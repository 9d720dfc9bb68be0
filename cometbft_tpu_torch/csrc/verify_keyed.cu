// Keyed Ed25519 verification after SHA-512, one lane per group of G
// threads, in one launch.
//
// Replaces, on the keyed main path, the composition that
// cometbft_tpu/ops/ed25519_verify.py:143 `verify_kernel_keyed` hands to
// XLA after the digest: R's decompression (ops/curve.py:123, ZIP-215),
// the canonical-S check (ops/scalar.py:115), the digest reduction mod L
// (scalar.py:90) and its comb windows (:124 / :133), [S]B over the shared
// 8-bit comb of B (ops/precompute.py:88), [k](-A) over the per-key pool
// (precompute.py:158), two point additions, the cofactor [8] and the
// identity test (ops/curve.py:47-121).  Its field products are the Pallas
// kernel cometbft_tpu/ops/field.py:338 (`_pallas_elementwise`, as the
// multiply and the square), here as field.cuh's group-level functions.
// Every step mirrors the port's plain version (ops/ed25519_verify.py
// `verify_keyed_plain`) operation for operation: the verdict and the
// limbs of [8]q are identical on every lane, at every group size.
//
// Inputs: the packed rows (104 + bucket, ld) uint8 -- pub[32] | sig[64] |
// msg[bucket] | msglen_le[4] | key_id_le[4], lane j in column j, rows
// `ld` bytes apart (a slice of a wider batch needs no copy) -- and the
// (64, n) uint8 digest SHA-512(R || A || M) from the sha512_keyed
// kernel.  Tables: the per-key pool (nwin, 4, 26, m) int32, entry
// key_id * 2^wb + window on the minor axis, its validity (cap,) bool, and
// the comb of B (32, 3, 26, 256) int32.  Outputs: (n,) bool verdicts and,
// when asked for, the (4, 26, n) int32 limbs of [8]q.  A key id outside
// the pool reads key 0's page and is refused (verdict false).
//
// Bound on the H100: per lane about 530 products and 267 squarings at
// 8-bit windows (786 and 267 at 4-bit), ~0.86M int32 instructions,
// against ~23 KB of gathered table entries: bound by operations.  At the
// main path's 256 lanes the operations take ~13 us of the whole card; one
// thread per lane left 8 warps on 8 SMs issuing their chains serially,
// so the time was latency, not work.
//
// Design.  A lane runs on a group of G consecutive threads of one warp,
// G in {1, 8, 32} (a template parameter; pick_group chooses it from the
// lane count).  The group keeps its lane's 15 field elements and a
// staging buffer for one comb entry in dynamic shared memory (struct
// Lane, ~2 KB), and the block keeps one copy of the field constants
// there, so that every operand of a product is in shared memory.  A
// product (field.cuh, group level) gives each rank the column pairs of
// its limbs and folds them in registers, taking each pass's carry from
// the rank below by warp shuffle: one barrier per product.  G = 1 is the
// register-level product of the fe_mul kernel.  Linear steps are
// limb-parallel; the scalar steps (the digest reduction, the S check, the
// key id, the windows, the canonical-form tests) run on every rank
// redundantly.  Small batches take G = 32 (latency: 8 warps of one thread
// per lane become 256 warps on every SM); large ones G = 1 (the card is
// full, and a lane then costs fewest instructions on one thread).
//
// Comb entries: a lane's windows are known once S and k are, so as soon
// as a step has read its entry (after its fourth product) the group
// starts copying the next step's entry (3 or 4 coordinates of 26 limbs)
// from device memory into the staging buffer with 4-byte cp.async, spread
// over the ranks, and waits for it only at the next step.  The pool keeps
// its limb-major layout: an entry's limbs are m words apart, which rules
// out TMA (a box's inner extent must be a multiple of 16 bytes).  Tensor
// cores do not fit: each lane multiplies its own pair of elements (no
// operand shared across lanes to make a matrix product), and lazy limbs
// exceed int8.  Code size: the field products, the canonical-form tests
// and the point formulas are not inlined and the window loop stays
// rolled.
//
// The lane-level steps (the point formulas, R's decompression, the S
// check, the digest reduction, the entry copies) are point.cuh's, shared
// with the generic tier's kernel (verify_generic.cu).
//
// The per-lane body compiles as plain C++ too (field.cuh's FE_HD; a phase
// becomes a loop over the ranks and a shuffle a read of another rank's
// slot): `verify_keyed_host` runs it on the host, at every compiled G, for
// a check where there is no card.

#include <cstdint>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "field.cuh"
#include "point.cuh"

namespace vk {

using fe::Grp;
using fe::NL;
using pt::Consts;
using pt::Next;
using pt::P1;
using pt::P2;
using pt::RT;
using pt::RX;
using pt::RY;

// A lane's elements: the shared slots of point.cuh, nothing more.  R's
// decompression borrows the P1, P2 and T slots as scratch before either
// accumulator exists.
using Lane = pt::Lane<pt::NSLOTS>;

struct Args {
  const uint8_t* buf;        // (104 + bucket, ld) packed rows
  int64_t ld;                // row stride of buf, bytes
  int bucket;
  const uint8_t* digest;     // (64, n)
  const int32_t* table;      // (256 / wb, 4, 26, m) per-key combs
  int64_t m;                 // pool minor extent: cap * 2^wb
  const uint8_t* key_valid;  // (cap,)
  int64_t cap;
  const int32_t* b_table;    // (32, 3, 26, 256) comb of B
  uint8_t* ok;               // (n,) verdicts
  int32_t* q8;               // (4, 26, n) limbs of [8]q, or null
  int64_t n;
};

// -- one lane ----------------------------------------------------------

// The keyed verify of lane `lane` (verify_keyed_plain) on group g, with
// its elements in L and the field constants in k.  The scalar steps run
// on every rank.
template <int WB, int G>
FE_HD void verify_lane(const Args& a, int64_t lane, Lane* L, const Consts& kc, Grp<G> g) {
  constexpr int NWIN = 256 / WB;
  constexpr int PER_LIMB = 16 / WB;
  constexpr int NSTEP = 32 + NWIN;
  const uint8_t* col = a.buf + lane;
  const int64_t ld = a.ld;
  const uint8_t* kb = col + (100 + a.bucket) * ld;
  int64_t key = static_cast<int32_t>(
      static_cast<uint32_t>(kb[0]) | (static_cast<uint32_t>(kb[ld]) << 8) |
      (static_cast<uint32_t>(kb[2 * ld]) << 16) | (static_cast<uint32_t>(kb[3 * ld]) << 24));
  const bool key_in = key >= 0 && key < a.cap;
  if (!key_in) key = 0;
  int64_t k[16];
  pt::reduce_digest(a.digest + lane, a.n, k);

  // Step s < 32 adds [S]B's entry S[s] of window s (3 coordinates, the
  // comb of B); step 32 + w adds [k](-A)'s entry key * 2^wb + k_w of
  // window w (4 coordinates, the pool).  Step 0's entry is in flight
  // while R is decompressed; each step starts the next one's.
  const int64_t bs = static_cast<int64_t>(NL) * 256;  // coordinate stride of the comb of B
  const int64_t cs = static_cast<int64_t>(NL) * a.m;  // coordinate stride of the pool
  auto entry = [&](int s) -> Next {
    if (s < 32) return Next{a.b_table + s * 3 * bs + col[(64 + s) * ld], bs, 256, 3};
    const int w = s - 32;
    const int64_t win = (k[w / PER_LIMB] >> (WB * (w % PER_LIMB))) & ((1 << WB) - 1);
    return Next{a.table + w * 4 * cs + (key << WB) + win, cs, a.m, 4};
  };
  const Next first = entry(0);
  pt::fetch_entry(g, L->stage, first.src, first.cstride, first.lstride, first.ncoord);

  const bool r_ok = pt::decompress(g, col + 32 * ld, ld, L, kc, RX);
  const bool s_ok = pt::bytes_lt_l(col + 64 * ld, ld);
  pt::set_identity(g, L, P1, P2);

#pragma unroll 1
  for (int s = 0; s < NSTEP; ++s) {
    pt::copy_wait();
    g.sync();
    const Next next = s + 1 < NSTEP ? entry(s + 1) : Next{nullptr, 0, 0, 0};
    pt::pt_madd(g, L, s < 32 ? P1 : P2, s >= 32, next);
  }

  // q = [S]B + [k](-A) - R, then [8]q
  pt::pt_add(g, L, kc, P1, L->s[P2], L->s[P2 + 1], L->s[P2 + 2], L->s[P2 + 3]);
  fe::neg(g, L->s[RX], L->s[RX]);
  fe::neg(g, L->s[RT], L->s[RT]);
  pt::pt_add(g, L, kc, P1, L->s[RX], L->s[RY], kc[pt::K_ONE], L->s[RT]);
#pragma unroll 1
  for (int i = 0; i < 3; ++i) pt::pt_double(g, L, P1);

  const bool x_zero = fe::is_zero(g, L->s[P1]);
  const bool y_eq_z = fe::eq(g, L->s[P1 + 1], L->s[P1 + 2]);
  const bool ok = x_zero && y_eq_z && r_ok && s_ok && key_in && a.key_valid[key] != 0;
  FE_PHASE(g) {
    if (r == 0) a.ok[lane] = ok;
    if (a.q8 != nullptr) {
      for (int c = 0; c < 4; ++c) {
        for (int i = r; i < NL; i += G) a.q8[(c * NL + i) * a.n + lane] = L->s[P1 + c][i];
      }
    }
  }
}

}  // namespace vk

// The group size the launcher picks for n lanes (host builds too).
extern "C" int verify_keyed_group(int64_t n) { return pt::pick_group(n); }

#ifdef __CUDACC__

namespace {

using pt::BLOCK;

template <int WB, int G>
__global__ void __launch_bounds__(BLOCK) verify_keyed_kernel(vk::Args a) {
  extern __shared__ int32_t smem[];
  vk::Consts& kc = *reinterpret_cast<vk::Consts*>(smem);
  pt::fill_consts(kc, threadIdx.x, BLOCK);
  __syncwarp();
  const int sub = threadIdx.x / G;
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * (BLOCK / G) + sub;
  if (lane >= a.n) return;  // the whole group leaves together
  fe::Grp<G> g;
  g.rank = threadIdx.x % G;
  g.mask = (G == 32 ? 0xffffffffu : (1u << (G % 32)) - 1u) << (threadIdx.x & 31 & ~(G - 1));
  int32_t* lanes = smem + pt::NCONST * vk::NL;
  vk::verify_lane<WB, G>(
      a, lane, reinterpret_cast<vk::Lane*>(lanes + sub * pt::lane_words<vk::Lane, G>()), kc, g);
}

template <int WB, int G>
int launch(const vk::Args& a, cudaStream_t stream) {
  return pt::launch<vk::Lane, G, vk::Args, verify_keyed_kernel<WB, G>>(a, stream);
}

template <int WB>
int launch_group(const vk::Args& a, int group, cudaStream_t st) {
  switch (group) {
    case 1: return launch<WB, 1>(a, st);
    case 8: return launch<WB, 8>(a, st);
    case 32: return launch<WB, 32>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C interface, loaded with ctypes: launches on `stream`, does not
// synchronise, returns cudaGetLastError() (0 on success).  `q8` may be
// null.  window_bits is 8 or 4; group is 1, 8 or 32 threads per lane,
// or 0 for the launcher's choice (verify_keyed_group).  `ev0` and `ev1`,
// when not null, are CUDA events recorded on `stream` just before and
// just after the kernel, in this one call (its device time, with no
// host gap between the launch and its events).
extern "C" int verify_keyed_launch(const void* buf, int64_t ld, int bucket, const void* digest,
                                   const void* table, int64_t m, const void* key_valid,
                                   int64_t cap, const void* b_table, void* ok, void* q8,
                                   int64_t n, int window_bits, int group, void* stream,
                                   void* ev0, void* ev1) {
  const vk::Args a{static_cast<const uint8_t*>(buf), ld, bucket,
                   static_cast<const uint8_t*>(digest), static_cast<const int32_t*>(table), m,
                   static_cast<const uint8_t*>(key_valid), cap,
                   static_cast<const int32_t*>(b_table), static_cast<uint8_t*>(ok),
                   static_cast<int32_t*>(q8), n};
  if (window_bits != 8 && window_bits != 4) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (group == 0) group = pt::pick_group(n);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ev0 != nullptr) cudaEventRecord(static_cast<cudaEvent_t>(ev0), st);
  const int rc =
      window_bits == 8 ? launch_group<8>(a, group, st) : launch_group<4>(a, group, st);
  if (ev1 != nullptr) cudaEventRecord(static_cast<cudaEvent_t>(ev1), st);
  return rc;
}

// The dynamic shared memory one block (one warp) takes at group size
// `group`, in bytes; -1 for a group size that is not compiled.
extern "C" int verify_keyed_smem_bytes(int group) { return pt::smem_bytes<vk::Lane>(group); }

#else  // a host C++ compiler: the per-lane body on the CPU

namespace {

template <int WB, int G>
void run_host(const vk::Args& a) {
  vk::Lane lane_mem;
  vk::Consts kc;
  pt::fill_consts(kc, 0, 1);
  for (int64_t lane = 0; lane < a.n; ++lane) vk::verify_lane<WB, G>(a, lane, &lane_mem, kc, {});
}

}  // namespace

// Host check of the kernel source: the same arguments on host memory,
// lanes run one after another, each group's ranks simulated in turn.
// Returns 0, or -1 for a window width other than 8 or 4 or a group size
// that is not compiled (1, 8, 32).
extern "C" int verify_keyed_host(const void* buf, int64_t ld, int bucket, const void* digest,
                                 const void* table, int64_t m, const void* key_valid,
                                 int64_t cap, const void* b_table, void* ok, void* q8,
                                 int64_t n, int window_bits, int group) {
  const vk::Args a{static_cast<const uint8_t*>(buf), ld, bucket,
                   static_cast<const uint8_t*>(digest), static_cast<const int32_t*>(table), m,
                   static_cast<const uint8_t*>(key_valid), cap,
                   static_cast<const int32_t*>(b_table), static_cast<uint8_t*>(ok),
                   static_cast<int32_t*>(q8), n};
  if (window_bits != 8 && window_bits != 4) return -1;
  const int key = window_bits * 100 + group;
  switch (key) {
    case 801: run_host<8, 1>(a); return 0;
    case 808: run_host<8, 8>(a); return 0;
    case 832: run_host<8, 32>(a); return 0;
    case 401: run_host<4, 1>(a); return 0;
    case 408: run_host<4, 8>(a); return 0;
    case 432: run_host<4, 32>(a); return 0;
    default: return -1;
  }
}

#endif
