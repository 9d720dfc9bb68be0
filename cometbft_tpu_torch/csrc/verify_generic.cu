// Generic Ed25519 verification after SHA-512, one lane per group of G
// threads, in one launch: the device tier for batches whose keys have no
// comb tables (a set of more than TABLE_MAX_KEYS unique keys).
//
// Replaces what cometbft_tpu/ops/ed25519_verify.py:114 `verify_kernel`
// (reached through `verify_kernel_packed`, :194) hands to XLA after the
// digest: A's and R's decompression (ops/curve.py:151, ZIP-215), the
// canonical-S check (ops/scalar.py:115), the digest reduction mod L
// (scalar.py:90) and its nibbles (:133), S's nibbles
// (curve.py:198 `nibbles_from_bytes_le`), [S]B over the 4-bit comb of B
// (curve.py:207 `comb_mul_base` with `B_COMB`, :56), [k](-A) by
// windowed double-and-add (curve.py:225 `window_mul`), two point
// additions, the cofactor [8] and the identity test.  Its field products
// are the Pallas kernel cometbft_tpu/ops/field.py:338
// (`_pallas_elementwise`, as the multiply and the square), here as
// field.cuh's group-level functions.  Every step mirrors the port's
// plain version (ops/ed25519_verify.py `verify_generic_plain`) operation
// for operation: the verdict and the limbs of [8]q are identical on every
// lane, at every group size.
//
// Inputs: the packed rows (100 + bucket, ld) uint8 -- pub[32] | sig[64] |
// msg[bucket] | msglen_le[4], lane j in column j, rows `ld` bytes apart
// (only pub and sig are read here) -- and the (64, n) uint8 digest
// SHA-512(R || A || M) from the sha512_keyed kernel.  Tables: the comb
// of B (64, 16, 3, 26) int32 in affine-Niels form, and a scratch tensor
// (16, 4, 26, n) int32 that receives each lane's multiples 0..15 of -A,
// lanes on the minor axis.  Outputs: (n,) bool verdicts and, when asked
// for, the (4, 26, n) int32 limbs of [8]q.
//
// Bound on the H100: per lane 2244 products and 1546 squarings (two
// decompressions of 20 and 255, the table of 14 point additions, 64
// windows of 4 doublings and one addition, 64 mixed additions, two point
// additions and [8]), ~4.01M int32 instructions, against 96 bytes of
// packed rows, the digest and ~64 distinct comb entries of 312 bytes:
// bound by operations, ~4.7 times the keyed verify's work.
//
// Design.  The keyed kernel's (verify_keyed.cu), with point.cuh's steps:
// a lane on a group of G consecutive threads of one warp, G in {1, 8, 32}
// (a template parameter; pick_group chooses it from the lane count), its
// 18 field elements (the 15 shared slots and -A's x, y, t) and a staging
// buffer in dynamic shared memory, the field constants once per block.
// The multiples table of -A does not fit beside them (16 points of 4
// coordinates are 6.5 KB a lane; 32 lanes at G = 1 would need ~280 KB
// with the lanes, more than an SM has), so each lane writes its entries
// once to the scratch tensor in device memory and every window fetches
// its entry from there into the staging buffer with 4-byte cp.async,
// started before the window's four doublings and waited for after them.
// The comb of B's entries (3 coordinates, contiguous) come the same way,
// one step ahead, as in the keyed kernel.  No tensor cores (each lane
// multiplies its own elements; lazy limbs exceed int8) and no TMA (an
// entry of the scratch tensor is 104 words n words apart).
//
// The per-lane body compiles as plain C++ too (field.cuh's FE_HD):
// `verify_generic_host` runs it on the host, at every compiled G, for a
// check where there is no card.

#include <cstdint>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "field.cuh"
#include "point.cuh"

namespace vg {

using fe::Grp;
using fe::NL;
using pt::Consts;
using pt::Next;
using pt::P1;
using pt::P2;
using pt::RT;
using pt::RX;
using pt::RY;

// A lane's elements: the shared slots, then -A's x, y and t = xy (z is
// one).  A's decompression borrows P1, P2 and the temporaries as scratch;
// P2 builds the multiples table before it accumulates [k](-A).
enum Slot { AX = pt::NSLOTS, AY, AT, NSLOTS };
using Lane = pt::Lane<NSLOTS>;

constexpr int NWIN = 64;  // 4-bit windows of S and k
constexpr int NENT = 16;  // multiples 0..15 of -A

struct Args {
  const uint8_t* buf;     // (100 + bucket, ld) packed rows
  int64_t ld;             // row stride of buf, bytes
  const uint8_t* digest;  // (64, n)
  const int32_t* b_comb;  // (64, 16, 3, 26) comb of B
  int32_t* mult;          // (16, 4, 26, n) scratch: multiples of -A
  uint8_t* ok;            // (n,) verdicts
  int32_t* q8;            // (4, 26, n) limbs of [8]q, or null
  int64_t n;
};

// The point in slots p..p+3 as entry j of lane `lane`'s multiples table.
// The phase's barrier orders the stores before the group's later copies.
template <int G>
FE_HD FE_INLINE void store_entry(Grp<G> g, const Args& a, int64_t lane, const Lane* L, int j,
                                 int p) {
  FE_PHASE(g) {
    for (int idx = r; idx < 4 * NL; idx += G) {
      const int c = idx / NL, i = idx - c * NL;
      a.mult[((j * 4 + c) * NL + i) * a.n + lane] = L->s[p + c][i];
    }
  }
}

// P2 = -A: (x, y, one, t) from the lane's -A slots.
template <int G>
FE_HD FE_INLINE void load_neg_a(Grp<G> g, Lane* L, const Consts& kc) {
  FE_PHASE(g) {
    for (int k = r; k < NL; k += G) {
      L->s[P2][k] = L->s[AX][k], L->s[P2 + 1][k] = L->s[AY][k];
      L->s[P2 + 2][k] = kc[pt::K_ONE][k], L->s[P2 + 3][k] = L->s[AT][k];
    }
  }
}

// The generic verify of lane `lane` (verify_generic_plain) on group g,
// with its elements in L and the field constants in kc.  The scalar steps
// run on every rank.
template <int G>
FE_HD void verify_lane(const Args& a, int64_t lane, Lane* L, const Consts& kc, Grp<G> g) {
  const uint8_t* col = a.buf + lane;
  const int64_t ld = a.ld;

  // Step s of [S]B adds the comb entry of window s and S's nibble s
  // (3 coordinates, contiguous).  Step 0's entry is in flight while A
  // and R are decompressed; each step starts the next one's.
  auto comb_entry = [&](int s) -> Next {
    const int nib = (col[(64 + s / 2) * ld] >> (4 * (s & 1))) & 0xF;
    return Next{a.b_comb + (s * NENT + nib) * 3 * NL, NL, 1, 3};
  };
  const Next first = comb_entry(0);
  pt::fetch_entry(g, L->stage, first.src, first.cstride, first.lstride, first.ncoord);

  const bool a_ok = pt::decompress(g, col, ld, L, kc, AX);
  const bool r_ok = pt::decompress(g, col + 32 * ld, ld, L, kc, RX);
  const bool s_ok = pt::bytes_lt_l(col + 64 * ld, ld);

  // window_mul's table: entry 0 the identity, 1 = -A, j = (j - 1) + (-A)
  fe::neg(g, L->s[AX], L->s[AX]);
  fe::neg(g, L->s[AT], L->s[AT]);
  pt::set_identity(g, L, P1, P2);
  store_entry(g, a, lane, L, 0, P2);
  load_neg_a(g, L, kc);
  store_entry(g, a, lane, L, 1, P2);
#pragma unroll 1
  for (int j = 2; j < NENT; ++j) {
    pt::pt_add(g, L, kc, P2, L->s[AX], L->s[AY], kc[pt::K_ONE], L->s[AT]);
    store_entry(g, a, lane, L, j, P2);
  }
  pt::set_identity(g, L, P2, P2);

  // [S]B: 64 mixed additions into P1
#pragma unroll 1
  for (int s = 0; s < NWIN; ++s) {
    pt::copy_wait();
    g.sync();
    const Next next = s + 1 < NWIN ? comb_entry(s + 1) : Next{nullptr, 0, 0, 0};
    pt::pt_madd(g, L, P1, false, next);
  }

  // [k](-A) into P2: k's nibbles from the most significant, each window
  // four doublings, then the entry, which loads meanwhile
  int64_t k[16];
  pt::reduce_digest(a.digest + lane, a.n, k);
#pragma unroll 1
  for (int w = NWIN - 1; w >= 0; --w) {
    const int64_t nib = (k[w / 4] >> (4 * (w % 4))) & 0xF;
    pt::fetch_entry(g, L->stage, a.mult + nib * 4 * NL * a.n + lane, NL * a.n, a.n, 4);
#pragma unroll 1
    for (int i = 0; i < 4; ++i) pt::pt_double(g, L, P2);
    pt::copy_wait();
    g.sync();
    pt::pt_add(g, L, kc, P2, L->stage[0], L->stage[1], L->stage[2], L->stage[3]);
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
  const bool ok = x_zero && y_eq_z && a_ok && r_ok && s_ok;
  FE_PHASE(g) {
    if (r == 0) a.ok[lane] = ok;
    if (a.q8 != nullptr) {
      for (int c = 0; c < 4; ++c) {
        for (int i = r; i < NL; i += G) a.q8[(c * NL + i) * a.n + lane] = L->s[P1 + c][i];
      }
    }
  }
}

}  // namespace vg

// The group size the launcher picks for n lanes (host builds too).
extern "C" int verify_generic_group(int64_t n) { return pt::pick_group(n); }

#ifdef __CUDACC__

namespace {

using pt::BLOCK;

template <int G>
__global__ void __launch_bounds__(BLOCK) verify_generic_kernel(vg::Args a) {
  extern __shared__ int32_t smem[];
  vg::Consts& kc = *reinterpret_cast<vg::Consts*>(smem);
  pt::fill_consts(kc, threadIdx.x, BLOCK);
  __syncwarp();
  const int sub = threadIdx.x / G;
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * (BLOCK / G) + sub;
  if (lane >= a.n) return;  // the whole group leaves together
  fe::Grp<G> g;
  g.rank = threadIdx.x % G;
  g.mask = (G == 32 ? 0xffffffffu : (1u << (G % 32)) - 1u) << (threadIdx.x & 31 & ~(G - 1));
  int32_t* lanes = smem + pt::NCONST * vg::NL;
  vg::verify_lane<G>(
      a, lane, reinterpret_cast<vg::Lane*>(lanes + sub * pt::lane_words<vg::Lane, G>()), kc, g);
}

template <int G>
int launch(const vg::Args& a, cudaStream_t stream) {
  return pt::launch<vg::Lane, G, vg::Args, verify_generic_kernel<G>>(a, stream);
}

}  // namespace

// C interface, loaded with ctypes: launches on `stream`, does not
// synchronise, returns cudaGetLastError() (0 on success).  `q8` may be
// null.  group is 1, 8 or 32 threads per lane, or 0 for the launcher's
// choice (verify_generic_group).
extern "C" int verify_generic_launch(const void* buf, int64_t ld, const void* digest,
                                     const void* b_comb, void* mult, void* ok, void* q8,
                                     int64_t n, int group, void* stream) {
  const vg::Args a{static_cast<const uint8_t*>(buf), ld, static_cast<const uint8_t*>(digest),
                   static_cast<const int32_t*>(b_comb), static_cast<int32_t*>(mult),
                   static_cast<uint8_t*>(ok), static_cast<int32_t*>(q8), n};
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (group == 0) group = pt::pick_group(n);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (group) {
    case 1: return launch<1>(a, st);
    case 8: return launch<8>(a, st);
    case 32: return launch<32>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The dynamic shared memory one block (one warp) takes at group size
// `group`, in bytes; -1 for a group size that is not compiled.
extern "C" int verify_generic_smem_bytes(int group) { return pt::smem_bytes<vg::Lane>(group); }

#else  // a host C++ compiler: the per-lane body on the CPU

namespace {

template <int G>
void run_host(const vg::Args& a) {
  vg::Lane lane_mem;
  vg::Consts kc;
  pt::fill_consts(kc, 0, 1);
  for (int64_t lane = 0; lane < a.n; ++lane) vg::verify_lane<G>(a, lane, &lane_mem, kc, {});
}

}  // namespace

// Host check of the kernel source: the same arguments on host memory,
// lanes run one after another, each group's ranks simulated in turn.
// Returns 0, or -1 for a group size that is not compiled (1, 8, 32).
extern "C" int verify_generic_host(const void* buf, int64_t ld, const void* digest,
                                   const void* b_comb, void* mult, void* ok, void* q8,
                                   int64_t n, int group) {
  const vg::Args a{static_cast<const uint8_t*>(buf), ld, static_cast<const uint8_t*>(digest),
                   static_cast<const int32_t*>(b_comb), static_cast<int32_t*>(mult),
                   static_cast<uint8_t*>(ok), static_cast<int32_t*>(q8), n};
  switch (group) {
    case 1: run_host<1>(a); return 0;
    case 8: run_host<8>(a); return 0;
    case 32: run_host<32>(a); return 0;
    default: return -1;
  }
}

#endif
