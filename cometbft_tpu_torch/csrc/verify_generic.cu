// Generic Ed25519 verification after SHA-512, one lane per Q quarters of
// G threads, in one launch: the device tier for batches whose keys have no
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
// lane, at every launch shape.
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
// bound by operations, ~4.7 times the keyed verify's work.  At a few
// hundred lanes the card is far from full, and the time is a lane's chain
// of dependent field operations: 3790 one after another on one group.
//
// Design.  A lane runs on Q quarters of G threads (point.cuh's Team), so
// that each point formula's independent products run side by side:
// doublings at a depth of two products, additions of the table and of the
// windows at three, mixed additions at two.  The shapes (Q, G) compiled
// are (1, 1), (1, 8), (1, 32) -- one group per lane, a stage's products
// in turn -- and (4, 1), (4, 8), (4, 32); pick_shape chooses
// one from the lane count.  The quarters share the lane's elements in
// dynamic shared memory and meet at a barrier after each stage and each
// limb-parallel step: __syncwarp while a lane lies in one warp (Q G <=
// 32), named barrier 1 for the 128 threads of a (4, 32) lane.  The
// lane's schedule:
//
//   1. A's and R's decompressions, side by side on quarters 0 and 1
//      (~275 dependent operations), and [S]B into P1 (64 mixed additions
//      over the comb of B, each entry fetched by 4-byte cp.async during
//      the step before): at (4, 32) beside them, two-way on quarters 2
//      and 3 (named barrier 2, 64 threads; 256 steps); otherwise after
//      them, four-way (128 steps).  Quarters of one warp that run
//      different code take turns, so only whole-warp quarters run [S]B
//      beside the decompressions.
//   2. The multiples 0..15 of -A (14 additions, 42 steps), stored by the
//      lane's threads to the scratch tensor: 16 points of 4 coordinates
//      are 6.5 KB a lane, too many for shared memory beside 8 or 32
//      lanes a block.
//   3. [k](-A): 64 windows of four doublings and one addition of the
//      window's entry (704 steps), the entry copied from the scratch
//      tensor by cp.async during the doublings.
//   4. The two final additions, [8] and the identity test (12 steps).
//
// The critical path is ~1033 dependent operations at (4, 32) and ~1161
// at (4, 1) and (4, 8), against 3790 at Q = 1 (VG_CHAIN in
// chip_smoke.py).  The work is the same: a quarter does the products it
// would otherwise wait for.  Every product keeps its operands and its
// chain order (no reassociation, the table's order, the windows, x2d
// before xt2), so the limbs stay the plain version's at every shape.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py,
// tools/torch_product_cycles.py): 256 lanes take 0.70 ms at (4, 32)
// against 1.46 at (1, 32) -- a chain 3.7 times shorter, a step ~1.8
// times slower (four warps' products share the SM's load pipe, and each
// stage adds a limb step and a barrier).  From ~2 lanes per SM the
// instructions per product count, and fewer threads per quarter win.
// Slots per lane: 18 at Q = 1 (the 15 shared ones and -A's x, y, t);
// 27 at (4, 1) and (4, 8), where A's decompression takes nine of its own;
// 36 at (4, 32), where R's does too.  No tensor cores (each lane
// multiplies its own elements; lazy limbs exceed int8) and no TMA (an
// entry of the scratch tensor is 104 words n words apart).
//
// The per-lane body compiles as plain C++ too (field.cuh's FE_HD):
// `verify_generic_host` runs it on the host at every compiled shape,
// each stage's jobs in order or last to first, for a check where there
// is no card.

#include <cstdint>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "field.cuh"
#include "point.cuh"

namespace vg {

using fe::NL;
using pt::Consts;
using pt::Next;
using pt::P1;
using pt::P2;
using pt::RT;
using pt::RX;
using pt::RY;
using pt::Team;

#ifdef __CUDA_ARCH__
constexpr bool kDevice = true;
#else
constexpr bool kDevice = false;
#endif

// A lane's elements: the shared slots, -A's x, y and t = xy (z is one),
// then the scratch of decompressions that run side by side: A's nine
// from XA (Q = 4) and R's nine from XR ((4, 32)).  A decompression that
// has none of its own takes the nine slots from P1 (P1, P2, T0), free
// until [S]B starts.  valid[] holds A's and R's validity for the
// quarters that did not decompress them.
enum Slot { AX = pt::NSLOTS, AY, AT, XA, XR = XA + 9, NSLOTS_MAX = XR + 9 };

// [S]B runs beside the decompressions: only when quarters are whole warps.
template <int Q, int G>
FE_HD constexpr bool split() {
  return Q == 4 && G == 32;
}
template <int Q, int G>
FE_HD constexpr int nslots() {
  return Q == 1 ? XA : split<Q, G>() ? NSLOTS_MAX : XR;
}
template <int Q, int G>
struct Lane : pt::Lane<nslots<Q, G>()> {
  int32_t valid[2];
};

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

// [S]B into P1 (comb_mul_base): from the identity, one mixed addition a
// window, S's nibble s choosing window s's comb entry (3 coordinates,
// contiguous), which is copied during the step before.
template <int Q, int G, int NS>
FE_HD void comb_mul(Team<Q, G> t, pt::Lane<NS>* L, const int32_t* b_comb, const uint8_t* col,
                    int64_t ld) {
  auto entry = [&](int s) -> Next {
    const int nib = (col[(64 + s / 2) * ld] >> (4 * (s & 1))) & 0xF;
    return Next{b_comb + (s * NENT + nib) * 3 * NL, NL, 1, 3};
  };
  pt::set_identity_q(t, L, P1);
  const Next first = entry(0);
  pt::fetch_entry_q(t, L->stage, first.src, first.cstride, first.lstride, first.ncoord);
#pragma unroll 1
  for (int s = 0; s < NWIN; ++s) {
    pt::copy_wait();
    t.sync();
    pt::pt_madd_q(t, L, P1, s + 1 < NWIN ? entry(s + 1) : Next{nullptr, 0, 0, 0});
  }
}

// Quarters 2 and 3 of a (4, 32) lane as a team of their own.
template <int G>
FE_HD FE_INLINE Team<2, G> upper_half(Team<4, G> t) {
#ifdef __CUDA_ARCH__
  Team<2, G> h;
  h.g = t.g, h.q = t.q - 2, h.tid = t.tid - 2 * G, h.mask = 0xffffffffu, h.bar = 2;
  return h;
#else
  return Team<2, G>{t.g, t.reverse};
#endif
}

// Entry j of lane `lane`'s multiples table from slots p..p+3, spread over
// the lane's threads; the barrier orders the stores before later copies.
template <int Q, int G, int NS>
FE_HD FE_INLINE void store_entry(Team<Q, G> t, const Args& a, int64_t lane,
                                 const pt::Lane<NS>* L, int j, int p) {
  pt::each<4 * NL>(t, [&](int idx) {
    const int c = idx / NL, i = idx - c * NL;
    a.mult[((j * 4 + c) * NL + i) * a.n + lane] = L->s[p + c][i];
  });
  t.sync();
}

// The generic verify of lane `lane` (verify_generic_plain) on team t,
// with its elements in L and the field constants in kc.  The scalar
// steps run on every thread.
template <int Q, int G>
FE_HD void verify_lane(const Args& a, int64_t lane, Lane<Q, G>* L, const Consts& kc,
                       Team<Q, G> t) {
  const uint8_t* col = a.buf + lane;
  const int64_t ld = a.ld;
  const int32_t* one = kc[pt::K_ONE];

  // 1. A's (j = 0) and R's (j = 1) decompressions, and [S]B
  auto decompress = [&](int j) {
    const int out = j == 0 ? int{AX} : int{RX};
    const int scratch = Q == 1 ? int{P1} : j == 0 ? int{XA} : split<Q, G>() ? int{XR} : int{P1};
    const bool ok = pt::decompress(t.g, col + 32 * j * ld, ld, L, kc, out, pt::BaseScratch{scratch});
    if (pt::lead(t.g)) L->valid[j] = ok;
  };
  if constexpr (split<Q, G>()) {
    pt::stage<4>(t, [&](int j) {
      if (j < 2) {
        decompress(j);
      } else if (j == 2 || kDevice) {  // the host runs both quarters' team at once
        comb_mul(upper_half(t), L, a.b_comb, col, ld);
      }
    });
  } else {
    pt::stage<2>(t, decompress);
    comb_mul(t, L, a.b_comb, col, ld);
  }

  // 2. window_mul's table: entry 0 the identity, 1 = -A, j = (j - 1) + (-A)
  pt::set_identity_q(t, L, P2);
  store_entry(t, a, lane, L, 0, P2);
  pt::limbs(t, [&](int k) {
    const int32_t x = pt::sub32(0, L->s[AX][k]), tt = pt::sub32(0, L->s[AT][k]);
    L->s[AX][k] = x, L->s[AT][k] = tt;
    L->s[P2][k] = x, L->s[P2 + 1][k] = L->s[AY][k], L->s[P2 + 2][k] = one[k], L->s[P2 + 3][k] = tt;
  });
  store_entry(t, a, lane, L, 1, P2);
#pragma unroll 1
  for (int j = 2; j < NENT; ++j) {
    pt::pt_add_q(t, L, kc, P2, L->s[AX], L->s[AY], one, L->s[AT]);
    store_entry(t, a, lane, L, j, P2);
  }
  pt::set_identity_q(t, L, P2);

  // 3. [k](-A) into P2: k's nibbles from the most significant, each
  // window four doublings, then the entry, which loads meanwhile
  int64_t k[16];
  pt::reduce_digest(a.digest + lane, a.n, k);
  const bool s_ok = pt::bytes_lt_l(col + 64 * ld, ld);
#pragma unroll 1
  for (int w = NWIN - 1; w >= 0; --w) {
    const int64_t nib = (k[w / 4] >> (4 * (w % 4))) & 0xF;
    pt::fetch_entry_q(t, L->stage, a.mult + nib * 4 * NL * a.n + lane, NL * a.n, a.n, 4);
#pragma unroll 1
    for (int i = 0; i < 4; ++i) pt::pt_double_q(t, L, P2);
    pt::copy_wait();
    t.sync();
    pt::pt_add_q(t, L, kc, P2, L->stage[0], L->stage[1], L->stage[2], L->stage[3]);
  }

  // 4. q = [S]B + [k](-A) - R, then [8]q
  pt::pt_add_q(t, L, kc, P1, L->s[P2], L->s[P2 + 1], L->s[P2 + 2], L->s[P2 + 3]);
  pt::limbs(t, [&](int k) {
    L->s[RX][k] = pt::sub32(0, L->s[RX][k]);
    L->s[RT][k] = pt::sub32(0, L->s[RT][k]);
  });
  pt::pt_add_q(t, L, kc, P1, L->s[RX], L->s[RY], one, L->s[RT]);
#pragma unroll 1
  for (int i = 0; i < 3; ++i) pt::pt_double_q(t, L, P1);

  const bool x_zero = fe::is_zero(t.g, L->s[P1]);
  const bool y_eq_z = fe::eq(t.g, L->s[P1 + 1], L->s[P1 + 2]);
  const bool ok = x_zero && y_eq_z && L->valid[0] && L->valid[1] && s_ok;
  pt::each<1>(t, [&](int) { a.ok[lane] = ok; });
  if (a.q8 != nullptr) {
    pt::each<4 * NL>(t, [&](int idx) {
      const int c = idx / NL, i = idx - c * NL;
      a.q8[(c * NL + i) * a.n + lane] = L->s[P1 + c][i];
    });
  }
}

// The shape (quarters, threads per quarter) for n lanes, from the sweep
// chip_smoke.py prints (H100): four quarters at every size; a warp per
// quarter up to 256 lanes (the shortest chain, ~2 lanes per SM), 8
// threads per quarter up to 1024, then one (4 threads a lane), where the
// card fills and the instructions per product, not the chain, set the
// time.
FE_HD FE_INLINE void pick_shape(int64_t n, int& quarters, int& group) {
  quarters = 4;
  group = n <= 256 ? 32 : n <= 1024 ? 8 : 1;
}

}  // namespace vg

// The compiled shapes (quarters, threads per quarter).
#define VG_SHAPES(X) X(1, 1) X(1, 8) X(1, 32) X(4, 1) X(4, 8) X(4, 32)

// The shape the launcher picks for n lanes (host builds too).
extern "C" int verify_generic_shape(int64_t n, int* quarters, int* group) {
  vg::pick_shape(n, *quarters, *group);
  return 0;
}

#ifdef __CUDACC__

namespace {

// The threads of a warp's w-aligned run that holds this thread.
__device__ FE_INLINE unsigned warp_run(int w) {
  return (w >= 32 ? 0xffffffffu : (1u << w) - 1u) << (threadIdx.x & 31 & ~(w - 1));
}

// minBlocks 1: without it ptxas capped the (4, 8) and (4, 32) kernels'
// registers and spilled
template <int Q, int G>
__global__ void __launch_bounds__(pt::block_threads<Q * G>(), 1)
    verify_generic_kernel(vg::Args a) {
  constexpr int TPL = Q * G, THREADS = pt::block_threads<TPL>();
  extern __shared__ int32_t smem[];
  vg::Consts& kc = *reinterpret_cast<vg::Consts*>(smem);
  pt::fill_consts(kc, threadIdx.x, THREADS);
  __syncthreads();
  const int sub = threadIdx.x / TPL;
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * (THREADS / TPL) + sub;
  if (lane >= a.n) return;  // the whole lane leaves together
  pt::Team<Q, G> t;
  t.tid = threadIdx.x % TPL;
  t.q = t.tid / G;
  t.g.rank = threadIdx.x % G;
  t.g.mask = warp_run(G);
  t.mask = warp_run(TPL);
  t.bar = 1;
  int32_t* lanes = smem + pt::NCONST * vg::NL;
  vg::verify_lane<Q, G>(
      a, lane,
      reinterpret_cast<vg::Lane<Q, G>*>(lanes + sub * pt::lane_words<vg::Lane<Q, G>, G>()), kc,
      t);
}

template <int Q, int G>
int launch(const vg::Args& a, cudaStream_t stream) {
  return pt::launch<vg::Lane<Q, G>, G, vg::Args, verify_generic_kernel<Q, G>, Q * G>(a, stream);
}

}  // namespace

// C interface, loaded with ctypes: launches on `stream`, does not
// synchronise, returns cudaGetLastError() (0 on success).  `q8` may be
// null.  (quarters, group) is a compiled shape, or (0, 0) for the
// launcher's choice (verify_generic_shape).  `ev0` and `ev1`, when not
// null, are CUDA events recorded on `stream` just before and just after
// the kernel, in this one call.
extern "C" int verify_generic_launch(const void* buf, int64_t ld, const void* digest,
                                     const void* b_comb, void* mult, void* ok, void* q8,
                                     int64_t n, int quarters, int group, void* stream,
                                     void* ev0, void* ev1) {
  const vg::Args a{static_cast<const uint8_t*>(buf), ld, static_cast<const uint8_t*>(digest),
                   static_cast<const int32_t*>(b_comb), static_cast<int32_t*>(mult),
                   static_cast<uint8_t*>(ok), static_cast<int32_t*>(q8), n};
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (quarters == 0 && group == 0) vg::pick_shape(n, quarters, group);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = static_cast<int>(cudaErrorInvalidValue);
  if (ev0 != nullptr) cudaEventRecord(static_cast<cudaEvent_t>(ev0), st);
#define VG_LAUNCH(Q, G) \
  if (quarters == Q && group == G) rc = launch<Q, G>(a, st);
  VG_SHAPES(VG_LAUNCH)
#undef VG_LAUNCH
  if (ev1 != nullptr) cudaEventRecord(static_cast<cudaEvent_t>(ev1), st);
  return rc;
}

// The dynamic shared memory one block takes at a shape, in bytes; -1 for
// a shape that is not compiled.
extern "C" int verify_generic_smem_bytes(int quarters, int group) {
#define VG_SMEM(Q, G) \
  if (quarters == Q && group == G) return pt::smem_bytes<vg::Lane<Q, G>, G, Q * G>();
  VG_SHAPES(VG_SMEM)
#undef VG_SMEM
  return -1;
}

#else  // a host C++ compiler: the per-lane body on the CPU

namespace {

template <int Q, int G>
void run_host(const vg::Args& a, bool reverse) {
  vg::Lane<Q, G> lane_mem;
  vg::Consts kc;
  pt::fill_consts(kc, 0, 1);
  for (int64_t lane = 0; lane < a.n; ++lane)
    vg::verify_lane<Q, G>(a, lane, &lane_mem, kc, pt::Team<Q, G>{{}, reverse});
}

}  // namespace

// Host check of the kernel source: the same arguments on host memory,
// lanes one after another, each group's ranks simulated phase by phase
// and each stage's jobs in turn -- last to first when `reverse` is not 0.
// Returns 0, or -1 for a shape that is not compiled.
extern "C" int verify_generic_host(const void* buf, int64_t ld, const void* digest,
                                   const void* b_comb, void* mult, void* ok, void* q8,
                                   int64_t n, int quarters, int group, int reverse) {
  const vg::Args a{static_cast<const uint8_t*>(buf), ld, static_cast<const uint8_t*>(digest),
                   static_cast<const int32_t*>(b_comb), static_cast<int32_t*>(mult),
                   static_cast<uint8_t*>(ok), static_cast<int32_t*>(q8), n};
#define VG_HOST(Q, G)                        \
  if (quarters == Q && group == G) {         \
    run_host<Q, G>(a, reverse != 0);         \
    return 0;                                \
  }
  VG_SHAPES(VG_HOST)
#undef VG_HOST
  return -1;
}

#endif
