// The lane-level steps that the fused verify kernels share: a lane's
// field elements in shared memory, asynchronous copies of table entries,
// the point formulas, ZIP-215 decompression, the canonical-S check and
// the digest reduction mod L; and the group size both kernels launch
// with and their launcher.  verify_keyed.cu (the keyed tier),
// verify_generic.cu (the generic tier) and build_tables.cu include it.
//
// Every step mirrors its plain PyTorch version operation for operation
// (ops/curve.py pt_add / pt_add_niels / pt_add_pniels / pt_double /
// decompress, ops/scalar.py bytes_lt_l / reduce_digest), so a kernel's
// limbs equal its plain version's, not merely congruent mod p.  The
// field arithmetic is field.cuh's group level: a lane runs on a group of
// G threads of one warp (G = 1 is one thread).
//
// A lane's elements are the slots of a Lane<NS>: the first NSLOTS are
// the layout both kernels use (R, the two accumulators, four
// temporaries); a kernel that needs more slots takes them after those.
//
// The generic kernel and the table build (build_tables.cu) run a lane on
// Q quarters of G threads (a Team; the four-way formulas pt_double_q,
// pt_add_q, pt_madd_q, and the build's pt_add_q_niels), so that a
// formula's independent products run side by side.  The keyed kernel
// keeps the one-group steps (pt_double, pt_add, pt_madd) and its launch
// shapes (pick_group): the kernels differ by design, and each has its
// own chooser.
// The file compiles as plain C++ too (see field.cuh).

#pragma once

#include <cstdint>
#ifdef __CUDACC__
#include <cuda_runtime.h>

#include <atomic>
#endif

#include "field.cuh"

namespace pt {

using fe::Grp;
using fe::NL;

// 16-bit limbs (ops/scalar.py): 16c with 2^256 = -16c (mod L), L with a
// zero 17th limb, and 16L.
FE_TABLE(int64_t, kK, 9, {16080, 53085, 12709, 33062, 52581, 12153, 40426, 19951, 1})
FE_TABLE(int64_t, kL, 17,
         {54253, 23797, 25370, 22546, 40150, 41719, 63966, 5342, 0, 0, 0, 0, 0, 0, 0, 4096, 0})
FE_TABLE(int64_t, kL16, 17,
         {16080, 53085, 12709, 33062, 52581, 12153, 40426, 19951, 1, 0, 0, 0, 0, 0, 0, 0, 1})

// The shared slots: R's x, y and t = xy (z is one), the accumulators P1
// and P2 (four slots each), and the point formulas' four temporaries.
// Decompression borrows P1, P2 and the temporaries as scratch.
enum Slot { RX, RY, RT, P1, P2 = P1 + 4, T0 = P2 + 4, T1, T2, T3, NSLOTS };

// The field constants the steps read: the block's, one copy before the
// lanes.  With the constants in shared memory every operand of a product
// is, and the compiler addresses them all as shared.
enum Const { K_ONE, K_D, K_TWO_D, K_SQRT_M1, NCONST };

// A lane's shared memory: its NS elements and the staging buffer of one
// table entry (up to 4 coordinates of 26 limbs).
template <int NS>
struct Lane {
  static_assert(NS >= NSLOTS, "a lane holds at least the shared slots");
  int32_t s[NS][NL];
  int32_t stage[4][NL];
};

using Consts = int32_t[NCONST][NL];

FE_HD FE_INLINE void fill_consts(Consts& k, int first, int step) {
  for (int i = first; i < NL; i += step) {
    k[K_ONE][i] = FE_K(fe::kOne)[i];
    k[K_D][i] = FE_K(fe::kD)[i];
    k[K_TWO_D][i] = FE_K(fe::kTwoD)[i];
    k[K_SQRT_M1][i] = FE_K(fe::kSqrtM1)[i];
  }
}

// Words between two lanes' Lane structs: padded to G (mod 32) so that
// the groups of one warp start on distinct banks and a group's G
// consecutive words tile the 32 banks with its neighbours' (G = 1: an
// odd stride, so 32 lanes reading the same word of their own structs hit
// 32 banks).
template <class LaneT, int G>
FE_HD constexpr int lane_words() {
  constexpr int base = static_cast<int>(sizeof(LaneT) / sizeof(int32_t));
  return base + ((G % 32) - base % 32 + 32) % 32;
}

// The keyed kernel's group size for n lanes, from the sweeps
// chip_smoke.py prints (H100): G = 32 is fastest up to 1024 lanes, G = 8
// up to 4096, and one thread per lane beyond, where the card is full and
// a lane's instruction count, not its latency, sets the time.  (The
// generic kernel has its own chooser, verify_generic.cu's pick_shape.)
FE_HD FE_INLINE int pick_group(int64_t n) { return n <= 1024 ? 32 : n <= 4096 ? 8 : 1; }

#ifdef __CUDACC__

// -- the launcher both kernels use ------------------------------------------

constexpr int BLOCK = 32;  // one warp: 32 / G lanes
constexpr int MAX_DEVICES = 64;

// A block's threads for TPL threads per lane: one warp, or one lane
// when a lane spans warps.
template <int TPL>
FE_HD constexpr int block_threads() {
  return TPL > BLOCK ? TPL : BLOCK;
}

// A block's dynamic shared memory: the constants, then its lanes (TPL
// threads each, G to a group).
template <class LaneT, int G, int TPL = G>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(int32_t)) *
         (NCONST * NL + (block_threads<TPL>() / TPL) * lane_words<LaneT, G>());
}

// The same at a run-time group size; -1 for one that is not compiled.
template <class LaneT>
int smem_bytes(int group) {
  return group == 1 ? smem_bytes<LaneT, 1>() : group == 8 ? smem_bytes<LaneT, 8>()
                                             : group == 32 ? smem_bytes<LaneT, 32>() : -1;
}

// Launches Kernel over a.n lanes of TPL threads (G by default),
// block_threads<TPL>() threads a block, on `stream`, without
// synchronising; returns cudaGetLastError().  Shared memory above 48 KB
// needs an opt-in, once per device: the attribute belongs to the
// function in each device's context.
template <class LaneT, int G, class Args, void (*Kernel)(Args), int TPL = G>
int launch(const Args& a, cudaStream_t stream) {
  static std::atomic<bool> opted_in[MAX_DEVICES];
  constexpr int smem = smem_bytes<LaneT, G, TPL>();
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= MAX_DEVICES || !opted_in[dev].load()) {
    err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= 0 && dev < MAX_DEVICES) opted_in[dev].store(true);
  }
  constexpr int threads = block_threads<TPL>();
  constexpr int lpb = threads / TPL;
  const unsigned grid = static_cast<unsigned>((a.n + lpb - 1) / lpb);
  Kernel<<<grid, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

#endif

// -- asynchronous copies of table entries --------------------------------

#ifdef __CUDA_ARCH__
__device__ FE_INLINE void copy_async4(int32_t* dst, const int32_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
// Wait for all of this thread's copies (one entry is in flight at a time).
__device__ FE_INLINE void copy_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }
#else
inline void copy_async4(int32_t* dst, const int32_t* src) { *dst = *src; }
inline void copy_wait() {}
#endif

// Start copying one table entry (`ncoord` coordinates, coordinate c's
// limb i at src[c * cstride + i * lstride]) into dst, spread over the
// ranks.
template <int G>
FE_HD FE_INLINE void fetch_entry(Grp<G> g, int32_t (*dst)[NL], const int32_t* src,
                                 int64_t cstride, int64_t lstride, int ncoord) {
  FE_RANKS(g) {
    for (int idx = r; idx < ncoord * NL; idx += G) {
      const int c = idx / NL, i = idx - c * NL;
      copy_async4(&dst[c][i], src + c * cstride + i * lstride);
    }
  }
}

// -- points: (X, Y, Z, T) in four consecutive slots from `p` ------------

template <int G, int NS>
FE_HD FE_INLINE void set_identity(Grp<G> g, Lane<NS>* L, int p, int q) {
  FE_PHASE(g) {
    for (int k = r; k < NL; k += G) {
      const int32_t one = k == 0 ? 1 : 0;
      L->s[p][k] = 0, L->s[p + 1][k] = one, L->s[p + 2][k] = one, L->s[p + 3][k] = 0;
      L->s[q][k] = 0, L->s[q + 1][k] = one, L->s[q + 2][k] = one, L->s[q + 3][k] = 0;
    }
  }
}

// The table entry a step adds next, or none (src null): fetched into the
// staging buffer as soon as the current step has read its own entry.
struct Next {
  const int32_t* src;
  int64_t cstride, lstride;
  int ncoord;
};

// p += (Y+X, Y-X, c2) for the entry in L->stage: pt_add_niels (c2 =
// 2dxy, dd = 2 Z1) or, when `projective`, pt_add_pniels (c2 = 2dT, dd =
// Z1 * z2 with z2 = 2Z).  The stage's coordinates are yplus, yminus, then
// c2 (affine) or z2, c2 (projective).  Once dd is formed the entry is
// spent, and `next` starts loading into the same buffer.  The last four
// products write in place (e in X, h in Y), so the step needs four
// temporaries.
template <int G, int NS>
FE_HD FE_NOINLINE void pt_madd(Grp<G> g, Lane<NS>* L, int p, bool projective, Next next) {
  int32_t *x1 = L->s[p], *y1 = L->s[p + 1], *z1 = L->s[p + 2], *t1 = L->s[p + 3];
  int32_t *a = L->s[T0], *b = L->s[T1], *c = L->s[T2], *dd = L->s[T3];
  const int32_t *yplus = L->stage[0], *yminus = L->stage[1];
  fe::sub_add(g, a, b, y1, x1);
  fe::mul(g, a, a, yminus);
  fe::mul(g, b, b, yplus);
  if (projective) {
    fe::mul(g, c, t1, L->stage[3]);
    fe::mul(g, dd, z1, L->stage[2]);
  } else {
    fe::mul(g, c, t1, L->stage[2]);
    fe::mul_small(g, dd, z1, 2);
  }
  if (next.src != nullptr) fetch_entry(g, L->stage, next.src, next.cstride, next.lstride, next.ncoord);
  int32_t *e = x1, *h = y1, *f = a, *gg = b;  // x1, y1, a and b are spent
  fe::sub_add(g, e, h, b, a);
  fe::sub_add(g, f, gg, dd, c);
  fe::mul(g, t1, e, h);
  fe::mul(g, z1, f, gg);
  fe::mul(g, x1, e, f);
  fe::mul(g, y1, gg, h);
}

// p += q: pt_add (add-2008-hwcd-3, a = -1, k = 2d).
template <int G, int NS>
FE_HD FE_NOINLINE void pt_add(Grp<G> g, Lane<NS>* L, const Consts& k, int p, const int32_t* x2,
                              const int32_t* y2, const int32_t* z2, const int32_t* t2) {
  int32_t *x1 = L->s[p], *y1 = L->s[p + 1], *z1 = L->s[p + 2], *t1 = L->s[p + 3];
  int32_t *a = L->s[T0], *b = L->s[T1], *c = L->s[T2], *dd = L->s[T3];
  fe::sub(g, a, y1, x1);
  fe::sub(g, b, y2, x2);
  fe::mul(g, a, a, b);
  fe::add(g, b, y1, x1);
  fe::add(g, c, y2, x2);
  fe::mul(g, b, b, c);
  fe::mul(g, c, t1, k[K_TWO_D]);
  fe::mul(g, c, c, t2);
  fe::mul(g, dd, z1, z2);
  fe::mul_small(g, dd, dd, 2);
  int32_t *e = x1, *h = y1, *f = a, *gg = b;  // x1, y1, a and b are spent
  fe::sub_add(g, e, h, b, a);
  fe::sub_add(g, f, gg, dd, c);
  fe::mul(g, t1, e, h);
  fe::mul(g, z1, f, gg);
  fe::mul(g, x1, e, f);
  fe::mul(g, y1, gg, h);
}

// p = [2]p: pt_double (dbl-2008-hwcd).  T is not read, so it holds e,
// and Z holds g once Z^2 is formed.
template <int G, int NS>
FE_HD FE_NOINLINE void pt_double(Grp<G> g, Lane<NS>* L, int p) {
  int32_t *x1 = L->s[p], *y1 = L->s[p + 1], *z1 = L->s[p + 2], *t1 = L->s[p + 3];
  int32_t *a = L->s[T0], *b = L->s[T1], *c = L->s[T2], *h = L->s[T3];
  int32_t *e = t1, *gg = z1, *f = a;
  fe::sq(g, a, x1, 1);
  fe::sq(g, b, y1, 1);
  fe::sq(g, c, z1, 1);
  fe::mul_small(g, c, c, 2);
  fe::add(g, h, a, b);
  fe::add(g, e, x1, y1);
  fe::sq(g, e, e, 1);
  fe::sub(g, e, h, e);
  fe::sub(g, gg, a, b);
  fe::add(g, f, c, gg);  // a is spent
  fe::mul(g, x1, e, f);
  fe::mul(g, y1, gg, h);
  fe::mul(g, z1, f, gg);
  fe::mul(g, t1, e, h);
}

// Where a decompression keeps its nine scratch elements (u, v, v3, v7,
// two temporaries, pow22523's three): slot x(m) for m < 9.  FixedScratch
// is P1, the temporaries and P2; BaseScratch the nine slots from `base`,
// a run-time value, so that quarters that decompress side by side run
// one function and stay converged.
struct FixedScratch {
  FE_HD FE_INLINE int operator()(int m) const { return m < 4 ? P1 + m : m < 8 ? T0 + m - 4 : P2; }
};
struct BaseScratch {
  int base;
  FE_HD FE_INLINE int operator()(int m) const { return base + m; }
};

// ZIP-215 decompression (decompress) of the 32 bytes at enc[0], enc[ld],
// ... -- a lane's column of the packed rows at the encoding's first row:
// A at row 0, R at row 32.  Leaves x, y and t = xy in slots out, out + 1
// and out + 2 (z is one) and returns the validity.  Scratch: the slots
// of `x` (P1, P2 and the temporaries by default), so `out` must lie
// outside them.
template <int G, int NS, class S = FixedScratch>
FE_HD FE_NOINLINE bool decompress(Grp<G> g, const uint8_t* enc, int64_t ld, Lane<NS>* L,
                                  const Consts& k, int out, S x = S()) {
  const int32_t* one = k[K_ONE];
  int32_t *xo = L->s[out], *y = L->s[out + 1];
  int32_t *u = L->s[x(0)], *v = L->s[x(1)], *v3 = L->s[x(2)], *v7 = L->s[x(3)];
  int32_t *a = L->s[x(4)], *b = L->s[x(5)];
  const int32_t sign = enc[31 * ld] >> 7;
  fe::from_bytes_le(g, y, enc, ld);
  // clear bit 255: limb 25 covers bits [250, 260), so bit 255 is its bit 5
  FE_PHASE(g) {
    if (r == (NL - 1) % G) y[NL - 1] -= sign << 5;
  }
  fe::sq(g, a, y, 1);  // yy
  fe::sub(g, u, a, one);
  fe::mul(g, v, a, k[K_D]);
  fe::add(g, v, v, one);
  fe::sq(g, a, v, 1);
  fe::mul(g, v3, a, v);
  fe::sq(g, a, v3, 1);
  fe::mul(g, v7, a, v);
  fe::mul(g, a, u, v7);
  fe::pow22523(g, b, a, L->s[x(6)], L->s[x(7)], L->s[x(8)]);
  fe::mul(g, a, u, v3);
  fe::mul(g, xo, a, b);
  fe::sq(g, a, xo, 1);
  fe::mul(g, a, v, a);  // vxx
  const bool ok1 = fe::eq(g, a, u);
  fe::neg(g, b, u);
  const bool ok2 = fe::eq(g, a, b);
  fe::mul(g, b, xo, k[K_SQRT_M1]);
  fe::select_into(g, ok2, xo, b);
  const bool flip = fe::is_odd(g, xo) != (sign == 1);
  fe::neg(g, b, xo);
  fe::select_into(g, flip, xo, b);
  fe::mul(g, L->s[out + 2], xo, y);
  return ok1 || ok2;
}

// -- a lane on Q quarters of G threads ----------------------------------
//
// A Team runs one lane on Q groups of G threads, its quarters (Q in {1,
// 2, 4}; each a Grp<G> of field.cuh).  A stage's independent jobs (the
// products of one step of a point formula) are spread over the quarters,
// job j on quarter j % Q; a limb-parallel step is spread over all Q * G
// threads, limb k on thread k mod Q * G; the lane meets at a barrier after
// each.  Q = 1 runs a stage's jobs in turn on one group.  The barrier is
// __syncwarp over the lane's threads when they lie in one warp, and a
// named barrier (`bar`, Q * G threads) when they span warps.  Under a
// host compiler the jobs of a stage run one after another, in order or,
// with `reverse`, last to first: a job that reads a slot another job of
// its stage writes shows as a difference between the two orders.
template <int Q, int G>
struct Team {
  static constexpr int NT = Q * G;
  Grp<G> g;  // this thread's quarter
#ifdef __CUDA_ARCH__
  int q;          // the quarter's index in the lane
  int tid;        // the thread's index in the lane, q * G + rank
  unsigned mask;  // NT <= 32: the lane's threads in the warp
  int bar;        // NT > 32: the named barrier
  __device__ FE_INLINE void sync() const {
    if (NT > 32) {
      asm volatile("barrier.sync %0, %1;" ::"r"(bar), "r"(NT) : "memory");
    } else if (NT > 1) {
      __syncwarp(NT == 32 ? 0xffffffffu : mask);
    }
  }
#else
  bool reverse;
  FE_INLINE void sync() const {}
#endif
};

// True on one thread of the group (under a host compiler, where a group
// is simulated, on the one pass).
template <int G>
FE_HD FE_INLINE bool lead(Grp<G> g) {
#ifdef __CUDA_ARCH__
  return g.rank == 0;
#else
  (void)g;
  return true;
#endif
}

// Device loops below have compile-time trip counts and a compile-time
// job index where the lane has one quarter: a product is then never
// called under a branch that the compiler must treat as divergent.

// f(i) for each i < N, spread over the lane's threads; no barrier.
template <int N, int Q, int G, class F>
FE_HD FE_INLINE void each(Team<Q, G> t, F&& f) {
#ifdef __CUDA_ARCH__
  constexpr int NT = Q * G;
#pragma unroll
  for (int i = 0; i < (N + NT - 1) / NT; ++i) {
    const int k = (NT == 1 ? 0 : t.tid) + i * NT;
    if (N % NT == 0 || k < N) f(k);
  }
#else
  (void)t;
  for (int i = 0; i < N; ++i) f(i);
#endif
}

// A limb-parallel step: f(k) for each limb k, then the barrier.  f reads
// all of its operands' limb k before it writes any output's, so outputs
// may alias operands.
template <int Q, int G, class F>
FE_HD FE_INLINE void limbs(Team<Q, G> t, F&& f) {
  each<NL>(t, f);
  t.sync();
}

// A stage: job(j) for j < N, job j on quarter j % Q, then the barrier.
template <int N, int Q, int G, class F>
FE_HD FE_INLINE void stage(Team<Q, G> t, F&& job) {
#ifdef __CUDA_ARCH__
#pragma unroll
  for (int i = 0; i < (N + Q - 1) / Q; ++i) {
    const int j = (Q == 1 ? 0 : t.q) + i * Q;
    if (N % Q == 0 || j < N) job(j);
  }
  t.sync();
#else
  for (int i = 0; i < N; ++i) job(t.reverse ? N - 1 - i : i);
#endif
}

// The j-th of four values.  A stage's quarters pick their operands with
// it and make one call, so that quarters of one warp stay converged.
template <class P>
FE_HD FE_INLINE P pick(int j, P p0, P p1, P p2, P p3) {
  return j == 0 ? p0 : j == 1 ? p1 : j == 2 ? p2 : p3;
}

FE_HD FE_INLINE int32_t add32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
FE_HD FE_INLINE int32_t sub32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}

template <int Q, int G, int NS>
FE_HD FE_INLINE void set_identity_q(Team<Q, G> t, Lane<NS>* L, int p) {
  limbs(t, [&](int k) {
    const int32_t one = k == 0 ? 1 : 0;
    L->s[p][k] = 0, L->s[p + 1][k] = one, L->s[p + 2][k] = one, L->s[p + 3][k] = 0;
  });
}

// Start copying one table entry into dst (as fetch_entry), spread over
// the lane's threads.
template <int Q, int G>
FE_HD FE_INLINE void fetch_entry_q(Team<Q, G> t, int32_t (*dst)[NL], const int32_t* src,
                                   int64_t cstride, int64_t lstride, int ncoord) {
  each<4 * NL>(t, [&](int idx) {
    const int c = idx / NL, i = idx - c * NL;
    if (c < ncoord) copy_async4(&dst[c][i], src + c * cstride + i * lstride);
  });
}

// The four-way point formulas: pt_double's, pt_add's and pt_madd's
// operations on the same operands, in the same order within each chain,
// so the limbs are theirs; only the independent products of a step run
// side by side, as one stage.  No job reads a slot that another job of
// its stage writes: each formula ends with e, f, g and h in T0-T3 and the
// stage X = ef, Y = gh, Z = fg, T = eh.
template <int Q, int G, int NS>
FE_HD FE_INLINE void ext_products(Team<Q, G> t, Lane<NS>* L, int p) {
  int32_t *e = L->s[T0], *f = L->s[T1], *gg = L->s[T2], *h = L->s[T3];
  stage<4>(t, [&](int j) {
    fe::mul(t.g, L->s[p + j], pick(j, e, gg, f, e), pick(j, f, h, gg, h));
  });
}

// p = [2]p (pt_double): four squarings -- X^2, Y^2, Z^2, (X + Y)^2 in
// T0-T3 -- then e = h - (X + Y)^2, f = 2Z^2 + g, g = X^2 - Y^2, h = X^2 +
// Y^2, then the four products: a depth of two.
template <int Q, int G, int NS>
FE_HD FE_NOINLINE void pt_double_q(Team<Q, G> t, Lane<NS>* L, int p) {
  int32_t *x1 = L->s[p], *y1 = L->s[p + 1], *z1 = L->s[p + 2];
  int32_t *t0 = L->s[T0], *t1 = L->s[T1], *t2 = L->s[T2], *t3 = L->s[T3];
  limbs(t, [&](int k) { t3[k] = add32(x1[k], y1[k]); });
  stage<4>(t, [&](int j) { fe::sq(t.g, pick(j, t0, t1, t2, t3), pick(j, x1, y1, z1, t3), 1); });
  limbs(t, [&](int k) {
    const int32_t a = t0[k], b = t1[k], c = t2[k], s = t3[k];
    const int32_t h = add32(a, b), gg = sub32(a, b);
    t0[k] = sub32(h, s);                                                      // e
    t1[k] = add32(static_cast<int32_t>(static_cast<uint32_t>(c) * 2u), gg);  // f
    t2[k] = gg;
    t3[k] = h;
  });
  ext_products(t, L, p);
}

// e, f, g, h into T0-T3 from a = T0, b = `bs`, c = T (the point's slot
// p + 3) and dd: e = b - a, f = dd - c, g = dd + c, h = b + a.
template <int Q, int G, int NS, class DD>
FE_HD FE_INLINE void efgh(Team<Q, G> t, Lane<NS>* L, int p, const int32_t* bs, DD dd) {
  int32_t *t0 = L->s[T0], *t1 = L->s[T1], *t2 = L->s[T2], *t3 = L->s[T3];
  const int32_t* c = L->s[p + 3];
  limbs(t, [&](int k) {
    const int32_t a = t0[k], b = bs[k], ck = c[k], d = dd(k);
    t0[k] = sub32(b, a);
    t1[k] = sub32(d, ck);
    t2[k] = add32(d, ck);
    t3[k] = add32(b, a);
  });
}

// p += q (pt_add): a = (Y1 - X1)(Y2 - X2), b = (Y1 + X1)(Y2 + X2), c =
// T1 2d and dd = Z1 Z2 side by side (c in T1's slot, dd in Z1's), then c
// *= T2 alone, then the four products: a depth of three.
template <int Q, int G, int NS>
FE_HD FE_NOINLINE void pt_add_q(Team<Q, G> t, Lane<NS>* L, const Consts& k, int p,
                                const int32_t* x2, const int32_t* y2, const int32_t* z2,
                                const int32_t* t2) {
  int32_t *x1 = L->s[p], *y1 = L->s[p + 1], *z1 = L->s[p + 2], *t1 = L->s[p + 3];
  int32_t *s0 = L->s[T0], *s1 = L->s[T1], *s2 = L->s[T2], *s3 = L->s[T3];
  limbs(t, [&](int i) {
    const int32_t xa = x1[i], ya = y1[i], xb = x2[i], yb = y2[i];
    s0[i] = sub32(ya, xa);
    s1[i] = sub32(yb, xb);
    s2[i] = add32(ya, xa);
    s3[i] = add32(yb, xb);
  });
  stage<4>(t, [&](int j) {
    int32_t* o = pick(j, s0, s2, t1, z1);
    fe::mul(t.g, o, o, pick<const int32_t*>(j, s1, s3, k[K_TWO_D], z2));
  });
  stage<1>(t, [&](int) { fe::mul(t.g, t1, t1, t2); });
  efgh(t, L, p, s2, [&](int i) { return static_cast<int32_t>(static_cast<uint32_t>(z1[i]) * 2u); });
  ext_products(t, L, p);
}

// p += q as pt_add_q, for the table build, which also wants p's own
// projective Niels form (Y+X, Y-X, 2Z, 2dT) as table entry `j`: the
// first limb step's Y1+X1 and Y1-X1 and 2Z1, and stage 1's T1 2d, copied
// to out[c * NL + i][j] (coordinate c, limb i) before they are spent.
// c = (T1 2d) T2 goes to a spent temporary (T1's slot), so T1 2d stays
// until the limb step that forms e, f, g and h copies it.  The same
// operations on the same operands as pt_add_q: p's limbs are its limbs,
// and the entry's are the plain build's (its 2dT is T 2d).
template <int Q, int G, int NS>
FE_HD FE_NOINLINE void pt_add_q_niels(Team<Q, G> t, Lane<NS>* L, const Consts& k, int p,
                                      const int32_t* x2, const int32_t* y2, const int32_t* z2,
                                      const int32_t* t2, int32_t (*out)[8], int j) {
  int32_t *x1 = L->s[p], *y1 = L->s[p + 1], *z1 = L->s[p + 2], *t1 = L->s[p + 3];
  int32_t *s0 = L->s[T0], *s1 = L->s[T1], *s2 = L->s[T2], *s3 = L->s[T3];
  limbs(t, [&](int i) {
    const int32_t xa = x1[i], ya = y1[i], xb = x2[i], yb = y2[i], za = z1[i];
    const int32_t minus = sub32(ya, xa), plus = add32(ya, xa);
    s0[i] = minus;
    s1[i] = sub32(yb, xb);
    s2[i] = plus;
    s3[i] = add32(yb, xb);
    out[i][j] = plus;
    out[NL + i][j] = minus;
    out[2 * NL + i][j] = static_cast<int32_t>(static_cast<uint32_t>(za) * 2u);
  });
  stage<4>(t, [&](int j4) {
    int32_t* o = pick(j4, s0, s2, t1, z1);
    fe::mul(t.g, o, o, pick<const int32_t*>(j4, s1, s3, k[K_TWO_D], z2));
  });
  stage<1>(t, [&](int) { fe::mul(t.g, s1, t1, t2); });
  // e, f, g, h as efgh, with c in T1's slot; the entry's 2dT out
  limbs(t, [&](int i) {
    const int32_t a = s0[i], b = s2[i], c = s1[i], td = t1[i];
    const int32_t d = static_cast<int32_t>(static_cast<uint32_t>(z1[i]) * 2u);
    s0[i] = sub32(b, a);
    s1[i] = sub32(d, c);
    s2[i] = add32(d, c);
    s3[i] = add32(b, a);
    out[3 * NL + i][j] = td;
  });
  ext_products(t, L, p);
}

// p += (Y+X, Y-X, 2dxy), the entry in L->stage (pt_add_niels): a, b and
// c = T1 2dxy side by side, then the four products: a depth of two.  Once
// the first stage has read the entry, `next` starts loading into the
// same buffer.
template <int Q, int G, int NS>
FE_HD FE_NOINLINE void pt_madd_q(Team<Q, G> t, Lane<NS>* L, int p, Next next) {
  int32_t *x1 = L->s[p], *y1 = L->s[p + 1], *z1 = L->s[p + 2], *t1 = L->s[p + 3];
  int32_t *s0 = L->s[T0], *s1 = L->s[T1];
  limbs(t, [&](int i) {
    const int32_t xa = x1[i], ya = y1[i];
    s0[i] = sub32(ya, xa);
    s1[i] = add32(ya, xa);
  });
  stage<3>(t, [&](int j) {
    int32_t* o = pick(j, s0, s1, t1, t1);
    const int32_t* c = L->stage[2];
    fe::mul(t.g, o, o, pick<const int32_t*>(j, L->stage[1], L->stage[0], c, c));
  });
  if (next.src != nullptr) fetch_entry_q(t, L->stage, next.src, next.cstride, next.lstride, next.ncoord);
  efgh(t, L, p, s1, [&](int i) { return static_cast<int32_t>(static_cast<uint32_t>(z1[i]) * 2u); });
  ext_products(t, L, p);
}

// -- scalars mod L: signed int64 16-bit limbs ---------------------------

// Exact sequential pass (_propagate), in place: limbs to [0, 2^16),
// returning the signed carry out.
FE_HD FE_INLINE int64_t sc_propagate(int64_t* c, int n) {
  int64_t carry = 0;
  for (int i = 0; i < n; ++i) {
    const int64_t t = c[i] + carry;
    c[i] = t & 0xFFFF;
    carry = t >> 16;
  }
  return carry;
}

// The canonical-S check (bytes_lt_l): the 32 bytes at s[0], s[ld], ...
FE_HD FE_INLINE bool bytes_lt_l(const uint8_t* s, int64_t ld) {
  int64_t d[16];
  for (int i = 0; i < 16; ++i)
    d[i] = s[2 * i * ld] + (static_cast<int64_t>(s[(2 * i + 1) * ld]) << 8) - FE_K(kL)[i];
  return sc_propagate(d, 16) < 0;
}

// n (len limbs) -> LO(16) - HI*16c, `width` limbs (_fold_step): three
// relax passes that keep the top limb's own carry.
FE_HD FE_INLINE void fold_step(int64_t (&n)[32], int len, int width) {
  const int nh = len - 16;
  const int plen = nh + 9 - 1;
  int64_t prod[32];
  for (int t = 0; t < plen; ++t) prod[t] = 0;
  for (int j = 0; j < 9; ++j) {
    const int64_t kj = FE_K(kK)[j];
    if (kj != 0) {
      for (int i = 0; i < nh; ++i) prod[j + i] += kj * n[16 + i];
    }
  }
  const int w = width > plen ? width : plen;
  int64_t out[32];
  for (int t = 0; t < w; ++t)
    out[t] = (t < 16 ? n[t] : 0) - (t < plen ? prod[t] : 0);
  for (int pass = 0; pass < 3; ++pass) {
    int64_t carry[32];
    for (int t = 0; t < w; ++t) carry[t] = out[t] >> 16;
    carry[w - 1] = 0;
    for (int t = 0; t < w; ++t) out[t] -= carry[t] * 65536;
    for (int t = w - 1; t >= 1; --t) out[t] += carry[t - 1];
  }
  for (int t = 0; t < width; ++t) n[t] = out[t];
}

// The 64-byte little-endian digest at d[0], d[stride], ... -> its 16
// canonical limbs mod L (reduce_digest).  Static: not a template and not
// inlined, so each kernel source keeps its own copy.
static FE_HD FE_NOINLINE void reduce_digest(const uint8_t* d, int64_t stride, int64_t (&k)[16]) {
  int64_t n[32];
  for (int i = 0; i < 32; ++i)
    n[i] = d[2 * i * stride] + (static_cast<int64_t>(d[(2 * i + 1) * stride]) << 8);
  fold_step(n, 32, 25);  // |n| < 2^390
  fold_step(n, 25, 18);  // |n| < 2^265
  fold_step(n, 18, 17);  // (-2^135, 2^256 + 2^135)
  int64_t tmp[17];
  // make positive: one add of 16L = 2^256 + 16c always suffices
  for (int t = 0; t < 17; ++t) tmp[t] = n[t];
  if (sc_propagate(tmp, 17) < 0) {
    for (int t = 0; t < 17; ++t) n[t] += FE_K(kL16)[t];
  }
  int64_t limbs[17];
  for (int t = 0; t < 17; ++t) limbs[t] = n[t];
  sc_propagate(limbs, 17);  // in [0, 2^262)
  // approximate quotient: q = floor(n / 2^252) < 2^10
  const int64_t q = (limbs[15] >> 12) + (limbs[16] << 4);
  for (int t = 0; t < 17; ++t) n[t] = limbs[t] - (t < 16 ? FE_K(kL)[t] * q : 0);
  for (int t = 0; t < 17; ++t) tmp[t] = n[t];
  if (sc_propagate(tmp, 17) < 0) {
    for (int t = 0; t < 17; ++t) n[t] += FE_K(kL)[t];
  }
  int64_t diff[17];
  for (int t = 0; t < 17; ++t) diff[t] = n[t] - FE_K(kL)[t];
  if (sc_propagate(diff, 17) >= 0) {
    for (int t = 0; t < 16; ++t) k[t] = diff[t];
  } else {
    sc_propagate(n, 17);
    for (int t = 0; t < 16; ++t) k[t] = n[t];
  }
}

}  // namespace pt
