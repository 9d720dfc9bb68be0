// GF(2^255-19) on 26 x 10-bit int32 lazy limbs: the device functions
// shared by field.cu (the standalone fe_mul / fe_sq kernels) and
// verify_keyed.cu (the fused keyed verify).
//
// Every function mirrors its plain PyTorch version in
// cometbft_tpu_torch/ops/field.py operation for operation, so the limbs
// are identical, not merely congruent mod p:
//
//   mul_regs / sq_regs, mul / sq   mul_plain / square_plain (51 columns,
//                                  _fold_high, relax)
//   add, sub, neg, mul_small       add, sub, neg, mul_small
//   reduce_full (propagate_seq, narrow, cond_sub_p)  reduce_full
//   eq, is_zero, is_odd            eq, is_zero, is_odd
//   from_bytes_le                  from_bytes_le
//   pow22523                       pow22523
//
// Integer semantics: column sums, products and lazy adds are taken in
// uint32, so they wrap exactly as the int32 tensor arithmetic of the
// plain version does instead of being undefined behaviour.  Carries are
// arithmetic right shifts of the signed value (as torch's >> is), and
// the low part is `c & 1023`, which equals the reference's
// `c - (carry << 10)` without left-shifting a negative number.  Because
// uint32 addition is exact mod 2^32 in any order, a column may be summed
// in any order, and a square may use the product's column formula
// (sum_i x_i x_(j-i) equals the plain square's 2 x_i x_(j-i) + x_(j/2)^2).
//
// Two levels.  The register level (`uint32_t (&)[26]`) is what one
// thread inlines: the bodies of the standalone fe_mul / fe_sq kernels.
// The group level runs one lane's field element on a group of G threads
// of one warp (G divides 32): an element is 26 consecutive words of
// shared memory, and each step is a sequence of phases.  In a phase rank
// r handles its limbs (k = r, r + G, ... for linear steps); a phase reads
// only what earlier phases wrote and ends with __syncwarp over the group.
// Steps that need every limb at once (the canonical-form tests) run on
// every rank redundantly and end with the same barrier.  A product is
// the register level for G = 1 and, for a group, one phase: each rank's
// columns and its part of the fold stay in registers, and a pass's
// carries cross ranks by warp shuffle.
// `mul`, `sq`, `eq`, `is_zero`, `is_odd` and `pow22523` are deliberately
// not inlined: the fused kernel calls them at hundreds of sites.
//
// The file compiles as plain C++ as well (FE_HD is empty without nvcc, a
// phase is a loop over the G ranks and a shuffle reads another rank's
// slot), so the fused kernel's per-lane body can be built and checked on
// a host that has no CUDA compiler, at every group size.

#pragma once

#include <cstdint>

#ifdef __CUDACC__
#define FE_HD __host__ __device__
#define FE_INLINE __forceinline__
#define FE_NOINLINE __noinline__
// A constant table: __device__ memory for the device pass, a host array
// for the host pass; FE_K(name) picks the one of the pass being compiled.
#define FE_TABLE(type, name, n, ...)               \
  __device__ const type name##_d[n] = __VA_ARGS__; \
  static const type name##_h[n] = __VA_ARGS__;
#else
#define FE_HD
#define FE_INLINE inline
#define FE_NOINLINE __attribute__((noinline))
#define FE_TABLE(type, name, n, ...) static const type name##_h[n] = __VA_ARGS__;
#endif

#ifdef __CUDA_ARCH__
#define FE_K(name) name##_d
#else
#define FE_K(name) name##_h
#endif

namespace fe {

constexpr int NL = 26;
constexpr int NCOL = 2 * NL - 1;  // 51
constexpr uint32_t MASK = 1023;
constexpr uint32_t WRAP = 608;    // 2^260 mod p

// Limbs of 1, p, the curve's d and 2d, and sqrt(-1) (ops/field.py
// ONE / P_LIMBS, ops/curve.py D_LIMBS / TWO_D_LIMBS / SQRT_M1_LIMBS).
FE_TABLE(int32_t, kOne, NL,
         {1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0})
FE_TABLE(int32_t, kP, NL,
         {1005, 1023, 1023, 1023, 1023, 1023, 1023, 1023, 1023, 1023, 1023, 1023, 1023,
          1023, 1023, 1023, 1023, 1023, 1023, 1023, 1023, 1023, 1023, 1023, 1023, 31})
FE_TABLE(int32_t, kD, NL,
         {163, 606, 309, 808, 845, 378, 695, 866, 321, 848, 164, 448, 0, 550, 926,
          477, 121, 464, 204, 462, 1022, 731, 738, 435, 515, 20})
FE_TABLE(int32_t, kTwoD, NL,
         {345, 188, 619, 592, 667, 757, 366, 709, 643, 672, 329, 896, 0, 76, 829,
          955, 242, 928, 408, 924, 1020, 439, 453, 871, 6, 9})
FE_TABLE(int32_t, kSqrtM1, NL,
         {176, 936, 160, 157, 539, 315, 908, 913, 303, 427, 384, 268, 815, 489, 957,
          247, 153, 832, 692, 44, 479, 1008, 4, 146, 899, 10})

// -- register level ----------------------------------------------------

FE_HD FE_INLINE int32_t asr10(uint32_t x) { return static_cast<int32_t>(x) >> 10; }

// 51 columns -> 26 lazy limbs, then four relax passes; `c` is
// clobbered.  Mirrors _fold_high + relax exactly.
FE_HD FE_INLINE void fold_relax(uint32_t (&c)[NCOL], uint32_t (&out)[NL]) {
  uint32_t high[NL + 1];
#pragma unroll
  for (int j = 0; j < NL - 1; ++j) high[j] = c[NL + j];
  high[NL - 1] = 0;
  high[NL] = 0;
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    int32_t carry[NL + 1];
#pragma unroll
    for (int j = 0; j <= NL; ++j) {
      carry[j] = asr10(high[j]);
      high[j] &= MASK;
    }
    // row 0 receives nothing; row 26's carry leaves the block (it is
    // zero for every input, as in the reference's _shift_up)
#pragma unroll
    for (int j = 1; j <= NL; ++j) high[j] += static_cast<uint32_t>(carry[j - 1]);
  }
#pragma unroll
  for (int i = 0; i < NL; ++i) out[i] = c[i] + high[i] * WRAP;
  out[0] += high[NL] * (WRAP * WRAP);
#pragma unroll
  for (int pass = 0; pass < 4; ++pass) {
    int32_t carry[NL];
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      carry[j] = asr10(out[j]);
      out[j] &= MASK;
    }
    out[0] += static_cast<uint32_t>(carry[NL - 1]) * WRAP;
#pragma unroll
    for (int j = 1; j < NL; ++j) out[j] += static_cast<uint32_t>(carry[j - 1]);
  }
}

// out = x * y (mul_plain).  `out` may alias x or y.
FE_HD FE_INLINE void mul_regs(const uint32_t (&x)[NL], const uint32_t (&y)[NL],
                              uint32_t (&out)[NL]) {
  uint32_t c[NCOL];
#pragma unroll
  for (int j = 0; j < NCOL; ++j) c[j] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
#pragma unroll
    for (int j = 0; j < NL; ++j) c[i + j] += x[i] * y[j];
  }
  fold_relax(c, out);
}

// x = x^2 in place (one step of square_plain): cols[j] =
// sum_{i < j-i} 2x[i]x[j-i] + (j even) x[j/2]^2 -- 351 products.
FE_HD FE_INLINE void sq_regs(uint32_t (&x)[NL]) {
  uint32_t c[NCOL];
#pragma unroll
  for (int j = 0; j < NCOL; ++j) c[j] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    c[2 * i] += x[i] * x[i];
    const uint32_t d = x[i] + x[i];
#pragma unroll
    for (int j = i + 1; j < NL; ++j) c[i + j] += d * x[j];
  }
  fold_relax(c, x);
}

// Exact sequential carry pass (_propagate_seq): limbs to [0, 2^10),
// returning the signed carry out of weight 2^260.
FE_HD FE_INLINE int32_t propagate_seq(int32_t (&c)[NL]) {
  int32_t carry = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int32_t t = static_cast<int32_t>(static_cast<uint32_t>(c[i]) +
                                           static_cast<uint32_t>(carry));
    c[i] = t & static_cast<int32_t>(MASK);
    carry = t >> 10;
  }
  return carry;
}

// Lazy form -> canonical [0, p), in place (reduce_full: _narrow, then
// _cond_sub_p twice).
FE_HD FE_INLINE void reduce_full_regs(int32_t (&a)[NL]) {
  // relax(a, iters=2)
  for (int pass = 0; pass < 2; ++pass) {
    int32_t carry[NL];
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      carry[j] = a[j] >> 10;
      a[j] &= static_cast<int32_t>(MASK);
    }
    a[0] = static_cast<int32_t>(static_cast<uint32_t>(a[0]) +
                                static_cast<uint32_t>(carry[NL - 1]) * WRAP);
#pragma unroll
    for (int j = 1; j < NL; ++j) a[j] += carry[j - 1];
  }
  int32_t carry = propagate_seq(a);
  a[0] += static_cast<int32_t>(WRAP) * carry;
  carry = propagate_seq(a);
  a[0] += static_cast<int32_t>(WRAP) * carry;
  propagate_seq(a);
  // value < 2^260; split the top limb at bit 255: t*2^250 becomes
  // 19*(t >> 5) at limb 0 + (t & 31)*2^250
  const int32_t t = a[NL - 1];
  a[NL - 1] = t & 31;
  a[0] += 19 * (t >> 5);
  propagate_seq(a);
  // _cond_sub_p, twice
  for (int k = 0; k < 2; ++k) {
    int32_t diff[NL];
#pragma unroll
    for (int i = 0; i < NL; ++i) diff[i] = a[i] - FE_K(kP)[i];
    const int32_t borrow = propagate_seq(diff);
    if (borrow >= 0) {
#pragma unroll
      for (int i = 0; i < NL; ++i) a[i] = diff[i];
    }
  }
}

// -- group level -------------------------------------------------------

// The group a lane runs on.  On the device: the thread's rank in the
// group and the group's lanes of the warp, for __syncwarp.  Under a host
// compiler a phase loops over the ranks instead, and there is no barrier.
template <int G>
struct Grp {
  static_assert(G >= 1 && G <= 32 && (32 % G) == 0, "G divides 32");
#ifdef __CUDA_ARCH__
  int rank;
  unsigned mask;
  // a lone thread's own shared-memory accesses are already in order
  __device__ FE_INLINE void sync() const {
    if (G > 1) __syncwarp(mask);
  }
#else
  FE_INLINE void sync() const {}
#endif
};

// FE_PHASE(g) { body }: the body runs with `r` bound to each rank of the
// group, then the group meets at a barrier.  FE_RANKS(g) is the same
// without the barrier: a step whose results stay in registers, travel by
// shuffle, or are asynchronous copies waited for later.
#ifdef __CUDA_ARCH__
#define FE_PHASE(g) \
  for (int r = (g).rank, fe_once_ = 1; fe_once_; fe_once_ = 0, (g).sync())
#define FE_RANKS(g) for (int r = (g).rank, fe_once_ = 1; fe_once_; fe_once_ = 0)
#else
#define FE_PHASE(g) for (int r = 0; r < G; ++r)
#define FE_RANKS(g) for (int r = 0; r < G; ++r)
#endif

// Per-rank values that live across the steps of one phase, exchanged
// with warp shuffles.  On the device a thread keeps its own value
// (FE_MINE(x) is x[0]); under a host compiler each step loops over the
// ranks, so a value is an array over the ranks (FE_MINE(x) is x[r]) and
// a shuffle reads another rank's slot.  A step reads only what earlier
// steps wrote, and writes no array it reads from another rank.
#ifdef __CUDA_ARCH__
#define FE_NR 1
#define FE_MINE(x) ((x)[0])
#else
#define FE_NR G
#define FE_MINE(x) ((x)[r])
#endif

// x on rank src (every rank of the group must call it).
template <int G>
FE_HD FE_INLINE uint32_t from_rank(Grp<G> g, const uint32_t* x, int src) {
#ifdef __CUDA_ARCH__
  return __shfl_sync(g.mask, x[0], src, G);
#else
  (void)g;
  return x[src];
#endif
}

// Limbs per rank: rank r owns the limbs k = r + G t, t < NT (a stride,
// so neighbouring ranks touch neighbouring words).
template <int G>
struct Own {
  static constexpr int NT = (NL + G - 1) / G;
};

// The value of limb k - 1's entry of a per-rank array x[t] (limb r + G t)
// for each of this rank's limbs, from the shuffles s[t] = x[t] of rank
// r - 1 (rank G - 1 for rank 0): rank r > 0 takes s[t]; rank 0 takes
// s[t - 1] (limb G t - 1 is rank G - 1's limb of index t - 1) and, for
// limb 0, `wrap`.  `below[t]` must not alias x.
template <int G>
FE_HD FE_INLINE void limbs_below(Grp<G> g, uint32_t (*x)[FE_NR], uint32_t* below, int r,
                                 uint32_t wrap) {
  constexpr int NT = Own<G>::NT;
  uint32_t sh[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) sh[t] = from_rank(g, x[t], r ? r - 1 : G - 1);
#pragma unroll
  for (int t = 0; t < NT; ++t) below[t] = r ? sh[t] : (t ? sh[t - 1] : wrap);
}

// out = a * b (mul_plain).  One thread (G = 1): the register level.  A
// group: one phase, with the columns and the fold in registers.
//
// The columns: rank r forms, for each of its limbs k, column k and
// column 26 + k (high row k) together: sum_i a[i] * b[(k - i) mod 26],
// the terms with i <= k going to column k and the rest to column 26 + k
// (26 terms for every k), each sum split over four partial sums so that
// the multiply-adds do not wait on one another.  a[i] is one word for the
// whole group (a broadcast), and the rank reads b rotated by r, so b's
// word index is consecutive across the ranks and the reads have no bank
// conflicts.
//
// The fold, limb-parallel: each pass moves a carry one limb up, so limb k
// takes limb k - 1's value by a shuffle (limbs_below): the two
// shift-only passes over the high rows (row 0 receives nothing; rows 25
// and 26 start at zero, so row 26 after both passes is
// asr10(asr10(row 24))), the x608 fold with row 26 x608^2 into limb 0,
// and the four relax passes (limb 0 receives limb 25's carry times 608).
// Limbs 26 and up of the last rank exist only as padding: they feed
// nothing that is stored.  `out` may alias a or b: every rank has read
// both before the phase that writes.
template <int G>
FE_HD FE_NOINLINE void mul(Grp<G> g, int32_t* out, const int32_t* a, const int32_t* b) {
  if (G == 1) {
    uint32_t x[NL], y[NL];
#pragma unroll
    for (int i = 0; i < NL; ++i) x[i] = static_cast<uint32_t>(a[i]), y[i] = static_cast<uint32_t>(b[i]);
    mul_regs(x, y, x);
#pragma unroll
    for (int i = 0; i < NL; ++i) out[i] = static_cast<int32_t>(x[i]);
    return;
  }
  constexpr int NT = Own<G>::NT;
  uint32_t lo_[NT][FE_NR], row_[NT][FE_NR], h1_[NT][FE_NR], v_[NT][FE_NR];
  uint32_t c_[2][NT][FE_NR], row24_[FE_NR];
  FE_RANKS(g) {
    uint32_t x[NL], y[NL];
    // ranks past the limbs (G = 32) take rank r - 26's rotation
    const int rr = r < NL ? r : r - NL;
#pragma unroll
    for (int i = 0; i < NL; ++i) x[i] = static_cast<uint32_t>(a[i]);
#pragma unroll
    for (int m = 0; m < NL; ++m) y[m] = static_cast<uint32_t>(b[m + rr < NL ? m + rr : m + rr - NL]);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int k = r + G * t;
      uint32_t lo[4] = {}, hi[4] = {};
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        // k - i = (G t - i) + r; y[(G t - i) mod 26] = b[(k - i) mod 26]
        const int d = i - G * t;
        const uint32_t p = x[i] * y[((G * t - i) % NL + NL) % NL];
        if (d <= 0 || (d < G && d <= r)) {
          lo[i % 4] += p;
        } else {
          hi[i % 4] += p;
        }
      }
      FE_MINE(lo_[t]) = (lo[0] + lo[1]) + (lo[2] + lo[3]);
      // column 51 does not exist: rows 25 and up start at zero
      FE_MINE(row_[t]) = k < NL - 1 ? (hi[0] + hi[1]) + (hi[2] + hi[3]) : 0u;
    }
  }
  FE_RANKS(g) {  // first high pass; row 24 for row 26
    FE_MINE(row24_) = from_rank(g, row_[(NL - 2) / G], (NL - 2) % G);
    uint32_t below[NT];
    limbs_below(g, row_, below, r, 0u);
#pragma unroll
    for (int t = 0; t < NT; ++t)
      FE_MINE(h1_[t]) = (FE_MINE(row_[t]) & MASK) + static_cast<uint32_t>(asr10(below[t]));
  }
  FE_RANKS(g) {  // second high pass, the fold, the first relax carry
    uint32_t below[NT];
    limbs_below(g, h1_, below, r, 0u);
    const uint32_t row26 = static_cast<uint32_t>(asr10(static_cast<uint32_t>(asr10(FE_MINE(row24_)))));
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const uint32_t h2 = (FE_MINE(h1_[t]) & MASK) + static_cast<uint32_t>(asr10(below[t]));
      const uint32_t v = FE_MINE(lo_[t]) + h2 * WRAP + (r == 0 && t == 0 ? row26 * (WRAP * WRAP) : 0u);
      FE_MINE(c_[0][t]) = static_cast<uint32_t>(asr10(v));
      FE_MINE(v_[t]) = v & MASK;
    }
  }
#pragma unroll
  for (int pass = 1; pass < 4; ++pass) {
    uint32_t(*cin)[FE_NR] = c_[(pass - 1) & 1];
    uint32_t(*cout)[FE_NR] = c_[pass & 1];
    FE_RANKS(g) {
      uint32_t below[NT];
      limbs_below(g, cin, below, r, from_rank(g, cin[(NL - 1) / G], (NL - 1) % G) * WRAP);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const uint32_t v = FE_MINE(v_[t]) + below[t];
        FE_MINE(cout[t]) = static_cast<uint32_t>(asr10(v));
        FE_MINE(v_[t]) = v & MASK;
      }
    }
  }
  FE_PHASE(g) {
    uint32_t below[NT];
    limbs_below(g, c_[1], below, r, from_rank(g, c_[1][(NL - 1) / G], (NL - 1) % G) * WRAP);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int k = r + G * t;
      if (k < NL) out[k] = static_cast<int32_t>(FE_MINE(v_[t]) + below[t]);
    }
  }
}

// out = a^(2^reps): `reps` squarings, each the product's column formula
// (one thread: sq_regs, all reps in registers).
template <int G>
FE_HD FE_NOINLINE void sq(Grp<G> g, int32_t* out, const int32_t* a, int reps) {
  if (G == 1) {
    uint32_t x[NL];
#pragma unroll
    for (int i = 0; i < NL; ++i) x[i] = static_cast<uint32_t>(a[i]);
#pragma unroll 1
    for (int rep = 0; rep < reps; ++rep) sq_regs(x);
#pragma unroll
    for (int i = 0; i < NL; ++i) out[i] = static_cast<int32_t>(x[i]);
    return;
  }
  mul(g, out, a, a);
#pragma unroll 1
  for (int rep = 1; rep < reps; ++rep) mul(g, out, out, out);
}

// Limb-parallel steps: each rank reads all its operand limbs before it
// writes an output limb (outputs may alias operands limb for limb), so the
// loads issue together.

template <int G>
FE_HD FE_INLINE void add(Grp<G> g, int32_t* out, const int32_t* a, const int32_t* b) {
  FE_PHASE(g) {
    uint32_t v[Own<G>::NT];
#pragma unroll
    for (int t = 0; t < Own<G>::NT; ++t) {
      const int k = r + G * t;
      if (k < NL) v[t] = static_cast<uint32_t>(a[k]) + static_cast<uint32_t>(b[k]);
    }
#pragma unroll
    for (int t = 0; t < Own<G>::NT; ++t) {
      const int k = r + G * t;
      if (k < NL) out[k] = static_cast<int32_t>(v[t]);
    }
  }
}

template <int G>
FE_HD FE_INLINE void sub(Grp<G> g, int32_t* out, const int32_t* a, const int32_t* b) {
  FE_PHASE(g) {
    uint32_t v[Own<G>::NT];
#pragma unroll
    for (int t = 0; t < Own<G>::NT; ++t) {
      const int k = r + G * t;
      if (k < NL) v[t] = static_cast<uint32_t>(a[k]) - static_cast<uint32_t>(b[k]);
    }
#pragma unroll
    for (int t = 0; t < Own<G>::NT; ++t) {
      const int k = r + G * t;
      if (k < NL) out[k] = static_cast<int32_t>(v[t]);
    }
  }
}

// d = x - y and s = x + y in one phase.
template <int G>
FE_HD FE_INLINE void sub_add(Grp<G> g, int32_t* d, int32_t* s, const int32_t* x,
                             const int32_t* y) {
  FE_PHASE(g) {
    uint32_t vd[Own<G>::NT], vs[Own<G>::NT];
#pragma unroll
    for (int t = 0; t < Own<G>::NT; ++t) {
      const int k = r + G * t;
      if (k < NL) {
        const uint32_t xk = static_cast<uint32_t>(x[k]), yk = static_cast<uint32_t>(y[k]);
        vd[t] = xk - yk;
        vs[t] = xk + yk;
      }
    }
#pragma unroll
    for (int t = 0; t < Own<G>::NT; ++t) {
      const int k = r + G * t;
      if (k < NL) {
        d[k] = static_cast<int32_t>(vd[t]);
        s[k] = static_cast<int32_t>(vs[t]);
      }
    }
  }
}

template <int G>
FE_HD FE_INLINE void neg(Grp<G> g, int32_t* out, const int32_t* a) {
  FE_PHASE(g) {
    uint32_t v[Own<G>::NT];
#pragma unroll
    for (int t = 0; t < Own<G>::NT; ++t) {
      const int k = r + G * t;
      if (k < NL) v[t] = 0u - static_cast<uint32_t>(a[k]);
    }
#pragma unroll
    for (int t = 0; t < Own<G>::NT; ++t) {
      const int k = r + G * t;
      if (k < NL) out[k] = static_cast<int32_t>(v[t]);
    }
  }
}

template <int G>
FE_HD FE_INLINE void mul_small(Grp<G> g, int32_t* out, const int32_t* a, uint32_t m) {
  FE_PHASE(g) {
    uint32_t v[Own<G>::NT];
#pragma unroll
    for (int t = 0; t < Own<G>::NT; ++t) {
      const int k = r + G * t;
      if (k < NL) v[t] = static_cast<uint32_t>(a[k]) * m;
    }
#pragma unroll
    for (int t = 0; t < Own<G>::NT; ++t) {
      const int k = r + G * t;
      if (k < NL) out[k] = static_cast<int32_t>(v[t]);
    }
  }
}

// select(mask, a, out) for one lane: out = a where `mask`, else unchanged.
template <int G>
FE_HD FE_INLINE void select_into(Grp<G> g, bool mask, int32_t* out, const int32_t* a) {
  FE_PHASE(g) {
    if (mask) {
#pragma unroll
      for (int t = 0; t < Own<G>::NT; ++t) {
        const int k = r + G * t;
        if (k < NL) out[k] = a[k];
      }
    }
  }
}

// Canonical equality of lazy elements: reduce_full(a - b) == 0, on every
// rank.
template <int G>
FE_HD FE_NOINLINE bool eq(Grp<G> g, const int32_t* a, const int32_t* b) {
  int32_t x[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i)
    x[i] = static_cast<int32_t>(static_cast<uint32_t>(a[i]) - static_cast<uint32_t>(b[i]));
  reduce_full_regs(x);
  int32_t any = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) any |= x[i];
  g.sync();
  return any == 0;
}

template <int G>
FE_HD FE_NOINLINE bool is_zero(Grp<G> g, const int32_t* a) {
  int32_t x[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) x[i] = a[i];
  reduce_full_regs(x);
  int32_t any = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) any |= x[i];
  g.sync();
  return any == 0;
}

// Low bit of the canonical value.
template <int G>
FE_HD FE_NOINLINE bool is_odd(Grp<G> g, const int32_t* a) {
  int32_t x[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) x[i] = a[i];
  reduce_full_regs(x);
  g.sync();
  return (x[0] & 1) != 0;
}

// 32 little-endian bytes at b[0], b[stride], ... -> narrow limbs (value
// < 2^256, unreduced): limb k covers bits [10k, 10k+10), three byte
// taps from byte 10k/8, bytes past 31 read as zero.
template <int G>
FE_HD FE_INLINE void from_bytes_le(Grp<G> g, int32_t* out, const uint8_t* b, int64_t stride) {
  FE_PHASE(g) {
    for (int k = r; k < NL; k += G) {
      const int j = (10 * k) / 8;
      int32_t word = b[j * stride];
      if (j + 1 < 32) word |= static_cast<int32_t>(b[(j + 1) * stride]) << 8;
      if (j + 2 < 32) word |= static_cast<int32_t>(b[(j + 2) * stride]) << 16;
      out[k] = (word >> ((10 * k) % 8)) & static_cast<int32_t>(MASK);
    }
  }
}

// out = z^((p-5)/8), the square-root chain core (pow22523); t0..t2 are
// scratch elements.  `out` may alias z.
template <int G>
FE_HD FE_NOINLINE void pow22523(Grp<G> g, int32_t* out, const int32_t* z, int32_t* t0,
                                int32_t* t1, int32_t* t2) {
  sq(g, t0, z, 1);       // z^2
  sq(g, t1, t0, 2);      // z^8
  mul(g, t1, z, t1);     // z^9
  mul(g, t0, t0, t1);    // z^11
  sq(g, t0, t0, 1);      // z^22
  mul(g, t0, t1, t0);    // z^31 = z^(2^5-1)
  sq(g, t1, t0, 5);      // z^(2^10-2^5)
  mul(g, t0, t1, t0);    // z^(2^10-1)
  sq(g, t1, t0, 10);
  mul(g, t1, t1, t0);    // z^(2^20-1)
  sq(g, t2, t1, 20);
  mul(g, t1, t2, t1);    // z^(2^40-1)
  sq(g, t1, t1, 10);
  mul(g, t0, t1, t0);    // z^(2^50-1)
  sq(g, t1, t0, 50);
  mul(g, t1, t1, t0);    // z^(2^100-1)
  sq(g, t2, t1, 100);
  mul(g, t1, t2, t1);    // z^(2^200-1)
  sq(g, t1, t1, 50);
  mul(g, t0, t1, t0);    // z^(2^250-1)
  sq(g, t0, t0, 2);      // z^(2^252-4)
  mul(g, out, t0, z);    // z^(2^252-3) = z^((p-5)/8)
}

}  // namespace fe
