// GF(2^255-19) on 26 x 10-bit int32 lazy limbs: the device functions
// shared by field.cu (the standalone fe_mul / fe_sq kernels) and
// verify_keyed.cu (the fused keyed verify).
//
// Every function mirrors its plain PyTorch version in
// cometbft_tpu_torch/ops/field.py operation for operation, so the limbs
// are identical, not merely congruent mod p:
//
//   mul_regs / sq_regs   mul_plain / square_plain (51 columns,
//                        _fold_high, relax): the bodies of the
//                        standalone fe_mul / fe_sq kernels
//   add, sub, neg, mul_small                      add, sub, neg, mul_small
//   reduce_full (propagate_seq, narrow, cond_sub_p)  reduce_full
//   eq, is_zero, is_odd                           eq, is_zero, is_odd
//   from_bytes_le                                 from_bytes_le
//   pow22523                                      pow22523
//
// Integer semantics: column sums, products and lazy adds are taken in
// uint32, so they wrap exactly as the int32 tensor arithmetic of the
// plain version does instead of being undefined behaviour.  Carries are
// arithmetic right shifts of the signed value (as torch's >> is), and
// the low part is `c & 1023`, which equals the reference's
// `c - (carry << 10)` without left-shifting a negative number.
//
// Two levels.  The register level (`uint32_t (&)[26]`) is what a
// standalone kernel inlines.  The view level works on a field element
// stored with a stride: limb i of the element at p[i * s].  A view may
// point into shared memory (a lane's slot, s = threads per block), into
// a comb table in device memory (s = the table's minor extent) or at a
// constant below (s = 1).  `mul`, `sq`, `eq`, `is_zero` and `is_odd` at
// the view level are deliberately not inlined: the fused kernel calls
// them at hundreds of sites and keeps one copy of each body.
//
// The file compiles as plain C++ as well (FE_HD is empty without nvcc),
// so the fused kernel's per-lane body can be built and checked on a host
// that has no CUDA compiler.

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

// -- view level --------------------------------------------------------

struct FeIn {
  const int32_t* p;
  int s;
  FE_HD FE_INLINE int32_t operator[](int i) const { return p[i * s]; }
};

struct Fe {
  int32_t* p;
  int s;
  FE_HD FE_INLINE int32_t& operator[](int i) const { return p[i * s]; }
  FE_HD FE_INLINE operator FeIn() const { return FeIn{p, s}; }
};

// A constant from the tables above as a view.
#define FE_CONST(name) (::fe::FeIn{::fe::FE_K(name), 1})

FE_HD FE_INLINE void load(FeIn a, uint32_t (&x)[NL]) {
#pragma unroll
  for (int i = 0; i < NL; ++i) x[i] = static_cast<uint32_t>(a[i]);
}

FE_HD FE_INLINE void store(Fe o, const uint32_t (&x)[NL]) {
#pragma unroll
  for (int i = 0; i < NL; ++i) o[i] = static_cast<int32_t>(x[i]);
}

// out = a * b.  Outputs alias inputs freely: every operand limb is in
// registers before the first store.
FE_HD FE_NOINLINE void mul(Fe out, FeIn a, FeIn b) {
  uint32_t x[NL], y[NL];
  load(a, x);
  load(b, y);
  mul_regs(x, y, x);
  store(out, x);
}

// out = a^(2^reps): `reps` squarings in registers.
FE_HD FE_NOINLINE void sq(Fe out, FeIn a, int reps) {
  uint32_t x[NL];
  load(a, x);
#pragma unroll 1
  for (int r = 0; r < reps; ++r) sq_regs(x);
  store(out, x);
}

FE_HD FE_INLINE void add(Fe out, FeIn a, FeIn b) {
#pragma unroll
  for (int i = 0; i < NL; ++i)
    out[i] = static_cast<int32_t>(static_cast<uint32_t>(a[i]) + static_cast<uint32_t>(b[i]));
}

FE_HD FE_INLINE void sub(Fe out, FeIn a, FeIn b) {
#pragma unroll
  for (int i = 0; i < NL; ++i)
    out[i] = static_cast<int32_t>(static_cast<uint32_t>(a[i]) - static_cast<uint32_t>(b[i]));
}

FE_HD FE_INLINE void neg(Fe out, FeIn a) {
#pragma unroll
  for (int i = 0; i < NL; ++i)
    out[i] = static_cast<int32_t>(0u - static_cast<uint32_t>(a[i]));
}

FE_HD FE_INLINE void mul_small(Fe out, FeIn a, uint32_t k) {
#pragma unroll
  for (int i = 0; i < NL; ++i) out[i] = static_cast<int32_t>(static_cast<uint32_t>(a[i]) * k);
}

FE_HD FE_INLINE void copy(Fe out, FeIn a) {
#pragma unroll
  for (int i = 0; i < NL; ++i) out[i] = a[i];
}

// select(mask, a, b) for one lane: out = a where `mask`, else unchanged.
FE_HD FE_INLINE void select_into(bool mask, Fe out, FeIn a) {
  if (mask) copy(out, a);
}

// Canonical equality of lazy elements: reduce_full(a - b) == 0.
FE_HD FE_NOINLINE bool eq(FeIn a, FeIn b) {
  int32_t x[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i)
    x[i] = static_cast<int32_t>(static_cast<uint32_t>(a[i]) - static_cast<uint32_t>(b[i]));
  reduce_full_regs(x);
  int32_t any = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) any |= x[i];
  return any == 0;
}

FE_HD FE_NOINLINE bool is_zero(FeIn a) {
  int32_t x[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) x[i] = a[i];
  reduce_full_regs(x);
  int32_t any = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) any |= x[i];
  return any == 0;
}

// Low bit of the canonical value.
FE_HD FE_NOINLINE bool is_odd(FeIn a) {
  int32_t x[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) x[i] = a[i];
  reduce_full_regs(x);
  return (x[0] & 1) != 0;
}

// 32 little-endian bytes at b[0], b[stride], ... -> narrow limbs (value
// < 2^256, unreduced): limb i covers bits [10i, 10i+10), three byte
// taps from byte 10i/8, bytes past 31 read as zero.
FE_HD FE_INLINE void from_bytes_le(Fe out, const uint8_t* b, int64_t stride) {
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int k = (10 * i) / 8;
    int32_t word = b[k * stride];
    if (k + 1 < 32) word |= static_cast<int32_t>(b[(k + 1) * stride]) << 8;
    if (k + 2 < 32) word |= static_cast<int32_t>(b[(k + 2) * stride]) << 16;
    out[i] = (word >> ((10 * i) % 8)) & static_cast<int32_t>(MASK);
  }
}

// out = z^((p-5)/8), the square-root chain core (pow22523); t0..t2 are
// scratch elements.  `out` may alias z.
FE_HD FE_NOINLINE void pow22523(Fe out, FeIn z, Fe t0, Fe t1, Fe t2) {
  sq(t0, z, 1);          // z^2
  sq(t1, t0, 2);         // z^8
  mul(t1, z, t1);        // z^9
  mul(t0, t0, t1);       // z^11
  sq(t0, t0, 1);         // z^22
  mul(t0, t1, t0);       // z^31 = z^(2^5-1)
  sq(t1, t0, 5);         // z^(2^10-2^5)
  mul(t0, t1, t0);       // z^(2^10-1)
  sq(t1, t0, 10);
  mul(t1, t1, t0);       // z^(2^20-1)
  sq(t2, t1, 20);
  mul(t1, t2, t1);       // z^(2^40-1)
  sq(t1, t1, 10);
  mul(t0, t1, t0);       // z^(2^50-1)
  sq(t1, t0, 50);
  mul(t1, t1, t0);       // z^(2^100-1)
  sq(t2, t1, 100);
  mul(t1, t2, t1);       // z^(2^200-1)
  sq(t1, t1, 50);
  mul(t0, t1, t0);       // z^(2^250-1)
  sq(t0, t0, 2);         // z^(2^252-4)
  mul(out, t0, z);       // z^(2^252-3) = z^((p-5)/8)
}

}  // namespace fe
