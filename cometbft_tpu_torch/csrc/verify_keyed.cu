// Keyed Ed25519 verification after SHA-512, one thread per lane, in one
// launch.
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
// multiply and the square), here as field.cuh's device functions.  Every
// step mirrors the port's plain version (ops/ed25519_verify.py
// `verify_keyed_plain`) operation for operation: the verdict and the
// limbs of [8]q are identical on every lane.
//
// Inputs: the packed rows (104 + bucket, ld) uint8 -- pub[32] | sig[64] |
// msg[bucket] | msglen_le[4] | key_id_le[4], lane j in column j, rows
// `ld` bytes apart (a slice of a wider batch needs no copy) -- and the
// (64, n) uint8 digest SHA-512(R || A || M) from the sha512_padded
// kernel.  Tables: the per-key pool (nwin, 4, 26, m) int32, entry
// key_id * 2^wb + window on the minor axis, its validity (cap,) bool, and
// the comb of B (32, 3, 26, 256) int32.  Outputs: (n,) bool verdicts and,
// when asked for, the (4, 26, n) int32 limbs of [8]q.  A key id outside
// the pool reads key 0's page and is refused (verdict false).
//
// Bound on the H100: per lane about 530 products and 267 squarings at
// 8-bit windows (786 and 267 at 4-bit), ~0.86M int32 instructions,
// against ~23 KB of gathered table entries: bound by operations.  At the
// main path's 256 lanes the operations take ~13 us of the whole card,
// but one lane is one thread, so the time is one warp's ~0.9M dependent
// instructions on each of 8 SMs: latency, not throughput.
//
// Design.  A lane's working set is ~17 field elements (its R, two
// accumulators, the formula temporaries); with fe::mul's ~100 registers
// that exceeds 255 registers, so the elements live in dynamic shared
// memory, laid out [slot][limb][threadIdx.x]: a warp's access to limb i
// of a slot hits 32 consecutive banks.  Only a multiply's operands and
// columns are in registers.  Comb entries are read straight from device
// memory as strided views (limb i at entry + i * m); the pool keeps its
// limb-major layout, so each gathered limb costs one 32-byte sector.
// Code size: the field products, the canonical-form tests and the point
// formulas are not inlined and the window loops stay rolled, so the
// kernel holds one copy of each body.
//
// The per-lane body compiles as plain C++ too (field.cuh's FE_HD), with
// the lane's scratch passed in: `verify_keyed_host` runs it on the host
// for a check where there is no card.

#include <cstdint>
#ifdef __CUDACC__
#include <cuda_runtime.h>

#include <atomic>
#endif

#include "field.cuh"

namespace vk {

using fe::Fe;
using fe::FeIn;
using fe::NL;

// 16-bit limbs (ops/scalar.py): 16c with 2^256 = -16c (mod L), L with a
// zero 17th limb, and 16L.
FE_TABLE(int64_t, kK, 9, {16080, 53085, 12709, 33062, 52581, 12153, 40426, 19951, 1})
FE_TABLE(int64_t, kL, 17,
         {54253, 23797, 25370, 22546, 40150, 41719, 63966, 5342, 0, 0, 0, 0, 0, 0, 0, 4096, 0})
FE_TABLE(int64_t, kL16, 17,
         {16080, 53085, 12709, 33062, 52581, 12153, 40426, 19951, 1, 0, 0, 0, 0, 0, 0, 0, 1})

// A lane's field elements.  R's decompression borrows the P1 and T
// slots as scratch before either accumulator exists.
enum Slot { RX, RY, RT, P1, P2 = P1 + 4, T0 = P2 + 4, T1, T2, T3, T4, T5, NSLOTS };

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

FE_HD FE_INLINE Fe slot(int32_t* sm, int ss, int k) { return Fe{sm + k * NL * ss, ss}; }

// -- points: (X, Y, Z, T) in four consecutive slots from `p` ------------

FE_HD FE_INLINE void set_identity(int32_t* sm, int ss, int p) {
  const FeIn one = FE_CONST(kOne);
  for (int i = 0; i < NL; ++i) {
    slot(sm, ss, p)[i] = 0;
    slot(sm, ss, p + 3)[i] = 0;
  }
  fe::copy(slot(sm, ss, p + 1), one);
  fe::copy(slot(sm, ss, p + 2), one);
}

// p += (Y+X, Y-X, c2): pt_add_niels (c2 = 2dxy, dd = 2 Z1) or, when
// `projective`, pt_add_pniels (c2 = 2dT, dd = Z1 * z2 with z2 = 2Z).
FE_HD FE_NOINLINE void pt_madd(int32_t* sm, int ss, int p, FeIn yplus, FeIn yminus,
                               FeIn c2, FeIn z2, bool projective) {
  const Fe x1 = slot(sm, ss, p), y1 = slot(sm, ss, p + 1);
  const Fe z1 = slot(sm, ss, p + 2), t1 = slot(sm, ss, p + 3);
  const Fe a = slot(sm, ss, T0), b = slot(sm, ss, T1), c = slot(sm, ss, T2);
  const Fe dd = slot(sm, ss, T3), e = slot(sm, ss, T4), h = slot(sm, ss, T5);
  fe::sub(a, y1, x1);
  fe::mul(a, a, yminus);
  fe::add(b, y1, x1);
  fe::mul(b, b, yplus);
  fe::mul(c, t1, c2);
  if (projective) {
    fe::mul(dd, z1, z2);
  } else {
    fe::mul_small(dd, z1, 2);
  }
  fe::sub(e, b, a);
  fe::add(h, b, a);
  const Fe f = a, g = b;  // a and b are spent
  fe::sub(f, dd, c);
  fe::add(g, dd, c);
  fe::mul(x1, e, f);
  fe::mul(y1, g, h);
  fe::mul(z1, f, g);
  fe::mul(t1, e, h);
}

// p += q: pt_add (add-2008-hwcd-3, a = -1, k = 2d).
FE_HD FE_NOINLINE void pt_add(int32_t* sm, int ss, int p, FeIn x2, FeIn y2, FeIn z2, FeIn t2) {
  const Fe x1 = slot(sm, ss, p), y1 = slot(sm, ss, p + 1);
  const Fe z1 = slot(sm, ss, p + 2), t1 = slot(sm, ss, p + 3);
  const Fe a = slot(sm, ss, T0), b = slot(sm, ss, T1), c = slot(sm, ss, T2);
  const Fe dd = slot(sm, ss, T3), e = slot(sm, ss, T4), h = slot(sm, ss, T5);
  fe::sub(a, y1, x1);
  fe::sub(b, y2, x2);
  fe::mul(a, a, b);
  fe::add(b, y1, x1);
  fe::add(c, y2, x2);
  fe::mul(b, b, c);
  fe::mul(c, t1, FE_CONST(kTwoD));
  fe::mul(c, c, t2);
  fe::mul(dd, z1, z2);
  fe::mul_small(dd, dd, 2);
  fe::sub(e, b, a);
  fe::add(h, b, a);
  const Fe f = a, g = b;
  fe::sub(f, dd, c);
  fe::add(g, dd, c);
  fe::mul(x1, e, f);
  fe::mul(y1, g, h);
  fe::mul(z1, f, g);
  fe::mul(t1, e, h);
}

// p = [2]p: pt_double (dbl-2008-hwcd).
FE_HD FE_NOINLINE void pt_double(int32_t* sm, int ss, int p) {
  const Fe x1 = slot(sm, ss, p), y1 = slot(sm, ss, p + 1);
  const Fe z1 = slot(sm, ss, p + 2), t1 = slot(sm, ss, p + 3);
  const Fe a = slot(sm, ss, T0), b = slot(sm, ss, T1), c = slot(sm, ss, T2);
  const Fe h = slot(sm, ss, T3), e = slot(sm, ss, T4), g = slot(sm, ss, T5);
  fe::sq(a, x1, 1);
  fe::sq(b, y1, 1);
  fe::sq(c, z1, 1);
  fe::mul_small(c, c, 2);
  fe::add(h, a, b);
  fe::add(e, x1, y1);
  fe::sq(e, e, 1);
  fe::sub(e, h, e);
  fe::sub(g, a, b);
  const Fe f = a;  // a is spent
  fe::add(f, c, g);
  fe::mul(x1, e, f);
  fe::mul(y1, g, h);
  fe::mul(z1, f, g);
  fe::mul(t1, e, h);
}

// R's decompression (decompress, ZIP-215): the 32 bytes at enc[0],
// enc[ld], ...  Leaves x, y, t = xy in RX, RY, RT (z is one) and returns
// the validity.
FE_HD FE_NOINLINE bool decompress_r(const uint8_t* enc, int64_t ld, int32_t* sm, int ss) {
  const FeIn one = FE_CONST(kOne);
  const Fe x = slot(sm, ss, RX), y = slot(sm, ss, RY);
  const Fe u = slot(sm, ss, P1), v = slot(sm, ss, P1 + 1);
  const Fe v3 = slot(sm, ss, P1 + 2), v7 = slot(sm, ss, P1 + 3);
  const Fe a = slot(sm, ss, T0), b = slot(sm, ss, T1);
  const int32_t sign = enc[31 * ld] >> 7;
  fe::from_bytes_le(y, enc, ld);
  // clear bit 255: limb 25 covers bits [250, 260), so bit 255 is its bit 5
  y[NL - 1] -= sign << 5;
  fe::sq(a, y, 1);  // yy
  fe::sub(u, a, one);
  fe::mul(v, a, FE_CONST(kD));
  fe::add(v, v, one);
  fe::sq(a, v, 1);
  fe::mul(v3, a, v);
  fe::sq(a, v3, 1);
  fe::mul(v7, a, v);
  fe::mul(a, u, v7);
  fe::pow22523(b, a, slot(sm, ss, T2), slot(sm, ss, T3), slot(sm, ss, T4));
  fe::mul(a, u, v3);
  fe::mul(x, a, b);
  fe::sq(a, x, 1);
  fe::mul(a, v, a);  // vxx
  const bool ok1 = fe::eq(a, u);
  fe::neg(b, u);
  const bool ok2 = fe::eq(a, b);
  fe::mul(b, x, FE_CONST(kSqrtM1));
  fe::select_into(ok2, x, b);
  const bool flip = fe::is_odd(x) != (sign == 1);
  fe::neg(b, x);
  fe::select_into(flip, x, b);
  fe::mul(slot(sm, ss, RT), x, y);
  return ok1 || ok2;
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
// canonical limbs mod L (reduce_digest).
FE_HD FE_NOINLINE void reduce_digest(const uint8_t* d, int64_t stride, int64_t (&k)[16]) {
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

// -- one lane ----------------------------------------------------------

// The keyed verify of lane `lane` (verify_keyed_plain), with its field
// elements in `sm` (slot k, limb i at sm[(k * 26 + i) * ss]).
template <int WB>
FE_HD void verify_lane(const Args& a, int64_t lane, int32_t* sm, int ss) {
  constexpr int NWIN = 256 / WB;
  constexpr int PER_LIMB = 16 / WB;
  const uint8_t* col = a.buf + lane;
  const int64_t ld = a.ld;
  const uint8_t* kb = col + (100 + a.bucket) * ld;
  int64_t key = static_cast<int32_t>(
      static_cast<uint32_t>(kb[0]) | (static_cast<uint32_t>(kb[ld]) << 8) |
      (static_cast<uint32_t>(kb[2 * ld]) << 16) | (static_cast<uint32_t>(kb[3 * ld]) << 24));
  const bool key_in = key >= 0 && key < a.cap;
  if (!key_in) key = 0;

  const bool r_ok = decompress_r(col + 32 * ld, ld, sm, ss);
  const bool s_ok = bytes_lt_l(col + 64 * ld, ld);
  int64_t k[16];
  reduce_digest(a.digest + lane, a.n, k);

  // [S]B: 32 affine-Niels adds, entry S[w] of window w
  set_identity(sm, ss, P1);
  const int bs = NL * 256;  // coordinate stride of the comb of B
#pragma unroll 1
  for (int w = 0; w < 32; ++w) {
    const int32_t* e = a.b_table + static_cast<int64_t>(w) * 3 * bs + col[(64 + w) * ld];
    pt_madd(sm, ss, P1, FeIn{e, 256}, FeIn{e + bs, 256}, FeIn{e + 2 * bs, 256},
            FeIn{e, 256}, false);
  }

  // [k](-A): projective-Niels adds, entry key * 2^wb + window
  set_identity(sm, ss, P2);
  const int m = static_cast<int>(a.m);
  const int64_t cs = static_cast<int64_t>(NL) * a.m;  // coordinate stride
#pragma unroll 1
  for (int w = 0; w < NWIN; ++w) {
    const int64_t win = (k[w / PER_LIMB] >> (WB * (w % PER_LIMB))) & ((1 << WB) - 1);
    const int32_t* e = a.table + static_cast<int64_t>(w) * 4 * cs + (key << WB) + win;
    pt_madd(sm, ss, P2, FeIn{e, m}, FeIn{e + cs, m}, FeIn{e + 3 * cs, m},
            FeIn{e + 2 * cs, m}, true);
  }

  // q = [S]B + [k](-A) - R, then [8]q
  pt_add(sm, ss, P1, slot(sm, ss, P2), slot(sm, ss, P2 + 1), slot(sm, ss, P2 + 2),
         slot(sm, ss, P2 + 3));
  fe::neg(slot(sm, ss, RX), slot(sm, ss, RX));
  fe::neg(slot(sm, ss, RT), slot(sm, ss, RT));
  pt_add(sm, ss, P1, slot(sm, ss, RX), slot(sm, ss, RY), FE_CONST(kOne), slot(sm, ss, RT));
#pragma unroll 1
  for (int i = 0; i < 3; ++i) pt_double(sm, ss, P1);

  const bool id = fe::is_zero(slot(sm, ss, P1)) && fe::eq(slot(sm, ss, P1 + 1), slot(sm, ss, P1 + 2));
  a.ok[lane] = id && r_ok && s_ok && key_in && a.key_valid[key] != 0;
  if (a.q8 != nullptr) {
    for (int c = 0; c < 4; ++c) {
      const Fe pc = slot(sm, ss, P1 + c);
      for (int i = 0; i < NL; ++i) a.q8[(c * NL + i) * a.n + lane] = pc[i];
    }
  }
}

}  // namespace vk

#ifdef __CUDACC__

namespace {

constexpr int BLOCK = 32;
constexpr int SMEM_BYTES = static_cast<int>(sizeof(int32_t)) * vk::NSLOTS * vk::NL * BLOCK;

template <int WB>
__global__ void __launch_bounds__(BLOCK) verify_keyed_kernel(vk::Args a) {
  extern __shared__ int32_t smem[];
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * BLOCK + threadIdx.x;
  if (lane >= a.n) return;
  vk::verify_lane<WB>(a, lane, smem + threadIdx.x, BLOCK);
}

constexpr int MAX_DEVICES = 64;

template <int WB>
int launch(const vk::Args& a, cudaStream_t stream) {
  // Shared memory above 48 KB is opted into once per device: the
  // attribute belongs to the function in each device's context.
  static std::atomic<bool> opted_in[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= MAX_DEVICES || !opted_in[dev].load()) {
    err = cudaFuncSetAttribute(verify_keyed_kernel<WB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= 0 && dev < MAX_DEVICES) opted_in[dev].store(true);
  }
  const unsigned grid = static_cast<unsigned>((a.n + BLOCK - 1) / BLOCK);
  verify_keyed_kernel<WB><<<grid, BLOCK, SMEM_BYTES, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, loaded with ctypes: launches on `stream`, does not
// synchronise, returns cudaGetLastError() (0 on success).  `q8` may be
// null.  window_bits is 8 or 4.
extern "C" int verify_keyed_launch(const void* buf, int64_t ld, int bucket, const void* digest,
                                   const void* table, int64_t m, const void* key_valid,
                                   int64_t cap, const void* b_table, void* ok, void* q8,
                                   int64_t n, int window_bits, void* stream) {
  const vk::Args a{static_cast<const uint8_t*>(buf), ld, bucket,
                   static_cast<const uint8_t*>(digest), static_cast<const int32_t*>(table), m,
                   static_cast<const uint8_t*>(key_valid), cap,
                   static_cast<const int32_t*>(b_table), static_cast<uint8_t*>(ok),
                   static_cast<int32_t*>(q8), n};
  if (window_bits != 8 && window_bits != 4) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return window_bits == 8 ? launch<8>(a, st) : launch<4>(a, st);
}

// The dynamic shared memory one block of the kernel takes, in bytes.
extern "C" int verify_keyed_smem_bytes() { return SMEM_BYTES; }

#else  // a host C++ compiler: the per-lane body on the CPU

// Host check of the kernel source: the same arguments on host memory,
// lanes run one after another, each with its own scratch (stride 1).
// Returns 0, or -1 for a window width other than 8 or 4.
extern "C" int verify_keyed_host(const void* buf, int64_t ld, int bucket, const void* digest,
                                 const void* table, int64_t m, const void* key_valid,
                                 int64_t cap, const void* b_table, void* ok, void* q8,
                                 int64_t n, int window_bits) {
  const vk::Args a{static_cast<const uint8_t*>(buf), ld, bucket,
                   static_cast<const uint8_t*>(digest), static_cast<const int32_t*>(table), m,
                   static_cast<const uint8_t*>(key_valid), cap,
                   static_cast<const int32_t*>(b_table), static_cast<uint8_t*>(ok),
                   static_cast<int32_t*>(q8), n};
  if (window_bits != 8 && window_bits != 4) return -1;
  int32_t scratch[vk::NSLOTS * vk::NL];
  for (int64_t lane = 0; lane < n; ++lane) {
    if (window_bits == 8) {
      vk::verify_lane<8>(a, lane, scratch, 1);
    } else {
      vk::verify_lane<4>(a, lane, scratch, 1);
    }
  }
  return 0;
}

#endif
