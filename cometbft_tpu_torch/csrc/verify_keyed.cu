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
// The per-lane body compiles as plain C++ too (field.cuh's FE_HD; a phase
// becomes a loop over the ranks and a shuffle a read of another rank's
// slot): `verify_keyed_host` runs it on the host, at every compiled G, for
// a check where there is no card.

#include <cstdint>
#ifdef __CUDACC__
#include <cuda_runtime.h>

#include <atomic>
#endif

#include "field.cuh"

namespace vk {

using fe::Grp;
using fe::NL;

// 16-bit limbs (ops/scalar.py): 16c with 2^256 = -16c (mod L), L with a
// zero 17th limb, and 16L.
FE_TABLE(int64_t, kK, 9, {16080, 53085, 12709, 33062, 52581, 12153, 40426, 19951, 1})
FE_TABLE(int64_t, kL, 17,
         {54253, 23797, 25370, 22546, 40150, 41719, 63966, 5342, 0, 0, 0, 0, 0, 0, 0, 4096, 0})
FE_TABLE(int64_t, kL16, 17,
         {16080, 53085, 12709, 33062, 52581, 12153, 40426, 19951, 1, 0, 0, 0, 0, 0, 0, 0, 1})

// A lane's field elements.  R's decompression borrows the P1, P2 and T
// slots as scratch before either accumulator exists.
enum Slot { RX, RY, RT, P1, P2 = P1 + 4, T0 = P2 + 4, T1, T2, T3, NSLOTS };

// A lane's shared memory: its elements and the staging buffer of a comb
// entry (up to 4 coordinates of 26 limbs).  The field constants its steps
// read are the block's (Consts, one copy before the lanes).  With the
// constants in shared memory every operand of a product is, and the
// compiler addresses them all as shared.
enum Const { K_ONE, K_D, K_TWO_D, K_SQRT_M1, NCONST };

struct Lane {
  int32_t s[NSLOTS][NL];
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
template <int G>
FE_HD constexpr int lane_words() {
  constexpr int base = static_cast<int>(sizeof(Lane) / sizeof(int32_t));
  return base + ((G % 32) - base % 32 + 32) % 32;
}

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

// -- asynchronous copies of comb entries ---------------------------------

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

// Start copying one comb entry (`ncoord` coordinates, coordinate c's limb
// i at src[c * cstride + i * lstride]) into dst, spread over the ranks.
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

template <int G>
FE_HD FE_INLINE void set_identity(Grp<G> g, Lane* L, int p, int q) {
  FE_PHASE(g) {
    for (int k = r; k < NL; k += G) {
      const int32_t one = k == 0 ? 1 : 0;
      L->s[p][k] = 0, L->s[p + 1][k] = one, L->s[p + 2][k] = one, L->s[p + 3][k] = 0;
      L->s[q][k] = 0, L->s[q + 1][k] = one, L->s[q + 2][k] = one, L->s[q + 3][k] = 0;
    }
  }
}

// The comb entry a step adds next, or none (src null): fetched into the
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
template <int G>
FE_HD FE_NOINLINE void pt_madd(Grp<G> g, Lane* L, int p, bool projective, Next next) {
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
template <int G>
FE_HD FE_NOINLINE void pt_add(Grp<G> g, Lane* L, const Consts& k, int p, const int32_t* x2,
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
template <int G>
FE_HD FE_NOINLINE void pt_double(Grp<G> g, Lane* L, int p) {
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

// R's decompression (decompress, ZIP-215): the 32 bytes at enc[0],
// enc[ld], ...  Leaves x, y, t = xy in RX, RY, RT (z is one) and returns
// the validity.
template <int G>
FE_HD FE_NOINLINE bool decompress_r(Grp<G> g, const uint8_t* enc, int64_t ld, Lane* L,
                                    const Consts& k) {
  const int32_t* one = k[K_ONE];
  int32_t *x = L->s[RX], *y = L->s[RY];
  int32_t *u = L->s[P1], *v = L->s[P1 + 1], *v3 = L->s[P1 + 2], *v7 = L->s[P1 + 3];
  int32_t *a = L->s[T0], *b = L->s[T1];
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
  fe::pow22523(g, b, a, L->s[T2], L->s[T3], L->s[P2]);
  fe::mul(g, a, u, v3);
  fe::mul(g, x, a, b);
  fe::sq(g, a, x, 1);
  fe::mul(g, a, v, a);  // vxx
  const bool ok1 = fe::eq(g, a, u);
  fe::neg(g, b, u);
  const bool ok2 = fe::eq(g, a, b);
  fe::mul(g, b, x, k[K_SQRT_M1]);
  fe::select_into(g, ok2, x, b);
  const bool flip = fe::is_odd(g, x) != (sign == 1);
  fe::neg(g, b, x);
  fe::select_into(g, flip, x, b);
  fe::mul(g, L->s[RT], x, y);
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
  reduce_digest(a.digest + lane, a.n, k);

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
  fetch_entry(g, L->stage, first.src, first.cstride, first.lstride, first.ncoord);

  const bool r_ok = decompress_r(g, col + 32 * ld, ld, L, kc);
  const bool s_ok = bytes_lt_l(col + 64 * ld, ld);
  set_identity(g, L, P1, P2);

#pragma unroll 1
  for (int s = 0; s < NSTEP; ++s) {
    copy_wait();
    g.sync();
    const Next next = s + 1 < NSTEP ? entry(s + 1) : Next{nullptr, 0, 0, 0};
    pt_madd(g, L, s < 32 ? P1 : P2, s >= 32, next);
  }

  // q = [S]B + [k](-A) - R, then [8]q
  pt_add(g, L, kc, P1, L->s[P2], L->s[P2 + 1], L->s[P2 + 2], L->s[P2 + 3]);
  fe::neg(g, L->s[RX], L->s[RX]);
  fe::neg(g, L->s[RT], L->s[RT]);
  pt_add(g, L, kc, P1, L->s[RX], L->s[RY], kc[K_ONE], L->s[RT]);
#pragma unroll 1
  for (int i = 0; i < 3; ++i) pt_double(g, L, P1);

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

// The group size for n lanes, from the sweep chip_smoke.py prints (H100):
// G = 32 is fastest up to 1024 lanes, G = 8 up to 4096, and one thread
// per lane beyond, where the card is full and a lane's instruction
// count, not its latency, sets the time.
FE_HD FE_INLINE int pick_group(int64_t n, int /*wb*/) {
  return n <= 1024 ? 32 : n <= 4096 ? 8 : 1;
}

}  // namespace vk

#ifdef __CUDACC__

namespace {

constexpr int BLOCK = 32;  // one warp: 32 / G lanes

// The block's constants, then its lanes.
template <int G>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(int32_t)) *
         (vk::NCONST * vk::NL + (BLOCK / G) * vk::lane_words<G>());
}

template <int WB, int G>
__global__ void __launch_bounds__(BLOCK) verify_keyed_kernel(vk::Args a) {
  extern __shared__ int32_t smem[];
  vk::Consts& kc = *reinterpret_cast<vk::Consts*>(smem);
  vk::fill_consts(kc, threadIdx.x, BLOCK);
  __syncwarp();
  const int sub = threadIdx.x / G;
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * (BLOCK / G) + sub;
  if (lane >= a.n) return;  // the whole group leaves together
  fe::Grp<G> g;
  g.rank = threadIdx.x % G;
  g.mask = (G == 32 ? 0xffffffffu : (1u << (G % 32)) - 1u) << (threadIdx.x & 31 & ~(G - 1));
  int32_t* lanes = smem + vk::NCONST * vk::NL;
  vk::verify_lane<WB, G>(
      a, lane, reinterpret_cast<vk::Lane*>(lanes + sub * vk::lane_words<G>()), kc, g);
}

constexpr int MAX_DEVICES = 64;

template <int WB, int G>
int launch(const vk::Args& a, cudaStream_t stream) {
  // Shared memory above 48 KB would need an opt-in, once per device: the
  // attribute belongs to the function in each device's context.
  static std::atomic<bool> opted_in[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= MAX_DEVICES || !opted_in[dev].load()) {
    err = cudaFuncSetAttribute(verify_keyed_kernel<WB, G>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<G>());
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= 0 && dev < MAX_DEVICES) opted_in[dev].store(true);
  }
  const int lpb = BLOCK / G;
  const unsigned grid = static_cast<unsigned>((a.n + lpb - 1) / lpb);
  verify_keyed_kernel<WB, G><<<grid, BLOCK, smem_bytes<G>(), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
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
// or 0 for the launcher's choice (verify_keyed_group).
extern "C" int verify_keyed_launch(const void* buf, int64_t ld, int bucket, const void* digest,
                                   const void* table, int64_t m, const void* key_valid,
                                   int64_t cap, const void* b_table, void* ok, void* q8,
                                   int64_t n, int window_bits, int group, void* stream) {
  const vk::Args a{static_cast<const uint8_t*>(buf), ld, bucket,
                   static_cast<const uint8_t*>(digest), static_cast<const int32_t*>(table), m,
                   static_cast<const uint8_t*>(key_valid), cap,
                   static_cast<const int32_t*>(b_table), static_cast<uint8_t*>(ok),
                   static_cast<int32_t*>(q8), n};
  if (window_bits != 8 && window_bits != 4) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (group == 0) group = vk::pick_group(n, window_bits);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return window_bits == 8 ? launch_group<8>(a, group, st) : launch_group<4>(a, group, st);
}

// The group size the launcher picks for n lanes.
extern "C" int verify_keyed_group(int64_t n, int window_bits) {
  return vk::pick_group(n, window_bits);
}

// The dynamic shared memory one block (one warp) takes at group size
// `group`, in bytes; -1 for a group size that is not compiled.
extern "C" int verify_keyed_smem_bytes(int group) {
  return group == 1 ? smem_bytes<1>() : group == 8 ? smem_bytes<8>()
                                      : group == 32 ? smem_bytes<32>() : -1;
}

#else  // a host C++ compiler: the per-lane body on the CPU

namespace {

template <int WB, int G>
void run_host(const vk::Args& a) {
  vk::Lane lane_mem;
  vk::Consts kc;
  vk::fill_consts(kc, 0, 1);
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
