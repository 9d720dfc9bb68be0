// Native Ed25519 BATCH verification on the host: one
// random-linear-combination check for a whole batch (the port's copy
// of the reference's native/crypto/ed25519_batch.cpp, the analog of
// CometBFT's ed25519consensus batch verifier, crypto/ed25519/batch.go).
// It runs on the CPU and is built with g++ (ops/_build.py); it is host
// code, not a kernel.
//
//   [8]( [c]B + sum_i [zr_i](-R_i) + sum_i [za_i](-A_i) ) == identity
//   with c = sum_i z_i*s_i mod L, za_i = z_i*k_i mod L, zr_i = z_i
//
// The caller (cometbft_tpu_torch/crypto/ed25519_native.py rlc_verify)
// computes all SCALARS in Python big-int arithmetic (SHA-512 k_i,
// random 128-bit z_i, the mod-L products) — this file does only curve
// work: ZIP-215 point decompression, one Pippenger multi-scalar
// multiplication over all terms, three doublings, identity check.
// Field arithmetic is the standard radix-51 representation on
// unsigned __int128 accumulators; point formulas mirror the package's
// pure-Python oracle (crypto/edwards.py: add-2008-hwcd-3 unified add,
// dbl-2008-hwcd, ZIP-215 decode with non-canonical y accepted) so the
// differential tests pin this implementation to the oracle bit for
// bit.

#include <cstdint>
#include <cstring>
#include <new>

namespace {

typedef unsigned __int128 u128;
typedef uint64_t u64;

constexpr u64 MASK51 = (1ull << 51) - 1;

// -- GF(2^255-19), radix 51 -------------------------------------------

struct fe {
  u64 v[5];
};

const fe FE_ZERO = {{0, 0, 0, 0, 0}};
const fe FE_ONE = {{1, 0, 0, 0, 0}};

// d = -121665/121666 mod p (matches edwards.py D)
const fe FE_D = {{0x34dca135978a3ull, 0x1a8283b156ebdull, 0x5e7a26001c029ull,
                  0x739c663a03cbbull, 0x52036cee2b6ffull}};
// 2d mod p
const fe FE_2D = {{0x69b9426b2f159ull, 0x35050762add7aull,
                   0x3cf44c0038052ull, 0x6738cc7407977ull,
                   0x2406d9dc56dffull}};
// sqrt(-1) = 2^((p-1)/4) (matches edwards.py SQRT_M1)
const fe FE_SQRTM1 = {{0x61b274a0ea0b0ull, 0xd5a5fc8f189dull,
                       0x7ef5e9cbd0c60ull, 0x78595a6804c9eull,
                       0x2b8324804fc1dull}};

inline void fe_add(fe& r, const fe& a, const fe& b) {
  for (int i = 0; i < 5; i++) r.v[i] = a.v[i] + b.v[i];
}

// r = a - b, biased by 2p so limbs stay non-negative (standard donna
// constants: 2p = (2^52-38, 2^52-2, ..., 2^52-2) in radix 51)
inline void fe_sub(fe& r, const fe& a, const fe& b) {
  r.v[0] = a.v[0] + 0xFFFFFFFFFFFDAull - b.v[0];
  r.v[1] = a.v[1] + 0xFFFFFFFFFFFFEull - b.v[1];
  r.v[2] = a.v[2] + 0xFFFFFFFFFFFFEull - b.v[2];
  r.v[3] = a.v[3] + 0xFFFFFFFFFFFFEull - b.v[3];
  r.v[4] = a.v[4] + 0xFFFFFFFFFFFFEull - b.v[4];
}

inline void fe_carry(fe& r) {
  u64 c;
  c = r.v[0] >> 51; r.v[0] &= MASK51; r.v[1] += c;
  c = r.v[1] >> 51; r.v[1] &= MASK51; r.v[2] += c;
  c = r.v[2] >> 51; r.v[2] &= MASK51; r.v[3] += c;
  c = r.v[3] >> 51; r.v[3] &= MASK51; r.v[4] += c;
  c = r.v[4] >> 51; r.v[4] &= MASK51; r.v[0] += c * 19;
  c = r.v[0] >> 51; r.v[0] &= MASK51; r.v[1] += c;
}

void fe_mul(fe& r, const fe& f, const fe& g) {
  u128 f0 = f.v[0], f1 = f.v[1], f2 = f.v[2], f3 = f.v[3], f4 = f.v[4];
  u64 g0 = g.v[0], g1 = g.v[1], g2 = g.v[2], g3 = g.v[3], g4 = g.v[4];
  u64 g1_19 = g1 * 19, g2_19 = g2 * 19, g3_19 = g3 * 19, g4_19 = g4 * 19;
  u128 r0 = f0 * g0 + f1 * g4_19 + f2 * g3_19 + f3 * g2_19 + f4 * g1_19;
  u128 r1 = f0 * g1 + f1 * g0 + f2 * g4_19 + f3 * g3_19 + f4 * g2_19;
  u128 r2 = f0 * g2 + f1 * g1 + f2 * g0 + f3 * g4_19 + f4 * g3_19;
  u128 r3 = f0 * g3 + f1 * g2 + f2 * g1 + f3 * g0 + f4 * g4_19;
  u128 r4 = f0 * g4 + f1 * g3 + f2 * g2 + f3 * g1 + f4 * g0;
  u64 c;
  u64 t0 = (u64)r0 & MASK51; c = (u64)(r0 >> 51);
  r1 += c; u64 t1 = (u64)r1 & MASK51; c = (u64)(r1 >> 51);
  r2 += c; u64 t2 = (u64)r2 & MASK51; c = (u64)(r2 >> 51);
  r3 += c; u64 t3 = (u64)r3 & MASK51; c = (u64)(r3 >> 51);
  r4 += c; u64 t4 = (u64)r4 & MASK51; c = (u64)(r4 >> 51);
  t0 += c * 19; c = t0 >> 51; t0 &= MASK51; t1 += c;
  r.v[0] = t0; r.v[1] = t1; r.v[2] = t2; r.v[3] = t3; r.v[4] = t4;
}

// dedicated squaring: 15 wide products instead of mul's 25 (doubled
// cross terms) — the decompression sqrt chain is ~95% squarings
void fe_sq(fe& r, const fe& f) {
  u128 f0 = f.v[0], f1 = f.v[1], f2 = f.v[2], f3 = f.v[3], f4 = f.v[4];
  u64 d0 = f.v[0] * 2, d1 = f.v[1] * 2, d2 = f.v[2] * 2, d3 = f.v[3] * 2;
  u64 f3_19 = f.v[3] * 19, f4_19 = f.v[4] * 19;
  u128 r0 = f0 * (u64)f0 + (u128)d1 * f4_19 + (u128)d2 * f3_19;
  u128 r1 = (u128)d0 * (u64)f1 + (u128)d2 * f4_19 + (u128)f3_19 * (u64)f3;
  u128 r2 = (u128)d0 * (u64)f2 + f1 * (u64)f1 + (u128)d3 * f4_19;
  u128 r3 = (u128)d0 * (u64)f3 + (u128)d1 * (u64)f2
            + (u128)f4_19 * (u64)f4;
  u128 r4 = (u128)d0 * (u64)f4 + (u128)d1 * (u64)f3 + f2 * (u64)f2;
  u64 c;
  u64 t0 = (u64)r0 & MASK51; c = (u64)(r0 >> 51);
  r1 += c; u64 t1 = (u64)r1 & MASK51; c = (u64)(r1 >> 51);
  r2 += c; u64 t2 = (u64)r2 & MASK51; c = (u64)(r2 >> 51);
  r3 += c; u64 t3 = (u64)r3 & MASK51; c = (u64)(r3 >> 51);
  r4 += c; u64 t4 = (u64)r4 & MASK51; c = (u64)(r4 >> 51);
  t0 += c * 19; c = t0 >> 51; t0 &= MASK51; t1 += c;
  r.v[0] = t0; r.v[1] = t1; r.v[2] = t2; r.v[3] = t3; r.v[4] = t4;
}

inline void fe_sqn(fe& r, const fe& z, int n) {
  fe_sq(r, z);
  for (int i = 1; i < n; i++) fe_sq(r, r);
}

// z^(2^252 - 3) via the standard 251-squaring / 11-multiply addition
// chain ((p-5)/8 — decompression's dominant cost; the exponent has
// ~250 one-bits, so generic square-and-multiply would double the work)
void fe_pow22523(fe& r, const fe& z) {
  fe t0, t1, t2;
  fe_sq(t0, z);                    // 2
  fe_sqn(t1, t0, 2);               // 8
  fe_mul(t1, z, t1);               // 9
  fe_mul(t0, t0, t1);              // 11
  fe_sq(t0, t0);                   // 22
  fe_mul(t0, t1, t0);              // 2^5 - 1
  fe_sqn(t1, t0, 5);               // 2^10 - 2^5
  fe_mul(t0, t1, t0);              // 2^10 - 1
  fe_sqn(t1, t0, 10);              // 2^20 - 2^10
  fe_mul(t1, t1, t0);              // 2^20 - 1
  fe_sqn(t2, t1, 20);              // 2^40 - 2^20
  fe_mul(t1, t2, t1);              // 2^40 - 1
  fe_sqn(t1, t1, 10);              // 2^50 - 2^10
  fe_mul(t0, t1, t0);              // 2^50 - 1
  fe_sqn(t1, t0, 50);              // 2^100 - 2^50
  fe_mul(t1, t1, t0);              // 2^100 - 1
  fe_sqn(t2, t1, 100);             // 2^200 - 2^100
  fe_mul(t1, t2, t1);              // 2^200 - 1
  fe_sqn(t1, t1, 50);              // 2^250 - 2^50
  fe_mul(t0, t1, t0);              // 2^250 - 1
  fe_sqn(t0, t0, 2);               // 2^252 - 4
  fe_mul(r, t0, z);                // 2^252 - 3
}

void fe_frombytes(fe& r, const uint8_t s[32]) {
  // 51-bit slices of the 255 low bits (bit 255 is the sign, masked by
  // the caller)
  u64 w0, w1, w2, w3;
  memcpy(&w0, s, 8); memcpy(&w1, s + 8, 8);
  memcpy(&w2, s + 16, 8); memcpy(&w3, s + 24, 8);
  r.v[0] = w0 & MASK51;
  r.v[1] = ((w0 >> 51) | (w1 << 13)) & MASK51;
  r.v[2] = ((w1 >> 38) | (w2 << 26)) & MASK51;
  r.v[3] = ((w2 >> 25) | (w3 << 39)) & MASK51;
  r.v[4] = (w3 >> 12) & MASK51;  // drops bit 255
}

// canonical little-endian bytes (full reduction mod p)
void fe_tobytes(uint8_t s[32], const fe& f) {
  fe t = f;
  fe_carry(t);
  fe_carry(t);
  // subtract p if t >= p: compute t + 19, if that carries past 2^255
  // the value was >= p
  u64 q = (t.v[0] + 19) >> 51;
  q = (t.v[1] + q) >> 51;
  q = (t.v[2] + q) >> 51;
  q = (t.v[3] + q) >> 51;
  q = (t.v[4] + q) >> 51;
  t.v[0] += 19 * q;
  u64 c;
  c = t.v[0] >> 51; t.v[0] &= MASK51; t.v[1] += c;
  c = t.v[1] >> 51; t.v[1] &= MASK51; t.v[2] += c;
  c = t.v[2] >> 51; t.v[2] &= MASK51; t.v[3] += c;
  c = t.v[3] >> 51; t.v[3] &= MASK51; t.v[4] += c;
  t.v[4] &= MASK51;
  u64 w0 = t.v[0] | (t.v[1] << 51);
  u64 w1 = (t.v[1] >> 13) | (t.v[2] << 38);
  u64 w2 = (t.v[2] >> 26) | (t.v[3] << 25);
  u64 w3 = (t.v[3] >> 39) | (t.v[4] << 12);
  memcpy(s, &w0, 8); memcpy(s + 8, &w1, 8);
  memcpy(s + 16, &w2, 8); memcpy(s + 24, &w3, 8);
}

bool fe_iszero(const fe& f) {
  uint8_t s[32];
  fe_tobytes(s, f);
  uint8_t acc = 0;
  for (int i = 0; i < 32; i++) acc |= s[i];
  return acc == 0;
}

bool fe_eq(const fe& a, const fe& b) {
  fe d;
  fe_sub(d, a, b);
  return fe_iszero(d);
}

inline bool fe_isodd(const fe& f) {
  uint8_t s[32];
  fe_tobytes(s, f);
  return s[0] & 1;
}

void fe_neg(fe& r, const fe& f) { fe_sub(r, FE_ZERO, f); }

// -- points (extended coordinates, mirrors edwards.py) -----------------

struct ge {
  fe X, Y, Z, T;
};

const ge GE_ID = {FE_ZERO, FE_ONE, FE_ONE, FE_ZERO};

// unified addition, add-2008-hwcd-3 (edwards.py pt_add)
void ge_add(ge& r, const ge& p, const ge& q) {
  fe a, b, c, d, e, f, g, h, t;
  fe_sub(a, p.Y, p.X);
  fe_sub(t, q.Y, q.X);
  fe_mul(a, a, t);                       // A = (y1-x1)(y2-x2)
  fe_add(b, p.Y, p.X);
  fe_add(t, q.Y, q.X);
  fe_carry(t);
  fe_mul(b, b, t);                       // B = (y1+x1)(y2+x2)
  fe_mul(c, p.T, FE_2D);
  fe_mul(c, c, q.T);                     // C = 2 d t1 t2
  fe_mul(d, p.Z, q.Z);
  fe_add(d, d, d);                       // D = 2 z1 z2
  fe_sub(e, b, a);
  fe_sub(f, d, c);
  fe_add(g, d, c);
  fe_carry(g);
  fe_add(h, b, a);
  fe_carry(h);
  fe_mul(r.X, e, f);
  fe_mul(r.Y, g, h);
  fe_mul(r.Z, f, g);
  fe_mul(r.T, e, h);
}

// doubling, dbl-2008-hwcd (edwards.py pt_double)
void ge_double(ge& r, const ge& p) {
  fe a, b, c, e, f, g, h, t;
  fe_sq(a, p.X);
  fe_sq(b, p.Y);
  fe_sq(c, p.Z);
  fe_add(c, c, c);
  fe_carry(c);
  fe_add(h, a, b);
  fe_carry(h);
  fe_add(t, p.X, p.Y);
  fe_carry(t);
  fe_sq(t, t);
  fe_sub(e, h, t);
  fe_sub(g, a, b);
  fe_add(f, c, g);
  fe_carry(f);
  fe_mul(r.X, e, f);
  fe_mul(r.Y, g, h);
  fe_mul(r.Z, f, g);
  fe_mul(r.T, e, h);
}

bool ge_is_identity(const ge& p) {
  // x == 0 and y == z
  return fe_iszero(p.X) && fe_eq(p.Y, p.Z);
}

// ZIP-215 decode (edwards.py decode_point): non-canonical y accepted
// (implicitly reduced mod p by the field arithmetic), any sign bit,
// x = 0 with sign 1 accepted. Returns false iff u/v is not a square.
bool ge_decode(ge& r, const uint8_t s[32]) {
  fe y;
  fe_frombytes(y, s);  // low 255 bits
  int sign = s[31] >> 7;
  fe yy, u, v, x, vxx, nu;
  fe_sq(yy, y);
  fe_sub(u, yy, FE_ONE);          // u = y^2 - 1
  fe_mul(v, yy, FE_D);
  fe_add(v, v, FE_ONE);
  fe_carry(v);                    // v = d y^2 + 1
  // candidate x = u v^3 (u v^7)^((p-5)/8)
  fe v2, v3, v7, uv7, t;
  fe_sq(v2, v);
  fe_mul(v3, v2, v);
  fe_sq(t, v3);
  fe_mul(v7, t, v);
  fe_mul(uv7, u, v7);
  fe_pow22523(t, uv7);
  fe_mul(x, u, v3);
  fe_mul(x, x, t);
  fe_mul(vxx, v, x);
  fe_mul(vxx, vxx, x);
  fe_neg(nu, u);
  if (fe_eq(vxx, u)) {
    // ok
  } else if (fe_eq(vxx, nu)) {
    fe_mul(x, x, FE_SQRTM1);
  } else {
    return false;
  }
  if ((int)fe_isodd(x) != sign) fe_neg(x, x);
  fe_carry(x);
  r.X = x;
  r.Y = y;
  r.Z = FE_ONE;
  fe_mul(r.T, x, y);
  return true;
}

void ge_neg(ge& r, const ge& p) {
  fe_neg(r.X, p.X);
  r.Y = p.Y;
  r.Z = p.Z;
  fe_neg(r.T, p.T);
  fe_carry(r.X);
  fe_carry(r.T);
}

// cached Niels form of a DECODED point (Z = 1): y+x, y-x, 2d*t —
// the per-window bucket deposits then cost 7 muls instead of 9
struct ge_niels {
  fe ypx, ymx, t2d;
};

void ge_to_niels(ge_niels& r, const ge& p) {
  // decode gives Z = 1, so affine x = X, y = Y, t = T
  fe_add(r.ypx, p.Y, p.X);
  fe_carry(r.ypx);
  fe_sub(r.ymx, p.Y, p.X);
  fe_carry(r.ymx);
  fe_mul(r.t2d, p.T, FE_2D);
}

// mixed addition: r = p + q where q is a cached Niels point (Z = 1);
// same add-2008-hwcd-3 structure as ge_add with D = 2 z1
void ge_madd(ge& r, const ge& p, const ge_niels& q) {
  fe a, b, c, d, e, f, g, h;
  fe_sub(a, p.Y, p.X);
  fe_mul(a, a, q.ymx);
  fe_add(b, p.Y, p.X);
  fe_mul(b, b, q.ypx);
  fe_mul(c, p.T, q.t2d);
  fe_add(d, p.Z, p.Z);
  fe_sub(e, b, a);
  fe_sub(f, d, c);
  fe_add(g, d, c);
  fe_carry(g);
  fe_add(h, b, a);
  fe_carry(h);
  fe_mul(r.X, e, f);
  fe_mul(r.Y, g, h);
  fe_mul(r.Z, f, g);
  fe_mul(r.T, e, h);
}

}  // namespace

extern "C" {

int cmt_ed25519_backend(void) { return 2; }  // 2 = native RLC

// One RLC batch check.
//   upubs:  nu*32 unique pubkey encodings
//   keyidx: n indices into upubs
//   rs:     n*32 R encodings
//   benc:   32 basepoint encoding (passed in so B comes from the same
//           decode path the oracle uses)
//   za:     n*32 LE scalars (z_i * k_i mod L)
//   zr:     n*32 LE scalars (z_i)
//   cb:     32 LE scalar (sum z_i s_i mod L)
// Returns 1 = equation holds (all signatures valid); anything else
// means the batch could not be accepted — 0 = equation mismatch,
// -(i+1) = unique pub i undecodable, -(1000000+i) = R_i undecodable.
// The caller treats every non-1 result identically: it re-verifies
// the whole batch per-signature for exact per-lane verdicts (the
// reference's batch.go fallback); the distinct codes exist for
// diagnostics only.
long cmt_ed25519_rlc_verify(const uint8_t* upubs, const int32_t* keyidx,
                            const uint8_t* rs, const uint8_t* benc,
                            const uint8_t* za, const uint8_t* zr,
                            const uint8_t* cb, long nu, long n) {
  if (nu <= 0 || n <= 0) return 0;
  // decode unique pubkeys (negated: the MSM accumulates -A terms),
  // keeping both the extended point (first bucket copy) and the
  // cached Niels form (mixed-add deposits: 7 muls instead of 9)
  ge* apts = new (std::nothrow) ge[nu];
  ge_niels* anls = new (std::nothrow) ge_niels[nu];
  if (!apts || !anls) {
    delete[] apts;
    delete[] anls;
    return 0;
  }
  for (long i = 0; i < nu; i++) {
    ge a;
    if (!ge_decode(a, upubs + 32 * i)) {
      delete[] apts;
      delete[] anls;
      return -(i + 1);
    }
    ge_neg(apts[i], a);
    ge_to_niels(anls[i], apts[i]);
  }
  ge b;
  ge_niels bnls;
  if (!ge_decode(b, benc)) {
    delete[] apts;
    delete[] anls;
    return 0;
  }
  ge_to_niels(bnls, b);

  // Pippenger, window c = 8 (scalar bytes are the digits). Points:
  //   B with scalar cb, -A_{keyidx[i]} with scalar za_i,
  //   -R_i with scalar zr_i (all decoded once up front).
  ge* rpts = new (std::nothrow) ge[n];
  ge_niels* rnls = new (std::nothrow) ge_niels[n];
  if (!rpts || !rnls) {
    delete[] apts;
    delete[] anls;
    delete[] rpts;
    delete[] rnls;
    return 0;
  }
  for (long i = 0; i < n; i++) {
    ge r;
    if (!ge_decode(r, rs + 32 * i)) {
      delete[] apts;
      delete[] anls;
      delete[] rpts;
      delete[] rnls;
      return -(1000000 + i);
    }
    ge_neg(rpts[i], r);
    ge_to_niels(rnls[i], rpts[i]);
  }

  ge buckets[256];  // bucket[0] unused
  bool used[256];
  ge acc = GE_ID;
  bool acc_started = false;
  for (int w = 31; w >= 0; w--) {
    if (acc_started)
      for (int k = 0; k < 8; k++) ge_double(acc, acc);
    for (int j = 1; j < 256; j++) used[j] = false;
    auto deposit = [&](const ge& p, const ge_niels& pn, uint8_t digit) {
      if (!digit) return;
      if (used[digit]) {
        ge_madd(buckets[digit], buckets[digit], pn);
      } else {
        buckets[digit] = p;
        used[digit] = true;
      }
    };
    deposit(b, bnls, cb[w]);
    for (long i = 0; i < n; i++) {
      deposit(apts[keyidx[i]], anls[keyidx[i]], za[32 * i + w]);
      deposit(rpts[i], rnls[i], zr[32 * i + w]);
    }
    // fold buckets: sum_j j * bucket[j] via running suffix sums
    ge running = GE_ID, wsum = GE_ID;
    bool run_started = false, wsum_started = false;
    for (int j = 255; j >= 1; j--) {
      if (used[j]) {
        if (run_started) ge_add(running, running, buckets[j]);
        else { running = buckets[j]; run_started = true; }
      }
      if (run_started) {
        if (wsum_started) ge_add(wsum, wsum, running);
        else { wsum = running; wsum_started = true; }
      }
    }
    if (wsum_started) {
      if (acc_started) ge_add(acc, acc, wsum);
      else { acc = wsum; acc_started = true; }
    }
  }
  delete[] apts;
  delete[] anls;
  delete[] rpts;
  delete[] rnls;
  // cofactor: [8] acc must be the identity
  for (int k = 0; k < 3; k++) ge_double(acc, acc);
  return ge_is_identity(acc) ? 1 : 0;
}

}  // extern "C"
