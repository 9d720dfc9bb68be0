// Native secret-connection frame pump: ChaCha20-Poly1305 (RFC 8439)
// frame seal/open for the p2p data plane (the port's copy of the
// reference's native/transport/frame_crypto.cpp; the code below the
// header is the reference's, byte for byte).  It runs on the CPU and
// is built with g++ (ops/_build.py); it is host code, not a kernel.
//
// Reference analog: the sealed-frame hot loop of
// p2p/conn/secret_connection.go:33-50 (1024-byte data frames + 4-byte
// length prefix, sealed with a 96-bit little-endian counter nonce).
// The Python plane (cometbft_tpu_torch/p2p/conn/secret_connection.py)
// keeps the handshake, auth, and socket lifecycle; this component moves
// the per-frame crypto + framing loop into one C call per write/read
// burst so the per-frame interpreter overhead disappears and a whole
// write's frames go out as one contiguous buffer (single sendall).
//
// The cipher is implemented from the RFC 8439 specification (ChaCha20
// block function, 5x26-bit-limb Poly1305, AEAD construction) — no
// external crypto dependency.  When the system's libcrypto loads
// (dlopen, below), the cipher runs through its EVP ChaCha20-Poly1305
// instead; cmt_frame_backend() says which (1 EVP, 0 portable), and
// CMT_TPU_FRAME_SCALAR, read once per process, forces the portable
// code.  tests/test_torch_p2p.py holds both to the RFC 8439 §2.8.2
// vector and to OpenSSL through `cryptography`.
//
// ABI (all little-endian, thread-safe, no global state):
//   cmt_aead_seal / cmt_aead_open  — raw AEAD (test hook + KAT anchor)
//   cmt_frames_seal                — data -> n sealed frames, one call
//   cmt_frames_open                — n sealed frames -> data, one call

#include <dlfcn.h>

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <initializer_list>

namespace {

constexpr uint64_t DATA_LEN_SIZE = 4;
constexpr uint64_t DATA_MAX_SIZE = 1024;
constexpr uint64_t TOTAL_FRAME_SIZE = DATA_MAX_SIZE + DATA_LEN_SIZE;  // 1028
constexpr uint64_t TAG_SIZE = 16;
constexpr uint64_t SEALED_FRAME_SIZE = TOTAL_FRAME_SIZE + TAG_SIZE;   // 1044

inline uint32_t rotl32(uint32_t x, int n) {
  return (x << n) | (x >> (32 - n));
}

inline uint32_t load32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

inline void store32(uint8_t* p, uint32_t v) {
  p[0] = (uint8_t)v;
  p[1] = (uint8_t)(v >> 8);
  p[2] = (uint8_t)(v >> 16);
  p[3] = (uint8_t)(v >> 24);
}

inline void store64(uint8_t* p, uint64_t v) {
  for (int i = 0; i < 8; i++) p[i] = (uint8_t)(v >> (8 * i));
}

// -- ChaCha20 block function (RFC 8439 §2.3) --------------------------

struct ChaChaState {
  uint32_t key[8];
  uint32_t nonce[3];
};

inline void quarter(uint32_t& a, uint32_t& b, uint32_t& c, uint32_t& d) {
  a += b; d ^= a; d = rotl32(d, 16);
  c += d; b ^= c; b = rotl32(b, 12);
  a += b; d ^= a; d = rotl32(d, 8);
  c += d; b ^= c; b = rotl32(b, 7);
}

void chacha20_block(const ChaChaState& st, uint32_t counter, uint8_t out[64]) {
  uint32_t s[16] = {
      0x61707865u, 0x3320646eu, 0x79622d32u, 0x6b206574u,
      st.key[0], st.key[1], st.key[2], st.key[3],
      st.key[4], st.key[5], st.key[6], st.key[7],
      counter,   st.nonce[0], st.nonce[1], st.nonce[2],
  };
  uint32_t x[16];
  std::memcpy(x, s, sizeof(x));
  for (int i = 0; i < 10; i++) {
    quarter(x[0], x[4], x[8], x[12]);
    quarter(x[1], x[5], x[9], x[13]);
    quarter(x[2], x[6], x[10], x[14]);
    quarter(x[3], x[7], x[11], x[15]);
    quarter(x[0], x[5], x[10], x[15]);
    quarter(x[1], x[6], x[11], x[12]);
    quarter(x[2], x[7], x[8], x[13]);
    quarter(x[3], x[4], x[9], x[14]);
  }
  for (int i = 0; i < 16; i++) store32(out + 4 * i, x[i] + s[i]);
}

// XOR src into dst with the keystream starting at block ``counter``.
void chacha20_xor(const ChaChaState& st, uint32_t counter, const uint8_t* src,
                  uint8_t* dst, uint64_t len) {
  uint8_t block[64];
  while (len > 0) {
    chacha20_block(st, counter++, block);
    uint64_t n = len < 64 ? len : 64;
    for (uint64_t i = 0; i < n; i++) dst[i] = src[i] ^ block[i];
    src += n;
    dst += n;
    len -= n;
  }
}

// -- Poly1305 (RFC 8439 §2.5; 5x26-bit limbs) -------------------------

struct Poly1305 {
  uint32_t r[5];
  uint32_t h[5];
  uint32_t pad[4];
  uint8_t buf[16];
  uint32_t buflen = 0;

  void init(const uint8_t key[32]) {
    // clamp r (RFC 8439 §2.5: clear the top 4 bits of bytes 3/7/11/15
    // and the bottom 2 bits of bytes 4/8/12)
    uint32_t t0 = load32(key + 0), t1 = load32(key + 4);
    uint32_t t2 = load32(key + 8), t3 = load32(key + 12);
    r[0] = t0 & 0x3ffffff;
    r[1] = ((t0 >> 26) | (t1 << 6)) & 0x3ffff03;
    r[2] = ((t1 >> 20) | (t2 << 12)) & 0x3ffc0ff;
    r[3] = ((t2 >> 14) | (t3 << 18)) & 0x3f03fff;
    r[4] = (t3 >> 8) & 0x00fffff;
    for (int i = 0; i < 5; i++) h[i] = 0;
    for (int i = 0; i < 4; i++) pad[i] = load32(key + 16 + 4 * i);
  }

  // one 16-byte block; hibit = 1<<24 for full blocks (the 2^128 bit),
  // already folded into the caller-padded final block otherwise
  void block(const uint8_t m[16], uint32_t hibit) {
    uint32_t t0 = load32(m + 0), t1 = load32(m + 4);
    uint32_t t2 = load32(m + 8), t3 = load32(m + 12);
    h[0] += t0 & 0x3ffffff;
    h[1] += ((t0 >> 26) | (t1 << 6)) & 0x3ffffff;
    h[2] += ((t1 >> 20) | (t2 << 12)) & 0x3ffffff;
    h[3] += ((t2 >> 14) | (t3 << 18)) & 0x3ffffff;
    h[4] += (t3 >> 8) | hibit;

    // h *= r (mod 2^130 - 5): schoolbook with the 5*r wrap folded in
    uint64_t s1 = r[1] * 5ull, s2 = r[2] * 5ull, s3 = r[3] * 5ull,
             s4 = r[4] * 5ull;
    uint64_t d0 = (uint64_t)h[0] * r[0] + (uint64_t)h[1] * s4 +
                  (uint64_t)h[2] * s3 + (uint64_t)h[3] * s2 +
                  (uint64_t)h[4] * s1;
    uint64_t d1 = (uint64_t)h[0] * r[1] + (uint64_t)h[1] * r[0] +
                  (uint64_t)h[2] * s4 + (uint64_t)h[3] * s3 +
                  (uint64_t)h[4] * s2;
    uint64_t d2 = (uint64_t)h[0] * r[2] + (uint64_t)h[1] * r[1] +
                  (uint64_t)h[2] * r[0] + (uint64_t)h[3] * s4 +
                  (uint64_t)h[4] * s3;
    uint64_t d3 = (uint64_t)h[0] * r[3] + (uint64_t)h[1] * r[2] +
                  (uint64_t)h[2] * r[1] + (uint64_t)h[3] * r[0] +
                  (uint64_t)h[4] * s4;
    uint64_t d4 = (uint64_t)h[0] * r[4] + (uint64_t)h[1] * r[3] +
                  (uint64_t)h[2] * r[2] + (uint64_t)h[3] * r[1] +
                  (uint64_t)h[4] * r[0];

    uint64_t c = d0 >> 26; h[0] = (uint32_t)d0 & 0x3ffffff;
    d1 += c;  c = d1 >> 26; h[1] = (uint32_t)d1 & 0x3ffffff;
    d2 += c;  c = d2 >> 26; h[2] = (uint32_t)d2 & 0x3ffffff;
    d3 += c;  c = d3 >> 26; h[3] = (uint32_t)d3 & 0x3ffffff;
    d4 += c;  c = d4 >> 26; h[4] = (uint32_t)d4 & 0x3ffffff;
    h[0] += (uint32_t)(c * 5);
    c = h[0] >> 26; h[0] &= 0x3ffffff;
    h[1] += (uint32_t)c;
  }

  // Streaming update: partial tails buffer across calls (the AEAD
  // feeds aad / padding / ciphertext / lengths as separate segments
  // of ONE Poly1305 message — only finish() may see a partial block).
  void update(const uint8_t* m, uint64_t len) {
    if (buflen) {
      uint64_t need = 16 - buflen;
      uint64_t take = len < need ? len : need;
      std::memcpy(buf + buflen, m, take);
      buflen += (uint32_t)take;
      m += take;
      len -= take;
      if (buflen < 16) return;
      block(buf, 1u << 24);
      buflen = 0;
    }
    while (len >= 16) {
      block(m, 1u << 24);
      m += 16;
      len -= 16;
    }
    if (len) {
      std::memcpy(buf, m, len);
      buflen = (uint32_t)len;
    }
  }

  void finish(uint8_t tag[16]) {
    if (buflen) {
      // final partial block: append the length bit, zero-fill
      buf[buflen] = 1;
      std::memset(buf + buflen + 1, 0, 16 - buflen - 1);
      block(buf, 0);
      buflen = 0;
    }
    // full carry, then conditionally subtract p = 2^130 - 5
    uint32_t c;
    c = h[1] >> 26; h[1] &= 0x3ffffff; h[2] += c;
    c = h[2] >> 26; h[2] &= 0x3ffffff; h[3] += c;
    c = h[3] >> 26; h[3] &= 0x3ffffff; h[4] += c;
    c = h[4] >> 26; h[4] &= 0x3ffffff; h[0] += c * 5;
    c = h[0] >> 26; h[0] &= 0x3ffffff; h[1] += c;

    uint32_t g0 = h[0] + 5; c = g0 >> 26; g0 &= 0x3ffffff;
    uint32_t g1 = h[1] + c; c = g1 >> 26; g1 &= 0x3ffffff;
    uint32_t g2 = h[2] + c; c = g2 >> 26; g2 &= 0x3ffffff;
    uint32_t g3 = h[3] + c; c = g3 >> 26; g3 &= 0x3ffffff;
    uint32_t g4 = h[4] + c - (1u << 26);

    uint32_t mask = (g4 >> 31) - 1;  // all-ones when h >= p
    h[0] = (h[0] & ~mask) | (g0 & mask);
    h[1] = (h[1] & ~mask) | (g1 & mask);
    h[2] = (h[2] & ~mask) | (g2 & mask);
    h[3] = (h[3] & ~mask) | (g3 & mask);
    h[4] = (h[4] & ~mask) | (g4 & mask);

    // h += pad (mod 2^128), serialize little-endian
    uint64_t f;
    f = (uint64_t)(h[0] | (h[1] << 26)) + pad[0];
    store32(tag + 0, (uint32_t)f);
    f = (uint64_t)((h[1] >> 6) | (h[2] << 20)) + pad[1] + (f >> 32);
    store32(tag + 4, (uint32_t)f);
    f = (uint64_t)((h[2] >> 12) | (h[3] << 14)) + pad[2] + (f >> 32);
    store32(tag + 8, (uint32_t)f);
    f = (uint64_t)((h[3] >> 18) | (h[4] << 8)) + pad[3] + (f >> 32);
    store32(tag + 12, (uint32_t)f);
  }
};

// -- OpenSSL EVP backend (dlopen'd; no headers in this image) ---------
//
// The scalar implementation above is the portable anchor; when the
// platform ships libcrypto (it does here — the Python side's AEAD is
// the same library), the pump routes the cipher through EVP's
// vectorized ChaCha20-Poly1305 (~10x the scalar's throughput) while
// keeping the batched-framing structure.  The EVP_* prototypes are
// declared locally against OpenSSL 3's stable ABI.

typedef struct evp_cipher_ctx_st EVP_CIPHER_CTX;
typedef struct evp_cipher_st EVP_CIPHER;
constexpr int EVP_CTRL_AEAD_GET_TAG = 0x10;
constexpr int EVP_CTRL_AEAD_SET_TAG = 0x11;

struct EvpApi {
  EVP_CIPHER_CTX* (*ctx_new)() = nullptr;
  void (*ctx_free)(EVP_CIPHER_CTX*) = nullptr;
  const EVP_CIPHER* (*chacha20_poly1305)() = nullptr;
  int (*ctrl)(EVP_CIPHER_CTX*, int, int, void*) = nullptr;
  int (*enc_init)(EVP_CIPHER_CTX*, const EVP_CIPHER*, void*,
                  const uint8_t*, const uint8_t*) = nullptr;
  int (*enc_update)(EVP_CIPHER_CTX*, uint8_t*, int*, const uint8_t*,
                    int) = nullptr;
  int (*enc_final)(EVP_CIPHER_CTX*, uint8_t*, int*) = nullptr;
  int (*dec_init)(EVP_CIPHER_CTX*, const EVP_CIPHER*, void*,
                  const uint8_t*, const uint8_t*) = nullptr;
  int (*dec_update)(EVP_CIPHER_CTX*, uint8_t*, int*, const uint8_t*,
                    int) = nullptr;
  int (*dec_final)(EVP_CIPHER_CTX*, uint8_t*, int*) = nullptr;
  bool ok = false;
};

EvpApi load_evp() {
  EvpApi api;
  if (std::getenv("CMT_TPU_FRAME_SCALAR")) return api;
  void* h = nullptr;
  for (const char* name :
       {"libcrypto.so.3", "libcrypto.so", "libcrypto.so.1.1"}) {
    h = dlopen(name, RTLD_NOW | RTLD_LOCAL);
    if (h) break;
  }
  if (!h) return api;
  auto sym = [&](const char* n) { return dlsym(h, n); };
  api.ctx_new = (EVP_CIPHER_CTX * (*)()) sym("EVP_CIPHER_CTX_new");
  api.ctx_free = (void (*)(EVP_CIPHER_CTX*))sym("EVP_CIPHER_CTX_free");
  api.chacha20_poly1305 =
      (const EVP_CIPHER* (*)())sym("EVP_chacha20_poly1305");
  api.ctrl =
      (int (*)(EVP_CIPHER_CTX*, int, int, void*))sym("EVP_CIPHER_CTX_ctrl");
  api.enc_init = (int (*)(EVP_CIPHER_CTX*, const EVP_CIPHER*, void*,
                          const uint8_t*, const uint8_t*))
      sym("EVP_EncryptInit_ex");
  api.enc_update = (int (*)(EVP_CIPHER_CTX*, uint8_t*, int*, const uint8_t*,
                            int))sym("EVP_EncryptUpdate");
  api.enc_final =
      (int (*)(EVP_CIPHER_CTX*, uint8_t*, int*))sym("EVP_EncryptFinal_ex");
  api.dec_init = (int (*)(EVP_CIPHER_CTX*, const EVP_CIPHER*, void*,
                          const uint8_t*, const uint8_t*))
      sym("EVP_DecryptInit_ex");
  api.dec_update = (int (*)(EVP_CIPHER_CTX*, uint8_t*, int*, const uint8_t*,
                            int))sym("EVP_DecryptUpdate");
  api.dec_final =
      (int (*)(EVP_CIPHER_CTX*, uint8_t*, int*))sym("EVP_DecryptFinal_ex");
  api.ok = api.ctx_new && api.ctx_free && api.chacha20_poly1305 &&
           api.ctrl && api.enc_init && api.enc_update && api.enc_final &&
           api.dec_init && api.dec_update && api.dec_final;
  return api;
}

const EvpApi& evp() {
  static const EvpApi api = load_evp();
  return api;
}

// One EVP context per seal/open BURST: the cipher+key initialize
// once, each frame re-initializes only the counter nonce — the
// per-frame ctx_new/key-schedule cost was measured at ~40% of the
// pump's time.  RAII so every return path frees the ctx.
struct EvpCtx {
  EVP_CIPHER_CTX* ctx;
  explicit EvpCtx() : ctx(evp().ok ? evp().ctx_new() : nullptr) {}
  ~EvpCtx() {
    if (ctx) evp().ctx_free(ctx);
  }
  EvpCtx(const EvpCtx&) = delete;
  EvpCtx& operator=(const EvpCtx&) = delete;
};

int evp_seal(EVP_CIPHER_CTX* ctx, bool first, const uint8_t key[32],
             const uint8_t nonce[12], const uint8_t* pt, int len,
             uint8_t* ct, uint8_t tag[16]) {
  const EvpApi& e = evp();
  int n = 0;
  int ok = first ? e.enc_init(ctx, e.chacha20_poly1305(), nullptr, key,
                              nonce)
                 : e.enc_init(ctx, nullptr, nullptr, nullptr, nonce);
  if (ok == 1 && e.enc_update(ctx, ct, &n, pt, len) == 1 && n == len &&
      e.enc_final(ctx, ct + n, &n) == 1 &&
      e.ctrl(ctx, EVP_CTRL_AEAD_GET_TAG, 16, tag) == 1)
    return 0;
  return -1;
}

int evp_open(EVP_CIPHER_CTX* ctx, bool first, const uint8_t key[32],
             const uint8_t nonce[12], const uint8_t* ct, int len,
             const uint8_t tag[16], uint8_t* pt) {
  const EvpApi& e = evp();
  int n = 0;
  uint8_t tagbuf[16];
  std::memcpy(tagbuf, tag, 16);
  int ok = first ? e.dec_init(ctx, e.chacha20_poly1305(), nullptr, key,
                              nonce)
                 : e.dec_init(ctx, nullptr, nullptr, nullptr, nonce);
  if (ok == 1 && e.dec_update(ctx, pt, &n, ct, len) == 1 && n == len &&
      e.ctrl(ctx, EVP_CTRL_AEAD_SET_TAG, 16, tagbuf) == 1 &&
      e.dec_final(ctx, pt + n, &n) == 1)
    return 0;
  return -1;
}

// -- AEAD construction (RFC 8439 §2.8) --------------------------------

void aead_tag(const ChaChaState& st, const uint8_t* aad, uint64_t aad_len,
              const uint8_t* ct, uint64_t ct_len, uint8_t tag[16]) {
  uint8_t otk[64];
  chacha20_block(st, 0, otk);  // poly key = first 32 bytes of block 0
  Poly1305 poly;
  poly.init(otk);
  static const uint8_t zeros[16] = {0};
  poly.update(aad, aad_len);
  if (aad_len % 16) poly.update(zeros, 16 - aad_len % 16);
  poly.update(ct, ct_len);
  if (ct_len % 16) poly.update(zeros, 16 - ct_len % 16);
  uint8_t lens[16];
  store64(lens, aad_len);
  store64(lens + 8, ct_len);
  poly.update(lens, 16);
  poly.finish(tag);
}

inline ChaChaState make_state(const uint8_t key[32], const uint8_t nonce[12]) {
  ChaChaState st;
  for (int i = 0; i < 8; i++) st.key[i] = load32(key + 4 * i);
  for (int i = 0; i < 3; i++) st.nonce[i] = load32(nonce + 4 * i);
  return st;
}

// counter nonce: 4 zero bytes + 64-bit little-endian counter
// (secret_connection.go:47 aeadNonceSize layout)
inline ChaChaState make_counter_state(const uint8_t key[32], uint64_t ctr) {
  uint8_t nonce[12] = {0};
  store64(nonce + 4, ctr);
  return make_state(key, nonce);
}

inline int tag_equal(const uint8_t a[16], const uint8_t b[16]) {
  uint8_t d = 0;
  for (int i = 0; i < 16; i++) d |= a[i] ^ b[i];
  return d == 0;
}

}  // namespace

extern "C" {

// Raw AEAD seal: out = ciphertext || 16-byte tag (out_cap >= len+16).
// Returns bytes written, or -1 on bad args.  Test hook / KAT anchor.
long cmt_aead_seal(const uint8_t* key, const uint8_t* nonce,
                   const uint8_t* aad, uint64_t aad_len, const uint8_t* pt,
                   uint64_t len, uint8_t* out, uint64_t out_cap) {
  if (out_cap < len + TAG_SIZE) return -1;
  ChaChaState st = make_state(key, nonce);
  chacha20_xor(st, 1, pt, out, len);
  aead_tag(st, aad, aad_len, out, len, out + len);
  return (long)(len + TAG_SIZE);
}

// Raw AEAD open: in = ciphertext || tag.  Returns plaintext length
// written to out, or -1 on auth failure / bad args.
long cmt_aead_open(const uint8_t* key, const uint8_t* nonce,
                   const uint8_t* aad, uint64_t aad_len, const uint8_t* in,
                   uint64_t in_len, uint8_t* out, uint64_t out_cap) {
  if (in_len < TAG_SIZE || out_cap < in_len - TAG_SIZE) return -1;
  uint64_t len = in_len - TAG_SIZE;
  ChaChaState st = make_state(key, nonce);
  uint8_t tag[16];
  aead_tag(st, aad, aad_len, in, len, tag);
  if (!tag_equal(tag, in + len)) return -1;
  chacha20_xor(st, 1, in, out, len);
  return (long)len;
}

// Seal ``data`` into consecutive 1044-byte frames with counter nonces
// nonce0, nonce0+1, ... (empty data still produces one empty frame,
// matching the Python write() loop).  Returns the number of frames
// written, or -1 when out_cap is too small / the counter would wrap.
long cmt_frames_seal(const uint8_t* key, uint64_t nonce0,
                     const uint8_t* data, uint64_t len, uint8_t* out,
                     uint64_t out_cap) {
  uint64_t nframes = len == 0 ? 1 : (len + DATA_MAX_SIZE - 1) / DATA_MAX_SIZE;
  if (out_cap < nframes * SEALED_FRAME_SIZE) return -1;
  if (nonce0 + nframes < nonce0) return -1;  // counter wrap
  uint8_t frame[TOTAL_FRAME_SIZE];
  const bool use_evp = evp().ok;
  EvpCtx ec;
  if (use_evp && !ec.ctx) return -2;
  for (uint64_t f = 0; f < nframes; f++) {
    uint64_t off = f * DATA_MAX_SIZE;
    uint64_t chunk = len - off < DATA_MAX_SIZE ? len - off : DATA_MAX_SIZE;
    store32(frame, (uint32_t)chunk);
    std::memcpy(frame + DATA_LEN_SIZE, data + off, chunk);
    std::memset(frame + DATA_LEN_SIZE + chunk, 0,
                DATA_MAX_SIZE - chunk);
    uint8_t* dst = out + f * SEALED_FRAME_SIZE;
    if (use_evp) {
      uint8_t nonce[12] = {0};
      store64(nonce + 4, nonce0 + f);
      if (evp_seal(ec.ctx, f == 0, key, nonce, frame, TOTAL_FRAME_SIZE,
                   dst, dst + TOTAL_FRAME_SIZE) != 0)
        return -2;
    } else {
      ChaChaState st = make_counter_state(key, nonce0 + f);
      chacha20_xor(st, 1, frame, dst, TOTAL_FRAME_SIZE);
      aead_tag(st, nullptr, 0, dst, TOTAL_FRAME_SIZE,
               dst + TOTAL_FRAME_SIZE);
    }
  }
  return (long)nframes;
}

// Open ``n`` consecutive sealed frames (counter nonces nonce0...).
// Payloads are written contiguously to out; per-frame payload lengths
// to lens (callers split multi-frame reads without rescanning).
// Returns total payload bytes; -(i+1) when frame i fails auth;
// -1000000-(i) when frame i declares an invalid length; -2000000 for
// a too-small out_cap; -2000001 for a cipher resource failure (the
// auth codes stay unambiguous: reads are far below 1e6 frames).
long cmt_frames_open(const uint8_t* key, uint64_t nonce0,
                     const uint8_t* sealed, uint64_t n, uint8_t* out,
                     uint64_t out_cap, uint32_t* lens) {
  if (out_cap < n * DATA_MAX_SIZE || n >= 500000) return -2000000;
  uint8_t frame[TOTAL_FRAME_SIZE];
  const bool use_evp = evp().ok;
  EvpCtx ec;
  if (use_evp && !ec.ctx) return -2000001;
  uint64_t total = 0;
  for (uint64_t f = 0; f < n; f++) {
    const uint8_t* src = sealed + f * SEALED_FRAME_SIZE;
    if (use_evp) {
      uint8_t nonce[12] = {0};
      store64(nonce + 4, nonce0 + f);
      if (evp_open(ec.ctx, f == 0, key, nonce, src, TOTAL_FRAME_SIZE,
                   src + TOTAL_FRAME_SIZE, frame) != 0)
        return -(long)(f + 1);
    } else {
      ChaChaState st = make_counter_state(key, nonce0 + f);
      uint8_t tag[16];
      aead_tag(st, nullptr, 0, src, TOTAL_FRAME_SIZE, tag);
      if (!tag_equal(tag, src + TOTAL_FRAME_SIZE)) return -(long)(f + 1);
      chacha20_xor(st, 1, src, frame, TOTAL_FRAME_SIZE);
    }
    uint32_t dlen = load32(frame);
    if (dlen > DATA_MAX_SIZE) return -1000000 - (long)f;
    std::memcpy(out + total, frame + DATA_LEN_SIZE, dlen);
    lens[f] = dlen;
    total += dlen;
  }
  return (long)total;
}

// Which cipher backend the frame functions use: 1 = OpenSSL EVP
// (dlopen'd libcrypto), 0 = built-in scalar RFC 8439.
int cmt_frame_backend() { return evp().ok ? 1 : 0; }

}  // extern "C"
