// SHA-512 on the device, one lane per thread: of pre-padded
// feature-first buffers (sha512_padded), and of R || A || M read
// straight from the keyed verify's packed rows (sha512_keyed).
//
// Replaces cometbft_tpu/ops/sha512.py:116 `sha512_padded` (with
// `_compress` :77 and `_schedule` :61), which XLA compiles into the
// keyed verify program at cometbft_tpu/ops/ed25519_verify.py:163
// together with the padded input (`build_padded_input`, :66).  In eager
// PyTorch the same computation would be ~10^4 tensor launches per
// verify (2 blocks x (64 schedule steps + 80 rounds) x ~30 ops); here it
// is one.
//
// sha512_padded: buf is (nblocks * 128, n) uint8, byte r of lane j at
// buf[r*n + j] (the caller supplies the FIPS 180-4 padding; see
// ops/ed25519_verify.build_padded_input).  Lane j absorbs only its first
// min(nblocks, nblocks_lane[j]) blocks, as the reference's masked
// select does.
//
// sha512_keyed: buf is the packed rows (104 + bucket, ld) uint8 --
// pub[32] | sig[64] | msg[bucket] | msglen_le[4] | key_id_le[4], lane j
// in column j, rows ld bytes apart, so a slice of a wider batch needs no
// copy.  The generic tier's rows (100 + bucket, ld), without the key ids,
// hash the same way: R, A, the message and its length sit at the same
// rows in both layouts, and the key-id rows are never read.  The
// message is R (rows 32:64) || A (rows 0:32) || M (rows
// 96:96+msglen); each 64-bit word of a block is assembled in registers
// with the padding exactly where build_padded_input puts it: 0x80 at
// byte 64 + msglen, the big-endian bit length in the last 8 bytes of the
// lane's own last block, nothing past it (a lane that needs fewer blocks
// than the bucket's stops early).  That replaces the ~20 torch ops that
// built the padded input on the device and the buffer they wrote.
//
// Both write (64, n) uint8, the big-endian digest bytes, and share one
// compression function.
//
// Bound on the H100: per block a lane reads at most 128 bytes and needs
// about 2.7k 64-bit operations, 5.4k 32-bit ones (a rotate is two funnel
// shifts, an add an add and an add-with-carry), so both kernels are
// bound by operations.  The design keeps the 8-word state and the
// 16-word schedule window in registers and the round constants in
// __constant__ memory (every lane reads the same K[t] at the same time,
// which the constant cache broadcasts).  Byte loads are strided by the
// row stride, so neighbouring threads read neighbouring bytes:
// coalesced.
//
// The per-lane body of sha512_keyed compiles as plain C++ too:
// `sha512_keyed_host` runs it on the host for a check where there is no
// card.

#include <cstdint>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#define SH_HD __host__ __device__
#define SH_INLINE __forceinline__
#else
#define SH_HD
#define SH_INLINE inline
#endif

namespace {

#define SHA512_K_INIT {                                     \
  0x428a2f98d728ae22ULL, 0x7137449123ef65cdULL, 0xb5c0fbcfec4d3b2fULL, \
  0xe9b5dba58189dbbcULL, 0x3956c25bf348b538ULL, 0x59f111f1b605d019ULL, \
  0x923f82a4af194f9bULL, 0xab1c5ed5da6d8118ULL, 0xd807aa98a3030242ULL, \
  0x12835b0145706fbeULL, 0x243185be4ee4b28cULL, 0x550c7dc3d5ffb4e2ULL, \
  0x72be5d74f27b896fULL, 0x80deb1fe3b1696b1ULL, 0x9bdc06a725c71235ULL, \
  0xc19bf174cf692694ULL, 0xe49b69c19ef14ad2ULL, 0xefbe4786384f25e3ULL, \
  0x0fc19dc68b8cd5b5ULL, 0x240ca1cc77ac9c65ULL, 0x2de92c6f592b0275ULL, \
  0x4a7484aa6ea6e483ULL, 0x5cb0a9dcbd41fbd4ULL, 0x76f988da831153b5ULL, \
  0x983e5152ee66dfabULL, 0xa831c66d2db43210ULL, 0xb00327c898fb213fULL, \
  0xbf597fc7beef0ee4ULL, 0xc6e00bf33da88fc2ULL, 0xd5a79147930aa725ULL, \
  0x06ca6351e003826fULL, 0x142929670a0e6e70ULL, 0x27b70a8546d22ffcULL, \
  0x2e1b21385c26c926ULL, 0x4d2c6dfc5ac42aedULL, 0x53380d139d95b3dfULL, \
  0x650a73548baf63deULL, 0x766a0abb3c77b2a8ULL, 0x81c2c92e47edaee6ULL, \
  0x92722c851482353bULL, 0xa2bfe8a14cf10364ULL, 0xa81a664bbc423001ULL, \
  0xc24b8b70d0f89791ULL, 0xc76c51a30654be30ULL, 0xd192e819d6ef5218ULL, \
  0xd69906245565a910ULL, 0xf40e35855771202aULL, 0x106aa07032bbd1b8ULL, \
  0x19a4c116b8d2d0c8ULL, 0x1e376c085141ab53ULL, 0x2748774cdf8eeb99ULL, \
  0x34b0bcb5e19b48a8ULL, 0x391c0cb3c5c95a63ULL, 0x4ed8aa4ae3418acbULL, \
  0x5b9cca4f7763e373ULL, 0x682e6ff3d6b2b8a3ULL, 0x748f82ee5defb2fcULL, \
  0x78a5636f43172f60ULL, 0x84c87814a1f0ab72ULL, 0x8cc702081a6439ecULL, \
  0x90befffa23631e28ULL, 0xa4506cebde82bde9ULL, 0xbef9a3f7b2c67915ULL, \
  0xc67178f2e372532bULL, 0xca273eceea26619cULL, 0xd186b8c721c0c207ULL, \
  0xeada7dd6cde0eb1eULL, 0xf57d4f7fee6ed178ULL, 0x06f067aa72176fbaULL, \
  0x0a637dc5a2c898a6ULL, 0x113f9804bef90daeULL, 0x1b710b35131c471bULL, \
  0x28db77f523047d84ULL, 0x32caab7b40c72493ULL, 0x3c9ebe0a15c9bebcULL, \
  0x431d67c49c100d4cULL, 0x4cc5d4becb3e42b6ULL, 0x597f299cfc657e2aULL, \
  0x5fcb6fab3ad6faecULL, 0x6c44198c4a475817ULL \
  }
#define SHA512_IV_INIT {                                    \
  0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL, \
  0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL, \
  0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL \
  }

#ifdef __CUDACC__
__constant__ uint64_t kK_d[80] = SHA512_K_INIT;
__constant__ uint64_t kIV_d[8] = SHA512_IV_INIT;
#endif
const uint64_t kK_h[80] = SHA512_K_INIT;
const uint64_t kIV_h[8] = SHA512_IV_INIT;

#ifdef __CUDA_ARCH__
#define SH_K kK_d
#define SH_IV kIV_d
#else
#define SH_K kK_h
#define SH_IV kIV_h
#endif

SH_HD SH_INLINE uint64_t rotr(uint64_t x, int s) { return (x >> s) | (x << (64 - s)); }

// One block: the state st absorbs the 16 words w (w is clobbered).
SH_HD SH_INLINE void compress(uint64_t (&st)[8], uint64_t (&w)[16]) {
  uint64_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint64_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll 16
  for (int t = 0; t < 80; ++t) {
    uint64_t wt;
    if (t < 16) {
      wt = w[t & 15];
    } else {
      const uint64_t w1 = w[(t + 1) & 15], w14 = w[(t + 14) & 15];
      const uint64_t s0 = rotr(w1, 1) ^ rotr(w1, 8) ^ (w1 >> 7);
      const uint64_t s1 = rotr(w14, 19) ^ rotr(w14, 61) ^ (w14 >> 6);
      wt = w[t & 15] + s0 + w[(t + 9) & 15] + s1;
      w[t & 15] = wt;
    }
    const uint64_t ch = (e & f) ^ (~e & g);
    const uint64_t maj = (a & b) ^ (a & c) ^ (b & c);
    const uint64_t big0 = rotr(a, 28) ^ rotr(a, 34) ^ rotr(a, 39);
    const uint64_t big1 = rotr(e, 14) ^ rotr(e, 18) ^ rotr(e, 41);
    const uint64_t t1 = h + big1 + ch + SH_K[t] + wt;
    const uint64_t t2 = big0 + maj;
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

SH_HD SH_INLINE void store_digest(const uint64_t (&st)[8], uint8_t* out, int64_t n) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k) out[(i * 8 + k) * n] = static_cast<uint8_t>(st[i] >> (56 - 8 * k));
  }
}

// SHA-512(R || A || M) of the lane whose column starts at col (rows ld
// bytes apart), written to out[0], out[n], ...: build_padded_input's
// bytes, absorbed for min(nblocks, the lane's own block count) blocks.
// msglen is read as build_padded_input's caller reads it (a signed
// little-endian int32), so any row content hashes as the plain version
// hashes it.
SH_HD SH_INLINE void keyed_lane(const uint8_t* col, int64_t ld, int bucket, int nblocks,
                                uint8_t* out, int64_t n) {
  const uint8_t* lb = col + static_cast<int64_t>(96 + bucket) * ld;
  const int32_t msglen = static_cast<int32_t>(
      static_cast<uint32_t>(lb[0]) | (static_cast<uint32_t>(lb[ld]) << 8) |
      (static_cast<uint32_t>(lb[2 * ld]) << 16) | (static_cast<uint32_t>(lb[3 * ld]) << 24));
  const int64_t total = 64 + static_cast<int64_t>(msglen);
  const int64_t own = (total + 17 + 127) >> 7;  // floor division by 128
  const int used = own < nblocks ? (own < 0 ? 0 : static_cast<int>(own)) : nblocks;
  const int64_t last = own * 128 - 1;  // the lane's last padded byte
  const int64_t bits = total * 8;
  const int64_t content = 64 + bucket;
  uint64_t st[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] = SH_IV[i];
  const int64_t data_end = total < content ? total : content;
  for (int blk = 0; blk < used; ++blk) {
    uint64_t w[16];
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      uint64_t v = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int64_t p = static_cast<int64_t>(blk) * 128 + t * 8 + k;
        const int64_t row = p < 32 ? 32 + p : p < 64 ? p - 32 : 32 + p;
        uint32_t byte = p < data_end ? col[row * ld] : 0u;
        byte = p == total ? 0x80u : byte;
        const uint64_t from_end = static_cast<uint64_t>(last - p);
        byte = from_end < 8 ? static_cast<uint32_t>((bits >> (8 * from_end)) & 0xFF) : byte;
        v = (v << 8) | byte;
      }
      w[t] = v;
    }
    compress(st, w);
  }
  store_digest(st, out, n);
}

}  // namespace

#ifdef __CUDACC__

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
sha512_padded_kernel(const uint8_t* __restrict__ buf, int nblocks,
                     const int64_t* __restrict__ nblocks_lane,
                     uint8_t* __restrict__ out, int64_t n) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (lane >= n) return;
  uint64_t st[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] = SH_IV[i];
  const int64_t want = nblocks_lane[lane];
  const int used = want < nblocks ? (want < 0 ? 0 : static_cast<int>(want)) : nblocks;
  for (int blk = 0; blk < used; ++blk) {
    const uint8_t* p = buf + static_cast<int64_t>(blk) * 128 * n + lane;
    uint64_t w[16];
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      uint64_t v = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) v = (v << 8) | p[(t * 8 + k) * n];
      w[t] = v;
    }
    compress(st, w);
  }
  store_digest(st, out + lane, n);
}

__global__ void __launch_bounds__(THREADS)
sha512_keyed_kernel(const uint8_t* __restrict__ buf, int64_t ld, int bucket, int nblocks,
                    uint8_t* __restrict__ out, int64_t n) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (lane >= n) return;
  keyed_lane(buf + lane, ld, bucket, nblocks, out + lane, n);
}

unsigned grid_for(int64_t n) { return static_cast<unsigned>((n + THREADS - 1) / THREADS); }

}  // namespace

// C interface, loaded with ctypes: each launches on `stream`, does not
// synchronise, returns cudaGetLastError() (0 on success).
extern "C" int sha512_padded_launch(const void* buf, int nblocks,
                                    const void* nblocks_lane, void* out,
                                    int64_t n, void* stream) {
  if (n > 0) {
    sha512_padded_kernel<<<grid_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(buf), nblocks,
        static_cast<const int64_t*>(nblocks_lane), static_cast<uint8_t*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sha512_keyed_launch(const void* buf, int64_t ld, int bucket, int nblocks,
                                   void* out, int64_t n, void* stream) {
  if (n > 0) {
    sha512_keyed_kernel<<<grid_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(buf), ld, bucket, nblocks, static_cast<uint8_t*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}

#else  // a host C++ compiler: sha512_keyed's per-lane body on the CPU

// Host check of the kernel source: the same arguments on host memory,
// lanes one after another.
extern "C" int sha512_keyed_host(const void* buf, int64_t ld, int bucket, int nblocks,
                                 void* out, int64_t n) {
  for (int64_t lane = 0; lane < n; ++lane) {
    keyed_lane(static_cast<const uint8_t*>(buf) + lane, ld, bucket, nblocks,
               static_cast<uint8_t*>(out) + lane, n);
  }
  return 0;
}

#endif
