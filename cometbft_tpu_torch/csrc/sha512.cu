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
// 96:96+msglen), with the padding exactly where build_padded_input puts
// it: 0x80 at byte 64 + msglen, the big-endian bit length in the last 8
// bytes of the lane's own last block, nothing past it (a lane that needs
// fewer blocks than the bucket's stops early).
//
// Both write (64, n) uint8, the big-endian digest bytes, and share one
// compression function.
//
// Bound on the H100: per block a lane reads at most 128 bytes and needs
// about 2.7k 64-bit operations, 5.4k 32-bit ones (a rotate is two funnel
// shifts, an add an add and an add-with-carry), so both kernels are
// bound by operations.  But at the main path's 256 to 8192 lanes the
// card holds at most one warp per SM partition, so a launch takes one
// lane's latency: its loads, then two blocks of 80 dependent rounds.
//
// sha512_keyed's design.  A block is two warps for 32 lanes.  The
// schedule warp copies, for each 128-byte block of the message, the rows
// it covers, 32 bytes of each (its lanes' columns), into shared memory:
// 16-byte cp.async where the rows' bytes are 16-byte aligned, 4-byte
// cp.async where they are 4-byte aligned, byte loads otherwise (an odd
// row stride, a slice at an odd column, the last block's lanes past n);
// rows past the bucket are not read.  The first copy also takes the 4
// length rows.  A lane's 16 words are built from 8 shared bytes each
// with __byte_perm, the padding placed by word: the data bytes kept by
// one mask, the 0x80 byte by one shift, the length as a whole word.  The
// schedule warp then runs the message schedule (W[16..79]) ahead and
// writes every W[t] to shared memory, 16 at a time, while the rounds warp
// runs the 80 rounds on them, its 8 working variables in registers and
// the round constants in __constant__ memory (every lane reads the same
// K[t] at the same time, which the constant cache broadcasts); named
// barriers pass each 16 words, two schedule buffers let the schedule run
// a block ahead, and the next block's copy is in flight meanwhile.  One
// thread per lane ran the schedule and the rounds in one instruction
// stream: at these lane counts a warp is alone on its SM partition, so
// a block took its instructions' issue time; taking the schedule's third
// of them off the rounds' stream cut 32 lanes alone from 13.3 to 10.3 us
// a launch (tools/torch_product_cycles.py on an H100: 18808 cycles for
// one warp's two blocks).  Every unrolled round and schedule step keeps
// its words in registers or at constant shared addresses.
//
// The per-lane steps of sha512_keyed and its staging compile as plain
// C++ too: `sha512_keyed_host` runs them on the host, 32 lanes' copy and
// then their words, schedule and rounds in turn, for a check where there
// is no card.

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

// W[16c] .. W[16c + 15] of the message schedule, in place over the 16
// words before them (w[i] holds W[16(c - 1) + i] on entry).
SH_HD SH_INLINE void schedule16(uint64_t (&w)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const uint64_t w1 = w[(i + 1) & 15], w14 = w[(i + 14) & 15];
    const uint64_t s0 = rotr(w1, 1) ^ rotr(w1, 8) ^ (w1 >> 7);
    const uint64_t s1 = rotr(w14, 19) ^ rotr(w14, 61) ^ (w14 >> 6);
    w[i] += s0 + w[(i + 9) & 15] + s1;
  }
}

// Rounds 16c .. 16c + 15 on the working variables v = (a, ..., h), round
// 16c + i taking the word word(i).  Inlined with c a constant, so every
// K[t] is a constant address.
template <class Word>
SH_HD SH_INLINE void rounds16(uint64_t (&v)[8], int c, Word word) {
  uint64_t a = v[0], b = v[1], cc = v[2], d = v[3], e = v[4], f = v[5], g = v[6], h = v[7];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const uint64_t ch = (e & f) ^ (~e & g);
    const uint64_t maj = (a & b) ^ (a & cc) ^ (b & cc);
    const uint64_t big0 = rotr(a, 28) ^ rotr(a, 34) ^ rotr(a, 39);
    const uint64_t big1 = rotr(e, 14) ^ rotr(e, 18) ^ rotr(e, 41);
    const uint64_t t1 = h + big1 + ch + SH_K[16 * c + i] + word(i);
    const uint64_t t2 = big0 + maj;
    h = g; g = f; f = e; e = d + t1;
    d = cc; cc = b; b = a; a = t1 + t2;
  }
  v[0] = a; v[1] = b; v[2] = cc; v[3] = d; v[4] = e; v[5] = f; v[6] = g; v[7] = h;
}

// One block: the state st absorbs the 16 words w (w is clobbered).
// Fully unrolled, so every index into w is a constant and the schedule
// stays in registers.
SH_HD SH_INLINE void compress(uint64_t (&st)[8], uint64_t (&w)[16]) {
  uint64_t v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = st[i];
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    if (c > 0) schedule16(w);
    rounds16(v, c, [&](int i) { return w[i]; });
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] += v[i];
}

SH_HD SH_INLINE void store_digest(const uint64_t (&st)[8], uint8_t* out, int64_t n) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k) out[(i * 8 + k) * n] = static_cast<uint8_t>(st[i] >> (56 - 8 * k));
  }
}

// -- sha512_keyed: 32 lanes' rows staged in shared memory ---------------

constexpr int LANES = 32;       // lanes of a block (its schedule warp and its rounds warp)
constexpr int SROWS = 128 + 4;  // a message block's bytes, then the length rows

// The packed row that holds byte p of R || A || M.
SH_HD SH_INLINE int64_t src_row(int64_t p) { return p < 32 ? 32 + p : p < 64 ? p - 32 : 32 + p; }

#ifdef __CUDA_ARCH__
__device__ SH_INLINE void copy_async(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
  }
}
__device__ SH_INLINE void copy_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }
#else
inline void copy_async(void* dst, const void* src, int bytes) {
  for (int k = 0; k < bytes; ++k) static_cast<uint8_t*>(dst)[k] = static_cast<const uint8_t*>(src)[k];
}
inline void copy_wait() {}
#endif

// 16 staged bytes of one row: `have` of them belong to lanes below n.
SH_HD SH_INLINE void copy16(uint8_t* dst, const uint8_t* src, int64_t have) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(src);
  if (have >= 16 && at % 16 == 0) {
    copy_async(dst, src, 16);
  } else if (have >= 16 && at % 4 == 0) {
    for (int k = 0; k < 16; k += 4) copy_async(dst + k, src + k, 4);
  } else {
    for (int k = 0; k < 16; ++k) dst[k] = k < have ? src[k] : 0;
  }
}

// Thread `tid`'s part (of 32) of staging message block `blk` of the 32
// lanes from lane0: stage row r < 128 is byte 128 blk + r of R || A || M
// for those lanes (rows past the bucket are left as they are: the
// padding masks them), and, for block 0, rows 128-131 the length rows.
// Each row is two 16-byte chunks, thread tid takes chunks tid, tid + 32,
// ...
SH_HD SH_INLINE void stage_block(uint8_t* stage, const uint8_t* buf, int64_t ld, int bucket,
                                 int64_t lane0, int64_t n, int blk, int tid) {
  const int chunks = 2 * (blk == 0 ? SROWS : 128);
  for (int c = tid; c < chunks; c += LANES) {
    const int r = c >> 1, half = c & 1;
    int64_t row;
    if (r < 128) {
      const int64_t p = static_cast<int64_t>(blk) * 128 + r;
      if (p >= 64 + bucket) continue;
      row = src_row(p);
    } else {
      row = 96 + bucket + (r - 128);
    }
    const int64_t first = lane0 + 16 * half;
    copy16(stage + r * LANES + 16 * half, buf + row * ld + first, n - first);
  }
}

// (b0 << 24) | (b1 << 16) | (b2 << 8) | b3
SH_HD SH_INLINE uint32_t be32(uint32_t b0, uint32_t b1, uint32_t b2, uint32_t b3) {
#ifdef __CUDA_ARCH__
  return __byte_perm(__byte_perm(b3, b2, 0x0040), __byte_perm(b1, b0, 0x0040), 0x5410);
#else
  return (b0 << 24) | (b1 << 16) | (b2 << 8) | b3;
#endif
}

// The first n bytes (0 to 4, clamped) of a big-endian 32-bit word.
SH_HD SH_INLINE uint32_t head_mask(int n) {
  n = n < 0 ? 0 : n > 4 ? 4 : n;
#ifdef __CUDA_ARCH__
  return __funnelshift_rc(0u, 0xffffffffu, 8 * n);
#else
  return static_cast<uint32_t>(0xffffffff00000000ull >> (8 * n));
#endif
}

// One lane's hash in progress: where its data, its 0x80 byte and its
// length word fall, how many blocks it absorbs, and the state.
struct KeyedLane {
  int64_t data_end;  // bytes below it are R || A || M
  int64_t total;     // the 0x80 byte: 64 + msglen
  int64_t len_word;  // the first byte of the big-endian bit length
  uint64_t bits;
  int used;          // blocks absorbed: min(nblocks, the lane's own count)
  uint64_t st[8];
};

// x - base as an offset into a 128-byte block, clamped to [-8, 136]: the
// padding's positions in 32-bit arithmetic.
SH_HD SH_INLINE int block_offset(int64_t x, int64_t base) {
  const int64_t d = x - base;
  return static_cast<int>(d < -8 ? -8 : d > 136 ? 136 : d);
}

// A lane's plan from its staged length bytes (rows 128-131 of block 0's
// stage).  msglen is read as build_padded_input's caller reads it (a
// signed little-endian int32), so any row content hashes as the plain
// version hashes it.
SH_HD SH_INLINE KeyedLane keyed_begin(const uint8_t* stage, int lane, int bucket, int nblocks) {
  const uint8_t* lb = stage + 128 * LANES + lane;
  const int32_t msglen = static_cast<int32_t>(
      static_cast<uint32_t>(lb[0]) | (static_cast<uint32_t>(lb[LANES]) << 8) |
      (static_cast<uint32_t>(lb[2 * LANES]) << 16) | (static_cast<uint32_t>(lb[3 * LANES]) << 24));
  KeyedLane s;
  s.total = 64 + static_cast<int64_t>(msglen);
  const int64_t content = 64 + bucket;
  s.data_end = s.total < content ? s.total : content;
  const int64_t own = (s.total + 17 + 127) >> 7;  // floor division by 128
  s.used = own < nblocks ? (own < 0 ? 0 : static_cast<int>(own)) : nblocks;
  s.len_word = own * 128 - 8;
  s.bits = static_cast<uint64_t>(s.total * 8);
#pragma unroll
  for (int i = 0; i < 8; ++i) s.st[i] = SH_IV[i];
  return s;
}

// The 16 words of block blk of the lane's padded message, from the
// stage.  The padding goes in by word, without a branch: the data
// bytes kept by a mask, the 0x80 byte or'ed in, the length word in place
// of the word.
SH_HD SH_INLINE void keyed_words(const KeyedLane& s, const uint8_t* stage, int lane, int blk,
                                 uint64_t (&w)[16]) {
  const int64_t base = static_cast<int64_t>(blk) * 128;
  const int data = block_offset(s.data_end, base), mark = block_offset(s.total, base);
  const int len = block_offset(s.len_word, base);
  const uint32_t bits_hi = static_cast<uint32_t>(s.bits >> 32);
  const uint32_t bits_lo = static_cast<uint32_t>(s.bits);
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    const uint8_t* b = stage + 8 * t * LANES + lane;
    uint32_t hi = be32(b[0], b[LANES], b[2 * LANES], b[3 * LANES]);
    uint32_t lo = be32(b[4 * LANES], b[5 * LANES], b[6 * LANES], b[7 * LANES]);
    const int o = 8 * t;
    hi &= head_mask(data - o);
    lo &= head_mask(data - o - 4);
    const int at = mark - o;  // the 0x80 byte's place in the word
    hi |= static_cast<unsigned>(at) < 4u ? 0x80u << ((24 - 8 * at) & 31) : 0u;
    lo |= static_cast<unsigned>(at - 4) < 4u ? 0x80u << ((56 - 8 * at) & 31) : 0u;
    hi = len == o ? bits_hi : hi;
    lo = len == o ? bits_lo : lo;
    w[t] = (static_cast<uint64_t>(hi) << 32) | lo;
  }
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

// Two warps for 32 lanes: the schedule warp stages the rows, builds
// each block's 16 words and runs the message schedule ahead, writing
// W[0..79] to shared memory 16 words at a time; the rounds warp runs the
// 80 rounds on them.  Named barriers pair them: CHUNK + 5p + c when
// chunk c of a block in schedule buffer p is written (bar.arrive by the
// schedule warp, bar.sync by the rounds warp), FREE + p when the rounds
// warp is done with buffer p, which the schedule warp waits for before
// it writes the block two after.  A barrier id is never arrived at twice
// before it completes: a warp reaches buffer p's barriers again only
// after FREE + p.
constexpr int SPLIT = 2 * LANES;
constexpr int CHUNK = 1, FREE = CHUNK + 10;  // ids 1-12; 0 is __syncthreads

__device__ SH_INLINE void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(SPLIT) : "memory");
}
__device__ SH_INLINE void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(SPLIT) : "memory");
}

__global__ void __launch_bounds__(SPLIT)
sha512_keyed_kernel(const uint8_t* __restrict__ buf, int64_t ld, int bucket, int nblocks,
                    uint8_t* __restrict__ out, int64_t n) {
  __shared__ __align__(16) uint8_t stage[SROWS * LANES];
  __shared__ uint64_t sched[2][80][LANES];
  const int tid = threadIdx.x % LANES;
  const bool rounds_warp = threadIdx.x < LANES;
  const int64_t lane0 = static_cast<int64_t>(blockIdx.x) * LANES, lane = lane0 + tid;
  if (!rounds_warp) {
    stage_block(stage, buf, ld, bucket, lane0, n, 0, tid);
    copy_wait();
  }
  __syncthreads();
  KeyedLane s = keyed_begin(stage, tid, bucket, nblocks);
  if (lane >= n) s.used = 0;
  const int blocks = __reduce_max_sync(0xffffffffu, s.used);
  if (rounds_warp) {
    for (int blk = 0; blk < blocks; ++blk) {
      const bool active = blk < s.used;
      const int p = blk & 1;
      uint64_t v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = s.st[i];
#pragma unroll
      for (int c = 0; c < 5; ++c) {
        bar_sync(CHUNK + 5 * p + c);
        if (active) rounds16(v, c, [&](int i) { return sched[p][16 * c + i][tid]; });
      }
      if (blk + 2 < blocks) bar_arrive(FREE + p);
      if (active) {
#pragma unroll
        for (int i = 0; i < 8; ++i) s.st[i] += v[i];
      }
    }
    if (lane < n) store_digest(s.st, out + lane, n);
  } else {
    for (int blk = 0; blk < blocks; ++blk) {
      const bool active = blk < s.used;
      const int p = blk & 1;
      if (blk >= 2) bar_sync(FREE + p);
      uint64_t w[16];
      if (active) {
        keyed_words(s, stage, tid, blk, w);
#pragma unroll
        for (int i = 0; i < 16; ++i) sched[p][i][tid] = w[i];
      }
      __syncwarp();  // the stage is read: the next block's copy may land
      if (blk + 1 < blocks) stage_block(stage, buf, ld, bucket, lane0, n, blk + 1, tid);
      bar_arrive(CHUNK + 5 * p);
#pragma unroll
      for (int c = 1; c < 5; ++c) {
        if (active) {
          schedule16(w);
#pragma unroll
          for (int i = 0; i < 16; ++i) sched[p][16 * c + i][tid] = w[i];
        }
        bar_arrive(CHUNK + 5 * p + c);
      }
      copy_wait();
      __syncwarp();
    }
  }
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

// `ev0` and `ev1`, when not null, are CUDA events recorded on `stream`
// just before and just after the kernel, in this one call.
extern "C" int sha512_keyed_launch(const void* buf, int64_t ld, int bucket, int nblocks,
                                   void* out, int64_t n, void* stream, void* ev0, void* ev1) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ev0 != nullptr) cudaEventRecord(static_cast<cudaEvent_t>(ev0), st);
  if (n > 0) {
    const unsigned grid = static_cast<unsigned>((n + LANES - 1) / LANES);
    sha512_keyed_kernel<<<grid, SPLIT, 0, st>>>(
        static_cast<const uint8_t*>(buf), ld, bucket, nblocks, static_cast<uint8_t*>(out), n);
  }
  const int rc = static_cast<int>(cudaGetLastError());
  if (ev1 != nullptr) cudaEventRecord(static_cast<cudaEvent_t>(ev1), st);
  return rc;
}

#else  // a host C++ compiler: sha512_keyed's per-lane body on the CPU

// Host check of the kernel source: the same arguments on host memory,
// 32 lanes at a time as the kernel's two warps take them: the stage
// copied as the schedule warp copies it, then each lane's words, its
// schedule 16 words at a time and the rounds on them, block by block
// (the same helpers; the warps' barriers have no host counterpart).
extern "C" int sha512_keyed_host(const void* buf, int64_t ld, int bucket, int nblocks,
                                 void* out, int64_t n) {
  const uint8_t* rows = static_cast<const uint8_t*>(buf);
  static thread_local uint8_t stage[SROWS * LANES];
  for (int64_t lane0 = 0; lane0 < n; lane0 += LANES) {
    for (int tid = 0; tid < LANES; ++tid) stage_block(stage, rows, ld, bucket, lane0, n, 0, tid);
    KeyedLane s[LANES];
    int blocks = 0;
    for (int tid = 0; tid < LANES; ++tid) {
      s[tid] = keyed_begin(stage, tid, bucket, nblocks);
      if (lane0 + tid >= n) s[tid].used = 0;
      blocks = s[tid].used > blocks ? s[tid].used : blocks;
    }
    for (int blk = 0; blk < blocks; ++blk) {
      for (int tid = 0; tid < LANES; ++tid) {
        if (blk >= s[tid].used) continue;
        uint64_t w[16];
        keyed_words(s[tid], stage, tid, blk, w);
        compress(s[tid].st, w);
      }
      if (blk + 1 < blocks) {
        for (int tid = 0; tid < LANES; ++tid)
          stage_block(stage, rows, ld, bucket, lane0, n, blk + 1, tid);
      }
    }
    for (int tid = 0; tid < LANES && lane0 + tid < n; ++tid)
      store_digest(s[tid].st, static_cast<uint8_t*>(out) + lane0 + tid, n);
  }
  return 0;
}

#endif
