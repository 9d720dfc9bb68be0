// Cycles per GF(2^255-19) product of the verify kernels' group-level
// multiply (cometbft_tpu_torch/csrc/field.cuh, fe::mul<G>) on one warp,
// of the register-level product one thread per lane, per point formula
// of a lane on Q quarters of G threads (csrc/point.cuh's Team and
// four-way formulas), and of sha512_keyed's two-block chain for a lone
// warp (csrc/sha512.cu), on an NVIDIA GPU.  Built and run by
// tools/torch_product_cycles.py.
//
// One block of one warp runs `kReps` dependent products on operands in
// shared memory (as the fused kernels' lanes do) and reads the SM clock
// around them: the latency of one product on an otherwise idle SM
// partition, which is what a lane's chain of products pays when there
// are few lanes.  The formula timings are the same for a step of a
// lane's chain: a doubling is two steps at Q = 4, an addition three.

#include <cstdio>
#include <cuda_runtime.h>

#include "../cometbft_tpu_torch/csrc/field.cuh"
#include "../cometbft_tpu_torch/csrc/point.cuh"
#include "../cometbft_tpu_torch/csrc/sha512.cu"

namespace {

constexpr int kReps = 2000;
// A lane's operands, padded as the kernel pads its lanes (lane_words in
// verify_keyed.cu): G (mod 32), so one warp's groups hit distinct banks.
template <int G>
__host__ __device__ constexpr int lane_words() {
  return 104 + ((G % 32) - 104 % 32 + 32) % 32;
}

template <int G>
__global__ void group_products(long long* cycles) {
  extern __shared__ int32_t smem[];
  const int sub = threadIdx.x / G;
  int32_t* lane = smem + sub * lane_words<G>();
  fe::Grp<G> g;
  g.rank = threadIdx.x % G;
  g.mask = (G == 32 ? 0xffffffffu : (1u << (G % 32)) - 1u) << (threadIdx.x & 31 & ~(G - 1));
  for (int i = g.rank; i < 104; i += G) lane[i] = (i * 37) & 1023;
  g.sync();
  const long long t0 = clock64();
  for (int i = 0; i < kReps; ++i) fe::mul(g, lane + 26 * (i & 1), lane, lane + 52);
  const long long t1 = clock64();
  if (threadIdx.x == 0) *cycles = t1 - t0;
}

// One thread per lane, limbs strided over the warp's threads in shared
// memory (the previous design's layout), fe::mul_regs.
__global__ void thread_products(long long* cycles) {
  extern __shared__ int32_t smem[];
  int32_t* lane = smem + threadIdx.x;
  for (int i = 0; i < 104; ++i) lane[i * 32] = (i * 37) & 1023;
  const long long t0 = clock64();
  for (int i = 0; i < kReps; ++i) {
    uint32_t x[fe::NL], y[fe::NL];
    for (int k = 0; k < fe::NL; ++k) x[k] = lane[k * 32], y[k] = lane[(52 + k) * 32];
    fe::mul_regs(x, y, x);
    for (int k = 0; k < fe::NL; ++k) lane[(26 * (i & 1) + k) * 32] = x[k];
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0) *cycles = t1 - t0;
}

// One lane of the generic kernel's layout on Q quarters of G threads
// (point.cuh's Team), alone on the card: cycles per point doubling, per
// point addition and per lane barrier, each over kFormulas in a row --
// the latency of a step of the lane's chain.  Q = 0 runs the one-group
// formulas (pt_double, pt_add) that the keyed kernel uses, on G threads.
constexpr int kFormulas = 200;

template <int Q, int G>
__global__ void formula_cycles(long long* cycles) {
  constexpr int QQ = Q == 0 ? 1 : Q;
  extern __shared__ int32_t smem[];
  pt::Consts& kc = *reinterpret_cast<pt::Consts*>(smem);
  pt::fill_consts(kc, threadIdx.x, blockDim.x);
  auto* L = reinterpret_cast<pt::Lane<pt::NSLOTS>*>(smem + pt::NCONST * fe::NL);
  pt::Team<QQ, G> t;
  t.tid = threadIdx.x;
  t.q = threadIdx.x / G;
  t.g.rank = threadIdx.x % G;
  t.g.mask = (G == 32 ? 0xffffffffu : (1u << (G % 32)) - 1u) << (threadIdx.x & 31 & ~(G - 1));
  t.mask = (QQ * G >= 32 ? 0xffffffffu : (1u << (QQ * G)) - 1u);
  t.bar = 1;
  for (int i = threadIdx.x; i < pt::NSLOTS * fe::NL; i += blockDim.x)
    L->s[i / fe::NL][i % fe::NL] = (i * 37) & 1023;
  __syncthreads();
  const long long t0 = clock64();
  for (int i = 0; i < kFormulas; ++i) {
    if (Q == 0) pt::pt_double(t.g, L, pt::P1);
    else pt::pt_double_q(t, L, pt::P1);
  }
  const long long t1 = clock64();
  for (int i = 0; i < kFormulas; ++i) {
    const int32_t *x2 = L->s[pt::P2], *y2 = L->s[pt::P2 + 1], *z2 = L->s[pt::P2 + 2],
                  *t2 = L->s[pt::P2 + 3];
    if (Q == 0) pt::pt_add(t.g, L, kc, pt::P1, x2, y2, z2, t2);
    else pt::pt_add_q(t, L, kc, pt::P1, x2, y2, z2, t2);
  }
  const long long t2 = clock64();
  for (int i = 0; i < kFormulas; ++i) t.sync();
  const long long t3 = clock64();
  // a limb-parallel step of four inputs and four outputs, then the barrier
  int32_t *a = L->s[pt::T0], *b = L->s[pt::T1], *c = L->s[pt::T2], *d = L->s[pt::T3];
  for (int i = 0; i < kFormulas; ++i) {
    pt::limbs(t, [&](int k) {
      const int32_t ak = a[k], bk = b[k], ck = c[k], dk = d[k];
      a[k] = pt::sub32(bk, ak), b[k] = pt::sub32(dk, ck), c[k] = pt::add32(dk, ck);
      d[k] = pt::add32(bk, ak);
    });
  }
  const long long t4 = clock64();
  if (threadIdx.x == 0)
    cycles[0] = t1 - t0, cycles[1] = t2 - t1, cycles[2] = t3 - t2, cycles[3] = t4 - t3;
}

template <int Q, int G>
int report_formulas() {
  constexpr int threads = (Q == 0 ? 1 : Q) * G;  // the lane alone
  constexpr int smem = 4 * (pt::NCONST * fe::NL) + sizeof(pt::Lane<pt::NSLOTS>);
  long long* d = nullptr;
  long long h[4] = {};
  if (cudaMalloc(&d, sizeof(h)) != cudaSuccess) return 1;
  for (int run = 0; run < 2; ++run) formula_cycles<Q, G><<<1, threads, smem>>>(d);
  if (cudaDeviceSynchronize() != cudaSuccess || cudaGetLastError() != cudaSuccess) return 1;
  cudaMemcpy(h, d, sizeof(h), cudaMemcpyDeviceToHost);
  cudaFree(d);
  char name[64];
  if (Q == 0) snprintf(name, sizeof(name), "one group of G = %d (keyed formulas)", G);
  else snprintf(name, sizeof(name), "(Q, G) = (%d, %d)", Q, G);
  printf("%-40s doubling %8.1f, addition %8.1f, lane barrier %6.1f, limb step %6.1f cycles\n",
         name, static_cast<double>(h[0]) / kFormulas, static_cast<double>(h[1]) / kFormulas,
         static_cast<double>(h[2]) / kFormulas, static_cast<double>(h[3]) / kFormulas);
  return 0;
}

template <typename Kernel>
int report(const char* name, Kernel kernel, int smem_bytes) {
  long long* d = nullptr;
  long long h = 0;
  if (cudaMalloc(&d, sizeof(long long)) != cudaSuccess) return 1;
  for (int run = 0; run < 2; ++run) kernel<<<1, 32, smem_bytes>>>(d);  // the first warms up
  if (cudaDeviceSynchronize() != cudaSuccess || cudaGetLastError() != cudaSuccess) return 1;
  cudaMemcpy(&h, d, sizeof(h), cudaMemcpyDeviceToHost);
  cudaFree(d);
  printf("%-44s %8.1f cycles per product\n", name, static_cast<double>(h) / kReps);
  return 0;
}

// sha512_keyed's latency floor: one warp of 32 lanes alone on the card
// (as at a few hundred lanes, one warp per SM partition), its two
// message blocks staged as the kernel stages them, then the cycles of
// the two blocks' words and compression on one warp, one after the other
// in a loop (two inlined copies of the unrolled compression ran 1.5 times
// slower): the chain a lane on one thread cannot beat.  report_sha also
// times the kernel itself (its schedule warp ahead of its rounds warp)
// for one block of 32 lanes alone.
__global__ void sha_chain(const uint8_t* buf, int64_t ld, int bucket, int nblocks,
                          long long* cycles, uint8_t* out) {
  __shared__ __align__(16) uint8_t stage[2][SROWS * LANES];
  const int tid = threadIdx.x;
  stage_block(stage[0], buf, ld, bucket, 0, LANES, 0, tid);
  stage_block(stage[1], buf, ld, bucket, 0, LANES, 1, tid);
  copy_wait();
  __syncwarp();
  KeyedLane s = keyed_begin(stage[0], tid, bucket, nblocks);
  __syncwarp();
  const long long t0 = clock64();
#pragma unroll 1
  for (int blk = 0; blk < s.used; ++blk) {
    uint64_t w[16];
    keyed_words(s, stage[blk & 1], tid, blk, w);
    compress(s.st, w);
  }
  __syncwarp();
  const long long t1 = clock64();
  store_digest(s.st, out + tid, LANES);
  if (tid == 0) cycles[0] = t1 - t0;
}

int report_sha() {
  constexpr int bucket = 128, rows = 104 + bucket;  // the keyed rows of commit150
  uint8_t host[rows * LANES];
  for (int i = 0; i < rows * LANES; ++i) host[i] = static_cast<uint8_t>(i * 131 + 7);
  for (int j = 0; j < LANES; ++j) {  // 120-byte messages: two blocks each
    host[(96 + bucket) * LANES + j] = 120;
    for (int k = 1; k < 4; ++k) host[(96 + bucket + k) * LANES + j] = 0;
  }
  uint8_t *d_buf = nullptr, *d_out = nullptr;
  long long* d_cycles = nullptr;
  long long cycles = 0;
  if (cudaMalloc(&d_buf, sizeof(host)) != cudaSuccess || cudaMalloc(&d_out, 64 * LANES) != cudaSuccess ||
      cudaMalloc(&d_cycles, sizeof(long long)) != cudaSuccess)
    return 1;
  cudaMemcpy(d_buf, host, sizeof(host), cudaMemcpyHostToDevice);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  for (int run = 0; run < 3; ++run) sha_chain<<<1, LANES>>>(d_buf, LANES, bucket, 2, d_cycles, d_out);
  cudaEventRecord(e0);
  for (int run = 0; run < 100; ++run) sha_chain<<<1, LANES>>>(d_buf, LANES, bucket, 2, d_cycles, d_out);
  cudaEventRecord(e1);
  if (cudaDeviceSynchronize() != cudaSuccess || cudaGetLastError() != cudaSuccess) return 1;
  float ms = 0, kms = 0;
  cudaEventElapsedTime(&ms, e0, e1);
  cudaMemcpy(&cycles, d_cycles, sizeof(cycles), cudaMemcpyDeviceToHost);
  for (int run = 0; run < 3; ++run) sha512_keyed_kernel<<<1, SPLIT>>>(d_buf, LANES, bucket, 2, d_out, LANES);
  cudaEventRecord(e0);
  for (int run = 0; run < 100; ++run) sha512_keyed_kernel<<<1, SPLIT>>>(d_buf, LANES, bucket, 2, d_out, LANES);
  cudaEventRecord(e1);
  if (cudaDeviceSynchronize() != cudaSuccess || cudaGetLastError() != cudaSuccess) return 1;
  cudaEventElapsedTime(&kms, e0, e1);
  printf("sha512_keyed, a lone warp: two blocks' words and compression %lld cycles on one "
         "warp; that lone-warp launch (staging included) %.2f us back to back; the kernel "
         "(schedule and rounds on two warps) on 32 lanes alone %.2f us back to back\n",
         cycles, 1e3 * ms / 100, 1e3 * kms / 100);
  cudaFree(d_buf);
  cudaFree(d_out);
  cudaFree(d_cycles);
  return 0;
}

}  // namespace

int main() {
  int bad = 0;
  bad |= report("fe::mul<32> (one lane per warp)", group_products<32>, lane_words<32>() * 4);
  bad |= report("fe::mul<8> (4 lanes per warp)", group_products<8>, 4 * lane_words<8>() * 4);
  bad |= report("fe::mul<1> (32 lanes per warp)", group_products<1>, 32 * lane_words<1>() * 4);
  bad |= report("fe::mul_regs, strided lanes (32 per warp)", thread_products, 32 * 104 * 4);
  // per lane: a doubling is 4 squarings and 4 products (depth 2 on four
  // quarters), an addition 9 products (depth 3)
  bad |= report_formulas<0, 32>();
  bad |= report_formulas<1, 32>();
  bad |= report_formulas<4, 32>();
  bad |= report_formulas<0, 8>();
  bad |= report_formulas<1, 8>();
  bad |= report_formulas<4, 8>();
  bad |= report_formulas<0, 1>();
  bad |= report_formulas<1, 1>();
  bad |= report_formulas<4, 1>();
  bad |= report_sha();
  return bad;
}
