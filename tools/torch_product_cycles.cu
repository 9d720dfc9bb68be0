// Cycles per GF(2^255-19) product of the verify kernels' group-level
// multiply (cometbft_tpu_torch/csrc/field.cuh, fe::mul<G>) on one warp,
// of the register-level product one thread per lane, and per point
// formula of a lane on Q quarters of G threads (csrc/point.cuh's Team and
// four-way formulas), on an NVIDIA GPU.  Built and run by
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
  return bad;
}
