// Cycles per GF(2^255-19) product of the fused keyed verify's group-level
// multiply (cometbft_tpu_torch/csrc/field.cuh, fe::mul<G>) on one warp,
// and of the register-level product one thread per lane, on an NVIDIA
// GPU.  Built and run by tools/torch_product_cycles.py.
//
// One block of one warp runs `kReps` dependent products on operands in
// shared memory (as the fused kernel's lanes do) and reads the SM clock
// around them: the latency of one product on an otherwise idle SM
// partition, which is what a lane's chain of ~800 products pays when
// there are few lanes.

#include <cstdio>
#include <cuda_runtime.h>

#include "../cometbft_tpu_torch/csrc/field.cuh"

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
  return bad;
}
