// GF(2^255-19) multiply and square on 26 x 10-bit int32 lazy limbs.
//
// Replaces the Pallas kernel cometbft_tpu/ops/field.py:338
// `_pallas_elementwise` (pl.pallas_call at :366), built there twice: as
// the multiply (`_mul_rows`, :311) and as the square (`_square_rows`,
// :322).  The output is the reference's lazy limbs bit for bit, not only
// the same value mod p: 51 schoolbook columns, two shift-only relax
// passes over the 27 high rows (`_fold_high_rows`, :285), the fold x608
// (row 26 x608^2), then four relax passes (`_relax_rows`, :301).
//
// Layout: limbs-first (26, n) int32, lane-contiguous.  One thread per
// lane holds its 26 limbs and 51 columns in registers; limb i of
// neighbouring threads is neighbouring words, so every load and store
// is coalesced.  No shared memory: lanes never talk to each other.
//
// Bound on the H100: the multiply needs about 1.2k int32 instructions
// per lane (676 multiply-adds, ~500 for the fold and relax) against
// 312 bytes moved.  At the published peaks (3.35 TB/s; 132 SMs x 64
// int32 lanes x 1.98 GHz, about 16.7 T operations/s) that is 71 fs of
// operations against 93 fs of bytes per lane: a lone multiply is bound
// by bytes, narrowly, and a square repeated twice or more by
// operations.  At the main path's 256 lanes either bound is ~20 ns, far
// below the cost of a launch, so the design answer is fewer launches:
// every intermediate stays in registers (HBM sees only operands and
// result), and the square repeats in registers: fe_sq(a, reps) computes
// a^(2^reps) in one launch, so the 251 squarings of pow22523 take 11
// launches, not 251.
//
// The arithmetic is field.cuh's register level (mul_regs, sq_regs; the
// integer semantics are described there), which the fused keyed verify
// (verify_keyed.cu) shares.  No path launches these two kernels: the
// table build is its own kernel (build_tables.cu).  They serve the plain
// versions of the fused kernels on a CUDA tensor.

#include <cstdint>
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

using fe::NL;
constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
fe_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
              int32_t* __restrict__ out, int64_t n) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (lane >= n) return;
  uint32_t x[NL], y[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    x[i] = static_cast<uint32_t>(a[i * n + lane]);
    y[i] = static_cast<uint32_t>(b[i * n + lane]);
  }
  uint32_t r[NL];
  fe::mul_regs(x, y, r);
#pragma unroll
  for (int i = 0; i < NL; ++i) out[i * n + lane] = static_cast<int32_t>(r[i]);
}

__global__ void __launch_bounds__(THREADS)
fe_sq_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out,
             int64_t n, int reps) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (lane >= n) return;
  uint32_t x[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) x[i] = static_cast<uint32_t>(a[i * n + lane]);
  for (int rep = 0; rep < reps; ++rep) fe::sq_regs(x);
#pragma unroll
  for (int i = 0; i < NL; ++i) out[i * n + lane] = static_cast<int32_t>(x[i]);
}

inline unsigned grid_for(int64_t n) {
  return static_cast<unsigned>((n + THREADS - 1) / THREADS);
}

}  // namespace

// C interface, loaded with ctypes.  Each launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 on success).
extern "C" int fe_mul_launch(const void* a, const void* b, void* out,
                             int64_t n, void* stream) {
  if (n > 0) {
    fe_mul_kernel<<<grid_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
        static_cast<int32_t*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fe_sq_launch(const void* a, void* out, int64_t n, int reps,
                            void* stream) {
  if (n > 0) {
    fe_sq_kernel<<<grid_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(a), static_cast<int32_t*>(out), n, reps);
  }
  return static_cast<int>(cudaGetLastError());
}
