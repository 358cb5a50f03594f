// SP2 density-matrix purification, one thread block per molecule.
//
// Replaces the TPU kernel pyseqm_tpu/ops/sp2_pallas.py::_sp2_kernel and
// computes what it computes (not its 128-lane panel layout): for each
// molecule b, starting from the pre-scaled iterate X = a0[b] (n x n,
// symmetric, spectrum in [0, 1]),
//
//   repeat up to max_iter times while the molecule is not converged:
//     X2 = X X,  tr2 = tr(X2) = ||X||_F^2
//     take = |tr2 - nocc| < |2 tr - tr2 - nocc|
//     X   = X + s (X2 - X),  s = +1 if take else -1   (X2 or 2X - X2)
//     tr  = take ? tr2 : 2 tr - tr2                   (scalar recurrence)
//     e2, e1, e0 = e1, e0, |tr - nocc|
//     converged when e0 < eps and not e0 < e2
//   then one McWeeny step X = 3 X^2 - 2 X^3, and the output is 2 X.
//
// What bounds it on an H100: at the packed size n = 16 a molecule's X and
// X2 are 2 KB, so the work is ~30 iterations of a 16^3 product per
// molecule, ~4 MFLOP per molecule and ~40 GFLOP for 10,240 molecules: the
// FP32 FMA rate (no tensor cores, no TF32, which would break the SCF's
// f32 fidelity) bounds it, not the 2 x 10 MB of device-memory traffic.
// The simple design keeps X and X2 in shared memory (2 n^2 floats, 128 KB
// at n = 128, requested as dynamic shared memory), gives each thread whole
// output elements of the product, takes tr(X2) as a block reduction, runs
// the trace recurrence uniformly in the block, and lets every block leave
// its loop as soon as its own molecule converges (the TPU program ran to
// its slowest molecule).  Several molecules per block, warp shuffles and
// split-TF32 mma.sync are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Sum of v over the block, returned to every thread.
__device__ float block_sum(float v, float* scratch) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // scratch may still be read from the previous call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float s = 0.0f;
  for (int w = 0; w < kWarps; ++w) s += scratch[w];
  return s;
}

// out[i, j] = sum_k A[i, k] B[k, j] for the block's elements (plain FP32 FMA).
__device__ __forceinline__ float dot_row_col(const float* A, const float* B,
                                             int n, int i, int j) {
  float acc = 0.0f;
  for (int k = 0; k < n; ++k) acc = fmaf(A[i * n + k], B[k * n + j], acc);
  return acc;
}

__global__ void __launch_bounds__(kThreads)
sp2_kernel(const float* __restrict__ a0, const float* __restrict__ nocc,
           float* __restrict__ out, int* __restrict__ iters, int n, float eps,
           int max_iter) {
  extern __shared__ float smem[];
  const int nn = n * n;
  float* X = smem;
  float* X2 = smem + nn;
  float* scratch = smem + 2 * nn;
  const int b = blockIdx.x;
  const float* src = a0 + static_cast<long long>(b) * nn;
  float* dst = out + static_cast<long long>(b) * nn;
  const float occ = nocc[b];

  float diag = 0.0f;
  for (int e = threadIdx.x; e < nn; e += kThreads) {
    const float v = src[e];
    X[e] = v;
    if (e / n == e % n) diag += v;
  }
  float tr = block_sum(diag, scratch);
  float e0 = fabsf(tr - occ), e1 = e0, e2 = e0;

  int it = 0;
  bool active = true;
  while (active && it < max_iter) {
    float frob = 0.0f;
    for (int e = threadIdx.x; e < nn; e += kThreads) {
      X2[e] = dot_row_col(X, X, n, e / n, e % n);
      frob += X[e] * X[e];
    }
    const float tr2 = block_sum(frob, scratch);  // also orders X2 writes
    const bool take = fabsf(tr2 - occ) < fabsf(2.0f * tr - tr2 - occ);
    const float s = take ? 1.0f : -1.0f;
    for (int e = threadIdx.x; e < nn; e += kThreads) X[e] = X[e] + s * (X2[e] - X[e]);
    __syncthreads();
    tr = take ? tr2 : 2.0f * tr - tr2;
    e2 = e1;
    e1 = e0;
    e0 = fabsf(tr - occ);
    ++it;
    if (e0 < eps && !(e0 < e2)) active = false;
  }

  // McWeeny polish: X <- 3 X^2 - 2 X^3, output 2 X
  for (int e = threadIdx.x; e < nn; e += kThreads) X2[e] = dot_row_col(X, X, n, e / n, e % n);
  __syncthreads();
  for (int e = threadIdx.x; e < nn; e += kThreads) {
    const float x3 = dot_row_col(X, X2, n, e / n, e % n);
    dst[e] = 2.0f * (3.0f * X2[e] - 2.0f * x3);
  }
  if (iters != nullptr && threadIdx.x == 0) iters[b] = it;
}

}  // namespace

// a0, out: (B, n, n) float32 contiguous; nocc: (B,) float32; iters: (B,)
// int32 or null.  Launches on `stream` and returns cudaGetLastError().
extern "C" int sp2_purify_f32(const float* a0, const float* nocc, float* out,
                              int* iters, int B, int n, float eps,
                              int max_iter, void* stream) {
  const size_t smem = (2 * static_cast<size_t>(n) * n + kWarps) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      sp2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B > 0) {
    sp2_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        a0, nocc, out, iters, n, eps, max_iter);
  }
  return static_cast<int>(cudaGetLastError());
}
