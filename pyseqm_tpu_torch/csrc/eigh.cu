// Batched symmetric eigensolver by one-sided (Hestenes) Jacobi, one thread
// block per molecule.
//
// Replaces the TPU kernel pyseqm_tpu/ops/eigh_pallas.py::_eigh_kernel and
// computes what it computes (not its 128-lane panel layout).  The input is
// the shifted and reflected matrix G0 = sigma I - A (n x n, n a power of two
// <= 128, built by the wrapper); column j of G is owned by thread j.  In
// round d = 1 .. n-1 of a sweep, column j rotates against column j ^ d
// (every pair meets once per sweep):
//
//   alpha = <g_j, g_j>,  gamma = <g_j, g_{j^d}>,  beta = alpha_{j^d}
//   off   = max(off, gamma^2 / (alpha beta))              (0 if alpha beta = 0)
//   rotate when gamma^2 > rot_tol * max(alpha beta, 1e-30)
//   zeta  = (beta - alpha) / (2 gamma)                     (gamma -> 1 if not)
//   t     = sign(zeta) / (|zeta| + sqrt(1 + zeta^2)),  0 if not rotating
//   c     = 1 / sqrt(1 + t^2),  s = t c
//   g_j  <- c g_j - s g_{j^d}
//
// Both members of a pair read the pre-round columns, so G is double-
// buffered in shared memory and the round writes the other buffer.  Sweeps
// repeat while the block's max `off` over the last sweep exceeds off_tol
// and fewer than max_sweeps have run; each molecule leaves on its own (the
// TPU program ran every molecule of a grid step to the slowest one, and
// extra sweeps change a converged molecule only at rounding level).
// Outputs: the final G, its column norms, the last sweep's max `off` (the
// convergence residual) and, when asked, the number of sweeps.
//
// The column sums are sequential FP32 FMA chains over i; the rotation and
// the update use explicitly rounded operations (__fmul_rn, __fadd_rn, ...)
// so the compiler cannot contract them into FMAs.  The plain PyTorch
// version repeats exactly these operations, so the two agree bit for bit
// up to rare double-rounding ties in its emulation of the FMA.
//
// What bounds it on an H100: per sweep a molecule needs (n - 1) rounds of
// ~6 n^2 FP32 operations (per pair one gamma, two alphas and two column
// updates; both members of a pair compute the same gamma and rotation
// here, ~7 n^2 issued), about 25 kFLOP per sweep at n = 16 and 0.2 MFLOP
// at n = 32, against 2 n^2 * 4 bytes moved once: the FP32 rate bounds it,
// and at these sizes latency does first (a round is a dependent chain of
// n FMAs plus two barriers).
// The simple design keeps G in shared memory (2 n^2 floats: 2 KB at
// n = 16, 128 KB at n = 128, requested as dynamic shared memory), one
// thread per column with max(n, 32) threads, and a per-molecule exit.
// One warp per molecule with __shfl_xor_sync for n <= 32 (the XOR pair
// order maps onto it exactly) and several molecules per block are later
// work.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 128;

// max that propagates NaN, as torch.maximum and jnp.maximum do
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

// Max of v over the block (blockDim.x a multiple of 32), returned to every
// thread.
__device__ float block_max(float v, float* scratch) {
  for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  __syncthreads();  // scratch may still be read from the previous call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float m = scratch[0];
  for (int w = 1; w < warps; ++w) m = nan_max(m, scratch[w]);
  return m;
}

__global__ void __launch_bounds__(kMaxN)
eigh_kernel(const float* __restrict__ g0, float* __restrict__ g_out,
            float* __restrict__ nrm_out, float* __restrict__ resid_out,
            int* __restrict__ sweeps_out, int n, float off_tol, float rot_tol,
            int max_sweeps) {
  extern __shared__ float smem[];
  const int nn = n * n;
  float* cur = smem;
  float* nxt = smem + nn;
  float* alpha_s = smem + 2 * nn;
  float* scratch = alpha_s + n;
  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const bool owns = j < n;

  const float* src = g0 + static_cast<long long>(b) * nn;
  for (int e = threadIdx.x; e < nn; e += blockDim.x) cur[e] = src[e];
  __syncthreads();

  float off_max = 1.0f;
  int sweep = 0;
  while (off_max > off_tol && sweep < max_sweeps) {
    float off = 0.0f;
    for (int d = 1; d < n; ++d) {
      const int p = j ^ d;
      float alpha = 0.0f, gamma = 0.0f;
      if (owns) {
        for (int i = 0; i < n; ++i) {
          const float x = cur[i * n + j];
          alpha = fmaf(x, x, alpha);
          gamma = fmaf(x, cur[i * n + p], gamma);
        }
        alpha_s[j] = alpha;
      }
      __syncthreads();
      if (owns) {
        const float beta = alpha_s[p];
        const float denom = __fmul_rn(alpha, beta);
        const float dmax = nan_max(denom, 1.0e-30f);
        const float g2 = __fmul_rn(gamma, gamma);
        off = nan_max(off, denom > 0.0f ? __fdiv_rn(g2, dmax) : 0.0f);
        const bool rotate = g2 > __fmul_rn(rot_tol, dmax);
        const float zeta = __fdiv_rn(__fsub_rn(beta, alpha),
                                     __fmul_rn(2.0f, rotate ? gamma : 1.0f));
        const float sgn = static_cast<float>((zeta > 0.0f) - (zeta < 0.0f));
        float t = __fdiv_rn(sgn, __fadd_rn(fabsf(zeta),
                                           __fsqrt_rn(__fadd_rn(1.0f, __fmul_rn(zeta, zeta)))));
        if (!rotate) t = 0.0f;
        const float c = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(1.0f, __fmul_rn(t, t))));
        const float s = __fmul_rn(t, c);
        for (int i = 0; i < n; ++i) {
          nxt[i * n + j] = __fsub_rn(__fmul_rn(c, cur[i * n + j]),
                                     __fmul_rn(s, cur[i * n + p]));
        }
      }
      __syncthreads();
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    off_max = block_max(off, scratch);
    ++sweep;
  }

  if (owns) {
    float* dst = g_out + static_cast<long long>(b) * nn;
    float a = 0.0f;
    for (int i = 0; i < n; ++i) {
      const float x = cur[i * n + j];
      a = fmaf(x, x, a);
      dst[i * n + j] = x;
    }
    nrm_out[static_cast<long long>(b) * n + j] = __fsqrt_rn(a);
  }
  if (threadIdx.x == 0) {
    resid_out[b] = off_max;
    if (sweeps_out != nullptr) sweeps_out[b] = sweep;
  }
}

}  // namespace

// g0, g: (B, n, n) float32 contiguous; nrm: (B, n) float32; resid: (B,)
// float32; sweeps: (B,) int32 or null.  n a power of two <= 128.  Launches
// on `stream` and returns cudaGetLastError() (or the error that refused the
// launch).
extern "C" int eigh_jacobi_f32(const float* g0, float* g, float* nrm,
                               float* resid, int* sweeps, int B, int n,
                               float off_tol, float rot_tol, int max_sweeps,
                               void* stream) {
  if (n < 1 || n > kMaxN || (n & (n - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = n < 32 ? 32 : n;
  const size_t smem =
      (2 * static_cast<size_t>(n) * n + n + threads / 32) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      eigh_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B > 0) {
    eigh_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        g0, g, nrm, resid, sweeps, n, off_tol, rot_tol, max_sweeps);
  }
  return static_cast<int>(cudaGetLastError());
}
