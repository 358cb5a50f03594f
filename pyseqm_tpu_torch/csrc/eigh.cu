// Batched symmetric eigensolver by one-sided (Hestenes) Jacobi: one launch
// per call, from A to the sorted eigenpairs.
//
// Replaces the TPU kernel pyseqm_tpu/ops/eigh_pallas.py::_eigh_kernel and
// computes what it computes (not its 128-lane panel layout), together with
// the shift, padding, sort and normalisation that surround it there.  For
// each molecule b, A (n0 x n0, symmetric) is padded to the power of two
// n <= 128:
//
//   prologue  row sums r_j = sum_i |a_ij| - |a_jj|, read in order i = 0..
//             n0-1 down column j; h1 = min_j (a_jj - r_j), hN = max_j
//             (a_jj + r_j); sigma = hN + 0.05 max(hN - h1, 1) (Gershgorin);
//             G0 = sigma I - A on the n0 x n0 block, 0 on the padding (the
//             padding diagonal of A at sigma);
//   sweeps    in round d = 1 .. n-1 of a sweep, column j of G rotates
//             against column j ^ d (every pair meets once per sweep):
//               alpha = <g_j, g_j>,  gamma = <g_j, g_{j^d}>,  beta = alpha_{j^d}
//               off   = max(off, gamma^2 / (alpha beta))      (0 if alpha beta = 0)
//               rotate when gamma^2 > rot_tol * max(alpha beta, 1e-30)
//               zeta  = (beta - alpha) / (2 gamma)             (gamma -> 1 if not)
//               t     = sign(zeta) / (|zeta| + sqrt(1 + zeta^2)),  0 if not rotating
//               c     = 1 / sqrt(1 + t^2),  s = t c
//               g_j  <- c g_j - s g_{j^d}
//             while the molecule's max `off` over the last sweep exceeds
//             off_tol and fewer than max_sweeps have run (each molecule
//             leaves on its own);
//   epilogue  e_j = sigma - |g_j|; column j goes to position rank_j =
//             #{k : e_k < e_j, or e_k = e_j and k < j} (ascending, ties by
//             index, NaN last: torch.argsort(stable=True)'s order; padding
//             columns have |g| = 0 and land last); the kernel writes e
//             (B, n0), v = g_j / max(|g_j|, 1e-20) (B, n0, n0), the last
//             sweep's max `off` (the residual) and, when asked, the sweeps.
//
// The column sums are sequential FP32 FMA chains over i; the shift, the
// rotation, the update and the normalisation use explicitly rounded
// operations (__fmul_rn, __fadd_rn, ...) so that the compiler cannot
// contract them into FMAs.  The plain PyTorch version repeats exactly these
// operations, so the two agree bit for bit up to rare double-rounding ties
// in its emulation of the FMA.
//
// What bounds it on an H100: per sweep a molecule needs (n - 1) rounds of
// ~6 n^2 FP32 operations (per pair one gamma, two alphas, two column
// updates), ~25 kFLOP per sweep at n = 16 and 0.2 MFLOP at n = 32, against
// ~2 n^2 * 4 bytes moved once: the FP32 rate bounds it.  What keeps it
// from that rate is instruction throughput and latency: a round is a
// dependent chain of n FMAs, and at n = 16 its IEEE divisions and square
// roots are most of its instructions.
//
// Two variants:
//   * n <= 32, the warp kernel (template on n): one molecule per group of
//     n lanes (32/n molecules per warp, 128 threads per block); lane j
//     holds column j of G in registers and receives the partner column by
//     __shfl_xor_sync with the group's mask (the XOR pair order maps onto
//     the shuffle exactly).  No shared memory and no block barrier; the
//     group's max `off`, min h1 and max hN are shuffle reductions, and the
//     rank reads every e_k by shuffle.  A molecule that has converged
//     leaves its loop and idles while its warp-mates sweep on.  Both
//     members of a pair compute the same gamma and rotation.  The partner
//     column stays in registers for the update (n more per lane): shuffling
//     it again there, or capping the registers, ran slower on an H100.
//   * n = 64 and 128, the block kernel: one block of n threads per
//     molecule, G double-buffered in shared memory (both members of a pair
//     read the pre-round columns; 2 n^2 floats, 128 KB at n = 128), two
//     barriers per round, the same prologue and epilogue as device
//     functions with block reductions.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 128;
constexpr int kWarpKernelThreads = 128;

// max and min that propagate NaN, as torch.maximum / amax / clamp do
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (b < a || b != b) ? b : a;
}

// Gershgorin ends of row j (column j read in order; A symmetric):
// lo = a_jj - r_j, hi = a_jj + r_j.
__device__ __forceinline__ void gershgorin_row(const float* a, int n0, int j,
                                               float& lo, float& hi) {
  float s = 0.0f;
  for (int i = 0; i < n0; ++i) s = __fadd_rn(s, fabsf(a[i * n0 + j]));
  const float ajj = a[j * n0 + j];
  const float r = __fsub_rn(s, fabsf(ajj));
  lo = __fsub_rn(ajj, r);
  hi = __fadd_rn(ajj, r);
}

__device__ __forceinline__ float shift_from(float h1, float hN) {
  const float spread = nan_max(__fsub_rn(hN, h1), 1.0f);
  return __fadd_rn(hN, __fmul_rn(0.05f, spread));
}

// G0[i, j] = sigma I - A on the n0 x n0 block, 0 on the padding
__device__ __forceinline__ float g0_entry(const float* a, int n0, int i, int j,
                                          float sigma) {
  if (i >= n0 || j >= n0) return 0.0f;
  return __fsub_rn(__fmul_rn(i == j ? 1.0f : 0.0f, sigma), a[i * n0 + j]);
}

// Folds the pair's relative off-diagonal into `off` and returns the
// rotation (c, s) of column j against its partner.
__device__ __forceinline__ void rotation(float alpha, float beta, float gamma,
                                         float rot_tol, float& off, float& c,
                                         float& s) {
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
  c = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(1.0f, __fmul_rn(t, t))));
  s = __fmul_rn(t, c);
}

// Whether column k sorts before column j: ascending e, ties by index, NaN
// last.
__device__ __forceinline__ int sorts_before(float ek, int k, float ej, int j) {
  const bool nk = ek != ek, nj = ej != ej;
  if (nk || nj) return !nk || (nj && k < j);
  return ek < ej || (ek == ej && k < j);
}

__device__ __forceinline__ float normaliser(float nrm) {
  return nan_max(nrm, 1.0e-20f);
}

// ---------------------------------------------------------------- n <= 32

template <int N>
__device__ __forceinline__ float group_max(float v, unsigned mask) {
#pragma unroll
  for (int o = N / 2; o > 0; o >>= 1) v = nan_max(v, __shfl_xor_sync(mask, v, o, N));
  return v;
}

template <int N>
__device__ __forceinline__ float group_min(float v, unsigned mask) {
#pragma unroll
  for (int o = N / 2; o > 0; o >>= 1) v = nan_min(v, __shfl_xor_sync(mask, v, o, N));
  return v;
}

template <int N>
__global__ void __launch_bounds__(kWarpKernelThreads)
eigh_warp_kernel(const float* __restrict__ A, float* __restrict__ e_out,
                 float* __restrict__ v_out, float* __restrict__ resid_out,
                 int* __restrict__ sweeps_out, int B, int n0, float off_tol,
                 float rot_tol, int max_sweeps) {
  const int lane = threadIdx.x & 31;
  const int j = lane & (N - 1);
  const long long b =
      (static_cast<long long>(blockIdx.x) * kWarpKernelThreads + threadIdx.x) / N;
  if (b >= B) return;  // the whole group leaves together
  const unsigned mask =
      N == 32 ? 0xffffffffu : (((1u << (N & 31)) - 1u) << (lane & ~(N - 1)));
  const long long nn0 = static_cast<long long>(n0) * n0;
  const float* a = A + b * nn0;

  float lo = __int_as_float(0x7f800000), hi = -lo;  // +inf, -inf
  if (j < n0) gershgorin_row(a, n0, j, lo, hi);
  const float sigma = shift_from(group_min<N>(lo, mask), group_max<N>(hi, mask));

  float g[N];
#pragma unroll
  for (int i = 0; i < N; ++i) g[i] = g0_entry(a, n0, i, j, sigma);

  float off_max = 1.0f;
  int sweep = 0;
  while (off_max > off_tol && sweep < max_sweeps) {
    float off = 0.0f;
    for (int d = 1; d < N; ++d) {
      float gp[N];
      float alpha = 0.0f, gamma = 0.0f;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        gp[i] = __shfl_xor_sync(mask, g[i], d, N);
        alpha = fmaf(g[i], g[i], alpha);
        gamma = fmaf(g[i], gp[i], gamma);
      }
      const float beta = __shfl_xor_sync(mask, alpha, d, N);
      float c, s;
      rotation(alpha, beta, gamma, rot_tol, off, c, s);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        g[i] = __fsub_rn(__fmul_rn(c, g[i]), __fmul_rn(s, gp[i]));
      }
    }
    off_max = group_max<N>(off, mask);
    ++sweep;
  }

  float a2 = 0.0f;
#pragma unroll
  for (int i = 0; i < N; ++i) a2 = fmaf(g[i], g[i], a2);
  const float nrm = __fsqrt_rn(a2);
  const float ej = __fsub_rn(sigma, nrm);
  int rank = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    rank += sorts_before(__shfl_sync(mask, ej, k, N), k, ej, j);
  }
  if (rank < n0) {
    e_out[b * n0 + rank] = ej;
    const float q = normaliser(nrm);
    float* vb = v_out + b * nn0;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (i < n0) vb[i * n0 + rank] = __fdiv_rn(g[i], q);
    }
  }
  if (j == 0) {
    resid_out[b] = off_max;
    if (sweeps_out != nullptr) sweeps_out[b] = sweep;
  }
}

// ------------------------------------------------------------ n = 64, 128

// Reduction of v over the block (blockDim.x a multiple of 32) with op,
// returned to every thread.
template <typename Op>
__device__ float block_reduce(float v, float* scratch, Op op) {
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  __syncthreads();  // scratch may still be read from the previous call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float m = scratch[0];
  for (int w = 1; w < warps; ++w) m = op(m, scratch[w]);
  return m;
}

struct MaxOp {
  __device__ float operator()(float a, float b) const { return nan_max(a, b); }
};
struct MinOp {
  __device__ float operator()(float a, float b) const { return nan_min(a, b); }
};

__global__ void __launch_bounds__(kMaxN)
eigh_block_kernel(const float* __restrict__ A, float* __restrict__ e_out,
                  float* __restrict__ v_out, float* __restrict__ resid_out,
                  int* __restrict__ sweeps_out, int n0, int n, float off_tol,
                  float rot_tol, int max_sweeps) {
  extern __shared__ float smem[];
  const int nn = n * n;
  float* cur = smem;
  float* nxt = smem + nn;
  float* alpha_s = smem + 2 * nn;  // also e_j in the epilogue
  float* scratch = alpha_s + n;
  const long long b = blockIdx.x;
  const int j = threadIdx.x;  // blockDim.x == n
  const long long nn0 = static_cast<long long>(n0) * n0;
  const float* a = A + b * nn0;

  float lo = __int_as_float(0x7f800000), hi = -lo;
  if (j < n0) gershgorin_row(a, n0, j, lo, hi);
  const float h1 = block_reduce(lo, scratch, MinOp());
  const float sigma = shift_from(h1, block_reduce(hi, scratch, MaxOp()));
  for (int i = 0; i < n; ++i) cur[i * n + j] = g0_entry(a, n0, i, j, sigma);
  __syncthreads();

  float off_max = 1.0f;
  int sweep = 0;
  while (off_max > off_tol && sweep < max_sweeps) {
    float off = 0.0f;
    for (int d = 1; d < n; ++d) {
      const int p = j ^ d;
      float alpha = 0.0f, gamma = 0.0f;
      for (int i = 0; i < n; ++i) {
        const float x = cur[i * n + j];
        alpha = fmaf(x, x, alpha);
        gamma = fmaf(x, cur[i * n + p], gamma);
      }
      alpha_s[j] = alpha;
      __syncthreads();
      float c, s;
      rotation(alpha, alpha_s[p], gamma, rot_tol, off, c, s);
      for (int i = 0; i < n; ++i) {
        nxt[i * n + j] = __fsub_rn(__fmul_rn(c, cur[i * n + j]),
                                   __fmul_rn(s, cur[i * n + p]));
      }
      __syncthreads();
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    off_max = block_reduce(off, scratch, MaxOp());
    ++sweep;
  }

  float a2 = 0.0f;
  for (int i = 0; i < n; ++i) a2 = fmaf(cur[i * n + j], cur[i * n + j], a2);
  const float nrm = __fsqrt_rn(a2);
  const float ej = __fsub_rn(sigma, nrm);
  alpha_s[j] = ej;  // the last round's alpha_s reads ended at its barrier
  __syncthreads();
  int rank = 0;
  for (int k = 0; k < n; ++k) rank += sorts_before(alpha_s[k], k, ej, j);
  if (rank < n0) {
    e_out[b * n0 + rank] = ej;
    const float q = normaliser(nrm);
    float* vb = v_out + b * nn0;
    for (int i = 0; i < n0; ++i) vb[i * n0 + rank] = __fdiv_rn(cur[i * n + j], q);
  }
  if (j == 0) {
    resid_out[b] = off_max;
    if (sweeps_out != nullptr) sweeps_out[b] = sweep;
  }
}

template <int N>
cudaError_t launch_warp(const float* A, float* e, float* v, float* resid,
                        int* sweeps, int B, int n0, float off_tol,
                        float rot_tol, int max_sweeps, cudaStream_t stream) {
  constexpr int per_block = kWarpKernelThreads / N;
  const int blocks = (B + per_block - 1) / per_block;
  eigh_warp_kernel<N><<<blocks, kWarpKernelThreads, 0, stream>>>(
      A, e, v, resid, sweeps, B, n0, off_tol, rot_tol, max_sweeps);
  return cudaGetLastError();
}

}  // namespace

// A: (B, n0, n0) float32 contiguous, n0 <= 128; e: (B, n0) float32;
// v: (B, n0, n0) float32; resid: (B,) float32; sweeps: (B,) int32 or
// null.  One launch on `stream`: the warp kernel for n0 <= 32, the block
// kernel for 32 < n0 <= 128.  Returns cudaGetLastError() (or the error
// that refused the launch).
extern "C" int eigh_jacobi_f32(const float* A, float* e, float* v,
                               float* resid, int* sweeps, int B, int n0,
                               float off_tol, float rot_tol, int max_sweeps,
                               void* stream) {
  if (n0 < 1 || n0 > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  int n = 1;
  while (n < n0) n <<= 1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err;
  switch (n) {
    case 1: err = launch_warp<1>(A, e, v, resid, sweeps, B, n0, off_tol, rot_tol, max_sweeps, st); break;
    case 2: err = launch_warp<2>(A, e, v, resid, sweeps, B, n0, off_tol, rot_tol, max_sweeps, st); break;
    case 4: err = launch_warp<4>(A, e, v, resid, sweeps, B, n0, off_tol, rot_tol, max_sweeps, st); break;
    case 8: err = launch_warp<8>(A, e, v, resid, sweeps, B, n0, off_tol, rot_tol, max_sweeps, st); break;
    case 16: err = launch_warp<16>(A, e, v, resid, sweeps, B, n0, off_tol, rot_tol, max_sweeps, st); break;
    case 32: err = launch_warp<32>(A, e, v, resid, sweeps, B, n0, off_tol, rot_tol, max_sweeps, st); break;
    default: {
      const size_t smem =
          (2 * static_cast<size_t>(n) * n + n + n / 32) * sizeof(float);
      err = cudaFuncSetAttribute(eigh_block_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      eigh_block_kernel<<<B, n, smem, st>>>(A, e, v, resid, sweeps, n0, n,
                                            off_tol, rot_tol, max_sweeps);
      err = cudaGetLastError();
    }
  }
  return static_cast<int>(err);
}
