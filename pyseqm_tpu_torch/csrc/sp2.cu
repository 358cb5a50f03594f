// SP2 density-matrix purification: a molecule per half-warp or warp for
// n <= 32, a thread block per molecule above.
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
// What bounds it on an H100: at the packed size n = 16 the work is ~17
// iterations of a 16^3 product per molecule, ~0.15 MFLOP per molecule and
// ~1.8 GFLOP for 10,240 molecules, against 2 x 10 MB of device memory: the
// FP32 FMA rate bounds it (no tensor cores, no TF32, which would break the
// SCF's f32 fidelity).  What keeps it from that rate is instruction
// throughput (the product's shared-memory loads beside its FMAs).
//
// Two variants:
//   * n <= 32, the warp kernel (template on W = 16 lanes per molecule for
//     n <= 16, 32 for n <= 32; 128 threads per block, no block barrier):
//     lane j owns column j of X (zero beyond n, which leaves every sum
//     exact).  The group's own slice of shared memory holds X^T by rows
//     (row k = column k of X), so column j of X^2 is y_i = sum_k S[k][i]
//     x_k, computed in W registers with FP32 FMA: per row k, W/4 16-byte
//     broadcast loads and W FMAs into W independent chains, the
//     multipliers x_k read from the lane's own row 16 rows at a time.
//     Rows are W + 4 floats apart (16-byte loads and stores of the lanes'
//     own rows land in distinct banks); a molecule has two such buffers
//     (X, and X^2 for the McWeeny step), which also puts the two
//     molecules of a warp's halves 8 banks apart.
//     tr(X^2) = ||X||_F^2 is a shuffle reduction over the group; the
//     choice X^2 or 2X - X^2, the trace recurrence and the exit test run
//     per molecule, so a converged molecule idles while its warp-mate
//     iterates on.  Only __syncwarp with the group's mask orders the slice.
//   * n > 32, the block kernel: X and X2 in shared memory (2 n^2 floats,
//     128 KB at n = 128, dynamic shared memory), each of 256 threads
//     computes whole elements of the product, tr(X2) is a block reduction,
//     the recurrence runs uniformly in the block, and each block leaves as
//     soon as its molecule converges.
// Split-TF32 (3xTF32) mma.sync for the products is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpKernelThreads = 128;
// rows per step of the warp kernel's product loop: 16 was the fastest of
// 4, 8, 16 (W = 16) and of 8, 16, 32 (W = 32) on an H100; all 32 rows at
// once hold the rows' loads in registers (237-255 registers, slower)
constexpr int kRowsPerStep = 16;

// ---------------------------------------------------------------- n <= 32

template <int W>
struct Slice {
  static constexpr int kStride = W + 4;            // floats between rows
  static constexpr int kFloats = W * kStride + 4;  // one W x W buffer
  static constexpr int kPerBlock = kWarpKernelThreads / W;
};

template <int W>
__device__ __forceinline__ float group_sum(float v, unsigned mask) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) v += __shfl_xor_sync(mask, v, o, W);
  return v;
}

// out_i = sum_k rows[k][i] mult_k: column j of Y Z when `rows` holds Y^T
// by rows and `mult` (this lane's own row of a buffer) is column j of Z.
template <int W>
__device__ __forceinline__ void column_product(const float* rows,
                                               const float* mult,
                                               float (&out)[W]) {
#pragma unroll
  for (int i = 0; i < W; ++i) out[i] = 0.0f;
#pragma unroll 1
  for (int k0 = 0; k0 < W; k0 += kRowsPerStep) {
    float m[kRowsPerStep];
#pragma unroll
    for (int q = 0; q < kRowsPerStep / 4; ++q) {
      const float4 m4 = *reinterpret_cast<const float4*>(mult + k0 + 4 * q);
      m[4 * q] = m4.x;
      m[4 * q + 1] = m4.y;
      m[4 * q + 2] = m4.z;
      m[4 * q + 3] = m4.w;
    }
#pragma unroll
    for (int kk = 0; kk < kRowsPerStep; ++kk) {
      const float4* row =
          reinterpret_cast<const float4*>(rows + (k0 + kk) * Slice<W>::kStride);
#pragma unroll
      for (int q = 0; q < W / 4; ++q) {
        const float4 r = row[q];
        out[4 * q] = fmaf(r.x, m[kk], out[4 * q]);
        out[4 * q + 1] = fmaf(r.y, m[kk], out[4 * q + 1]);
        out[4 * q + 2] = fmaf(r.z, m[kk], out[4 * q + 2]);
        out[4 * q + 3] = fmaf(r.w, m[kk], out[4 * q + 3]);
      }
    }
  }
}

template <int W>
__device__ __forceinline__ void store_row(float* S, int j, const float (&x)[W]) {
  float4* row = reinterpret_cast<float4*>(S + j * Slice<W>::kStride);
#pragma unroll
  for (int q = 0; q < W / 4; ++q) {
    row[q] = make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
  }
}

template <int W>
__device__ __forceinline__ void load_row(const float* S, int j, float (&x)[W]) {
  const float4* row = reinterpret_cast<const float4*>(S + j * Slice<W>::kStride);
#pragma unroll
  for (int q = 0; q < W / 4; ++q) {
    const float4 r = row[q];
    x[4 * q] = r.x;
    x[4 * q + 1] = r.y;
    x[4 * q + 2] = r.z;
    x[4 * q + 3] = r.w;
  }
}

template <int W>
__global__ void __launch_bounds__(kWarpKernelThreads)
sp2_warp_kernel(const float* __restrict__ a0, const float* __restrict__ nocc,
                float* __restrict__ out, int* __restrict__ iters, int B, int n,
                float eps, int max_iter) {
  constexpr int kFloats = Slice<W>::kFloats;
  __shared__ __align__(16) float smem[Slice<W>::kPerBlock * 2 * kFloats];
  const int lane = threadIdx.x & 31;
  const int j = threadIdx.x & (W - 1);
  const int slot = threadIdx.x / W;
  const long long b = static_cast<long long>(blockIdx.x) * Slice<W>::kPerBlock + slot;
  if (b >= B) return;  // the whole group leaves together
  const unsigned mask = W == 32 ? 0xffffffffu : (0xffffu << (lane & 16));
  float* S = smem + slot * 2 * kFloats;  // X^T by rows: row k = column k of X
  float* T = S + kFloats;                // X^2 by rows, for the McWeeny step
  const float* own = S + j * Slice<W>::kStride;  // column j of X
  const long long nn = static_cast<long long>(n) * n;
  const float* src = a0 + b * nn;
  const float occ = nocc[b];

  float x[W], y[W];
#pragma unroll
  for (int i = 0; i < W; ++i) x[i] = (i < n && j < n) ? src[i * n + j] : 0.0f;
  float diag = 0.0f;
#pragma unroll
  for (int i = 0; i < W; ++i) diag = i == j ? x[i] : diag;
  float tr = group_sum<W>(diag, mask);
  float e0 = fabsf(tr - occ), e1 = e0, e2 = e0;
  store_row<W>(S, j, x);
  __syncwarp(mask);

  int it = 0;
  bool active = true;
  while (active && it < max_iter) {
    column_product<W>(S, own, y);  // column j of X^2
    load_row<W>(S, j, x);
    float frob = 0.0f;
#pragma unroll
    for (int i = 0; i < W; ++i) frob = fmaf(x[i], x[i], frob);
    const float tr2 = group_sum<W>(frob, mask);
    const bool take = fabsf(tr2 - occ) < fabsf(2.0f * tr - tr2 - occ);
    const float s = take ? 1.0f : -1.0f;
#pragma unroll
    for (int i = 0; i < W; ++i) x[i] = x[i] + s * (y[i] - x[i]);
    __syncwarp(mask);  // every lane of the molecule has read the slice
    store_row<W>(S, j, x);
    __syncwarp(mask);
    tr = take ? tr2 : 2.0f * tr - tr2;
    e2 = e1;
    e1 = e0;
    e0 = fabsf(tr - occ);
    ++it;
    if (e0 < eps && !(e0 < e2)) active = false;
  }

  // McWeeny polish: X <- 3 X^2 - 2 X^3, output 2 X
  column_product<W>(S, own, y);  // column j of X^2
  store_row<W>(T, j, y);
  __syncwarp(mask);
  column_product<W>(T, own, x);  // column j of X^2 X
  float* dst = out + b * nn;
  if (j < n) {
#pragma unroll
    for (int i = 0; i < W; ++i) {
      if (i < n) dst[i * n + j] = 2.0f * (3.0f * y[i] - 2.0f * x[i]);
    }
  }
  if (iters != nullptr && j == 0) iters[b] = it;
}

// ------------------------------------------------------------------ n > 32

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
sp2_block_kernel(const float* __restrict__ a0, const float* __restrict__ nocc,
                 float* __restrict__ out, int* __restrict__ iters, int n,
                 float eps, int max_iter) {
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

template <int W>
void launch_warp(const float* a0, const float* nocc, float* out, int* iters,
                 int B, int n, float eps, int max_iter, cudaStream_t stream) {
  constexpr int per_block = Slice<W>::kPerBlock;
  sp2_warp_kernel<W><<<(B + per_block - 1) / per_block, kWarpKernelThreads, 0,
                       stream>>>(a0, nocc, out, iters, B, n, eps, max_iter);
}

}  // namespace

// a0, out: (B, n, n) float32 contiguous, n <= 128; nocc: (B,) float32;
// iters: (B,) int32 or null.  One launch on `stream`: the warp kernel for
// n <= 32, the block kernel above.  Returns cudaGetLastError().
extern "C" int sp2_purify_f32(const float* a0, const float* nocc, float* out,
                              int* iters, int B, int n, float eps,
                              int max_iter, void* stream) {
  if (n < 1 || n > 128) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  if (n <= 16) {
    launch_warp<16>(a0, nocc, out, iters, B, n, eps, max_iter, st);
  } else if (n <= 32) {
    launch_warp<32>(a0, nocc, out, iters, B, n, eps, max_iter, st);
  } else {
    const size_t smem = (2 * static_cast<size_t>(n) * n + kWarps) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        sp2_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    sp2_block_kernel<<<B, kThreads, smem, st>>>(a0, nocc, out, iters, n, eps,
                                                max_iter);
  }
  return static_cast<int>(cudaGetLastError());
}
