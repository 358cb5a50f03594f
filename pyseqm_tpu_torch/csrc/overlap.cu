// The five STO overlap combinations of one pair segment (S111, S211, S121,
// S221, S222), float32 in and out, one thread per cell: the forward of
// ops/overlap.py::_STf on CUDA float32 tensors.
//
// Replaces no TPU kernel: the JAX package leaves this chain to XLA, which
// fuses its double-float (hi, lo) float32 operations into a few loops.
// Eager PyTorch runs each of those operations as its own launch, some
// 2,300 to 10,200 per segment, so on the card the chain was the step's
// largest block of time and most of its launches.
//
// Arithmetic.  The A/B auxiliary integrals and the alternating-sign
// brackets that the chain carries as double-float are evaluated here in
// FP64 registers (the H100 has native FP64; the original PYSEQM computes
// this chain in float64).  The float32 prefactors (x^1.5 and x^2.5 of the
// exponent products, r^4, r^5, the constants) are computed in float32
// exactly as the chain does on the card, where PyTorch divides a tensor
// by a Python number as a product with the number's float32 reciprocal;
// each output is rounded to float32 once, from the FP64 product of its
// prefactor and its bracket.  No --use_fast_math, and every float32
// product is an explicit __fmul_rn.  So each output lies within one
// float32 ulp of the chain's, whose own error is ~1e-11 relative before
// its final rounding.  The chain's edge cases are kept: a zero A argument
// (a zero exponent sum) and one above 103.97 (where its float32 exp
// saturates to 0) give A = 0; the exact B regime clamps its argument to
// +-85; the B regime (exact |x| > 0.5, Taylor 1e-6 < |x| <= 0.5, limit
// below) is chosen on the argument rounded to float32, as the chain
// chooses it on its hi part.
//
// Which combinations a cell evaluates.  The segment's mode (2 H-H, 3 X-H,
// 4 general; the highest jcall class present) is a template parameter: a
// mode-2 segment evaluates the ss combination only and writes zeros to the
// other four, as _s_combinations returns them.  Within a segment each cell
// evaluates only the class its masks select, with the chain's priorities
// (S111: jcall2, then jcall3, then jcall4; S211: jcall3, then jcall4; the
// rest: jcall4), and of the B integrals only its own regime; a cell that
// selects no class (row 3, or none) writes zeros.
//
// What bounds it on an H100.  Per cell it reads at most five floats and
// three bytes and writes five floats (expanded inputs read less); on the
// 34.1M cells of an xl-small step 1.24 GB, 0.37 ms at 3.35 TB/s.  A cell
// of class jcall2 / jcall3 / jcall4 evaluates one / two / four A/B pairs
// in FP64 (two exp and three divides each), some 1.2 G operations per
// xl-small step, 0.035 ms at the card's 34 TFLOP/s of FP64 outside the
// tensor cores: device memory bounds it.  The kernel keeps to one pass:
// no input is copied or expanded, and the outputs are written once,
// coalesced.  A cell's work depends on its class, so warps with mixed
// classes diverge (the heavy-atom segment runs at a quarter to a third
// of its byte bound, the H-H segment at it).
//
// Inputs may be broadcast views (the X-H and H-H call sites pass expanded
// per-atom exponents): the wrapper passes each input's strides over the
// broadcast shape, at most 4 dimensions after it merges the dimensions
// that every input walks contiguously, and no input is copied.  Offsets
// are 32-bit where every offset fits (template parameter I).  Outputs are
// contiguous in the broadcast shape.
//
// Entry point (plain C, ctypes): overlap_f32(...), launched on the given
// stream; returns the cudaError_t of the launch.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int kMaxDim = 4;
constexpr int kInputs = 8;     // rij, zsi, zpi, zsj, zpj, jcall2, jcall3, jcall4
constexpr int kThreads = 256;

struct Layout {
  int ndim;                               // 1..kMaxDim, outermost first
  long long size[kMaxDim];
  long long stride[kInputs][kMaxDim];     // in elements
};

struct Args {
  const float* f[5];                      // rij, zsi, zpi, zsj, zpj
  const unsigned char* m[3];              // jcall2, jcall3, jcall4
  float* s[5];                            // S111, S211, S121, S221, S222
};

// PyTorch on CUDA divides a float32 tensor by a Python number as a product
// with the number's float32 reciprocal (computed in float32)
constexpr double kSqrt3 = 1.7320508075688772;
constexpr float kInvSqrt3x8 = 1.0f / static_cast<float>(kSqrt3 * 8.0);
constexpr float kInv48 = 1.0f / 48.0f;
constexpr float kInv16Sqrt3 = 1.0f / static_cast<float>(16.0 * kSqrt3);

template <typename I>
__device__ __forceinline__ void cell_offsets(const Layout& L, I i,
                                             I off[kInputs]) {
#pragma unroll
  for (int k = 0; k < kInputs; ++k) off[k] = 0;
#pragma unroll
  for (int d = kMaxDim - 1; d > 0; --d) {
    if (d >= L.ndim) continue;
    const I sz = static_cast<I>(L.size[d]);
    const I q = i / sz;
    const I r = i - q * sz;
#pragma unroll
    for (int k = 0; k < kInputs; ++k)
      off[k] += r * static_cast<I>(L.stride[k][d]);
    i = q;
  }
#pragma unroll
  for (int k = 0; k < kInputs; ++k)
    off[k] += i * static_cast<I>(L.stride[k][0]);
}

// overlap._p15 and _p25: x^1.5 and x^2.5 on the argument clamped to the
// smallest normal float, 0 for x <= 0
__device__ __forceinline__ float p15(float x) {
  const float xc = fmaxf(x, FLT_MIN);
  return x > 0.0f ? __fmul_rn(xc, __fsqrt_rn(xc)) : 0.0f;
}

__device__ __forceinline__ float p25(float x) {
  const float xc = fmaxf(x, FLT_MIN);
  return x > 0.0f ? __fmul_rn(__fmul_rn(xc, xc), __fsqrt_rn(xc)) : 0.0f;
}

// A_k(x) = int_1^inf t^k exp(-x t) dt, k = 0..4
__device__ __forceinline__ void a_integrals(double x, double A[5]) {
  const float xh = __double2float_rn(x);
  if (xh == 0.0f || xh > 103.97f) {
#pragma unroll
    for (int k = 0; k < 5; ++k) A[k] = 0.0;
    return;
  }
  const double u = 1.0 / x;
  const double a1 = exp(-x) * u;
  A[0] = a1;
  A[1] = a1 + a1 * u;
  A[2] = a1 + 2.0 * (A[1] * u);
  A[3] = a1 + 3.0 * (A[2] * u);
  A[4] = a1 + 4.0 * (A[3] * u);
}

// B_k(x) = int_-1^1 t^k exp(-x t) dt, k = 0..4, in the regime of x
__device__ __forceinline__ void b_integrals(double x, double B[5]) {
  const float ah = fabsf(__double2float_rn(x));
  if (ah > 0.5f) {
    const double xs = ah > 85.0f ? copysign(85.0, x) : x;
    const double u = 1.0 / xs;
    const double ep = exp(xs);
    const double tx = ep * u;
    const double tmx = -(u / ep);
    B[0] = tx + tmx;
    B[1] = -tx + tmx + B[0] * u;
    B[2] = tx + tmx + 2.0 * (B[1] * u);
    B[3] = -tx + tmx + 3.0 * (B[2] * u);
    B[4] = tx + tmx + 4.0 * (B[3] * u);
  } else if (ah > 1.0e-6f) {
    const double x2 = x * x;
    B[0] = ((x2 * (1.0 / 2520.0) + 1.0 / 60.0) * x2 + 1.0 / 3.0) * x2 + 2.0;
    B[1] = -(x * ((x2 * (1.0 / 420.0) + 1.0 / 15.0) * x2 + 2.0 / 3.0));
    B[2] = ((x2 * (1.0 / 3240.0) + 1.0 / 84.0) * x2 + 1.0 / 5.0) * x2
           + 2.0 / 3.0;
    B[3] = -(x * ((x2 * (1.0 / 540.0) + 1.0 / 21.0) * x2 + 2.0 / 5.0));
    B[4] = ((x2 * (1.0 / 3960.0) + 1.0 / 108.0) * x2 + 1.0 / 7.0) * x2
           + 2.0 / 5.0;
  } else {
    B[0] = 2.0;
    B[1] = 0.0;
    B[2] = 2.0 / 3.0;
    B[3] = 0.0;
    B[4] = 2.0 / 5.0;
  }
}

// A at 0.5 rij (z1 + z2), B at 0.5 rij (z1 - z2)
__device__ __forceinline__ void ab(float rij, float z1, float z2, double A[5],
                                   double B[5]) {
  const double r = 0.5 * static_cast<double>(rij);
  const double a = static_cast<double>(z1), b = static_cast<double>(z2);
  a_integrals(r * (a + b), A);
  b_integrals(r * (a - b), B);
}

// a float32 prefactor times an FP64 bracket, rounded once
__device__ __forceinline__ float once(float pref, double bracket) {
  return __double2float_rn(static_cast<double>(pref) * bracket);
}

template <int MODE, typename I>
__global__ void __launch_bounds__(kThreads)
overlap_s_kernel(Args g, Layout L, I n) {
  const I i = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  I off[kInputs];
  cell_offsets(L, i, off);
  const float rij = g.f[0][off[0]];
  const float zsi = g.f[1][off[1]], zpi = g.f[2][off[2]];
  const float zsj = g.f[3][off[3]], zpj = g.f[4][off[4]];
  const bool j2 = g.m[0][off[5]] != 0;
  const bool j3 = MODE >= 3 && g.m[1][off[6]] != 0;
  const bool j4 = MODE >= 4 && g.m[2][off[7]] != 0;
  const float r2 = __fmul_rn(rij, rij);
  const float r4 = __fmul_rn(r2, r2);
  const float r5 = __fmul_rn(r4, rij);
  float s111 = 0.0f, s211 = 0.0f, s121 = 0.0f, s221 = 0.0f, s222 = 0.0f;
  double A[5], B[5];

  if (j2 || j3 || j4) {
    ab(rij, zsi, zsj, A, B);
    if (j2) {
      const float w = __fmul_rn(p15(__fmul_rn(__fmul_rn(zsi, zsj), r2)),
                                0.25f);
      s111 = once(w, A[2] * B[0] - B[2] * A[0]);
    } else if (j3) {
      const float w = __fmul_rn(
          __fmul_rn(__fmul_rn(p15(zsj), p25(zsi)), r4), kInvSqrt3x8);
      s111 = once(w, A[3] * B[0] - B[3] * A[0] + A[2] * B[1] - B[2] * A[1]);
    } else {
      const float w = __fmul_rn(__fmul_rn(p25(__fmul_rn(zsj, zsi)), r5),
                                kInv48);
      s111 = once(w, A[4] * B[0] + B[4] * A[0] - 2.0 * (A[2] * B[2]));
    }
  }
  if (j3 || j4) {
    ab(rij, zpi, zsj, A, B);
    if (j3) {
      const float w = __fmul_rn(
          __fmul_rn(__fmul_rn(p15(zsj), p25(zpi)), r4), 0.125f);
      s211 = once(w, A[2] * B[0] - B[2] * A[0] + A[3] * B[1] - B[3] * A[1]);
    } else {
      const float w = __fmul_rn(__fmul_rn(p25(__fmul_rn(zsj, zpi)), r5),
                                kInv16Sqrt3);
      s211 = once(w, A[3] * (B[0] - B[2]) - A[1] * (B[2] - B[4])
                         + B[3] * (A[0] - A[2]) - B[1] * (A[2] - A[4]));
    }
  }
  if (j4) {
    ab(rij, zsi, zpj, A, B);
    const float w = __fmul_rn(__fmul_rn(p25(__fmul_rn(zpj, zsi)), r5),
                              kInv16Sqrt3);
    s121 = once(w, A[3] * (B[0] - B[2]) - A[1] * (B[2] - B[4])
                       - B[3] * (A[0] - A[2]) + B[1] * (A[2] - A[4]));
    ab(rij, zpi, zpj, A, B);
    const float wf = __fmul_rn(__fmul_rn(p25(__fmul_rn(zpj, zpi)), r5),
                               0.0625f);
    s221 = once(-wf, B[2] * (A[4] + A[0]) - A[2] * (B[4] + B[0]));
    s222 = once(__fmul_rn(0.5f, wf),
                A[4] * (B[0] - B[2]) - B[4] * (A[0] - A[2]) - A[2] * B[0]
                    + B[2] * A[0]);
  }
  g.s[0][i] = s111;
  g.s[1][i] = s211;
  g.s[2][i] = s121;
  g.s[3][i] = s221;
  g.s[4][i] = s222;
}

template <int MODE>
cudaError_t launch(const Args& g, const Layout& L, long long n, bool wide,
                   cudaStream_t stream) {
  const unsigned blocks =
      static_cast<unsigned>((n + kThreads - 1) / kThreads);
  if (wide)
    overlap_s_kernel<MODE, unsigned long long><<<blocks, kThreads, 0, stream>>>(
        g, L, static_cast<unsigned long long>(n));
  else
    overlap_s_kernel<MODE, unsigned><<<blocks, kThreads, 0, stream>>>(
        g, L, static_cast<unsigned>(n));
  return cudaGetLastError();
}

}  // namespace

extern "C" int overlap_f32(const void* rij, const void* zsi, const void* zpi,
                           const void* zsj, const void* zpj, const void* j2,
                           const void* j3, const void* j4, void* s111,
                           void* s211, void* s121, void* s221, void* s222,
                           int mode, long long n, int ndim,
                           const long long* sizes, const long long* strides,
                           int wide, void* stream) {
  if (n <= 0) return 0;
  if (ndim < 1 || ndim > kMaxDim || mode < 2 || mode > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  Args g;
  const void* fin[5] = {rij, zsi, zpi, zsj, zpj};
  const void* mask[3] = {j2, j3, j4};
  void* sout[5] = {s111, s211, s121, s221, s222};
  for (int k = 0; k < 5; ++k) {
    g.f[k] = static_cast<const float*>(fin[k]);
    g.s[k] = static_cast<float*>(sout[k]);
  }
  for (int k = 0; k < 3; ++k)
    g.m[k] = static_cast<const unsigned char*>(mask[k]);
  Layout L;
  L.ndim = ndim;
  for (int d = 0; d < kMaxDim; ++d) {
    L.size[d] = d < ndim ? sizes[d] : 1;
    for (int k = 0; k < kInputs; ++k)
      L.stride[k][d] = d < ndim ? strides[k * ndim + d] : 0;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (mode) {
    case 2: err = launch<2>(g, L, n, wide != 0, s); break;
    case 3: err = launch<3>(g, L, n, wide != 0, s); break;
    default: err = launch<4>(g, L, n, wide != 0, s); break;
  }
  return static_cast<int>(err);
}
