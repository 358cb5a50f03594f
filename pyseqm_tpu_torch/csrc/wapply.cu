// Fused two-electron apply (K3), forward and backward, one thread per cell.
//
// Replaces the TPU kernels tools/wapply_pallas.py::_fwd_kernel and
// ::_bwd_kernel (launched by _call, wrapped by the w_apply_fused
// custom_vjp) and computes what they compute, not their (64, 128) lane
// layout.  A cell is one atom pair of a Fock build: the 22 local-frame
// integrals ri, the pair's frame U (4 x 4) and a 4 x 4 density block X.
// The forward is
//
//   Xl = U^T X U                         (rotate into the local frame)
//   y[f] = sum over the nonzeros (f, r, c) of T_perm:  ri[r] * Xl[c]
//   out = U y U^T                        (rotate back)
//
// where T_perm is the 0/1 expansion tensor of the 22 integrals with its
// four orbital indices permuted (f = free pair, c = contracted pair, both
// flattened 4 a + b).  The wrapper passes its 72 nonzeros as a table of
// packed ints f | r << 4 | c << 9, built from the package's own
// _ri_expansion_table (ops/wapply_kernel.py).
//
// U is structural: row 0 is e_0 and column 0 of rows 1-3 is 0
// (tetci.frame_matrix).  Only the 3 x 3 block U[1:4, 1:4] is read, and
// the U cotangent is returned on that block only (zeros elsewhere), as in
// the TPU kernel.
//
// The backward takes the output cotangent Yb and gives, in one pass,
//
//   El = U^T Yb U,   B = T_perm(ri)[Xl],   C = T_perm*(ri)[El]
//   dX   = U C U^T                         (T_perm*: f and c swapped)
//   dri[r] = sum over the nonzeros (f, r, c): El[f] Xl[c]
//   dU   = Yb U B^T + Yb^T U B + X U C^T + X^T U C   (3 x 3 block)
//
// Any of the three cotangent pointers may be null (not computed).
//
// What bounds it on an H100: a cell reads 47 values and writes 16 in the
// forward (63 and 47 in the backward) and does ~400 (~900) floating-point
// operations on them, about 2 (4) flops per byte in float32: device
// memory bounds it, far below the FP32 rate.  The design is the simple
// one: one thread per cell, each thread loading its own cell; the rotations
// in registers with the structural zeros of U folded out; the 72-entry
// contraction as a loop over the table held in shared memory, with the
// arrays it indexes at run time (ri, Xl, y and in the backward also El, B,
// C, dri) in shared memory laid out [component][thread], so that every
// access of a warp hits 32 consecutive banks.  Coalesced staging of the
// cells through shared memory and a perm-specialised unrolled contraction
// are later work.  Templated on float and double; no fast-math.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxEntries = 128;

// u[3 (a - 1) + (k - 1)] = U[a][k] for a, k in 1..3
template <typename T>
__device__ __forceinline__ void load_u(const T* __restrict__ U, T (&u)[9]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int k = 0; k < 3; ++k) u[3 * a + k] = U[4 * (a + 1) + k + 1];
  }
}

template <typename T>
__device__ __forceinline__ void load16(const T* __restrict__ p, T (&x)[16]) {
#pragma unroll
  for (int k = 0; k < 16; ++k) x[k] = p[k];
}

// Xl = U^T X U
template <typename T>
__device__ __forceinline__ void to_local(const T (&u)[9], const T (&X)[16],
                                         T (&Xl)[16]) {
  T t[16];  // t[k][b] = sum_a U[a][k] X[a][b]
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    t[b] = X[b];
#pragma unroll
    for (int k = 1; k < 4; ++k) {
      t[4 * k + b] = u[k - 1] * X[4 + b] + u[3 + k - 1] * X[8 + b] +
                     u[6 + k - 1] * X[12 + b];
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    Xl[4 * k] = t[4 * k];
#pragma unroll
    for (int l = 1; l < 4; ++l) {
      Xl[4 * k + l] = t[4 * k + 1] * u[l - 1] + t[4 * k + 2] * u[3 + l - 1] +
                      t[4 * k + 3] * u[6 + l - 1];
    }
  }
}

// E = U Y U^T
template <typename T>
__device__ __forceinline__ void from_local(const T (&u)[9], const T (&Y)[16],
                                           T (&E)[16]) {
  T s[16];  // s[a][l] = sum_k U[a][k] Y[k][l]
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    s[l] = Y[l];
#pragma unroll
    for (int a = 1; a < 4; ++a) {
      s[4 * a + l] = u[3 * (a - 1)] * Y[4 + l] + u[3 * (a - 1) + 1] * Y[8 + l] +
                     u[3 * (a - 1) + 2] * Y[12 + l];
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    E[4 * a] = s[4 * a];
#pragma unroll
    for (int b = 1; b < 4; ++b) {
      E[4 * a + b] = s[4 * a + 1] * u[3 * (b - 1)] +
                     s[4 * a + 2] * u[3 * (b - 1) + 1] +
                     s[4 * a + 3] * u[3 * (b - 1) + 2];
    }
  }
}

// rows 1..3 of M = op(A) U, op(A) = A or A^T: M[a][l] = sum_m op(A)[a][m] U[m][l]
template <typename T, bool kTrans>
__device__ __forceinline__ void times_u(const T (&A)[16], const T (&u)[9],
                                        T (&M)[12]) {
#pragma unroll
  for (int a = 1; a < 4; ++a) {
    const T a1 = kTrans ? A[4 + a] : A[4 * a + 1];
    const T a2 = kTrans ? A[8 + a] : A[4 * a + 2];
    const T a3 = kTrans ? A[12 + a] : A[4 * a + 3];
    M[4 * (a - 1)] = kTrans ? A[a] : A[4 * a];
#pragma unroll
    for (int l = 1; l < 4; ++l) {
      M[4 * (a - 1) + l] = a1 * u[l - 1] + a2 * u[3 + l - 1] + a3 * u[6 + l - 1];
    }
  }
}

// out[a][k] += sum_l M[a][l] B[k][l] (M B^T; kTrans: B[l][k], M B), a, k in 1..3
template <typename T, bool kTrans>
__device__ __forceinline__ void add_times(const T (&M)[12], const T (&B)[16],
                                          T (&out)[9]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int k = 1; k < 4; ++k) {
      T acc = out[3 * a + k - 1];
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        acc += M[4 * a + l] * (kTrans ? B[4 * l + k] : B[4 * k + l]);
      }
      out[3 * a + k - 1] = acc;
    }
  }
}

template <typename T, int kThreads>
__global__ void __launch_bounds__(kThreads)
wapply_fwd(const T* __restrict__ ri, const T* __restrict__ U,
           const T* __restrict__ X, T* __restrict__ y,
           const int* __restrict__ table, int n_entries, long long C) {
  __shared__ int s_tab[kMaxEntries];
  __shared__ T s_ri[22 * kThreads];
  __shared__ T s_xl[16 * kThreads];
  __shared__ T s_y[16 * kThreads];
  for (int e = threadIdx.x; e < n_entries; e += kThreads) s_tab[e] = table[e];
  __syncthreads();
  const long long c = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= C) return;  // no barrier follows
  const int t = threadIdx.x;

  T u[9], x[16], xl[16];
  load_u(U + 16 * c, u);
  load16(X + 16 * c, x);
#pragma unroll
  for (int r = 0; r < 22; ++r) s_ri[r * kThreads + t] = ri[22 * c + r];
  to_local(u, x, xl);
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    s_xl[k * kThreads + t] = xl[k];
    s_y[k * kThreads + t] = T(0);
  }
  for (int e = 0; e < n_entries; ++e) {
    const int v = s_tab[e];
    const int f = v & 15, r = (v >> 4) & 31, cc = v >> 9;
    s_y[f * kThreads + t] += s_ri[r * kThreads + t] * s_xl[cc * kThreads + t];
  }
  T yl[16], out[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) yl[k] = s_y[k * kThreads + t];
  from_local(u, yl, out);
#pragma unroll
  for (int k = 0; k < 16; ++k) y[16 * c + k] = out[k];
}

template <typename T, int kThreads>
__global__ void __launch_bounds__(kThreads)
wapply_bwd(const T* __restrict__ ri, const T* __restrict__ U,
           const T* __restrict__ X, const T* __restrict__ Yb,
           T* __restrict__ dri, T* __restrict__ dU, T* __restrict__ dX,
           const int* __restrict__ table, int n_entries, long long C) {
  __shared__ int s_tab[kMaxEntries];
  __shared__ T s_ri[22 * kThreads];
  __shared__ T s_xl[16 * kThreads];
  __shared__ T s_el[16 * kThreads];
  __shared__ T s_b[16 * kThreads];
  __shared__ T s_c[16 * kThreads];
  __shared__ T s_dri[22 * kThreads];
  for (int e = threadIdx.x; e < n_entries; e += kThreads) s_tab[e] = table[e];
  __syncthreads();
  const long long c = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= C) return;  // no barrier follows
  const int t = threadIdx.x;

  T u[9], x[16], yb[16];
  load_u(U + 16 * c, u);
  load16(X + 16 * c, x);
  load16(Yb + 16 * c, yb);
#pragma unroll
  for (int r = 0; r < 22; ++r) {
    s_ri[r * kThreads + t] = ri[22 * c + r];
    s_dri[r * kThreads + t] = T(0);
  }
  {
    T xl[16], el[16];
    to_local(u, x, xl);
    to_local(u, yb, el);
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      s_xl[k * kThreads + t] = xl[k];
      s_el[k * kThreads + t] = el[k];
      s_b[k * kThreads + t] = T(0);
      s_c[k * kThreads + t] = T(0);
    }
  }
  for (int e = 0; e < n_entries; ++e) {
    const int v = s_tab[e];
    const int f = v & 15, r = (v >> 4) & 31, cc = v >> 9;
    const T rr = s_ri[r * kThreads + t];
    const T xc = s_xl[cc * kThreads + t];
    const T ef = s_el[f * kThreads + t];
    s_b[f * kThreads + t] += rr * xc;
    s_c[cc * kThreads + t] += rr * ef;
    s_dri[r * kThreads + t] += ef * xc;
  }
  if (dri != nullptr) {
#pragma unroll
    for (int r = 0; r < 22; ++r) dri[22 * c + r] = s_dri[r * kThreads + t];
  }
  T cm[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) cm[k] = s_c[k * kThreads + t];
  if (dX != nullptr) {
    T dx[16];
    from_local(u, cm, dx);
#pragma unroll
    for (int k = 0; k < 16; ++k) dX[16 * c + k] = dx[k];
  }
  if (dU != nullptr) {
    T bm[16], m[12], du[9];
#pragma unroll
    for (int k = 0; k < 16; ++k) bm[k] = s_b[k * kThreads + t];
#pragma unroll
    for (int k = 0; k < 9; ++k) du[k] = T(0);
    times_u<T, false>(yb, u, m);   // Yb U B^T
    add_times<T, false>(m, bm, du);
    times_u<T, true>(yb, u, m);    // Yb^T U B
    add_times<T, true>(m, bm, du);
    times_u<T, false>(x, u, m);    // X U C^T
    add_times<T, false>(m, cm, du);
    times_u<T, true>(x, u, m);     // X^T U C
    add_times<T, true>(m, cm, du);
    T* o = dU + 16 * c;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      o[k] = T(0);
      o[4 * k] = T(0);
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int k = 0; k < 3; ++k) o[4 * (a + 1) + k + 1] = du[3 * a + k];
    }
  }
}

// 27.6 KB of shared memory per block in every variant
template <typename T> struct Threads;
template <> struct Threads<float> { static constexpr int kFwd = 128, kBwd = 64; };
template <> struct Threads<double> { static constexpr int kFwd = 64, kBwd = 32; };

template <typename T>
int launch_fwd(const T* ri, const T* U, const T* X, T* y, const int* table,
               int n_entries, long long C, void* stream) {
  if (n_entries < 0 || n_entries > kMaxEntries || C < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int kT = Threads<T>::kFwd;
  const long long blocks = (C + kT - 1) / kT;
  if (blocks > 0) {
    wapply_fwd<T, kT><<<static_cast<unsigned>(blocks), kT, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        ri, U, X, y, table, n_entries, C);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const T* ri, const T* U, const T* X, const T* Yb, T* dri,
               T* dU, T* dX, const int* table, int n_entries, long long C,
               void* stream) {
  if (n_entries < 0 || n_entries > kMaxEntries || C < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int kT = Threads<T>::kBwd;
  const long long blocks = (C + kT - 1) / kT;
  if (blocks > 0) {
    wapply_bwd<T, kT><<<static_cast<unsigned>(blocks), kT, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        ri, U, X, Yb, dri, dU, dX, table, n_entries, C);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ri: (C, 22); U, X, y, Yb, dU, dX: (C, 4, 4); dri: (C, 22); all contiguous
// and of one type; table: (n_entries,) int32 on the device.  dri, dU and
// dX may be null.  Launch on `stream`; return cudaGetLastError() (or
// cudaErrorInvalidValue for a table longer than 128 entries).
extern "C" int wapply_fwd_f32(const float* ri, const float* U, const float* X,
                              float* y, const int* table, int n_entries,
                              long long C, void* stream) {
  return launch_fwd(ri, U, X, y, table, n_entries, C, stream);
}

extern "C" int wapply_fwd_f64(const double* ri, const double* U,
                              const double* X, double* y, const int* table,
                              int n_entries, long long C, void* stream) {
  return launch_fwd(ri, U, X, y, table, n_entries, C, stream);
}

extern "C" int wapply_bwd_f32(const float* ri, const float* U, const float* X,
                              const float* Yb, float* dri, float* dU,
                              float* dX, const int* table, int n_entries,
                              long long C, void* stream) {
  return launch_bwd(ri, U, X, Yb, dri, dU, dX, table, n_entries, C, stream);
}

extern "C" int wapply_bwd_f64(const double* ri, const double* U,
                              const double* X, const double* Yb, double* dri,
                              double* dU, double* dX, const int* table,
                              int n_entries, long long C, void* stream) {
  return launch_bwd(ri, U, X, Yb, dri, dU, dX, table, n_entries, C, stream);
}
