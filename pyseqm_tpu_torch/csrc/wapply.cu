// Fused two-electron apply (K3), forward and backward.
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
// flattened 4 a + b).  T's 72 nonzeros are the constexpr table kT below
// (the package's _ri_expansion_table; tests/test_torch_wapply.py parses
// it and holds it to that table).  The perm is a template parameter:
// (1, 2, 3, 4) Coulomb on atom i, (3, 4, 1, 2) Coulomb on atom j,
// (1, 3, 2, 4) exchange.  Each instantiation unrolls the 72 entries with
// their indices fixed at compile time, as the TPU kernel unrolls them at
// trace time, so every per-cell array lives in registers.
//
// U is structural: row 0 is e_0 and column 0 of rows 1-3 is 0
// (tetci.frame_matrix).  Only the 3 x 3 block U[1:4, 1:4] is used, and
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
// forward (63 and 47 in the backward; U is moved whole, so 70 / 70 and
// 54 move) and does ~400 (~1,300) floating-point operations on them,
// a few flops per byte: device memory bounds it, far below the FP32 rate.
// The design streams the cells through shared memory in contiguous
// spans:
//
// - A block of kCells threads takes tiles of kCells consecutive cells;
//   each tile's ri, U, X (and Yb) are contiguous spans of device memory
//   (88 / 64 bytes per cell in float32), which one thread brings into
//   shared memory with bulk asynchronous copies (cp.async.bulk, completion
//   on an mbarrier).  The grid is persistent (as many blocks as stay
//   resident, each looping over tiles) with two stages: the next tile's
//   copies are issued before the current tile is computed.
// - Each thread reads its own cell from shared memory with 16-byte (ri:
//   8-byte in float32) loads, computes in registers, and writes its
//   outputs back into its own cell's slots of the stage (forward y over
//   X; backward dri over ri, dX over U, dU over X); the block then stores
//   each output span with one bulk copy back to device memory.
// - Bulk copies need 16-byte-aligned addresses: a launch whose pointers
//   are not all 16-byte aligned (a view at an odd cell offset), and the
//   ragged last tile, take the same arithmetic with plain loads and
//   stores straight from device memory.  Never the plain PyTorch version.
//
// Templated on float and double; no fast-math.

#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>
#include <utility>

namespace {

// Element j of T's nonzero e: the 72 nonzeros (r, k, l, m, n), T[r][k][l]
// [m][n] = 1, the integral r on the orbital quadruple (k l | m n) of the
// local frame.  Evaluated at compile time only (constexpr uses below).
__host__ __device__ constexpr int t_nz(int e, int j) {
  constexpr int kT[72][5] = {
      {0, 0, 0, 0, 0}, {1, 0, 1, 0, 0}, {1, 1, 0, 0, 0}, {2, 1, 1, 0, 0},
      {3, 2, 2, 0, 0}, {3, 3, 3, 0, 0}, {4, 0, 0, 0, 1}, {4, 0, 0, 1, 0},
      {5, 0, 1, 0, 1}, {5, 0, 1, 1, 0}, {5, 1, 0, 0, 1}, {5, 1, 0, 1, 0},
      {6, 0, 2, 0, 2}, {6, 0, 2, 2, 0}, {6, 0, 3, 0, 3}, {6, 0, 3, 3, 0},
      {6, 2, 0, 0, 2}, {6, 2, 0, 2, 0}, {6, 3, 0, 0, 3}, {6, 3, 0, 3, 0},
      {7, 1, 1, 0, 1}, {7, 1, 1, 1, 0}, {8, 2, 2, 0, 1}, {8, 2, 2, 1, 0},
      {8, 3, 3, 0, 1}, {8, 3, 3, 1, 0}, {9, 1, 2, 0, 2}, {9, 1, 2, 2, 0},
      {9, 1, 3, 0, 3}, {9, 1, 3, 3, 0}, {9, 2, 1, 0, 2}, {9, 2, 1, 2, 0},
      {9, 3, 1, 0, 3}, {9, 3, 1, 3, 0}, {10, 0, 0, 1, 1}, {11, 0, 0, 2, 2},
      {11, 0, 0, 3, 3}, {12, 0, 1, 1, 1}, {12, 1, 0, 1, 1}, {13, 0, 1, 2, 2},
      {13, 0, 1, 3, 3}, {13, 1, 0, 2, 2}, {13, 1, 0, 3, 3}, {14, 0, 2, 1, 2},
      {14, 0, 2, 2, 1}, {14, 0, 3, 1, 3}, {14, 0, 3, 3, 1}, {14, 2, 0, 1, 2},
      {14, 2, 0, 2, 1}, {14, 3, 0, 1, 3}, {14, 3, 0, 3, 1}, {15, 1, 1, 1, 1},
      {16, 2, 2, 1, 1}, {16, 3, 3, 1, 1}, {17, 1, 1, 2, 2}, {17, 1, 1, 3, 3},
      {18, 2, 2, 2, 2}, {18, 3, 3, 3, 3}, {19, 1, 2, 1, 2}, {19, 1, 2, 2, 1},
      {19, 1, 3, 1, 3}, {19, 1, 3, 3, 1}, {19, 2, 1, 1, 2}, {19, 2, 1, 2, 1},
      {19, 3, 1, 1, 3}, {19, 3, 1, 3, 1}, {20, 2, 2, 3, 3}, {20, 3, 3, 2, 2},
      {21, 2, 3, 2, 3}, {21, 2, 3, 3, 2}, {21, 3, 2, 2, 3}, {21, 3, 2, 3, 2},
  };
  return kT[e][j];
}
constexpr int kNnz = 72;

// T_perm's entry e: its integral r, free pair f and contracted pair c.
// P0..P3 number T's orbital axes 1..4 (k, l, m, n) as the package's perm
// tuples do: T_perm = T.transpose((0,) + perm).
template <int P0, int P1, int P2, int P3>
struct Perm {
  static __host__ __device__ constexpr int r(int e) { return t_nz(e, 0); }
  static __host__ __device__ constexpr int f(int e) {
    return 4 * t_nz(e, P0) + t_nz(e, P1);
  }
  static __host__ __device__ constexpr int c(int e) {
    return 4 * t_nz(e, P2) + t_nz(e, P3);
  }
};

using Entries = std::make_integer_sequence<int, kNnz>;

// --- the contraction, unrolled in table order --------------------------

// y[f] += ri[r] Xl[c]
template <class P, int E, typename V>
__device__ __forceinline__ void fwd_entry(const V (&ri)[22], const V (&xl)[16],
                                          V (&y)[16]) {
  constexpr int r = P::r(E), f = P::f(E), c = P::c(E);
  y[f] += ri[r] * xl[c];
}

template <class P, typename V, int... E>
__device__ __forceinline__ void apply_t(const V (&ri)[22], const V (&xl)[16],
                                        V (&y)[16],
                                        std::integer_sequence<int, E...>) {
  (fwd_entry<P, E>(ri, xl, y), ...);
}

// dri[r] += El[f] Xl[c]
template <class P, int E, typename V>
__device__ __forceinline__ void dri_entry(const V (&el)[16], const V (&xl)[16],
                                          V (&dri)[22]) {
  constexpr int r = P::r(E), f = P::f(E), c = P::c(E);
  dri[r] += el[f] * xl[c];
}

template <class P, typename V, int... E>
__device__ __forceinline__ void dri_pass(const V (&el)[16], const V (&xl)[16],
                                         V (&dri)[22],
                                         std::integer_sequence<int, E...>) {
  (dri_entry<P, E>(el, xl, dri), ...);
}

// C[c] += ri[r] El[f]  (T_perm* applied to El)
template <class P, int E, typename V>
__device__ __forceinline__ void adj_entry(const V (&ri)[22], const V (&el)[16],
                                          V (&cm)[16]) {
  constexpr int r = P::r(E), f = P::f(E), c = P::c(E);
  cm[c] += ri[r] * el[f];
}

template <class P, typename V, int... E>
__device__ __forceinline__ void apply_t_adj(const V (&ri)[22],
                                            const V (&el)[16], V (&cm)[16],
                                            std::integer_sequence<int, E...>) {
  (adj_entry<P, E>(ri, el, cm), ...);
}

// --- a cell's loads and stores ------------------------------------------
// kVec: 16-byte accesses (8-byte for a float ri row, whose cells are 88
// bytes apart); the caller guarantees the alignment.  Otherwise scalar.

__device__ __forceinline__ void ld16b(const float* p, float* x) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
}
__device__ __forceinline__ void ld16b(const double* p, double* x) {
  const double2 q = *reinterpret_cast<const double2*>(p);
  x[0] = q.x; x[1] = q.y;
}
__device__ __forceinline__ void st16b(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void st16b(double* p, const double* x) {
  *reinterpret_cast<double2*>(p) = make_double2(x[0], x[1]);
}
__device__ __forceinline__ void ld2(const float* p, float* x) {
  const float2 q = *reinterpret_cast<const float2*>(p);
  x[0] = q.x; x[1] = q.y;
}
__device__ __forceinline__ void ld2(const double* p, double* x) {
  ld16b(p, x);
}
__device__ __forceinline__ void st2(float* p, const float* x) {
  *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
}
__device__ __forceinline__ void st2(double* p, const double* x) {
  st16b(p, x);
}

template <bool kVec, typename V>
__device__ __forceinline__ void load16(const V* p, V (&x)[16]) {
  constexpr int w = kVec ? 16 / sizeof(V) : 1;
#pragma unroll
  for (int j = 0; j < 16; j += w) {
    if constexpr (kVec) {
      ld16b(p + j, x + j);
    } else {
      x[j] = p[j];
    }
  }
}

template <bool kVec, typename V>
__device__ __forceinline__ void store16(V* p, const V (&x)[16]) {
  constexpr int w = kVec ? 16 / sizeof(V) : 1;
#pragma unroll
  for (int j = 0; j < 16; j += w) {
    if constexpr (kVec) {
      st16b(p + j, x + j);
    } else {
      p[j] = x[j];
    }
  }
}

template <bool kVec, typename V>
__device__ __forceinline__ void load22(const V* p, V (&x)[22]) {
#pragma unroll
  for (int j = 0; j < 22; j += kVec ? 2 : 1) {
    if constexpr (kVec) {
      ld2(p + j, x + j);
    } else {
      x[j] = p[j];
    }
  }
}

template <bool kVec, typename V>
__device__ __forceinline__ void store22(V* p, const V (&x)[22]) {
#pragma unroll
  for (int j = 0; j < 22; j += kVec ? 2 : 1) {
    if constexpr (kVec) {
      st2(p + j, x + j);
    } else {
      p[j] = x[j];
    }
  }
}

// u[3 (a - 1) + (k - 1)] = U[a][k] for a, k in 1..3 (rows 1-3 loaded)
template <bool kVec, typename V>
__device__ __forceinline__ void load_u(const V* p, V (&u)[9]) {
  constexpr int w = kVec ? 16 / sizeof(V) : 1;
  V rows[12];
#pragma unroll
  for (int j = 0; j < 12; j += w) {
    if constexpr (kVec) {
      ld16b(p + 4 + j, rows + j);
    } else {
      rows[j] = p[4 + j];
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int k = 0; k < 3; ++k) u[3 * a + k] = rows[4 * a + k + 1];
  }
}

// --- the rotations, with U's structural zeros folded out ----------------

// Xl = U^T X U
template <typename V>
__device__ __forceinline__ void to_local(const V (&u)[9], const V (&X)[16],
                                         V (&Xl)[16]) {
  V t[16];  // t[k][b] = sum_a U[a][k] X[a][b]
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
template <typename V>
__device__ __forceinline__ void from_local(const V (&u)[9], const V (&Y)[16],
                                           V (&E)[16]) {
  V s[16];  // s[a][l] = sum_k U[a][k] Y[k][l]
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
template <typename V, bool kTrans>
__device__ __forceinline__ void times_u(const V (&A)[16], const V (&u)[9],
                                        V (&M)[12]) {
#pragma unroll
  for (int a = 1; a < 4; ++a) {
    const V a1 = kTrans ? A[4 + a] : A[4 * a + 1];
    const V a2 = kTrans ? A[8 + a] : A[4 * a + 2];
    const V a3 = kTrans ? A[12 + a] : A[4 * a + 3];
    M[4 * (a - 1)] = kTrans ? A[a] : A[4 * a];
#pragma unroll
    for (int l = 1; l < 4; ++l) {
      M[4 * (a - 1) + l] = a1 * u[l - 1] + a2 * u[3 + l - 1] + a3 * u[6 + l - 1];
    }
  }
}

// out[a][k] += sum_l M[a][l] B[k][l] (M B^T; kTrans: B[l][k], M B), a, k in 1..3
template <typename V, bool kTrans>
__device__ __forceinline__ void add_times(const V (&M)[12], const V (&B)[16],
                                          V (&out)[9]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int k = 1; k < 4; ++k) {
      V acc = out[3 * a + k - 1];
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        acc += M[4 * a + l] * (kTrans ? B[4 * l + k] : B[4 * k + l]);
      }
      out[3 * a + k - 1] = acc;
    }
  }
}

// --- one cell ----------------------------------------------------------
// The pointers address the cell's values in shared memory (kVec) or in
// device memory; an output may alias an input of the same cell, which is
// read before it is written.

template <class P, bool kVec, typename V>
__device__ __forceinline__ void fwd_cell(const V* ri_c, const V* u_c,
                                         const V* x_c, V* y_c) {
  V u[9], xl[16];
  load_u<kVec>(u_c, u);
  {
    V x[16];
    load16<kVec>(x_c, x);
    to_local(u, x, xl);
  }
  V ri[22], y[16];
  load22<kVec>(ri_c, ri);
#pragma unroll
  for (int k = 0; k < 16; ++k) y[k] = V(0);
  apply_t<P>(ri, xl, y, Entries{});
  V out[16];
  from_local(u, y, out);
  store16<kVec>(y_c, out);
}

// dri and dX are finished and stored before the dU products, which read
// X and Yb again (in the shared-memory path dri goes over ri, dX over U,
// dU over X); B and C are separate passes, so that Xl is dead before C
// is formed
template <class P, bool kVec, typename V>
__device__ __forceinline__ void bwd_cell(const V* ri_c, const V* u_c,
                                         const V* x_c, const V* yb_c,
                                         V* dri_c, V* du_c, V* dx_c) {
  V u[9], xl[16], el[16];
  load_u<kVec>(u_c, u);
  {
    V a[16];
    load16<kVec>(x_c, a);
    to_local(u, a, xl);
    load16<kVec>(yb_c, a);
    to_local(u, a, el);
  }
  V ri[22];
  load22<kVec>(ri_c, ri);
  if (dri_c != nullptr) {
    V dri[22];
#pragma unroll
    for (int r = 0; r < 22; ++r) dri[r] = V(0);
    dri_pass<P>(el, xl, dri, Entries{});
    store22<kVec>(dri_c, dri);
  }
  V b[16], cm[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) b[k] = cm[k] = V(0);
  apply_t<P>(ri, xl, b, Entries{});
  apply_t_adj<P>(ri, el, cm, Entries{});
  if (dx_c != nullptr) {
    V dx[16];
    from_local(u, cm, dx);
    store16<kVec>(dx_c, dx);
  }
  if (du_c != nullptr) {
    V du[9], m[12];
#pragma unroll
    for (int k = 0; k < 9; ++k) du[k] = V(0);
    {
      V a[16];
      load16<kVec>(yb_c, a);
      times_u<V, false>(a, u, m);   // Yb U B^T
      add_times<V, false>(m, b, du);
      times_u<V, true>(a, u, m);    // Yb^T U B
      add_times<V, true>(m, b, du);
      load16<kVec>(x_c, a);
      times_u<V, false>(a, u, m);   // X U C^T
      add_times<V, false>(m, cm, du);
      times_u<V, true>(a, u, m);    // X^T U C
      add_times<V, true>(m, cm, du);
    }
    V o[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) o[k] = V(0);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int k = 0; k < 3; ++k) o[4 * (a + 1) + k + 1] = du[3 * a + k];
    }
    store16<kVec>(du_c, o);
  }
}

// --- bulk copies and mbarriers (sm_90) -----------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(1)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// device -> shared, `bytes` a multiple of 16, both addresses 16-byte aligned
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// shared -> device, same rules
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                   dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the committed stores have read their shared-memory source
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// this thread's shared-memory writes before a bulk copy that reads them
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --- the kernels ---------------------------------------------------------

// cells per tile = threads per block; a stage holds a tile's inputs:
// [ri 22 | U 16 | X 16 (| Yb 16)] x kCells values, 13.8 KB forward and
// 17.9 KB backward in both types
template <typename V> struct Tile;
template <> struct Tile<float> { static constexpr int kCells = 64; };
template <> struct Tile<double> { static constexpr int kCells = 32; };

template <typename V, int P0, int P1, int P2, int P3>
__global__ void __launch_bounds__(Tile<V>::kCells)
wapply_fwd(const V* __restrict__ ri, const V* __restrict__ U,
           const V* __restrict__ X, V* __restrict__ y, long long C,
           int bulk) {
  using P = Perm<P0, P1, P2, P3>;
  constexpr int kN = Tile<V>::kCells;
  constexpr int kRi = 22 * kN, kM = 16 * kN, kStage = kRi + 2 * kM;
  __shared__ alignas(128) V s_buf[2][kStage];
  __shared__ alignas(8) uint64_t s_bar[2];
  const int t = threadIdx.x;
  const long long n_tiles = (C + kN - 1) / kN;
  const long long n_bulk = bulk ? C / kN : 0;   // full tiles, bulk copies
  if (t == 0) {
    mbar_init(&s_bar[0]);
    mbar_init(&s_bar[1]);
    mbar_init_fence();
  }
  __syncthreads();
  auto issue = [&](int s, long long tile) {
    V* b = s_buf[s];
    mbar_expect_tx(&s_bar[s], kStage * sizeof(V));
    bulk_load(b, ri + tile * kRi, kRi * sizeof(V), &s_bar[s]);
    bulk_load(b + kRi, U + tile * kM, kM * sizeof(V), &s_bar[s]);
    bulk_load(b + kRi + kM, X + tile * kM, kM * sizeof(V), &s_bar[s]);
  };
  long long tile = blockIdx.x;
  if (t == 0 && tile < n_bulk) issue(0, tile);
  uint32_t phase = 0;   // bit s: the parity stage s's barrier completes next
  for (int i = 0; tile < n_tiles; ++i, tile += gridDim.x) {
    const int s = i & 1;
    const long long next = tile + gridDim.x;
    if (t == 0 && next < n_bulk) {
      bulk_wait_read();   // the tile before this one has left stage s ^ 1
      issue(s ^ 1, next);
    }
    if (tile < n_bulk) {
      mbar_wait(&s_bar[s], (phase >> s) & 1u);
      phase ^= 1u << s;
      V* b = s_buf[s];
      fwd_cell<P, true>(b + 22 * t, b + kRi + 16 * t, b + kRi + kM + 16 * t,
                        b + kRi + kM + 16 * t);
      fence_async_shared();
      __syncthreads();
      if (t == 0) {
        bulk_store(y + tile * kM, b + kRi + kM, kM * sizeof(V));
        bulk_commit();
      }
    } else {
      const long long c = tile * kN + t;
      if (c < C) {
        fwd_cell<P, false>(ri + 22 * c, U + 16 * c, X + 16 * c, y + 16 * c);
      }
    }
  }
  if (t == 0) bulk_wait_all();
}

template <typename V, int P0, int P1, int P2, int P3>
__global__ void __launch_bounds__(Tile<V>::kCells)
wapply_bwd(const V* __restrict__ ri, const V* __restrict__ U,
           const V* __restrict__ X, const V* __restrict__ Yb,
           V* __restrict__ dri, V* __restrict__ dU, V* __restrict__ dX,
           long long C, int bulk) {
  using P = Perm<P0, P1, P2, P3>;
  constexpr int kN = Tile<V>::kCells;
  constexpr int kRi = 22 * kN, kM = 16 * kN, kStage = kRi + 3 * kM;
  __shared__ alignas(128) V s_buf[2][kStage];
  __shared__ alignas(8) uint64_t s_bar[2];
  const int t = threadIdx.x;
  const long long n_tiles = (C + kN - 1) / kN;
  const long long n_bulk = bulk ? C / kN : 0;
  if (t == 0) {
    mbar_init(&s_bar[0]);
    mbar_init(&s_bar[1]);
    mbar_init_fence();
  }
  __syncthreads();
  auto issue = [&](int s, long long tile) {
    V* b = s_buf[s];
    mbar_expect_tx(&s_bar[s], kStage * sizeof(V));
    bulk_load(b, ri + tile * kRi, kRi * sizeof(V), &s_bar[s]);
    bulk_load(b + kRi, U + tile * kM, kM * sizeof(V), &s_bar[s]);
    bulk_load(b + kRi + kM, X + tile * kM, kM * sizeof(V), &s_bar[s]);
    bulk_load(b + kRi + 2 * kM, Yb + tile * kM, kM * sizeof(V), &s_bar[s]);
  };
  long long tile = blockIdx.x;
  if (t == 0 && tile < n_bulk) issue(0, tile);
  uint32_t phase = 0;
  for (int i = 0; tile < n_tiles; ++i, tile += gridDim.x) {
    const int s = i & 1;
    const long long next = tile + gridDim.x;
    if (t == 0 && next < n_bulk) {
      bulk_wait_read();
      issue(s ^ 1, next);
    }
    if (tile < n_bulk) {
      mbar_wait(&s_bar[s], (phase >> s) & 1u);
      phase ^= 1u << s;
      V* b = s_buf[s];
      V* ri_s = b + 22 * t;
      V* u_s = b + kRi + 16 * t;
      V* x_s = b + kRi + kM + 16 * t;
      bwd_cell<P, true>(ri_s, u_s, x_s, b + kRi + 2 * kM + 16 * t,
                        dri != nullptr ? ri_s : nullptr,
                        dU != nullptr ? x_s : nullptr,
                        dX != nullptr ? u_s : nullptr);
      fence_async_shared();
      __syncthreads();
      if (t == 0) {
        if (dri != nullptr) bulk_store(dri + tile * kRi, b, kRi * sizeof(V));
        if (dX != nullptr) {
          bulk_store(dX + tile * kM, b + kRi, kM * sizeof(V));
        }
        if (dU != nullptr) {
          bulk_store(dU + tile * kM, b + kRi + kM, kM * sizeof(V));
        }
        bulk_commit();
      }
    } else {
      const long long c = tile * kN + t;
      if (c < C) {
        bwd_cell<P, false>(ri + 22 * c, U + 16 * c, X + 16 * c, Yb + 16 * c,
                           dri != nullptr ? dri + 22 * c : nullptr,
                           dU != nullptr ? dU + 16 * c : nullptr,
                           dX != nullptr ? dX + 16 * c : nullptr);
      }
    }
  }
  if (t == 0) bulk_wait_all();
}

// --- launch --------------------------------------------------------------

bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  }
  return true;
}

// Blocks of `kernel` that stay resident on the whole card (occupancy x
// SMs), computed at its first launch: the persistent grid's size.  The
// shared-memory carveout is set to its maximum first, since shared memory
// is what limits the blocks per SM.
template <typename Kernel>
int resident_blocks(Kernel kernel, int threads, int& cache) {
  if (cache > 0) return cache;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  cache = sms * (per_sm > 0 ? per_sm : 1);
  return cache;
}

template <typename V, int P0, int P1, int P2, int P3>
int launch_fwd_perm(const V* ri, const V* U, const V* X, V* y, long long C,
                    cudaStream_t stream) {
  static int resident = 0;
  constexpr int kN = Tile<V>::kCells;
  const auto kernel = wapply_fwd<V, P0, P1, P2, P3>;
  const long long tiles = (C + kN - 1) / kN;
  const long long grid = tiles < resident_blocks(kernel, kN, resident)
                             ? tiles : resident;
  kernel<<<static_cast<unsigned>(grid), kN, 0, stream>>>(
      ri, U, X, y, C, aligned16({ri, U, X, y}) ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename V, int P0, int P1, int P2, int P3>
int launch_bwd_perm(const V* ri, const V* U, const V* X, const V* Yb, V* dri,
                    V* dU, V* dX, long long C, cudaStream_t stream) {
  static int resident = 0;
  constexpr int kN = Tile<V>::kCells;
  const auto kernel = wapply_bwd<V, P0, P1, P2, P3>;
  const long long tiles = (C + kN - 1) / kN;
  const long long grid = tiles < resident_blocks(kernel, kN, resident)
                             ? tiles : resident;
  kernel<<<static_cast<unsigned>(grid), kN, 0, stream>>>(
      ri, U, X, Yb, dri, dU, dX, C,
      aligned16({ri, U, X, Yb, dri, dU, dX}) ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

// perm ids: 0 = (1, 2, 3, 4), 1 = (3, 4, 1, 2), 2 = (1, 3, 2, 4)
template <typename V>
int launch_fwd(const V* ri, const V* U, const V* X, V* y, int perm,
               long long C, void* stream) {
  if (C < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0) return static_cast<int>(cudaSuccess);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (perm) {
    case 0: return launch_fwd_perm<V, 1, 2, 3, 4>(ri, U, X, y, C, st);
    case 1: return launch_fwd_perm<V, 3, 4, 1, 2>(ri, U, X, y, C, st);
    case 2: return launch_fwd_perm<V, 1, 3, 2, 4>(ri, U, X, y, C, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename V>
int launch_bwd(const V* ri, const V* U, const V* X, const V* Yb, V* dri,
               V* dU, V* dX, int perm, long long C, void* stream) {
  if (C < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0) return static_cast<int>(cudaSuccess);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (perm) {
    case 0:
      return launch_bwd_perm<V, 1, 2, 3, 4>(ri, U, X, Yb, dri, dU, dX, C, st);
    case 1:
      return launch_bwd_perm<V, 3, 4, 1, 2>(ri, U, X, Yb, dri, dU, dX, C, st);
    case 2:
      return launch_bwd_perm<V, 1, 3, 2, 4>(ri, U, X, Yb, dri, dU, dX, C, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// ri: (C, 22); U, X, y, Yb, dU, dX: (C, 4, 4); dri: (C, 22); all contiguous
// and of one type, any alignment (16-byte-aligned pointers take the bulk
// copies).  dri, dU and dX may be null.  perm: 0 = (1, 2, 3, 4), 1 =
// (3, 4, 1, 2), 2 = (1, 3, 2, 4).  Launch on `stream`; return
// cudaGetLastError() (or cudaErrorInvalidValue for another perm id or a
// negative C).
extern "C" int wapply_fwd_f32(const float* ri, const float* U, const float* X,
                              float* y, int perm, long long C, void* stream) {
  return launch_fwd(ri, U, X, y, perm, C, stream);
}

extern "C" int wapply_fwd_f64(const double* ri, const double* U,
                              const double* X, double* y, int perm,
                              long long C, void* stream) {
  return launch_fwd(ri, U, X, y, perm, C, stream);
}

extern "C" int wapply_bwd_f32(const float* ri, const float* U, const float* X,
                              const float* Yb, float* dri, float* dU,
                              float* dX, int perm, long long C, void* stream) {
  return launch_bwd(ri, U, X, Yb, dri, dU, dX, perm, C, stream);
}

extern "C" int wapply_bwd_f64(const double* ri, const double* U,
                              const double* X, const double* Yb, double* dri,
                              double* dU, double* dX, int perm, long long C,
                              void* stream) {
  return launch_bwd(ri, U, X, Yb, dri, dU, dX, perm, C, stream);
}
