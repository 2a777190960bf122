// Element-block passes for Hopper (sm_90a): freeze, tangent action,
// internal force and f64 residual of the mixed-precision Newton path on an
// unstructured tetrahedral mesh (any mesh without a Kuhn-lattice
// BoxStructure).
//
// Replaces the four element-block Pallas TPU kernels:
//   fea_elem_apply_f32   <- pallas_kernels.py::_apply_kernel        (B6)
//   fea_elem_freeze_f32  <- pallas_kernels.py::_freeze_kernel       (B7)
//   fea_elem_force_f32   <- pallas_kernels.py::_force_kernel        (B8)
//   fea_elem_resid_f64   <- pallas_residual.py::_resid_kernel_unstr (B9)
// (files under fea_large_tpu/ops/). Each computes what its TPU kernel
// computes; the plain PyTorch versions sit beside the wrappers in
// fea_large_tpu_torch/ops/elem_kernels.py. B9 runs in native f64 where the
// TPU kernel splits every operand into (hi, lo) f32 pairs.
//
// Layout (kept from the reference): every operand is [rows, E], E elements,
// element axis last. Gathered nodal values ve/ue rows 3a + i, geometry
// gradN rows (k*npe + a)*3 + J and detJxW rows k, state rows k*9 + 3i + j,
// per-point scalars rows k, outputs rows i*npe + a. As on the TPU, the
// gather of nodal values (v[conn]) and the nodal scatter stay outside the
// kernels, in PyTorch (ops/soa.py).
//
// ONE THREAD PER ELEMENT e, blocks of `block` threads (a launch parameter,
// a multiple of 32 up to 256): a warp reads 32 neighbouring addresses of
// every row, so every load and store is coalesced. The grid is
// ceil(E/block) and the kernel masks the ragged last block itself.
//
// Accumulation: the 3*npe outputs of an element live in registers and are
// summed in a fixed (k, a, J) order; no atomics, bitwise deterministic.
//
// What bounds them on this card: memory traffic. Unlike the lattice
// kernels, the geometry is not shared between elements: every element
// streams its own gradN (q*npe*3 = 120 rows for TET10) and detJxW. Per
// TET10 element B6 reads 30 + 120 + 4 + 3*36 + 2*4 rows and writes 30
// (300 rows, 280 MB per call at E = 233,280), B7 reads 150 and writes 116
// (266 rows, 248 MB), B8 reads 120 + 4 + 2*36 and writes 30 (226 rows,
// 211 MB), against ~0.5-1 kFLOP of f32 arithmetic per element-point. B9
// reads 30 + 120 + 4 and writes 30 rows of f64 (184 rows, 343 MB) against
// ~0.6 kFLOP of f64 per element-point: it writes no state, where the
// two-pass f64 residual writes F and S and reads them back. The design
// reads each operand exactly once and keeps every temporary in registers
// (B9 keeps 30 nodal values and 30 accumulators in double; ptxas reports
// its registers and spills in the build log).

#include <cuda_runtime.h>

#include "material_point.cuh"

namespace {

using fea::material_point;
using fea::right_cauchy_green;

constexpr int kMaxBlock = 256;

// The 3*npe gathered nodal values of element e: v[a][i] = rows 3a + i.
template <int NPE, typename T>
__device__ __forceinline__ void load_nodal(const T* __restrict__ rows, size_t E, int e,
                                           T v[NPE][3]) {
#pragma unroll
  for (int a = 0; a < NPE; ++a)
#pragma unroll
    for (int i = 0; i < 3; ++i) v[a][i] = rows[(size_t)(3 * a + i) * E + e];
}

// The shape-function gradients of element e at point k: g[a][J].
template <int NPE, typename T>
__device__ __forceinline__ void load_grad(const T* __restrict__ gN, int k, size_t E, int e,
                                          T g[NPE][3]) {
#pragma unroll
  for (int a = 0; a < NPE; ++a)
#pragma unroll
    for (int J = 0; J < 3; ++J) g[a][J] = gN[(size_t)((k * NPE + a) * 3 + J) * E + e];
}

// G[i][J] = sum_a v[a][i] g[a][J]
template <int NPE, typename T>
__device__ __forceinline__ void nodal_grad(const T v[NPE][3], const T g[NPE][3], T G[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int J = 0; J < 3; ++J) {
      T s = T(0);
#pragma unroll
      for (int a = 0; a < NPE; ++a) s += v[a][i] * g[a][J];
      G[i][J] = s;
    }
}

// acc[i][a] += sum_J PV[i][J] g[a][J]
template <int NPE, typename T>
__device__ __forceinline__ void add_nodal(const T PV[3][3], const T g[NPE][3],
                                          T acc[3][NPE]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int a = 0; a < NPE; ++a)
      acc[i][a] += PV[i][0] * g[a][0] + PV[i][1] * g[a][1] + PV[i][2] * g[a][2];
}

__device__ __forceinline__ void load3(const float* __restrict__ buf, int k, size_t E, int e,
                                      float M[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) M[i][j] = buf[(size_t)(k * 9 + 3 * i + j) * E + e];
}

__device__ __forceinline__ void store3(float* __restrict__ buf, int k, size_t E, int e,
                                       const float M[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) buf[(size_t)(k * 9 + 3 * i + j) * E + e] = M[i][j];
}

template <int NPE, typename T>
__device__ __forceinline__ void store_out(T* __restrict__ out, size_t E, int e,
                                          const T acc[3][NPE]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int a = 0; a < NPE; ++a) out[(size_t)(i * NPE + a) * E + e] = acc[i][a];
}

// ---------------------------------------------------------------------------
// B7 freeze: F = I + sum_a u_a (x) g_a, C = F^T F, and the material state
// (S, A, alpha, beta) of kind 0 SVK, 1 neo-Hookean Ciarlet, 2 neo-Hookean
// volumetric. Replaces pallas_kernels.py::_freeze_kernel.
// ---------------------------------------------------------------------------
template <int Q, int NPE>
__global__ void __launch_bounds__(kMaxBlock)
freeze_kernel(const float* __restrict__ ue, const float* __restrict__ gN,
              float* __restrict__ Fo, float* __restrict__ So, float* __restrict__ Ao,
              float* __restrict__ alo, float* __restrict__ beo, int E, int kind, float lam,
              float mu) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const size_t Es = E;
  float u[NPE][3];
  load_nodal<NPE>(ue, Es, e, u);
#pragma unroll 1
  for (int k = 0; k < Q; ++k) {
    float g[NPE][3], F[3][3], Cm[3][3], S[3][3], A[3][3], alpha, beta;
    load_grad<NPE>(gN, k, Es, e, g);
    nodal_grad<NPE>(u, g, F);
#pragma unroll
    for (int i = 0; i < 3; ++i) F[i][i] += 1.f;
    right_cauchy_green(F, Cm);
    material_point(kind, lam, mu, Cm, S, A, alpha, beta);
    store3(Fo, k, Es, e, F);
    store3(So, k, Es, e, S);
    store3(Ao, k, Es, e, A);
    alo[(size_t)k * Es + e] = alpha;
    beo[(size_t)k * Es + e] = beta;
  }
}

// ---------------------------------------------------------------------------
// B6 tangent action: dF = sum_a v_a (x) g_a, dE = sym(F^T dF),
// dS = alpha (A:dE) A + beta A dE A, dP = dF S + F dS; out[i][a] =
// sum_q V dP_iJ g_a[J]. Replaces pallas_kernels.py::_apply_kernel.
// ---------------------------------------------------------------------------
template <int Q, int NPE>
__global__ void __launch_bounds__(kMaxBlock)
apply_kernel(const float* __restrict__ ve, const float* __restrict__ gN,
             const float* __restrict__ dV, const float* __restrict__ Fb,
             const float* __restrict__ Sb, const float* __restrict__ Ab,
             const float* __restrict__ alb, const float* __restrict__ beb,
             float* __restrict__ out, int E) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const size_t Es = E;
  float v[NPE][3], acc[3][NPE];
  load_nodal<NPE>(ve, Es, e, v);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int a = 0; a < NPE; ++a) acc[i][a] = 0.f;
#pragma unroll 1
  for (int k = 0; k < Q; ++k) {
    float g[NPE][3], F[3][3], S[3][3], A[3][3], dF[3][3];
    load_grad<NPE>(gN, k, Es, e, g);
    load3(Fb, k, Es, e, F);
    load3(Sb, k, Es, e, S);
    load3(Ab, k, Es, e, A);
    const float al = alb[(size_t)k * Es + e];
    const float be = beb[(size_t)k * Es + e];
    const float V = dV[(size_t)k * Es + e];
    nodal_grad<NPE>(v, g, dF);
    float dE[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float fij = F[0][i] * dF[0][j] + F[1][i] * dF[1][j] + F[2][i] * dF[2][j];
        const float fji = F[0][j] * dF[0][i] + F[1][j] * dF[1][i] + F[2][j] * dF[2][i];
        dE[i][j] = 0.5f * (fij + fji);
      }
    float AdE = 0.f;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) AdE += A[i][j] * dE[i][j];
    float AdEr[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        AdEr[i][j] = A[i][0] * dE[0][j] + A[i][1] * dE[1][j] + A[i][2] * dE[2][j];
    float dS[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float adea = AdEr[i][0] * A[0][j] + AdEr[i][1] * A[1][j] + AdEr[i][2] * A[2][j];
        dS[i][j] = al * AdE * A[i][j] + be * adea;
      }
    float dPV[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int J = 0; J < 3; ++J)
        dPV[i][J] = (dF[i][0] * S[0][J] + dF[i][1] * S[1][J] + dF[i][2] * S[2][J] +
                     F[i][0] * dS[0][J] + F[i][1] * dS[1][J] + F[i][2] * dS[2][J]) * V;
    add_nodal<NPE>(dPV, g, acc);
  }
  store_out<NPE>(out, Es, e, acc);
}

// ---------------------------------------------------------------------------
// B8 internal force from the frozen state: out[i][a] = sum_q V (F S)_iJ
// g_a[J]. Replaces pallas_kernels.py::_force_kernel.
// ---------------------------------------------------------------------------
template <int Q, int NPE>
__global__ void __launch_bounds__(kMaxBlock)
force_kernel(const float* __restrict__ gN, const float* __restrict__ dV,
             const float* __restrict__ Fb, const float* __restrict__ Sb,
             float* __restrict__ out, int E) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const size_t Es = E;
  float acc[3][NPE];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int a = 0; a < NPE; ++a) acc[i][a] = 0.f;
#pragma unroll 1
  for (int k = 0; k < Q; ++k) {
    float g[NPE][3], F[3][3], S[3][3], PV[3][3];
    load_grad<NPE>(gN, k, Es, e, g);
    load3(Fb, k, Es, e, F);
    load3(Sb, k, Es, e, S);
    const float V = dV[(size_t)k * Es + e];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int J = 0; J < 3; ++J)
        PV[i][J] = (F[i][0] * S[0][J] + F[i][1] * S[1][J] + F[i][2] * S[2][J]) * V;
    add_nodal<NPE>(PV, g, acc);
  }
  store_out<NPE>(out, Es, e, acc);
}

// ---------------------------------------------------------------------------
// B9 f64 residual: F = I + sum_a u_a (x) g_a, C = F^T F, S(C), and
// out[i][a] = sum_q V (F S)_iJ g_a[J], in one pass with no state written.
// Replaces pallas_residual.py::_resid_kernel_unstr.
// ---------------------------------------------------------------------------
template <int Q, int NPE>
__global__ void __launch_bounds__(kMaxBlock)
resid_kernel(const double* __restrict__ ue, const double* __restrict__ gN,
             const double* __restrict__ dV, double* __restrict__ out, int E, int kind,
             double lam, double mu) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const size_t Es = E;
  double u[NPE][3], acc[3][NPE];
  load_nodal<NPE>(ue, Es, e, u);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int a = 0; a < NPE; ++a) acc[i][a] = 0.0;
#pragma unroll 1
  for (int k = 0; k < Q; ++k) {
    double g[NPE][3], F[3][3], Cm[3][3], S[3][3], A[3][3], PV[3][3], alpha, beta;
    load_grad<NPE>(gN, k, Es, e, g);
    nodal_grad<NPE>(u, g, F);
#pragma unroll
    for (int i = 0; i < 3; ++i) F[i][i] += 1.0;
    right_cauchy_green(F, Cm);
    material_point(kind, lam, mu, Cm, S, A, alpha, beta);
    const double V = dV[(size_t)k * Es + e];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int J = 0; J < 3; ++J)
        PV[i][J] = (F[i][0] * S[0][J] + F[i][1] * S[1][J] + F[i][2] * S[2][J]) * V;
    add_nodal<NPE>(PV, g, acc);
  }
  store_out<NPE>(out, Es, e, acc);
}

inline bool bad_launch(int E, int block) {
  return E <= 0 || block <= 0 || block > kMaxBlock || block % 32 != 0;
}

inline unsigned grid_for(int E, int block) { return (unsigned)((E + block - 1) / block); }

}  // namespace

// Instantiated elements: (Q, NPE) = (4, 10) TET10 with the 4-point rule and
// (1, 4) TET4 with the 1-point rule.
#define FEA_ELEM_DISPATCH(q, npe, ...)                 \
  do {                                                 \
    if ((q) == 4 && (npe) == 10) {                     \
      constexpr int kQ = 4, kNPE = 10;                 \
      __VA_ARGS__;                                     \
    } else if ((q) == 1 && (npe) == 4) {               \
      constexpr int kQ = 1, kNPE = 4;                  \
      __VA_ARGS__;                                     \
    } else {                                           \
      return (int)cudaErrorInvalidValue;               \
    }                                                  \
  } while (0)

// Plain C interface (loaded with ctypes). Each entry launches on `stream`,
// does not synchronise, and returns cudaGetLastError() after the launch.
extern "C" {

int fea_elem_freeze_f32(const float* ue, const float* gN, float* F, float* S, float* A,
                        float* alpha, float* beta, int E, int q, int npe, int block, int kind,
                        float lam, float mu, void* stream) {
  if (bad_launch(E, block) || kind < 0 || kind > 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FEA_ELEM_DISPATCH(q, npe,
                    freeze_kernel<kQ, kNPE><<<grid_for(E, block), block, 0, s>>>(
                        ue, gN, F, S, A, alpha, beta, E, kind, lam, mu));
  return (int)cudaGetLastError();
}

int fea_elem_apply_f32(const float* ve, const float* gN, const float* dV, const float* F,
                       const float* S, const float* A, const float* alpha, const float* beta,
                       float* out, int E, int q, int npe, int block, void* stream) {
  if (bad_launch(E, block)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FEA_ELEM_DISPATCH(q, npe,
                    apply_kernel<kQ, kNPE><<<grid_for(E, block), block, 0, s>>>(
                        ve, gN, dV, F, S, A, alpha, beta, out, E));
  return (int)cudaGetLastError();
}

int fea_elem_force_f32(const float* gN, const float* dV, const float* F, const float* S,
                       float* out, int E, int q, int npe, int block, void* stream) {
  if (bad_launch(E, block)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FEA_ELEM_DISPATCH(q, npe,
                    force_kernel<kQ, kNPE><<<grid_for(E, block), block, 0, s>>>(
                        gN, dV, F, S, out, E));
  return (int)cudaGetLastError();
}

int fea_elem_resid_f64(const double* ue, const double* gN, const double* dV, double* out,
                       int E, int q, int npe, int block, int kind, double lam, double mu,
                       void* stream) {
  if (bad_launch(E, block) || kind < 0 || kind > 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FEA_ELEM_DISPATCH(q, npe,
                    resid_kernel<kQ, kNPE><<<grid_for(E, block), block, 0, s>>>(
                        ue, gN, dV, out, E, kind, lam, mu));
  return (int)cudaGetLastError();
}

}  // extern "C"
