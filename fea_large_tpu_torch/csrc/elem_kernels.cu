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
// TPU kernel splits every operand into (hi, lo) f32 pairs. Three more
// kernels replace no TPU kernel (see there): fea_elem_diag_f32 and
// fea_elem_diag_sum_f32 form the block-Jacobi diagonal of an unstructured
// mesh, and fea_elem_nodal_sum_f32/_f64 is the fixed-order nodal sum of
// every element pass's output.
//
// Layout (kept from the reference): every operand is [rows, E], E elements,
// element axis last. Gathered nodal values ue rows 3a + i, geometry gradN
// rows (k*npe + a)*3 + J and detJxW rows k, state rows k*9 + 3i + j,
// per-point scalars rows k, outputs rows i*npe + a. B6 gathers its nodal
// values itself, from the nodal vector v [3, N] at the int32 connectivity
// conn [npe, E]; B7 and B9 take them gathered (ops/soa.py). The nodal sums
// walk a compact table of each node's element slots (`nodal_sum_kernel`),
// where the TPU sums through padded valence buckets in XLA.
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
// TET10 element B6 reads 10 conn rows (int32), 120 + 4 + 3*36 + 2*4 rows
// and 30 nodal values, which neighbouring elements share in L2 (v is 4.1 MB
// at 1M DOF), and writes 30 (265 MB per call at E = 233,280; 280 MB with
// the values gathered before it, as the yardstick counts), B7 reads 150
// and writes 116 (266 rows, 248 MB), B8 reads 120 + 4 + 2*36 and writes 30 (226 rows,
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

// The 3*npe nodal values of element e gathered from v [3, N] at its nodes
// conn[a][e] (int32 [npe, E]): the conn reads are coalesced along e, the
// values are read where the nodes lie (neighbouring elements share nodes).
template <int NPE>
__device__ __forceinline__ void gather_nodal(const float* __restrict__ v,
                                             const int* __restrict__ conn, size_t N, size_t E,
                                             int e, float out[NPE][3]) {
#pragma unroll
  for (int a = 0; a < NPE; ++a) {
    const size_t n = (size_t)conn[(size_t)a * E + e];
#pragma unroll
    for (int i = 0; i < 3; ++i) out[a][i] = v[(size_t)i * N + n];
  }
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
// B6 tangent action: v_a = v[:, conn[a][e]] (the gather, in the kernel),
// dF = sum_a v_a (x) g_a, dE = sym(F^T dF), dS = alpha (A:dE) A + beta A dE
// A, dP = dF S + F dS; out[i][a] = sum_q V dP_iJ g_a[J]. Replaces
// pallas_kernels.py::_apply_kernel and the gather before it.
// ---------------------------------------------------------------------------
template <int Q, int NPE>
__global__ void __launch_bounds__(kMaxBlock)
apply_kernel(const float* __restrict__ vn, const int* __restrict__ conn,
             const float* __restrict__ gN, const float* __restrict__ dV,
             const float* __restrict__ Fb, const float* __restrict__ Sb,
             const float* __restrict__ Ab, const float* __restrict__ alb,
             const float* __restrict__ beb, float* __restrict__ out, int E, int N) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const size_t Es = E;
  float v[NPE][3], acc[3][NPE];
  gather_nodal<NPE>(vn, conn, (size_t)N, Es, e, v);
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

// ---------------------------------------------------------------------------
// Block-Jacobi diagonal of an unstructured mesh, in two kernels: the element
// pass (diag_kernel) and the fixed-order nodal sum (diag_sum_kernel). They
// replace no TPU kernel: the reference forms this diagonal in plain jnp on
// unstructured meshes (its lattice counterpart is B3, csrc/struct_kernels.cu).
// They were added because the plain PyTorch pass, which broadcasts
// [q, E, npe, 3, 3] temporaries (336 MB each at 1M DOF), took ~6.3 ms of
// every Newton head's ~7.6 ms on the 1M-DOF TET10 box, ~50x its bytes bound.
//
// diag_kernel: sum_q V [(alpha + beta/2) s_a s_a^T + (beta/2) B G_aa
// + (g_a.S.g_a) I], FA = F A, B = FA F^T, s_a = FA g_a, G_aa = g_a.A.g_a
// (B3's math on B6's layout). ONE THREAD PER ELEMENT, as B6: every operand
// row is read once, coalesced along the element axis. Every nodal block is
// symmetric (s s^T, B = F A F^T with A symmetric, a multiple of I), so the
// thread sums only the npe x 6 upper-triangle entries over the q points in
// registers and touches no output inside the point loop. It then writes
// each slot's six sums, padded to 8 floats (one 32-byte sector, two 16-byte
// stores), at the flat a-major slot a*E + e that the valence buckets index
// (ops/soa.py ScatterBuckets): a warp's stores are one contiguous run per
// a. Bytes per TET10 element (q = 4): F, S, A 108 rows, alpha and beta 8,
// gradN 120 and detJxW 4 read (960 B), 10 x 32 B written: 224 MB + 75 MB at
// E = 233,280, 0.089 ms at 3.35 TB/s, against ~0.3 GFLOP (0.005 ms at 67
// TFLOP/s): bound by bytes. The launch bounds (blocks of at most 128, four
// a SM) hold it to 128 registers, no spill; at five a SM (96) it spills and
// is slower. On the H100 the reads alone run at 93% of the rate; the
// writes, a quarter of the bytes, hold the pass to ~62% of its bound.
//
// diag_sum_kernel: ONE THREAD PER NODE n, walking the node's slots in the
// nodal sums' table (`nodal_sum_kernel`, below): it sums their sectors in
// the table's order, then mirrors the upper triangle into the [3, 3, N]
// blocks, rows 3i + k, coalesced along n. No atomics: two launches are
// bitwise equal. Bytes: the table's offsets and slot ids (4 B each), one
// 32-byte sector per slot and the 36-byte block per node: ~0.1 GB at 1M
// DOF. Bound by bytes; its sector reads are gathers.
// ---------------------------------------------------------------------------
constexpr int kSlotPad = 8;
constexpr int kDiagBlock = 128;  // the element pass's largest block

__host__ __device__ constexpr int sym_index(int i, int k) {  // of the row-major upper triangle
  return i <= k ? 3 * i - i * (i - 1) / 2 + k - i : 3 * k - k * (k - 1) / 2 + i - k;
}

template <int Q, int NPE>
__global__ void __launch_bounds__(kDiagBlock, 4)
diag_kernel(const float* __restrict__ gN, const float* __restrict__ dV,
            const float* __restrict__ Fb, const float* __restrict__ Sb,
            const float* __restrict__ Ab, const float* __restrict__ alb,
            const float* __restrict__ beb, float* __restrict__ slots, int E) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const size_t Es = E;
  float acc[NPE][6];
#pragma unroll
  for (int a = 0; a < NPE; ++a)
#pragma unroll
    for (int c = 0; c < 6; ++c) acc[a][c] = 0.f;
#pragma unroll 1
  for (int k = 0; k < Q; ++k) {
    float F[3][3], S[3][3], A[3][3];
    load3(Fb, k, Es, e, F);
    load3(Sb, k, Es, e, S);
    load3(Ab, k, Es, e, A);
    const float al = alb[(size_t)k * Es + e];
    const float be = beb[(size_t)k * Es + e];
    const float V = dV[(size_t)k * Es + e];
    const float w1 = (al + 0.5f * be) * V;
    const float w2 = 0.5f * be * V;
    float FA[3][3], w2B[6];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        FA[i][j] = F[i][0] * A[0][j] + F[i][1] * A[1][j] + F[i][2] * A[2][j];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = i; j < 3; ++j)
        w2B[sym_index(i, j)] = w2 * (FA[i][0] * F[j][0] + FA[i][1] * F[j][1] + FA[i][2] * F[j][2]);
#pragma unroll
    for (int a = 0; a < NPE; ++a) {
      float g[3];
#pragma unroll
      for (int J = 0; J < 3; ++J) g[J] = gN[(size_t)((k * NPE + a) * 3 + J) * Es + e];
      float s[3], Ag[3], Sg[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        s[i] = FA[i][0] * g[0] + FA[i][1] * g[1] + FA[i][2] * g[2];
        Ag[i] = A[i][0] * g[0] + A[i][1] * g[1] + A[i][2] * g[2];
        Sg[i] = S[i][0] * g[0] + S[i][1] * g[1] + S[i][2] * g[2];
      }
      const float Gaa = g[0] * Ag[0] + g[1] * Ag[1] + g[2] * Ag[2];
      const float geo = V * (g[0] * Sg[0] + g[1] * Sg[1] + g[2] * Sg[2]);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float w1s = w1 * s[i];
#pragma unroll
        for (int kk = i; kk < 3; ++kk) {
          float term = w1s * s[kk] + w2B[sym_index(i, kk)] * Gaa;
          if (i == kk) term += geo;
          acc[a][sym_index(i, kk)] += term;
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < NPE; ++a) {
    float4* dst = reinterpret_cast<float4*>(slots + ((size_t)a * Es + e) * kSlotPad);
    dst[0] = make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
    dst[1] = make_float4(acc[a][4], acc[a][5], 0.f, 0.f);
  }
}

__global__ void __launch_bounds__(kMaxBlock)
diag_sum_kernel(const float* __restrict__ slots, const int* __restrict__ offsets,
                const int* __restrict__ ids, float* __restrict__ out, int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const int end = offsets[n + 1];
  for (int j = offsets[n]; j < end; ++j) {
    const float4* src = reinterpret_cast<const float4*>(slots + (size_t)ids[j] * kSlotPad);
    const float4 lo = src[0], hi = src[1];
    acc[0] += lo.x;
    acc[1] += lo.y;
    acc[2] += lo.z;
    acc[3] += lo.w;
    acc[4] += hi.x;
    acc[5] += hi.y;
  }
  const size_t Ns = N;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int kk = 0; kk < 3; ++kk) out[(size_t)(3 * i + kk) * Ns + n] = acc[sym_index(i, kk)];
}

// ---------------------------------------------------------------------------
// The fixed-order nodal sum of an element pass's output (no TPU kernel: the
// reference sums through padded valence buckets in XLA, ScatterBuckets in
// ops/soa.py, and so did the port in plain PyTorch before this kernel): C
// channels of per-slot values d [C, M], M = npe*E flat a-major slots
// a*E + e, into nodal sums out [C, N]. The table (ScatterBuckets.csr) lists
// each node's slots, offsets [N + 1] and slot ids, int32, in the order of
// the node's bucket row, padding left out.
//
// ONE THREAD PER NODE n: it walks slots offsets[n] .. offsets[n + 1] in that
// order, sums the C channels in registers and writes out[c][n] once,
// coalesced along n. No atomics and no index_add_: two launches are bitwise
// equal. Every f32 output of B6 and B8, every f64 output of B9 and of the
// plain f64 passes is summed here. Bytes at 1M DOF (TET10, E = 233,280, N =
// 342,361, C = 3, f32): d 28.0 MB read once, the slot ids 9.3 MB and offsets
// 1.4 MB, out 4.1 MB: 42.8 MB, 0.0128 ms at 3.35 TB/s. The d reads are
// gathers: a node's slots lie E apart for its different a, and a warp's 32
// nodes touch neighbouring elements, so a 32-byte sector serves several of
// them through L1 (and d, just written by B6, partly sits in L2).
// ---------------------------------------------------------------------------
template <typename T, int C>
__global__ void __launch_bounds__(kMaxBlock)
nodal_sum_kernel(const T* __restrict__ d, const int* __restrict__ offsets,
                 const int* __restrict__ ids, T* __restrict__ out, int M, int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  T acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = T(0);
  const size_t Ms = M;
  const int end = offsets[n + 1];
  for (int j = offsets[n]; j < end; ++j) {
    const size_t s = (size_t)ids[j];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] += d[c * Ms + s];
  }
  const size_t Ns = N;
#pragma unroll
  for (int c = 0; c < C; ++c) out[c * Ns + n] = acc[c];
}

inline bool bad_launch(int E, int block) {
  return E <= 0 || block <= 0 || block > kMaxBlock || block % 32 != 0;
}

inline unsigned grid_for(int E, int block) { return (unsigned)((E + block - 1) / block); }

}  // namespace

// Instantiated elements: (Q, NPE) = (4, 10) TET10 with the 4-point rule,
// (5, 10) TET10 with the 5-point rule and (1, 4) TET4 with the 1-point rule.
#define FEA_ELEM_DISPATCH(q, npe, ...)                 \
  do {                                                 \
    if ((q) == 4 && (npe) == 10) {                     \
      constexpr int kQ = 4, kNPE = 10;                 \
      __VA_ARGS__;                                     \
    } else if ((q) == 5 && (npe) == 10) {              \
      constexpr int kQ = 5, kNPE = 10;                 \
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

int fea_elem_apply_f32(const float* v, const int* conn, const float* gN, const float* dV,
                       const float* F, const float* S, const float* A, const float* alpha,
                       const float* beta, float* out, int E, int N, int q, int npe, int block,
                       void* stream) {
  if (bad_launch(E, block) || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FEA_ELEM_DISPATCH(q, npe,
                    apply_kernel<kQ, kNPE><<<grid_for(E, block), block, 0, s>>>(
                        v, conn, gN, dV, F, S, A, alpha, beta, out, E, N));
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

int fea_elem_diag_f32(const float* gN, const float* dV, const float* F, const float* S,
                      const float* A, const float* alpha, const float* beta, float* slots, int E,
                      int q, int npe, int block, void* stream) {
  if (bad_launch(E, block) || block > kDiagBlock) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FEA_ELEM_DISPATCH(q, npe,
                    diag_kernel<kQ, kNPE><<<grid_for(E, block), block, 0, s>>>(
                        gN, dV, F, S, A, alpha, beta, slots, E));
  return (int)cudaGetLastError();
}

int fea_elem_diag_sum_f32(const float* slots, const int* offsets, const int* ids, float* out,
                          int N, int block, void* stream) {
  if (bad_launch(N, block)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  diag_sum_kernel<<<grid_for(N, block), block, 0, s>>>(slots, offsets, ids, out, N);
  return (int)cudaGetLastError();
}

// The nodal sum of C = 3 channels (the nodal force and tangent action).
int fea_elem_nodal_sum_f32(const float* d, const int* offsets, const int* ids, float* out,
                           int C, int M, int N, int block, void* stream) {
  if (bad_launch(N, block) || M <= 0 || C != 3) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  nodal_sum_kernel<float, 3><<<grid_for(N, block), block, 0, s>>>(d, offsets, ids, out, M, N);
  return (int)cudaGetLastError();
}

int fea_elem_nodal_sum_f64(const double* d, const int* offsets, const int* ids, double* out,
                           int C, int M, int N, int block, void* stream) {
  if (bad_launch(N, block) || M <= 0 || C != 3) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  nodal_sum_kernel<double, 3><<<grid_for(N, block), block, 0, s>>>(d, offsets, ids, out, M, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
