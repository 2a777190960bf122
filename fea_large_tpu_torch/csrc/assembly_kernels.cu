// The f64 assembly of the global BCSR stiffness for Hopper (sm_90a): the
// element pass and the slot sum of assembly/bcsr.py::assemble_bcsr.
//
// Replaces no TPU kernel: the reference forms the element stiffness and
// sums it into the BCSR slots in plain jnp (fea_large_tpu/elements/
// kernels.py element_stiffness, fea_large_tpu/assembly/bcsr.py
// assemble_bcsr), and so did the port in plain PyTorch before these
// kernels: broadcast [E, npe, 3, npe, 3] temporaries and padded bucket sums,
// ~39 ms an assembly on the 1M-DOF TET10 box, where its least traffic takes
// 0.27 ms. The plain versions, in the same layout and summation order, sit
// beside the wrapper in fea_large_tpu_torch/ops/assembly_kernels.py.
//
// Layout: u [N, 3], conn int32 [E, npe], gradN [E, q, npe, 3] and detJxW
// [E, q] (ElementGeometry, element axis first: one element's geometry is
// contiguous). The element pass writes, per element, its P = npe(npe+1)/2
// upper blocks Ke[a, :, b, :] with a <= b in the row-major order of (a, b),
// blocks [E, P, 9] (rows i*3 + k), and its force fe [3, E*npe] at the flat
// e-major slots e*npe + a that the nodal sum's table (NodeScatter) indexes.
// The stiffness is symmetric, Ke[a,i,b,k] = Ke[b,k,a,i], so a block with
// a > b is the stored (b, a) block transposed.
//
// stiffness_kernel<Q, NPE>: a block of EPB elements (4 for TET10 with the
// 4-point rule) and EPB * P threads, one a (element, stored block). In
// shared memory, phase by phase behind __syncthreads():
//   0. the elements' gradN and detJxW (contiguous rows, coalesced) and the
//      nodal values u at conn, gathered by the kernel itself (as B6 does);
//   1. a thread a (element, point): F = I + sum_a u_a (x) g_a, C = F^T F,
//      material_point (kinds 0-2), FA = F A, B = FA F^T, V F S, V alpha,
//      V beta / 2;
//   2. a thread a (element, point, node b): s_b = FA g_b, A g_b, S g_b;
//   3. a thread a (element, block (a, b)): 9 accumulators summed over the
//      points in order, with G_ab = g_a.A.g_b and Gs_ab = g_a.S.g_b,
//        Ke[a,i,b,k] = sum_q V [alpha s_ai s_bk + beta/2 (B_ik G_ab
//                               + s_ak s_bi) + Gs_ab delta_ik],
//      and a thread a (element, node, component) the force sum_q (V F S) g_a;
//   4. the blocks through a shared tile to one contiguous, coalesced store.
// About 5.4 KB of shared memory an element (static, under 48 KB a block).
// The block's phases alternate between loads, arithmetic and stores, so
// several blocks an SM keep its memory busy: measured at full width (H100
// 80GB HBM3, 700 W; PERF.md), 4 TET10 elements a block and five an SM (launch
// bounds: 56 registers, a few spilled) took 0.79 ms, 8 elements and two
// blocks 0.90 ms, 4 and four 0.83, 4 and six (heavy spills) 1.58. The
// 5-point rule takes 6 elements a block, TET4 32, two blocks an SM.
//
// What bounds it: bytes. Per TET10 element it reads 124 f64 of geometry
// and 10 int32, and writes 55 blocks of 72 B and 30 force values; with u
// read once, 1.23 GB at E = 233,280, 0.37 ms at 3.35 TB/s, against ~24
// kFLOP of f64 an element as written (5.6 GFLOP, 0.17 ms at 34 TFLOP/s).
// Storing only the upper blocks halves both the arithmetic and the
// written bytes of the full [E, npe, 3, npe, 3] stiffness.
//
// slot_sum_kernel: ONE THREAD PER BCSR SLOT s. It walks the slot's entries
// codes[offsets[s] .. offsets[s + 1]] in the plain path's (e, a, b) order
// (BCSRStructure.perm), each a stored block (code >> 1), read transposed
// where code & 1, and sums the 9 values in registers in that order; then
// the block's tile of slots goes to data [nnzb, 9] in one coalesced store.
// No atomics: two launches are bitwise equal. Bytes at 1M DOF: the 12.8M
// stored blocks read (924 MB), the 23.3M codes (93 MB) and offsets (37 MB)
// read, 9.18M blocks written (661 MB): 1.72 GB, 0.51 ms at 3.35 TB/s. The
// block reads are gathers, but a warp's slots lie in one or two block rows
// (a node), whose entries come from the few tets around that node: their
// blocks share sectors in L1 and L2. A diagonal slot has one entry a tet
// around its node, the others one to six, so a warp waits for its longest
// slot; blocks of one warp measured fastest (0.93 ms, against 1.07 with
// blocks of 64 threads, 1.13 with 128 and 1.19 with 256; H100 80GB HBM3).

#include <cuda_runtime.h>

#include "material_point.cuh"

namespace {

using fea::material_point;
using fea::right_cauchy_green;

// per point in shared memory: FA 9, A 9, S 9, B 6 (upper triangle), V F S
// 9, V alpha, V beta / 2, V
constexpr int kPoint = 45;
constexpr int kFA = 0, kA = 9, kS = 18, kB = 27, kPV = 33, kWa = 42, kWb = 43, kVol = 44;
// per (point, node): s = FA g, A g, S g
constexpr int kNode = 9;
constexpr int kSumBlock = 32;  // slots a block of the slot sum: one warp

__host__ __device__ constexpr int sym_index(int i, int k) {  // of the row-major upper triangle
  return i <= k ? 3 * i - i * (i - 1) / 2 + k - i : 3 * k - k * (k - 1) / 2 + i - k;
}

template <int NPE>
__host__ __device__ constexpr int pairs() {
  return NPE * (NPE + 1) / 2;
}

// elements a block of the element pass, and blocks resident an SM (its
// launch bounds), as measured at full width on the H100 (see above)
template <int Q, int NPE>
__host__ __device__ constexpr int elems_per_block() {
  return NPE == 4 ? 32 : (Q == 5 ? 6 : 4);
}

template <int Q, int NPE>
__host__ __device__ constexpr int blocks_per_sm() {
  return NPE == 4 || Q == 5 ? 2 : 5;
}

template <int Q, int NPE>
__host__ __device__ constexpr int stiffness_threads() {
  return elems_per_block<Q, NPE>() * pairs<NPE>();
}

template <int Q, int NPE>
__global__ void __launch_bounds__(stiffness_threads<Q, NPE>(), blocks_per_sm<Q, NPE>())
stiffness_kernel(const double* __restrict__ u, const int* __restrict__ conn,
                 const double* __restrict__ gN, const double* __restrict__ dV,
                 double* __restrict__ blocks, double* __restrict__ fe, int E, int kind,
                 double lam, double mu) {
  constexpr int EPB = elems_per_block<Q, NPE>();
  constexpr int P = pairs<NPE>();
  constexpr int NG = Q * NPE * 3;  // gradN values an element
  constexpr int kG = 0;
  constexpr int kU = kG + EPB * NG;
  constexpr int kV = kU + EPB * NPE * 3;
  constexpr int kPts = kV + EPB * Q;
  constexpr int kNodes = kPts + EPB * Q * kPoint;
  constexpr int kSmem = kNodes + EPB * Q * NPE * kNode;
  static_assert(EPB * P * 9 <= kSmem, "the output tile overlays the inputs");
  static_assert(kSmem * sizeof(double) <= 48 * 1024, "static shared memory");
  __shared__ double sm[kSmem];

  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const int e0 = blockIdx.x * EPB;
  const int ne = E - e0 < EPB ? E - e0 : EPB;  // elements of this block
  const size_t Es = E;

  // 0: geometry and the nodal values at conn; a missing element of the
  // last block reads zeros (F = I: finite, and never stored)
  for (int i = t; i < EPB * NG; i += nt) sm[kG + i] = i < ne * NG ? gN[(size_t)e0 * NG + i] : 0.0;
  for (int i = t; i < EPB * Q; i += nt) sm[kV + i] = i < ne * Q ? dV[(size_t)e0 * Q + i] : 0.0;
  for (int i = t; i < EPB * NPE * 3; i += nt) {
    const int el = i / (NPE * 3), r = i % (NPE * 3);
    sm[kU + i] = el < ne ? u[(size_t)conn[(size_t)(e0 + el) * NPE + r / 3] * 3 + r % 3] : 0.0;
  }
  __syncthreads();

  // 1: a thread a (element, point)
  for (int i = t; i < EPB * Q; i += nt) {
    const int el = i / Q;
    const double* g = sm + kG + i * NPE * 3;
    const double* ue = sm + kU + el * NPE * 3;
    double F[3][3], Cm[3][3], S[3][3], A[3][3], alpha, beta;
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int J = 0; J < 3; ++J) {
        double f = (r == J) ? 1.0 : 0.0;
#pragma unroll
        for (int a = 0; a < NPE; ++a) f += ue[a * 3 + r] * g[a * 3 + J];
        F[r][J] = f;
      }
    right_cauchy_green(F, Cm);
    material_point(kind, lam, mu, Cm, S, A, alpha, beta);
    const double V = sm[kV + i];
    double* pt = sm + kPts + i * kPoint;
    double FA[3][3];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int J = 0; J < 3; ++J) {
        FA[r][J] = F[r][0] * A[0][J] + F[r][1] * A[1][J] + F[r][2] * A[2][J];
        pt[kFA + 3 * r + J] = FA[r][J];
        pt[kA + 3 * r + J] = A[r][J];
        pt[kS + 3 * r + J] = S[r][J];
        pt[kPV + 3 * r + J] = (F[r][0] * S[0][J] + F[r][1] * S[1][J] + F[r][2] * S[2][J]) * V;
      }
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = r; c < 3; ++c)
        pt[kB + sym_index(r, c)] = FA[r][0] * F[c][0] + FA[r][1] * F[c][1] + FA[r][2] * F[c][2];
    pt[kWa] = V * alpha;
    pt[kWb] = 0.5 * V * beta;
    pt[kVol] = V;
  }
  __syncthreads();

  // 2: a thread a (element, point, node b)
  for (int i = t; i < EPB * Q * NPE; i += nt) {
    const double* g = sm + kG + i * 3;
    const double* pt = sm + kPts + (i / NPE) * kPoint;
    double* nv = sm + kNodes + i * kNode;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      nv[r] = pt[kFA + 3 * r] * g[0] + pt[kFA + 3 * r + 1] * g[1] + pt[kFA + 3 * r + 2] * g[2];
      nv[3 + r] = pt[kA + 3 * r] * g[0] + pt[kA + 3 * r + 1] * g[1] + pt[kA + 3 * r + 2] * g[2];
      nv[6 + r] = pt[kS + 3 * r] * g[0] + pt[kS + 3 * r + 1] * g[1] + pt[kS + 3 * r + 2] * g[2];
    }
  }
  __syncthreads();

  // 3: a thread a (element, block (a, b)), a <= b; the force
  const int el = t / P;
  int a = 0, rem = t % P;
  while (rem >= NPE - a) {
    rem -= NPE - a;
    ++a;
  }
  const int b = a + rem;
  double acc[9];
#pragma unroll
  for (int c = 0; c < 9; ++c) acc[c] = 0.0;
#pragma unroll 1
  for (int k = 0; k < Q; ++k) {
    const int ek = el * Q + k;
    const double* pt = sm + kPts + ek * kPoint;
    const double* na = sm + kNodes + (ek * NPE + a) * kNode;
    const double* nb = sm + kNodes + (ek * NPE + b) * kNode;
    const double* ga = sm + kG + (ek * NPE + a) * 3;
    const double G = ga[0] * nb[3] + ga[1] * nb[4] + ga[2] * nb[5];
    const double Gs = ga[0] * nb[6] + ga[1] * nb[7] + ga[2] * nb[8];
    const double wa = pt[kWa], wb = pt[kWb], V = pt[kVol];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int kk = 0; kk < 3; ++kk) {
        double term = wa * na[i] * nb[kk] + wb * (pt[kB + sym_index(i, kk)] * G + nb[i] * na[kk]);
        if (i == kk) term += V * Gs;
        acc[3 * i + kk] += term;
      }
  }
  for (int i = t; i < EPB * NPE * 3; i += nt) {
    const int c = i / (EPB * NPE), r = i % (EPB * NPE);
    if (r / NPE >= ne) continue;
    double f = 0.0;
#pragma unroll 1
    for (int k = 0; k < Q; ++k) {
      const int ek = (r / NPE) * Q + k;
      const double* pv = sm + kPts + ek * kPoint + kPV + 3 * c;
      const double* g = sm + kG + (ek * NPE + r % NPE) * 3;
      f += pv[0] * g[0] + pv[1] * g[1] + pv[2] * g[2];
    }
    fe[c * Es * NPE + (size_t)e0 * NPE + r] = f;
  }
  __syncthreads();

  // 4: the blocks through the tile [EPB][P][9] to one contiguous store
#pragma unroll
  for (int c = 0; c < 9; ++c) sm[t * 9 + c] = acc[c];
  __syncthreads();
  double* out = blocks + (size_t)e0 * P * 9;
  for (int i = t; i < ne * P * 9; i += nt) out[i] = sm[i];
}

__global__ void __launch_bounds__(kSumBlock)
slot_sum_kernel(const double* __restrict__ blocks, const int* __restrict__ offsets,
                const int* __restrict__ codes, double* __restrict__ data, int nnzb) {
  __shared__ double tile[kSumBlock * 9];
  const int t = threadIdx.x;
  const int s0 = blockIdx.x * kSumBlock;
  const int s = s0 + t;
  double acc[9];
#pragma unroll
  for (int c = 0; c < 9; ++c) acc[c] = 0.0;
  if (s < nnzb) {
    const int end = offsets[s + 1];
    for (int j = offsets[s]; j < end; ++j) {
      const int code = codes[j];
      const double* src = blocks + (size_t)(code >> 1) * 9;
      const bool tr = code & 1;
#pragma unroll
      for (int c = 0; c < 9; ++c) acc[c] += src[tr ? (c % 3) * 3 + c / 3 : c];
    }
  }
#pragma unroll
  for (int c = 0; c < 9; ++c) tile[t * 9 + c] = acc[c];
  __syncwarp();
  const int n = (nnzb - s0 < kSumBlock ? nnzb - s0 : kSumBlock) * 9;
  for (int i = t; i < n; i += kSumBlock) data[(size_t)s0 * 9 + i] = tile[i];
}

template <int Q, int NPE>
int launch_stiffness(const double* u, const int* conn, const double* gN, const double* dV,
                     double* blocks, double* fe, int E, int kind, double lam, double mu,
                     cudaStream_t s) {
  constexpr int EPB = elems_per_block<Q, NPE>();
  constexpr int kThreads = stiffness_threads<Q, NPE>();
  const unsigned grid = (unsigned)((E + EPB - 1) / EPB);
  stiffness_kernel<Q, NPE><<<grid, kThreads, 0, s>>>(u, conn, gN, dV, blocks, fe, E, kind, lam,
                                                      mu);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). Each entry launches on `stream`,
// does not synchronise, and returns cudaGetLastError() after the launch.
extern "C" {

// Instantiated elements: (q, npe) = (4, 10) TET10 with the 4-point rule,
// (5, 10) with the 5-point rule and (1, 4) TET4 with the 1-point rule.
int fea_asm_stiffness_f64(const double* u, const int* conn, const double* gN, const double* dV,
                          double* blocks, double* fe, int E, int q, int npe, int kind, double lam,
                          double mu, void* stream) {
  if (E <= 0 || kind < 0 || kind > 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q == 4 && npe == 10)
    return launch_stiffness<4, 10>(u, conn, gN, dV, blocks, fe, E, kind, lam, mu, s);
  if (q == 5 && npe == 10)
    return launch_stiffness<5, 10>(u, conn, gN, dV, blocks, fe, E, kind, lam, mu, s);
  if (q == 1 && npe == 4)
    return launch_stiffness<1, 4>(u, conn, gN, dV, blocks, fe, E, kind, lam, mu, s);
  return (int)cudaErrorInvalidValue;
}

int fea_asm_slot_sum_f64(const double* blocks, const int* offsets, const int* codes, double* data,
                         int nnzb, void* stream) {
  if (nnzb <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = (unsigned)((nnzb + kSumBlock - 1) / kSumBlock);
  slot_sum_kernel<<<grid, kSumBlock, 0, s>>>(blocks, offsets, codes, data, nnzb);
  return (int)cudaGetLastError();
}

}  // extern "C"
