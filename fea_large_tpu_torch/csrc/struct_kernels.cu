// Structured-lattice element passes for Hopper (sm_90a): freeze, tangent
// action, block-Jacobi diagonal and internal force of the mixed-precision
// Newton path, and its f64 residual, on a uniform Kuhn lattice.
//
// Replaces the four Pallas TPU kernels of fea_large_tpu/ops/pallas_structured.py
// and the structured residual kernel of fea_large_tpu/ops/pallas_residual.py:
//   fea_struct_freeze_f32  <- _freeze_kernel  (B2)
//   fea_struct_apply_f32   <- _apply_kernel   (B1)
//   fea_struct_diag_f32    <- _diag_kernel    (B3)
//   fea_struct_force_f32   <- _force_kernel   (B4)
//   fea_struct_resid_f64   <- pallas_residual.py::_resid_kernel (B5)
// Each computes what its TPU kernel computes; the plain PyTorch versions
// sit beside the wrappers in fea_large_tpu_torch/ops/struct_kernels.py.
//
// Layout (kept from the reference): every operand is [rows, C], C cells.
// State rows are r = (k*9 + 3i + j)*T + t, per-point scalars k*T + t, the
// (class, offset) pair cache and pair outputs n_comp*pair + comp. A warp's
// 32 lanes always run along the cell axis, so every row load and store is
// coalesced; the kernels mask the ragged last block themselves and nothing
// is padded.
//
// Threads and accumulation. All five kernels run ONE THREAD PER (TET SLOT t,
// CELL c), blocks of kCellTile = 32 cells x T slots (thread = t * 32 +
// cell), so T times as many loads are in flight as with a thread per cell
// and every row access stays coalesced. B2 stores its own state rows
// straight from registers (every row belongs to one (k, t)). B1, B3, B4 and
// B5 sum their nodal contributions over the q points in registers, touch no
// output row inside the point loop, and end in a fixed-order combine of the
// slots through shared memory that writes each output row once
// (combine_slots). No atomics anywhere: the results are bitwise
// deterministic.
//
// Geometry: gN [q, npe, 3, T], dV [q, T] and pair_of [T, npe] are the same
// for every cell (744 values for TET10). They arrive as small device
// buffers and are staged in shared memory at block start; loops over
// (a, i, J) are unrolled by the (Q, NPE, T) template parameters.
//
// What bounds them on this card: memory traffic. Per cell, B1 reads the
// 81-row pair cache, F, S, A (3 x 216 rows) and alpha, beta (2 x 24) and
// writes 81 rows: about 858 rows x 4 B, so ~147 MB per call at C = 42,875
// (the 1,073,733-DOF TET10 lattice), against ~0.5 kFLOP of arithmetic per
// tet-point. B2 reads 81 and writes 696 rows, B3 reads 696 and writes 243,
// B4 reads 432 and writes 81. Every design reads each operand from device
// memory once and keeps the per-point temporaries in registers. B5 reads 81
// f64 rows and writes 81, and its f64 arithmetic takes the card as long as
// its bytes: it is held by its 60 registers of sums (two blocks an SM) and
// by the f64 pipe, not by memory. Folding the pair gather and scatter into
// the kernels is later work.
//
// Scalar type is a template parameter: B1-B4 are instantiated for float,
// B5 is written for double. The TPU runs B5 in double-word f32 arithmetic
// because Pallas there is f32-only; Hopper has native f64, so B5 is the
// freeze-then-force math of B2 + B4 in double, fused into one pass that
// writes only the 81 f64 pair rows (no state leaves the registers).

#include <cuda_runtime.h>

#include "material_point.cuh"

namespace {

using fea::material_point;
using fea::right_cauchy_green;

template <typename scalar_t, int Q, int NPE, int T>
struct Tables {
  scalar_t gN[Q * NPE * 3 * T];
  scalar_t dV[Q * T];
  int pair_of[T * NPE];
};

// Copy the per-slot tables into shared memory; every thread of the block
// takes part (before any thread leaves on the ragged edge).
template <typename scalar_t, int Q, int NPE, int T>
__device__ __forceinline__ void stage(Tables<scalar_t, Q, NPE, T>& tb,
                                      const scalar_t* __restrict__ gN,
                                      const scalar_t* __restrict__ dV,
                                      const int* __restrict__ pair_of) {
  for (int i = threadIdx.x; i < Q * NPE * 3 * T; i += blockDim.x) tb.gN[i] = gN[i];
  if (dV != nullptr)
    for (int i = threadIdx.x; i < Q * T; i += blockDim.x) tb.dV[i] = dV[i];
  for (int i = threadIdx.x; i < T * NPE; i += blockDim.x) tb.pair_of[i] = pair_of[i];
  __syncthreads();
}

template <typename scalar_t, int Q, int NPE, int T>
__device__ __forceinline__ scalar_t g_at(const Tables<scalar_t, Q, NPE, T>& tb,
                                         int k, int a, int J, int t) {
  return tb.gN[((k * NPE + a) * 3 + J) * T + t];
}

// Load the 3x3 state matrix of point (k, t) of cell c.
template <typename scalar_t, int T>
__device__ __forceinline__ void load3(const scalar_t* __restrict__ buf, int k, int t,
                                      size_t C, int c, scalar_t M[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) M[i][j] = buf[(size_t)((k * 9 + 3 * i + j) * T + t) * C + c];
}

// The nodal values of tet slot t of cell c: ve[a][i] from the pair cache.
template <typename scalar_t, int Q, int NPE, int T>
__device__ __forceinline__ void load_slot(const Tables<scalar_t, Q, NPE, T>& tb,
                                          const scalar_t* __restrict__ cache, int t,
                                          size_t C, int c, scalar_t ve[NPE][3]) {
#pragma unroll
  for (int a = 0; a < NPE; ++a) {
    const int p = tb.pair_of[t * NPE + a];
#pragma unroll
    for (int i = 0; i < 3; ++i) ve[a][i] = cache[(size_t)(3 * p + i) * C + c];
  }
}

// grad[i][J] = sum_a ve[a][i] g_a[J] at point (k, t).
template <typename scalar_t, int Q, int NPE, int T>
__device__ __forceinline__ void slot_grad(const Tables<scalar_t, Q, NPE, T>& tb,
                                          const scalar_t ve[NPE][3], int k, int t,
                                          scalar_t G[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int J = 0; J < 3; ++J) {
      scalar_t s = 0;
#pragma unroll
      for (int a = 0; a < NPE; ++a) s += ve[a][i] * g_at(tb, k, a, J, t);
      G[i][J] = s;
    }
}

// acc[a][i] += sum_J PV[i][J] g_a[J] for every node slot a of tet slot t
// (the nodal contribution of a weighted stress-like PV at point k).
template <typename scalar_t, int Q, int NPE, int T>
__device__ __forceinline__ void add_nodal(const Tables<scalar_t, Q, NPE, T>& tb,
                                          const scalar_t PV[3][3], int k, int t,
                                          scalar_t acc[NPE][3]) {
#pragma unroll
  for (int a = 0; a < NPE; ++a) {
    const scalar_t g0 = g_at(tb, k, a, 0, t), g1 = g_at(tb, k, a, 1, t),
                   g2 = g_at(tb, k, a, 2, t);
#pragma unroll
    for (int i = 0; i < 3; ++i) acc[a][i] += PV[i][0] * g0 + PV[i][1] * g1 + PV[i][2] * g2;
  }
}

// ---------------------------------------------------------------------------
// Blocks of one thread per (tet slot t, cell c): a tile of
// kCellTile cells times the T slots, a warp's lanes along c
// (thread = t * kCellTile + cell).
// ---------------------------------------------------------------------------
constexpr int kCellTile = 32;

inline unsigned tile_grid(int C) { return (unsigned)((C + kCellTile - 1) / kCellTile); }

// ---------------------------------------------------------------------------
// B2 freeze: F = I + sum_a u_a (x) g_a, C = F^T F, material state.
// Replaces pallas_structured.py::_freeze_kernel. Bound by its writes (696
// state rows per cell, ~119 MB at C = 42,875).
//
// ONE THREAD PER (TET SLOT t, CELL c). The thread loads its npe x 3 nodal
// values once and, for each of the q points, stores the 29 state rows of
// (k, t) coalesced, straight from registers. Every output row belongs to
// one (k, t): there is nothing to combine and no barrier after the tables
// are staged.
//
// Whole 32-byte sectors. A row starts at element r * C, so unless C is a
// multiple of 8 the rows start anywhere within a sector, a warp's 32 cells
// begin and end inside one, and two blocks each write a part of it: the
// H100 then runs the kernel at about half the rate it reaches with C a
// multiple of 8 (partial sector writes). So with such a C the
// blocks overlap: block b computes the 32 cells from 24 b on, and of every
// row it stores the sectors 3b + 1 .. 3b + 3 of that row (and block 0 also
// sector 0, the one the row shares with the row before), counted from the
// sector that holds the row's first element. Their 24 cells lie within the
// block's 32 wherever the row starts, so every store instruction writes
// whole sectors, at the price of computing a third more cells (the kernel
// is bound by its writes). With C a multiple of 8 the blocks do not
// overlap (own_cells = kCellTile) and store all they compute.
// ---------------------------------------------------------------------------
constexpr int kOwnSectors = 3;
constexpr int kOwnTile = 8 * kOwnSectors;

// Blocks of the freeze grid and the cells each owns.
inline int freeze_own(int C) { return C % 8 == 0 ? kCellTile : kOwnTile; }
inline unsigned freeze_grid(int C) {
  if (C % 8 == 0) return tile_grid(C);
  const int last = (C + 6) >> 3;  // sector of the last cell of a row that starts at 7 of 8
  return (unsigned)((last + kOwnSectors - 1) / kOwnSectors);
}

// The sectors of a row that one block stores, and whether column c of row r
// is in them.
struct OwnedSectors {
  int lo, hi;
  __device__ __forceinline__ bool holds(int r, int C, int c) const {
    const int sector = (int)((((unsigned)r * (unsigned)C) & 7u) + (unsigned)c) >> 3;
    return sector >= lo && sector <= hi;
  }
};

// Store the block's share of the 3x3 state matrix of point (k, t) of cell c.
template <typename scalar_t, int T>
__device__ __forceinline__ void store3(scalar_t* __restrict__ buf, int k, int t, int C, int c,
                                       OwnedSectors own, const scalar_t M[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int r = (k * 9 + 3 * i + j) * T + t;
      if (own.holds(r, C, c)) buf[(size_t)r * C + c] = M[i][j];
    }
}

template <typename scalar_t, int Q, int NPE, int T>
__global__ void __launch_bounds__(kCellTile * T)
freeze_kernel(const scalar_t* __restrict__ cache, const scalar_t* __restrict__ gN,
              const int* __restrict__ pair_of, scalar_t* __restrict__ Fo,
              scalar_t* __restrict__ So, scalar_t* __restrict__ Ao,
              scalar_t* __restrict__ alo, scalar_t* __restrict__ beo, int C, int own_cells,
              int kind, scalar_t lam, scalar_t mu) {
  __shared__ Tables<scalar_t, Q, NPE, T> tb;
  stage(tb, gN, static_cast<const scalar_t*>(nullptr), pair_of);
  const int t = threadIdx.x / kCellTile;
  const int b = blockIdx.x;
  const int c = b * own_cells + threadIdx.x % kCellTile;
  if (c >= C) return;
  const OwnedSectors own = own_cells == kCellTile
                               ? OwnedSectors{0, 0x7fffffff}
                               : OwnedSectors{kOwnSectors * b + (b > 0), kOwnSectors * b + kOwnSectors};
  const size_t Cs = C;
  scalar_t ue[NPE][3];
  load_slot(tb, cache, t, Cs, c, ue);
#pragma unroll 1
  for (int k = 0; k < Q; ++k) {
    scalar_t F[3][3];
    slot_grad(tb, ue, k, t, F);
#pragma unroll
    for (int i = 0; i < 3; ++i) F[i][i] += scalar_t(1);
    scalar_t Cm[3][3];
    right_cauchy_green(F, Cm);
    scalar_t S[3][3], A[3][3], alpha, beta;
    material_point(kind, lam, mu, Cm, S, A, alpha, beta);
    store3<scalar_t, T>(Fo, k, t, C, c, own, F);
    store3<scalar_t, T>(So, k, t, C, c, own, S);
    store3<scalar_t, T>(Ao, k, t, C, c, own, A);
    if (own.holds(k * T + t, C, c)) {
      alo[(size_t)(k * T + t) * Cs + c] = alpha;
      beo[(size_t)(k * T + t) * Cs + c] = beta;
    }
  }
}

// ---------------------------------------------------------------------------
// The combine of B1, B3, B4 and B5. Each thread has summed NCOMP components
// for each of its npe node slots over the q points: B1, B4 and B5 the 3
// components of a nodal vector, B3 the 6 entries (00, 01, 02, 11, 12, 22) of a symmetric nodal 3x3
// block. After the point loop the threads store them to a shared tile, row
// (t * npe + a) * NCOMP + comp, which overlays the per-slot tables that the
// loop is done with (a barrier before the stores, one after). Then one
// thread per (pair, cell) sums the pair's slots in the t-major order of the
// slot table (StructTables.slot_table) and writes the pair's output rows
// once, coalesced along the cells: rows 3*pair + comp for a nodal vector,
// rows 9*pair + 3i + kk for B3, whose lower triangle mirrors the upper. Fixed
// order, no atomics: bitwise deterministic. The ragged last tile is masked.
// ---------------------------------------------------------------------------
template <typename scalar_t, int Q, int NPE, int T, int NCOMP>
struct SlotShared {
  int slot_table[T * NPE * T];  // [P, T] slots of each pair, padded with T * NPE
  union {
    Tables<scalar_t, Q, NPE, T> tb;             // during the point loop
    scalar_t tile[T * NPE * NCOMP][kCellTile];  // after it: 23 KB (B1, B4), 46 KB (B3, B5) for TET10
  };
};

// Stage the slot table and the per-slot tables; ends in a barrier.
template <typename scalar_t, int Q, int NPE, int T, int NCOMP>
__device__ __forceinline__ void stage_slots(SlotShared<scalar_t, Q, NPE, T, NCOMP>& sh,
                                            const scalar_t* __restrict__ gN,
                                            const scalar_t* __restrict__ dV,
                                            const int* __restrict__ pair_of,
                                            const int* __restrict__ slot_table, int P) {
  for (int i = threadIdx.x; i < P * T; i += blockDim.x) sh.slot_table[i] = slot_table[i];
  stage(sh.tb, gN, dV, pair_of);
}

__host__ __device__ constexpr int sym_index(int i, int k) {  // of the row-major upper triangle
  return i <= k ? 3 * i - i * (i - 1) / 2 + k - i : 3 * k - k * (k - 1) / 2 + i - k;
}

// Store the thread's sums to the tile and combine them into the output rows.
template <typename scalar_t, int Q, int NPE, int T, int NCOMP>
__device__ __forceinline__ void combine_slots(SlotShared<scalar_t, Q, NPE, T, NCOMP>& sh,
                                              const scalar_t acc[NPE][NCOMP],
                                              scalar_t* __restrict__ out, int P, int C) {
  static_assert(NCOMP == 3 || NCOMP == 6, "a nodal vector or a symmetric nodal block");
  constexpr int NOUT = NCOMP == 3 ? 3 : 9;
  const int lane = threadIdx.x % kCellTile;
  const int t = threadIdx.x / kCellTile;
  const int c0 = blockIdx.x * kCellTile;
  __syncthreads();  // every thread is done with the tables under the tile
#pragma unroll
  for (int a = 0; a < NPE; ++a)
#pragma unroll
    for (int e = 0; e < NCOMP; ++e) sh.tile[(t * NPE + a) * NCOMP + e][lane] = acc[a][e];
  __syncthreads();
  for (int o = threadIdx.x; o < P * kCellTile; o += blockDim.x) {
    const int pair = o / kCellTile, cell = o % kCellTile;
    const int* slots = sh.slot_table + pair * T;
    scalar_t sum[NCOMP];
#pragma unroll
    for (int e = 0; e < NCOMP; ++e) sum[e] = scalar_t(0);
#pragma unroll
    for (int m = 0; m < T; ++m) {
      const int s = slots[m];
      if (s < T * NPE) {
#pragma unroll
        for (int e = 0; e < NCOMP; ++e) sum[e] += sh.tile[s * NCOMP + e][cell];
      }
    }
    if (c0 + cell < C) {
#pragma unroll
      for (int j = 0; j < NOUT; ++j)
        out[(size_t)(NOUT * pair + j) * C + c0 + cell] =
            sum[NCOMP == 3 ? j : sym_index(j / 3, j % 3)];
    }
  }
}

// ---------------------------------------------------------------------------
// B1 tangent action: dF = sum_a v_a (x) g_a, dE = sym(F^T dF),
// dS = alpha (A:dE) A + beta A dE A, dP = dF S + F dS; V dP g_a into pairs.
// Replaces pallas_structured.py::_apply_kernel. Bound by reading the frozen
// state (696 rows per cell) once per PCG iteration.
//
// ONE THREAD PER (TET SLOT t, CELL c), so every state and cache row load
// stays coalesced and T times as many loads are in flight as with a thread
// per cell. The thread loads its npe x 3 nodal values once, loops over the
// q points with one point's state in registers, and keeps its npe x 3
// nodal contributions in registers: no output row is touched inside the
// loop. Then the block combines them into the 3P output rows through the
// shared tile (combine_slots). The ragged last tile is masked; its idle
// threads still reach the barriers.
// ---------------------------------------------------------------------------
template <typename scalar_t, int Q, int NPE, int T>
__global__ void __launch_bounds__(kCellTile * T)
apply_kernel(const scalar_t* __restrict__ cache, const scalar_t* __restrict__ Fb,
             const scalar_t* __restrict__ Sb, const scalar_t* __restrict__ Ab,
             const scalar_t* __restrict__ alb, const scalar_t* __restrict__ beb,
             const scalar_t* __restrict__ gN, const scalar_t* __restrict__ dV,
             const int* __restrict__ pair_of, const int* __restrict__ slot_table,
             scalar_t* __restrict__ out, int C, int P) {
  __shared__ SlotShared<scalar_t, Q, NPE, T, 3> sh;
  stage_slots(sh, gN, dV, pair_of, slot_table, P);
  const Tables<scalar_t, Q, NPE, T>& tb = sh.tb;
  const int t = threadIdx.x / kCellTile;
  const int c = blockIdx.x * kCellTile + threadIdx.x % kCellTile;
  const size_t Cs = C;
  scalar_t acc[NPE][3];
#pragma unroll
  for (int a = 0; a < NPE; ++a)
#pragma unroll
    for (int i = 0; i < 3; ++i) acc[a][i] = scalar_t(0);
  if (c < C) {
    scalar_t ve[NPE][3];
    load_slot(tb, cache, t, Cs, c, ve);
#pragma unroll 1
    for (int k = 0; k < Q; ++k) {
      scalar_t F[3][3], S[3][3], A[3][3], dF[3][3];
      load3<scalar_t, T>(Fb, k, t, Cs, c, F);
      load3<scalar_t, T>(Sb, k, t, Cs, c, S);
      load3<scalar_t, T>(Ab, k, t, Cs, c, A);
      const scalar_t al = alb[(size_t)(k * T + t) * Cs + c];
      const scalar_t be = beb[(size_t)(k * T + t) * Cs + c];
      const scalar_t V = tb.dV[k * T + t];
      slot_grad(tb, ve, k, t, dF);
      scalar_t dE[3][3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const scalar_t fij = F[0][i] * dF[0][j] + F[1][i] * dF[1][j] + F[2][i] * dF[2][j];
          const scalar_t fji = F[0][j] * dF[0][i] + F[1][j] * dF[1][i] + F[2][j] * dF[2][i];
          dE[i][j] = scalar_t(0.5) * (fij + fji);
        }
      scalar_t AdE = 0;
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) AdE += A[i][j] * dE[i][j];
      scalar_t AdEr[3][3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
          AdEr[i][j] = A[i][0] * dE[0][j] + A[i][1] * dE[1][j] + A[i][2] * dE[2][j];
      scalar_t dS[3][3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const scalar_t adea = AdEr[i][0] * A[0][j] + AdEr[i][1] * A[1][j] + AdEr[i][2] * A[2][j];
          dS[i][j] = al * AdE * A[i][j] + be * adea;
        }
      scalar_t dPV[3][3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int J = 0; J < 3; ++J)
          dPV[i][J] = (dF[i][0] * S[0][J] + dF[i][1] * S[1][J] + dF[i][2] * S[2][J] +
                       F[i][0] * dS[0][J] + F[i][1] * dS[1][J] + F[i][2] * dS[2][J]) * V;
      add_nodal(tb, dPV, k, t, acc);
    }
  }
  combine_slots(sh, acc, out, P, C);
}

// ---------------------------------------------------------------------------
// B3 block-Jacobi diagonal: sum_q V [(alpha + beta/2) s_a s_a^T
// + (beta/2) B G_aa + (g_a.S.g_a) I], FA = F A, B = FA F^T, s_a = FA g_a,
// G_aa = g_a.A.g_a; rows 9*pair + 3i + kk.
// Replaces pallas_structured.py::_diag_kernel. Bound by reading the frozen
// state (696 rows per cell) and writing the 243 output rows once. Once per
// Newton step.
//
// ONE THREAD PER (TET SLOT t, CELL c), as B1. Every nodal block is
// symmetric (s s^T, B = F A F^T with A symmetric, the multiple of I), so
// the thread sums only its upper triangle over the q points: npe x 6
// register sums, and no output row is touched inside the loop. The point
// loop is unrolled, so that the loads of the next point's state are in
// flight while this point's npe blocks are summed; the launch bounds hold
// that to the 168 registers at which two blocks fit an SM. Then the block
// combines the sums into the 9P output rows through the shared tile, which
// mirrors the lower triangle (combine_slots). The ragged last tile is
// masked; its idle threads still reach the barriers.
// ---------------------------------------------------------------------------
template <typename scalar_t, int Q, int NPE, int T>
__global__ void __launch_bounds__(kCellTile * T, 2)
diag_kernel(const scalar_t* __restrict__ Fb, const scalar_t* __restrict__ Sb,
            const scalar_t* __restrict__ Ab, const scalar_t* __restrict__ alb,
            const scalar_t* __restrict__ beb, const scalar_t* __restrict__ gN,
            const scalar_t* __restrict__ dV, const int* __restrict__ pair_of,
            const int* __restrict__ slot_table, scalar_t* __restrict__ out, int C, int P) {
  __shared__ SlotShared<scalar_t, Q, NPE, T, 6> sh;
  stage_slots(sh, gN, dV, pair_of, slot_table, P);
  const Tables<scalar_t, Q, NPE, T>& tb = sh.tb;
  const int t = threadIdx.x / kCellTile;
  const int c = blockIdx.x * kCellTile + threadIdx.x % kCellTile;
  const size_t Cs = C;
  scalar_t acc[NPE][6];
#pragma unroll
  for (int a = 0; a < NPE; ++a)
#pragma unroll
    for (int e = 0; e < 6; ++e) acc[a][e] = scalar_t(0);
  if (c < C) {
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      scalar_t F[3][3], S[3][3], A[3][3];
      load3<scalar_t, T>(Fb, k, t, Cs, c, F);
      load3<scalar_t, T>(Sb, k, t, Cs, c, S);
      load3<scalar_t, T>(Ab, k, t, Cs, c, A);
      const scalar_t al = alb[(size_t)(k * T + t) * Cs + c];
      const scalar_t be = beb[(size_t)(k * T + t) * Cs + c];
      const scalar_t V = tb.dV[k * T + t];
      const scalar_t w1 = (al + scalar_t(0.5) * be) * V;
      const scalar_t w2 = scalar_t(0.5) * be * V;
      scalar_t FA[3][3], w2B[6];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
          FA[i][j] = F[i][0] * A[0][j] + F[i][1] * A[1][j] + F[i][2] * A[2][j];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = i; j < 3; ++j)
          w2B[sym_index(i, j)] =
              w2 * (FA[i][0] * F[j][0] + FA[i][1] * F[j][1] + FA[i][2] * F[j][2]);
#pragma unroll
      for (int a = 0; a < NPE; ++a) {
        const scalar_t g[3] = {g_at(tb, k, a, 0, t), g_at(tb, k, a, 1, t),
                               g_at(tb, k, a, 2, t)};
        scalar_t s[3], Ag[3], Sg[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          s[i] = FA[i][0] * g[0] + FA[i][1] * g[1] + FA[i][2] * g[2];
          Ag[i] = A[i][0] * g[0] + A[i][1] * g[1] + A[i][2] * g[2];
          Sg[i] = S[i][0] * g[0] + S[i][1] * g[1] + S[i][2] * g[2];
        }
        const scalar_t Gaa = g[0] * Ag[0] + g[1] * Ag[1] + g[2] * Ag[2];
        const scalar_t geo = V * (g[0] * Sg[0] + g[1] * Sg[1] + g[2] * Sg[2]);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const scalar_t w1s = w1 * s[i];
#pragma unroll
          for (int kk = i; kk < 3; ++kk) {
            scalar_t term = w1s * s[kk] + w2B[sym_index(i, kk)] * Gaa;
            if (i == kk) term += geo;
            acc[a][sym_index(i, kk)] += term;
          }
        }
      }
    }
  }
  combine_slots(sh, acc, out, P, C);
}

// ---------------------------------------------------------------------------
// B4 internal force from the frozen state: f_a = sum_q V (F S) g_a.
// Replaces pallas_structured.py::_force_kernel. Bound by reading F and S
// (432 rows per cell) once; a few times per solve (the resid32 gate).
//
// ONE THREAD PER (TET SLOT t, CELL c), as B1: per point 18 coalesced loads
// (F, S), one 3x3 product and npe x 3 x 3 multiply-adds into the thread's
// npe x 3 register sums; no output row is touched inside the loop. The
// point loop is unrolled so that the loads of all q points are in flight
// together, and the launch bounds hold that to the registers at which three
// blocks fit an SM (96 for TET10, no spill). Then the block combines the sums into the 3P output rows through the
// shared tile (combine_slots). The ragged last tile is masked; its idle
// threads still reach the barriers.
// ---------------------------------------------------------------------------
template <typename scalar_t, int Q, int NPE, int T>
__global__ void __launch_bounds__(kCellTile * T, 3)
force_kernel(const scalar_t* __restrict__ Fb, const scalar_t* __restrict__ Sb,
             const scalar_t* __restrict__ gN, const scalar_t* __restrict__ dV,
             const int* __restrict__ pair_of, const int* __restrict__ slot_table,
             scalar_t* __restrict__ out, int C, int P) {
  __shared__ SlotShared<scalar_t, Q, NPE, T, 3> sh;
  stage_slots(sh, gN, dV, pair_of, slot_table, P);
  const Tables<scalar_t, Q, NPE, T>& tb = sh.tb;
  const int t = threadIdx.x / kCellTile;
  const int c = blockIdx.x * kCellTile + threadIdx.x % kCellTile;
  const size_t Cs = C;
  scalar_t acc[NPE][3];
#pragma unroll
  for (int a = 0; a < NPE; ++a)
#pragma unroll
    for (int i = 0; i < 3; ++i) acc[a][i] = scalar_t(0);
  if (c < C) {
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      scalar_t F[3][3], S[3][3], PV[3][3];
      load3<scalar_t, T>(Fb, k, t, Cs, c, F);
      load3<scalar_t, T>(Sb, k, t, Cs, c, S);
      const scalar_t V = tb.dV[k * T + t];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int J = 0; J < 3; ++J)
          PV[i][J] = (F[i][0] * S[0][J] + F[i][1] * S[1][J] + F[i][2] * S[2][J]) * V;
      add_nodal(tb, PV, k, t, acc);
    }
  }
  combine_slots(sh, acc, out, P, C);
}

// ---------------------------------------------------------------------------
// B5 f64 residual: f_a = sum_q V (F S(C)) g_a with F = I + sum_a u_a (x) g_a,
// C = F^T F, straight from the f64 pair cache: B2's kinematics and the
// material's stress followed by B4's contraction, in double, with nothing
// but the 81 pair rows written. Replaces pallas_residual.py::_resid_kernel
// (whose double-word (hi, lo) f32 arithmetic and tet-slot groups exist only
// for the TPU). Its memory traffic, 81 f64 rows read and 81 written per
// cell (55.6 MB at C = 42,875), and its f64 arithmetic (~0.5 GFLOP a call)
// take the card about the same time, so it must overlap the two and do no
// f64 operation it does not need.
//
// ONE THREAD PER (TET SLOT t, CELL c), as B1, with npe x 3 register sums in
// double and the fixed-order combine through a double tile ([T npe 3][32],
// 46 KB, over the per-slot tables: 47.5 KB static in all). Registers are
// what is scarce: the sums alone take 60, and two blocks fit an SM only
// at 168 a thread. So the point loop stays rolled, the stress comes from
// material_stress (the six entries of the symmetric C, C^-1 and S; no
// tangent factors), each sum takes its three multiply-adds as one chain,
// and the thread's npe x 3 nodal values are not kept over the loop but read
// again at every point from the 81 cache rows, which stay in L1: 168
// registers for TET10, no spill.
// ---------------------------------------------------------------------------
template <int Q, int NPE, int T>
__global__ void __launch_bounds__(kCellTile * T, 2)
resid_kernel(const double* __restrict__ cache, const double* __restrict__ gN,
             const double* __restrict__ dV, const int* __restrict__ pair_of,
             const int* __restrict__ slot_table, double* __restrict__ out, int C, int P,
             int kind, double lam, double mu) {
  __shared__ SlotShared<double, Q, NPE, T, 3> sh;
  stage_slots(sh, gN, dV, pair_of, slot_table, P);
  const Tables<double, Q, NPE, T>& tb = sh.tb;
  const int t = threadIdx.x / kCellTile;
  const int c = blockIdx.x * kCellTile + threadIdx.x % kCellTile;
  double acc[NPE][3];
#pragma unroll
  for (int a = 0; a < NPE; ++a)
#pragma unroll
    for (int i = 0; i < 3; ++i) acc[a][i] = 0.0;
  if (c < C) {
    const double* __restrict__ col = cache + c;  // column c of every cache row
#pragma unroll 1
    for (int k = 0; k < Q; ++k) {
      // The pair indices are read from shared memory anew at every point:
      // else the compiler keeps the npe x 3 row addresses over the loop and
      // spills them.
      asm volatile("" ::: "memory");
      double F[3][3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int J = 0; J < 3; ++J) F[i][J] = (i == J) ? 1.0 : 0.0;
#pragma unroll
      for (int a = 0; a < NPE; ++a) {
        const int row = 3 * tb.pair_of[t * NPE + a];
        const double g0 = g_at(tb, k, a, 0, t), g1 = g_at(tb, k, a, 1, t),
                     g2 = g_at(tb, k, a, 2, t);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const double u = col[(row + i) * C];  // 3 P C < 2^31 (checked at the launch)
          F[i][0] += u * g0;
          F[i][1] += u * g1;
          F[i][2] += u * g2;
        }
      }
      double Cm[6], S[6];
      fea::right_cauchy_green_sym(F, Cm);
      fea::material_stress(kind, lam, mu, Cm, S);
      const double V = tb.dV[k * T + t];
      double PV[3][3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int J = 0; J < 3; ++J)
          PV[i][J] = (F[i][0] * S[sym_index(0, J)] + F[i][1] * S[sym_index(1, J)] +
                      F[i][2] * S[sym_index(2, J)]) * V;
#pragma unroll
      for (int a = 0; a < NPE; ++a) {
        const double g0 = g_at(tb, k, a, 0, t), g1 = g_at(tb, k, a, 1, t),
                     g2 = g_at(tb, k, a, 2, t);
#pragma unroll
        for (int i = 0; i < 3; ++i)  // three multiply-adds in a chain, no separate add
          acc[a][i] = fma(PV[i][2], g2, fma(PV[i][1], g1, fma(PV[i][0], g0, acc[a][i])));
      }
    }
  }
  combine_slots(sh, acc, out, P, C);
}

}  // namespace

// Instantiated lattices: (Q, NPE, T) = (4, 10, 6) TET10, (5, 10, 6) TET10
// with the 5-point rule and (1, 4, 6) TET4.
#define FEA_DISPATCH(q, npe, T, ...)                               \
  do {                                                             \
    if ((q) == 4 && (npe) == 10 && (T) == 6) {                     \
      constexpr int kQ = 4, kNPE = 10, kT = 6;                     \
      __VA_ARGS__;                                                 \
    } else if ((q) == 5 && (npe) == 10 && (T) == 6) {              \
      constexpr int kQ = 5, kNPE = 10, kT = 6;                     \
      __VA_ARGS__;                                                 \
    } else if ((q) == 1 && (npe) == 4 && (T) == 6) {               \
      constexpr int kQ = 1, kNPE = 4, kT = 6;                      \
      __VA_ARGS__;                                                 \
    } else {                                                       \
      return (int)cudaErrorInvalidValue;                           \
    }                                                              \
  } while (0)

// Plain C interface (loaded with ctypes). Each entry launches on `stream`,
// does not synchronise, and returns cudaGetLastError() after the launch.
extern "C" {

int fea_struct_freeze_f32(const float* cache, const float* gN, const int* pair_of,
                          float* F, float* S, float* A, float* alpha, float* beta,
                          int C, int q, int npe, int T, int kind, float lam, float mu,
                          void* stream) {
  if (C <= 0 || kind < 0 || kind > 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FEA_DISPATCH(q, npe, T,
               freeze_kernel<float, kQ, kNPE, kT><<<freeze_grid(C), kCellTile * kT, 0, s>>>(
                   cache, gN, pair_of, F, S, A, alpha, beta, C, freeze_own(C), kind, lam, mu));
  return (int)cudaGetLastError();
}

// slot_table (B1, B3, B4 and B5) int32 [P, T]: the (t * npe + a) slots of each pair
// in t-major order, padded with T * npe (a pair is a node of a tet at most
// once, so it has at most T slots); P <= T * npe pairs.
int fea_struct_apply_f32(const float* cache, const float* F, const float* S,
                         const float* A, const float* alpha, const float* beta,
                         const float* gN, const float* dV, const int* pair_of,
                         const int* slot_table, float* out, int C, int q, int npe, int T,
                         int P, void* stream) {
  if (C <= 0 || P <= 0 || P > T * npe) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FEA_DISPATCH(q, npe, T,
               apply_kernel<float, kQ, kNPE, kT><<<tile_grid(C), kCellTile * kT, 0, s>>>(
                   cache, F, S, A, alpha, beta, gN, dV, pair_of, slot_table, out, C, P));
  return (int)cudaGetLastError();
}

int fea_struct_diag_f32(const float* F, const float* S, const float* A, const float* alpha,
                        const float* beta, const float* gN, const float* dV,
                        const int* pair_of, const int* slot_table, float* out, int C, int q,
                        int npe, int T, int P, void* stream) {
  if (C <= 0 || P <= 0 || P > T * npe) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FEA_DISPATCH(q, npe, T,
               diag_kernel<float, kQ, kNPE, kT><<<tile_grid(C), kCellTile * kT, 0, s>>>(
                   F, S, A, alpha, beta, gN, dV, pair_of, slot_table, out, C, P));
  return (int)cudaGetLastError();
}

int fea_struct_force_f32(const float* F, const float* S, const float* gN, const float* dV,
                         const int* pair_of, const int* slot_table, float* out, int C, int q,
                         int npe, int T, int P, void* stream) {
  if (C <= 0 || P <= 0 || P > T * npe) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FEA_DISPATCH(q, npe, T,
               force_kernel<float, kQ, kNPE, kT><<<tile_grid(C), kCellTile * kT, 0, s>>>(
                   F, S, gN, dV, pair_of, slot_table, out, C, P));
  return (int)cudaGetLastError();
}

int fea_struct_resid_f64(const double* cache, const double* gN, const double* dV,
                         const int* pair_of, const int* slot_table, double* out, int C, int q,
                         int npe, int T, int P, int kind, double lam, double mu,
                         void* stream) {
  if (C <= 0 || P <= 0 || P > T * npe || kind < 0 || kind > 2 ||
      3LL * P * C > 0x7fffffffLL)  // the kernel indexes the cache rows with an int
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FEA_DISPATCH(q, npe, T,
               resid_kernel<kQ, kNPE, kT><<<tile_grid(C), kCellTile * kT, 0, s>>>(
                   cache, gN, dV, pair_of, slot_table, out, C, P, kind, lam, mu));
  return (int)cudaGetLastError();
}

}  // extern "C"
