// Block-CSR product y = K x for Hopper (sm_90a), 3x3 nodal blocks: the
// PCG operator of the f64 assembled path (linear="pcg_bcsr").
//
// Replaces fea_large_tpu/ops/pallas_kernels.py::_spmv_kernel (B10), which
// does the per-block 3x3 products on the TPU while XLA gathers x[indices]
// before it and segment-sums the sorted rows after it. Here one kernel
// does all three. The plain PyTorch version sits beside the wrapper in
// fea_large_tpu_torch/ops/bcsr_kernels.py.
//
// Operands: indptr int32 [N+1], indices int32 [nnzb], data [nnzb, 3, 3]
// row-major (72 bytes per f64 block), x and y [N, 3]. Templated on the
// scalar type: double on the path, float checked too.
//
// A WARP OWNS A BLOCK ROW r: its L = 32 lanes (kLanes, a compile-time
// constant) share the row's blocks, which are one contiguous span of data.
// Lane l takes the slots indptr[r] + l, + l + L, ...: it reads the slot's
// nine words and column, gathers the three x values through the read-only
// path and adds the whole 3x3 product to three register sums; the loop is
// unrolled so that every lane has two slots' loads in flight. The lanes of
// the warp read L neighbouring blocks per step (L * 72 B of f64), so every
// 32-byte sector a warp fetches is used by that warp within the same nine
// load instructions, whatever the rows' lengths; a short row idles lanes
// of its own warp only. A row of a TET10 mesh (~27 blocks) takes one step
// with all its loads in flight at once.
//
// The L partial sums are combined by an xor-butterfly of __shfl_xor_sync
// (offsets L/2, ..., 1) and lane 0 writes y[r] once. The
// summation order depends on the row's length only, never on the
// launch's block size or on timing: no atomics, bitwise-equal repeats. It
// is not the plain version's slot order, so the two agree to rounding.
//
// What bounds it on this card: memory traffic. Each stored block is read
// once (72 B of f64 data and a 4 B column), against 18 flops per block;
// x (8.2 MB at N = 342,361) is gathered from L2 and y written once. At
// the TET10 5-tet box n=36 (nnzb = 9,184,321, 26.8 blocks a row) that is
// ~0.72 GB per product.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxBlock = 256;
constexpr int kLanes = 32;  // lanes that share a block row: one warp

// acc += B x_c for the stored block at slot s.
template <typename T>
struct Slot {
  T d[9];
  int c;
  __device__ __forceinline__ void load(const int* __restrict__ indices,
                                       const T* __restrict__ data, int s) {
    c = __ldg(indices + s);
    const T* p = data + 9 * (size_t)s;
#pragma unroll
    for (int k = 0; k < 9; ++k) d[k] = __ldg(p + k);
  }
  __device__ __forceinline__ void add_product(const T* __restrict__ x, T& y0, T& y1,
                                              T& y2) const {
    const T* xc = x + 3 * (size_t)c;
    const T x0 = __ldg(xc), x1 = __ldg(xc + 1), x2 = __ldg(xc + 2);
    y0 += d[0] * x0 + d[1] * x1 + d[2] * x2;
    y1 += d[3] * x0 + d[4] * x1 + d[5] * x2;
    y2 += d[6] * x0 + d[7] * x1 + d[8] * x2;
  }
};

template <typename T>
__global__ void __launch_bounds__(kMaxBlock)
spmv_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
            const T* __restrict__ data, const T* __restrict__ x, T* __restrict__ y,
            int n_rows) {
  constexpr int L = kLanes;
  const int r = blockIdx.x * (blockDim.x / L) + threadIdx.x / L;
  const int lane = threadIdx.x % L;
  // rows past the end keep their lanes (an empty slot range): the shuffles
  // below name the whole warp
  int s = 0, end = 0;
  if (r < n_rows) {
    s = __ldg(indptr + r) + lane;
    end = __ldg(indptr + r + 1);
  }
  T y0 = T(0), y1 = T(0), y2 = T(0);
  for (; s + L < end; s += 2 * L) {
    Slot<T> a, b;
    a.load(indices, data, s);
    b.load(indices, data, s + L);
    a.add_product(x, y0, y1, y2);
    b.add_product(x, y0, y1, y2);
  }
  if (s < end) {
    Slot<T> a;
    a.load(indices, data, s);
    a.add_product(x, y0, y1, y2);
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) {
    y0 += __shfl_xor_sync(0xffffffffu, y0, off);
    y1 += __shfl_xor_sync(0xffffffffu, y1, off);
    y2 += __shfl_xor_sync(0xffffffffu, y2, off);
  }
  if (lane == 0 && r < n_rows) {
    y[3 * (size_t)r] = y0;
    y[3 * (size_t)r + 1] = y1;
    y[3 * (size_t)r + 2] = y2;
  }
}

template <typename T>
int launch(const int* indptr, const int* indices, const T* data, const T* x, T* y,
           int n_rows, int block, void* stream) {
  if (n_rows <= 0 || block <= 0 || block > kMaxBlock || block % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const int rows = block / kLanes;  // block rows of one CUDA block
  const unsigned grid = (unsigned)((n_rows + rows - 1) / rows);
  spmv_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(indptr, indices, data,
                                                                         x, y, n_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). Each entry launches on `stream`,
// does not synchronise, and returns cudaGetLastError() after the launch.
extern "C" {

int fea_bcsr_spmv_f64(const int* indptr, const int* indices, const double* data,
                      const double* x, double* y, int n_rows, int block, void* stream) {
  return launch<double>(indptr, indices, data, x, y, n_rows, block, stream);
}

int fea_bcsr_spmv_f32(const int* indptr, const int* indices, const float* data,
                      const float* x, float* y, int n_rows, int block, void* stream) {
  return launch<float>(indptr, indices, data, x, y, n_rows, block, stream);
}

}  // extern "C"
