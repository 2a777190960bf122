// Block-CSR product y = K x for Hopper (sm_90a), 3x3 nodal blocks: the
// PCG operator of the f64 assembled path (linear="pcg_bcsr").
//
// Replaces fea_large_tpu/ops/pallas_kernels.py::_spmv_kernel (B10), which
// does the per-block 3x3 products on the TPU while XLA gathers x[indices]
// before it and segment-sums the sorted rows after it. Here one kernel
// does all three. The plain PyTorch version sits beside the wrapper in
// fea_large_tpu_torch/ops/bcsr_kernels.py.
//
// Operands: indptr int64 [N+1], indices int64 [nnzb], data [nnzb, 3, 3]
// row-major (72 bytes per f64 block), x and y [N, 3]. Templated on the
// scalar type: double on the path, float checked too.
//
// ONE THREAD PER BLOCK ROW r: it walks the slots indptr[r] .. indptr[r+1]
// in order, gathers x[indices[s]], multiplies by the block, accumulates the
// three outputs in registers and writes y[r] once. Deterministic, with no
// atomics: every row is summed in slot order by one thread.
//
// What bounds it on this card: memory traffic. Each stored block is read
// once (72 B of f64 data and an 8 B index), against 18 flops per block;
// x is gathered (mostly from L2: a row's columns are nearby nodes) and y
// written once. At the TET10 5-tet box n=36 (nnzb = 9,184,321, N =
// 342,361) that is ~0.75 GB per product. The simple design leaves the
// block reads uncoalesced: neighbouring threads read rows ~27 blocks
// (~2 KB) apart. A warp per row, reducing in a fixed order, would
// coalesce them.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxBlock = 256;

template <typename T>
__global__ void __launch_bounds__(kMaxBlock)
spmv_kernel(const long long* __restrict__ indptr, const long long* __restrict__ indices,
            const T* __restrict__ data, const T* __restrict__ x, T* __restrict__ y,
            int n_rows) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  T y0 = T(0), y1 = T(0), y2 = T(0);
  const long long end = indptr[r + 1];
  for (long long s = indptr[r]; s < end; ++s) {
    const long long c = indices[s];
    const T x0 = x[3 * c], x1 = x[3 * c + 1], x2 = x[3 * c + 2];
    const T* d = data + 9 * s;
    y0 += d[0] * x0 + d[1] * x1 + d[2] * x2;
    y1 += d[3] * x0 + d[4] * x1 + d[5] * x2;
    y2 += d[6] * x0 + d[7] * x1 + d[8] * x2;
  }
  y[3 * (size_t)r] = y0;
  y[3 * (size_t)r + 1] = y1;
  y[3 * (size_t)r + 2] = y2;
}

template <typename T>
int launch(const long long* indptr, const long long* indices, const T* data, const T* x, T* y,
           int n_rows, int block, void* stream) {
  if (n_rows <= 0 || block <= 0 || block > kMaxBlock || block % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((n_rows + block - 1) / block);
  spmv_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(indptr, indices, data,
                                                                         x, y, n_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). Each entry launches on `stream`,
// does not synchronise, and returns cudaGetLastError() after the launch.
extern "C" {

int fea_bcsr_spmv_f64(const long long* indptr, const long long* indices, const double* data,
                      const double* x, double* y, int n_rows, int block, void* stream) {
  return launch<double>(indptr, indices, data, x, y, n_rows, block, stream);
}

int fea_bcsr_spmv_f32(const long long* indptr, const long long* indices, const float* data,
                      const float* x, float* y, int n_rows, int block, void* stream) {
  return launch<float>(indptr, indices, data, x, y, n_rows, block, stream);
}

}  // extern "C"
