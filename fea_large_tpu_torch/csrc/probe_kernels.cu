// A yardstick, not a kernel of the port: the rate at which this card does
// f64 multiply-adds outside the tensor cores, measured, to set beside the
// data-sheet rate that the bounds of the f64 kernels (the lattice residual
// B5, the element-block residual B9) are computed from. chip_smoke.py builds
// it, launches it in its timings and prints the rates; nothing in the
// package calls it.
//
// Every thread runs kChains independent chains of dependent multiply-adds
// x <- x y + z, so that neither the latency of one multiply-add nor memory
// (one store a thread at the end) limits the rate. With REGS the factors y
// and z are registers of the thread, as the operands of the kernels'
// multiply-adds are (three 64-bit register reads an instruction); without,
// they are the same two constants for every thread (one register read).

#include <cuda_runtime.h>

namespace {

constexpr int kChains = 8;
constexpr int kThreads = 256;

template <bool REGS>
__global__ void __launch_bounds__(kThreads)
dfma_kernel(double* __restrict__ out, int iters, double a, double b) {
  double x[kChains], y[kChains], z[kChains];
#pragma unroll
  for (int j = 0; j < kChains; ++j) {
    x[j] = 1e-3 * (threadIdx.x + j);
    y[j] = REGS ? a - 1e-12 * (threadIdx.x + j) : a;
    z[j] = REGS ? b * (threadIdx.x + j + 1) : b;
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < kChains; ++j) x[j] = fma(x[j], y[j], z[j]);
  }
  double sum = 0.0;
#pragma unroll
  for (int j = 0; j < kChains; ++j) sum += x[j];
  out[(size_t)blockIdx.x * kThreads + threadIdx.x] = sum;
}

}  // namespace

extern "C" {

// out: blocks * 256 doubles. Does blocks * 256 * iters * 8 multiply-adds,
// with the factors in registers (regs != 0) or constant.
int fea_probe_dfma(double* out, int blocks, int iters, int regs, double a, double b,
                   void* stream) {
  if (blocks <= 0 || iters <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (regs)
    dfma_kernel<true><<<blocks, kThreads, 0, s>>>(out, iters, a, b);
  else
    dfma_kernel<false><<<blocks, kThreads, 0, s>>>(out, iters, a, b);
  return (int)cudaGetLastError();
}

}  // extern "C"
