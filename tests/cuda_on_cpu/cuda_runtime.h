// A CPU stand-in for the CUDA runtime, for running the port's kernels
// (fea_large_tpu_torch/csrc/*.cu) in the CPU tests, where there is no nvcc
// and no card: tests/test_torch_kernels_on_cpu.py compiles a kernel source
// against this header with g++ and calls its C interface on CPU tensors.
//
// A launch runs its blocks one after another; the threads of a block are
// real host threads, so that the kernels' cooperation is exercised and not
// only their arithmetic: __syncthreads() is a barrier of the block,
// __syncwarp() one of the warp, and __shfl_xor_sync exchanges values
// through a slot per thread between two barriers of the warp. A thread that returns early leaves both barriers,
// as an exited CUDA thread does. __shared__ is a static: one block runs at
// a time. This checks indexing, masking, reductions and their order; it
// says nothing about speed, registers or what nvcc accepts.
#pragma once
#include <math.h>

#include <algorithm>
#include <barrier>
#include <cstddef>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __shared__ static

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx;
inline dim3 blockIdx, blockDim, gridDim;

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }

template <class T>
inline T __ldg(const T* p) { return *p; }

struct alignas(16) float4 {
  float x, y, z, w;
};
inline float4 make_float4(float x, float y, float z, float w) { return float4{x, y, z, w}; }

namespace cuda_on_cpu {
inline std::barrier<>* block_barrier;
inline std::vector<std::unique_ptr<std::barrier<>>> warp_barriers;
inline unsigned long long slots[1024];
}  // namespace cuda_on_cpu

inline void __syncthreads() { cuda_on_cpu::block_barrier->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  cuda_on_cpu::warp_barriers[threadIdx.x / 32]->arrive_and_wait();
}

template <class T>
inline T __shfl_xor_sync(unsigned, T v, int lane_mask) {
  static_assert(sizeof(T) <= sizeof(unsigned long long));
  const unsigned tid = threadIdx.x;
  std::barrier<>& warp = *cuda_on_cpu::warp_barriers[tid / 32];
  std::memcpy(&cuda_on_cpu::slots[tid], &v, sizeof(T));
  warp.arrive_and_wait();
  T out;
  std::memcpy(&out, &cuda_on_cpu::slots[(tid & ~31u) | ((tid ^ lane_mask) & 31u)], sizeof(T));
  warp.arrive_and_wait();
  return out;
}

// kernel<<<grid, block, shared, stream>>>(args...) is rewritten by the test
// into CUDA_ON_CPU_LAUNCH((kernel), grid, block, args...).
template <class Body>
inline void cuda_on_cpu_launch(unsigned grid, unsigned block, Body body) {
  gridDim = dim3(grid);
  blockDim = dim3(block);
  for (unsigned b = 0; b < grid; ++b) {
    blockIdx = dim3(b);
    std::barrier<> block_barrier(block);
    cuda_on_cpu::block_barrier = &block_barrier;
    cuda_on_cpu::warp_barriers.clear();
    for (unsigned w = 0; w < (block + 31) / 32; ++w)
      cuda_on_cpu::warp_barriers.push_back(
          std::make_unique<std::barrier<>>(std::min(32u, block - 32 * w)));
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < block; ++t)
      threads.emplace_back([&, t] {
        threadIdx = dim3(t);
        body();
        block_barrier.arrive_and_drop();
        cuda_on_cpu::warp_barriers[t / 32]->arrive_and_drop();
      });
    for (std::thread& th : threads) th.join();
  }
}
#define CUDA_ON_CPU_LAUNCH(kernel, grid, block, ...) \
  cuda_on_cpu_launch((grid), (block), [&] { kernel(__VA_ARGS__); })
