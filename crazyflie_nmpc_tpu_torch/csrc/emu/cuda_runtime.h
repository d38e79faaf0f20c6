// Stand-in for the CUDA runtime in the CPU rehearsal of the port's kernels
// (ops/cuda/emulated.py compiles a source against it with g++ -std=c++20).
//
// The CUDA keywords are defined away; each block's threads run as
// std::threads, one std::barrier a block standing in for __syncthreads();
// the block's dynamic shared memory is filled with 0xFF bytes (NaN in every
// float type) before it starts; CFL_ASM (batch_last.cuh) makes a cp.async a
// plain copy.  The driver rewrites a `kernel<<<grid, block, smem,
// stream>>>(args)` launch into `cfl_emu::launch(kernel, grid, block, smem,
// stream)(args)` and `extern __shared__ ... name[];` into a pointer to the
// block's shared memory, `cfl_emu::shared<type>()`.  Blocks run one after
// another.
#pragma once

#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) alignas(n)

struct uint3 {
  unsigned x, y, z;
};
// the 16-byte vector types (a shared-memory row read in one load)
struct alignas(16) float4 {
  float x, y, z, w;
};
struct alignas(16) double2 {
  double x, y;
};
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};

struct CUstream_st;
typedef CUstream_st* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };

inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t e) {
  return e == cudaSuccess ? "no error" : "invalid argument";
}
template <typename F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
// the H100's 227 KB a block and 2048 threads an SM
template <typename F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, F,
                                                          int threads,
                                                          size_t smem) {
  const int by_smem = smem ? static_cast<int>(232448 / smem) : 32;
  *blocks = std::min(by_smem, 2048 / threads);
  return cudaSuccess;
}

namespace cfl_emu {

struct Context {
  uint3 thread, block, block_dim, grid_dim;
  std::barrier<>* bar;
  unsigned char* smem;
};
inline thread_local Context ctx;

template <typename T>
T* shared() {
  return reinterpret_cast<T*>(ctx.smem);
}

// kernel<<<grid, block, smem, stream>>>(args): every block in turn, its
// threads at once
template <typename... P>
struct Launch {
  void (*fn)(P...);
  dim3 grid, block;
  size_t smem;
  template <typename... A>
  void operator()(A... args) const {
    const unsigned nt = block.x * block.y * block.z;
    std::vector<unsigned char> mem(smem + 16);
    for (unsigned bz = 0; bz < grid.z; ++bz)
      for (unsigned by = 0; by < grid.y; ++by)
        for (unsigned bx = 0; bx < grid.x; ++bx) {
          std::fill(mem.begin(), mem.end(), 0xFF);
          std::barrier<> bar(nt);
          std::vector<std::thread> threads;
          threads.reserve(nt);
          for (unsigned i = 0; i < nt; ++i)
            threads.emplace_back([&, i] {
              ctx = Context{{i % block.x, i / block.x % block.y,
                             i / (block.x * block.y)},
                            {bx, by, bz},
                            {block.x, block.y, block.z},
                            {grid.x, grid.y, grid.z},
                            &bar,
                            mem.data()};
              fn(args...);
            });
          for (auto& th : threads) th.join();
        }
  }
};

template <typename... P>
Launch<P...> launch(void (*fn)(P...), dim3 grid, dim3 block, size_t smem = 0,
                    cudaStream_t = nullptr) {
  return Launch<P...>{fn, grid, block, smem};
}

}  // namespace cfl_emu

#define threadIdx (cfl_emu::ctx.thread)
#define blockIdx (cfl_emu::ctx.block)
#define blockDim (cfl_emu::ctx.block_dim)
#define gridDim (cfl_emu::ctx.grid_dim)

inline void __syncthreads() { cfl_emu::ctx.bar->arrive_and_wait(); }
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
inline double rsqrt(double x) { return 1.0 / std::sqrt(x); }
template <typename T>
T __ldcg(const T* p) {
  return *p;
}
template <typename T>
void __stcs(T* p, T v) {
  *p = v;
}
using std::max;
using std::min;
