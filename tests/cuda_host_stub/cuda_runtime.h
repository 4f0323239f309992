// A host stand-in for the CUDA runtime header, so that a kernel source can
// be compiled by g++ and its grid run on the CPU
// (tests/test_torch_kernels.py::test_msda_source_on_the_cpu_gives_the_plain_bits,
// ::test_attention_mask_source_on_the_cpu_gives_the_plain_bits). It defines
// what msda.cu, attention_mask.cu and common.cuh use, with the device
// intrinsics' round-to-nearest arithmetic. A launch `k<<<blocks, threads,
// ...>>>(...)` becomes either `EMULATE_GRID(blocks, threads) k(...)`, one
// thread after another (a kernel with no barrier), or `emulate_blocks(blocks,
// threads, [&] { k(...); })`, a block at a time with one host thread per
// CUDA thread, so that __syncthreads_or is a real barrier; there a kernel's
// `extern __shared__` array becomes a `static` one, which the block's
// threads share.
#pragma once
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <condition_variable>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __launch_bounds__(...)
#define __align__(n)

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <typename F> cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}

struct uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) { return {x, y, z, w}; }
struct dim3_ { unsigned x, y, z; };
static dim3_ blockIdx;
static thread_local dim3_ threadIdx;
#define EMULATE_GRID(blocks, threads)                                               \
  for (blockIdx.x = 0; blockIdx.x < static_cast<unsigned>(blocks); ++blockIdx.x)    \
    for (threadIdx.x = 0; threadIdx.x < static_cast<unsigned>(threads); ++threadIdx.x)

// the barrier of the block that runs: every thread's predicate ORed
struct BlockBarrier {
  std::mutex m;
  std::condition_variable cv;
  unsigned threads = 0, arrived = 0, generation = 0;
  int any = 0, result = 0;
};
static BlockBarrier block_barrier;

inline int __syncthreads_or(int predicate) {
  std::unique_lock<std::mutex> lock(block_barrier.m);
  block_barrier.any |= predicate != 0;
  const unsigned generation = block_barrier.generation;
  if (++block_barrier.arrived == block_barrier.threads) {
    block_barrier.result = block_barrier.any;
    block_barrier.any = 0;
    block_barrier.arrived = 0;
    ++block_barrier.generation;
    block_barrier.cv.notify_all();
  } else {
    block_barrier.cv.wait(lock, [&] { return block_barrier.generation != generation; });
  }
  return block_barrier.result;
}
inline void __syncthreads() { __syncthreads_or(0); }

template <typename F>
void emulate_blocks(unsigned blocks, unsigned threads, F&& body) {
  block_barrier.threads = threads;
  for (blockIdx.x = 0; blockIdx.x < blocks; ++blockIdx.x) {
    std::vector<std::thread> pool;
    for (unsigned t = 0; t < threads; ++t)
      pool.emplace_back([&body, t] {
        threadIdx.x = t;
        body();
      });
    for (auto& thread : pool) thread.join();
  }
}

inline float __uint_as_float(unsigned u) { float f; memcpy(&f, &u, 4); return f; }
inline unsigned __float_as_uint(float f) { unsigned u; memcpy(&u, &f, 4); return u; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
template <typename T> T __ldg(const T* p) { return *p; }
inline float __shfl_xor_sync(unsigned, float v, int) { return v; }
