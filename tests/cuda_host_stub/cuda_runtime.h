// A host stand-in for the CUDA runtime header, so that a kernel source can
// be compiled by g++ and its grid run on the CPU, one thread after another
// (tests/test_torch_kernels.py::test_msda_source_on_the_cpu_gives_the_plain_bits).
// It defines what msda.cu and common.cuh use, with the device intrinsics'
// round-to-nearest arithmetic; a launch `k<<<blocks, threads, ...>>>(...)`
// becomes `EMULATE_GRID(blocks, threads) k(...)`.
#pragma once
#include <math.h>
#include <stdint.h>
#include <string.h>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __launch_bounds__(...)
#define __align__(n)

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

struct uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) { return {x, y, z, w}; }
struct dim3_ { unsigned x, y, z; };
static dim3_ blockIdx, threadIdx;
#define EMULATE_GRID(blocks, threads)                                               \
  for (blockIdx.x = 0; blockIdx.x < static_cast<unsigned>(blocks); ++blockIdx.x)    \
    for (threadIdx.x = 0; threadIdx.x < static_cast<unsigned>(threads); ++threadIdx.x)

inline float __uint_as_float(unsigned u) { float f; memcpy(&f, &u, 4); return f; }
inline unsigned __float_as_uint(float f) { unsigned u; memcpy(&u, &f, 4); return u; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
template <typename T> T __ldg(const T* p) { return *p; }
inline float __shfl_xor_sync(unsigned, float v, int) { return v; }
