// Multi-scale deformable attention (MSDA) sampling sum, forward, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes MSDA with XLA routes
// (weed_instance_segmentation_tpu/ops/msda_{fused,packed,select}.py), and
// the port's plain version is ops/deformable_attention.py::_msda_fused,
// twelve row gathers over a flat value table and their elementwise tail.
// This kernel computes that function, with its rounding, in one launch:
// for every (batch b, query q, head h) and channel d,
//
//   out[b, q, h*D + d] = sum over levels l, corners (dy, dx), in that order,
//     of round(sum over points p, in order, of round(v[tap] * w_tap))
//
// with the running sum rounded to the value type after every corner and
// the tap weight w_tap = round(((xw * yw) * in_bounds) * attention weight),
// formed in float32 from x = loc_x * W_l - 0.5, y = loc_y * H_l - 0.5 and
// their floors (grid_sample's align_corners=False, zero padding). Every
// float operation is an explicit __fmul_rn / __fadd_rn / __fsub_rn, so no
// multiply-add is contracted and the bits are those of the plain version's
// separate PyTorch ops. At float32, "round" is the identity. An
// out-of-range corner reads no row: its products are 0 * w_tap, as the
// plain version's clamped row times a zero weight (NaN where w_tap is NaN).
//
// What bounds it: not HBM and not the tensor cores (it has none to use).
// One serving call (Swin-L 800², batch 4: 13125 queries, 8 heads, 3 levels,
// 4 points, D 32 bf16) needs the 26.9 MB value table, 30.2 MB of bf16
// locations and weights and the 26.9 MB output: 84 MB, 25 us at 3.35 TB/s.
// But it makes 20.2 M tap reads of a 64-byte row, 1.29 GB from L2, about
// 0.2-0.3 ms at the L2's rate: the gather through L2, and the latency of
// each dependent read, bound it. The design:
//   - `value` is read in its native (B, L, heads, D) layout: a tap is one
//     contiguous row of D values (64 bytes at D 32 bf16), so the plain
//     version's transposed copy of the table is not made;
//   - a group of G = D * sizeof(T) / 16 lanes serves one (b, q, h) and
//     loads each row in 16-byte pieces, one a lane (4 lanes at D 32 bf16, so
//     a warp serves 8 heads of one query);
//   - consecutive blocks take consecutive queries of one image, heads
//     inner, so that neighbouring queries sample neighbouring rows and the
//     table of one call stays in the 50 MB L2;
//   - each lane keeps its 4 corners' point sums in registers and issues the
//     4 corner loads of a point together;
//   - no shared memory and no atomics: each output element is written once,
//     by one lane, in a fixed order, so two calls give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 4;

struct Levels {
  int h[kMaxLevels], w[kMaxLevels], start[kMaxLevels];  // start: first row of the level
};

// x rounded to T and widened again (the identity for float)
template <typename T>
__device__ __forceinline__ float rounded(float x) {
  return to_f(from_f<T>(x));
}

// the 16 bytes of a lane widened to floats
__device__ __forceinline__ void widen(uint4 raw, float (&v)[4]) {
  v[0] = __uint_as_float(raw.x);
  v[1] = __uint_as_float(raw.y);
  v[2] = __uint_as_float(raw.z);
  v[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void widen(uint4 raw, float (&v)[8]) {
  const uint32_t u[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// floats that hold values of T narrowed into 16 bytes (exact: each is
// already a value of T)
__device__ __forceinline__ uint4 narrow(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                    __float_as_uint(v[3]));
}
__device__ __forceinline__ uint4 narrow(const float (&v)[8]) {
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    u[i] = (__float_as_uint(v[2 * i]) >> 16) | (__float_as_uint(v[2 * i + 1]) & 0xffff0000u);
  return make_uint4(u[0], u[1], u[2], u[3]);
}

// T: value and output type; S: locations' and weights' type; D: head dim
template <typename T, typename S, int D>
__global__ void __launch_bounds__(kThreads)
msda_fwd_kernel(const T* __restrict__ value, const S* __restrict__ locations,
                const S* __restrict__ weights, T* __restrict__ out, Levels lv, int levels,
                int points, int nq, int heads, int l_total, int groups) {
  constexpr int C = 16 / static_cast<int>(sizeof(T));  // channels a lane holds
  constexpr int G = D / C;                              // lanes of one (b, q, h)
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int g = t / G;  // (b * nq + q) * heads + h
  if (g >= groups) return;
  const int lane = t - g * G;
  const int h = g % heads;
  const long long b = g / heads / nq;
  const long long row_stride = static_cast<long long>(heads) * D;  // elements a table row
  const T* base = value + (b * l_total * heads + h) * D + lane * C;
  const S* loc = locations + static_cast<long long>(g) * levels * points * 2;
  const S* att = weights + static_cast<long long>(g) * levels * points;

  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;

  for (int l = 0; l < levels; ++l) {
    const int hl = lv.h[l], wl = lv.w[l];
    const float fh = static_cast<float>(hl), fw = static_cast<float>(wl);
    const float y_max = static_cast<float>(hl - 1), x_max = static_cast<float>(wl - 1);
    const T* level_base = base + lv.start[l] * row_stride;
    float sums[4][C];  // corner (dy, dx) = (k >> 1, k & 1): its points' sum
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int c = 0; c < C; ++c) sums[k][c] = 0.f;

#pragma unroll 1
    for (int p = 0; p < points; ++p) {
      const int i = l * points + p;
      const float x = __fsub_rn(__fmul_rn(to_f(loc[2 * i]), fw), 0.5f);
      const float y = __fsub_rn(__fmul_rn(to_f(loc[2 * i + 1]), fh), 0.5f);
      const float level_w = to_f(att[i]);
      const float x0 = floorf(x), y0 = floorf(y);
      const float wx1 = __fsub_rn(x, x0), wy1 = __fsub_rn(y, y0);
      const float wx0 = __fsub_rn(1.f, wx1), wy0 = __fsub_rn(1.f, wy1);
      uint4 raw[4];
      float tap_w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int dy = k >> 1, dx = k & 1;
        const float iy = dy ? __fadd_rn(y0, 1.f) : y0;
        const float ix = dx ? __fadd_rn(x0, 1.f) : x0;
        const bool ok = iy >= 0.f && iy <= y_max && ix >= 0.f && ix <= x_max;
        tap_w[k] = rounded<T>(__fmul_rn(
            __fmul_rn(__fmul_rn(dx ? wx1 : wx0, dy ? wy1 : wy0), ok ? 1.f : 0.f), level_w));
        raw[k] = make_uint4(0u, 0u, 0u, 0u);
        if (ok) {
          const int row = static_cast<int>(iy) * wl + static_cast<int>(ix);
          raw[k] = __ldg(reinterpret_cast<const uint4*>(level_base + row * row_stride));
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float v[C];
        widen(raw[k], v);
#pragma unroll
        for (int c = 0; c < C; ++c)
          sums[k][c] = __fadd_rn(sums[k][c], rounded<T>(__fmul_rn(v[c], tap_w[k])));
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int c = 0; c < C; ++c)
        acc[c] = rounded<T>(__fadd_rn(acc[c], rounded<T>(sums[k][c])));
  }
  *reinterpret_cast<uint4*>(out + static_cast<long long>(g) * D + lane * C) = narrow(acc);
}

template <typename T, typename S, int D>
int launch(const void* value, const void* locations, const void* weights, void* out,
           const Levels& lv, int levels, int points, int batch, int nq, int heads, int l_total,
           cudaStream_t stream) {
  constexpr int G = D * static_cast<int>(sizeof(T)) / 16;
  const long long groups = static_cast<long long>(batch) * nq * heads;
  if (groups * G + kThreads >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>((groups * G + kThreads - 1) / kThreads);
  msda_fwd_kernel<T, S, D><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(value), static_cast<const S*>(locations),
      static_cast<const S*>(weights), static_cast<T*>(out), lv, levels, points, nq, heads,
      l_total, static_cast<int>(groups));
  return static_cast<int>(cudaGetLastError());
}

// the locations' and weights' type, for a value type and head dim
template <typename T, int D>
int launch_value(const void* value, const void* locations, const void* weights, void* out,
                 const Levels& lv, int levels, int points, int batch, int nq, int heads,
                 int l_total, int coords_bf16, cudaStream_t stream) {
  return coords_bf16
             ? launch<T, __nv_bfloat16, D>(value, locations, weights, out, lv, levels, points,
                                           batch, nq, heads, l_total, stream)
             : launch<T, float, D>(value, locations, weights, out, lv, levels, points, batch,
                                   nq, heads, l_total, stream);
}

}  // namespace

// value (batch, l_total, heads, head_dim), 16-byte aligned; locations
// (batch, nq, heads, levels, points, 2) and weights (batch, nq, heads,
// levels, points), both float32 or both bfloat16 (`coords_bf16`); out
// (batch, nq, heads * head_dim) in the value's type (`bf16`); all
// contiguous. Level l is (h_l, w_l) rows of the table from the sum of the
// earlier levels' h * w; 1 <= levels <= 4 (the unused h_l, w_l are
// ignored), sum h_l * w_l == l_total, head_dim in {16, 32, 64}. Launch on
// `stream`; return cudaGetLastError() (or cudaErrorInvalidValue for a
// shape the kernel does not take).
extern "C" int wis_msda_fwd(const void* value, const void* locations, const void* weights,
                            void* out, int batch, int l_total, int nq, int heads, int head_dim,
                            int levels, int points, int h0, int w0, int h1, int w1, int h2,
                            int w2, int h3, int w3, int bf16, int coords_bf16, void* stream) {
  if (levels < 1 || levels > kMaxLevels || points < 1 || batch < 0 || nq < 0 || heads < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || nq == 0) return static_cast<int>(cudaGetLastError());
  const int hs[kMaxLevels] = {h0, h1, h2, h3}, ws[kMaxLevels] = {w0, w1, w2, w3};
  Levels lv;
  long long start = 0;
  for (int l = 0; l < kMaxLevels; ++l) {
    lv.h[l] = l < levels ? hs[l] : 0;
    lv.w[l] = l < levels ? ws[l] : 0;
    if (l < levels && (hs[l] < 1 || ws[l] < 1)) return static_cast<int>(cudaErrorInvalidValue);
    lv.start[l] = static_cast<int>(start);
    start += static_cast<long long>(lv.h[l]) * lv.w[l];
  }
  if (start != l_total) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  WIS_DISPATCH(launch_value, value, locations, weights, out, lv, levels, points, batch, nq,
               heads, l_total, coords_bf16, s)
}
