// The masked-attention decoder's attention mask, for Hopper (sm_90a): one
// launch from a layer's mask logits to the next layer's boolean mask.
//
// Replaces no TPU kernel: the JAX package resizes and thresholds with XLA
// (weed_instance_segmentation_tpu/models/transformer_decoder.py). The port's
// plain version, ops/attention_mask.py::attention_mask_plain, runs
// F.interpolate (bilinear, align_corners=False) over B*Q one-channel planes,
// then sigmoid, `< 0.5`, a row `all` and `& ~` as separate launches. This
// kernel computes that function in one launch: for every row (b, q) of the
// (B, Q, H, W) logits and every output position p = y * w + x of the target
// (h, w),
//
//   v = round(bilinear(logits[b, q], y, x))     (the logit itself where
//                                                 (h, w) == (H, W))
//   blocked[p] = round(1 / (1 + exp(-v))) < 0.5
//   out[b, 0, q, p] = blocked[p] && !(every position of the row blocked)
//
// with `round` to the logits' type (the identity for float32). The taps,
// lambdas and weighted sum are PyTorch's CUDA bilinear kernel's, written as
// the same float expressions (aten/src/ATen/native/cuda/UpSample.cuh::
// area_pixel_compute_source_index and UpSampleBilinear2d.cu), so that nvcc
// contracts them as it contracts PyTorch's; the sigmoid is PyTorch's CUDA
// sigmoid, 1 / (1 + expf(-v)) in float32, rounded to the type. So the mask
// is the plain version's, bit for bit, in float32 and bfloat16.
//
// What bounds it: bytes and latency, not arithmetic. At the serving shape
// (B 4, Q 200, 200x200 bf16 logits) a 100x100 mask reads each logit once,
// 64 MB, and writes 8 MB: about 21 us at 3.35 TB/s; a 25x25 mask reads 2 of
// every 8 rows and columns. PyTorch's resize gives one thread to each output
// pixel and loops it over the 800 planes, so at 25x25 the whole card holds
// 625 threads. The design:
//   - one block a row (b, q), its 256 threads on consecutive output
//     positions, so that a warp's 2x2 taps are neighbouring logits that one
//     or two cache lines hold, and 800 rows fill the 132 SMs;
//   - the row's decisions stay in shared memory (h * w bytes, 10 KB at
//     100x100), placed at the output row's offset within 16 bytes; one
//     block-wide OR (__syncthreads_or) finds a row with no open position;
//   - the row then leaves in 16-byte stores, or as zeros where every
//     position was blocked (the all-masked escape); only the bytes the row
//     shares with a 16-byte chunk of its neighbour rows are stored one by one.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// x rounded to T and widened again (the identity for float)
template <typename T>
__device__ __forceinline__ float rounded(float x) {
  return to_f(from_f<T>(x));
}

// PyTorch's area_pixel_compute_source_index for align_corners=False, linear
__device__ __forceinline__ float source_index(float scale, int dst) {
  const float src = scale * (dst + 0.5f) - 0.5f;
  return src < 0.f ? 0.f : src;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_mask_kernel(const T* __restrict__ logits, uint8_t* __restrict__ out, int in_h, int in_w,
                      int out_h, int out_w, float rheight, float rwidth) {
  extern __shared__ uint4 smem[];
  uint8_t* decided = reinterpret_cast<uint8_t*>(smem);
  const int hw = out_h * out_w;
  const long long row = blockIdx.x;
  const T* plane = logits + row * in_h * in_w;
  uint8_t* row_out = out + row * hw;
  // the row's first byte sits `pad` bytes into a 16-byte chunk; decision p
  // is held at pad + p, so that shared chunk c is global chunk c from `base`
  const int pad = static_cast<int>(reinterpret_cast<uintptr_t>(row_out) & 15u);
  const bool identity = in_h == out_h && in_w == out_w;

  int open = 0;
#pragma unroll 4
  for (int p = threadIdx.x; p < hw; p += kThreads) {
    float v;
    if (identity) {
      v = to_f(plane[p]);
    } else {
      const int y = p / out_w, x = p - y * out_w;
      const float h1r = source_index(rheight, y);
      const int h1 = static_cast<int>(h1r);
      const int h1p = h1 < in_h - 1 ? in_w : 0;
      const float h1lambda = h1r - h1;
      const float h0lambda = 1.f - h1lambda;
      const float w1r = source_index(rwidth, x);
      const int w1 = static_cast<int>(w1r);
      const int w1p = w1 < in_w - 1 ? 1 : 0;
      const float w1lambda = w1r - w1;
      const float w0lambda = 1.f - w1lambda;
      const T* tap = plane + h1 * in_w + w1;
      v = rounded<T>(h0lambda * (w0lambda * to_f(tap[0]) + w1lambda * to_f(tap[w1p])) +
                     h1lambda * (w0lambda * to_f(tap[h1p]) + w1lambda * to_f(tap[h1p + w1p])));
    }
    const bool blocked = rounded<T>(1.f / (1.f + expf(-v))) < 0.5f;
    decided[pad + p] = blocked;
    open |= !blocked;
  }
  const bool escape = !__syncthreads_or(open);

  uint8_t* base = row_out - pad;  // 16-byte aligned
  const int end = pad + hw;
  for (int c = threadIdx.x; c * 16 < end; c += kThreads) {
    const int lo = c * 16, hi = lo + 16;
    if (lo >= pad && hi <= end) {
      reinterpret_cast<uint4*>(base)[c] = escape ? make_uint4(0u, 0u, 0u, 0u) : smem[c];
    } else {  // a chunk shared with a neighbour row: this row's bytes only
      for (int j = lo > pad ? lo : pad; j < (hi < end ? hi : end); ++j)
        base[j] = escape ? 0 : decided[j];
    }
  }
}

template <typename T>
int launch(const void* logits, void* out, int rows, int in_h, int in_w, int out_h, int out_w,
           cudaStream_t stream) {
  const long long hw = static_cast<long long>(out_h) * out_w;
  const int shared = static_cast<int>((hw + 15 + 15) / 16 * 16);  // pad + hw, whole chunks
  if (shared > kSharedLimit) return static_cast<int>(cudaErrorInvalidValue);
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_mask_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // the source scales as PyTorch forms them: float(input) / output
  const float rheight = static_cast<float>(in_h) / out_h;
  const float rwidth = static_cast<float>(in_w) / out_w;
  attention_mask_kernel<T><<<rows, kThreads, shared, stream>>>(
      static_cast<const T*>(logits), static_cast<uint8_t*>(out), in_h, in_w, out_h, out_w,
      rheight, rwidth);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// logits (rows, in_h, in_w) contiguous, float32 or bfloat16 (`bf16`); out
// (rows, out_h * out_w) bool, contiguous, any alignment. Launch on `stream`;
// return cudaGetLastError() (or cudaErrorInvalidValue for sizes the kernel
// does not take: out_h * out_w + 30 bytes must fit a block's shared memory).
extern "C" int wis_attention_mask(const void* logits, void* out, int rows, int in_h, int in_w,
                                  int out_h, int out_w, int bf16, void* stream) {
  if (rows < 0 || in_h < 1 || in_w < 1 || out_h < 1 || out_w < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(logits, out, rows, in_h, in_w, out_h, out_w, s)
              : launch<float>(logits, out, rows, in_h, in_w, out_h, out_w, s);
}
