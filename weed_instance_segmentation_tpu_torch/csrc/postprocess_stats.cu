// Fused post-process statistics for Mask2Former instance segmentation, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// weed_instance_segmentation_tpu/ops/postprocess_kernel.py::fused_upsample_stats
// (body `_kernel`). For every (batch, query) mask-logit map (Hm, Wm) it
// computes, in one pass, the bilinear upsample to the scoring resolution
// (SH, SW) and three reductions of it:
//   sig_sum[map] = sum of sigmoid(up) over pixels where up > 0
//   pos_cnt[map] = number of pixels where up > 0
//   bins[map]    = (up > 0) as int8, row-major (SH, SW)
// The upsampled logits never reach device memory.
//
// Each output pixel is the 2x2-tap bilinear form with the taps of
// ops/resize.py::bilinear_resize_matrix (built on the host, passed as small
// index/weight arrays): rows first, then columns, as Wy . M . Wx^T does. The
// result equals that matrix product up to float32 summation order.
//
// What bounds it: memory. At the serving shape (4 x 200 maps of 200x200 f32
// in, 384x384 int8 out) it reads 128 MB and writes 118 MB, a floor of about
// 74 us at the H100's 3.35 TB/s. The design: one block per map, threads
// striding over the map's outputs so that the int8 stores of a warp are
// contiguous; the 160 KB logit map is read through L1/L2 (each logit feeds
// about four outputs). The per-map sums are reduced with warp shuffles and one
// shared-memory pass. Staging the map in shared memory or loading it with TMA
// is left for later.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
upsample_stats_kernel(const float* __restrict__ logits,
                      const int* __restrict__ y_idx,    // (2, sh): lo, then hi
                      const float* __restrict__ y_w,    // (2, sh): w_lo, then w_hi
                      const int* __restrict__ x_idx,    // (2, sw)
                      const float* __restrict__ x_w,    // (2, sw)
                      float* __restrict__ sig_sum,      // (maps,)
                      float* __restrict__ pos_cnt,      // (maps,)
                      int8_t* __restrict__ bins,        // (maps, sh, sw)
                      int hm, int wm, int sh, int sw) {
  const long long map = blockIdx.x;
  const float* m = logits + map * hm * wm;
  int8_t* out = bins + map * sh * sw;
  const int n = sh * sw;

  float sig = 0.f;
  int cnt = 0;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int oy = i / sw;
    const int ox = i - oy * sw;
    const float* row0 = m + y_idx[oy] * wm;
    const float* row1 = m + y_idx[sh + oy] * wm;
    const float wy0 = y_w[oy], wy1 = y_w[sh + oy];
    const int x0 = x_idx[ox], x1 = x_idx[sw + ox];
    const float r0 = wy0 * row0[x0] + wy1 * row1[x0];
    const float r1 = wy0 * row0[x1] + wy1 * row1[x1];
    const float up = x_w[ox] * r0 + x_w[sw + ox] * r1;
    const bool pos = up > 0.f;
    out[i] = pos ? 1 : 0;
    if (pos) {
      sig += 1.f / (1.f + expf(-up));
      ++cnt;
    }
  }

  __shared__ float s_sig[kWarps];
  __shared__ int s_cnt[kWarps];
  for (int off = 16; off > 0; off >>= 1) {
    sig += __shfl_down_sync(0xffffffffu, sig, off);
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s_sig[warp] = sig;
    s_cnt[warp] = cnt;
  }
  __syncthreads();
  if (warp == 0) {
    sig = lane < kWarps ? s_sig[lane] : 0.f;
    cnt = lane < kWarps ? s_cnt[lane] : 0;
    for (int off = 16; off > 0; off >>= 1) {
      sig += __shfl_down_sync(0xffffffffu, sig, off);
      cnt += __shfl_down_sync(0xffffffffu, cnt, off);
    }
    if (lane == 0) {
      sig_sum[map] = sig;
      pos_cnt[map] = static_cast<float>(cnt);
    }
  }
}

}  // namespace

// Launches on `stream` (PyTorch's current stream); returns cudaGetLastError()
// so the caller can raise on a refused launch. All pointers are device
// pointers to contiguous arrays of the shapes noted on the kernel.
extern "C" int wis_postprocess_stats(const void* logits, const void* y_idx, const void* y_w,
                                     const void* x_idx, const void* x_w, void* sig_sum,
                                     void* pos_cnt, void* bins, int maps, int hm, int wm,
                                     int sh, int sw, void* stream) {
  if (maps > 0) {
    upsample_stats_kernel<<<maps, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(logits), static_cast<const int*>(y_idx),
        static_cast<const float*>(y_w), static_cast<const int*>(x_idx),
        static_cast<const float*>(x_w), static_cast<float*>(sig_sum),
        static_cast<float*>(pos_cnt), static_cast<int8_t*>(bins), hm, wm, sh, sw);
  }
  return static_cast<int>(cudaGetLastError());
}
