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
// ops/resize.py::bilinear_resize_matrix (built on the host as one int4 per
// output row or column: lo, hi and the bits of their two weights): rows
// first, then columns, as Wy . M . Wx^T does. The result equals that matrix
// product up to float32 summation order.
//
// What bounds it: memory, then instruction issue. At the serving shape
// (4 x 200 maps of 200x200 f32 in, 384x384 int8 out) it reads 128 MB and
// writes 118 MB, a floor of about 74 us at the H100's 3.35 TB/s. Each output
// pixel also takes about 20 instructions (two shared loads, the taps, a
// compare, a ballot, a sigmoid of two SFU operations, its share of the bin
// store), which on 132 SMs issuing 4 warp-instructions a clock is about as
// long again, so the kernel reaches about half the byte bound. The design:
//   - one block per (map, band of `band_rows` output rows), the bands of a
//     map in consecutive blocks, so that a halo row two bands share is read
//     from L2, and enough blocks for several waves;
//   - the band's input rows, a contiguous span of the map, are staged in
//     shared memory by 16-byte cp.async copies (4-byte copies where the span
//     starts or ends off a 16-byte boundary), so every logit leaves HBM about
//     once;
//   - a vertical pass makes the band's rows x Wm column-interpolated values
//     once, into shared memory (float4s where the rows are 16-byte aligned);
//     a horizontal pass makes the outputs, each warp 128 consecutive pixels of
//     a row (lane l the pixels l, l + 32, ..., so that its shared-memory reads
//     do not conflict) with that segment's column taps in registers; neither
//     pass divides per pixel;
//   - where SW % 16 == 0 the bins come from the warp's ballots, four to a
//     lane as a 32-bit word, gathered in the span's buffer once the span is
//     read; the band's bins, one contiguous run of the output, then leave by
//     one bulk asynchronous copy (cp.async.bulk, the TMA engine). Other
//     widths store one byte a pixel;
//   - the sigmoid where up > 0 by ex2.approx and rcp.approx; a warp with no
//     positive pixel in a row skips it;
//   - deterministic sums: each block writes its band's partial sum and
//     integer count, and a second small launch adds each map's partials in
//     band order. There are no atomics, so two calls give the same bits.
// Timed and dropped (PERF.md): blocks that walk
// a run of bands with the next span copied while they compute (slower: fewer
// warps an SM), and two rows a step in each warp (no faster).

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr int kSegment = 128;  // outputs of a row that a warp makes at once: 4 a lane
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float bits_f(int v) { return __int_as_float(v); }

// 1 / x by the SFU (rcp.approx.ftz: within 1 ulp)
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a float of shared memory at a byte address
__device__ __forceinline__ float lds(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

// Block (map, band): stage, vertical pass, horizontal pass, band partials.
// Shared memory, laid out by the caller: from float 0 the staged span
// (placed so that its 16-byte-aligned elements land on 16-byte boundaries)
// and, once the vertical pass has read it, the band's bins (kTile); from
// float v_off the band's band_rows x wm vertical values; from float y_off its
// band_rows row taps. kTile: the bins leave by one bulk copy a band, else by
// one byte a pixel.
template <bool kTile>
__global__ void __launch_bounds__(kMaxThreads)
upsample_stats_band_kernel(const float* __restrict__ logits,
                           const int4* __restrict__ y_taps,  // (sh,): lo, hi, w_lo, w_hi bits
                           const int4* __restrict__ x_taps,  // (sw,)
                           float* __restrict__ sig_part,     // (maps, bands)
                           int* __restrict__ cnt_part,       // (maps, bands)
                           int8_t* __restrict__ bins,        // (maps, sh, sw)
                           int hm, int wm, int sh, int sw, int band_rows, int bands,
                           int v_off, int y_off) {
  extern __shared__ __align__(16) float smem[];
  const int map = blockIdx.x / bands;
  const int band = blockIdx.x - map * bands;
  const int oy0 = band * band_rows;
  const int rows = min(band_rows, sh - oy0);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, nwarps = nthreads / 32;

  float* s_in = smem;
  int8_t* s_bins = reinterpret_cast<int8_t*>(smem);
  float* s_v = smem + v_off;                          // band_rows * wm
  int4* s_y = reinterpret_cast<int4*>(smem + y_off);  // band_rows

  // the taps are monotone, so the band's input rows are lo of its first row
  // to hi of its last: one contiguous run of the map
  const int r_lo = y_taps[oy0].x;
  const int n = (y_taps[oy0 + rows - 1].y - r_lo + 1) * wm;
  const float* src = logits + static_cast<long long>(map) * hm * wm +
                     static_cast<long long>(r_lo) * wm;
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  float* dst = s_in + mis;  // dst[k] and src[k] share their offset within 16 bytes
  const int head = min((4 - mis) & 3, n);
  const int body = (n - head) & ~3;
  for (int k = tid; k < head; k += nthreads) cp_async_4(dst + k, src + k, true);
  for (int k = head + 4 * tid; k < head + body; k += 4 * nthreads)
    cp_async_16(dst + k, src + k, true);
  for (int k = head + body + tid; k < n; k += nthreads) cp_async_4(dst + k, src + k, true);
  cp_async_commit();
  for (int r = tid; r < rows; r += nthreads) {
    int4 t = y_taps[oy0 + r];
    t.x -= r_lo;
    t.y -= r_lo;
    s_y[r] = t;
  }

  // this warp's share of the horizontal pass: a segment of kSegment columns
  // (taps in registers) and every `row_step`-th row from `row0`
  const int segments = (sw + kSegment - 1) / kSegment;
  int seg0, seg_step, row0, row_step;
  if (nwarps >= segments) {
    row_step = nwarps / segments;
    seg0 = warp % segments;
    seg_step = segments;
    row0 = warp < row_step * segments ? warp / segments : rows;  // spare warps idle
  } else {
    seg0 = warp;
    seg_step = nwarps;
    row0 = 0;
    row_step = 1;
  }

  cp_async_wait<0>();
  __syncthreads();

  // vertical pass: s_v[r][x] = w_lo * span[lo][x] + w_hi * span[hi][x], in
  // float4s where the rows are 16-byte aligned; a flat walk over (r, x)
  // that steps without dividing
  if (wm % 4 == 0 && mis == 0) {
    const int w4 = wm / 4;
    const float4* in4 = reinterpret_cast<const float4*>(dst);
    float4* v4 = reinterpret_cast<float4*>(s_v);
    const int dr = nthreads / w4, dx = nthreads - dr * w4;
    int r = tid / w4, x = tid - r * w4;
    while (r < rows) {
      const int4 t = s_y[r];
      const float w0 = bits_f(t.z), w1 = bits_f(t.w);
      const float4 a = in4[t.x * w4 + x], b = in4[t.y * w4 + x];
      v4[r * w4 + x] = make_float4(w0 * a.x + w1 * b.x, w0 * a.y + w1 * b.y,
                                   w0 * a.z + w1 * b.z, w0 * a.w + w1 * b.w);
      x += dx;
      r += dr;
      if (x >= w4) {
        x -= w4;
        ++r;
      }
    }
  } else {
    const int dr = nthreads / wm, dx = nthreads - dr * wm;
    int r = tid / wm, x = tid - r * wm;
    while (r < rows) {
      const int4 t = s_y[r];
      s_v[r * wm + x] = bits_f(t.z) * dst[t.x * wm + x] + bits_f(t.w) * dst[t.y * wm + x];
      x += dx;
      r += dr;
      if (x >= wm) {
        x -= wm;
        ++r;
      }
    }
  }
  __syncthreads();  // from here region A may hold the bins

  // horizontal pass, bins and the band's sums. Step j of a segment: lane l
  // makes pixel ox0 + 32 j + l, and the warp's ballot holds the step's 32
  // bins; with kTile lane l then writes pixels 4l .. 4l + 3, bits 4l % 32 ..
  // + 3 of the ballot of step l / 8, as four bytes of 0 or 1.
  float sig = 0.f;
  int cnt = 0;
  const int my_step = lane / 8, my_bits = (4 * lane) % 32;
  for (int seg = seg0; seg < segments; seg += seg_step) {
    const int ox0 = seg * kSegment;
    uint32_t lo_off[4], hi_off[4];  // byte offsets into a row of s_v
    float wx0[4], wx1[4];
    bool in_row[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ox = ox0 + 32 * j + lane;
      in_row[j] = ox < sw;
      const int4 t = in_row[j] ? x_taps[ox] : make_int4(0, 0, 0, 0);
      lo_off[j] = 4 * t.x;
      hi_off[j] = 4 * t.y;
      wx0[j] = bits_f(t.z);
      wx1[j] = bits_f(t.w);
    }
    for (int r = row0; r < rows; r += row_step) {
      const uint32_t v = smem_addr(s_v + r * wm);
      float up[4];
      bool pos[4];
      uint32_t ballot[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        up[j] = wx0[j] * lds(v + lo_off[j]) + wx1[j] * lds(v + hi_off[j]);
        pos[j] = in_row[j] && up[j] > 0.f;
        ballot[j] = __ballot_sync(0xffffffffu, pos[j]);
      }
      if ((ballot[0] | ballot[1] | ballot[2] | ballot[3]) != 0) {  // the warp, or none of it
#pragma unroll
        for (int j = 0; j < 4; ++j)  // a pixel that is not positive adds 1 / (1 + 2^inf) = 0
          sig += rcp_approx(1.f + exp2_approx(pos[j] ? -kLog2e * up[j] : INFINITY));
      }
      if (!kTile) {
        int8_t* out = bins + (static_cast<long long>(map) * sh + oy0 + r) * sw + ox0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          cnt += pos[j];
          if (in_row[j]) out[32 * j + lane] = static_cast<int8_t>(pos[j]);
        }
      } else {
        const uint32_t mine = my_step == 0 ? ballot[0]
                              : my_step == 1 ? ballot[1]
                              : my_step == 2 ? ballot[2] : ballot[3];
        const uint32_t nibble = (mine >> my_bits) & 0xfu;
        cnt += __popc(nibble);
        // bit k of the nibble to byte k (the shifted copies never overlap)
        const int word = static_cast<int>((nibble * 0x204081u) & 0x01010101u);
        if (ox0 + 4 * lane < sw) reinterpret_cast<int*>(s_bins + r * sw + ox0)[lane] = word;
      }
    }
  }
  if (kTile) {
    // the band's rows are one contiguous run of the map's bins
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid == 0) {
      int8_t* out = bins + (static_cast<long long>(map) * sh + oy0) * sw;
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
          "cp.async.bulk.commit_group;\n" ::"l"(out),
          "r"(smem_addr(s_bins)), "r"(rows * sw)
          : "memory");
    }
  }

  // the block's sums in a fixed order: lanes by xor shuffles, then warps
  __shared__ float w_sig[kMaxThreads / 32];
  __shared__ int w_cnt[kMaxThreads / 32];
  for (int off = 16; off > 0; off >>= 1) {
    sig += __shfl_xor_sync(0xffffffffu, sig, off);
    cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
  }
  if (lane == 0) {
    w_sig[warp] = sig;
    w_cnt[warp] = cnt;
  }
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    int c = 0;
    for (int w = 0; w < nwarps; ++w) {
      s += w_sig[w];
      c += w_cnt[w];
    }
    sig_part[blockIdx.x] = s;
    cnt_part[blockIdx.x] = c;
    // the block's shared memory must outlive the bulk copy's reads
    if (kTile) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// One thread a map: its band partials added in band order.
__global__ void band_sums_kernel(const float* __restrict__ sig_part,
                                 const int* __restrict__ cnt_part, float* __restrict__ sig_sum,
                                 float* __restrict__ pos_cnt, int maps, int bands) {
  const int map = blockIdx.x * blockDim.x + threadIdx.x;
  if (map >= maps) return;
  float s = 0.f;
  int c = 0;
  for (int b = 0; b < bands; ++b) {
    s += sig_part[static_cast<long long>(map) * bands + b];
    c += cnt_part[static_cast<long long>(map) * bands + b];
  }
  sig_sum[map] = s;
  pos_cnt[map] = static_cast<float>(c);
}

}  // namespace

// Launches both kernels on `stream` (PyTorch's current stream); returns the
// first CUDA error (cudaErrorInvalidValue for a layout the kernel does not
// take, or shared memory beyond the card's limit) so the caller can raise.
// All pointers are device pointers to contiguous arrays: logits
// (maps, hm, wm) f32; y_taps (sh, 4) and x_taps (sw, 4) int32 (lo, hi,
// float bits of w_lo, w_hi); sig_part and cnt_part (maps, bands) scratch,
// bands = ceil(sh / band_rows); sig_sum, pos_cnt (maps,) f32; bins
// (maps, sh, sw) int8. The caller lays out a block's shared memory
// (ops/postprocess_kernel.py::shared_layout: v_off, y_off and shared_bytes,
// sized for the most input rows a band reads) and chooses the bulk-copy
// stores (tile_stores: SW % 16 == 0 and bins 16-byte aligned).
extern "C" int wis_postprocess_stats(const void* logits, const void* y_taps, const void* x_taps,
                                     void* sig_part, void* cnt_part, void* sig_sum,
                                     void* pos_cnt, void* bins, int maps, int hm, int wm, int sh,
                                     int sw, int band_rows, int tile_stores, int v_off, int y_off,
                                     int shared_bytes, int threads, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (maps <= 0) return static_cast<int>(cudaGetLastError());
  const int bands = (sh + band_rows - 1) / band_rows;
  if (threads < 32 || threads > kMaxThreads || threads % 32 || band_rows < 1 ||
      static_cast<long long>(maps) * bands >= (1LL << 31) || v_off % 4 || y_off % 4 ||
      (tile_stores && (sw % 16 || reinterpret_cast<uintptr_t>(bins) % 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel =
      tile_stores ? upsample_stats_band_kernel<true> : upsample_stats_band_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         shared_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<maps * bands, threads, shared_bytes, s>>>(
      static_cast<const float*>(logits), static_cast<const int4*>(y_taps),
      static_cast<const int4*>(x_taps), static_cast<float*>(sig_part),
      static_cast<int*>(cnt_part), static_cast<int8_t*>(bins), hm, wm, sh, sw, band_rows, bands,
      v_off, y_off);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  band_sums_kernel<<<(maps + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(sig_part), static_cast<const int*>(cnt_part),
      static_cast<float*>(sig_sum), static_cast<float*>(pos_cnt), maps, bands);
  return static_cast<int>(cudaGetLastError());
}
