// Swin window attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tools/ab_window_attn.py::pallas_window_attention
// (body `_win_kernel`), which computes, per window w and head h,
//   O = softmax(Q K^T / sqrt(D) + rel_bias[h]) V
// for q/k/v (NW, H, T, D). This kernel also takes the shifted-window mask
// (the Pallas kernel lacks it): attn_mask[w % nW_img] (nW_img, T, T) is added
// to the scores, in the window order of models/swin.py::window_partition, as
// models/swin.py::WindowAttention does. The backward kernel has no Pallas
// original: it gives dQ, dK, dV and dBias = sum over windows of dScores.
//
// What bounds it: memory. At Swin-L stage 1 (T = 144, D = 32) the forward does
// 4*T*D flops per score pair against 4*T*D*2 bytes (bf16) per window-head of
// q/k/v/o, so about 36 flops per byte, far below the ~295 at which the H100's
// tensor cores, not HBM, would be the limit. This first version does the
// arithmetic on CUDA cores in float32 (softmax and sums in f32 for bf16 and
// f32 inputs) and keeps the scores out of device memory:
// - forward: one block per (window, head); Q, K and V are staged in shared
//   memory as f32 (row stride D + 1, so a warp reading K by rows hits 32
//   banks); a warp per query row, with that row in registers, forms the T
//   scores (lane j takes keys j, j + 32, ...), adds rel_bias[h] and the
//   mask, takes a warp-reduced softmax and writes O[i, :] with one lane per
//   channel. It stores the per-row log-sum-exp for the backward.
// - backward: one block of 512 threads per (head, run of windows), which its
//   ~175 KB of shared memory keeps alone on an SM. For each window it stages
//   Q, K, V and dO, recomputes P from the log-sum-exp, and forms
//   dS = P * (dP - Delta), Delta_i = dO_i . O_i. A warp per query row gives dQ;
//   a warp per key column gives dK and dV (recomputing that column of P and
//   dS), so no two threads add into one output; each warp keeps its row or
//   column of the operands in registers. dS is summed into a (T, T)
//   f32 accumulator in shared memory over the block's run of windows (each
//   (i, j) has one owning thread), and added into dBias with one atomicAdd per
//   element per block: with 578 windows at stage 1 b2, per-window atomics
//   would contend 578-fold.
// wgmma, TMA and keeping P in registers are left for later.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// the backward's ~175 KB of shared memory fits one block per SM, so its
// block is twice as wide as the forward's to keep 16 warps resident
constexpr int kBwdThreads = 512;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kMaxTokens = 256;
constexpr int kKeysPerLane = kMaxTokens / 32;

// (rows, D) contiguous → shared memory as f32 with row stride D + 1
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int rows) {
  for (int e = threadIdx.x; e < rows * D; e += blockDim.x) {
    const int r = e / D, c = e - r * D;
    dst[r * (D + 1) + c] = to_f(src[e]);
  }
}

template <int D>
__device__ __forceinline__ void row_to_regs(float (&dst)[D], const float* src) {
#pragma unroll
  for (int d = 0; d < D; ++d) dst[d] = src[d];
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
window_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const float* __restrict__ bias,   // (H, T, T)
                            const float* __restrict__ mask,   // (nW_img, T, T) or null
                            T* __restrict__ o,                // (NW, H, T, D)
                            float* __restrict__ lse,          // (NW, H, T)
                            int heads, int t, int n_img_windows, float sqrt_d) {
  extern __shared__ float smem[];
  constexpr int ld = D + 1;
  float* sq = smem;
  float* sk = sq + t * ld;
  float* sv = sk + t * ld;
  float* sp = sv + t * ld;  // kWarps rows of t probabilities

  const long long wh = blockIdx.x;  // window * heads + head
  const int h = static_cast<int>(wh % heads);
  const long long w = wh / heads;
  const long long base = wh * t * D;
  load_tile<T, D>(sq, q + base, t);
  load_tile<T, D>(sk, k + base, t);
  load_tile<T, D>(sv, v + base, t);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* bias_h = bias + static_cast<long long>(h) * t * t;
  const float* mask_w = mask ? mask + (w % n_img_windows) * t * t : nullptr;
  float* p = sp + warp * t;
  for (int i = warp; i < t; i += kWarps) {
    float qi[D];
    row_to_regs<D>(qi, sq + i * ld);
    float s[kKeysPerLane];
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < kKeysPerLane; ++c) {
      const int j = lane + 32 * c;
      s[c] = -INFINITY;
      if (j < t) {
        float val = dot_reg<D>(qi, sk + j * ld) / sqrt_d + bias_h[i * t + j];
        if (mask_w) val += mask_w[i * t + j];
        s[c] = val;
        mx = fmaxf(mx, val);
      }
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < kKeysPerLane; ++c) {
      const int j = lane + 32 * c;
      if (j < t) {
        const float e = expf(s[c] - mx);
        p[j] = e;
        sum += e;
      }
    }
    sum = warp_sum(sum);
    __syncwarp();
    for (int d = lane; d < D; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < t; ++j) acc += p[j] * sv[j * ld + d];
      o[base + i * D + d] = from_f<T>(acc / sum);
    }
    if (lane == 0) lse[wh * t + i] = mx + logf(sum);
    __syncwarp();  // p is rewritten for the next row
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads)
window_attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ o,
                            const T* __restrict__ dout, const float* __restrict__ lse,
                            const float* __restrict__ bias, const float* __restrict__ mask,
                            T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                            float* __restrict__ dbias,  // (H, T, T), zeroed by the caller
                            int windows, int heads, int t, int n_img_windows,
                            int windows_per_block, float sqrt_d) {
  extern __shared__ float smem[];
  constexpr int ld = D + 1;
  float* sq = smem;
  float* sk = sq + t * ld;
  float* sv = sk + t * ld;
  float* sdo = sv + t * ld;
  float* sacc = sdo + t * ld;   // (t, t) sum of dS over this block's windows
  float* slse = sacc + t * t;
  float* sdelta = slse + t;
  float* sbuf = sdelta + t;     // kBwdWarps x 2 rows of t

  const int h = blockIdx.y;
  const int w0 = blockIdx.x * windows_per_block;
  const int w1 = min(windows, w0 + windows_per_block);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* bias_h = bias + static_cast<long long>(h) * t * t;
  float* buf_a = sbuf + warp * 2 * t;
  float* buf_b = buf_a + t;
  for (int e = threadIdx.x; e < t * t; e += kBwdThreads) sacc[e] = 0.f;

  for (int w = w0; w < w1; ++w) {
    __syncthreads();  // the previous window's readers are done with the tiles
    const long long wh = static_cast<long long>(w) * heads + h;
    const long long base = wh * t * D;
    load_tile<T, D>(sq, q + base, t);
    load_tile<T, D>(sk, k + base, t);
    load_tile<T, D>(sv, v + base, t);
    load_tile<T, D>(sdo, dout + base, t);
    __syncthreads();
    for (int i = threadIdx.x; i < t; i += kBwdThreads) {
      float acc = 0.f;
      for (int d = 0; d < D; ++d) acc += sdo[i * ld + d] * to_f(o[base + i * D + d]);
      sdelta[i] = acc;
      slse[i] = lse[wh * t + i];
    }
    __syncthreads();
    const float* mask_w = mask ? mask + static_cast<long long>(w % n_img_windows) * t * t : nullptr;

    // rows: dQ, and dS into the dBias accumulator (thread (i % kBwdWarps, j % 32) owns (i, j))
    for (int i = warp; i < t; i += kBwdWarps) {
      float qi[D], doi[D];
      row_to_regs<D>(qi, sq + i * ld);
      row_to_regs<D>(doi, sdo + i * ld);
#pragma unroll
      for (int c = 0; c < kKeysPerLane; ++c) {
        const int j = lane + 32 * c;
        if (j < t) {
          float s = dot_reg<D>(qi, sk + j * ld) / sqrt_d + bias_h[i * t + j];
          if (mask_w) s += mask_w[i * t + j];
          const float p = expf(s - slse[i]);
          const float ds = p * (dot_reg<D>(doi, sv + j * ld) - sdelta[i]);
          buf_a[j] = ds;
          sacc[i * t + j] += ds;
        }
      }
      __syncwarp();
      for (int d = lane; d < D; d += 32) {
        float acc = 0.f;
        for (int j = 0; j < t; ++j) acc += buf_a[j] * sk[j * ld + d];
        dq[base + i * D + d] = from_f<T>(acc / sqrt_d);
      }
      __syncwarp();
    }

    // columns: dK and dV
    for (int j = warp; j < t; j += kBwdWarps) {
      float kj[D], vj[D];
      row_to_regs<D>(kj, sk + j * ld);
      row_to_regs<D>(vj, sv + j * ld);
#pragma unroll
      for (int c = 0; c < kKeysPerLane; ++c) {
        const int i = lane + 32 * c;
        if (i < t) {
          float s = dot_reg<D>(kj, sq + i * ld) / sqrt_d + bias_h[i * t + j];
          if (mask_w) s += mask_w[i * t + j];
          const float p = expf(s - slse[i]);
          buf_a[i] = p;
          buf_b[i] = p * (dot_reg<D>(vj, sdo + i * ld) - sdelta[i]);
        }
      }
      __syncwarp();
      for (int d = lane; d < D; d += 32) {
        float acc_k = 0.f, acc_v = 0.f;
        for (int i = 0; i < t; ++i) {
          acc_v += buf_a[i] * sdo[i * ld + d];
          acc_k += buf_b[i] * sq[i * ld + d];
        }
        dk[base + j * D + d] = from_f<T>(acc_k / sqrt_d);
        dv[base + j * D + d] = from_f<T>(acc_v);
      }
      __syncwarp();
    }
  }
  __syncthreads();
  if (w0 < w1) {
    float* out = dbias + static_cast<long long>(h) * t * t;
    for (int e = threadIdx.x; e < t * t; e += kBwdThreads) atomicAdd(out + e, sacc[e]);
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 132;
  }
  return count;
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, const void* bias, const void* mask,
               void* o, void* lse, int windows, int heads, int t, int n_img_windows,
               cudaStream_t stream) {
  const size_t smem = (3 * static_cast<size_t>(t) * (D + 1) + kWarps * t) * sizeof(float);
  if (smem > kSharedLimit) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = window_attention_fwd_kernel<T, D>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  const long long blocks = static_cast<long long>(windows) * heads;
  if (blocks > 0) {
    kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const float*>(bias), static_cast<const float*>(mask), static_cast<T*>(o),
        static_cast<float*>(lse), heads, t, n_img_windows, sqrtf(static_cast<float>(D)));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const void* lse, const void* bias, const void* mask, void* dq, void* dk, void* dv,
               void* dbias, int windows, int heads, int t, int n_img_windows,
               cudaStream_t stream) {
  const size_t smem =
      (4 * static_cast<size_t>(t) * (D + 1) + static_cast<size_t>(t) * t + 2 * t +
       2 * kBwdWarps * t) * sizeof(float);
  if (smem > kSharedLimit) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = window_attention_bwd_kernel<T, D>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (windows > 0 && heads > 0) {
    // about four blocks per SM over the whole grid; each block adds its dBias once
    const int blocks_per_head = max(1, min(windows, (4 * sm_count() + heads - 1) / heads));
    const int per_block = (windows + blocks_per_head - 1) / blocks_per_head;
    const dim3 grid((windows + per_block - 1) / per_block, heads);
    kernel<<<grid, kBwdThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(o), static_cast<const T*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(bias), static_cast<const float*>(mask), static_cast<T*>(dq),
        static_cast<T*>(dk), static_cast<T*>(dv), static_cast<float*>(dbias), windows, heads, t,
        n_img_windows, per_block, sqrtf(static_cast<float>(D)));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All pointers are device pointers to contiguous arrays: q/k/v/o/dout/dq/dk/dv
// (windows, heads, tokens, head_dim) in bf16 (bf16 != 0) or f32; lse
// (windows, heads, tokens) f32; bias and dbias (heads, tokens, tokens) f32;
// mask (n_img_windows, tokens, tokens) f32 or null. tokens <= 256 and
// head_dim in {16, 32, 64}. Launch on `stream`; return cudaGetLastError() (or
// cudaErrorInvalidValue for a shape the kernels do not take).
extern "C" int wis_window_attention_fwd(const void* q, const void* k, const void* v,
                                        const void* bias, const void* mask, void* o, void* lse,
                                        int windows, int heads, int tokens, int head_dim,
                                        int n_img_windows, int bf16, void* stream) {
  if (tokens < 1 || tokens > kMaxTokens || n_img_windows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  WIS_DISPATCH(launch_fwd, q, k, v, bias, mask, o, lse, windows, heads, tokens, n_img_windows,
               static_cast<cudaStream_t>(stream))
}

extern "C" int wis_window_attention_bwd(const void* q, const void* k, const void* v,
                                        const void* o, const void* dout, const void* lse,
                                        const void* bias, const void* mask, void* dq, void* dk,
                                        void* dv, void* dbias, int windows, int heads, int tokens,
                                        int head_dim, int n_img_windows, int bf16, void* stream) {
  if (tokens < 1 || tokens > kMaxTokens || n_img_windows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  WIS_DISPATCH(launch_bwd, q, k, v, o, dout, lse, bias, mask, dq, dk, dv, dbias, windows, heads,
               tokens, n_img_windows, static_cast<cudaStream_t>(stream))
}
