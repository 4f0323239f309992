// Swin window attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tools/ab_window_attn.py::pallas_window_attention
// (body `_win_kernel`), which computes, per window w and head h,
//   O = softmax(Q K^T / sqrt(D) + rel_bias[h]) V
// for q/k/v (NW, H, T, D). This kernel also takes the shifted-window mask
// (the Pallas kernel lacks it): attn_mask[w % nW_img] (nW_img, T, T) is added
// to the scores, in the window order of models/swin.py::window_partition, as
// models/swin.py::WindowAttention does. The backward kernels have no Pallas
// original: with S the scores, P = exp(S - lse), Delta_i = dO_i . O_i and
// dS = P * (dO V^T - Delta), they give dQ = dS K / sqrt(D), dK = dS^T Q / sqrt(D),
// dV = P^T dO and dBias[h] = the sum over windows of dS, in f32.
//
// What bounds it: memory, in principle. At Swin-L stage 1 (T = 144, D = 32)
// the forward does 4*T*D flops per score pair against 4*T*D*2 bytes (bf16)
// per window-head of q/k/v/o, so about 36 flops per byte, far below the ~295
// at which the H100's tensor cores, not HBM, would be the limit.
// - forward, bf16: on tensor cores (mma.sync m16n8k16, bf16 in, f32
//   accumulate; csrc/mma.cuh). One block of T/16 warps (T padded to a
//   multiple of 16: 9 warps at T = 144) per (window, head), consecutive
//   blocks taking one head's windows, so the blocks an SM holds at once read
//   the same bias lines. Q, K and V are copied into shared memory as bf16 by
//   cp.async, rows padded by 16 bytes for ldmatrix, padded rows zero; the
//   first key step's bias is read while they are in flight. Each warp takes
//   16 queries (Q as A fragments) and walks the keys 16 at a time: S = Q K^T
//   by mma, then the scale, bias and mask in f32 in the C-fragment layout
//   (the next step's bias and mask are read while this step computes; a
//   window whose mask is all zero, as Swin's interior windows' are, reads no
//   mask), an online softmax (the row max over the quad, the sums rescaled by
//   e^(m_old - m_new)), P = e^(s - m) by ex2, and O += P V with P's
//   accumulator fragments packed to bf16 as the A operand and V read by
//   ldmatrix.trans. P is rounded to bf16 before PV, as the Pallas kernel
//   rounds it; the row sum adds the unrounded P; every sum is f32. O / l is
//   rounded to bf16 once, and the row's log-sum-exp m + ln l is stored for
//   the backward. A padded key scores -1e30 (never -inf), so its P is
//   exactly 0; a padded query writes nothing. Up to T = 144 and D = 32 a
//   thread holds at most 72 registers (68 at D = 32), so 3 blocks (27 warps)
//   share an SM.
//   What bounds it now: neither bytes (2.6x the byte bound at Swin-L stage 1
//   b2, 4x at stage 3) nor tensor-core operations, but each block's latency
//   (about 13 us on an H100: staging, then 9 key steps of bias loads, mma,
//   softmax and mma) at 3 blocks an SM; at stage 3 its 1200 blocks make
//   3.03 waves of 396. The shift mask adds about 10 us a call at either
//   stage. Occupancy set its time: holding the whole row of 144 scores in
//   registers (one softmax pass), or 32 or 48 keys a pass, took more
//   registers and fewer blocks an SM and measured slower, as did blocks
//   that walk a run of windows with double-buffered tiles.
// - forward, f32: on CUDA cores in f32, kept for the f32 parity checks. One
//   block per (window, head); Q, K and V are staged in shared memory as f32
//   (row stride D + 1, so a warp reading K by rows hits 32 banks); a warp
//   per query row, with that row in registers, forms the T scores (lane j
//   takes keys j, j + 32, ...), adds rel_bias[h] and the mask, takes a
//   warp-reduced softmax and writes O[i, :] with one lane per channel. It
//   stores the per-row log-sum-exp for the backward.
// - backward, bf16: on tensor cores (mma.sync m16n8k16, bf16 in, f32
//   accumulate; csrc/mma.cuh), T <= 144. A block of T/16 warps (T padded to
//   a multiple of 16: 9 warps at T = 144) takes one head and a run of
//   windows (the wrapper picks the runs: one wave of blocks). Run r takes
//   windows r, r + runs, ..., so the windows with a nonzero shift mask
//   (Swin's last row and column of windows) spread over the runs. Q, K, V,
//   dO and O of a window are copied into shared memory as bf16, and its lse
//   as f32, by cp.async, rows padded by 16 bytes for ldmatrix, padded rows
//   zero; the next window's copies are in flight while this one is used
//   where shared memory holds two sets (all head dims but 64). Per window:
//   (1) rows: each warp takes 16 queries (Q and dO as A fragments) and walks
//   the keys 16 at a time: S = Q K^T and dP = dO V^T by mma, then the scale,
//   bias and mask in f32 (the next step's bias and mask are read while this
//   step computes; a window whose mask is all zero, as Swin's interior
//   windows' are, reads no mask), P = e^(s - lse) by ex2 and
//   dS = P (dP - Delta); dQ += dS K with dS's accumulator fragments packed
//   to bf16 as the A operand and K read by ldmatrix.trans. dS is added
//   unrounded into the f32 dBias accumulator, which stays in registers in
//   the C-fragment layout over the whole run (each element has one owning
//   lane). P and dS are stored to shared memory as bf16. A padded key or
//   query gets P = dS = 0 and reads no bias or mask.
//   (2) columns: each warp takes 16 keys: dV = P^T dO and dK = dS^T Q, with
//   P^T and dS^T read from the stored tiles by ldmatrix.trans and dO and Q
//   as B operands. So each score's P and dS are computed once.
//   At the end of its run a block writes its dBias partial (runs, H, T, T),
//   and a second launch sums the runs in run order: no atomics, the same bits
//   on every call. P and dS are rounded to bf16 before the products that use
//   them, as the masked-attention kernels round them; every sum is f32.
//   What bounds it now: neither bytes (3.5x the byte bound at Swin-L stage 1)
//   nor tensor-core operations, but each warp's latency through the bias and
//   mask loads from L2, exp, dS and packing between its mma steps, at 9
//   warps an SM: P, dS and two sets of tiles (199 KB at T = 144, D = 32) leave
//   room for one block an SM, and the dBias accumulator holds 72 registers a
//   thread. Staging the head's bias in shared memory instead, which leaves
//   room for one set of tiles only, measured slower.
// - backward, f32: on CUDA cores in f32, kept for the f32 parity checks. One
//   block of 512 threads per (run of windows, head), the same runs. For each
//   window it stages Q, K, V and dO and recomputes P from the log-sum-exp; a
//   warp per query row gives dQ, a warp per key column gives dK and dV
//   (recomputing that column of P and dS), so no two threads add into one
//   output. dS goes into the block's dBias partial in device memory, each
//   element owned by one thread, and the same second launch sums the runs.
// Left for later: wgmma and TMA, and more warps an SM (for the backward, the
// mask-heavy runs of Swin-L stage 3 set its time).

#include "common.cuh"
#include "mma.cuh"

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBwdThreads = 512;  // the f32 backward: 16 warps
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kMaxTokens = 256;     // the forward
constexpr int kFwdFewWarps = 9;     // the bf16 forward's instantiation for T <= 144
constexpr int kBwdMaxTokens = 144;  // the backward: the bf16 dBias accumulator's registers
constexpr int kKeysPerLane = kMaxTokens / 32;
constexpr int kMaxKeySteps = kBwdMaxTokens / 16;  // 16-key steps of the bf16 backward
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNoScore = -1e30f;  // a padded key's score, and the running max before the first key

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

template <int D>
__global__ void __launch_bounds__(kThreads)
window_attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ bias,   // (H, T, T)
                            const float* __restrict__ mask,   // (nW_img, T, T) or null
                            float* __restrict__ o,            // (NW, H, T, D)
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
  load_tile<float, D>(sq, q + base, t);
  load_tile<float, D>(sk, k + base, t);
  load_tile<float, D>(sv, v + base, t);
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
      o[base + i * D + d] = acc / sum;
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
                            float* __restrict__ part,  // (runs, H, T, T) dBias partials
                            int windows, int heads, int t, int n_img_windows, float sqrt_d) {
  extern __shared__ float smem[];
  constexpr int ld = D + 1;
  float* sq = smem;
  float* sk = sq + t * ld;
  float* sv = sk + t * ld;
  float* sdo = sv + t * ld;
  float* slse = sdo + t * ld;
  float* sdelta = slse + t;
  float* sbuf = sdelta + t;     // kBwdWarps x 2 rows of t

  const int h = blockIdx.y, run = blockIdx.x, runs = gridDim.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* bias_h = bias + static_cast<long long>(h) * t * t;
  float* buf_a = sbuf + warp * 2 * t;
  float* buf_b = buf_a + t;
  // this run's dBias partial; thread (i % kBwdWarps, j % 32) owns (i, j)
  float* acc = part + (static_cast<long long>(run) * heads + h) * t * t;
  for (int i = warp; i < t; i += kBwdWarps)
    for (int j = lane; j < t; j += 32) acc[i * t + j] = 0.f;

  for (int w = run; w < windows; w += runs) {
    __syncthreads();  // the previous window's readers are done with the tiles
    const long long wh = static_cast<long long>(w) * heads + h;
    const long long base = wh * t * D;
    load_tile<T, D>(sq, q + base, t);
    load_tile<T, D>(sk, k + base, t);
    load_tile<T, D>(sv, v + base, t);
    load_tile<T, D>(sdo, dout + base, t);
    __syncthreads();
    for (int i = threadIdx.x; i < t; i += kBwdThreads) {
      float dl = 0.f;
      for (int d = 0; d < D; ++d) dl += sdo[i * ld + d] * to_f(o[base + i * D + d]);
      sdelta[i] = dl;
      slse[i] = lse[wh * t + i];
    }
    __syncthreads();
    const float* mask_w = mask ? mask + static_cast<long long>(w % n_img_windows) * t * t : nullptr;

    // rows: dQ, and dS into the dBias partial
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
          acc[i * t + j] += ds;
        }
      }
      __syncwarp();
      for (int d = lane; d < D; d += 32) {
        float a = 0.f;
        for (int j = 0; j < t; ++j) a += buf_a[j] * sk[j * ld + d];
        dq[base + i * D + d] = from_f<T>(a / sqrt_d);
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
}

// ---- the tensor-core (bf16) kernels ----

// rows [0, rows) of a (rows, D) bf16 array → shared bf16 with row stride
// D + 8, by cp.async in 16-byte vectors from the whole block; rows
// [rows, padded) are zero
template <int D>
__device__ __forceinline__ void stage_tile(bf16_t* dst, const bf16_t* __restrict__ src, int rows,
                                           int padded) {
  constexpr int kVecs = D / 8;
  for (int e = threadIdx.x; e < padded * kVecs; e += blockDim.x) {
    const int r = e / kVecs, c = (e - r * kVecs) * 8;
    const bool ok = r < rows;
    cp_async_16(dst + r * (D + 8) + c, src + (ok ? r * D + c : 0), ok);
  }
}

// bias + mask (mask_w may be null) of the lane's elements of 16-key step ks,
// in the C-fragment layout of the warp's rows (2 n8 tiles; element (n, e) is
// row r0 + 8 (e / 2), column 16 ks + 8 n + 2 tig + e % 2); 0 for a padded
// query or key. Pairs of columns are read as float2 where T is even (then
// every pair is 8-byte aligned).
__device__ __forceinline__ void load_bias(float (&bm)[2][4], const float* __restrict__ bias_h,
                                          const float* __restrict__ mask_w, int t, int r0,
                                          int tig, int ks) {
  const bool pairs = t % 2 == 0;
#pragma unroll
  for (int jt = 0; jt < 2; ++jt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = r0 + 8 * hh, j = ks * 16 + jt * 8 + 2 * tig;
      float2 x = make_float2(0.f, 0.f);
      if (i < t && j < t) {
        const int at = i * t + j;
        if (pairs) {
          x = *reinterpret_cast<const float2*>(bias_h + at);
          if (mask_w) {
            const float2 m = *reinterpret_cast<const float2*>(mask_w + at);
            x.x += m.x;
            x.y += m.y;
          }
        } else {
          x.x = bias_h[at] + (mask_w ? mask_w[at] : 0.f);
          if (j + 1 < t) x.y = bias_h[at + 1] + (mask_w ? mask_w[at + 1] : 0.f);
        }
      }
      bm[jt][2 * hh] = x.x;
      bm[jt][2 * hh + 1] = x.y;
    }
}

// T/16 warps a block, at most kMaxWarps; with up to 9 warps (T <= 144) and
// D <= 32 a thread holds at most 72 registers, so 3 blocks share an SM
template <int D, int kMaxWarps>
__global__ void __launch_bounds__(kMaxWarps * 32, (kMaxWarps <= kFwdFewWarps && D <= 32 ? 3 : 1))
window_attention_fwd_mma_kernel(const bf16_t* __restrict__ q, const bf16_t* __restrict__ k,
                                const bf16_t* __restrict__ v, const float* __restrict__ bias,
                                const float* __restrict__ mask,
                                const uint8_t* __restrict__ mask_used, bf16_t* __restrict__ o,
                                float* __restrict__ lse, int heads, int t, int n_img_windows,
                                float scale) {
  constexpr int ld = D + 8;
  const int tp = (t + 15) & ~15;  // tokens padded to whole 16-row tiles: one warp each
  const int steps = tp / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16_t* sq = reinterpret_cast<bf16_t*>(smem_raw);  // Q, K and V (tp, ld) each
  bf16_t* sk = sq + tp * ld;
  bf16_t* sv = sk + tp * ld;

  const int w = blockIdx.x, h = blockIdx.y;  // consecutive blocks: one head's windows
  const long long wh = static_cast<long long>(w) * heads + h;
  stage_tile<D>(sq, q + wh * t * D, t, tp);
  stage_tile<D>(sk, k + wh * t * D, t, tp);
  stage_tile<D>(sv, v + wh * t * D, t, tp);
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tig = lane % 4;
  const int r0 = warp * 16 + g;  // the lane's query rows r0 and r0 + 8
  const float* bias_h = bias + static_cast<long long>(h) * t * t;
  const int wi = w % n_img_windows;  // a mask that is all zero is not read
  const float* mask_w = mask && mask_used[wi] ? mask + static_cast<long long>(wi) * t * t : nullptr;
  float bm[2][4];
  load_bias(bm, bias_h, mask_w, t, r0, tig, 0);  // while the tiles are in flight
  cp_async_wait<0>();
  __syncthreads();

  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(qa[kk], sq + (warp * 16 + lane % 16) * ld + kk * 16 + (lane / 16) * 8);
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // of rows r0 and r0 + 8: the running max (the same in the row's 4 lanes)
  // and this lane's share of the running sum
  float m[2] = {kNoScore, kNoScore}, l[2] = {0.f, 0.f};
  for (int ks = 0; ks < steps; ++ks) {  // 16 keys at a time
    float bm_next[2][4] = {};  // the next step's, read while this one computes
    if (ks + 1 < steps) load_bias(bm_next, bias_h, mask_w, t, r0, tig, ks + 1);
    // S = Q K^T by mma, then the scale, bias and mask in f32
    float s[2][4] = {};
    mma_rows_t<D, 2>(s, qa, sk + ks * 16 * ld, lane);
    const bool ragged = ks * 16 + 16 > t;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int jt = 0; jt < 2; ++jt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = fmaf(s[jt][e], scale, bm[jt][e]);
        if (ragged && ks * 16 + jt * 8 + 2 * tig + (e & 1) >= t) x = kNoScore;  // padded key
        s[jt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
        bm[jt][e] = bm_next[jt][e];
      }
    float mlog2[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {  // the row's new max over its quad; rescale the old sums
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float alpha = exp2_approx((m[hh] - mx[hh]) * kLog2e);  // 0 at the first step
      l[hh] *= alpha;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][2 * hh] *= alpha;
        acc[n][2 * hh + 1] *= alpha;
      }
      m[hh] = mx[hh];
      mlog2[hh] = mx[hh] * kLog2e;
    }
    // P = e^(s - m) by ex2 (a padded key's is exactly 0); the sum takes P in
    // f32, O += P V takes P rounded to bf16 (C fragments → A, mma.cuh)
    uint32_t pa[1][4];
#pragma unroll
    for (int jt = 0; jt < 2; ++jt) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) p[e] = exp2_approx(fmaf(s[jt][e], kLog2e, -mlog2[e >> 1]));
      l[0] += p[0] + p[1];
      l[1] += p[2] + p[3];
      pa[0][jt * 2] = pack_bf16x2(p[0], p[1]);
      pa[0][jt * 2 + 1] = pack_bf16x2(p[2], p[3]);
    }
    mma_rows<D, 1>(acc, pa, sv + ks * 16 * ld, lane);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {  // the row sums over the quad; O / l and lse
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    const int row = r0 + 8 * hh;
    if (row >= t) continue;  // a padded query writes nothing
    const float inv = 1.f / l[hh];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(o + (wh * t + row) * D + n * 8 + 2 * tig) =
          pack_bf16x2(acc[n][2 * hh] * inv, acc[n][2 * hh + 1] * inv);
    if (tig == 0) lse[wh * t + row] = m[hh] + logf(l[hh]);
  }
}

// bf16 elements of one set of a window's tiles for `tp` padded tokens: Q,
// K, V, dO and O (tp, D + 8) each, then lse (tp floats)
template <int D>
__host__ __device__ int bwd_mma_set_elems(int tp) {
  return 5 * tp * (D + 8) + 2 * tp;
}

// bytes of shared memory of a bf16 backward block: P and dS, and `sets`
// sets of tiles
template <int D>
size_t bwd_mma_shared_bytes(int tp, int sets) {
  return (2 * static_cast<size_t>(tp) * (tp + 8) +
          static_cast<size_t>(sets) * bwd_mma_set_elems<D>(tp)) * sizeof(bf16_t);
}

template <int D>
__global__ void __launch_bounds__(kBwdMaxTokens * 2, 1)  // 9 warps at T = 144, one block an SM
window_attention_bwd_mma_kernel(const bf16_t* __restrict__ q, const bf16_t* __restrict__ k,
                                const bf16_t* __restrict__ v, const bf16_t* __restrict__ o,
                                const bf16_t* __restrict__ dout, const float* __restrict__ lse,
                                const float* __restrict__ bias, const float* __restrict__ mask,
                                const uint8_t* __restrict__ mask_used,
                                bf16_t* __restrict__ dq, bf16_t* __restrict__ dk,
                                bf16_t* __restrict__ dv, float* __restrict__ part, int windows,
                                int heads, int t, int n_img_windows, int sets, float scale) {
  constexpr int ld = D + 8;
  const int tp = (t + 15) & ~15;  // tokens padded to whole 16-row tiles: one warp each
  const int steps = tp / 16;
  const int ldp = tp + 8;
  const int tile = tp * ld, set_elems = bwd_mma_set_elems<D>(tp);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16_t* sp = reinterpret_cast<bf16_t*>(smem_raw);  // P (tp, ldp), [query][key]
  bf16_t* sds = sp + tp * ldp;                        // dS, the same
  bf16_t* tiles = sds + tp * ldp;  // `sets` x (Q, K, V, dO, O (tp, ld) each, lse (tp) f32)

  const int h = blockIdx.y, run = blockIdx.x, runs = gridDim.x;  // windows run, run + runs, ...
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tig = lane % 4;
  const int r0 = warp * 16 + g;  // the lane's rows (queries, then keys) r0 and r0 + 8
  const float* bias_h = bias + static_cast<long long>(h) * t * t;
  auto stage = [&](int set, int w) {
    const long long wh = static_cast<long long>(w) * heads + h;
    bf16_t* dst = tiles + set * set_elems;
    stage_tile<D>(dst, q + wh * t * D, t, tp);
    stage_tile<D>(dst + tile, k + wh * t * D, t, tp);
    stage_tile<D>(dst + 2 * tile, v + wh * t * D, t, tp);
    stage_tile<D>(dst + 3 * tile, dout + wh * t * D, t, tp);
    stage_tile<D>(dst + 4 * tile, o + wh * t * D, t, tp);
    float* sl = reinterpret_cast<float*>(dst + 5 * tile);
    for (int r = threadIdx.x; r < tp; r += blockDim.x)
      cp_async_4(sl + r, lse + wh * t + (r < t ? r : 0), r < t);
  };
  // this run's sum of dS in the C-fragment layout of the lane's rows: element
  // (n, e) is row r0 + 8 (e / 2), column 8 n + 2 tig + e % 2
  float acc_bias[2 * kMaxKeySteps][4];
#pragma unroll
  for (int n = 0; n < 2 * kMaxKeySteps; ++n)
    acc_bias[n][0] = acc_bias[n][1] = acc_bias[n][2] = acc_bias[n][3] = 0.f;

  if (run < windows) stage(0, run);
  cp_async_commit();
  for (int w = run, nth = 0; w < windows; w += runs, ++nth) {
    const int set = sets == 2 ? nth & 1 : 0;
    if (sets == 2 && w + runs < windows) stage(set ^ 1, w + runs);
    cp_async_commit();
    cp_async_wait<1>();  // window w's copies are done
    __syncthreads();
    const bf16_t* sq = tiles + set * set_elems;
    const bf16_t* sk = sq + tile;
    const bf16_t* sv = sk + tile;
    const bf16_t* sdo = sv + tile;
    const bf16_t* so = sdo + tile;
    const float* sl = reinterpret_cast<const float*>(so + tile);
    const long long wh = static_cast<long long>(w) * heads + h;
    const int wi = w % n_img_windows;  // a mask that is all zero is not read
    const float* mask_w = mask && mask_used[wi] ? mask + static_cast<long long>(wi) * t * t : nullptr;

    // (1) rows: the warp's 16 queries against every key
    {
      // Delta of row (lane / 2) of the warp, two lanes a row, half of D each
      float dl = 0.f;
      {
        const int at = (warp * 16 + lane / 2) * ld + (lane & 1) * (D / 2);  // padded rows: 0
#pragma unroll
        for (int d = 0; d < D / 2; d += 2) {
          const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sdo + at + d));
          const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(so + at + d));
          dl += x.x * y.x + x.y * y.y;
        }
        dl += __shfl_xor_sync(0xffffffffu, dl, 1);
      }
      const float dl0 = __shfl_sync(0xffffffffu, dl, 2 * g);
      const float dl1 = __shfl_sync(0xffffffffu, dl, 2 * (g + 8));
      const float lse0 = sl[r0] * kLog2e, lse1 = sl[r0 + 8] * kLog2e;
      uint32_t qa[D / 16][4], da[D / 16][4];
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int at = (warp * 16 + lane % 16) * ld + kk * 16 + (lane / 16) * 8;
        ldmatrix_x4(qa[kk], sq + at);
        ldmatrix_x4(da[kk], sdo + at);
      }
      float acc_dq[D / 8][4];
#pragma unroll
      for (int n = 0; n < D / 8; ++n) acc_dq[n][0] = acc_dq[n][1] = acc_dq[n][2] = acc_dq[n][3] = 0.f;

      float bm[2][4];
      load_bias(bm, bias_h, mask_w, t, r0, tig, 0);
#pragma unroll
      for (int ks = 0; ks < kMaxKeySteps; ++ks) {  // 16 keys at a time
        if (ks >= steps) break;
        float bm_next[2][4] = {};  // the next step's, read while this one computes
        if (ks + 1 < steps) load_bias(bm_next, bias_h, mask_w, t, r0, tig, ks + 1);
        float s[2][4] = {}, dp[2][4] = {};
        mma_rows_t<D, 2>(s, qa, sk + ks * 16 * ld, lane);
        mma_rows_t<D, 2>(dp, da, sv + ks * 16 * ld, lane);
        uint32_t pa[1][4], dsa[1][4];
#pragma unroll
        for (int jt = 0; jt < 2; ++jt) {
          float p[4], ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = r0 + 8 * (e >> 1), j = ks * 16 + jt * 8 + 2 * tig + (e & 1);
            p[e] = ds[e] = 0.f;
            if (i < t && j < t) {
              const float x = fmaf(s[jt][e], scale, bm[jt][e]);
              p[e] = exp2_approx(fmaf(x, kLog2e, -(e >> 1 ? lse1 : lse0)));
              ds[e] = p[e] * (dp[jt][e] - (e >> 1 ? dl1 : dl0));
            }
            acc_bias[2 * ks + jt][e] += ds[e];
          }
          pa[0][jt * 2] = pack_bf16x2(p[0], p[1]);
          pa[0][jt * 2 + 1] = pack_bf16x2(p[2], p[3]);
          dsa[0][jt * 2] = pack_bf16x2(ds[0], ds[1]);
          dsa[0][jt * 2 + 1] = pack_bf16x2(ds[2], ds[3]);
          const int at = r0 * ldp + ks * 16 + jt * 8 + 2 * tig;
          *reinterpret_cast<uint32_t*>(sp + at) = pa[0][jt * 2];
          *reinterpret_cast<uint32_t*>(sp + at + 8 * ldp) = pa[0][jt * 2 + 1];
          *reinterpret_cast<uint32_t*>(sds + at) = dsa[0][jt * 2];
          *reinterpret_cast<uint32_t*>(sds + at + 8 * ldp) = dsa[0][jt * 2 + 1];
        }
        mma_rows<D, 1>(acc_dq, dsa, sk + ks * 16 * ld, lane);
#pragma unroll
        for (int jt = 0; jt < 2; ++jt)
#pragma unroll
          for (int e = 0; e < 4; ++e) bm[jt][e] = bm_next[jt][e];
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int col = n * 8 + 2 * tig;
        if (r0 < t)
          *reinterpret_cast<uint32_t*>(dq + (wh * t + r0) * D + col) =
              pack_bf16x2(acc_dq[n][0] * scale, acc_dq[n][1] * scale);
        if (r0 + 8 < t)
          *reinterpret_cast<uint32_t*>(dq + (wh * t + r0 + 8) * D + col) =
              pack_bf16x2(acc_dq[n][2] * scale, acc_dq[n][3] * scale);
      }
    }
    __syncthreads();  // P and dS are complete

    // (2) columns: the warp's 16 keys against every query
    {
      float acc_dk[D / 8][4], acc_dv[D / 8][4];
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_dk[n][e] = acc_dv[n][e] = 0.f;
      // A fragments of P^T and dS^T: matrix l / 8 of the four holds queries
      // +8 (l / 16) and keys +8 (l / 8 % 2) of the 16 x 16 block
      const int mi = lane / 8;
      const int at = ((mi >> 1) * 8 + lane % 8) * ldp + warp * 16 + (mi & 1) * 8;
#pragma unroll
      for (int qs = 0; qs < kMaxKeySteps; ++qs) {  // 16 queries at a time
        if (qs >= steps) break;
        uint32_t pt[1][4], dst[1][4];
        ldmatrix_x4_trans(pt[0], sp + qs * 16 * ldp + at);
        ldmatrix_x4_trans(dst[0], sds + qs * 16 * ldp + at);
        mma_rows<D, 1>(acc_dv, pt, sdo + qs * 16 * ld, lane);
        mma_rows<D, 1>(acc_dk, dst, sq + qs * 16 * ld, lane);
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int col = n * 8 + 2 * tig;
        if (r0 < t) {
          const long long at_k = (wh * t + r0) * D + col;
          *reinterpret_cast<uint32_t*>(dk + at_k) = pack_bf16x2(acc_dk[n][0] * scale, acc_dk[n][1] * scale);
          *reinterpret_cast<uint32_t*>(dv + at_k) = pack_bf16x2(acc_dv[n][0], acc_dv[n][1]);
        }
        if (r0 + 8 < t) {
          const long long at_k = (wh * t + r0 + 8) * D + col;
          *reinterpret_cast<uint32_t*>(dk + at_k) = pack_bf16x2(acc_dk[n][2] * scale, acc_dk[n][3] * scale);
          *reinterpret_cast<uint32_t*>(dv + at_k) = pack_bf16x2(acc_dv[n][2], acc_dv[n][3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this window's tiles, P and dS
    if (sets == 1 && w + runs < windows) {
      stage(0, w + runs);
      cp_async_commit();
    }
  }

  float* out = part + (static_cast<long long>(run) * heads + h) * t * t;
#pragma unroll
  for (int n = 0; n < 2 * kMaxKeySteps; ++n) {
    if (n >= 2 * steps) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = r0 + 8 * (e >> 1), j = n * 8 + 2 * tig + (e & 1);
      if (i < t && j < t) out[i * t + j] = acc_bias[n][e];
    }
  }
}

// dbias = the sum of the `runs` partials (runs, n) in run order
__global__ void window_attention_dbias_reduce_kernel(const float* __restrict__ part,
                                                     float* __restrict__ dbias, long long n,
                                                     int runs) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float sum = 0.f;
    for (int r = 0; r < runs; ++r) sum += part[r * n + i];
    dbias[i] = sum;
  }
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, const void* bias, const void* mask,
               const void* mask_used, void* o, void* lse, int windows, int heads, int t,
               int n_img_windows, cudaStream_t stream) {
  if (windows <= 0 || heads <= 0) return static_cast<int>(cudaGetLastError());
  if constexpr (std::is_same<T, bf16_t>::value) {
    const int tp = (t + 15) & ~15;
    const size_t smem = 3 * static_cast<size_t>(tp) * (D + 8) * sizeof(bf16_t);
    if (heads > 65535 || (mask != nullptr && mask_used == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = tp <= 16 * kFwdFewWarps ? window_attention_fwd_mma_kernel<D, kFwdFewWarps>
                                          : window_attention_fwd_mma_kernel<D, kMaxTokens / 16>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    kernel<<<dim3(windows, heads), tp * 2, smem, stream>>>(
        static_cast<const bf16_t*>(q), static_cast<const bf16_t*>(k),
        static_cast<const bf16_t*>(v), static_cast<const float*>(bias),
        static_cast<const float*>(mask), static_cast<const uint8_t*>(mask_used),
        static_cast<bf16_t*>(o), static_cast<float*>(lse), heads, t, n_img_windows,
        1.f / sqrtf(static_cast<float>(D)));
  } else {
    const size_t smem = (3 * static_cast<size_t>(t) * (D + 1) + kWarps * t) * sizeof(float);
    if (smem > kSharedLimit) return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = window_attention_fwd_kernel<D>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    kernel<<<static_cast<unsigned>(static_cast<long long>(windows) * heads), kThreads, smem,
             stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                       static_cast<const float*>(v), static_cast<const float*>(bias),
                       static_cast<const float*>(mask), static_cast<float*>(o),
                       static_cast<float*>(lse), heads, t, n_img_windows,
                       sqrtf(static_cast<float>(D)));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const void* lse, const void* bias, const void* mask, const void* mask_used,
               void* dq, void* dk, void* dv, void* dbias, void* part, int windows, int heads,
               int t, int n_img_windows, int runs, cudaStream_t stream) {
  if (windows <= 0 || heads <= 0) return static_cast<int>(cudaGetLastError());
  if (runs < 1 || runs > windows) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(runs, heads);
  if constexpr (std::is_same<T, bf16_t>::value) {
    const int tp = (t + 15) & ~15;
    const int sets = bwd_mma_shared_bytes<D>(tp, 2) <= kSharedLimit ? 2 : 1;
    const size_t smem = bwd_mma_shared_bytes<D>(tp, sets);
    if (smem > kSharedLimit || (mask != nullptr && mask_used == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = window_attention_bwd_mma_kernel<D>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    kernel<<<grid, tp * 2, smem, stream>>>(
        static_cast<const bf16_t*>(q), static_cast<const bf16_t*>(k),
        static_cast<const bf16_t*>(v), static_cast<const bf16_t*>(o),
        static_cast<const bf16_t*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(bias), static_cast<const float*>(mask),
        static_cast<const uint8_t*>(mask_used), static_cast<bf16_t*>(dq),
        static_cast<bf16_t*>(dk), static_cast<bf16_t*>(dv),
        static_cast<float*>(part), windows, heads, t, n_img_windows, sets,
        1.f / sqrtf(static_cast<float>(D)));
  } else {
    const size_t smem =
        (4 * static_cast<size_t>(t) * (D + 1) + 2 * t + 2 * kBwdWarps * t) * sizeof(float);
    if (smem > kSharedLimit) return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = window_attention_bwd_kernel<T, D>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    kernel<<<grid, kBwdThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(o), static_cast<const T*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(bias), static_cast<const float*>(mask), static_cast<T*>(dq),
        static_cast<T*>(dk), static_cast<T*>(dv), static_cast<float*>(part), windows, heads, t,
        n_img_windows, sqrtf(static_cast<float>(D)));
  }
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const long long n = static_cast<long long>(heads) * t * t;
  const int blocks = static_cast<int>(std::min((n + 255) / 256, 4096LL));
  window_attention_dbias_reduce_kernel<<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(dbias), n, runs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All pointers are device pointers to contiguous arrays: q/k/v/o/dout/dq/dk/dv
// (windows, heads, tokens, head_dim) in bf16 (bf16 != 0; q/k/v/dout 16-byte
// aligned) or f32; lse (windows, heads, tokens) f32; bias and dbias (heads,
// tokens, tokens) f32; mask (n_img_windows, tokens, tokens) f32 or null, and
// with it mask_used (n_img_windows) bytes, 0 where that window's mask is all
// zero (the bf16 kernels then skip it; the f32 kernels ignore it); part
// f32 scratch of runs * heads * tokens * tokens, the backward's dBias
// partials, one for each of its `runs` runs of windows (1 <= runs <=
// windows; run r takes windows r, r + runs, r + 2 runs, ...). The forward
// takes tokens <= 256, the backward tokens <= 144; head_dim in {16, 32, 64}.
// Launch on `stream`; return cudaGetLastError() (or cudaErrorInvalidValue for
// a shape the kernels do not take).
extern "C" int wis_window_attention_fwd(const void* q, const void* k, const void* v,
                                        const void* bias, const void* mask,
                                        const void* mask_used, void* o, void* lse, int windows,
                                        int heads, int tokens, int head_dim, int n_img_windows,
                                        int bf16, void* stream) {
  if (tokens < 1 || tokens > kMaxTokens || n_img_windows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  WIS_DISPATCH(launch_fwd, q, k, v, bias, mask, mask_used, o, lse, windows, heads, tokens,
               n_img_windows, static_cast<cudaStream_t>(stream))
}

extern "C" int wis_window_attention_bwd(const void* q, const void* k, const void* v,
                                        const void* o, const void* dout, const void* lse,
                                        const void* bias, const void* mask,
                                        const void* mask_used, void* dq, void* dk, void* dv,
                                        void* dbias, void* part, int windows,
                                        int heads, int tokens, int head_dim, int n_img_windows,
                                        int bf16, int runs, void* stream) {
  if (tokens < 1 || tokens > kBwdMaxTokens || n_img_windows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  WIS_DISPATCH(launch_bwd, q, k, v, o, dout, lse, bias, mask, mask_used, dq, dk, dv, dbias, part,
               windows, heads, tokens, n_img_windows, runs, static_cast<cudaStream_t>(stream))
}
