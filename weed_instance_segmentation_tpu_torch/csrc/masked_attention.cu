// Masked cross-attention of the Mask2Former decoder, forward and backward, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tools/ab_masked_attn.py::pallas_masked_attention
// (body `_flash_kernel`): per (batch, head),
//   O = softmax(Q K^T + bias) V,   bias = -1e9 where mask, else 0,
// with q (B, H, Q, D) already scaled by D^-0.5, k/v (B, H, S, D) and the
// boolean mask (B, Q, S) shared over heads (models/transformer_decoder.py::
// MaskPredictor). The kernels read the mask as one byte per score, not the
// f32 bias, and add exactly -1e9f to a masked score in f32, as the additive
// form does. The backward kernels have no Pallas original: with
// P = exp(Q K^T + bias - lse), Delta_i = dO_i . O_i and dS = P * (dO V^T - Delta),
// they compute dQ = dS K, dK = dS^T Q and dV = P^T dO.
//
// What bounds it: memory. At the decoder's shapes (Q = 200, D = 32, S up to
// 10000) a score costs 4*D flops against (K, V, mask) bytes that are read once
// per (batch, head): about 60 flops per byte in bf16, far below the ~295 at
// which the H100's tensor cores would be the limit.
//
// Both forwards store the per-row log-sum-exp lse = m + log l for the
// backward. Rows are never fully masked: the decoder's all-masked-row escape
// comes first.
// - forward, bf16: on tensor cores (mma.sync m16n8k16, bf16 in, f32
//   accumulate), FlashAttention-2's forward split over the keys as in
//   flash-decoding. A block of 8 warps holds 128 query rows of one (batch,
//   head), 16 a warp, their Q as A fragments in registers, and walks one
//   chunk of the keys in tiles of 64 (K, V and the mask bytes copied by
//   double-buffered cp.async, as the backward's dQ launch does). Per 32 keys:
//   S = Q K^T by mma, the -1e9 bias where masked, the online-softmax row max
//   (over the 4 lanes of a row) and sum in f32 registers, P = e^(s - m) by
//   ex2, the O accumulator rescaled by e^(m_old - m_new), then O += P V with
//   P's accumulator fragments packed to bf16 as the A operand and V read by
//   ldmatrix.trans. P is rounded to bf16 before PV, as the Pallas kernel
//   rounds it; the row sum adds the unrounded P, as Pallas does; every sum is
//   f32. The keys are split into chunks so that the query tiles of all
//   (batch, head) fill the card (the wrapper picks the count); each chunk
//   writes its unnormalised f32 O and its row (max, sum) to scratch, and a
//   small launch merges the chunks in chunk order (m = max m_c,
//   l = sum l_c e^(m_c - m), O = sum O_c e^(m_c - m) / l): deterministic, no
//   atomics. With one chunk the main launch writes O and lse itself. No score
//   is ever -inf: a chunk whose keys are all blocked for a row has m_c about
//   -1e9, and its merge weight e^(m_c - m) is exactly 0.
//   What bounds it now: not bytes (K, V and the mask are read once per row
//   tile) nor tensor-core operations, but the scalar work per score (mask
//   test, max, exp, packing) and the mma -> softmax -> mma latency of each
//   warp at 16 warps an SM; the 72-row second tile of Q = 200 leaves 3 of its
//   8 warps idle.
// - forward, f32: on CUDA cores in f32, flash style, kept for the f32 parity
//   checks. A block holds 8 query rows of one (batch, head), a warp per row;
//   it walks the keys in tiles of 64 staged in shared memory, each lane
//   scoring one key of a 32-key step, and keeps the online-softmax max, sum
//   and the D-channel accumulator in registers.
// - backward, bf16: on tensor cores (mma.sync m16n8k16, bf16 in, f32
//   accumulate; csrc/mma.cuh), FlashAttention-2's backward as two launches
//   with no atomics. Tiles of 64 rows are copied into shared memory as bf16
//   by cp.async, double buffered (the next tile is in flight while this one
//   is used), rows padded by 16 bytes so that ldmatrix reads them without
//   bank conflicts; each warp takes a tile in two halves of 32 columns to
//   hold fewer registers.
//   (1) dQ: a block of 8 warps holds 128 query rows (16 a warp, their Q and
//   dO as A fragments in registers) and walks one chunk of the keys in tiles
//   of 64: S = Q K^T and dP = dO V^T by mma, P and dS in f32 registers, then
//   dQ += dS K with dS's accumulator fragments reused as the A operand and K
//   read by ldmatrix.trans. The keys are split into chunks so that the
//   query tiles of all (batch, head) fill the card (the wrapper picks the
//   count); each chunk writes an f32 partial dQ, and a small launch sums the
//   partials in a fixed order and casts. The chunk-0 blocks also write Delta.
//   (2) dK/dV: a block of 4 warps holds 64 keys (their K and V as A
//   fragments) and walks the queries in chunks of 64 with their lse, Delta
//   and mask bytes: S^T = K Q^T and dP^T = V dO^T, P^T and dS^T in f32,
//   dV += P^T dO and dK += dS^T Q with dO and Q through ldmatrix.trans. dK
//   and dV are written once. It is held to 128 registers so that 4 blocks
//   (16 warps) share an SM, which measured faster than 2 blocks with no
//   spills.
//   P and dS are rounded to bf16 before the products that consume them (as the
//   Pallas forward rounds P before PV); every sum is f32. A padded key or
//   query reads mask bytes of 1, so its P = dS = 0, and padded rows in shared
//   memory are zero.
//   What bounds it now: neither bytes nor tensor-core operations but the
//   scalar work per score (mask test, exp, dS, packing), done once in each
//   launch, and the latency of each warp's mma → exp → mma chain at 16 warps
//   an SM.
// - backward, f32: on CUDA cores in f32, kept for the f32 parity checks:
//   (1) a warp per query row walks the keys, recomputes P and dS and writes dQ
//   and Delta; (2) a block per (batch*head, tile of 64 keys) stages up to 256
//   query rows of Q, dO and the mask tile at a time in shared memory, and a
//   warp per key loops over them for dK and dV.
// Left for later: wgmma and TMA (warp-specialised, pipelined) for the bf16
// forward and backward, and one pass over the scores for both gradients.

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKeyTile = 64;
constexpr int kMaxQueries = 512;
constexpr int kQueryChunk = 256;  // query rows the f32 dK/dV launch stages at once
constexpr float kMaskedBias = -1e9f;
constexpr float kLog2e = 1.4426950408889634f;

// the tensor-core (bf16) kernels
constexpr int kQueryBlockThreads = 256;  // a forward or dQ block: 8 warps of 16 query rows
constexpr int kQueryBlockRows = 128;
constexpr int kDkdvThreads = 128, kDkdvKeys = 64;  // a dK/dV block: 4 warps of 16 keys
constexpr float kNoMax = -1e30f;  // the running max before the first key (below any score)
constexpr int kQueryTile = 64;  // queries the dK/dV launch stages at a time

// rows [row0, row0 + kKeyTile) of a (rows_total, D) array → shared f32 with
// row stride D + 1; rows past the end are zero
template <typename T, int D>
__device__ __forceinline__ void load_key_tile(float* dst, const T* __restrict__ src, int row0,
                                              int rows_total) {
  for (int e = threadIdx.x; e < kKeyTile * D; e += blockDim.x) {
    const int r = e / D, c = e - r * D;
    const int row = row0 + r;
    dst[r * (D + 1) + c] = row < rows_total ? to_f(src[static_cast<long long>(row) * D + c]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
masked_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const uint8_t* __restrict__ mask,
                            T* __restrict__ o, float* __restrict__ lse, int heads, int nq,
                            int ns) {
  constexpr int ld = D + 1;
  constexpr int kPerLane = (D + 31) / 32;
  __shared__ float sk[kKeyTile * ld];
  __shared__ float sv[kKeyTile * ld];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long bh = blockIdx.y;
  const long long b = bh / heads;
  const int i = blockIdx.x * kWarps + warp;
  const bool active = i < nq;
  const T* kb = k + bh * ns * D;
  const T* vb = v + bh * ns * D;

  float qr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) qr[d] = active ? to_f(q[(bh * nq + i) * D + d]) : 0.f;
  const uint8_t* mrow = mask + (b * nq + (active ? i : 0)) * ns;
  float m = -INFINITY, l = 0.f;
  float acc[kPerLane];
#pragma unroll
  for (int c = 0; c < kPerLane; ++c) acc[c] = 0.f;

  for (int s0 = 0; s0 < ns; s0 += kKeyTile) {
    __syncthreads();
    load_key_tile<T, D>(sk, kb, s0, ns);
    load_key_tile<T, D>(sv, vb, s0, ns);
    __syncthreads();
    if (!active) continue;
    for (int sub = 0; sub < kKeyTile && s0 + sub < ns; sub += 32) {
      const int j = s0 + sub + lane;
      float s = -INFINITY;
      if (j < ns) s = dot_reg<D>(qr, sk + (sub + lane) * ld) + (mrow[j] ? kMaskedBias : 0.f);
      const float m_new = fmaxf(m, warp_max(s));
      const float alpha = expf(m - m_new);
      const float p = j < ns ? expf(s - m_new) : 0.f;
      l = l * alpha + warp_sum(p);
#pragma unroll
      for (int c = 0; c < kPerLane; ++c) acc[c] *= alpha;
      for (int jj = 0; jj < 32; ++jj) {
        const float pj = __shfl_sync(0xffffffffu, p, jj);
        const float* vrow = sv + (sub + jj) * ld;
#pragma unroll
        for (int c = 0; c < kPerLane; ++c) {
          const int d = lane + 32 * c;
          if (d < D) acc[c] += pj * vrow[d];
        }
      }
      m = m_new;
    }
  }
  if (active) {
#pragma unroll
    for (int c = 0; c < kPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < D) o[(bh * nq + i) * D + d] = from_f<T>(acc[c] / l);
    }
    if (lane == 0) lse[bh * nq + i] = m + logf(l);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
masked_attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, const T* __restrict__ o,
                               const T* __restrict__ dout, const float* __restrict__ lse,
                               const uint8_t* __restrict__ mask, T* __restrict__ dq,
                               float* __restrict__ delta, int heads, int nq, int ns) {
  constexpr int ld = D + 1;
  constexpr int kPerLane = (D + 31) / 32;
  __shared__ float sk[kKeyTile * ld];
  __shared__ float sv[kKeyTile * ld];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long bh = blockIdx.y;
  const long long b = bh / heads;
  const int i = blockIdx.x * kWarps + warp;
  const bool active = i < nq;
  const long long row = bh * nq + (active ? i : 0);

  float qr[D], dor[D];
  float dl = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = to_f(q[row * D + d]);
    dor[d] = to_f(dout[row * D + d]);
  }
  for (int d = lane; d < D; d += 32) dl += dor[d] * to_f(o[row * D + d]);
  dl = warp_sum(dl);
  const float row_lse = lse[row];
  const uint8_t* mrow = mask + (b * nq + (active ? i : 0)) * ns;
  float acc[kPerLane];
#pragma unroll
  for (int c = 0; c < kPerLane; ++c) acc[c] = 0.f;

  for (int s0 = 0; s0 < ns; s0 += kKeyTile) {
    __syncthreads();
    load_key_tile<T, D>(sk, k + bh * ns * D, s0, ns);
    load_key_tile<T, D>(sv, v + bh * ns * D, s0, ns);
    __syncthreads();
    if (!active) continue;
    for (int sub = 0; sub < kKeyTile && s0 + sub < ns; sub += 32) {
      const int j = s0 + sub + lane;
      float ds = 0.f;
      if (j < ns) {
        const float s = dot_reg<D>(qr, sk + (sub + lane) * ld) + (mrow[j] ? kMaskedBias : 0.f);
        const float p = expf(s - row_lse);
        ds = p * (dot_reg<D>(dor, sv + (sub + lane) * ld) - dl);
      }
      for (int jj = 0; jj < 32; ++jj) {
        const float dsj = __shfl_sync(0xffffffffu, ds, jj);
        const float* krow = sk + (sub + jj) * ld;
#pragma unroll
        for (int c = 0; c < kPerLane; ++c) {
          const int d = lane + 32 * c;
          if (d < D) acc[c] += dsj * krow[d];
        }
      }
    }
  }
  if (active) {
#pragma unroll
    for (int c = 0; c < kPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < D) dq[row * D + d] = from_f<T>(acc[c]);
    }
    if (lane == 0) delta[row] = dl;
  }
}

// shared floats (plus mask bytes) of the f32 dK/dV launch for `nc` staged rows
template <int D>
size_t dkdv_shared_bytes(int nc) {
  return (2 * static_cast<size_t>(nc) * (D + 1) + 2 * nc + 2 * kWarps * nc) * sizeof(float) +
         static_cast<size_t>(nc) * kKeyTile;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
masked_attention_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                 const T* __restrict__ v, const T* __restrict__ dout,
                                 const float* __restrict__ lse, const float* __restrict__ delta,
                                 const uint8_t* __restrict__ mask, T* __restrict__ dk,
                                 T* __restrict__ dv, int heads, int nq, int ns) {
  extern __shared__ float smem[];
  constexpr int ld = D + 1;
  constexpr int kPerLane = (D + 31) / 32;
  constexpr int kKeysPerWarp = kKeyTile / kWarps;
  const int nc = min(nq, kQueryChunk);  // rows staged at once
  float* sq = smem;
  float* sdo = sq + nc * ld;
  float* slse = sdo + nc * ld;
  float* sdelta = slse + nc;
  float* sbuf = sdelta + nc;  // kWarps x 2 rows of nc
  uint8_t* smask = reinterpret_cast<uint8_t*>(sbuf + 2 * kWarps * nc);  // (nc, kKeyTile)

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long bh = blockIdx.y;
  const long long b = bh / heads;
  const int s0 = blockIdx.x * kKeyTile;
  float* pbuf = sbuf + warp * 2 * nc;
  float* dsbuf = pbuf + nc;
  float acc_k[kKeysPerWarp][kPerLane], acc_v[kKeysPerWarp][kPerLane];
#pragma unroll
  for (int t = 0; t < kKeysPerWarp; ++t)
#pragma unroll
    for (int c = 0; c < kPerLane; ++c) acc_k[t][c] = acc_v[t][c] = 0.f;

  for (int c0 = 0; c0 < nq; c0 += nc) {
    const int rows = min(nc, nq - c0);
    const long long qbase = bh * nq + c0;
    __syncthreads();
    for (int e = threadIdx.x; e < rows * D; e += kThreads) {
      const int r = e / D, c = e - r * D;
      sq[r * ld + c] = to_f(q[qbase * D + e]);
      sdo[r * ld + c] = to_f(dout[qbase * D + e]);
    }
    for (int r = threadIdx.x; r < rows; r += kThreads) {
      slse[r] = lse[qbase + r];
      sdelta[r] = delta[qbase + r];
    }
    for (int e = threadIdx.x; e < rows * kKeyTile; e += kThreads) {
      const int r = e / kKeyTile, c = e - r * kKeyTile;
      smask[e] = s0 + c < ns ? mask[(b * nq + c0 + r) * ns + s0 + c] : 1;
    }
    __syncthreads();

#pragma unroll
    for (int t = 0; t < kKeysPerWarp; ++t) {
      const int jt = warp + t * kWarps;
      const int j = s0 + jt;
      if (j >= ns) break;
      float kr[D], vr[D];
      const long long krow = (bh * ns + j) * D;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        kr[d] = to_f(k[krow + d]);
        vr[d] = to_f(v[krow + d]);
      }
      for (int i = lane; i < rows; i += 32) {
        const float s =
            dot_reg<D>(kr, sq + i * ld) + (smask[i * kKeyTile + jt] ? kMaskedBias : 0.f);
        const float p = expf(s - slse[i]);
        pbuf[i] = p;
        dsbuf[i] = p * (dot_reg<D>(vr, sdo + i * ld) - sdelta[i]);
      }
      __syncwarp();
#pragma unroll
      for (int c = 0; c < kPerLane; ++c) {
        const int d = lane + 32 * c;
        if (d >= D) continue;
        for (int i = 0; i < rows; ++i) {
          acc_v[t][c] += pbuf[i] * sdo[i * ld + d];
          acc_k[t][c] += dsbuf[i] * sq[i * ld + d];
        }
      }
      __syncwarp();
    }
  }
#pragma unroll
  for (int t = 0; t < kKeysPerWarp; ++t) {
    const int j = s0 + warp + t * kWarps;
    if (j >= ns) break;
#pragma unroll
    for (int c = 0; c < kPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < D) {
        dk[(bh * ns + j) * D + d] = from_f<T>(acc_k[t][c]);
        dv[(bh * ns + j) * D + d] = from_f<T>(acc_v[t][c]);
      }
    }
  }
}

// ---- the tensor-core (bf16) backward ----

// rows [row0, row0 + ROWS) of a (rows_total, D) bf16 array → shared bf16
// with row stride D + 8, by cp.async in 16-byte vectors from THREADS
// threads; rows past the end are zero
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void stage_rows(bf16_t* dst, const bf16_t* __restrict__ src, int row0,
                                           int rows_total) {
  constexpr int kVecs = D / 8, kCount = ROWS * kVecs;
#pragma unroll
  for (int i = 0; i < (kCount + THREADS - 1) / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    if (kCount % THREADS != 0 && e >= kCount) break;
    const int r = e / kVecs, c = (e - r * kVecs) * 8;
    const bool ok = row0 + r < rows_total;
    cp_async_16(dst + r * (D + 8) + c, src + (ok ? static_cast<long long>(row0 + r) * D + c : 0),
                ok);
  }
}

// the mask bytes of queries [q0, q0 + ROWS) x keys [s0, s0 + COLS) of one
// batch entry (`mask` points at its (nq, ns) bytes) → shared [query][key],
// row stride COLS + 4, from THREADS threads: by cp.async in 4-byte words where the rows are 4-byte
// aligned, else byte by byte. Outside (nq, ns) a byte is 1 (masked), so a
// padded key or query gets P = 0 with no test of its own.
template <int ROWS, int COLS, int THREADS>
__device__ __forceinline__ void stage_mask(uint8_t* dst, const uint8_t* __restrict__ mask, int q0,
                                           int nq, int s0, int ns) {
  const bool words = (ns & 3) == 0 && (reinterpret_cast<uintptr_t>(mask) & 3) == 0;
  constexpr int kWordsPerRow = COLS / 4, kMaskLd = COLS + 4;
  static_assert(ROWS * kWordsPerRow % THREADS == 0, "whole words per thread");
#pragma unroll
  for (int i = 0; i < ROWS * kWordsPerRow / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int r = e / kWordsPerRow, c = (e - r * kWordsPerRow) * 4;
    const int qi = q0 + r, sj = s0 + c;
    const bool ok = qi < nq && sj < ns;
    const uint8_t* src = mask + (ok ? static_cast<long long>(qi) * ns + sj : 0);
    if (words && ok) {
      cp_async_4(dst + r * kMaskLd + c, src, true);
    } else {  // a plain store: this buffer is not read until the next barrier
      uint32_t w = 0u;
#pragma unroll
      for (int t = 0; t < 4; ++t) w |= (ok && sj + t < ns ? src[t] : 1u) << (8 * t);
      *reinterpret_cast<uint32_t*>(dst + r * kMaskLd + c) = w;
    }
  }
}

// A fragments (D / 16 k-steps) of rows r0 and r0 + 8 of a (rows_total, D)
// bf16 array; zero for rows past the end
template <int D>
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[D / 16][4],
                                            const bf16_t* __restrict__ src, int r0,
                                            int rows_total, int tig) {
  const bool ok0 = r0 < rows_total, ok1 = r0 + 8 < rows_total;
  const bf16_t* p0 = src + static_cast<long long>(r0) * D + 2 * tig;
  const bf16_t* p1 = p0 + 8 * D;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    a[kk][0] = ok0 ? load_bf16x2(p0 + kk * 16) : 0u;
    a[kk][1] = ok1 ? load_bf16x2(p1 + kk * 16) : 0u;
    a[kk][2] = ok0 ? load_bf16x2(p0 + kk * 16 + 8) : 0u;
    a[kk][3] = ok1 ? load_bf16x2(p1 + kk * 16 + 8) : 0u;
  }
}

// scores of a half tile (4 n8 tiles of 32 columns, C fragments c[j][e]:
// rows g and g + 8 of the lane, columns 8j + 2t and 8j + 2t + 1) → the A
// fragments of its 2 k16 steps, of P = e^(s + bias - lse) and of
// dS = P (dp - delta). `masked(j, e)` is the mask byte, `lse2(j, e)` the
// row's (or column's) lse times log2(e), `delta(j, e)` its Delta.
template <typename Masked, typename Lse2, typename Delta>
__device__ __forceinline__ void probs_to_a(uint32_t (&pa)[2][4], uint32_t (&dsa)[2][4],
                                           const float (&s)[4][4], const float (&dp)[4][4],
                                           Masked masked, Lse2 lse2, Delta delta) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float p[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = exp2_approx(fmaf(s[j][e] + (masked(j, e) ? kMaskedBias : 0.f), kLog2e, -lse2(j, e)));
      ds[e] = p[e] * (dp[j][e] - delta(j, e));
    }
    pa[j / 2][(j & 1) * 2] = pack_bf16x2(p[0], p[1]);
    pa[j / 2][(j & 1) * 2 + 1] = pack_bf16x2(p[2], p[3]);
    dsa[j / 2][(j & 1) * 2] = pack_bf16x2(ds[0], ds[1]);
    dsa[j / 2][(j & 1) * 2 + 1] = pack_bf16x2(ds[2], ds[3]);
  }
}

// the mask bytes of a half tile (32 keys) for a lane's C fragments, from the
// staged mask at `row`, the lane's row g and the half's first key: m2[j][h]
// holds the bytes of columns 8j + 2t and 8j + 2t + 1 (low byte first) of rows
// g (h = 0) and g + 8 (h = 1)
__device__ __forceinline__ void load_mask_pairs(uint32_t (&m2)[4][2], const uint8_t* row,
                                                int tig) {
  constexpr int kMaskLd = kKeyTile + 4;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      m2[j][h] = *reinterpret_cast<const uint16_t*>(row + h * 8 * kMaskLd + 8 * j + 2 * tig);
}

// the mask byte of C fragment element (j, e) from load_mask_pairs' m2
__device__ __forceinline__ uint32_t mask_byte(const uint32_t (&m2)[4][2], int j, int e) {
  return (m2[j][e >> 1] >> (8 * (e & 1))) & 0xffu;
}

// the dynamic shared memory of a forward or dQ block: two buffers each of a
// K and a V tile and of the (128 x 64) mask bytes
template <int D>
constexpr size_t query_block_shared_bytes() {
  return 4 * kKeyTile * (D + 8) * sizeof(bf16_t) + 2 * kQueryBlockRows * (kKeyTile + 4);
}

template <int D>
__global__ void __launch_bounds__(kQueryBlockThreads, 2)  // 2 blocks an SM: at most 128 registers
masked_attention_fwd_mma_kernel(const bf16_t* __restrict__ q, const bf16_t* __restrict__ k,
                                const bf16_t* __restrict__ v, const uint8_t* __restrict__ mask,
                                bf16_t* __restrict__ o, float* __restrict__ lse,
                                float* __restrict__ part, int heads, int nq, int ns,
                                int tiles_per_chunk) {
  constexpr int ld = D + 8, kMaskLd = kKeyTile + 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto sk = reinterpret_cast<bf16_t (*)[kKeyTile * ld]>(smem_raw);
  auto sv = sk + 2;
  auto smask = reinterpret_cast<uint8_t (*)[kQueryBlockRows * kMaskLd]>(sv + 2);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tig = lane % 4;
  const long long bh = blockIdx.z;
  const long long b = bh / heads;
  const int q0 = blockIdx.x * kQueryBlockRows, chunk = blockIdx.y;
  const int tile_begin = chunk * tiles_per_chunk;
  const int tile_end = min(tile_begin + tiles_per_chunk, (ns + kKeyTile - 1) / kKeyTile);
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};  // this lane's two rows
  const bool warp_active = q0 + warp * 16 < nq;
  const bf16_t* kb = k + bh * ns * D;
  const bf16_t* vb = v + bh * ns * D;
  const uint8_t* mb = mask + b * nq * ns;
  auto stage = [&](int buf, int tile) {
    stage_rows<D, kKeyTile, kQueryBlockThreads>(sk[buf], kb, tile * kKeyTile, ns);
    stage_rows<D, kKeyTile, kQueryBlockThreads>(sv[buf], vb, tile * kKeyTile, ns);
    stage_mask<kQueryBlockRows, kKeyTile, kQueryBlockThreads>(smask[buf], mb, q0, nq,
                                                              tile * kKeyTile, ns);
  };
  if (tile_begin < tile_end) stage(0, tile_begin);
  cp_async_commit();

  uint32_t qa[D / 16][4];
  load_a_rows<D>(qa, q + bh * nq * D, rows[0], nq, tig);
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // of rows g and g + 8: the running max (the same in the row's 4 lanes) and
  // this lane's share of the running sum
  float m[2] = {kNoMax, kNoMax}, l[2] = {0.f, 0.f};

  for (int t = tile_begin; t < tile_end; ++t) {
    const int buf = (t - tile_begin) & 1;
    if (t + 1 < tile_end) stage(buf ^ 1, t + 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile t's copies are done
    __syncthreads();
    if (warp_active) {
      const uint8_t* mrow0 = smask[buf] + (warp * 16 + g) * kMaskLd;
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // 32 keys at a time
        if (t * kKeyTile + half * 32 >= ns) break;
        float s[4][4] = {};
        mma_rows_t<D, 4>(s, qa, sk[buf] + half * 32 * ld, lane);
        uint32_t m2[4][2];
        load_mask_pairs(m2, mrow0 + half * 32, tig);
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][e] += mask_byte(m2, j, e) ? kMaskedBias : 0.f;
            mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
          }
        float mlog2[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // the row's new max over its quad; rescale the old sums
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          const float alpha = exp2_approx((m[h] - mx[h]) * kLog2e);
          l[h] *= alpha;
#pragma unroll
          for (int n = 0; n < D / 8; ++n) {
            acc[n][2 * h] *= alpha;
            acc[n][2 * h + 1] *= alpha;
          }
          m[h] = mx[h];
          mlog2[h] = mx[h] * kLog2e;
        }
        // P = e^(s - m) with log2(e) folded into an FMA; the sum takes P in
        // f32, the product P rounded to bf16 (C fragments → A, mma.cuh)
        uint32_t pa[2][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) p[e] = exp2_approx(fmaf(s[j][e], kLog2e, -mlog2[e >> 1]));
          l[0] += p[0] + p[1];
          l[1] += p[2] + p[3];
          pa[j / 2][(j & 1) * 2] = pack_bf16x2(p[0], p[1]);
          pa[j / 2][(j & 1) * 2 + 1] = pack_bf16x2(p[2], p[3]);
        }
        mma_rows<D, 2>(acc, pa, sv[buf] + half * 32 * ld, lane);
      }
    }
    __syncthreads();  // every warp is done with `buf` before it is refilled
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {  // the row sums over the quad
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  if (gridDim.y == 1) {  // one chunk: normalise, write O and lse
    bf16_t* ob = o + bh * nq * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (rows[h] >= nq) continue;  // rows past nq are not written
      const float inv = 1.f / l[h];
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(ob + rows[h] * D + n * 8 + 2 * tig) =
            pack_bf16x2(acc[n][2 * h] * inv, acc[n][2 * h + 1] * inv);
      if (tig == 0) lse[bh * nq + rows[h]] = m[h] + logf(l[h]);
    }
  } else {  // this chunk's unnormalised O and (max, sum) for the combine launch
    const long long at = static_cast<long long>(chunk) * gridDim.z + bh;
    float* ob = part + at * nq * D;
    float2* ml =
        reinterpret_cast<float2*>(part + static_cast<long long>(gridDim.y) * gridDim.z * nq * D) +
        at * nq;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (rows[h] >= nq) continue;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<float2*>(ob + rows[h] * D + n * 8 + 2 * tig) =
            make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
      if (tig == 0) ml[rows[h]] = make_float2(m[h], l[h]);
    }
  }
}

// O (as bf16) and lse from the forward's `chunks` partials, merged in chunk
// order: `part` holds the unnormalised O (chunks, rows, D), then each row's
// (max, sum) (chunks, rows)
template <int D>
__global__ void masked_attention_fwd_combine_kernel(const float* __restrict__ part,
                                                    bf16_t* __restrict__ o,
                                                    float* __restrict__ lse, long long rows,
                                                    int chunks) {
  const float2* ml = reinterpret_cast<const float2*>(part + chunks * rows * D);
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < rows * D;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long row = i / D;
    float m = kNoMax;
    for (int c = 0; c < chunks; ++c) m = fmaxf(m, ml[c * rows + row].x);
    float l = 0.f, acc = 0.f;
    for (int c = 0; c < chunks; ++c) {
      const float2 x = ml[c * rows + row];
      const float w = expf(x.x - m);  // exactly 0 for a chunk that saw only blocked keys
      l += x.y * w;
      acc += part[c * rows * D + i] * w;
    }
    o[i] = __float2bfloat16(acc / l);
    if (i == row * D) lse[row] = m + logf(l);
  }
}

template <int D>
__global__ void __launch_bounds__(kQueryBlockThreads)
masked_attention_bwd_dq_mma_kernel(const bf16_t* __restrict__ q, const bf16_t* __restrict__ k,
                                   const bf16_t* __restrict__ v, const bf16_t* __restrict__ o,
                                   const bf16_t* __restrict__ dout, const float* __restrict__ lse,
                                   const uint8_t* __restrict__ mask, float* __restrict__ dq_part,
                                   float* __restrict__ delta, int heads, int nq, int ns,
                                   int tiles_per_chunk) {
  constexpr int ld = D + 8, kMaskLd = kKeyTile + 4;
  // query_block_shared_bytes<D>(), two buffers of each: the next key tile is
  // copied in while this one is used
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto sk = reinterpret_cast<bf16_t (*)[kKeyTile * ld]>(smem_raw);
  auto sv = sk + 2;
  auto smask = reinterpret_cast<uint8_t (*)[kQueryBlockRows * kMaskLd]>(sv + 2);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tig = lane % 4;
  const long long bh = blockIdx.z;
  const long long b = bh / heads;
  const int q0 = blockIdx.x * kQueryBlockRows, chunk = blockIdx.y;
  const int tile_begin = chunk * tiles_per_chunk;
  const int tile_end = min(tile_begin + tiles_per_chunk, (ns + kKeyTile - 1) / kKeyTile);
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;  // this lane's two rows
  const bool warp_active = q0 + warp * 16 < nq;
  const bf16_t* kb = k + bh * ns * D;
  const bf16_t* vb = v + bh * ns * D;
  const uint8_t* mb = mask + b * nq * ns;
  auto stage = [&](int buf, int tile) {
    stage_rows<D, kKeyTile, kQueryBlockThreads>(sk[buf], kb, tile * kKeyTile, ns);
    stage_rows<D, kKeyTile, kQueryBlockThreads>(sv[buf], vb, tile * kKeyTile, ns);
    stage_mask<kQueryBlockRows, kKeyTile, kQueryBlockThreads>(smask[buf], mb, q0, nq, tile * kKeyTile, ns);
  };
  if (tile_begin < tile_end) stage(0, tile_begin);
  cp_async_commit();

  uint32_t qa[D / 16][4], da[D / 16][4];
  load_a_rows<D>(qa, q + bh * nq * D, r0, nq, tig);
  load_a_rows<D>(da, dout + bh * nq * D, r0, nq, tig);
  const float lse0 = r0 < nq ? lse[bh * nq + r0] * kLog2e : 0.f;  // rows past nq are not written
  const float lse1 = r1 < nq ? lse[bh * nq + r1] * kLog2e : 0.f;
  // Delta of row (lane / 2) of the warp, two lanes a row, half of D each
  float dl = 0.f;
  {
    const int row = q0 + warp * 16 + lane / 2, d0 = (lane & 1) * (D / 2);
    if (row < nq) {
      const bf16_t* dor = dout + (bh * nq + row) * D + d0;
      const bf16_t* orow = o + (bh * nq + row) * D + d0;
#pragma unroll
      for (int d = 0; d < D / 2; d += 2) {
        const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dor + d));
        const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(orow + d));
        dl += x.x * y.x + x.y * y.y;
      }
    }
    dl += __shfl_xor_sync(0xffffffffu, dl, 1);
    if (chunk == 0 && row < nq && (lane & 1) == 0) delta[bh * nq + row] = dl;
  }
  const float dl0 = __shfl_sync(0xffffffffu, dl, 2 * g);
  const float dl1 = __shfl_sync(0xffffffffu, dl, 2 * (g + 8));

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int t = tile_begin; t < tile_end; ++t) {
    const int buf = (t - tile_begin) & 1;
    if (t + 1 < tile_end) stage(buf ^ 1, t + 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile t's copies are done
    __syncthreads();
    if (warp_active) {
      const uint8_t* mrow0 = smask[buf] + (warp * 16 + g) * kMaskLd;
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // 32 keys at a time
        if (t * kKeyTile + half * 32 >= ns) break;
        const bf16_t* skh = sk[buf] + half * 32 * ld;
        float sc[4][4] = {}, dp[4][4] = {};
        mma_rows_t<D, 4>(sc, qa, skh, lane);
        mma_rows_t<D, 4>(dp, da, sv[buf] + half * 32 * ld, lane);
        uint32_t pa[2][4], dsa[2][4];
        uint32_t m2[4][2];
        load_mask_pairs(m2, mrow0 + half * 32, tig);
        probs_to_a(
            pa, dsa, sc, dp, [&](int j, int e) { return mask_byte(m2, j, e); },
            [&](int, int e) { return e >> 1 ? lse1 : lse0; },
            [&](int, int e) { return e >> 1 ? dl1 : dl0; });
        mma_rows<D, 2>(acc, dsa, skh, lane);
      }
    }
    __syncthreads();  // every warp is done with `buf` before it is refilled
  }

  float* out = dq_part + (static_cast<long long>(chunk) * gridDim.z + bh) * nq * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * tig;
    if (r0 < nq) *reinterpret_cast<float2*>(out + r0 * D + col) = make_float2(acc[n][0], acc[n][1]);
    if (r1 < nq) *reinterpret_cast<float2*>(out + r1 * D + col) = make_float2(acc[n][2], acc[n][3]);
  }
}

// dq = the sum of the `chunks` partials (chunks, n) in chunk order, as bf16
__global__ void masked_attention_dq_reduce_kernel(const float* __restrict__ part,
                                                  bf16_t* __restrict__ dq, long long n,
                                                  int chunks) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float sum = 0.f;
    for (int c = 0; c < chunks; ++c) sum += part[c * n + i];
    dq[i] = __float2bfloat16(sum);
  }
}

template <int D>
__global__ void __launch_bounds__(kDkdvThreads, 4)  // 4 blocks an SM: at most 128 registers
masked_attention_bwd_dkdv_mma_kernel(const bf16_t* __restrict__ q, const bf16_t* __restrict__ k,
                                     const bf16_t* __restrict__ v, const bf16_t* __restrict__ dout,
                                     const float* __restrict__ lse,
                                     const float* __restrict__ delta,
                                     const uint8_t* __restrict__ mask, bf16_t* __restrict__ dk,
                                     bf16_t* __restrict__ dv, int heads, int nq, int ns) {
  constexpr int ld = D + 8, kMaskLd = kDkdvKeys + 4;
  // two buffers: the next query chunk is copied in while this one is used
  __shared__ __align__(16) bf16_t sq[2][kQueryTile * ld];
  __shared__ __align__(16) bf16_t sdo[2][kQueryTile * ld];
  __shared__ __align__(16) float slse[2][kQueryTile];
  __shared__ __align__(16) float sdelta[2][kQueryTile];
  __shared__ __align__(16) uint8_t smask[2][kQueryTile * kMaskLd];  // [query][key]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tig = lane % 4;
  const long long bh = blockIdx.y;
  const long long b = bh / heads;
  const int s0 = blockIdx.x * kDkdvKeys;
  const int key0 = s0 + warp * 16 + g, key1 = key0 + 8;  // this lane's two keys
  const bool warp_active = s0 + warp * 16 < ns;
  const bf16_t* qb = q + bh * nq * D;
  const bf16_t* dob = dout + bh * nq * D;
  const uint8_t* mb = mask + b * nq * ns;
  auto stage = [&](int buf, int c0) {
    stage_rows<D, kQueryTile, kDkdvThreads>(sq[buf], qb, c0, nq);
    stage_rows<D, kQueryTile, kDkdvThreads>(sdo[buf], dob, c0, nq);
    // threads [0, 64) copy lse, [64, 128) Delta; a padded query's are 0 (its
    // mask bytes are 1)
    static_assert(kDkdvThreads == 2 * kQueryTile, "a thread for each lse and Delta entry");
    const int r = threadIdx.x % kQueryTile;
    const bool ok = c0 + r < nq;
    const float* src = (threadIdx.x < kQueryTile ? lse : delta) + bh * nq + (ok ? c0 + r : 0);
    cp_async_4((threadIdx.x < kQueryTile ? slse[buf] : sdelta[buf]) + r, src, ok);
    stage_mask<kQueryTile, kDkdvKeys, kDkdvThreads>(smask[buf], mb, c0, nq, s0, ns);
  };
  stage(0, 0);
  cp_async_commit();

  uint32_t ka[D / 16][4], va[D / 16][4];
  load_a_rows<D>(ka, k + bh * ns * D, key0, ns, tig);
  load_a_rows<D>(va, v + bh * ns * D, key0, ns, tig);
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int c0 = 0; c0 < nq; c0 += kQueryTile) {
    const int buf = (c0 / kQueryTile) & 1;
    if (c0 + kQueryTile < nq) stage(buf ^ 1, c0 + kQueryTile);
    cp_async_commit();
    cp_async_wait<1>();  // this chunk's copies are done
    __syncthreads();
    if (warp_active) {
      const uint8_t* mcol = smask[buf] + warp * 16 + g;  // this lane's key g; + 8 for key g + 8
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // 32 queries at a time
        if (c0 + half * 32 >= nq) break;
        const int cbase = half * 32 + 2 * tig;
        float st[4][4] = {}, dpt[4][4] = {};
        mma_rows_t<D, 4>(st, ka, sq[buf] + half * 32 * ld, lane);
        mma_rows_t<D, 4>(dpt, va, sdo[buf] + half * 32 * ld, lane);
        uint32_t pa[2][4], dsa[2][4];
        probs_to_a(
            pa, dsa, st, dpt,
            [&](int j, int e) { return mcol[(cbase + 8 * j + (e & 1)) * kMaskLd + (e >> 1) * 8]; },
            [&](int j, int e) { return slse[buf][cbase + 8 * j + (e & 1)] * kLog2e; },
            [&](int j, int e) { return sdelta[buf][cbase + 8 * j + (e & 1)]; });
        mma_rows<D, 2>(dv_acc, pa, sdo[buf] + half * 32 * ld, lane);
        mma_rows<D, 2>(dk_acc, dsa, sq[buf] + half * 32 * ld, lane);
      }
    }
    __syncthreads();  // every warp is done with `buf` before it is refilled
  }

#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * tig;
    if (key0 < ns) {
      const long long at = (bh * ns + key0) * D + col;
      *reinterpret_cast<uint32_t*>(dk + at) = pack_bf16x2(dk_acc[n][0], dk_acc[n][1]);
      *reinterpret_cast<uint32_t*>(dv + at) = pack_bf16x2(dv_acc[n][0], dv_acc[n][1]);
    }
    if (key1 < ns) {
      const long long at = (bh * ns + key1) * D + col;
      *reinterpret_cast<uint32_t*>(dk + at) = pack_bf16x2(dk_acc[n][2], dk_acc[n][3]);
      *reinterpret_cast<uint32_t*>(dv + at) = pack_bf16x2(dv_acc[n][2], dv_acc[n][3]);
    }
  }
}

template <int D>
int launch_fwd_mma(const void* q, const void* k, const void* v, const void* mask, void* o,
                   void* lse, void* part, int chunks, int batch_heads, int heads, int nq, int ns,
                   cudaStream_t stream) {
  const int key_tiles = (ns + kKeyTile - 1) / kKeyTile;
  if (chunks < 1 || chunks > key_tiles || (chunks > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_per_chunk = (key_tiles + chunks - 1) / chunks;
  const dim3 grid((nq + kQueryBlockRows - 1) / kQueryBlockRows, chunks, batch_heads);
  cudaFuncSetAttribute(masked_attention_fwd_mma_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(query_block_shared_bytes<D>()));
  masked_attention_fwd_mma_kernel<D>
      <<<grid, kQueryBlockThreads, query_block_shared_bytes<D>(), stream>>>(
          static_cast<const bf16_t*>(q), static_cast<const bf16_t*>(k),
          static_cast<const bf16_t*>(v), static_cast<const uint8_t*>(mask),
          static_cast<bf16_t*>(o), static_cast<float*>(lse), static_cast<float*>(part), heads, nq,
          ns, tiles_per_chunk);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || chunks == 1) return err;
  const long long rows = static_cast<long long>(batch_heads) * nq;
  const int blocks = static_cast<int>(std::min((rows * D + 255) / 256, 4096LL));
  masked_attention_fwd_combine_kernel<D><<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<bf16_t*>(o), static_cast<float*>(lse), rows,
      chunks);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, const void* mask, void* o, void* lse,
               void* part, int chunks, int batch_heads, int heads, int nq, int ns,
               cudaStream_t stream) {
  if (batch_heads <= 0 || nq <= 0) return static_cast<int>(cudaGetLastError());
  if constexpr (std::is_same<T, bf16_t>::value) {
    return launch_fwd_mma<D>(q, k, v, mask, o, lse, part, chunks, batch_heads, heads, nq, ns,
                             stream);
  } else {
    const dim3 grid((nq + kWarps - 1) / kWarps, batch_heads);
    masked_attention_fwd_kernel<T, D><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const uint8_t*>(mask), static_cast<T*>(o), static_cast<float*>(lse), heads,
        nq, ns);
    return static_cast<int>(cudaGetLastError());
  }
}

template <int D>
int launch_bwd_mma(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const void* lse, const void* mask, void* dq, void* dk, void* dv, void* delta,
                   void* dq_part, int dq_chunks, int batch_heads, int heads, int nq, int ns,
                   cudaStream_t stream) {
  const int key_tiles = (ns + kKeyTile - 1) / kKeyTile;
  if (dq_chunks < 1 || dq_chunks > key_tiles || dq_part == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_per_chunk = (key_tiles + dq_chunks - 1) / dq_chunks;
  const dim3 grid_q((nq + kQueryBlockRows - 1) / kQueryBlockRows, dq_chunks, batch_heads);
  cudaFuncSetAttribute(masked_attention_bwd_dq_mma_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(query_block_shared_bytes<D>()));
  masked_attention_bwd_dq_mma_kernel<D><<<grid_q, kQueryBlockThreads, query_block_shared_bytes<D>(), stream>>>(
      static_cast<const bf16_t*>(q), static_cast<const bf16_t*>(k), static_cast<const bf16_t*>(v),
      static_cast<const bf16_t*>(o), static_cast<const bf16_t*>(dout),
      static_cast<const float*>(lse),
      static_cast<const uint8_t*>(mask), static_cast<float*>(dq_part), static_cast<float*>(delta),
      heads, nq, ns, tiles_per_chunk);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const long long n = static_cast<long long>(batch_heads) * nq * D;
  const int reduce_blocks = static_cast<int>(std::min((n + 255) / 256, 4096LL));
  masked_attention_dq_reduce_kernel<<<reduce_blocks, 256, 0, stream>>>(
      static_cast<const float*>(dq_part), static_cast<bf16_t*>(dq), n, dq_chunks);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const dim3 grid_k((ns + kDkdvKeys - 1) / kDkdvKeys, batch_heads);
  masked_attention_bwd_dkdv_mma_kernel<D><<<grid_k, kDkdvThreads, 0, stream>>>(
      static_cast<const bf16_t*>(q), static_cast<const bf16_t*>(k), static_cast<const bf16_t*>(v),
      static_cast<const bf16_t*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const uint8_t*>(mask), static_cast<bf16_t*>(dk),
      static_cast<bf16_t*>(dv), heads, nq, ns);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const void* lse, const void* mask, void* dq, void* dk, void* dv, void* delta,
               void* dq_part, int dq_chunks, int batch_heads, int heads, int nq, int ns,
               cudaStream_t stream) {
  if (batch_heads <= 0 || nq <= 0) return static_cast<int>(cudaGetLastError());
  if constexpr (std::is_same<T, bf16_t>::value) {
    return launch_bwd_mma<D>(q, k, v, o, dout, lse, mask, dq, dk, dv, delta, dq_part, dq_chunks,
                             batch_heads, heads, nq, ns, stream);
  } else {
    const size_t smem = dkdv_shared_bytes<D>(std::min(nq, kQueryChunk));
    if (smem > kSharedLimit) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid_q((nq + kWarps - 1) / kWarps, batch_heads);
    masked_attention_bwd_dq_kernel<T, D><<<grid_q, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(o), static_cast<const T*>(dout), static_cast<const float*>(lse),
        static_cast<const uint8_t*>(mask), static_cast<T*>(dq), static_cast<float*>(delta), heads,
        nq, ns);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    auto kernel = masked_attention_bwd_dkdv_kernel<T, D>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    const dim3 grid_k((ns + kKeyTile - 1) / kKeyTile, batch_heads);
    kernel<<<grid_k, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<const uint8_t*>(mask), static_cast<T*>(dk),
        static_cast<T*>(dv), heads, nq, ns);
    return static_cast<int>(cudaGetLastError());
  }
}

}  // namespace

// All pointers are device pointers to contiguous arrays: q/o/dout/dq
// (batch, heads, nq, head_dim) and k/v/dk/dv (batch, heads, ns, head_dim) in
// bf16 (bf16 != 0; 16-byte aligned) or f32; mask (batch, nq, ns) bytes,
// nonzero = masked; lse and delta (batch, heads, nq) f32 (delta is scratch
// written by the backward). For bf16 the forward splits the keys into
// `chunks` chunks and the backward's dQ launch into `dq_chunks`, each
// 1 <= count <= ceil(ns / 64); `part` is f32 scratch of
// chunks * batch * heads * nq * (head_dim + 2) (the chunks' O, then their row
// max and sum; unused with one chunk) and dq_part of
// dq_chunks * batch * heads * nq * head_dim; for f32 the counts and scratch
// are unused. nq <= 512, ns >= 1 and head_dim in {16, 32, 64}. Launch on
// `stream`; return cudaGetLastError() (or cudaErrorInvalidValue for a shape
// the kernels do not take).
extern "C" int wis_masked_attention_fwd(const void* q, const void* k, const void* v,
                                        const void* mask, void* o, void* lse, void* part,
                                        int batch, int heads, int nq, int ns, int head_dim,
                                        int bf16, int chunks, void* stream) {
  if (nq > kMaxQueries || ns < 1) return static_cast<int>(cudaErrorInvalidValue);
  WIS_DISPATCH(launch_fwd, q, k, v, mask, o, lse, part, chunks, batch * heads, heads, nq, ns,
               static_cast<cudaStream_t>(stream))
}

extern "C" int wis_masked_attention_bwd(const void* q, const void* k, const void* v,
                                        const void* o, const void* dout, const void* lse,
                                        const void* mask, void* dq, void* dk, void* dv,
                                        void* delta, void* dq_part, int batch, int heads, int nq,
                                        int ns, int head_dim, int bf16, int dq_chunks,
                                        void* stream) {
  if (nq > kMaxQueries || ns < 1) return static_cast<int>(cudaErrorInvalidValue);
  WIS_DISPATCH(launch_bwd, q, k, v, o, dout, lse, mask, dq, dk, dv, delta, dq_part, dq_chunks,
               batch * heads, heads, nq, ns, static_cast<cudaStream_t>(stream))
}
