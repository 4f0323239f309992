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
// form does. The backward kernels have no Pallas original.
//
// What bounds it: memory. At the decoder's shapes (Q = 200, D = 32, S up to
// 10000) a score costs 4*D flops against (K, V, mask) bytes that are read once
// per (batch, head): about 60 flops per byte in bf16, far below the ~295 at
// which the H100's tensor cores would be the limit. This first version works
// on CUDA cores in f32 (row max, sum and accumulators in f32):
// - forward: flash style. A block holds 8 query rows of one (batch, head), a
//   warp per row; it walks the keys in tiles of 64 staged in shared memory,
//   each lane scoring one key of a 32-key step, and keeps the online-softmax
//   max, sum and the D-channel accumulator (one lane per channel) in
//   registers. It stores the per-row log-sum-exp for the backward. Rows are
//   never fully masked: the decoder's all-masked-row escape comes first.
// - backward, two launches: (1) a warp per query row walks the keys again,
//   recomputes P = exp(S - lse) and dS = P * (dP - Delta) with
//   Delta_i = dO_i . O_i, and writes dQ (and Delta); (2) a block per
//   (batch*head, tile of 64 keys) stages all Q rows, dO rows and the mask tile
//   in shared memory, and a warp per key loops over the queries for dK and dV.
//   No two threads add into one output, so there are no atomics.
// The re-reads of K and V by the 25 query blocks of a (batch, head) go to L2;
// wgmma, TMA and larger query tiles are left for later.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKeyTile = 64;
constexpr int kMaxQueries = 512;
constexpr float kMaskedBias = -1e9f;

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
masked_attention_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                 const T* __restrict__ v, const T* __restrict__ dout,
                                 const float* __restrict__ lse, const float* __restrict__ delta,
                                 const uint8_t* __restrict__ mask, T* __restrict__ dk,
                                 T* __restrict__ dv, int heads, int nq, int ns) {
  extern __shared__ float smem[];
  constexpr int ld = D + 1;
  float* sq = smem;
  float* sdo = sq + nq * ld;
  float* slse = sdo + nq * ld;
  float* sdelta = slse + nq;
  float* sbuf = sdelta + nq;  // kWarps x 2 rows of nq
  uint8_t* smask = reinterpret_cast<uint8_t*>(sbuf + 2 * kWarps * nq);  // (nq, kKeyTile)

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long bh = blockIdx.y;
  const long long b = bh / heads;
  const int s0 = blockIdx.x * kKeyTile;
  const long long qbase = bh * nq;
  for (int e = threadIdx.x; e < nq * D; e += kThreads) {
    const int r = e / D, c = e - r * D;
    sq[r * ld + c] = to_f(q[qbase * D + e]);
    sdo[r * ld + c] = to_f(dout[qbase * D + e]);
  }
  for (int r = threadIdx.x; r < nq; r += kThreads) {
    slse[r] = lse[qbase + r];
    sdelta[r] = delta[qbase + r];
  }
  for (int e = threadIdx.x; e < nq * kKeyTile; e += kThreads) {
    const int r = e / kKeyTile, c = e - r * kKeyTile;
    smask[e] = s0 + c < ns ? mask[(b * nq + r) * ns + s0 + c] : 1;
  }
  __syncthreads();

  float* pbuf = sbuf + warp * 2 * nq;
  float* dsbuf = pbuf + nq;
  for (int jt = warp; jt < kKeyTile; jt += kWarps) {
    const int j = s0 + jt;
    if (j >= ns) break;
    float kr[D], vr[D];
    const long long krow = (bh * ns + j) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      kr[d] = to_f(k[krow + d]);
      vr[d] = to_f(v[krow + d]);
    }
    for (int i = lane; i < nq; i += 32) {
      const float s = dot_reg<D>(kr, sq + i * ld) + (smask[i * kKeyTile + jt] ? kMaskedBias : 0.f);
      const float p = expf(s - slse[i]);
      pbuf[i] = p;
      dsbuf[i] = p * (dot_reg<D>(vr, sdo + i * ld) - sdelta[i]);
    }
    __syncwarp();
    for (int d = lane; d < D; d += 32) {
      float acc_k = 0.f, acc_v = 0.f;
      for (int i = 0; i < nq; ++i) {
        acc_v += pbuf[i] * sdo[i * ld + d];
        acc_k += dsbuf[i] * sq[i * ld + d];
      }
      dk[krow + d] = from_f<T>(acc_k);
      dv[krow + d] = from_f<T>(acc_v);
    }
    __syncwarp();
  }
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, const void* mask, void* o, void* lse,
               int batch_heads, int heads, int nq, int ns, cudaStream_t stream) {
  if (batch_heads > 0 && nq > 0) {
    const dim3 grid((nq + kWarps - 1) / kWarps, batch_heads);
    masked_attention_fwd_kernel<T, D><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const uint8_t*>(mask), static_cast<T*>(o), static_cast<float*>(lse), heads,
        nq, ns);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const void* lse, const void* mask, void* dq, void* dk, void* dv, void* delta,
               int batch_heads, int heads, int nq, int ns, cudaStream_t stream) {
  const size_t smem = (2 * static_cast<size_t>(nq) * (D + 1) + 2 * nq + 2 * kWarps * nq) *
                          sizeof(float) +
                      static_cast<size_t>(nq) * kKeyTile;
  if (smem > kSharedLimit) return static_cast<int>(cudaErrorInvalidValue);
  if (batch_heads <= 0 || nq <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid_q((nq + kWarps - 1) / kWarps, batch_heads);
  masked_attention_bwd_dq_kernel<T, D><<<grid_q, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const uint8_t*>(mask), static_cast<T*>(dq), static_cast<float*>(delta), heads,
      nq, ns);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  if (ns > 0) {
    auto kernel = masked_attention_bwd_dkdv_kernel<T, D>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    const dim3 grid_k((ns + kKeyTile - 1) / kKeyTile, batch_heads);
    kernel<<<grid_k, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<const uint8_t*>(mask), static_cast<T*>(dk),
        static_cast<T*>(dv), heads, nq, ns);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All pointers are device pointers to contiguous arrays: q/o/dout/dq
// (batch, heads, nq, head_dim) and k/v/dk/dv (batch, heads, ns, head_dim) in
// bf16 (bf16 != 0) or f32; mask (batch, nq, ns) bytes, nonzero = masked; lse
// and delta (batch, heads, nq) f32 (delta is scratch written by the backward).
// nq <= 512 and head_dim in {16, 32, 64}. Launch on `stream`; return
// cudaGetLastError() (or cudaErrorInvalidValue for a shape the kernels do not
// take).
extern "C" int wis_masked_attention_fwd(const void* q, const void* k, const void* v,
                                        const void* mask, void* o, void* lse, int batch,
                                        int heads, int nq, int ns, int head_dim, int bf16,
                                        void* stream) {
  if (nq > kMaxQueries || ns < 1) return static_cast<int>(cudaErrorInvalidValue);
  WIS_DISPATCH(launch_fwd, q, k, v, mask, o, lse, batch * heads, heads, nq, ns,
               static_cast<cudaStream_t>(stream))
}

extern "C" int wis_masked_attention_bwd(const void* q, const void* k, const void* v,
                                        const void* o, const void* dout, const void* lse,
                                        const void* mask, void* dq, void* dk, void* dv,
                                        void* delta, int batch, int heads, int nq, int ns,
                                        int head_dim, int bf16, void* stream) {
  if (nq > kMaxQueries || ns < 1) return static_cast<int>(cudaErrorInvalidValue);
  WIS_DISPATCH(launch_bwd, q, k, v, o, dout, lse, mask, dq, dk, dv, delta, batch * heads, heads,
               nq, ns, static_cast<cudaStream_t>(stream))
}
