// Paged GQA decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `paged_attention` of the JAX package
// (src/repro/kernels/paged_attention.py, body `_kernel`): one query token
// per sequence attends to that sequence's KV cache, which lives in a pool of
// pages of `block_size` tokens indexed by a per-sequence block table, with an
// online softmax over the pages in order; tokens at or past `length` are
// masked and the softmax denominator is floored at 1e-30.
//
// Layouts (contiguous):
//   q       (B, n_kv, qpk, hd)   pre-scaled by hd^-0.5
//   k/v     (n_pages, bs, n_kv, hd)
//   tables  (B, max_pages) int32, entries clamped to [0, n_pages)
//   lengths (B,) int32
//   out     (B, n_kv, qpk, hd)
//
// Design.  One block per (sequence, kv head) holds that kv head's qpk query
// rows and walks the block table in a loop inside the block: the loop takes
// the place of the Pallas kernel's sequential page axis, since CUDA blocks
// run in no order.  Each tile of up to `tile` tokens (several pages) is read
// once into shared memory and serves all qpk query heads, so every K and V
// byte crosses from device memory once.  The running max m, sum l and the
// f32 accumulator stay in shared memory; the output is written once.
//
// Bound.  Decode attention does ~2 FLOPs per byte it reads: it is bound by
// device memory (bytes = sum_b length_b * n_kv * hd * 2 * sizeof(T)).  The
// tile loads are 16-byte vector loads with several in flight per thread,
// since the block's time goes to waiting on memory.  It stays simple rather
// than fast: with B * n_kv blocks in flight (64 at granite's max_batch 8)
// most SMs idle; splitting the page walk across blocks, with a second pass
// merging the partial (m, l, acc), is the next step.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ tables,
    const int* __restrict__ lengths, T* __restrict__ out, int n_kv, int qpk,
    int hd, int n_pages, int bs, int max_pages, int tile) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int ks = hd + 1;  // padded K row: conflict-free column reads
  float* q_s = smem;                // qpk * hd
  float* acc = q_s + qpk * hd;      // qpk * hd
  float* k_s = acc + qpk * hd;      // tile * ks
  float* v_s = k_s + tile * ks;     // tile * hd
  float* p_s = v_s + tile * hd;     // qpk * tile
  float* m_s = p_s + qpk * tile;    // qpk
  float* l_s = m_s + qpk;           // qpk
  float* a_s = l_s + qpk;           // qpk

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int64_t q_off = ((int64_t)b * n_kv + h) * qpk * hd;
  for (int i = tid; i < qpk * hd; i += blockDim.x) {
    q_s[i] = to_f32(q[q_off + i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < qpk; g += blockDim.x) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }
  const int length = min(lengths[b], max_pages * bs);
  const int64_t row_stride = (int64_t)n_kv * hd;
  const int64_t page_stride = (int64_t)bs * row_stride;
  const int* table = tables + (int64_t)b * max_pages;
  constexpr int kVec = Vec<T>::n;
  const int row_vecs = hd / kVec;
  __syncthreads();

  for (int t0 = 0; t0 < length; t0 += tile) {
    const int nt = min(tile, length - t0);
    // K/V rows of this tile -> shared memory (f32), 16 bytes per load and
    // four loads in flight per thread; rows past nt are zero
#pragma unroll 4
    for (int i = tid; i < tile * row_vecs; i += blockDim.x) {
      const int t = i / row_vecs;
      const int d0 = (i - t * row_vecs) * kVec;
      float kv[kVec], vv[kVec];
      if (t < nt) {
        const int tok = t0 + t;
        const int page = min(max(table[tok / bs], 0), n_pages - 1);
        const int64_t off = page * page_stride + (tok % bs) * row_stride +
                            (int64_t)h * hd + d0;
        load16(k_pages + off, kv);
        load16(v_pages + off, vv);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) kv[j] = vv[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        k_s[t * ks + d0 + j] = kv[j];
        v_s[t * hd + d0 + j] = vv[j];
      }
    }
    __syncthreads();
    // scores s[g][t] = q_g . k_t  (masked past the length)
    for (int i = tid; i < qpk * tile; i += blockDim.x) {
      const int g = i / tile;
      const int t = i - g * tile;
      float s = -INFINITY;
      if (t < nt) {
        const float* qr = q_s + g * hd;
        const float* kr = k_s + t * ks;
        s = 0.f;
        for (int d = 0; d < hd; ++d) s = fmaf(qr[d], kr[d], s);
      }
      p_s[i] = s;
    }
    __syncthreads();
    // online softmax, one warp per query row; nt >= 1 keeps m finite
    for (int g = warp; g < qpk; g += n_warps) {
      float* pr = p_s + g * tile;
      float mx = -INFINITY;
      for (int t = lane; t < nt; t += 32) mx = fmaxf(mx, pr[t]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < tile; t += 32) {
        const float p = t < nt ? expf(pr[t] - m_new) : 0.f;
        pr[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);  // 0 on the first tile
        a_s[g] = alpha;
        l_s[g] = alpha * l_s[g] + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // acc[g] = alpha_g * acc[g] + sum_t p[g][t] * v_t
    for (int i = tid; i < qpk * hd; i += blockDim.x) {
      const int g = i / hd;
      const int d = i - g * hd;
      const float* pr = p_s + g * tile;
      float o = 0.f;
      for (int t = 0; t < nt; ++t) o = fmaf(pr[t], v_s[t * hd + d], o);
      acc[i] = a_s[g] * acc[i] + o;
    }
    __syncthreads();
  }

  for (int i = tid; i < qpk * hd; i += blockDim.x) {
    const int g = i / hd;
    out[q_off + i] = from_f32<T>(acc[i] / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* tables, const void* lengths, void* out, int batch,
           int n_kv, int qpk, int hd, int n_pages, int bs, int max_pages,
           cudaStream_t stream) {
  const int tile = hd <= 128 ? 64 : 32;
  const size_t smem =
      sizeof(float) * ((size_t)2 * qpk * hd + (size_t)tile * (hd + 1) +
                       (size_t)tile * hd + (size_t)qpk * tile + 3 * qpk);
  cudaError_t err = allow_smem(paged_decode_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(batch, n_kv);
  paged_decode_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<T*>(out), n_kv, qpk, hd,
      n_pages, bs, max_pages, tile);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// Returns the cudaError_t of the launch (0 on success).
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages, const void* tables,
                                      const void* lengths, void* out,
                                      int batch, int n_kv, int qpk, int hd,
                                      int n_pages, int bs, int max_pages,
                                      int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return repro_torch::launch<__nv_bfloat16>(q, k_pages, v_pages, tables,
                                              lengths, out, batch, n_kv, qpk,
                                              hd, n_pages, bs, max_pages, s);
  }
  return repro_torch::launch<float>(q, k_pages, v_pages, tables, lengths, out,
                                    batch, n_kv, qpk, hd, n_pages, bs,
                                    max_pages, s);
}
