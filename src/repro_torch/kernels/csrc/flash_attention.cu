// Causal (optionally sliding-window) GQA flash attention for Hopper
// (sm_90a), the prefill path.
//
// Replaces the Pallas TPU kernel `flash_attention` of the JAX package
// (src/repro/kernels/flash_attention.py, body `_kernel`): q tiles stay
// resident while K/V tiles stream past with an online softmax; tiles wholly
// above the diagonal or left of the window are skipped; rows whose every key
// in a tile is masked keep m = -inf and are guarded (no exp of -inf - -inf).
//
// Layouts: q and out are (B, nh, S, hd) and k/v are (B, n_kv, S, hd), each
// given by strides in elements for (batch, head, sequence) with hd
// contiguous and every row on a 16-byte boundary (tiles load 16 bytes at
// a time), so the caller passes (B, S, n, hd) tensors transposed as views
// without a copy.  The kv head of q head h is h / qpk.  q is
// pre-scaled by hd^-0.5.
//
// Design.  One block per (q tile, q head, batch row).  It keeps its q tile
// and an f32 accumulator in shared memory and loops over the kv tiles from
// the window's first tile up to the diagonal, loading each K and V tile once
// into shared memory.  The loop replaces the Pallas kernel's sequential kv
// grid axis.  The kernel's own tile is 64 x 64 (32 x 32 above hd 128, to
// stay inside 227 KB of shared memory) and the ragged edge is masked, so any
// S works; the wrapper keeps the Pallas contract that S divides the caller's
// block sizes.
//
// Bound.  Causal attention does about 2 * 2 * B * nh * S^2 / 2 * hd FLOPs
// over 2-byte inputs: at prefill lengths it is bound by the tensor cores.
// This first version does its products on the CUDA cores in f32 from shared
// memory (padded K rows keep the column reads free of bank conflicts), so it
// runs far below the bf16 tensor-core peak; wgmma tiles fed by TMA are the
// step that moves it toward the bound.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_prefill_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int seq, int qpk, int hd, int window, int bq, int bk,
    int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh,
    int64_t k_ss, int64_t o_sb, int64_t o_sh, int64_t o_ss) {
  extern __shared__ float smem[];
  const int iq = blockIdx.x;
  const int hq = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = hq / qpk;
  const int ks = hd + 1;  // padded K row: conflict-free column reads
  float* q_s = smem;             // bq * hd
  float* acc = q_s + bq * hd;    // bq * hd
  float* k_s = acc + bq * hd;    // bk * ks
  float* v_s = k_s + bk * ks;    // bk * hd
  float* p_s = v_s + bk * hd;    // bq * bk
  float* m_s = p_s + bq * bk;    // bq
  float* l_s = m_s + bq;         // bq
  float* a_s = l_s + bq;         // bq

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int q_start = iq * bq;
  const int nq = min(bq, seq - q_start);
  const T* q_base = q + b * q_sb + hq * q_sh;
  const T* k_base = k + b * k_sb + hk * k_sh;
  const T* v_base = v + b * k_sb + hk * k_sh;

  constexpr int kVec = Vec<T>::n;
  const int row_vecs = hd / kVec;
  for (int i = tid; i < bq * row_vecs; i += blockDim.x) {
    const int r = i / row_vecs;
    const int d0 = (i - r * row_vecs) * kVec;
    float qv[kVec];
    if (r < nq) {
      load16(q_base + (q_start + r) * q_ss + d0, qv);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) qv[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      q_s[r * hd + d0 + j] = qv[j];
      acc[r * hd + d0 + j] = 0.f;
    }
  }
  for (int r = tid; r < bq; r += blockDim.x) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }
  __syncthreads();

  // kv tiles that can contribute: from the window's first tile (every
  // earlier key lies left of every row's window) up to the diagonal
  const int k_end = q_start + nq;
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_start - window + 1) / bk * bk;

  for (int k0 = k_begin; k0 < k_end; k0 += bk) {
    const int nk = min(bk, seq - k0);
#pragma unroll 4
    for (int i = tid; i < bk * row_vecs; i += blockDim.x) {
      const int c = i / row_vecs;
      const int d0 = (i - c * row_vecs) * kVec;
      float kv[kVec], vv[kVec];
      if (c < nk) {
        load16(k_base + (k0 + c) * k_ss + d0, kv);
        load16(v_base + (k0 + c) * k_ss + d0, vv);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) kv[j] = vv[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        k_s[c * ks + d0 + j] = kv[j];
        v_s[c * hd + d0 + j] = vv[j];
      }
    }
    __syncthreads();
    for (int i = tid; i < bq * bk; i += blockDim.x) {
      const int r = i / bk;
      const int c = i - r * bk;
      const int qi = q_start + r;
      const int kj = k0 + c;
      const bool ok = r < nq && c < nk && kj <= qi &&
                      (window == 0 || kj > qi - window);
      float s = -INFINITY;
      if (ok) {
        const float* qr = q_s + r * hd;
        const float* kr = k_s + c * ks;
        s = 0.f;
        for (int d = 0; d < hd; ++d) s = fmaf(qr[d], kr[d], s);
      }
      p_s[i] = s;
    }
    __syncthreads();
    // online softmax, one warp per row, guarded for fully masked rows
    for (int r = warp; r < bq; r += n_warps) {
      float* pr = p_s + r * bk;
      float mx = -INFINITY;
      for (int c = lane; c < bk; c += 32) mx = fmaxf(mx, pr[c]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float safe = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
      for (int c = lane; c < bk; c += 32) {
        const float s = pr[c];
        const float p = s == -INFINITY ? 0.f : expf(s - safe);
        pr[c] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = m_prev == -INFINITY ? 0.f : expf(m_prev - safe);
        a_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < bq * hd; i += blockDim.x) {
      const int r = i / hd;
      const int d = i - r * hd;
      const float* pr = p_s + r * bk;
      float o = 0.f;
      for (int c = 0; c < nk; ++c) o = fmaf(pr[c], v_s[c * hd + d], o);
      acc[i] = a_s[r] * acc[i] + o;
    }
    __syncthreads();
  }

  T* o_base = out + b * o_sb + hq * o_sh;
  for (int i = tid; i < nq * hd; i += blockDim.x) {
    const int r = i / hd;
    const int d = i - r * hd;
    o_base[(q_start + r) * o_ss + d] =
        from_f32<T>(acc[i] / fmaxf(l_s[r], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int nh, int seq, int qpk, int hd, int window, const int64_t* st,
           cudaStream_t stream) {
  const int tile = hd <= 128 ? 64 : 32;
  const size_t smem =
      sizeof(float) * ((size_t)2 * tile * hd + (size_t)tile * (hd + 1) +
                       (size_t)tile * hd + (size_t)tile * tile + 3 * tile);
  cudaError_t err = allow_smem(flash_prefill_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((seq + tile - 1) / tile, nh, batch);
  flash_prefill_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), seq, qpk, hd, window,
      tile, tile, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8]);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// strides: 9 int64 in elements, (batch, head, seq) for q, k/v, out.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int batch,
                                      int nh, int seq, int qpk, int hd,
                                      int window, const int64_t* strides,
                                      int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return repro_torch::launch<__nv_bfloat16>(q, k, v, out, batch, nh, seq,
                                              qpk, hd, window, strides, s);
  }
  return repro_torch::launch<float>(q, k, v, out, batch, nh, seq, qpk, hd,
                                    window, strides, s);
}
