// Chunkwise-parallel mLSTM for Hopper (sm_90a), with recurrent state in and
// out and any sequence length: the prefill of the xLSTM family.
//
// Replaces the Pallas TPU kernel `mlstm_chunk_kernel` of the JAX package
// (src/repro/kernels/mlstm_chunk.py:127, body `_kernel`).  For each
// (sequence, head) it walks the chunks of c tokens in order.  Inside a chunk,
// with F = cumsum(log f), D_tj = F_t - F_j + i_j (j <= t) and the stabiliser
// m_t = max(max_j D_tj, F_t + m0):
//
//   h_t = (e^{F_t+m0-m_t} q_t.C0 + sum_j e^{D_tj-m_t} (q_t.k_j) v_j) / den_t
//   den_t = max(|e^{F_t+m0-m_t} q_t.n0 + sum_j e^{D_tj-m_t} q_t.k_j|, e^{-m_t})
//
// and it hands (C of hd x hd, n of hd, m) on to the next chunk.  k is scaled
// by hd^-0.5 inside.  Unlike the Pallas kernel it starts from a given state
// (C0, n0, m0) and writes the final one, which the engine decodes from.
//
// Layouts: q, k, v and h are (B, H, S, hd), each given by strides in
// elements for (batch, head, sequence) with hd contiguous and rows on
// 16-byte boundaries, so (B, S, H, hd) projections pass as transposed views;
// i_raw and log_f are contiguous (B, H, S) float32; C (B,H,hd,hd), n (B,H,hd)
// and m (B,H) are contiguous float32.  h has q's type.
//
// Any S: the last chunk is padded with tokens that neither decay nor add
// (log f = 0, i = -1e30, q = k = v = 0), so its final row carries the state
// after token S - 1 exactly.  The stabiliser's start is the finite -1e30 of
// an empty state, so e^{F_t + m0 - m_t} comes out 0 and never NaN.
//
// Design.  C does not fit one block: at hd 256 it is 256 KiB of float32,
// over the 227 KB of shared memory a block may use, while the TPU kernel
// keeps it whole in VMEM.  So one block owns one (sequence, head, tile of
// C's value columns), the tile 64 columns wide (less where hd is narrower),
// and keeps its hd x 64 slice of C (64 KiB at hd 256) in shared memory for
// the whole walk; the loop over chunks inside the block replaces the Pallas
// kernel's sequential grid axis.  Each block recomputes what does not depend
// on the value columns: F, the c x c gate matrix, q.k^T, n and den; the
// block of tile 0 writes n and m.  q and k stream through shared memory in
// slabs of 64 feature columns (float32), and each slab's part of q.k^T,
// q.C0 and q.n0 is summed before that slab of C and n is advanced.
//
// Bound.  At xlstm-350m's prefill (B 1, H 4, S 512, hd 256) the work is about
// 0.67 GFLOP over 6.3 MB, so the card's bound is its memory (about 2 us).
// This first version does its products on the CUDA cores in float32 from
// shared memory and runs far from that; and one sequence of 4 heads gives
// only 4 x 4 = 16 blocks for 132 SMs, which caps it further.  wgmma tiles
// and a split of the chunk walk across blocks are the steps toward the bound.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 64;
constexpr int kTile = 64;           // C columns a block owns, at most
constexpr int kPad = kMaxChunk + 1;  // padded rows: conflict-free columns
constexpr float kNeg = -1e30f;

struct Strides {
  int64_t v[12];  // (batch, head, seq) for q, k, v, out
};

// Products run on an 8 x 2 register tile per thread: rows tr + 8a of the
// chunk (or of a slab of C) and columns tc + 32b, with tr the warp and tc
// the lane, so a warp reads one broadcast row operand and 32 consecutive
// column operands.
template <typename T>
__global__ void __launch_bounds__(kThreads) mlstm_chunk_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ ig, const float* __restrict__ lf,
    const float* __restrict__ c_in, const float* __restrict__ n_in,
    const float* __restrict__ m_in, T* __restrict__ out,
    float* __restrict__ c_out, float* __restrict__ n_out,
    float* __restrict__ m_out, int heads, int seq, int hd, int chunk, int tv,
    float scale, Strides st) {
  extern __shared__ float smem[];
  float* c_s = smem;                     // hd x kTile: this block's C slice
  float* q_s = c_s + hd * kTile;         // kMaxChunk x kPad: q slab
  float* k_s = q_s + kMaxChunk * kPad;   // kMaxChunk x kPad: scaled k slab
  float* v_s = k_s + kMaxChunk * kPad;   // kMaxChunk x kTile: v columns
  float* w_s = v_s + kMaxChunk * kTile;  // kMaxChunk x kPad: gate weights
  float* n_s = w_s + kMaxChunk * kPad;   // hd: normaliser
  float* i_s = n_s + hd;                 // kMaxChunk each below
  float* l_s = i_s + kMaxChunk;
  float* f_s = l_s + kMaxChunk;
  float* mt_s = f_s + kMaxChunk;
  float* in_s = mt_s + kMaxChunk;
  float* wj_s = in_s + kMaxChunk;
  float* qn_s = wj_s + kMaxChunk;
  float* den_s = qn_s + kMaxChunk;
  const int n_smem = hd * kTile + 3 * kMaxChunk * kPad + kMaxChunk * kTile +
                     hd + 8 * kMaxChunk;

  const int tile = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tr = tid >> 5;
  const int tc = tid & 31;
  const int col0 = tile * tv;
  const int64_t bh = (int64_t)b * heads + h;
  const T* q_b = q + b * st.v[0] + h * st.v[1];
  const T* k_b = k + b * st.v[3] + h * st.v[4];
  const T* v_b = v + b * st.v[6] + h * st.v[7];
  T* o_b = out + b * st.v[9] + h * st.v[10];
  const float* ig_b = ig + bh * seq;
  const float* lf_b = lf + bh * seq;

  // rows past the chunk, columns past the tile: zero for good, so every
  // product below may run over the full 64 x 64 tile
  for (int i = tid; i < n_smem; i += kThreads) smem[i] = 0.f;
  __syncthreads();
  for (int i = tid; i < hd * tv; i += kThreads) {
    const int d = i / tv;
    const int c = i - d * tv;
    c_s[d * kTile + c] = c_in ? c_in[(bh * hd + d) * hd + col0 + c] : 0.f;
  }
  for (int d = tid; d < hd; d += kThreads) {
    n_s[d] = n_in ? n_in[bh * hd + d] : 0.f;
  }
  float m0 = m_in ? m_in[bh] : kNeg;

  constexpr int kVec = Vec<T>::n;
  const int ds = tv;  // slab width: hd is a multiple of it
  const int slab_vecs = ds / kVec;
  const int tile_vecs = tv / kVec;

  for (int t0 = 0; t0 < seq; t0 += chunk) {
    const int nt = min(chunk, seq - t0);
    if (tid < chunk) {
      i_s[tid] = tid < nt ? ig_b[t0 + tid] : kNeg;
      l_s[tid] = tid < nt ? lf_b[t0 + tid] : 0.f;
    }
    __syncthreads();
    if (tid < chunk) {  // F_t, summed in token order
      float acc = 0.f;
      for (int j = 0; j <= tid; ++j) acc += l_s[j];
      f_s[tid] = acc;
    }
    __syncthreads();
    if (tid < chunk) {
      const float ft = f_s[tid];
      float mi = -INFINITY;
      for (int j = 0; j <= tid; ++j) mi = fmaxf(mi, ft - f_s[j] + i_s[j]);
      const float m_inter = ft + m0;
      const float mt = fmaxf(mi, m_inter);
      mt_s[tid] = mt;
      in_s[tid] = expf(m_inter - mt);
    }
    __syncthreads();
    const int last = chunk - 1;  // padding rows repeat row nt - 1
    const float m_new = mt_s[last];
    const float f_last = f_s[last];
    const float decay = expf(f_last + m0 - m_new);
    if (tid < chunk) {
      wj_s[tid] = expf(f_last - f_s[tid] + i_s[tid] - m_new);
      qn_s[tid] = 0.f;
    }
    for (int i = tid; i < chunk * chunk; i += kThreads) {
      const int t = i / chunk;
      const int j = i - t * chunk;
      w_s[t * kPad + j] =
          j <= t ? expf(f_s[t] - f_s[j] + i_s[j] - mt_s[t]) : 0.f;
    }
    for (int i = tid; i < chunk * tile_vecs; i += kThreads) {
      const int j = i / tile_vecs;
      const int c = (i - j * tile_vecs) * kVec;
      float vv[kVec];
      if (j < nt) {
        load16(v_b + (t0 + j) * st.v[8] + col0 + c, vv);
      } else {
#pragma unroll
        for (int x = 0; x < kVec; ++x) vv[x] = 0.f;
      }
#pragma unroll
      for (int x = 0; x < kVec; ++x) v_s[j * kTile + c + x] = vv[x];
    }

    float s_acc[8][2], h_acc[8][2];
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      s_acc[a][0] = s_acc[a][1] = 0.f;
      h_acc[a][0] = h_acc[a][1] = 0.f;
    }
    for (int d0 = 0; d0 < hd; d0 += ds) {
      for (int i = tid; i < chunk * slab_vecs; i += kThreads) {
        const int r = i / slab_vecs;
        const int c = (i - r * slab_vecs) * kVec;
        float qv[kVec], kv[kVec];
        if (r < nt) {
          load16(q_b + (t0 + r) * st.v[2] + d0 + c, qv);
          load16(k_b + (t0 + r) * st.v[5] + d0 + c, kv);
        } else {
#pragma unroll
          for (int x = 0; x < kVec; ++x) qv[x] = kv[x] = 0.f;
        }
#pragma unroll
        for (int x = 0; x < kVec; ++x) {
          q_s[r * kPad + c + x] = qv[x];
          k_s[r * kPad + c + x] = kv[x] * scale;
        }
      }
      __syncthreads();
      // this slab's share of q.k^T and q.C0, then of q.n0
      for (int dd = 0; dd < ds; ++dd) {
        float qa[8], kb[2], cb[2];
#pragma unroll
        for (int a = 0; a < 8; ++a) qa[a] = q_s[(tr + 8 * a) * kPad + dd];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          kb[x] = k_s[(tc + 32 * x) * kPad + dd];
          cb[x] = c_s[(d0 + dd) * kTile + tc + 32 * x];
        }
#pragma unroll
        for (int a = 0; a < 8; ++a) {
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            s_acc[a][x] = fmaf(qa[a], kb[x], s_acc[a][x]);
            h_acc[a][x] = fmaf(qa[a], cb[x], h_acc[a][x]);
          }
        }
      }
      if (tid < kMaxChunk) {
        float acc = 0.f;
        for (int dd = 0; dd < ds; ++dd) {
          acc = fmaf(q_s[tid * kPad + dd], n_s[d0 + dd], acc);
        }
        qn_s[tid] += acc;
      }
      __syncthreads();
      // advance this slab of C and n: decay * old + sum_j wj k_j v_j
      float c_acc[8][2];
#pragma unroll
      for (int a = 0; a < 8; ++a) c_acc[a][0] = c_acc[a][1] = 0.f;
      for (int j = 0; j < chunk; ++j) {
        const float wj = wj_s[j];
        float ka[8], vb[2];
#pragma unroll
        for (int a = 0; a < 8; ++a) ka[a] = k_s[j * kPad + tr + 8 * a] * wj;
#pragma unroll
        for (int x = 0; x < 2; ++x) vb[x] = v_s[j * kTile + tc + 32 * x];
#pragma unroll
        for (int a = 0; a < 8; ++a) {
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            c_acc[a][x] = fmaf(ka[a], vb[x], c_acc[a][x]);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        if (8 * a < ds) {
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            float* c = c_s + (d0 + tr + 8 * a) * kTile + tc + 32 * x;
            *c = decay * *c + c_acc[a][x];
          }
        }
      }
      if (tid < ds) {
        float acc = 0.f;
        for (int j = 0; j < chunk; ++j) {
          acc = fmaf(k_s[j * kPad + tid], wj_s[j], acc);
        }
        n_s[d0 + tid] = decay * n_s[d0 + tid] + acc;
      }
      __syncthreads();
    }

    // (q.k^T) * w in place of w, then den, then h
#pragma unroll
    for (int a = 0; a < 8; ++a) {
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        float* w = w_s + (tr + 8 * a) * kPad + tc + 32 * x;
        *w = s_acc[a][x] * *w;
      }
    }
    __syncthreads();
    if (tid < chunk) {
      float sum = 0.f;
      for (int j = 0; j < chunk; ++j) sum += w_s[tid * kPad + j];
      sum += in_s[tid] * qn_s[tid];
      den_s[tid] = fmaxf(fabsf(sum), expf(-mt_s[tid]));
    }
    __syncthreads();
    float o_acc[8][2];
#pragma unroll
    for (int a = 0; a < 8; ++a) o_acc[a][0] = o_acc[a][1] = 0.f;
    for (int j = 0; j < chunk; ++j) {
      float sw[8], vb[2];
#pragma unroll
      for (int a = 0; a < 8; ++a) sw[a] = w_s[(tr + 8 * a) * kPad + j];
#pragma unroll
      for (int x = 0; x < 2; ++x) vb[x] = v_s[j * kTile + tc + 32 * x];
#pragma unroll
      for (int a = 0; a < 8; ++a) {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          o_acc[a][x] = fmaf(sw[a], vb[x], o_acc[a][x]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int t = tr + 8 * a;
      if (t < nt) {
        const float inter = in_s[t];
        const float den = den_s[t];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int c = tc + 32 * x;
          if (c < tv) {
            o_b[(t0 + t) * st.v[11] + col0 + c] =
                from_f32<T>((o_acc[a][x] + inter * h_acc[a][x]) / den);
          }
        }
      }
    }
    m0 = m_new;
  }

  __syncthreads();
  for (int i = tid; i < hd * tv; i += kThreads) {
    const int d = i / tv;
    const int c = i - d * tv;
    c_out[(bh * hd + d) * hd + col0 + c] = c_s[d * kTile + c];
  }
  if (tile == 0) {
    for (int d = tid; d < hd; d += kThreads) n_out[bh * hd + d] = n_s[d];
    if (tid == 0) m_out[bh] = m0;
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* ig,
           const float* lf, const float* c_in, const float* n_in,
           const float* m_in, void* out, float* c_out, float* n_out,
           float* m_out, int batch, int heads, int seq, int hd, int chunk,
           const int64_t* strides, cudaStream_t stream) {
  const int tv = hd % 64 == 0 ? 64 : hd % 32 == 0 ? 32 : 16;
  const size_t smem =
      sizeof(float) * ((size_t)hd * kTile + 3 * kMaxChunk * kPad +
                       kMaxChunk * kTile + hd + 8 * kMaxChunk);
  cudaError_t err = allow_smem(mlstm_chunk_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  Strides st;
  for (int i = 0; i < 12; ++i) st.v[i] = strides[i];
  dim3 grid(hd / tv, heads, batch);
  mlstm_chunk_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), ig, lf, c_in, n_in, m_in,
      static_cast<T*>(out), c_out, n_out, m_out, heads, seq, hd, chunk, tv,
      (float)(1.0 / sqrt((double)hd)), st);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// strides: 12 int64 in elements, (batch, head, seq) for q, k, v, out.
// c_in/n_in/m_in may all be null for the empty state.  chunk is 1..64.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int mlstm_chunk_launch(const void* q, const void* k,
                                  const void* v, const float* i_raw,
                                  const float* log_f, const float* c_in,
                                  const float* n_in, const float* m_in,
                                  void* out, float* c_out, float* n_out,
                                  float* m_out, int batch, int heads, int seq,
                                  int hd, int chunk, const int64_t* strides,
                                  int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return repro_torch::launch<__nv_bfloat16>(
        q, k, v, i_raw, log_f, c_in, n_in, m_in, out, c_out, n_out, m_out,
        batch, heads, seq, hd, chunk, strides, s);
  }
  return repro_torch::launch<float>(q, k, v, i_raw, log_f, c_in, n_in, m_in,
                                    out, c_out, n_out, m_out, batch, heads,
                                    seq, hd, chunk, strides, s);
}
