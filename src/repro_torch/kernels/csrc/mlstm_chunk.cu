// Chunkwise-parallel mLSTM for Hopper (sm_90a), with recurrent state in and
// out and any sequence length: the prefill of the xLSTM family.
//
// Replaces the Pallas TPU kernel `mlstm_chunk_kernel` of the JAX package
// (src/repro/kernels/mlstm_chunk.py:127, body `_kernel`).  For each
// (sequence, head), over chunks of c tokens, with F = cumsum(log f) inside
// the chunk, D_tj = F_t - F_j + i_j (j <= t) and the stabiliser
// m_t = max(max_j D_tj, F_t + m0):
//
//   h_t = (e^{F_t+m0-m_t} q_t.C0 + sum_j e^{D_tj-m_t} (q_t.k_j) v_j) / den_t
//   den_t = max(|e^{F_t+m0-m_t} q_t.n0 + sum_j e^{D_tj-m_t} q_t.k_j|, e^{-m_t})
//
// and the chunk hands on (C of hd x hd, n of hd, m):
//
//   m' = max(max_j (F_last - F_j + i_j), F_last + m0)
//   C' = e^{F_last+m0-m'} C0 + sum_j e^{F_last-F_j+i_j-m'} k_j v_j^T
//   n' = e^{F_last+m0-m'} n0 + sum_j e^{F_last-F_j+i_j-m'} k_j
//
// k is scaled by hd^-0.5 inside.  Unlike the Pallas kernel it starts from a
// given state (C0, n0, m0) and writes the final one, which the engine
// decodes from.
//
// Layouts: q, k, v and h are (B, H, S, hd), each given by strides in
// elements for (batch, head, sequence) with hd contiguous and rows on
// 16-byte boundaries, so (B, S, H, hd) projections pass as transposed views;
// i_raw and log_f are (B, H, S) float32, also given by strides (the model
// passes views of its (B, S, H) gates, read in place); C (B,H,hd,hd),
// n (B,H,hd) and m (B,H) are contiguous float32.  h has q's type.
//
// Any S: the last chunk is padded with tokens that neither decay nor add
// (log f = 0, i = -1e30, q = k = v = 0), so its final row carries the state
// after token S - 1 exactly.  The stabiliser's start is the finite -1e30 of
// an empty state, so e^{F_t + m0 - m_t} comes out 0 and never NaN.
//
// Bound.  At xlstm-350m's prefill (B 1, H 4, S 512, hd 256, bf16 q/k/v, f32
// gates, empty state in) the function reads q, k, v and the gates once and
// writes h and the final state once: 5.26 MB, 0.0016 ms at 3.35 TB/s.  Its
// products (the causal q.k^T and (q.k^T * w).v of each chunk, q.C0 and the
// C update per token) are about 0.6 GFLOP, 0.0006 ms at the bf16
// tensor-core peak.  So the bound is bytes, 0.0016 ms (`time_mlstm` in
// chip_smoke.py counts both).
//
// Two instantiations, chosen by the launcher's rule (`mlstm_path` in
// kernels/mlstm_chunk.py):
//
// * tensor_core: bf16 with hd a multiple of 64 and c = 64, in two launches.
//   The m sequence depends on the gates alone, and given a chunk's starting
//   (C, n, m) the chunk's outputs depend on no other chunk; so the
//   recurrence runs apart from the outputs.
//   - States pass: one block per (sequence and head, 64-row tile of C,
//     64-column tile of C): 64 blocks at xlstm-350m's prefill, where the
//     cuda_core kernel has 16.  Three roles.  A producer warp streams each
//     chunk's k rows and v columns of the tile by TMA into a ring of 6
//     stages and computes the chunks' gate weights, 6 chunks at a time (F
//     by warp scans, the maxima by warp reductions, then the short m chain;
//     it writes m for the outputs pass).  A preparer warpgroup scales v's
//     rows by the weights in place and carries this block's share of n's
//     rows (a quarter of the tile's rows at hd 256), a chunk ahead.  The
//     consumer warpgroup keeps the C tile in f32 wgmma accumulators for the
//     whole walk: per chunk it scales them by the decay and issues wgmma
//     m64n64k16 for k^T (w v), both operands read MN-major from shared
//     memory (transpose bits set), and while they run hands C_{k-1} on to
//     the outputs pass through staging tiles and TMA stores.
//     The final state leaves from the f32 accumulators.
//   - Outputs pass: one block of one warpgroup per (sequence and head,
//     chunk, 64-column tile of h): 128 blocks at xlstm-350m's prefill, one
//     wave.  TMA brings the chunk's q and k rows, the columns of C_{k-1}
//     from the scratch and v's columns.  q.k^T and q.C_{k-1} run as wgmma
//     chains, C read MN-major.  Meanwhile each thread computes the gate
//     weights W and m_t of its accumulator fragment (a row's 64 columns live
//     in one quad, so max and sums reduce over two shuffles) and q.n_{k-1}.
//     (q.k^T * W) stays in registers as the A operand of (q.k^T * W).v,
//     added onto inter * q.C_{k-1}.  h leaves through shared memory by a
//     TMA store.
//   - Numbers.  Three operands are computed in f32 and must reach the
//     tensor cores in bf16: w v (states pass), C_{k-1} and q.k^T * W
//     (outputs pass).  Rounded once to bf16, they left h within 3e-2 of
//     mlstm_chunk_ref only while |h| < 4: an output of 4.6 at S 1100 from a
//     given state came out one bf16 step (0.03125) off (an H100,
//     chip_smoke.py phase 3).  TF32 takes no MN-major B.  So each is split
//     into a bf16 hi part and a bf16 lo part (the remainder), and each of
//     those products runs as two wgmma, one per part: the sum is exact to
//     about 2^-16, h is within 7.8e-3 (its own bf16 rounding) and the final
//     C within 1e-6 of the plain version.
//   Against the bound: the states pass reads each k and v byte once per
//   row or column tile (from L2 after the first block) and writes the
//   chunks' starting states to a scratch that the wrapper allocates: C as
//   two bf16 parts, 4 hd^2 bytes per (sequence, head, chunk), plus n and m
//   in f32.  That is 8.4 MB at xlstm-350m's prefill (1 x 4 heads x 8 chunks
//   at S 512) and grows with S by 1 MiB per chunk of 64 tokens (16 KiB a
//   token); the outputs pass reads it back from the 50 MB L2 up to about
//   S 3000, and from device memory beyond.  So the
//   design moves more bytes than the function needs; what it buys is
//   64 + 128 blocks in place of 16, products on the tensor cores, and a
//   sequential part of one eight-wgmma chain and a tile store a chunk.
//   At this size the two launches, the walk's dependent steps and the
//   outputs pass's wgmma chains at N = 64 (doubled by the lo parts) set the
//   time, not the bytes (PERF.md).
// * cuda_core: every other input (float32, where TF32 would break the 2e-5
//   parity of the float32 engines, and bf16 at any other hd or chunk).  C
//   does not fit one block (256 KiB of float32 at hd 256), so one block owns
//   one (sequence, head, tile of C's value columns), the tile 64 columns
//   wide (less where hd is narrower), and keeps its hd x 64 slice of C in
//   shared memory for the whole walk; the loop over chunks inside the block
//   replaces the Pallas kernel's sequential grid axis.  Each block
//   recomputes what does not depend on the value columns: F, the c x c gate
//   matrix, q.k^T, n and den; the block of tile 0 writes n and m.  q and k
//   stream through shared memory in slabs of 64 feature columns (float32),
//   and each slab's part of q.k^T, q.C0 and q.n0 is summed before that slab
//   of C and n is advanced.  Its products run on the CUDA cores in float32.

#include <cuda.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

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

struct GateStrides {
  int64_t v[6];  // (batch, head, seq) for i_raw, log_f
};

// one (sequence, head)'s gates and their strides along the sequence
struct Gates {
  const float* i;
  const float* f;
  int64_t si, sf;
};

__device__ __forceinline__ Gates gates_at(const float* ig, const float* lf,
                                          const GateStrides& g, int b, int h) {
  return {ig + b * g.v[0] + h * g.v[1], lf + b * g.v[3] + h * g.v[4], g.v[2],
          g.v[5]};
}

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
    float scale, Strides st, GateStrides gs) {
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
  const Gates g = gates_at(ig, lf, gs, b, h);

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
      i_s[tid] = tid < nt ? g.i[(t0 + tid) * g.si] : kNeg;
      l_s[tid] = tid < nt ? g.f[(t0 + tid) * g.sf] : 0.f;
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
  GateStrides gs;
  for (int i = 0; i < 6; ++i) gs.v[i] = strides[12 + i];
  dim3 grid(hd / tv, heads, batch);
  mlstm_chunk_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), ig, lf, c_in, n_in, m_in,
      static_cast<T*>(out), c_out, n_out, m_out, heads, seq, hd, chunk, tv,
      (float)(1.0 / sqrt((double)hd)), st, gs);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// tensor_core: a states pass and an outputs pass, wgmma products, TMA copies
// ---------------------------------------------------------------------------

namespace tc {

using namespace hopper;

constexpr int kC = 64;  // tokens a chunk; rows and columns of a tile
// a 64 x 64 bf16 tile, rows of 128 swizzled bytes
constexpr int kTileBytes = kC * 128;
constexpr int kStages = 6;            // the states pass's K/V ring
constexpr int kStatesThreads = 288;   // consumer and preparer warpgroups,
                                      // a producer warp
constexpr int kOutputsThreads = 128;  // one warpgroup
constexpr float kNeg = -1e30f;

// what the producer hands the consumers with each chunk of the walk
struct ChunkGates {
  float w[kC];   // hd^-0.5 e^{F_last - F_j + i_j - m_new}
  float decay;   // e^{F_last + m_prev - m_new}
  float pad[3];
};

constexpr size_t states_smem() {
  // 1 KB of slack to align the swizzled tiles, kStages (k, v, v_lo) tile
  // triples, two chunks' staging tiles of C (hi and lo), each stage's
  // gates, and per stage a loaded, a ready and a free mbarrier
  return 1024 + (size_t)kStages * (3 * kTileBytes + sizeof(ChunkGates)) +
         4 * kTileBytes + 24 * kStages;
}

size_t outputs_smem(int hd) {
  // 1 KB of slack, hd / 64 column blocks of q, k and C_{k-1}'s hi and lo
  // parts, one v tile; F and i of the chunk, n_{k-1}, m_{k-1} (padded to 4
  // floats) and two mbarriers
  return 1024 + (size_t)(4 * (hd / 64) + 1) * kTileBytes +
         4 * (2 * kC + hd + 4) + 16;
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// one warp's share of a chunk's gates: lane l holds tokens t and t + 1
// (t = chunk start + 2l), padded past S with tokens that neither decay
// nor add
__device__ __forceinline__ void load_gates(const Gates& g, int t, int seq,
                                           float (&i)[2], float (&l)[2]) {
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    i[x] = t + x < seq ? __ldg(g.i + (t + x) * g.si) : kNeg;
    l[x] = t + x < seq ? __ldg(g.f + (t + x) * g.sf) : 0.f;
  }
}

// the warp's lanes prefetch into L2 the n elements from p on, a 128-byte
// line each
__device__ __forceinline__ void prefetch_l2(const float* p, int64_t n,
                                            int lane) {
  for (int64_t e = lane * 32; e < n; e += 32 * 32) {
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p + e));
  }
}

// F = cumsum(log f) over each of N chunks: a warp scan of the lanes'
// pairs, the N scans interleaved
template <int N>
__device__ __forceinline__ void chunk_cumsum(const float (&l)[N][2],
                                             float (&f)[N][2]) {
  const int lane = threadIdx.x & 31;
  float x[N];
#pragma unroll
  for (int u = 0; u < N; ++u) x[u] = l[u][0] + l[u][1];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const float y = __shfl_up_sync(0xffffffffu, x[u], o);
      if (lane >= o) x[u] += y;
    }
  }
#pragma unroll
  for (int u = 0; u < N; ++u) {
    float before = __shfl_up_sync(0xffffffffu, x[u], 1);
    if (lane == 0) before = 0.f;
    f[u][0] = before + l[u][0];
    f[u][1] = f[u][0] + l[u][1];
  }
}

// x as hi + lo, two bf16 whose sum holds x to about 2^-16 of its size:
// a product of bf16 tensor-core operands taken as two wgmma, one on each
// part, is as accurate as one on f32 data to that level
__device__ __forceinline__ void split_bf16(float x, float y,
                                           __nv_bfloat162& hi,
                                           __nv_bfloat162& lo) {
  hi = __floats2bfloat162_rn(x, y);
  const float2 h = __bfloat1622float2(hi);
  lo = __floats2bfloat162_rn(x - h.x, y - h.y);
}

// e^x by the special-function unit (ex2.approx, relative error about
// 2^-22, far inside the bf16 output's rounding); e^-inf is 0
__device__ __forceinline__ float exp_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// the accumulator fragment of m64n64: warp w of the warpgroup owns rows
// 16w .. 16w + 15; a thread holds rows r0 (registers c with c & 2 == 0) and
// r0 + 8, columns 8 (c / 4) + t2 + (c & 1)
__device__ __forceinline__ int frag_col(int c, int t2) {
  return 8 * (c >> 2) + t2 + (c & 1);
}

// Grid (hd / 64 column tiles, hd / 64 row tiles, B * H).  Threads 0..127
// are the consumer warpgroup (C), 128..255 the preparer warpgroup (v's
// scaling and n), 256..287 the producer warp (TMA and the gates).
__global__ void __launch_bounds__(kStatesThreads, 1) mlstm_chunk_states_kernel(
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_c, const float* __restrict__ ig,
    const float* __restrict__ lf, GateStrides gs,
    const float* __restrict__ c_in,
    const float* __restrict__ n_in, const float* __restrict__ m_in,
    float* __restrict__ n_chunks, float* __restrict__ m_chunks,
    float* __restrict__ c_out, float* __restrict__ n_out,
    float* __restrict__ m_out, int heads, int seq, int hd, float scale) {
  extern __shared__ uint8_t smem_raw[];
  // stage s: the k tile, the v tile (w v's hi part once scaled), w v's lo
  // part; then two chunks' staging tiles of C, hi and lo
  uint8_t* tiles = align1024(smem_raw);
  uint8_t* staged = tiles + kStages * 3 * kTileBytes;
  ChunkGates* gates = reinterpret_cast<ChunkGates*>(staged + 4 * kTileBytes);
  uint64_t* loaded = reinterpret_cast<uint64_t*>(gates + kStages);
  uint64_t* ready = loaded + kStages;
  uint64_t* free_ = ready + kStages;

  const int col_tile = blockIdx.x;
  const int row_tile = blockIdx.y;
  const int bh = blockIdx.z;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int row0 = row_tile * kC;
  const int col0 = col_tile * kC;
  const int nc = (seq + kC - 1) / kC;
  const int tid = threadIdx.x;
  const int lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&loaded[s], 1 + 32);  // the TMA's bytes, the gates' lanes
      mbar_init(&ready[s], 128);      // every preparer thread
      mbar_init(&free_[s], 256);      // every consumer and preparer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // the producer warp: the sequence's gates into L2 at once, the first
    // kStages chunks' K/V tiles by TMA, then per chunk the gate weights,
    // m for the outputs pass, and the refill of the stage the other two
    // warpgroups have just released
    const Gates seq_gates = gates_at(ig, lf, gs, b, h);
    const bool owns_m = col_tile == 0 && row_tile == 0 && lane == 0;
    prefetch_l2(seq_gates.i, (int64_t)(seq - 1) * seq_gates.si + 1, lane);
    prefetch_l2(seq_gates.f, (int64_t)(seq - 1) * seq_gates.sf + 1, lane);
    auto load_tiles = [&](int k) {
      uint8_t* dst = tiles + (k % kStages) * 3 * kTileBytes;
      uint64_t* bar = &loaded[k % kStages];
      mbar_expect_tx(bar, 2 * kTileBytes);
      tma_load(dst, &tm_k, bar, row0, h, k * kC, b);
      tma_load(dst + kTileBytes, &tm_v, bar, col0, h, k * kC, b);
    };
    if (lane == 0) {
      for (int k = 0; k < min(nc, kStages); ++k) load_tiles(k);
    }
    float m_prev = m_in ? m_in[bh] : kNeg;
    // kStages chunks at a time: all their gates in flight at once, and
    // everything but the m chain free to overlap across them
    for (int k0 = 0; k0 < nc; k0 += kStages) {
      float gi[kStages][2], gl[kStages][2];
#pragma unroll
      for (int u = 0; u < kStages; ++u) {
        load_gates(seq_gates, (k0 + u) * kC + 2 * lane, seq, gi[u], gl[u]);
      }
      // F_last and max_j (F_last - F_j + i_j) do not depend on m: all
      // kStages chunks' scans and maxima at once
      float f[kStages][2], f_last[kStages], u_max[kStages];
      chunk_cumsum(gl, f);
#pragma unroll
      for (int u = 0; u < kStages; ++u) {
        f_last[u] = __shfl_sync(0xffffffffu, f[u][1], 31);
        gi[u][0] = f_last[u] - f[u][0] + gi[u][0];
        gi[u][1] = f_last[u] - f[u][1] + gi[u][1];
        u_max[u] = fmaxf(gi[u][0], gi[u][1]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int u = 0; u < kStages; ++u) {
          u_max[u] =
              fmaxf(u_max[u], __shfl_xor_sync(0xffffffffu, u_max[u], o));
        }
      }
#pragma unroll
      for (int u = 0; u < kStages; ++u) {
        const int k = k0 + u;
        if (k >= nc) break;
        const float m_new = fmaxf(u_max[u], f_last[u] + m_prev);
        ChunkGates& g = gates[u];
        g.w[2 * lane] = expf(gi[u][0] - m_new) * scale;
        g.w[2 * lane + 1] = expf(gi[u][1] - m_new) * scale;
        if (lane == 0) g.decay = expf(f_last[u] + m_prev - m_new);
        if (owns_m) m_chunks[(int64_t)bh * nc + k] = m_prev;
        mbar_arrive(&loaded[u]);
        m_prev = m_new;
        // chunk k - 1 + kStages goes where chunk k - 1 was, once both
        // warpgroups have released it (so the gates of chunk k + 1, written
        // next, stay one chunk ahead of them)
        const int refill = k - 1 + kStages;
        if (k >= 1 && refill < nc) {
          mbar_wait(&free_[(k - 1) % kStages], ((k - 1) / kStages) & 1);
          if (lane == 0) load_tiles(refill);
        }
      }
    }
    if (owns_m) m_out[bh] = m_prev;
    return;
  }

  if (tid >= 128) {
    // the preparer warpgroup: per chunk, w v as hi + lo, hi in place of v
    // and lo in the stage's third tile (row j of a swizzled tile is its
    // bytes 128 j .. 128 j + 127, whatever the swizzle did inside it; a
    // warp scales four whole rows an instruction), and n.
    // The blocks of a row tile share its 64 rows of n: row col_tile +
    // i tiles for i < n_rows goes to this block; 8 lanes sum a row over 8
    // tokens each (tokens 8 apart, so the 8 lanes read 8 banks), in up to 4
    // rounds of 16 rows, the same number for every thread, so the shuffles
    // see whole warps
    const int p = tid - 128;
    const int tiles_n = gridDim.x;
    const int n_rows = (kC - col_tile + tiles_n - 1) / tiles_n;
    const int n_grp = p & 7;
    float n_acc[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = r * 16 + (p >> 3);
      n_acc[r] = n_in && i < n_rows
                     ? n_in[(int64_t)bh * hd + row0 + col_tile + i * tiles_n]
                     : 0.f;
    }
    for (int c = 0; c < nc; ++c) {
      const int stage = c % kStages;
      mbar_wait(&loaded[stage], (c / kStages) & 1);
      const ChunkGates& g = gates[stage];
      uint8_t* k_s = tiles + stage * 3 * kTileBytes;
      uint8_t* v_s = k_s + kTileBytes;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int j = (p >> 3) + 16 * x;
        const float wj = g.w[j];
        const int off = j * 128 + (p & 7) * 16;
        uint4 r = *reinterpret_cast<uint4*>(v_s + off);
        uint4 r_lo;
        __nv_bfloat162* e2 = reinterpret_cast<__nv_bfloat162*>(&r);
        __nv_bfloat162* e2_lo = reinterpret_cast<__nv_bfloat162*>(&r_lo);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(e2[e]);
          split_bf16(f.x * wj, f.y * wj, e2[e], e2_lo[e]);
        }
        *reinterpret_cast<uint4*>(v_s + off) = r;
        *reinterpret_cast<uint4*>(v_s + kTileBytes + off) = r_lo;
      }
      // the scaled v is read by the tensor cores (the async proxy)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(&ready[stage]);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (r * 16 >= n_rows) break;
        const int i = r * 16 + (p >> 3);
        const int d = col_tile + min(i, n_rows - 1) * tiles_n;
        // n_{c-1}, chunk c's start, for the outputs pass
        if (n_grp == 0 && i < n_rows) {
          n_chunks[((int64_t)bh * nc + c) * hd + row0 + d] = n_acc[r];
        }
        float sum = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int j = 8 * e + n_grp;
          const __nv_bfloat16 x = *reinterpret_cast<const __nv_bfloat16*>(
              k_s + j * 128 + (((d >> 3) ^ (j & 7)) << 4) + (d & 7) * 2);
          sum = fmaf(g.w[j], __bfloat162float(x), sum);
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        sum += __shfl_xor_sync(0xffffffffu, sum, 4);
        n_acc[r] = g.decay * n_acc[r] + sum;
      }
      mbar_arrive(&free_[stage]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = r * 16 + (p >> 3);
      if (n_grp == 0 && i < n_rows) {
        n_out[(int64_t)bh * hd + row0 + col_tile + i * tiles_n] = n_acc[r];
      }
    }
    return;
  }

  // the consumer warpgroup: this block's 64 x 64 tile of C (rows are k's
  // features, columns v's) in the wgmma accumulator fragment
  const int r0 = (tid >> 5) * 16 + (lane >> 2);
  const int t2 = (lane & 3) * 2;
  const int64_t tile_off = ((int64_t)bh * hd + row0) * hd + col0;
  float acc[32], prev[32];
#pragma unroll
  for (int c = 0; c < 32; c += 2) {
    const int r = r0 + 8 * ((c >> 1) & 1);
    float2 x = make_float2(0.f, 0.f);
    if (c_in) {
      x = *reinterpret_cast<const float2*>(c_in + tile_off + (int64_t)r * hd +
                                           frag_col(c, t2));
    }
    acc[c] = x.x;
    acc[c + 1] = x.y;
  }
  for (int k = 0; k < nc; ++k) {
    const int stage = k % kStages;
    mbar_wait(&ready[stage], (k / kStages) & 1);
    const float decay = gates[stage].decay;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      prev[c] = acc[c];
      acc[c] *= decay;
    }
    hold(acc);
    wg_fence();
    const uint32_t ka = smem_u32(tiles + stage * 3 * kTileBytes);
#pragma unroll
    for (int part = 1; part <= 2; ++part) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // A = k^T and B = w v's hi, then lo part, both MN-major: 16 token
        // rows a k16 step
        wgmma_ss_n64<1, 1>(
            acc, desc<128>(ka + kk * 2048, kTileBytes, 1024),
            desc<128>(ka + part * kTileBytes + kk * 2048, kTileBytes, 1024),
            1);
      }
    }
    wg_commit();
    // while the tensor cores run: C_{k-1}, chunk k's start, to the outputs
    // pass as bf16 hi + lo, through two staging tiles in the scratch map's
    // swizzled layout and two TMA stores.  Thread 0 waits for its earlier
    // stores to have read their tiles before the barrier, so chunk k + 1
    // may refill the tiles that chunk k - 1 used.
    uint8_t* st = staged + (k & 1) * 2 * kTileBytes;
#pragma unroll
    for (int c = 0; c < 32; c += 4) {
      const int col = frag_col(c, t2);
      const int ch = col >> 3;
      const int in_ch = (col & 7) * 2;
      const int off_a = r0 * 128 + ((ch ^ (r0 & 7)) << 4) + in_ch;
      const int off_b = (r0 + 8) * 128 + ((ch ^ ((r0 + 8) & 7)) << 4) + in_ch;
      __nv_bfloat162 hi, lo;
      split_bf16(prev[c], prev[c + 1], hi, lo);
      *reinterpret_cast<__nv_bfloat162*>(st + off_a) = hi;
      *reinterpret_cast<__nv_bfloat162*>(st + kTileBytes + off_a) = lo;
      split_bf16(prev[c + 2], prev[c + 3], hi, lo);
      *reinterpret_cast<__nv_bfloat162*>(st + off_b) = hi;
      *reinterpret_cast<__nv_bfloat162*>(st + kTileBytes + off_b) = lo;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (tid == 0) {
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
    if (tid == 0) {
      tma_store(&tm_c, st, col0, row0, 2 * k, bh);
      tma_store(&tm_c, st + kTileBytes, col0, row0, 2 * k + 1, bh);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
    wg_wait_all();
    hold(acc);
    mbar_arrive(&free_[stage]);
  }

  // the final state, in float32
#pragma unroll
  for (int c = 0; c < 32; c += 2) {
    const int r = r0 + 8 * ((c >> 1) & 1);
    *reinterpret_cast<float2*>(c_out + tile_off + (int64_t)r * hd +
                               frag_col(c, t2)) =
        make_float2(acc[c], acc[c + 1]);
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Grid (NB column tiles of h, NC chunks, B * H), one warpgroup; hd is
// 64 NB.
template <int NB>
__global__ void __launch_bounds__(kOutputsThreads, 1)
    mlstm_chunk_outputs_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const __grid_constant__ CUtensorMap tm_c,
                               const __grid_constant__ CUtensorMap tm_o,
                               const float* __restrict__ ig,
                               const float* __restrict__ lf,
                               GateStrides gs,
                               const float* __restrict__ n_chunks,
                               const float* __restrict__ m_chunks, int heads,
                               int seq, float scale) {
  extern __shared__ uint8_t smem_raw[];
  constexpr int nb = NB;  // column blocks of a q or k row, row blocks of C
  constexpr int hd = 64 * NB;
  uint8_t* q_s = align1024(smem_raw);
  uint8_t* k_s = q_s + nb * kTileBytes;
  uint8_t* c_s = k_s + nb * kTileBytes;  // C_{k-1}'s hi part, then lo
  uint8_t* v_s = c_s + 2 * nb * kTileBytes;  // v's columns, later h's
  float* f_s = reinterpret_cast<float*>(v_s + kTileBytes);
  float* i_s = f_s + kC;
  float* n_s = i_s + kC;
  float* m_s = n_s + hd;
  uint64_t* bars = reinterpret_cast<uint64_t*>(m_s + 4);

  const int col_tile = blockIdx.x;
  const int k = blockIdx.y;
  const int bh = blockIdx.z;
  const int nc = gridDim.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int col0 = col_tile * kC;
  const int tid = threadIdx.x;
  const int lane = tid & 31;

  // warp 0 fetches the tiles, one TMA box a lane; warp 1 the chunk's
  // gates and m_{k-1}; every thread a share of n_{k-1}
  if (tid < 32) {
    if (lane == 0) {
      mbar_init(&bars[0], 1);
      mbar_init(&bars[1], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      mbar_expect_tx(&bars[0], 2 * nb * kTileBytes);
      mbar_expect_tx(&bars[1], (2 * nb + 1) * kTileBytes);
    }
    __syncwarp();
    const int cb = lane % nb;
    if (lane < nb) {
      tma_load(q_s + cb * kTileBytes, &tm_q, &bars[0], cb * 64, h, k * kC, b);
    } else if (lane < 2 * nb) {
      tma_load(k_s + cb * kTileBytes, &tm_k, &bars[0], cb * 64, h, k * kC, b);
    } else if (lane < 4 * nb) {
      const int part = (lane - 2 * nb) / nb;
      tma_load(c_s + (part * nb + cb) * kTileBytes, &tm_c, &bars[1], col0,
               cb * 64, 2 * k + part, bh);
    } else if (lane == 4 * nb) {
      tma_load(v_s, &tm_v, &bars[1], col0, h, k * kC, b);
    }
  } else if (tid < 64) {
    float gi[2], gl[1][2], f[1][2];
    load_gates(gates_at(ig, lf, gs, b, h), k * kC + 2 * lane, seq, gi, gl[0]);
    chunk_cumsum(gl, f);
    f_s[2 * lane] = f[0][0];
    f_s[2 * lane + 1] = f[0][1];
    i_s[2 * lane] = gi[0];
    i_s[2 * lane + 1] = gi[1];
    if (lane == 0) m_s[0] = m_chunks[(int64_t)bh * nc + k];
  }
  for (int d = tid; d < hd; d += kOutputsThreads) {
    n_s[d] = n_chunks[((int64_t)bh * nc + k) * hd + d];
  }
  __syncthreads();

  const int ra = (tid >> 5) * 16 + (lane >> 2);  // this thread's rows
  const int rb = ra + 8;
  const int t2 = (lane & 3) * 2;
  const float m0 = m_s[0];
  const float fa = f_s[ra];
  const float fb = f_s[rb];

  mbar_wait(&bars[0], 0);
  float s[32], o[32];
#pragma unroll
  for (int c = 0; c < 32; ++c) s[c] = o[c] = 0.f;
  hold(s);
  hold(o);
  wg_fence();
  const uint32_t qa = smem_u32(q_s);
  const uint32_t ka = smem_u32(k_s);
  const uint32_t ca = smem_u32(c_s);
  // S = q k^T, both K-major: k16 steps walk 32 bytes along the swizzled
  // rows, then on to the next column block
#pragma unroll
  for (int kk = 0; kk < 4 * nb; ++kk) {
    const uint32_t off = (kk >> 2) * kTileBytes + (kk & 3) * 32;
    wgmma_ss_n64<0, 0>(s, desc<128>(qa + off, 16, 1024),
                       desc<128>(ka + off, 16, 1024), kk > 0);
  }
  // q C_{k-1}, its hi then lo part, C MN-major: 16 feature rows a k16
  // step
  mbar_wait(&bars[1], 0);
#pragma unroll
  for (int part = 0; part < 2; ++part) {
#pragma unroll
    for (int kk = 0; kk < 4 * nb; ++kk) {
      const uint32_t off = (kk >> 2) * kTileBytes + (kk & 3) * 32;
      wgmma_ss_n64<0, 1>(
          o, desc<128>(qa + off, 16, 1024),
          desc<128>(ca + (part * nb * 4 + kk) * 2048, kTileBytes, 1024),
          part > 0 || kk > 0);
    }
  }
  wg_commit();

  // while the tensor cores run: the gate matrix of this thread's fragment
  // and its rows' stabilisers, then q.n_{k-1} split over the quad
  float w[32];
  float mxa = -INFINITY, mxb = -INFINITY;
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    const bool lo = (c & 2) == 0;
    const int t = lo ? ra : rb;
    const int j = frag_col(c, t2);
    const float d = j <= t ? ((lo ? fa : fb) - f_s[j]) + i_s[j] : -INFINITY;
    w[c] = d;
    if (lo) {
      mxa = fmaxf(mxa, d);
    } else {
      mxb = fmaxf(mxb, d);
    }
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, off));
    mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, off));
  }
  const float ma = fmaxf(mxa, fa + m0);
  const float mb = fmaxf(mxb, fb + m0);
#pragma unroll
  for (int c = 0; c < 32; ++c) w[c] = exp_fast(w[c] - ((c & 2) ? mb : ma));
  const float inter_a = exp_fast(fa + m0 - ma);
  const float inter_b = exp_fast(fb + m0 - mb);
  float qna = 0.f, qnb = 0.f;
  constexpr int per = hd / 4;  // features of q.n per thread of the quad
#pragma unroll
  for (int d0 = (lane & 3) * per; d0 < (lane & 3) * per + per; d0 += 8) {
    const int cb = d0 >> 6;
    const int ch = (d0 & 63) >> 3;
    const uint4 xa = *reinterpret_cast<const uint4*>(
        q_s + cb * kTileBytes + ra * 128 + ((ch ^ (ra & 7)) << 4));
    const uint4 xb = *reinterpret_cast<const uint4*>(
        q_s + cb * kTileBytes + rb * 128 + ((ch ^ (rb & 7)) << 4));
    const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&xa);
    const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&xb);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 a = __bfloat1622float2(pa[e]);
      const float2 bb = __bfloat1622float2(pb[e]);
      const float n0 = n_s[d0 + 2 * e];
      const float n1 = n_s[d0 + 2 * e + 1];
      qna = fmaf(a.x, n0, fmaf(a.y, n1, qna));
      qnb = fmaf(bb.x, n0, fmaf(bb.y, n1, qnb));
    }
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    qna += __shfl_xor_sync(0xffffffffu, qna, off);
    qnb += __shfl_xor_sync(0xffffffffu, qnb, off);
  }
  wg_wait_all();
  hold(s);
  hold(o);

  // S * hd^-0.5 * W, its row sums, and inter * q C_{k-1}
  float suma = 0.f, sumb = 0.f;
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    s[c] = s[c] * scale * w[c];
    if (c & 2) {
      sumb += s[c];
      o[c] *= inter_b;
    } else {
      suma += s[c];
      o[c] *= inter_a;
    }
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    suma += __shfl_xor_sync(0xffffffffu, suma, off);
    sumb += __shfl_xor_sync(0xffffffffu, sumb, off);
  }
  // += (S W) v, S W as bf16 hi and lo A fragments: k16 step kk takes
  // columns 16kk .. 16kk + 15, i.e. accumulator registers 8kk .. 8kk + 7
  uint32_t pw[2][4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      __nv_bfloat162 hi, lo;
      split_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1], hi, lo);
      pw[0][kk][x] = *reinterpret_cast<uint32_t*>(&hi);
      pw[1][kk][x] = *reinterpret_cast<uint32_t*>(&lo);
    }
  }
  hold(o);
  wg_fence();
  const uint32_t va = smem_u32(v_s);
#pragma unroll
  for (int part = 0; part < 2; ++part) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs_n64(o, pw[part][kk],
                   desc<128>(va + kk * 2048, kTileBytes, 1024));
    }
  }
  wg_commit();
  wg_wait_all();
  hold(o);

  // h = o / den into the v tile, which the last wgmma has finished reading,
  // in the tensor map's swizzled layout, and out by one TMA store (rows
  // past S are dropped)
  const float inv_a =
      1.f / fmaxf(fabsf(suma + inter_a * qna), exp_fast(-ma));
  const float inv_b =
      1.f / fmaxf(fabsf(sumb + inter_b * qnb), exp_fast(-mb));
  __syncthreads();
#pragma unroll
  for (int c = 0; c < 32; c += 4) {
    const int col = frag_col(c, t2);
    const int ch = col >> 3;
    const int in_ch = (col & 7) * 2;
    *reinterpret_cast<__nv_bfloat162*>(v_s + ra * 128 +
                                       ((ch ^ (ra & 7)) << 4) + in_ch) =
        __floats2bfloat162_rn(o[c] * inv_a, o[c + 1] * inv_a);
    *reinterpret_cast<__nv_bfloat162*>(v_s + rb * 128 +
                                       ((ch ^ (rb & 7)) << 4) + in_ch) =
        __floats2bfloat162_rn(o[c + 2] * inv_b, o[c + 3] * inv_b);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (tid == 0) {
    tma_store(&tm_o, v_s, col0, h, k * kC, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// the outputs pass's arguments, built once for its four instantiations
struct Outputs {
  CUtensorMap tm_q, tm_k, tm_v, tm_c, tm_o;
  const float* ig;
  const float* lf;
  GateStrides gs;
  const float* n_chunks;
  const float* m_chunks;
  dim3 grid;
  int heads, seq;
  float scale;
};

template <int NB>
int launch_outputs(const Outputs& a, cudaStream_t stream) {
  const size_t smem = outputs_smem(64 * NB);
  cudaError_t e = allow_smem(mlstm_chunk_outputs_kernel<NB>, smem);
  if (e != cudaSuccess) return (int)e;
  mlstm_chunk_outputs_kernel<NB><<<a.grid, kOutputsThreads, smem, stream>>>(
      a.tm_q, a.tm_k, a.tm_v, a.tm_c, a.tm_o, a.ig, a.lf, a.gs, a.n_chunks,
      a.m_chunks, a.heads, a.seq, a.scale);
  return (int)cudaGetLastError();
}

int launch(const void* q, const void* k, const void* v, const float* ig,
           const float* lf, const float* c_in, const float* n_in,
           const float* m_in, void* out, float* c_out, float* n_out,
           float* m_out, void* c_chunks, float* n_chunks, float* m_chunks,
           int batch, int heads, int seq, int hd, const int64_t* st,
           cudaStream_t stream) {
  if (hd % 64 || hd > 256) return (int)cudaErrorInvalidValue;
  const int nc = (seq + kC - 1) / kC;
  CUtensorMap tm_q{}, tm_k{}, tm_v{}, tm_o{}, tm_c{};
  if (nc > 0) {
    int err = make_map(&tm_q, q, hd, heads, seq, batch, st[0], st[1], st[2],
                       128);
    if (!err) {
      err = make_map(&tm_k, k, hd, heads, seq, batch, st[3], st[4], st[5],
                     128);
    }
    if (!err) {
      err = make_map(&tm_v, v, hd, heads, seq, batch, st[6], st[7], st[8],
                     128);
    }
    if (!err) {
      err = make_map(&tm_o, out, hd, heads, seq, batch, st[9], st[10],
                     st[11], 128);
    }
    if (!err) {
      // the chunks' starting C as bf16 hi and lo parts: (B * H, NC, 2, hd
      // rows, hd columns), one box is 64 columns of 64 rows of one part of
      // one chunk
      const int64_t dims[4] = {hd, hd, 2 * nc, (int64_t)batch * heads};
      const int64_t strides[3] = {hd, (int64_t)hd * hd,
                                  (int64_t)2 * nc * hd * hd};
      const int box[4] = {64, 64, 1, 1};
      err = make_map_4d(&tm_c, c_chunks, dims, strides, box, 128);
    }
    if (err) return err;
  }
  const size_t smem = states_smem();
  cudaError_t e = allow_smem(mlstm_chunk_states_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const float scale = (float)(1.0 / sqrt((double)hd));
  const int tiles = hd / kC;
  GateStrides gs;
  for (int i = 0; i < 6; ++i) gs.v[i] = st[12 + i];
  mlstm_chunk_states_kernel<<<dim3(tiles, tiles, batch * heads),
                              kStatesThreads, smem, stream>>>(
      tm_k, tm_v, tm_c, ig, lf, gs, c_in, n_in, m_in, n_chunks, m_chunks,
      c_out, n_out, m_out, heads, seq, hd, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || nc == 0) return (int)e;
  const Outputs a{tm_q, tm_k, tm_v, tm_c, tm_o, ig, lf, gs, n_chunks,
                  m_chunks, dim3(tiles, nc, batch * heads), heads, seq, scale};
  switch (tiles) {
    case 1:
      return launch_outputs<1>(a, stream);
    case 2:
      return launch_outputs<2>(a, stream);
    case 3:
      return launch_outputs<3>(a, stream);
    default:
      return launch_outputs<4>(a, stream);
  }
}

}  // namespace tc
}  // namespace
}  // namespace repro_torch

// strides: 18 int64 in elements, (batch, head, seq) for q, k, v, out,
// i_raw, log_f.
// c_in/n_in/m_in may all be null for the empty state.  chunk is 1..64.
// tensor_core 0 takes the cuda_core kernel; 1 the two tensor-core passes,
// for bf16 with hd a multiple of 64 and chunk 64 only, with the chunks'
// starting states in c_chunks (B, H, NC, 2, hd, hd) bf16 (C as hi + lo),
// n_chunks (B, H, NC, hd) and m_chunks (B, H, NC) float32, NC =
// ceil(seq / 64).  Returns the cudaError_t of the launch (0 on success).
extern "C" int mlstm_chunk_launch(
    const void* q, const void* k, const void* v, const float* i_raw,
    const float* log_f, const float* c_in, const float* n_in,
    const float* m_in, void* out, float* c_out, float* n_out, float* m_out,
    void* c_chunks, float* n_chunks, float* m_chunks, int batch, int heads,
    int seq, int hd, int chunk, const int64_t* strides, int is_bf16,
    void* stream, int tensor_core) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tensor_core) {
    if (!is_bf16 || chunk != repro_torch::tc::kC) {
      return (int)cudaErrorInvalidValue;
    }
    return repro_torch::tc::launch(q, k, v, i_raw, log_f, c_in, n_in, m_in,
                                   out, c_out, n_out, m_out, c_chunks,
                                   n_chunks, m_chunks, batch, heads, seq, hd,
                                   strides, s);
  }
  if (is_bf16) {
    return repro_torch::launch<__nv_bfloat16>(
        q, k, v, i_raw, log_f, c_in, n_in, m_in, out, c_out, n_out, m_out,
        batch, heads, seq, hd, chunk, strides, s);
  }
  return repro_torch::launch<float>(q, k, v, i_raw, log_f, c_in, n_in, m_in,
                                    out, c_out, n_out, m_out, batch, heads,
                                    seq, hd, chunk, strides, s);
}
