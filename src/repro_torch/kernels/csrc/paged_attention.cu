// Paged GQA decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `paged_attention` of the JAX package
// (src/repro/kernels/paged_attention.py, function `paged_attention`, body
// `_kernel`): one query token per sequence attends to that sequence's KV
// cache, which lives in a pool of pages of `block_size` tokens indexed by a
// per-sequence block table, with an online softmax over the pages; tokens
// at or past `length` are masked and the softmax denominator is floored at
// 1e-30 (a sequence of length 0 gives 0, as the Pallas kernel does).
//
// Layouts (contiguous):
//   q       (B, n_kv, qpk, hd)   not pre-scaled: the kernel applies `scale`
//   k/v     (n_pages, bs, n_kv, hd)
//   tables  (B, max_pages) int32, entries clamped to [0, n_pages)
//   lengths (B,) int32
//   out     (B, n_kv, qpk, hd)
//
// Bound.  Decode attention does about 2 FLOPs per byte it reads: it is
// bound by device memory (bytes = sum_b length_b * n_kv * hd * 2 *
// sizeof(T)).  At granite-3-2b's decode (B 8 slots of 512 tokens, 8 kv
// heads, qpk 4, hd 64, bf16) that is 8.4 MB, 2.5 us at 3.35 TB/s; with one
// block per (sequence, kv head) only 64 blocks would run on 132 SMs, each
// walking 32 pages one dependent load after another.
//
// Design: a split page walk.  One thread-block cluster of n_split <= 8
// blocks per (sequence, kv head, group of up to 4 q heads); block r walks
// the r-th contiguous range of `pages_per_split` pages.  The wrapper sizes
// both from the table's shape, never from the lengths: granite's decode
// runs 8 x 8 clusters of 4 blocks, 8 pages (128 tokens) a block.  The
// block's tokens follow from the shape alone, so q, the length and the
// block-table entries are loaded together, and the K/V rows right after:
// from device memory straight into registers, 16 bytes a thread (kept as
// packed bf16 until used), eight threads a 128-byte row at hd 64, four
// tokens a thread in flight; no shared-memory stage and no barrier inside
// the walk.  Each group of threads keeps an online (m, l, acc) for its
// tokens.  The groups of a warp merge their partials by shuffles, the
// warps through shared memory, and the cluster's
// blocks read every block's partial through distributed shared memory, all
// loads in flight together, each block merging and writing a share of the
// output: one launch, no global scratch.  A block whose range lies past
// the length contributes l = 0.
//
// Instantiations: float32 and bf16, each for 1, 2 or 4 q heads a block
// (the next power of two at or above qpk, 4 above that with the q heads
// split over several clusters that read the same pages).

#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace repro_torch {
namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplit = 8;   // portable cluster size
constexpr int kMaxHd = 256;

// tokens a thread has in flight: four bf16 rows (16 bytes each, kept packed
// until used), two float32 rows
template <typename T>
struct Unroll {
  static constexpr int n = sizeof(T) == 2 ? 4 : 2;
};

// threads that cover one row of hd elements, 8 each: a power of two
__host__ __device__ constexpr int row_threads(int hd) {
  int g = 1;
  while (g < hd / 8) g <<= 1;
  return g;
}

// shared memory of a block: each warp's partial and the block's merged
// one (hd accumulators, m and l each), for qt heads
__host__ __device__ constexpr size_t smem_bytes(int qt, int hd) {
  return sizeof(float) * (kWarps + 1) * qt * (hd + 2);
}

// merge the partial (m, l, acc) with (m2, l2, acc2), m in the log2 domain;
// either side may be empty (m = -inf, l = 0, acc = 0)
__device__ __forceinline__ void merge(float& m, float& l, float* acc,
                                      float m2, float l2, const float* acc2) {
  const float mn = fmaxf(m, m2);
  const float use = mn == -INFINITY ? 0.f : mn;
  const float a = exp2f(m - use);
  const float c = exp2f(m2 - use);
  l = a * l + c * l2;
#pragma unroll
  for (int d = 0; d < 8; ++d) acc[d] = a * acc[d] + c * acc2[d];
  m = mn;
}

// 8 consecutive elements of a row, loaded with 16-byte loads and turned
// into f32 pairs where they are used
template <typename T>
struct Row8;

template <>
struct Row8<__nv_bfloat16> {
  uint4 raw;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    raw = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void zero() { raw = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ float2 pair(int j) const {
    const uint32_t w = j == 0 ? raw.x : j == 1 ? raw.y : j == 2 ? raw.z
                                                                : raw.w;
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
  }
};

template <>
struct Row8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void zero() {
    a = b = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ float2 pair(int j) const {
    return j == 0 ? make_float2(a.x, a.y)
         : j == 1 ? make_float2(a.z, a.w)
         : j == 2 ? make_float2(b.x, b.y)
                  : make_float2(b.z, b.w);
  }
};

template <typename T, int QT>
__global__ void __launch_bounds__(kThreads, 4) paged_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ tables,
    const int* __restrict__ lengths, T* __restrict__ out, int n_kv, int qpk,
    int hd, int n_pages, int bs, int max_pages, int pages_per_split,
    float scale_log2) {
  constexpr int U = Unroll<T>::n;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_split = (int)cluster.num_blocks();
  const int hgroups = (qpk + QT - 1) / QT;
  const int h = blockIdx.y / hgroups;
  const int g0 = (blockIdx.y % hgroups) * QT;
  const int nq = min(QT, qpk - g0);
  const int b = blockIdx.z;
  const int tid = threadIdx.x;

  // a group of G threads (a power of two) covers one row, 8 elements each
  const int chunks = hd / 8;
  const int G = row_threads(hd);
  const int sub = tid & (G - 1);
  const int grp = tid / G;
  const int n_grp = kThreads / G;
  const bool active = sub < chunks;
  const int d0 = sub * 8;

  // shared memory: each warp's partial [kWarps][QT][hd] and [kWarps][QT]
  // (m, l); the block's partial [QT][hd] and [QT] (m, l), which the
  // cluster reads
  extern __shared__ float smem[];
  float* w_acc = smem;
  float* w_ml = w_acc + kWarps * QT * hd;
  float* b_acc = w_ml + kWarps * QT * 2;
  float* b_ml = b_acc + QT * hd;

  // the shape fixes the block's tokens; the length only masks them, so
  // the table, length and q loads all go out together
  const int t_lo = rank * pages_per_split * bs;
  const int t_end = min(t_lo + pages_per_split * bs, max_pages * bs);
  const int length = min(max(lengths[b], 0), max_pages * bs);
  const int* table = tables + (int64_t)b * max_pages;
  const int64_t row_stride = (int64_t)n_kv * hd;
  const int64_t page_stride = (int64_t)bs * row_stride;

  // q rows, scaled into the log2 domain
  float qr[QT][8];
  const int64_t q_off = (((int64_t)b * n_kv + h) * qpk + g0) * hd;
#pragma unroll
  for (int i = 0; i < QT; ++i) {
    Row8<T> row;
    if (active && i < nq) {
      row.load(q + q_off + (int64_t)i * hd + d0);
    } else {
      row.zero();
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = row.pair(j);
      qr[i][2 * j] = f.x * scale_log2;
      qr[i][2 * j + 1] = f.y * scale_log2;
    }
  }
  float m[QT], l[QT], acc[QT][8];
#pragma unroll
  for (int i = 0; i < QT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < 8; ++d) acc[i][d] = 0.f;
  }

  const int per_round = n_grp * U;
  // rounds are uniform over the block, so every lane reaches the shuffles
  const int rounds = t_end > t_lo ? (t_end - t_lo + per_round - 1) / per_round
                                  : 0;
  for (int rd = 0; rd < rounds; ++rd) {
    Row8<T> kx[U], vx[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int tok = t_lo + rd * per_round + u * n_grp + grp;
      const int page =
          tok < t_end ? min(max(table[tok / bs], 0), n_pages - 1) : 0;
      ok[u] = tok < t_end && tok < length;
      if (ok[u] && active) {
        const int64_t off = page * page_stride + (tok % bs) * row_stride +
                            (int64_t)h * hd + d0;
        kx[u].load(k_pages + off);
        vx[u].load(v_pages + off);
      } else {
        kx[u].zero();
        vx[u].zero();
      }
    }
    // scores: each thread's share of the dot products, then the sum over
    // the group, all QT x U sums one shuffle level at a time
    float sc[QT][U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int i = 0; i < QT; ++i) sc[i][u] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 kf = kx[u].pair(j);
#pragma unroll
        for (int i = 0; i < QT; ++i) {
          sc[i][u] = fmaf(qr[i][2 * j], kf.x, sc[i][u]);
          sc[i][u] = fmaf(qr[i][2 * j + 1], kf.y, sc[i][u]);
        }
      }
    }
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) {
      if (o < G) {
#pragma unroll
        for (int i = 0; i < QT; ++i) {
#pragma unroll
          for (int u = 0; u < U; ++u) {
            sc[i][u] += __shfl_xor_sync(0xffffffffu, sc[i][u], o);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < QT; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!ok[u]) sc[i][u] = -INFINITY;
        mx = fmaxf(mx, sc[i][u]);
      }
      const float mn = fmaxf(m[i], mx);
      const float use = mn == -INFINITY ? 0.f : mn;
      const float a = exp2f(m[i] - use);
      float p[U];
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u] = exp2f(sc[i][u] - use);
        sum += p[u];
      }
      l[i] = a * l[i] + sum;
      m[i] = mn;
#pragma unroll
      for (int d = 0; d < 8; ++d) acc[i][d] *= a;
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 vf = vx[u].pair(j);
          acc[i][2 * j] = fmaf(p[u], vf.x, acc[i][2 * j]);
          acc[i][2 * j + 1] = fmaf(p[u], vf.y, acc[i][2 * j + 1]);
        }
      }
    }
  }

  // the block's partial: the groups of each warp merge by shuffles (lanes
  // G, 2G, ... apart), the warps through shared memory, each thread taking
  // a share of the (head, element) pairs
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    if (o >= G) {
#pragma unroll
      for (int i = 0; i < QT; ++i) {
        float acc2[8];
#pragma unroll
        for (int d = 0; d < 8; ++d) {
          acc2[d] = __shfl_xor_sync(0xffffffffu, acc[i][d], o);
        }
        const float m2 = __shfl_xor_sync(0xffffffffu, m[i], o);
        const float l2 = __shfl_xor_sync(0xffffffffu, l[i], o);
        merge(m[i], l[i], acc[i], m2, l2, acc2);
      }
    }
  }
  const int warp = tid >> 5;
  if ((tid & 31) < G) {
#pragma unroll
    for (int i = 0; i < QT; ++i) {
      if (active) {
        float* wa = w_acc + (warp * QT + i) * hd + d0;
#pragma unroll
        for (int d = 0; d < 8; ++d) wa[d] = acc[i][d];
      }
      if (sub == 0) {
        w_ml[(warp * QT + i) * 2] = m[i];
        w_ml[(warp * QT + i) * 2 + 1] = l[i];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < QT * hd; e += kThreads) {
    const int i = e / hd;
    float mw[kWarps];
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      mw[w] = w_ml[(w * QT + i) * 2];
      mx = fmaxf(mx, mw[w]);
    }
    const float use = mx == -INFINITY ? 0.f : mx;
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = exp2f(mw[w] - use);
      ll = fmaf(c, w_ml[(w * QT + i) * 2 + 1], ll);
      aa = fmaf(c, w_acc[(w * QT + i) * hd + e - i * hd], aa);
    }
    b_acc[e] = aa;
    if (e == i * hd) {
      b_ml[2 * i] = mx;
      b_ml[2 * i + 1] = ll;
    }
  }

  // the cluster's merge, its outputs spread over the blocks: each reads
  // every block's (m, l) of its head and its element of acc from
  // distributed shared memory, all loads in flight together
  cluster.sync();
  for (int e = rank * kThreads + tid; e < nq * hd; e += n_split * kThreads) {
    const int i = e / hd;
    float mr[kMaxSplit], lr[kMaxSplit], ar[kMaxSplit];
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) {
      if (r < n_split) {
        const float* ml = cluster.map_shared_rank(b_ml, r);
        mr[r] = ml[2 * i];
        lr[r] = ml[2 * i + 1];
        ar[r] = cluster.map_shared_rank(b_acc, r)[e];
      } else {
        mr[r] = -INFINITY;
        lr[r] = ar[r] = 0.f;
      }
    }
    float mx = -INFINITY;
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) mx = fmaxf(mx, mr[r]);
    const float use = mx == -INFINITY ? 0.f : mx;
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) {
      const float w = exp2f(mr[r] - use);
      ll = fmaf(w, lr[r], ll);
      aa = fmaf(w, ar[r], aa);
    }
    out[q_off + e] = from_f32<T>(aa / fmaxf(ll, 1e-30f));
  }
  // no block leaves while another may still read its shared memory
  cluster.sync();
}

template <typename T, int QT>
int launch_qt(const void* q, const void* k_pages, const void* v_pages,
              const void* tables, const void* lengths, void* out, int batch,
              int n_kv, int qpk, int hd, int n_pages, int bs, int max_pages,
              int n_split, int pages_per_split, float scale,
              cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, n_kv * ((qpk + QT - 1) / QT), batch);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes(QT, hd);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, paged_split_kernel<T, QT>, static_cast<const T*>(q),
      static_cast<const T*>(k_pages), static_cast<const T*>(v_pages),
      static_cast<const int*>(tables), static_cast<const int*>(lengths),
      static_cast<T*>(out), n_kv, qpk, hd, n_pages, bs, max_pages,
      pages_per_split, scale * 1.4426950408889634f);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* tables, const void* lengths, void* out, int batch,
           int n_kv, int qpk, int hd, int n_pages, int bs, int max_pages,
           int n_split, int pages_per_split, float scale,
           cudaStream_t stream) {
  if (hd % 8 || hd > kMaxHd || n_split < 1 || n_split > kMaxSplit ||
      pages_per_split < 1 || n_split * pages_per_split < max_pages) {
    return (int)cudaErrorInvalidValue;
  }
  if (qpk == 1) {
    return launch_qt<T, 1>(q, k_pages, v_pages, tables, lengths, out, batch,
                           n_kv, qpk, hd, n_pages, bs, max_pages, n_split,
                           pages_per_split, scale, stream);
  }
  if (qpk == 2) {
    return launch_qt<T, 2>(q, k_pages, v_pages, tables, lengths, out, batch,
                           n_kv, qpk, hd, n_pages, bs, max_pages, n_split,
                           pages_per_split, scale, stream);
  }
  return launch_qt<T, 4>(q, k_pages, v_pages, tables, lengths, out, batch,
                         n_kv, qpk, hd, n_pages, bs, max_pages, n_split,
                         pages_per_split, scale, stream);
}

}  // namespace
}  // namespace repro_torch

// n_split blocks (one cluster) per (sequence, kv head, group of q heads),
// each walking pages_per_split pages; the split comes from the wrapper's
// planner (`split_plan` in kernels/paged_attention.py).  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages, const void* tables,
                                      const void* lengths, void* out,
                                      int batch, int n_kv, int qpk, int hd,
                                      int n_pages, int bs, int max_pages,
                                      int is_bf16, void* stream, float scale,
                                      int n_split, int pages_per_split) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return repro_torch::launch<__nv_bfloat16>(
        q, k_pages, v_pages, tables, lengths, out, batch, n_kv, qpk, hd,
        n_pages, bs, max_pages, n_split, pages_per_split, scale, s);
  }
  return repro_torch::launch<float>(q, k_pages, v_pages, tables, lengths, out,
                                    batch, n_kv, qpk, hd, n_pages, bs,
                                    max_pages, n_split, pages_per_split,
                                    scale, s);
}
