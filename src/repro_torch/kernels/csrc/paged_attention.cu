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
// Bound.  Decode attention does about 2 x qpk FLOPs per byte it reads: it
// is bound by device memory, and only the live rows count (bytes = sum_b
// length_b * n_kv * hd * 2 * sizeof(T)).  At the closed serving cell
// (h2o-danube-1.8b: B 256 slots of a 1,024-row cache, 8 kv heads, qpk 4,
// hd 80, bf16, lengths ~400 on average) that is ~260 MB a call, ~78 us at
// 3.35 TB/s.  A walk over the table's width instead of the live length
// does ~2.5x the work there; one memory latency per round of loads leaves
// the bandwidth idle.
//
// bf16: `paged_split_kernel_ring`, a walk over the live tokens only.
//   - Work follows the lengths.  The live tokens are cut into 16-token
//     tiles, dealt in turn to the n_split blocks of a cluster and, within
//     a block, to its four warps: nothing past the length is loaded or
//     computed, and a block with nothing live only merges.  The first
//     tiles' table entries load beside the length (the deal does not
//     depend on it).  The wrapper plans n_split from the shapes
//     (`split_plan`: blocks against the SMs, the table's width), never
//     from the lengths, so it never syncs.
//   - Loads stay in flight.  Each warp owns a ring of kStages tiles' K and
//     V rows in shared memory, filled by cp.async (a row's 16-byte chunks
//     on neighbouring lanes, zeros past the length) from the page table:
//     while it computes one tile, the next kStages - 1 are loading.  No
//     block-wide barrier inside the walk.  Two stages measured 1-5 %
//     faster than three, and four slower, on an H100 (PERF.md): three
//     blocks an SM (registers bound them) keep ~60 KB in flight.
//   - No idle lanes at any hd, few instructions a tile.  Q.K^T runs on the
//     tensor cores (mma.sync m16n8k16: 16 tokens by the block's up to 8 q
//     heads, bf16 products exact in f32); the online softmax in float32;
//     P.V on the tensor cores too (16 elements of the row by the 8 heads),
//     p entering as the exact sum of three bf16 terms (hi, mid, lo: the 24
//     bits of its significand), so that p is never rounded and every
//     product is exact and summed in float32.
//   - One launch, the merge included: the warps of a block merge through
//     shared memory; where n_split > 1 the blocks of a thread-block cluster
//     then merge through distributed shared memory and each writes a share
//     of the output.
//
// float32: `paged_split_kernel`, the CUDA-core walk of the table's width
// split over a cluster (the design before the bf16 kernel above), kept so
// that the float32 engines stay within 2e-5 of the CPU.  Each group of
// threads keeps an online (m, l, acc) over its tokens, 16-byte loads
// straight into registers; the cluster's blocks merge through distributed
// shared memory.
//
// Instantiations: bf16 by the widest row it serves (hd <= 64, 128, 256),
// each block serving up to 8 q heads; float32 for 1, 2 or 4 q heads a
// block (the next power of two at or above qpk).  More q heads are split
// over blocks that read the same pages.

#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace repro_torch {
namespace {

constexpr int kMaxSplit = 8;   // portable cluster size
constexpr int kMaxHd = 256;

// ------------------------------------------------ float32: CUDA-core walk

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

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


// ------------------------------------------- bf16: the live-token ring walk

constexpr int kRingWarps = 4;
constexpr int kRingThreads = kRingWarps * 32;
constexpr int kStages = 2;                // tiles of a warp's ring
constexpr int kTile = 16;                 // tokens a tile: an mma's k or m
constexpr int kMaxQ = 8;                  // q heads a block: an mma's n
constexpr int kPRow = 24;                 // floats of a head's row of p

// bytes of a staged K or V row: hd bf16 and 16 bytes of padding, so that
// the 8 rows of one ldmatrix phase fall on 8 distinct 16-byte bank groups
// (hd a multiple of 16 makes the stride an odd multiple of 16 bytes)
__host__ __device__ constexpr int ring_row_bytes(int hd) { return 2 * hd + 16; }

// one warp's ring: kStages stages of kTile K rows, then kTile V rows
__host__ __device__ constexpr int ring_warp_bytes(int hd) {
  return kStages * 2 * kTile * ring_row_bytes(hd);
}

// dynamic shared memory of a block: the warps' rings (a warp's partial
// reuses its own ring once its walk ends), each warp's p tile (f32, by
// head), and the block's partial, which the cluster reads
__host__ __device__ constexpr size_t ring_smem_bytes(int hd) {
  return (size_t)kRingWarps * ring_warp_bytes(hd) +
         sizeof(float) * kRingWarps * kMaxQ * kPRow +
         sizeof(float) * kMaxQ * (hd + 2);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory to shared memory past L1; zeros where !ok
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 b16 matrices from shared memory, lane l giving the address
// of row l % 8 of matrix l / 8; .trans hands each its transpose
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// D (16 x 8, f32) += A (16 x 16 bf16, by rows) * B (16 x 8 bf16, by columns)
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// the float32 pair (x, y) as the exact sum of three bf16 pairs: each term
// takes the next 8 bits of the 24-bit significands, and the remainders are
// exact in float32, so hi + mid + lo == (x, y) bit for bit
__device__ __forceinline__ void split3(float x, float y, uint32_t (&t)[3]) {
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x, y);
  const float2 h = __bfloat1622float2(hi);
  x -= h.x;
  y -= h.y;
  const __nv_bfloat162 mid = __floats2bfloat162_rn(x, y);
  const float2 m = __bfloat1622float2(mid);
  t[0] = bits(hi);
  t[1] = bits(mid);
  t[2] = bits(__floats2bfloat162_rn(x - m.x, y - m.y));
}

// KS: the most 16-element steps of a row the instantiation serves (hd <=
// 16 KS)
template <int KS>
__global__ void __launch_bounds__(kRingThreads, 3) paged_split_kernel_ring(
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k_pages,
    const __nv_bfloat16* __restrict__ v_pages, const int* __restrict__ tables,
    const int* __restrict__ lengths, __nv_bfloat16* __restrict__ out,
    int n_kv, int qpk, int hd, int n_pages, int bs, int max_pages,
    int n_split, float scale_log2) {
  const int hgroups = (qpk + kMaxQ - 1) / kMaxQ;
  const int h = blockIdx.y / hgroups;
  const int g0 = (blockIdx.y % hgroups) * kMaxQ;
  const int nq = min(kMaxQ, qpk - g0);
  const int b = blockIdx.z;
  const int rank = blockIdx.x;   // the block's rank in its cluster
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  extern __shared__ __align__(128) unsigned char ring_smem[];
  const int row_bytes = ring_row_bytes(hd);
  const int warp_bytes = ring_warp_bytes(hd);
  const int stage_bytes = 2 * kTile * row_bytes;
  unsigned char* ring = ring_smem + warp * warp_bytes;
  float* p_all = reinterpret_cast<float*>(ring_smem + kRingWarps * warp_bytes);
  float* p_s = p_all + warp * kMaxQ * kPRow;               // [kMaxQ][kPRow]
  float* b_acc = p_all + kRingWarps * kMaxQ * kPRow;       // [kMaxQ][hd]
  float* b_ml = b_acc + kMaxQ * hd;                        // [kMaxQ][2]
  const uint32_t ring_u32 = smem_addr(ring);

  // the walk: the live tokens in 16-token tiles, tile g to block g %
  // n_split and, within it, to its warps in turn; a warp's tiles are g =
  // first + j * stride.  Nothing here waits on the length, so the first
  // tiles' table entries load beside it.
  const int stride = n_split * kRingWarps;
  const int first = rank + n_split * warp;
  const int length_raw = lengths[b];

  // copies: lane l takes 16-byte chunks l, l + 32, ... of a tile's K rows
  // (and the same of its V rows), a row's chunks on neighbouring lanes;
  // copy i is row c_row[i] (kTile: none), element c_col[i], at byte c_dst[i]
  // of the stage
  const int cpr = hd >> 3;
  const int64_t row_stride = (int64_t)n_kv * hd;
  const int64_t page_stride = (int64_t)bs * row_stride;
  const int* table = tables + (int64_t)b * max_pages;
  const __nv_bfloat16* k_head = k_pages + (int64_t)h * hd;
  const __nv_bfloat16* v_head = v_pages + (int64_t)h * hd;
  const bool whole = bs % kTile == 0;   // a tile lies in one page
  const int width = max_pages * bs;
  int c_row[KS], c_col[KS], c_dst[KS];
#pragma unroll
  for (int i = 0; i < KS; ++i) {
    const int c = lane + 32 * i;
    const int r = c / cpr;
    c_row[i] = c < kTile * cpr ? r : kTile;
    c_col[i] = (c - r * cpr) * 8;
    c_dst[i] = r * row_bytes + (c - r * cpr) * 16;
  }

  // the page of tile g where the tile lies in one; -1 otherwise
  auto tile_page = [&](int g) {
    const int tok = g * kTile;
    return whole && tok < width
               ? min(max(__ldg(table + tok / bs), 0), n_pages - 1)
               : -1;
  };
  // tile g's copies into stage st, zeros past the length
  auto issue = [&](int g, int page, int st, int length) {
    const uint32_t kd = ring_u32 + st * stage_bytes;
    const uint32_t vd = kd + kTile * row_bytes;
    const int tok0 = g * kTile;
    const int64_t base =
        whole ? page * page_stride + (int64_t)(tok0 % bs) * row_stride : 0;
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      if (c_row[i] < kTile) {
        const int tok = tok0 + c_row[i];
        const bool ok = tok < length;
        int64_t off;
        if (whole) {
          off = base + c_row[i] * row_stride + c_col[i];
        } else {
          const int pg = ok ? min(max(__ldg(table + tok / bs), 0),
                                  n_pages - 1)
                            : 0;
          off = pg * page_stride + (int64_t)(tok % bs) * row_stride +
                c_col[i];
        }
        off = ok ? off : 0;
        cp_async16(kd + c_dst[i], k_head + off, ok);
        cp_async16(vd + c_dst[i], v_head + off, ok);
      }
    }
  };

  // q as the QK mma's B operand (k = the row's elements, n = the q heads):
  // lane l holds head l / 4, elements 2 (l % 4) + {0, 1} and + 8 of each
  // 16-element step
  const int ks = hd >> 4;
  const bool q_ok = (lane >> 2) < nq;
  const uint32_t* q_row = reinterpret_cast<const uint32_t*>(
      q + (((int64_t)b * n_kv + h) * qpk + g0 + (lane >> 2)) * hd) +
      (lane & 3);
  uint32_t qf[KS][2];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    qf[kk][0] = q_ok && kk < ks ? __ldg(q_row + kk * 8) : 0u;
    qf[kk][1] = q_ok && kk < ks ? __ldg(q_row + kk * 8 + 4) : 0u;
  }

  // the ring's first kStages - 1 tiles; then the length bounds the walk
  int pg[kStages];
#pragma unroll
  for (int j = 0; j < kStages; ++j) pg[j] = tile_page(first + j * stride);
  const int length = min(max(length_raw, 0), width);
  const int live_tiles = (length + kTile - 1) / kTile;
  const int my_tiles =
      live_tiles > first ? (live_tiles - first + stride - 1) / stride : 0;
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < my_tiles) issue(first + j * stride, pg[j], j, length);
    cp_async_commit();
  }
  int pg_next = pg[kStages - 1];

  // the warp's online softmax, m in the log2 domain.  The scores (QK mma:
  // m = 16 tokens, n = 8 heads) give lane l tokens l / 4 and l / 4 + 8 of
  // heads 2 (l % 4) and 2 (l % 4) + 1; the output (PV mma: m = 16
  // elements, n = 8 heads) gives it elements l / 4 and l / 4 + 8 of each
  // 16-element step for the same two heads, so its m, l and rescale are
  // those of its two heads
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float acc[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[kk][e] = 0.f;
  }
  const int r0 = lane >> 2;
  const int hc = (lane & 3) * 2;
  // ldmatrix of K (rows = tokens): lanes 8j .. 8j + 7 address matrix j,
  // tokens + 8 for odd j, elements + 8 for j >= 2
  const uint32_t k_off =
      ((lane & 7) + ((lane >> 3) & 1) * 8) * row_bytes + (lane >> 4) * 16;
  // ldmatrix.trans of V (rows = tokens, read as its transpose): elements
  // + 8 for odd j, tokens + 8 for j >= 2
  const uint32_t v_off = kTile * row_bytes +
                         ((lane & 7) + (lane >> 4) * 8) * row_bytes +
                         ((lane >> 3) & 1) * 16;

  for (int j = 0; j < my_tiles; ++j) {
    __syncwarp();   // every lane is done with the stage the next issue fills
    const int g_next = first + (j + kStages) * stride;
    const int pg_after = tile_page(g_next);
    if (j + kStages - 1 < my_tiles) {
      issue(first + (j + kStages - 1) * stride, pg_next,
            (j + kStages - 1) % kStages, length);
    }
    cp_async_commit();
    pg_next = pg_after;
    cp_async_wait<kStages - 1>();
    __syncwarp();

    const uint32_t st = ring_u32 + (j % kStages) * stage_bytes;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (kk < ks) {
        uint32_t a[4];
        ldmatrix_x4(a, st + k_off + kk * 32);
        mma_16816(c, a, qf[kk][0], qf[kk][1]);
      }
    }
    // scores of tokens r0 and r0 + 8 (c0, c1 and c2, c3) for heads hc and
    // hc + 1; the tile's max of each head over the 8 lanes sharing l % 4
    const int nvalid = min(kTile, length - (first + j * stride) * kTile);
    const float s0 = r0 < nvalid ? c[0] * scale_log2 : -INFINITY;
    const float s1 = r0 < nvalid ? c[1] * scale_log2 : -INFINITY;
    const float s2 = r0 + 8 < nvalid ? c[2] * scale_log2 : -INFINITY;
    const float s3 = r0 + 8 < nvalid ? c[3] * scale_log2 : -INFINITY;
    float mx0 = fmaxf(s0, s2), mx1 = fmaxf(s1, s3);
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    // token 0 of the tile is live, so the new maxima are finite
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    const float p0 = exp2f(s0 - mn0), p1 = exp2f(s1 - mn1);
    const float p2 = exp2f(s2 - mn0), p3 = exp2f(s3 - mn1);
    l0 = fmaf(l0, al0, p0 + p2);
    l1 = fmaf(l1, al1, p1 + p3);
    m0 = mn0;
    m1 = mn1;
    // p by head through shared memory: the PV mma's B operand (k = the
    // tile's tokens, n = the heads) wants lane l's tokens 2 (l % 4) + {0,
    // 1} and + 8 of head l / 4
    p_s[hc * kPRow + r0] = p0;
    p_s[(hc + 1) * kPRow + r0] = p1;
    p_s[hc * kPRow + r0 + 8] = p2;
    p_s[(hc + 1) * kPRow + r0 + 8] = p3;
    __syncwarp();
    const float* pr = p_s + r0 * kPRow + hc;
    const float2 pa = *reinterpret_cast<const float2*>(pr);
    const float2 pb = *reinterpret_cast<const float2*>(pr + 8);
    uint32_t ta[3], tb[3];
    split3(pa.x, pa.y, ta);
    split3(pb.x, pb.y, tb);
    // P.V on the tensor cores: p enters as the exact sum of three bf16
    // terms, each product exact, every sum float32
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      acc[kk][0] *= al0;
      acc[kk][1] *= al1;
      acc[kk][2] *= al0;
      acc[kk][3] *= al1;
      if (kk < ks) {
        uint32_t a[4];
        ldmatrix_x4_trans(a, st + v_off + kk * 32);
#pragma unroll
        for (int t = 0; t < 3; ++t) mma_16816(acc[kk], a, ta[t], tb[t]);
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();

  // the warp's partial, into its own ring: acc [kMaxQ][hd], then (m, l)
  // [kMaxQ]
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  float* w_acc = reinterpret_cast<float*>(ring);
  float* w_ml = w_acc + kMaxQ * hd;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    if (kk < ks) {
      const int d = kk * 16 + r0;
      w_acc[hc * hd + d] = acc[kk][0];
      w_acc[(hc + 1) * hd + d] = acc[kk][1];
      w_acc[hc * hd + d + 8] = acc[kk][2];
      w_acc[(hc + 1) * hd + d + 8] = acc[kk][3];
    }
  }
  if (lane < 4) {
    w_ml[2 * hc] = m0;
    w_ml[2 * hc + 1] = l0;
    w_ml[2 * hc + 2] = m1;
    w_ml[2 * hc + 3] = l1;
  }
  __syncthreads();

  // the block's merge over its warps; alone, the block writes the output
  const int64_t q_off = (((int64_t)b * n_kv + h) * qpk + g0) * hd;
  for (int e = tid; e < nq * hd; e += kRingThreads) {
    const int i = e / hd;
    float mw[kRingWarps];
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kRingWarps; ++w) {
      const float* wp =
          reinterpret_cast<const float*>(ring_smem + w * warp_bytes);
      mw[w] = wp[kMaxQ * hd + 2 * i];
      mx = fmaxf(mx, mw[w]);
    }
    const float use = mx == -INFINITY ? 0.f : mx;
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < kRingWarps; ++w) {
      const float* wp =
          reinterpret_cast<const float*>(ring_smem + w * warp_bytes);
      const float c = exp2f(mw[w] - use);
      ll = fmaf(c, wp[kMaxQ * hd + 2 * i + 1], ll);
      aa = fmaf(c, wp[e], aa);
    }
    if (n_split == 1) {
      out[q_off + e] = __float2bfloat16(aa / fmaxf(ll, 1e-30f));
    } else {
      b_acc[e] = aa;
      if (e == i * hd) {
        b_ml[2 * i] = mx;
        b_ml[2 * i + 1] = ll;
      }
    }
  }
  if (n_split == 1) return;

  // the cluster's merge, its outputs spread over the blocks: each reads
  // every block's (m, l) of its head and its element of acc from
  // distributed shared memory, all loads in flight together
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int e = rank * kRingThreads + tid; e < nq * hd;
       e += n_split * kRingThreads) {
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
    out[q_off + e] = __float2bfloat16(aa / fmaxf(ll, 1e-30f));
  }
  // no block leaves while another may still read its shared memory
  cluster.sync();
}

template <int KS>
int launch_ring(const void* q, const void* k_pages, const void* v_pages,
                const void* tables, const void* lengths, void* out,
                int batch, int n_kv, int qpk, int hd, int n_pages, int bs,
                int max_pages, int n_split, float scale,
                cudaStream_t stream) {
  // the shared-memory opt-in, once a device, for the instantiation's
  // widest row
  static bool opted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(paged_split_kernel_ring<KS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)ring_smem_bytes(16 * KS));
    if (err != cudaSuccess) return (int)err;
    opted[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, n_kv * ((qpk + kMaxQ - 1) / kMaxQ), batch);
  cfg.blockDim = dim3(kRingThreads, 1, 1);
  cfg.dynamicSmemBytes = ring_smem_bytes(hd);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = n_split > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(
      &cfg, paged_split_kernel_ring<KS>,
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_pages),
      static_cast<const __nv_bfloat16*>(v_pages),
      static_cast<const int*>(tables), static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(out), n_kv, qpk, hd, n_pages, bs,
      max_pages, n_split, scale * 1.4426950408889634f);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int launch_bf16(const void* q, const void* k_pages, const void* v_pages,
                const void* tables, const void* lengths, void* out, int batch,
                int n_kv, int qpk, int hd, int n_pages, int bs, int max_pages,
                int n_split, float scale, cudaStream_t stream) {
#define REPRO_RING(KS)                                                      \
  launch_ring<KS>(q, k_pages, v_pages, tables, lengths, out, batch, n_kv,   \
                  qpk, hd, n_pages, bs, max_pages, n_split, scale, stream)
  if (hd <= 64) return REPRO_RING(4);
  if (hd <= 128) return REPRO_RING(8);
  return REPRO_RING(16);
#undef REPRO_RING
}

int launch_f32(const void* q, const void* k_pages, const void* v_pages,
               const void* tables, const void* lengths, void* out, int batch,
               int n_kv, int qpk, int hd, int n_pages, int bs, int max_pages,
               int n_split, float scale, cudaStream_t stream) {
  // the table's width in n_split ranges, none wholly past it
  const int per = (max_pages + n_split - 1) / n_split;
  n_split = (max_pages + per - 1) / per;
  if (qpk == 1) {
    return launch_qt<float, 1>(q, k_pages, v_pages, tables, lengths, out,
                               batch, n_kv, qpk, hd, n_pages, bs, max_pages,
                               n_split, per, scale, stream);
  }
  if (qpk == 2) {
    return launch_qt<float, 2>(q, k_pages, v_pages, tables, lengths, out,
                               batch, n_kv, qpk, hd, n_pages, bs, max_pages,
                               n_split, per, scale, stream);
  }
  return launch_qt<float, 4>(q, k_pages, v_pages, tables, lengths, out,
                             batch, n_kv, qpk, hd, n_pages, bs, max_pages,
                             n_split, per, scale, stream);
}

}  // namespace
}  // namespace repro_torch

// n_split blocks (one cluster where n_split > 1) per (sequence, kv head,
// group of q heads); n_split comes from the wrapper's planner (`split_plan`
// in kernels/paged_attention.py).  bf16 deals the live tokens' tiles over
// the blocks, float32 splits the table's width.  Returns the cudaError_t
// of the launch (0 on success).
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages, const void* tables,
                                      const void* lengths, void* out,
                                      int batch, int n_kv, int qpk, int hd,
                                      int n_pages, int bs, int max_pages,
                                      int is_bf16, void* stream, float scale,
                                      int n_split) {
  if (hd % 16 || hd > repro_torch::kMaxHd || n_split < 1 ||
      n_split > repro_torch::kMaxSplit || max_pages < 1 || bs < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return repro_torch::launch_bf16(q, k_pages, v_pages, tables, lengths,
                                    out, batch, n_kv, qpk, hd, n_pages, bs,
                                    max_pages, n_split, scale, s);
  }
  return repro_torch::launch_f32(q, k_pages, v_pages, tables, lengths, out,
                                 batch, n_kv, qpk, hd, n_pages, bs, max_pages,
                                 n_split, scale, s);
}
