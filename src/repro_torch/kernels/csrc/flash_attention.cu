// Causal (optionally sliding-window) GQA flash attention for Hopper
// (sm_90a), the prefill path.
//
// Replaces the Pallas TPU kernel `flash_attention` of the JAX package
// (src/repro/kernels/flash_attention.py, function `flash_attention`, body
// `_kernel`): q tiles stay resident while K/V tiles stream past with an
// online softmax; tiles wholly above the diagonal or left of the window are
// skipped; rows whose every key in a tile is masked keep m = -inf and are
// guarded (no exp of -inf - -inf); l is floored at 1e-30.
//
// Layouts: q and out are (B, nh, S, hd) and k/v are (B, n_kv, S, hd), each
// given by strides in elements for (batch, head, sequence) with hd
// contiguous and every row on a 16-byte boundary, so the caller passes
// (B, S, n, hd) tensors transposed as views without a copy.  The kv head
// of q head h is h / qpk.  q is not pre-scaled: the kernel multiplies the
// f32 scores by `scale` (hd^-0.5).
//
// Bound.  At granite-3-2b's largest prefill (B 8, S 512, 32 q / 8 kv
// heads, hd 64, bf16) the causal products are 8.6 GFLOP, 8.7 us at the
// bf16 tensor-core peak, and the bytes (q and out 16.8 MB each, k and v
// 4.2 MB each) 12.5 us at 3.35 TB/s: the call is bound by bytes, with
// the tensor cores close behind.
//
// Two instantiations, chosen by the launcher's explicit rule
// (`flash_path` in kernels/flash_attention.py):
//
// * tensor_core: bf16 with hd in {32, 64, 128} and S % 64 == 0.  A work
//   item is a 64-row q tile of `heads` q heads that share a kv head (4 at
//   granite; 2 at hd 128, whose output accumulator would not fit the
//   registers of 4 warpgroups) for one batch row; items are ordered longest
//   causal rows first.  The grid is persistent, one block an SM walking its
//   share of the items: one consumer warpgroup per q head and one producer
//   warp.  The producer keeps two q buffers and a ring of four K/V stages
//   full by TMA over 4-D tensor maps (hd, heads, S, B) with the 128-byte
//   swizzle (64-byte at hd 32), signalled by mbarriers, refilling a buffer
//   once every warpgroup has released it; so each K/V tile crosses into
//   shared memory once for all the heads, and the next item's q and K/V
//   tiles arrive while the current item computes.  S = Q K^T is a chain of
//   wgmma m64n64k16 with both operands in shared memory (K-major
//   descriptors matching the TMA swizzle); the online softmax runs on the
//   f32 accumulator fragments (a row lives in the four threads of a quad:
//   max and sum reduce over shuffles 1 and 2), with the scale folded into
//   the exponent's FMA; P goes to bf16 in registers and O += P V is a
//   wgmma with A from registers and B the V tile read MN-major (transpose
//   bit set).  The normalised output goes back through the warpgroup's q
//   buffer, in the tensor map's swizzled layout, and out by TMA stores.
// * cuda_core: every other input (float32, where TF32 would break the
//   2e-5 parity of the float32 engines, and bf16 at any other hd or S).
//   One block per (q tile, q head, batch row) keeps its q tile and an f32
//   accumulator in shared memory and does its products in f32 on the CUDA
//   cores; its ragged edge is masked, so any S runs.

#include <cuda.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace repro_torch {
namespace {

// ---------------------------------------------------------------------------
// cuda_core: f32 products on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_prefill_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int seq, int qpk, int hd, int window, int bq, int bk,
    float scale, int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb,
    int64_t k_sh, int64_t k_ss, int64_t o_sb, int64_t o_sh, int64_t o_ss) {
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
        s *= scale;
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
           int nh, int seq, int qpk, int hd, int window, float scale,
           const int64_t* st, cudaStream_t stream) {
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
      tile, tile, scale, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8]);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// tensor_core: wgmma products, TMA copies, bf16
// ---------------------------------------------------------------------------

namespace tc {

using namespace hopper;

constexpr int kRows = 64;    // q rows of a warpgroup's tile; kv tokens a tile
constexpr int kStages = 4;   // K/V ring depth

template <int HD>
__device__ __forceinline__ void wgmma_rs(float (&d)[HD / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (HD == 32) {
    wgmma_rs_n32(d, a, db);
  } else if constexpr (HD == 64) {
    wgmma_rs_n64(d, a, db);
  } else {
    wgmma_rs_n128(d, a, db);
  }
}

template <int HD>
struct Layout {
  static constexpr int kSwizzle = HD >= 64 ? 128 : 64;  // bytes of an atom row
  static constexpr int kColBlock = kRows * kSwizzle;  // 64-row column block
  static constexpr int kTile = HD * 2 / kSwizzle * kColBlock;  // 64 x HD bf16
};

template <int HD, int WG>
constexpr size_t smem_bytes() {
  // 1 KB of slack to align the swizzled tiles, two buffers of WG q tiles,
  // kStages K/V tile pairs, and the mbarriers (q full and empty per
  // buffer; K/V full and empty per stage)
  return 1024 + (size_t)(2 * WG + 2 * kStages) * Layout<HD>::kTile +
         8 * (4 + 2 * kStages);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One work item: a 64-row q tile of WG q heads that share a kv head, for
// one batch row.  Items are numbered longest causal rows first, and block
// j of G takes item r * G + j in even rounds r and r * G + G - 1 - j in
// odd ones, which evens out the blocks' work.
struct Item {
  int iq, hk, hq0, b, kt0, n_kt;
};

__device__ __forceinline__ int item_index(int r, int j, int G) {
  return r * G + ((r & 1) ? G - 1 - j : j);
}

__device__ __forceinline__ Item item_at(int w, int n_qt, int batch, int qpk,
                                        int WG, int n_kv, int window) {
  const int groups = qpk / WG;
  const int per_tile = n_kv * groups;   // items of one q tile and batch row
  Item it;
  const int batch_items = w / per_tile; // q tile index (longest first) x B
  const int rem = w - batch_items * per_tile;
  it.hk = rem / groups;
  it.hq0 = it.hk * qpk + (rem - it.hk * groups) * WG;
  it.b = batch_items % batch;
  it.iq = n_qt - 1 - batch_items / batch;
  const int q0 = it.iq * kRows;
  // kv tiles from the window's first tile up to the diagonal
  it.kt0 = window > 0 ? max(0, q0 - window + 1) / kRows : 0;
  it.n_kt = it.iq - it.kt0 + 1;
  return it;
}

// WG consumer warpgroups, then one producer warp.  The grid is persistent:
// gridDim.x blocks walk the items, so the producer loads the next item's
// q and K/V tiles while the consumers still work on the current one.
template <int HD, int WG>
__global__ void __launch_bounds__(WG * 128 + 32, 1) flash_tc_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_o, int n_qt, int batch, int n_kv,
    int qpk, int window, float scale_log2) {
  using L = Layout<HD>;
  constexpr int SW = L::kSwizzle;
  constexpr int CB = HD * 2 / SW;    // column blocks of a tile
  constexpr int KSTEPS = HD / 16;    // k16 steps of Q K^T
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_s = base;                       // 2 buffers x WG tiles
  uint8_t* kv_s = base + 2 * WG * L::kTile;  // stage s: K tile, then V tile
  uint64_t* bars = reinterpret_cast<uint64_t*>(kv_s + 2 * kStages * L::kTile);
  uint64_t* q_full = bars;                   // [2]
  uint64_t* q_empty = bars + 2;              // [2]
  uint64_t* kv_full = bars + 4;              // [kStages]
  uint64_t* kv_empty = bars + 4 + kStages;   // [kStages]

  const int n_items = n_qt * batch * n_kv * (qpk / WG);
  const int G = gridDim.x;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], WG);
    }
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&kv_full[i], 1);
      mbar_init(&kv_empty[i], WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= WG * 128) {
    // the producer warp: one thread keeps the q buffers and the K/V ring
    // full, refilling a buffer once every warpgroup has released it
    if (tid == WG * 128) {
      int tile = 0;
      for (int r = 0, j = 0;; ++r, ++j) {
        const int w = item_index(r, blockIdx.x, G);
        if (w >= n_items) break;
        const Item it = item_at(w, n_qt, batch, qpk, WG, n_kv, window);
        const int qb = j & 1;
        if (j >= 2) mbar_wait(&q_empty[qb], ((j >> 1) - 1) & 1);
        mbar_expect_tx(&q_full[qb], WG * L::kTile);
        for (int h = 0; h < WG; ++h) {
#pragma unroll
          for (int cb = 0; cb < CB; ++cb) {
            tma_load(q_s + (qb * WG + h) * L::kTile + cb * L::kColBlock,
                     &tm_q, &q_full[qb], cb * (SW / 2), it.hq0 + h,
                     it.iq * kRows, it.b);
          }
        }
        for (int i = 0; i < it.n_kt; ++i, ++tile) {
          const int stage = tile % kStages;
          if (tile >= kStages) {
            mbar_wait(&kv_empty[stage], (tile / kStages - 1) & 1);
          }
          uint8_t* dst = kv_s + stage * 2 * L::kTile;
          mbar_expect_tx(&kv_full[stage], 2 * L::kTile);
#pragma unroll
          for (int cb = 0; cb < CB; ++cb) {
            tma_load(dst + cb * L::kColBlock, &tm_k, &kv_full[stage],
                     cb * (SW / 2), it.hk, (it.kt0 + i) * kRows, it.b);
            tma_load(dst + L::kTile + cb * L::kColBlock, &tm_v,
                     &kv_full[stage], cb * (SW / 2), it.hk,
                     (it.kt0 + i) * kRows, it.b);
          }
        }
      }
    }
    return;
  }

  // accumulator fragments: warp w of the warpgroup owns rows 16w .. 16w+15;
  // a thread holds rows r0 and r0 + 8, columns 8j + 2t and 8j + 2t + 1
  const int wg = tid / 128;
  const int lane = tid & 31;
  const int r0 = ((tid & 127) >> 5) * 16 + (lane >> 2);
  const int t2 = (lane & 3) * 2;
  int tile = 0;
  for (int r = 0, j = 0;; ++r, ++j) {
    const int w = item_index(r, blockIdx.x, G);
    if (w >= n_items) break;
    const Item it = item_at(w, n_qt, batch, qpk, WG, n_kv, window);
    const int q0 = it.iq * kRows;
    const int qi0 = q0 + r0;
    const int qi1 = qi0 + 8;
    const int qb = j & 1;
    const uint32_t q_addr = smem_u32(q_s + (qb * WG + wg) * L::kTile);
    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    // m is the running max of the raw scores; the scale goes into the
    // exponent's FMA
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    mbar_wait(&q_full[qb], (j >> 1) & 1);

    for (int i = 0; i < it.n_kt; ++i, ++tile) {
      const int stage = tile % kStages;
      const int kt = it.kt0 + i;
      mbar_wait(&kv_full[stage], (tile / kStages) & 1);
      const uint32_t k_addr = smem_u32(kv_s + stage * 2 * L::kTile);
      const uint32_t v_addr = k_addr + L::kTile;

      // S = Q K^T: k16 steps walk 32 bytes along the swizzled rows, then on
      // to the next column block
      float s[32];
#pragma unroll
      for (int c = 0; c < 32; ++c) s[c] = 0.f;
      hold(s);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const uint32_t off = (kk * 32) / SW * L::kColBlock + (kk * 32) % SW;
        wgmma_ss_n64<0, 0>(s, desc<SW>(q_addr + off, 16, 8 * SW),
                     desc<SW>(k_addr + off, 16, 8 * SW), kk > 0);
      }
      wg_commit();
      wg_wait_all();
      hold(s);

      // mask the diagonal tile and the window's left edge
      const int k0 = kt * kRows;
      if (kt == it.iq || (window > 0 && k0 <= q0 + kRows - 1 - window)) {
#pragma unroll
        for (int c = 0; c < 32; ++c) {
          const int qi = (c & 2) ? qi1 : qi0;
          const int kj = k0 + 8 * (c >> 2) + t2 + (c & 1);
          if (kj > qi || (window > 0 && kj <= qi - window)) s[c] = -INFINITY;
        }
      }
      // online softmax over the quad that holds each row
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int c = 0; c < 32; c += 4) {
        mx0 = fmaxf(mx0, fmaxf(s[c], s[c + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[c + 2], s[c + 3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      // fully masked so far: m stays -inf and every p is 0
      const float u0 = mx0 == -INFINITY ? 0.f : mx0 * scale_log2;
      const float u1 = mx1 == -INFINITY ? 0.f : mx1 * scale_log2;
      const float a0 = ex2(m0 * scale_log2 - u0);   // 0 while m is -inf
      const float a1 = ex2(m1 * scale_log2 - u1);
      m0 = mx0;
      m1 = mx1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int c = 0; c < 32; c += 4) {
        s[c] = ex2(fmaf(s[c], scale_log2, -u0));
        s[c + 1] = ex2(fmaf(s[c + 1], scale_log2, -u0));
        s[c + 2] = ex2(fmaf(s[c + 2], scale_log2, -u1));
        s[c + 3] = ex2(fmaf(s[c + 3], scale_log2, -u1));
        sum0 += s[c] + s[c + 1];
        sum1 += s[c + 2] + s[c + 3];
      }
      // l stays a per-thread partial sum: every thread of a quad scales it
      // by the same alpha, so the quad's sum is taken once at the end
      l0 = l0 * a0 + sum0;
      l1 = l1 * a1 + sum1;
#pragma unroll
      for (int c = 0; c < HD / 2; c += 4) {
        o[c] *= a0;
        o[c + 1] *= a0;
        o[c + 2] *= a1;
        o[c + 3] *= a1;
      }
      // O += P V, P as bf16 A fragments: k16 step kk takes columns 16kk ..
      // 16kk + 15, i.e. accumulator registers 8kk .. 8kk + 7
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          pa[kk][q] = pack_bf16(s[8 * kk + 2 * q], s[8 * kk + 2 * q + 1]);
        }
      }
      hold(o);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // V tile read MN-major: 16 token rows per step, column blocks
        // apart by one 64-row block
        wgmma_rs<HD>(o, pa[kk],
                     desc<SW>(v_addr + kk * 16 * SW, L::kColBlock, 8 * SW));
      }
      wg_commit();
      wg_wait_all();
      hold(o);

      // this warpgroup is done with the stage
      if ((tid & 127) == 0) mbar_arrive(&kv_empty[stage]);
    }

    // epilogue: the normalised tile goes into this warpgroup's q buffer,
    // which the last Q K^T has finished reading, in the swizzled layout of
    // the tensor map, and leaves by one TMA store per column block
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / fmaxf(l0, 1e-30f);
    const float inv1 = 1.f / fmaxf(l1, 1e-30f);
    uint8_t* o_s = q_s + (qb * WG + wg) * L::kTile;
#pragma unroll
    for (int c = 0; c < HD / 2; c += 4) {
      const int col = 2 * c + t2;                  // 8j + 2t, j = c / 4
      const int cb = col / (SW / 2);
      const int chunk = (col % (SW / 2)) / 8;      // 16-byte chunk of a row
      const int in_chunk = (col % 8) * 2;
      *reinterpret_cast<__nv_bfloat162*>(
          o_s + cb * L::kColBlock + r0 * SW +
          ((chunk ^ swizzle_row<SW>(r0)) * 16) + in_chunk) =
          __floats2bfloat162_rn(o[c] * inv0, o[c + 1] * inv0);
      *reinterpret_cast<__nv_bfloat162*>(
          o_s + cb * L::kColBlock + (r0 + 8) * SW +
          ((chunk ^ swizzle_row<SW>(r0 + 8)) * 16) + in_chunk) =
          __floats2bfloat162_rn(o[c + 2] * inv1, o[c + 3] * inv1);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    if ((tid & 127) == 0) {
#pragma unroll
      for (int cb = 0; cb < CB; ++cb) {
        tma_store(&tm_o, o_s + cb * L::kColBlock, cb * (SW / 2),
                  it.hq0 + wg, q0, it.b);
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      // the buffer is free for the next q once the store has read it
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      mbar_arrive(&q_empty[qb]);
    }
  }
  if ((tid & 127) == 0) {
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

template <int HD, int WG>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int nh, int n_kv, int seq, int window, float scale,
           const int64_t* st, cudaStream_t stream) {
  constexpr int SW = Layout<HD>::kSwizzle;
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  int err = make_map(&tm_q, q, HD, nh, seq, batch, st[0], st[1], st[2], SW);
  if (!err) {
    err = make_map(&tm_k, k, HD, n_kv, seq, batch, st[3], st[4], st[5], SW);
  }
  if (!err) {
    err = make_map(&tm_v, v, HD, n_kv, seq, batch, st[3], st[4], st[5], SW);
  }
  if (!err) {
    err = make_map(&tm_o, out, HD, nh, seq, batch, st[6], st[7], st[8], SW);
  }
  if (err) return err;
  constexpr size_t smem = smem_bytes<HD, WG>();
  cudaError_t e = allow_smem(flash_tc_kernel<HD, WG>, smem);
  if (e != cudaSuccess) return (int)e;
  int device = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&device);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, flash_tc_kernel<HD, WG>, WG * 128 + 32, smem);
  }
  if (e != cudaSuccess) return (int)e;
  const int qpk = nh / n_kv;
  const int n_qt = seq / kRows;
  const int n_items = n_qt * batch * n_kv * (qpk / WG);
  const int grid = min(n_items, max(per_sm, 1) * sms);
  flash_tc_kernel<HD, WG><<<grid, WG * 128 + 32, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_o, n_qt, batch, n_kv, qpk, window,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_heads(int heads, const void* q, const void* k, const void* v,
                 void* out, int batch, int nh, int n_kv, int seq, int window,
                 float scale, const int64_t* st, cudaStream_t stream) {
  switch (heads) {
    case 1:
      return launch<HD, 1>(q, k, v, out, batch, nh, n_kv, seq, window, scale,
                           st, stream);
    case 2:
      return launch<HD, 2>(q, k, v, out, batch, nh, n_kv, seq, window, scale,
                           st, stream);
    case 4:
      if constexpr (HD <= 64) {
        return launch<HD, 4>(q, k, v, out, batch, nh, n_kv, seq, window,
                             scale, st, stream);
      }
      return (int)cudaErrorInvalidValue;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tc
}  // namespace
}  // namespace repro_torch

// strides: 9 int64 in elements, (batch, head, seq) for q, k/v, out.
// tc_heads: 0 takes the cuda_core kernel; 1, 2 or 4 the tensor_core kernel
// with that many q heads (warpgroups) per block, for bf16 at hd 32, 64 or
// 128 and seq % 64 == 0 only.  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int batch,
                                      int nh, int seq, int qpk, int hd,
                                      int window, const int64_t* strides,
                                      int is_bf16, void* stream, float scale,
                                      int tc_heads) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tc_heads) {
    if (!is_bf16 || seq % repro_torch::tc::kRows || qpk % tc_heads) {
      return (int)cudaErrorInvalidValue;
    }
    const int n_kv = nh / qpk;
    switch (hd) {
      case 32:
        return repro_torch::tc::launch_heads<32>(
            tc_heads, q, k, v, out, batch, nh, n_kv, seq, window, scale,
            strides, s);
      case 64:
        return repro_torch::tc::launch_heads<64>(
            tc_heads, q, k, v, out, batch, nh, n_kv, seq, window, scale,
            strides, s);
      case 128:
        return repro_torch::tc::launch_heads<128>(
            tc_heads, q, k, v, out, batch, nh, n_kv, seq, window, scale,
            strides, s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (is_bf16) {
    return repro_torch::launch<__nv_bfloat16>(q, k, v, out, batch, nh, seq,
                                              qpk, hd, window, scale,
                                              strides, s);
  }
  return repro_torch::launch<float>(q, k, v, out, batch, nh, seq, qpk, hd,
                                    window, scale, strides, s);
}
