// GQA attention of a chunk of queries at an offset against a slot cache,
// for Hopper (sm_90a): chunked prefill's attention.
//
// Replaces no Pallas kernel.  The JAX package's chunked prefill
// (src/repro/models/transformer.py, `dense_block_chunk`) computes it as
// plain jnp (`attention_any`), which the port ran as plain PyTorch: float32
// logits of (B, n_kv, qpk, S, T) written to device memory, then scaled,
// masked and softmaxed in passes over them.  This kernel computes
//
//   attention_any(q, k, v, window, q_positions=positions,
//                 kv_positions=kv_pos, kv_valid=kv_pos >= 0)
//
// for q (B, S, nh, hd) and a cache k, v (B, T, n_kv, hd): the query at
// position p of row b attends key j iff kv_pos[b, j] >= 0, kv_pos[b, j] <=
// p and (window == 0 or kv_pos[b, j] > p - window), with the f32 scores
// scaled by `scale` (hd^-0.5; q is not pre-scaled) and P cast to bf16
// before P V, where the plain attention casts its probabilities.
//
// Preconditions, which the engine's slot cache keeps: positions rise along
// each row of `positions` (B, S), and a valid key sits at the row of its
// position (kv_pos[b, j] is j or negative).  So the keys that a 64-row q
// tile can attend lie in cache rows [first - window + 1, last] of its first
// and last positions, and the walk covers those tiles only: it stops at the
// chunk's end, not at T.  Inside them every score is masked by kv_pos
// itself, so validity is never inferred from lengths.  A query with no
// valid key gets 0 (l floored at 1e-30), where the plain attention gives
// the mean of V under its -1e30 fill; a chunked prefill has none, since
// every row's key 0 is valid.
//
// Bound.  At h2o-danube-1.8b's closed-cell chunk (B 32, S 512 at offset
// 512, T 1,024, 32 q / 8 kv heads, hd 80, bf16): q, K/V and out are 84 MB
// each, 75 us at 3.35 TB/s; the attended pairs are 4 * 32 * 32 * 80 *
// (512 * 768) = 1.3e11 FLOP, 130 us at 989 TFLOP/s: bound by operations.
//
// Design: flash_tc_kernel's (flash_attention.cu), the pieces of which it
// shares through flash_tc.cuh.  A persistent grid, one producer warp and
// one consumer warpgroup per q head of a group that shares a kv head
// (`tc_heads`: 4 up to hd 64, else 2); q tiles and a ring of K/V tiles by
// TMA in the 128-byte swizzle (hd 80's last 16 columns as a block of their
// own in the 32-byte one); S = Q K^T and O += P V by wgmma; the online
// softmax on the f32 accumulator fragments.  What differs:
//
// * q and out are (B, S) tiles and the cache (B, T) ones, each through its
//   own tensor maps;
// * an item's key tiles come from its q tile's first and last positions,
//   which the producer reads and hands to the consumers in shared memory
//   beside the q buffer;
// * each K/V stage also carries the tile's 64 kv_pos entries, by TMA over
//   a 1-D map of kv_pos's whole storage, so any T and any row offset: a
//   TMA box starts on a 16-byte boundary, so the box is 68 entries from
//   the tile's first entry rounded down to a multiple of four, and the
//   consumers read it from that shift; entries past T (the next row's, or
//   the storage's zero fill) are masked by the key's row.
//
// The name of the kernel function must not contain `flash_tc_kernel` or
// `flash_prefill_kernel`: the benchmark pairs device kernels of those names
// with the calls of the one-shot prefill.

#include <cuda.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "flash_tc.cuh"
#include "hopper.cuh"

namespace repro_torch {
namespace {
namespace tc {

using namespace hopper;

// a K/V tile's kv_pos entries: a box of 68 from a 16-byte boundary, in a
// slot of 384 bytes (TMA writes shared memory on 128-byte boundaries)
constexpr int kPosBox = kRows + 4;
constexpr int kPosBytes = kPosBox * 4;
constexpr int kPosPitch = 96;   // ints

template <int HD, int WG>
constexpr size_t chunk_smem_bytes() {
  // flash's q buffers, K/V ring and mbarriers, plus a kv_pos slot per
  // stage and the two q buffers' key walks (first tile, tile count)
  return smem_bytes<HD, WG>() + kStages * kPosPitch * 4 + 16;
}

// positions (B, S) int64 and kv_pos's storage, by strides in elements
struct ChunkArgs {
  const int64_t* pos;
  int64_t p_sb, p_ss;      // positions: batch, sequence
  int64_t kv_off, kv_sb;   // kv_pos in its storage: offset, batch stride
  int t_len;               // cache rows T
};

// item w's q tile, heads and batch row, ordered as flash_tc_kernel's: last
// q tiles (the most keys) first
__device__ __forceinline__ Item chunk_item(int w, int n_qt, int batch,
                                           int qpk, int WG, int n_kv) {
  const int groups = qpk / WG;
  const int per_tile = n_kv * groups;
  Item it;
  const int batch_items = w / per_tile;
  const int rem = w - batch_items * per_tile;
  it.hk = rem / groups;
  it.hq0 = it.hk * qpk + (rem - it.hk * groups) * WG;
  it.b = batch_items % batch;
  it.iq = n_qt - 1 - batch_items / batch;
  it.kt0 = it.n_kt = 0;
  return it;
}

// the key tiles that the q tile's rows can attend: cache rows from the
// window's left edge at the first position to the last position
__device__ __forceinline__ void key_walk(Item& it, const ChunkArgs& a,
                                         int window) {
  const int64_t* row = a.pos + it.b * a.p_sb + (int64_t)it.iq * kRows * a.p_ss;
  const int64_t first = row[0];
  const int64_t last = row[(kRows - 1) * a.p_ss];
  const int64_t hi = last + 1 < a.t_len ? last + 1 : a.t_len;
  const int64_t lo = window > 0 && first - window + 1 > 0
                         ? first - window + 1 : 0;
  it.kt0 = (int)(lo / kRows);
  it.n_kt = hi > lo ? (int)((hi + kRows - 1) / kRows) - it.kt0 : 0;
}

// WG consumer warpgroups, then one producer warp.
template <int HD, int WG>
__global__ void __launch_bounds__(WG * 128 + 32, 1) chunk_tc_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_o,
    const __grid_constant__ CUtensorMap tm_kvpos, int n_qt, int batch,
    int n_kv, int qpk, int window, float scale_log2,
    const __grid_constant__ TailMaps tail, const ChunkArgs args) {
  using L = Layout<HD>;
  constexpr int SW = L::kSwizzle;
  constexpr int CB = L::kMain;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_s = base;                       // 2 buffers x WG tiles
  uint8_t* kv_s = base + 2 * WG * L::kTile;  // stage s: K tile, then V tile
  int* kvpos_s = reinterpret_cast<int*>(kv_s + 2 * kStages * L::kTile);
  int* walk_s = kvpos_s + kStages * kPosPitch;   // [2][2]: kt0, n_kt
  uint64_t* bars = reinterpret_cast<uint64_t*>(walk_s + 4);
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
    // the producer: one thread reads each item's key walk, hands it on
    // beside the q buffer (released by the q buffer's arrival) and keeps
    // the q buffers and the K/V ring full
    if (tid == WG * 128) {
      int tile = 0;
      for (int r = 0, j = 0;; ++r, ++j) {
        const int w = item_index(r, blockIdx.x, G);
        if (w >= n_items) break;
        Item it = chunk_item(w, n_qt, batch, qpk, WG, n_kv);
        key_walk(it, args, window);
        const int qb = j & 1;
        if (j >= 2) mbar_wait(&q_empty[qb], ((j >> 1) - 1) & 1);
        walk_s[2 * qb] = it.kt0;
        walk_s[2 * qb + 1] = it.n_kt;
        mbar_expect_tx(&q_full[qb], WG * L::kTile);
        for (int h = 0; h < WG; ++h) {
#pragma unroll
          for (int cb = 0; cb < CB; ++cb) {
            tma_load(q_s + (qb * WG + h) * L::kTile + cb * L::kColBlock,
                     &tm_q, &q_full[qb], cb * (SW / 2), it.hq0 + h,
                     it.iq * kRows, it.b);
          }
          if constexpr (L::kTailCols > 0) {
            tma_load(q_s + (qb * WG + h) * L::kTile + L::kTailOff, &tail.q,
                     &q_full[qb], 0, it.hq0 + h, it.iq * kRows, it.b);
          }
        }
        for (int i = 0; i < it.n_kt; ++i, ++tile) {
          const int stage = tile % kStages;
          if (tile >= kStages) {
            mbar_wait(&kv_empty[stage], (tile / kStages - 1) & 1);
          }
          const int row = (it.kt0 + i) * kRows;
          uint8_t* dst = kv_s + stage * 2 * L::kTile;
          mbar_expect_tx(&kv_full[stage], 2 * L::kTile + kPosBytes);
#pragma unroll
          for (int cb = 0; cb < CB; ++cb) {
            tma_load(dst + cb * L::kColBlock, &tm_k, &kv_full[stage],
                     cb * (SW / 2), it.hk, row, it.b);
            tma_load(dst + L::kTile + cb * L::kColBlock, &tm_v,
                     &kv_full[stage], cb * (SW / 2), it.hk, row, it.b);
          }
          if constexpr (L::kTailCols > 0) {
            tma_load(dst + L::kTailOff, &tail.k, &kv_full[stage], 0, it.hk,
                     row, it.b);
            tma_load(dst + L::kTile + L::kTailOff, &tail.v, &kv_full[stage],
                     0, it.hk, row, it.b);
          }
          tma_load_1d(kvpos_s + stage * kPosPitch, &tm_kvpos,
                      &kv_full[stage],
                      (int)(args.kv_off + it.b * args.kv_sb + row) & ~3);
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
    Item it = chunk_item(w, n_qt, batch, qpk, WG, n_kv);
    const int q0 = it.iq * kRows;
    // the positions of this thread's two rows
    const int64_t* prow = args.pos + it.b * args.p_sb + (q0 + r0) * args.p_ss;
    const int p0 = (int)prow[0];
    const int p1 = (int)prow[8 * args.p_ss];
    // where the row's kv_pos entries start in each box (k0 is a multiple
    // of four)
    const int shift = (int)((args.kv_off + it.b * args.kv_sb) & 3);
    const int qb = j & 1;
    const uint32_t q_addr = smem_u32(q_s + (qb * WG + wg) * L::kTile);
    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    // m is the running max of the raw scores; the scale goes into the
    // exponent's FMA
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    mbar_wait(&q_full[qb], (j >> 1) & 1);
    it.kt0 = walk_s[2 * qb];
    it.n_kt = walk_s[2 * qb + 1];

    for (int i = 0; i < it.n_kt; ++i, ++tile) {
      const int stage = tile % kStages;
      mbar_wait(&kv_full[stage], (tile / kStages) & 1);
      const uint32_t k_addr = smem_u32(kv_s + stage * 2 * L::kTile);
      const uint32_t v_addr = k_addr + L::kTile;

      float s[32];
      qk_tile<HD>(s, q_addr, k_addr);

      // mask every score by its key's kv_pos: valid, not after the query,
      // inside its window; a key past the cache's last row is never valid
      const int* kp = kvpos_s + stage * kPosPitch + shift;
      const int k0 = (it.kt0 + i) * kRows;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const int col = 8 * (c >> 2) + t2 + (c & 1);
        const int kv = k0 + col < args.t_len ? kp[col] : -1;
        const int p = (c & 2) ? p1 : p0;
        if (kv < 0 || kv > p || (window > 0 && kv <= p - window)) {
          s[c] = -INFINITY;
        }
      }
      softmax_pv<HD>(s, o, m0, m1, l0, l1, scale_log2, v_addr);

      // this warpgroup is done with the stage and its kv_pos entries
      if ((tid & 127) == 0) mbar_arrive(&kv_empty[stage]);
    }

    // epilogue: the normalised tile through this warpgroup's q buffer, in
    // the tensor maps' swizzled layout, out by TMA stores
    uint8_t* o_s = q_s + (qb * WG + wg) * L::kTile;
    store_tile<HD>(o, l0, l1, o_s, r0, t2);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    if ((tid & 127) == 0) {
#pragma unroll
      for (int cb = 0; cb < CB; ++cb) {
        tma_store(&tm_o, o_s + cb * L::kColBlock, cb * (SW / 2),
                  it.hq0 + wg, q0, it.b);
      }
      if constexpr (L::kTailCols > 0) {
        tma_store(&tail.o, o_s + L::kTailOff, 0, it.hq0 + wg, q0, it.b);
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      mbar_arrive(&q_empty[qb]);
    }
  }
  if ((tid & 127) == 0) {
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

template <int HD, int WG>
int launch(const void* q, const void* k, const void* v, const void* kv_pos,
           void* out, int batch, int nh, int n_kv, int seq, int window,
           float scale, const int64_t* st, const ChunkArgs& args,
           int64_t kv_numel, cudaStream_t stream) {
  const int t = args.t_len;
  CUtensorMap tm_q, tm_k, tm_v, tm_o, tm_kvpos;
  TailMaps tail = {};
  int err = make_tile_maps<HD>(&tm_q, &tail.q, q, nh, seq, batch, st);
  if (!err) {
    err = make_tile_maps<HD>(&tm_k, &tail.k, k, n_kv, t, batch, st + 3);
  }
  if (!err) {
    err = make_tile_maps<HD>(&tm_v, &tail.v, v, n_kv, t, batch, st + 3);
  }
  if (!err) {
    err = make_tile_maps<HD>(&tm_o, &tail.o, out, nh, seq, batch, st + 6);
  }
  if (!err) err = make_map_i32(&tm_kvpos, kv_pos, kv_numel, kPosBox);
  if (err) return err;
  const int qpk = nh / n_kv;
  const int n_qt = seq / kRows;
  constexpr size_t smem = chunk_smem_bytes<HD, WG>();
  int grid = 0;
  const cudaError_t e =
      persistent_grid(chunk_tc_kernel<HD, WG>, WG * 128 + 32, smem,
                      n_qt * batch * n_kv * (qpk / WG), &grid);
  if (e != cudaSuccess) return (int)e;
  chunk_tc_kernel<HD, WG><<<grid, WG * 128 + 32, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_o, tm_kvpos, n_qt, batch, n_kv, qpk, window,
      scale * 1.4426950408889634f, tail, args);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_heads(int heads, const void* q, const void* k, const void* v,
                 const void* kv_pos, void* out, int batch, int nh, int n_kv,
                 int seq, int window, float scale, const int64_t* st,
                 const ChunkArgs& args, int64_t kv_numel,
                 cudaStream_t stream) {
  switch (heads) {
    case 1:
      return launch<HD, 1>(q, k, v, kv_pos, out, batch, nh, n_kv, seq,
                           window, scale, st, args, kv_numel, stream);
    case 2:
      return launch<HD, 2>(q, k, v, kv_pos, out, batch, nh, n_kv, seq,
                           window, scale, st, args, kv_numel, stream);
    case 4:
      if constexpr (HD <= 64) {
        return launch<HD, 4>(q, k, v, kv_pos, out, batch, nh, n_kv, seq,
                             window, scale, st, args, kv_numel, stream);
      }
      return (int)cudaErrorInvalidValue;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tc
}  // namespace
}  // namespace repro_torch

// q (B, seq, nh, hd), k/v (B, t_len, n_kv, hd) and out (B, seq, nh, hd)
// bf16; pos (B, seq) int64; kv_pos the int32 storage that holds the
// (B, t_len) kv_pos rows, of kv_numel elements.  strides: 13 int64 in
// elements: (batch, head, seq) for q, k/v and out; (batch, seq) for pos;
// kv_pos's offset in its storage and its batch stride.  heads: q heads
// (warpgroups) per block, 1, 2 or 4 (4 only up to hd 64).  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int chunk_attention_launch(const void* q, const void* k,
                                      const void* v, const void* pos,
                                      const void* kv_pos, void* out,
                                      int batch, int nh, int n_kv, int seq,
                                      int t_len, int hd, int window,
                                      int heads, const int64_t* strides,
                                      int64_t kv_numel, void* stream,
                                      float scale) {
  using namespace repro_torch::tc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (seq % kRows || nh % n_kv || (nh / n_kv) % heads) {
    return (int)cudaErrorInvalidValue;
  }
  const ChunkArgs args = {static_cast<const int64_t*>(pos), strides[9],
                          strides[10], strides[11], strides[12], t_len};
  switch (hd) {
    case 32:
      return launch_heads<32>(heads, q, k, v, kv_pos, out, batch, nh, n_kv,
                              seq, window, scale, strides, args, kv_numel, s);
    case 64:
      return launch_heads<64>(heads, q, k, v, kv_pos, out, batch, nh, n_kv,
                              seq, window, scale, strides, args, kv_numel, s);
    case 80:
      return launch_heads<80>(heads, q, k, v, kv_pos, out, batch, nh, n_kv,
                              seq, window, scale, strides, args, kv_numel, s);
    case 128:
      return launch_heads<128>(heads, q, k, v, kv_pos, out, batch, nh, n_kv,
                               seq, window, scale, strides, args, kv_numel,
                               s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
