// The pieces of the tensor-core attention kernels (flash_tc_kernel in
// flash_attention.cu, chunk_tc_kernel in chunk_attention.cu) that both
// share: the tile sizes, the 64 x HD bf16 tile layout in shared memory, the
// register-A wgmma by width, the shared-memory size, ex2, the order in
// which a persistent block takes its work items, and a consumer
// warpgroup's steps: Q K^T of a tile, its online softmax and P V, and the
// epilogue's write of the normalised tile; on the host, the tiles' tensor
// maps and the persistent grid.  Each source includes it into its own
// anonymous namespace.
#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace repro_torch {
namespace {
namespace tc {

using namespace hopper;

constexpr int kRows = 64;    // q rows of a warpgroup's tile; kv tokens a tile
constexpr int kStages = 4;   // K/V ring depth

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 32) {
    wgmma_rs_n32(d, a, db);
  } else if constexpr (N == 64) {
    wgmma_rs_n64(d, a, db);
  } else {
    wgmma_rs_n128(d, a, db);
  }
}

// A 64 x HD bf16 tile in shared memory: kMain column blocks of
// kSwizzle / 2 columns, each 64 rows of kSwizzle bytes in that swizzle,
// and, where HD is not a whole number of them (hd 80 = 64 + 16), a tail
// block of the last 16 columns, 64 rows of 32 bytes in the 32-byte
// swizzle.  The tensor cores see the tail as one more k16 step of Q K^T
// and one m64n16 product of P V, so no padded column is loaded or
// multiplied.
template <int HD>
struct Layout {
  static constexpr int kSwizzle = HD >= 64 ? 128 : 64;  // bytes of an atom row
  static constexpr int kColBlock = kRows * kSwizzle;  // 64-row column block
  static constexpr int kMain = HD * 2 / kSwizzle;     // whole column blocks
  static constexpr int kMainCols = kMain * kSwizzle / 2;
  static constexpr int kTailCols = HD - kMainCols;    // 16 at hd 80, else 0
  static constexpr int kTailSwizzle = 32;             // bytes of a tail row
  static constexpr int kTailOff = kMain * kColBlock;  // the tail block
  static constexpr int kTile = kTailOff + kRows * kTailCols * 2;  // 64 x HD
  static_assert(kTailCols == 0 || kTailCols * 2 == kTailSwizzle,
                "a tail of one 32-byte swizzle atom at most");
};

// the tensor maps of the tail block (hd 80's columns 64-79: a box of 16
// columns in the 32-byte swizzle); unused at the other head dims
struct TailMaps {
  CUtensorMap q, k, v, o;
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


// The tensor maps of a (batch, heads, rows, HD) bf16 tensor given element
// strides st (batch, head, row): its main column blocks' and, where HD has
// a tail block, the tail's from its own first column.
template <int HD>
inline int make_tile_maps(CUtensorMap* main, CUtensorMap* tail,
                          const void* p, int heads, int rows, int batch,
                          const int64_t* st) {
  using L = Layout<HD>;
  int err = make_map(main, p, L::kMainCols, heads, rows, batch, st[0],
                     st[1], st[2], L::kSwizzle);
  if constexpr (L::kTailCols > 0) {
    if (!err) {
      err = make_map(tail, p, L::kTailCols, heads, rows, batch, st[0],
                     st[1], st[2], L::kTailSwizzle, L::kMainCols);
    }
  }
  return err;
}

// A persistent grid for `kernel` at `threads` threads and `smem` bytes of
// dynamic shared memory: as many blocks as the card holds at once, at most
// n_items.
template <typename Kernel>
inline cudaError_t persistent_grid(Kernel kernel, int threads, size_t smem,
                                   int n_items, int* grid) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t e = allow_smem(kernel, smem);
  if (e == cudaSuccess) e = cudaGetDevice(&device);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  }
  *grid = min(n_items, max(per_sm, 1) * sms);
  return e;
}

// S = Q K^T of a warpgroup's 64-row q tile and a K tile, both in shared
// memory in the tile layout: k16 steps walk 32 bytes along the swizzled
// rows, then on to the next column block, the tail block's one k16 step
// last.  Accumulator fragments: warp w of the warpgroup owns rows 16w ..
// 16w+15; a thread holds rows r0 and r0 + 8, columns 8j + 2t and 8j + 2t
// + 1 (s[4j], s[4j + 1] and s[4j + 2], s[4j + 3]).
template <int HD>
__device__ __forceinline__ void qk_tile(float (&s)[32], uint32_t q_addr,
                                        uint32_t k_addr) {
  using L = Layout<HD>;
  constexpr int SW = L::kSwizzle;
  constexpr int TSW = L::kTailSwizzle;
  constexpr int KSTEPS = L::kMainCols / 16;  // k16 steps of the main blocks
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
  if constexpr (L::kTailCols > 0) {
    // the tail block's one k16 step: its whole 32-byte rows
    wgmma_ss_n64<0, 0>(s, desc<TSW>(q_addr + L::kTailOff, 16, 8 * TSW),
                       desc<TSW>(k_addr + L::kTailOff, 16, 8 * TSW), 1);
  }
  wg_commit();
  wg_wait_all();
  hold(s);
}

// One tile's online softmax over its masked raw scores s (-inf where
// masked; a row lives in the four threads of a quad: max and sum reduce
// over shuffles 1 and 2), with the scale folded into the exponent's FMA,
// then O += P V: P as bf16 A fragments from registers, the V tile at
// v_addr read MN-major.  m is the running max of the raw scores; l stays
// a per-thread partial sum, reduced over the quad by `store_tile`.
template <int HD>
__device__ __forceinline__ void softmax_pv(float (&s)[32], float (&o)[HD / 2],
                                           float& m0, float& m1, float& l0,
                                           float& l1, float scale_log2,
                                           uint32_t v_addr) {
  using L = Layout<HD>;
  constexpr int SW = L::kSwizzle;
  constexpr int TSW = L::kTailSwizzle;
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
  // every thread of a quad scales its partial l by the same alpha, so the
  // quad's sum is taken once at the end
  l0 = l0 * a0 + sum0;
  l1 = l1 * a1 + sum1;
#pragma unroll
  for (int c = 0; c < HD / 2; c += 4) {
    o[c] *= a0;
    o[c + 1] *= a0;
    o[c + 2] *= a1;
    o[c + 3] *= a1;
  }
  // k16 step kk takes columns 16kk .. 16kk + 15, i.e. accumulator
  // registers 8kk .. 8kk + 7
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
    // V tile read MN-major: 16 token rows per step, column blocks apart
    // by one 64-row block
    if constexpr (L::kTailCols == 0) {
      wgmma_rs<HD>(o, pa[kk],
                   desc<SW>(v_addr + kk * 16 * SW, L::kColBlock, 8 * SW));
    } else {
      // the main blocks into o's first kMainCols / 2 floats, the tail
      // block (one 16-column atom) into the last 8
      wgmma_rs<L::kMainCols>(
          *reinterpret_cast<float(*)[L::kMainCols / 2]>(o), pa[kk],
          desc<SW>(v_addr + kk * 16 * SW, L::kColBlock, 8 * SW));
      wgmma_rs_n16(
          *reinterpret_cast<float(*)[8]>(o + L::kMainCols / 2), pa[kk],
          desc<TSW>(v_addr + L::kTailOff + kk * 16 * TSW, kRows * TSW,
                    8 * TSW));
    }
  }
  wg_commit();
  wg_wait_all();
  hold(o);
}

// The epilogue's write: the tile normalised by the quad's sums of l, as
// bf16 into o_s (the warpgroup's q buffer, which its last Q K^T has
// finished reading) in the swizzled layout of the tensor maps.
template <int HD>
__device__ __forceinline__ void store_tile(const float (&o)[HD / 2], float l0,
                                           float l1, uint8_t* o_s, int r0,
                                           int t2) {
  using L = Layout<HD>;
  constexpr int SW = L::kSwizzle;
  constexpr int TSW = L::kTailSwizzle;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int c = 0; c < L::kMainCols / 2; c += 4) {
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
#pragma unroll
  for (int c = L::kMainCols / 2; c < HD / 2; c += 4) {
    // the tail block: 32-byte rows of two 16-byte chunks
    const int chunk = (c - L::kMainCols / 2) / 4;
    uint8_t* tail_s = o_s + L::kTailOff + t2 * 2;
    *reinterpret_cast<__nv_bfloat162*>(
        tail_s + r0 * TSW + ((chunk ^ swizzle_row<TSW>(r0)) * 16)) =
        __floats2bfloat162_rn(o[c] * inv0, o[c + 1] * inv0);
    *reinterpret_cast<__nv_bfloat162*>(
        tail_s + (r0 + 8) * TSW + ((chunk ^ swizzle_row<TSW>(r0 + 8)) * 16)) =
        __floats2bfloat162_rn(o[c + 2] * inv1, o[c + 3] * inv1);
  }
}

}  // namespace tc
}  // namespace
}  // namespace repro_torch
