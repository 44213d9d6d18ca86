// The dense decode block's glue, fused for Hopper (sm_90a): RMSNorm
// (alone, or after the residual add), RoPE with the step's K/V and kv_pos
// writes, and the gated MLP's SiLU-and-multiply.
//
// Replaces no Pallas kernel.  The JAX package computes this glue in jnp,
// which XLA fuses into the decode step's jitted program.  The port's eager
// PyTorch issued it as ~78 small kernels a layer (8 a norm, ~17 a RoPE
// call, ~6 a cache write, ~9 the kv_pos write, 2 SiLU and its product),
// each a host launch of ~10 us around a few KB a row.
//
// Bound.  Each kernel reads and writes a few KB a row: at granite-3-2b's
// decode (B 64, d 2048, 32/8 heads, hd 64, d_ff 8192, bf16) a norm moves
// 0.5 MB, RoPE and the writes 0.4 MB, SiLU-and-multiply 3.1 MB, 0.2 to
// 1 us at 3.35 TB/s.  At that size the launch, on the host and on the
// device, is the cost; the design is one launch for each piece of glue, a
// block per row, no shared-memory stage but the norm's row.
//
// Rounding follows the plain composition (kernels/ref.py) step by step:
// every float product and sum is rounded on its own (__fmul_rn, __fadd_rn,
// __fsub_rn: no FMA contraction), each cast to the compute dtype rounds to
// nearest even, and rsqrtf and expf are the functions PyTorch's CUDA
// kernels call.  The norm also adds its squares in the order of PyTorch's
// CUDA reduction for the mean (below), so every kernel gives PyTorch's
// bits wherever that order is reproduced.
//
// Layouts (contiguous), T float32 or bf16:
//   rms_norm       x, res, sum_out, out (rows, d) T; w (d,) float32;
//                  the row's y in shared memory (d floats)
//   rope_kv_write  q (B, nh, hd), k/v (B, n_kv, hd) T; cos/sin (B, hd/2)
//                  float32; pos (B,) int32; k/v_cache (B, T, n_kv, hd) T;
//                  kv_pos (B, T) int32; q_out (B, nh, hd) T
//   silu_mul       a, b, out (n,) T

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4096;
// the most lanes PyTorch's reduction gives one row (max_reduce_threads)
constexpr int kNormThreads = 512;

// rms_norm(y) = y * (rsqrt(mean(y^2) + eps) * w) with y = x (+ res), as
// layers.rms_norm: the mean of squares in float32, the scale in float32
// cast to T, the product rounded to T.  One block a row: every thread
// stages the row's y in shared memory (float, d of them), `width` lanes
// add the squares, every thread writes.
//
// The squares are added in the order of PyTorch's CUDA reduction for
// torch.mean(y^2, dim=-1) (ATen's Reduce.cuh), which gives a row `width`
// lanes (decode_glue.reduce_lanes computes width and vec as its
// setReduceConfig does).  Lane l keeps four accumulators: with vec, over
// the groups of four elements l, l + width, ..., element j of a group into
// accumulator j, and the tail past the last whole group into accumulator
// 0; without, over four strides at a time, l + j * width into accumulator
// j.  It adds them in order, then the lanes fold in halves through shared
// memory down to 32 and by shuffles at offsets 16, 8, 4, 2, 1 (lanes past
// width hold 0, and adding 0 is exact).  The mean is the sum times the
// float rows / (rows * d), as PyTorch's mean scales it.
template <typename T>
__global__ void __launch_bounds__(kNormThreads)
    rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ res,
                    const float* __restrict__ w, T* __restrict__ sum_out,
                    T* __restrict__ out, int d, float eps, int width,
                    int vec) {
  extern __shared__ float ys[];
  __shared__ float part[kNormThreads];
  __shared__ float scale_f32;
  const size_t off = static_cast<size_t>(blockIdx.x) * d;
  const int lane = threadIdx.x;
  for (int i = lane; i < d; i += blockDim.x) {
    float y = to_f32(x[off + i]);
    if (res != nullptr) {
      const T yt = from_f32<T>(__fadd_rn(y, to_f32(res[off + i])));
      sum_out[off + i] = yt;
      y = to_f32(yt);
    }
    ys[i] = y;
  }
  __syncthreads();
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (lane < width) {
    if (vec) {
#pragma unroll 4
      for (int g = lane; 4 * g + 3 < d; g += width) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[j] = __fadd_rn(acc[j], __fmul_rn(ys[4 * g + j], ys[4 * g + j]));
        }
      }
      const int tail = (d & ~3) + lane;
      if (tail < d) acc[0] = __fadd_rn(acc[0], __fmul_rn(ys[tail], ys[tail]));
    } else {
      int i = lane;
      for (; i + 3 * width < d; i += 4 * width) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float y = ys[i + j * width];
          acc[j] = __fadd_rn(acc[j], __fmul_rn(y, y));
        }
      }
      for (int j = 0; j < 4 && i < d; ++j, i += width) {
        acc[j] = __fadd_rn(acc[j], __fmul_rn(ys[i], ys[i]));
      }
    }
  }
  float s = __fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[1]), acc[2]), acc[3]);
  if (width > 32) {
    if (lane < width) part[lane] = s;
    for (int o = width / 2; o >= 32; o >>= 1) {
      __syncthreads();
      if (lane < o) {
        s = __fadd_rn(s, part[lane + o]);
        part[lane] = s;
      }
    }
  }
  if (lane < 32) {
    for (int o = 16; o > 0; o >>= 1) {
      s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, o));
    }
  }
  if (lane == 0) {
    const float factor = __fdiv_rn(
        static_cast<float>(gridDim.x),
        static_cast<float>(static_cast<long long>(gridDim.x) * d));
    scale_f32 = rsqrtf(__fadd_rn(__fmul_rn(s, factor), eps));
  }
  __syncthreads();
  const float r = scale_f32;
  for (int i = lane; i < d; i += blockDim.x) {
    const T scale = from_f32<T>(__fmul_rn(r, w[i]));
    out[off + i] = from_f32<T>(__fmul_rn(ys[i], to_f32(scale)));
  }
}

// (x1, x2) -> (x1 cos - x2 sin, x1 sin + x2 cos), x1 at x[0], x2 at
// x[half], as layers.apply_rope rounds it.
template <typename T>
__device__ __forceinline__ void rotate(const T* x, T* y, int half, float c,
                                       float s) {
  const float x1 = to_f32(x[0]);
  const float x2 = to_f32(x[half]);
  y[0] = from_f32<T>(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s)));
  y[half] = from_f32<T>(__fadd_rn(__fmul_rn(x1, s), __fmul_rn(x2, c)));
}

// One block a sequence b: its q heads rotated into q_out, its k heads
// rotated and its v heads copied into cache row clamp(pos, 0, T - 1) (the
// clamp of jax.lax.dynamic_update_slice), and pos into kv_pos at that row.
template <typename T>
__global__ void __launch_bounds__(kThreads) rope_kv_write_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, const int* __restrict__ pos,
    T* __restrict__ k_cache, T* __restrict__ v_cache,
    int* __restrict__ kv_pos, T* __restrict__ q_out, int nh, int n_kv,
    int hd, int t) {
  const int b = blockIdx.x;
  const int half = hd / 2;
  const int p = pos[b];
  const int row = min(max(p, 0), t - 1);
  const float* c = cos_t + static_cast<size_t>(b) * half;
  const float* s = sin_t + static_cast<size_t>(b) * half;
  const size_t q_off = static_cast<size_t>(b) * nh * hd;
  for (int i = threadIdx.x; i < nh * half; i += kThreads) {
    const int j = i % half;
    const size_t e = q_off + static_cast<size_t>(i / half) * hd + j;
    rotate(q + e, q_out + e, half, c[j], s[j]);
  }
  const size_t kv_off = static_cast<size_t>(b) * n_kv * hd;
  const size_t row_off = (static_cast<size_t>(b) * t + row) * n_kv * hd;
  for (int i = threadIdx.x; i < n_kv * half; i += kThreads) {
    const int j = i % half;
    const size_t e = static_cast<size_t>(i / half) * hd + j;
    rotate(k + kv_off + e, k_cache + row_off + e, half, c[j], s[j]);
  }
  for (int i = threadIdx.x; i < n_kv * hd; i += kThreads) {
    v_cache[row_off + i] = v[kv_off + i];
  }
  if (threadIdx.x == 0) kv_pos[static_cast<size_t>(b) * t + row] = p;
}

// out = silu(a) * b, silu(a) = a / (1 + exp(-a)) rounded to T first, as
// F.silu(a) * b rounds it.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    silu_mul_kernel(const T* __restrict__ a, const T* __restrict__ b,
                    T* __restrict__ out, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    const float x = to_f32(a[i]);
    const T sx = from_f32<T>(__fdiv_rn(x, __fadd_rn(1.f, expf(-x))));
    out[i] = from_f32<T>(__fmul_rn(to_f32(sx), to_f32(b[i])));
  }
}

template <typename T>
int launch_rms_norm(const void* x, const void* res, const void* w,
                    void* sum_out, void* out, int rows, int d, float eps,
                    int width, int vec, cudaStream_t stream) {
  if (rows == 0) return 0;
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  // the static arrays count against the 48 KB default too
  const cudaError_t err = allow_smem(rms_norm_kernel<T>,
                                     smem + (kNormThreads + 1) * sizeof(float));
  if (err != cudaSuccess) return static_cast<int>(err);
  rms_norm_kernel<T><<<rows, width < kThreads ? kThreads : width, smem,
                       stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(res),
      static_cast<const float*>(w), static_cast<T*>(sum_out),
      static_cast<T*>(out), d, eps, width, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rope_kv_write(const void* q, const void* k, const void* v,
                         const void* cos_t, const void* sin_t,
                         const void* pos, void* k_cache, void* v_cache,
                         void* kv_pos, void* q_out, int batch, int nh,
                         int n_kv, int hd, int t, cudaStream_t stream) {
  if (batch == 0) return 0;
  rope_kv_write_kernel<T><<<batch, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<const int*>(pos),
      static_cast<T*>(k_cache), static_cast<T*>(v_cache),
      static_cast<int*>(kv_pos), static_cast<T*>(q_out), nh, n_kv, hd, t);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_silu_mul(const void* a, const void* b, void* out, int64_t n,
                    cudaStream_t stream) {
  if (n == 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  silu_mul_kernel<T><<<static_cast<int>(blocks < kMaxBlocks ? blocks
                                                             : kMaxBlocks),
                       kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<T*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// res == nullptr: out = rms_norm(x); else sum_out = x + res and
// out = rms_norm(sum_out).
// width: a power of two in [1, 512].
extern "C" int rms_norm_launch(const void* x, const void* res, const void* w,
                               void* sum_out, void* out, int rows, int d,
                               float eps, int width, int vec, int is_bf16,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return repro_torch::launch_rms_norm<__nv_bfloat16>(
        x, res, w, sum_out, out, rows, d, eps, width, vec, s);
  }
  return repro_torch::launch_rms_norm<float>(x, res, w, sum_out, out, rows,
                                             d, eps, width, vec, s);
}

extern "C" int rope_kv_write_launch(const void* q, const void* k,
                                    const void* v, const void* cos_t,
                                    const void* sin_t, const void* pos,
                                    void* k_cache, void* v_cache,
                                    void* kv_pos, void* q_out, int batch,
                                    int nh, int n_kv, int hd, int t,
                                    int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return repro_torch::launch_rope_kv_write<__nv_bfloat16>(
        q, k, v, cos_t, sin_t, pos, k_cache, v_cache, kv_pos, q_out, batch,
        nh, n_kv, hd, t, s);
  }
  return repro_torch::launch_rope_kv_write<float>(
      q, k, v, cos_t, sin_t, pos, k_cache, v_cache, kv_pos, q_out, batch, nh,
      n_kv, hd, t, s);
}

extern "C" int silu_mul_launch(const void* a, const void* b, void* out,
                               int64_t n, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return repro_torch::launch_silu_mul<__nv_bfloat16>(a, b, out, n, s);
  }
  return repro_torch::launch_silu_mul<float>(a, b, out, n, s);
}
