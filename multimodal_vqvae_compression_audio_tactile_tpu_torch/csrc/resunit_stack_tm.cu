// Time-major residual-unit stack (K3), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel multimodal_vqvae_compression_audio_tactile_tpu/
// ops/resunit_tm_pallas.py::_kernel (driven by _stack_call). One residual unit
// at dilation d on time-major x [B, T, C], with an fp32 residual carry x_acc:
//   h   = snake_a1(x_acc)                                 (fp32, rounded to the operand type)
//   acc = sum_j h[t + (j - 3) d] . W7_j + b7              (zero outside [0, T))
//   h2  = snake_a2(acc)                                   (rounded to the operand type)
//   x_acc' = x_acc + (h2 . W1 + b1)                       (fp32)
// and after the last unit the optional trailing snake, on the fp32 carry,
// then one cast to the operand type. The wrapper (ops/resunit_tm.py) chains
// the units, two launches each: resunit_tm_conv7 (dilated k=7 conv with both
// snakes) and resunit_tm_conv1 (k=1 conv and the residual add). Between the
// units the carry is written in fp32; before unit 0 it is x itself, in the
// operand type, and the last unit writes the operand type. Each launch reads
// exactly [B, T, C] and treats rows outside [0, T) as zero, which is the TPU
// kernel's re-zeroing between units by construction.
//
// Bound on this card: 16 C^2 T multiply-adds per unit against a few passes of
// C T elements, so bound by operations at every width of the model. The TPU
// kernel kept all three units' weights and a haloed [t_tile + 80, C] window in
// VMEM; at C = 192 the weights alone are 1.8 MB in bf16, against 227 KB of
// shared memory a block. This design tiles the output [64 T x 64 C_out] per
// block and streams 16 input channels at a time, with their 6 d rows of halo,
// through shared memory (snake applied on the way in), together with the
// matching fp32 weights read in PyTorch's [C_out, C_in, k] layout and rounded
// to the operand type there, so no packed copy of the weights is made. It
// accumulates in fp32 FFMA, 4 x 4 outputs a thread, for fp32 and bf16 operands
// alike. With C contiguous each tap is a [rows, C_in] x [C_in, C_out] product:
// the tensor cores, and one launch per stack, are the work of a later change.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int CO_TILE = 64;     // output channels per block
constexpr int T_TILE = 64;      // time rows per block
constexpr int CI_CHUNK = 16;    // input channels staged per step
constexpr int MAX_SHIFT = 27;   // 3 * max dilation (9)
constexpr int WIN = T_TILE + 2 * MAX_SHIFT;
constexpr int THREADS = 256;    // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
// round a float to the operand type and back (identity for fp32)
template <typename T> __device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

__device__ __forceinline__ float snake(float x, float a) {
  float s = sinf(a * x);
  return x + s * s / (a + 1e-9f);
}

// T: operand type; TI: type of `in`; TA: type of the carry `resid`; TO: type of `out`.
// KT = 7: out = snake_a_out(W7 *_d snake_a_in(in) + b7), in = the carry
// KT = 1: out = resid + (W1 . in + b1), then snake_a_out if a_out != nullptr, in = h2
template <typename T, typename TI, typename TA, typename TO, int KT>
__global__ void __launch_bounds__(THREADS)
unit_tm_kernel(const TI* __restrict__ in, const float* __restrict__ w,
               const float* __restrict__ bias, const float* __restrict__ alpha_in,
               const float* __restrict__ alpha_out, const TA* __restrict__ resid,
               TO* __restrict__ out, int C, int Tlen, int dil) {
  __shared__ float in_s[CI_CHUNK][WIN];
  __shared__ float w_s[CI_CHUNK * KT][CO_TILE + 1];

  const int t0 = blockIdx.x * T_TILE;
  const int co0 = blockIdx.y * CO_TILE;
  const size_t base = (size_t)blockIdx.z * Tlen * C;
  const int tx = threadIdx.x % 16;    // output channels co0 + tx + 16 k
  const int ty = threadIdx.x / 16;    // output rows t0 + ty + 16 m
  const int halo = (KT - 1) / 2 * dil;
  const int win = T_TILE + 2 * halo;

  float acc[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[m][k] = 0.f;

  for (int ci0 = 0; ci0 < C; ci0 += CI_CHUNK) {
    // input window of this chunk (rows t0 - halo ..), zero outside [0, T) and past C
    for (int i = threadIdx.x; i < CI_CHUNK * win; i += THREADS) {
      int p = i / CI_CHUNK, c = i % CI_CHUNK;
      int ci = ci0 + c, t = t0 - halo + p;
      float v = 0.f;
      if (ci < C && t >= 0 && t < Tlen) {
        v = to_f(in[base + (size_t)t * C + ci]);
        if (KT == 7) v = rnd<T>(snake(v, alpha_in[ci]));
      }
      in_s[c][p] = v;
    }
    // weights W[co0 + r, ci0 .. ci0 + CI_CHUNK, 0 .. KT), contiguous per output channel
    for (int i = threadIdx.x; i < CO_TILE * CI_CHUNK * KT; i += THREADS) {
      int r = i / (CI_CHUNK * KT), q = i % (CI_CHUNK * KT);
      int co = co0 + r, ci = ci0 + q / KT;
      w_s[q][r] = (co < C && ci < C) ? rnd<T>(w[((size_t)co * C + ci) * KT + q % KT]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < CI_CHUNK; ++c) {
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        float wv[4], hv[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) wv[k] = w_s[c * KT + j][tx + 16 * k];
#pragma unroll
        for (int m = 0; m < 4; ++m) hv[m] = in_s[c][ty + 16 * m + j * dil];
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[m][k] = fmaf(hv[m], wv[k], acc[m][k]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < 4; ++m) {
    int t = t0 + ty + 16 * m;
    if (t >= Tlen) continue;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      int co = co0 + tx + 16 * k;
      if (co >= C) continue;
      size_t o = base + (size_t)t * C + co;
      float v = acc[m][k] + bias[co];
      if (KT == 7) {
        v = snake(v, alpha_out[co]);
      } else {
        v = to_f(resid[o]) + v;
        if (alpha_out != nullptr) v = snake(v, alpha_out[co]);
      }
      out[o] = from_f<TO>(v);
    }
  }
}

template <typename T, typename TI, typename TA, typename TO, int KT>
int launch(const void* in, const void* w, const void* bias, const void* alpha_in,
           const void* alpha_out, const void* resid, void* out, int B, int C,
           int Tlen, int dil, void* stream) {
  dim3 grid((Tlen + T_TILE - 1) / T_TILE, (C + CO_TILE - 1) / CO_TILE, B);
  unit_tm_kernel<T, TI, TA, TO, KT><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const TI*)in, (const float*)w, (const float*)bias, (const float*)alpha_in,
      (const float*)alpha_out, (const TA*)resid, (TO*)out, C, Tlen, dil);
  return (int)cudaGetLastError();
}

using bf16 = __nv_bfloat16;

}  // namespace

extern "C" {

// h2 = snake_a2(conv7_dil(snake_a1(acc)) + b7); acc [B, T, C] in fp32 when
// acc_f32, else in the operand type; h2 [B, T, C] in the operand type;
// w7 [C, C, 7] fp32 (nn.Conv1d layout), b7, a1, a2 [C] fp32
int resunit_tm_conv7(const void* acc, int acc_f32, const void* w7, const void* b7,
                     const void* a1, const void* a2, void* h2, int B, int C,
                     int Tlen, int dil, int is_bf16, void* stream) {
  if (dil < 1 || 3 * dil > MAX_SHIFT) return (int)cudaErrorInvalidValue;
  if (!is_bf16)
    return launch<float, float, float, float, 7>(acc, w7, b7, a1, a2, nullptr, h2,
                                                 B, C, Tlen, dil, stream);
  return acc_f32
      ? launch<bf16, float, float, bf16, 7>(acc, w7, b7, a1, a2, nullptr, h2, B, C,
                                            Tlen, dil, stream)
      : launch<bf16, bf16, bf16, bf16, 7>(acc, w7, b7, a1, a2, nullptr, h2, B, C,
                                          Tlen, dil, stream);
}

// out = acc + (W1 . h2 + b1), then snake_post when post_alpha is not null;
// out in fp32 when out_f32, else in the operand type; w1 [C, C, 1] fp32
int resunit_tm_conv1(const void* acc, int acc_f32, const void* h2, const void* w1,
                     const void* b1, const void* post_alpha, void* out, int out_f32,
                     int B, int C, int Tlen, int is_bf16, void* stream) {
  if (!is_bf16)
    return launch<float, float, float, float, 1>(h2, w1, b1, nullptr, post_alpha, acc,
                                                 out, B, C, Tlen, 1, stream);
  if (acc_f32)
    return out_f32
        ? launch<bf16, bf16, float, float, 1>(h2, w1, b1, nullptr, post_alpha, acc, out,
                                              B, C, Tlen, 1, stream)
        : launch<bf16, bf16, float, bf16, 1>(h2, w1, b1, nullptr, post_alpha, acc, out,
                                             B, C, Tlen, 1, stream);
  return out_f32
      ? launch<bf16, bf16, bf16, float, 1>(h2, w1, b1, nullptr, post_alpha, acc, out,
                                           B, C, Tlen, 1, stream)
      : launch<bf16, bf16, bf16, bf16, 1>(h2, w1, b1, nullptr, post_alpha, acc, out,
                                          B, C, Tlen, 1, stream);
}

}  // extern "C"
