// Residual-unit stack of the DAC-class backbone, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel multimodal_vqvae_compression_audio_tactile_tpu/
// ops/resunit_pallas.py::_resunit_stack_kernel (driven by _resunit_stack_call).
// One residual unit at dilation d, on channels-first x [B, C, T]:
//   h   = snake_a1(x)                                      (fp32, rounded to the operand type)
//   acc = sum_j W7[:, :, j] . h[t + (j - 3) d] + b7        (zero outside [0, T))
//   h2  = snake_a2(acc)
//   x'  = x + W1 . h2 + b1                                 (optionally followed by snake_post)
// The wrapper (ops/resunit.py) chains the units of a stack, two launches each:
// resunit_conv7 (dilated k=7 conv with both snakes) and resunit_conv1 (k=1 conv,
// residual add, optional trailing block snake). Each launch reads exactly
// [B, C, T] and treats everything outside [0, T) as zero, which is the TPU
// kernel's re-zeroing between units (resunit_pallas.py:108-110) by construction.
//
// Bound on this card: the stack is 16 C^2 T multiply-adds per unit (2 flops
// each) against about 5 activation passes of C T elements, so at C >= 64 it is
// bound by operations, not bytes. The TPU kernel kept a whole stack's weights
// resident (8 C^2 per unit); at C = 768 that is 19 MB in fp32, far beyond the
// 227 KB of shared memory of a block, so each unit is two launches here.
//
// bf16 operands run on the tensor cores through the product core shared with
// K3 (resunit_mma.cuh: mma.sync m16n8k16, fp32 accumulate, a tile chosen per
// shape so that batch 1 fills the card, a three-stage cp.async ring): a
// prologue writes unit 0's snaked operand time-major, transposing x, and
// packs the stack's weights in bf16; each k=7 launch reads its snaked
// operand and writes h2 time-major [B, T, C]; each k=1 launch writes the
// channels-first output and, but for the last unit, the next unit's snaked
// operand. So a bf16 stack of n units is 2 n + 1 launches.
//
// fp32 operands keep the FFMA design below, bit-identical to the plain
// version in PyTorch: each block a [64 C_out x 64 T] tile, weights streamed
// through shared memory in chunks of 16 input channels (with the input
// window of the chunk, its 6 d halo included, snake applied on the way in),
// 4 x 4 outputs a thread, h2 channels-first [B, C, T].

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "resunit_mma.cuh"

namespace {

constexpr int CO_TILE = 64;     // output channels per block
constexpr int T_TILE = 64;      // time steps per block
constexpr int CI_CHUNK = 16;    // input channels staged per step
constexpr int MAX_HALO = 27;    // 3 * max dilation (9)
constexpr int WIN = T_TILE + 2 * MAX_HALO;
constexpr int THREADS = 256;    // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float snake(float x, float a) {
  float s = sinf(a * x);
  return x + s * s / (a + 1e-9f);
}

// KT = 7: h2 = snake_a2(W7 *_d snake_a1(x) + b7)
// KT = 1: out = x + W1 . h2 + b1, then snake_post if post_alpha != nullptr
template <int KT>
__global__ void __launch_bounds__(THREADS)
unit_conv_kernel(const float* __restrict__ in, const float* __restrict__ w,
                 const float* __restrict__ bias, const float* __restrict__ alpha_in,
                 const float* __restrict__ alpha_out, const float* __restrict__ resid,
                 float* __restrict__ out, int C, int Tlen, int dil) {
  __shared__ float in_s[CI_CHUNK][WIN];
  __shared__ float w_s[CO_TILE][CI_CHUNK * KT + 1];

  const int t0 = blockIdx.x * T_TILE;
  const int co0 = blockIdx.y * CO_TILE;
  const size_t base = (size_t)blockIdx.z * C * Tlen;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int halo = (KT - 1) / 2 * dil;
  const int win = T_TILE + 2 * halo;

  float acc[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[m][k] = 0.f;

  for (int ci0 = 0; ci0 < C; ci0 += CI_CHUNK) {
    // input window of this chunk, zero outside [0, T) and past C
    for (int i = threadIdx.x; i < CI_CHUNK * win; i += THREADS) {
      int c = i / win, p = i % win;
      int ci = ci0 + c, t = t0 - halo + p;
      float v = 0.f;
      if (ci < C && t >= 0 && t < Tlen) {
        v = in[base + (size_t)ci * Tlen + t];
        if (KT == 7) v = snake(v, alpha_in[ci]);
      }
      in_s[c][p] = v;
    }
    // weights W[co0 + r, ci0 .. ci0 + CI_CHUNK, 0 .. KT) (contiguous per row)
    for (int i = threadIdx.x; i < CO_TILE * CI_CHUNK * KT; i += THREADS) {
      int r = i / (CI_CHUNK * KT), q = i % (CI_CHUNK * KT);
      int co = co0 + r, ci = ci0 + q / KT;
      w_s[r][q] = (co < C && ci < C) ? w[((size_t)co * C + ci) * KT + q % KT] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < CI_CHUNK; ++c) {
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        float wv[4], hv[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) wv[m] = w_s[ty + 16 * m][c * KT + j];
#pragma unroll
        for (int k = 0; k < 4; ++k) hv[k] = in_s[c][tx + 16 * k + j * dil];
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[m][k] = fmaf(wv[m], hv[k], acc[m][k]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < 4; ++m) {
    int co = co0 + ty + 16 * m;
    if (co >= C) continue;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      int t = t0 + tx + 16 * k;
      if (t >= Tlen) continue;
      size_t o = base + (size_t)co * Tlen + t;
      float v = acc[m][k] + bias[co];
      if (KT == 7) {
        v = snake(v, alpha_out[co]);
      } else {
        v = resid[o] + v;
        if (alpha_out != nullptr) v = snake(v, alpha_out[co]);
      }
      out[o] = v;
    }
  }
}

template <int KT>
int launch(const void* in, const void* w, const void* bias, const void* alpha_in,
           const void* alpha_out, const void* resid, void* out, int B, int C,
           int Tlen, int dil, void* stream) {
  dim3 grid((Tlen + T_TILE - 1) / T_TILE, (C + CO_TILE - 1) / CO_TILE, B);
  unit_conv_kernel<KT><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)in, (const float*)w, (const float*)bias, (const float*)alpha_in,
      (const float*)alpha_out, (const float*)resid, (float*)out, C, Tlen, dil);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The prologue of a bf16 stack of n_units (1..3): hs = bf16(snake_a1(x))
// [B, T, C], unit 0's operand, from x [B, C, T] bf16; and each unit u's fp32
// weights w7_u [C, C, 7], w1_u [C, C, 1] rounded to bf16 and packed into
// wp + u * 8 C^2 as [7][C_out][C_in] then [C_out][C_in] (the w7/w1 arguments
// of the bf16 launches below)
int resunit_prologue(const void* x, const void* a1, void* hs, const void* w7_0,
                     const void* w7_1, const void* w7_2, const void* w1_0,
                     const void* w1_1, const void* w1_2, int n_units, void* wp, int B,
                     int C, int Tlen, void* stream) {
  const void* w7[] = {w7_0, w7_1, w7_2};
  const void* w1[] = {w1_0, w1_1, w1_2};
  return mma_core::launch_prologue<true>(x, a1, hs, w7, w1, n_units, wp, B, C, Tlen, stream);
}

// h2 = snake_a2(conv7_dil(snake_a1(x)) + b7). fp32: x and h2 [B, C, T], w7
// [C, C, 7] (nn.Conv1d layout). bf16: x is hs = bf16(snake_a1(x)) [B, T, C]
// (a1 unused), w7 the unit's packed [7][C][C] from the prologue, h2 [B, T, C],
// with the tile (t_tile, co_tile).
int resunit_conv7(const void* x, const void* w7, const void* b7, const void* a1,
                  const void* a2, void* h2, int B, int C, int Tlen, int dil,
                  int is_bf16, int t_tile, int co_tile, void* stream) {
  if (dil < 1 || 3 * dil > MAX_HALO) return (int)cudaErrorInvalidValue;
  return is_bf16
      ? mma_core::launch<7, true, __nv_bfloat16, __nv_bfloat16>(
            t_tile, co_tile, x, w7, b7, a2, nullptr, nullptr, h2, nullptr, B, C, Tlen,
            dil, stream)
      : launch<7>(x, w7, b7, a1, a2, nullptr, h2, B, C, Tlen, dil, stream);
}

// out = x + W1 . h2 + b1, then snake_post when post_alpha is not null;
// x, out [B, C, T]; h2 as resunit_conv7 wrote it; w1 [C, C, 1] fp32, or in
// bf16 the unit's packed [C][C]. bf16 only: with hs_next not null, also
// hs_next = bf16(snake_a1_next(out)) [B, T, C], the next unit's operand.
int resunit_conv1(const void* x, const void* h2, const void* w1, const void* b1,
                  const void* post_alpha, const void* a1_next, void* hs_next, void* out,
                  int B, int C, int Tlen, int is_bf16, int t_tile, int co_tile,
                  void* stream) {
  return is_bf16
      ? mma_core::launch<1, true, __nv_bfloat16, __nv_bfloat16>(
            t_tile, co_tile, h2, w1, b1, post_alpha, a1_next, x, out, hs_next, B, C,
            Tlen, 1, stream)
      : launch<1>(h2, w1, b1, nullptr, post_alpha, x, out, B, C, Tlen, 1, stream);
}

// dynamic shared memory of one bf16 launch (kt = 7 or 1) of the tile at
// dilation dil, as the build reports it beside ptxas's registers
int resunit_smem_bytes(int kt, int t_tile, int co_tile, int dil) {
  return mma_core::smem_bytes(kt, t_tile, co_tile, dil);
}

}  // extern "C"
