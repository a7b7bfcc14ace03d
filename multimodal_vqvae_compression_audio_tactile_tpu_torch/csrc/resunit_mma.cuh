// Tensor-core product core of the residual-unit stacks K1 (resunit_stack.cu)
// and K3 (resunit_stack_tm.cu), bf16 operands, for Hopper (sm_90a).
//
// A bf16 stack of n units is 2 n + 1 launches:
//   prologue_kernel: hs = bf16(snake_a1(x)) of unit 0, written time-major
//                    [B, T, C] (K1 transposes its channels-first x here), and
//                    the stack's fp32 nn.Conv1d weights, read in place once,
//                    rounded to bf16 and packed tap-major, W[j][co][ci];
//   per unit, KT = 7: h2 = bf16(snake_a2(sum_j hs[t + (j - 3) d] . W7_j + b7));
//             KT = 1: x' = x + (h2 . W1 + b1), written in x's layout, then
//                     either the trailing snake (last unit) or the next
//                     unit's hs = bf16(snake_a1'(x')), time-major.
// Rows outside [0, T) and channels past C are zero, which is the TPU
// kernels' re-zeroing between units by construction.
//
// Bound: a unit does 32 C^2 flops per time step (16 C^2 multiply-adds)
// against 4 C bytes of bf16 input and output, 512 flops a byte already at
// C = 64, the narrowest stack; the card needs ~295 in bf16, so the stacks
// are bound by operations at every width of the model.
// Design:
// - mma.sync.m16n8k16 (bf16 in, fp32 accumulate). A block owns a
//   [TM rows x 32 output channels] tile (TM = 128, 64 or 32, chosen per
//   shape by the wrapper's pick_tile so that batch 1 fills 132 SMs), each
//   of its TM / 32 x 2 warps a 32 x 16 sub-tile (2 x 2 MMA tiles); see
//   MMA_TILES below.
// - Both operands are staged as they lie in memory, rows with the reduced
//   channel contiguous: H_s[t][ci] and W_s[j][co][ci]. A tap shift of
//   (j - 3) d then moves whole rows, so every ldmatrix row address stays
//   16-byte aligned for any d (shifting along the contiguous axis would not).
//   Rows are padded to 40 bf16 (80 bytes), which makes each 8-row ldmatrix
//   phase conflict-free.
// - The input channels stream through a ring of three shared-memory stages,
//   32 channels a stage, filled by cp.async (16 bytes a copy; C % 8 != 0 is
//   loaded plainly): two chunks are in flight while the MMAs run on a third,
//   with one __syncthreads a chunk. Each thread's copies are the same in
//   every chunk but for the channel offset, so their addresses are worked
//   out once, before the loop: computing them per copy cost as many
//   instructions as the MMAs.
// - Every snake runs once per element, in the prologue and the epilogues:
//   applying snake_a1 while staging recomputed it for every output-channel
//   tile and every chunk's halo, and cost more than the products; rounding
//   the fp32 weights while staging kept the loads in registers and out of
//   the pipeline.
// - The accumulators go through shared memory to the epilogue, which walks
//   the tile in the output's own order, so the stores are coalesced in the
//   channels-first layout as in the time-major one.
// No split of the reduction: each output's sum order is fixed from run to run.
// Everything here has internal linkage, so two libraries that include this
// header never resolve each other's kernels.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "resunit_groups.cuh"

namespace mma_core {
namespace {

using bf16 = __nv_bfloat16;
using resunit_groups::MAX_GROUPS;
using resunit_groups::Sets;
using resunit_groups::pick;

constexpr int CK = 32;            // input channels per stage: two k16 steps
constexpr int PITCH = CK + 8;     // bf16 per shared-memory row (80 bytes)
constexpr int MAX_DIL = 9;
constexpr int STAGES = 3;         // cp.async ring depth
constexpr int MAX_UNITS = 3;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

__device__ __forceinline__ float snake(float x, float a) {
  float s = sinf(a * x);
  return x + s * s / (a + 1e-9f);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldmatrix_x4(const bf16* p, uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes global -> shared; src_bytes = 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// A block's [TM x TN] output tile, WM x WN warps of (TM / WM) x (TN / WN)
template <int KT, int TM, int TN, int WM, int WN>
struct Tile {
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int MI = TM / WM / 16;    // m16 tiles per warp
  static constexpr int NI = TN / WN / 8;     // n8 tiles per warp
  static constexpr int WIN_MAX = TM + (KT - 1) * MAX_DIL;
  static constexpr int SEGS = CK / 8;        // 16-byte segments of a staged row
  // a thread's cp.async slots per chunk, for the H window and the W rows
  static constexpr int H_SLOTS = (WIN_MAX * SEGS + THREADS - 1) / THREADS;
  static constexpr int W_SLOTS = (KT * TN * SEGS + THREADS - 1) / THREADS;
  static constexpr int OPITCH = TN + 1;      // fp32 epilogue tile row
  static_assert(MI >= 1 && NI % 2 == 0 && THREADS % SEGS == 0, "tile");

  static size_t smem_bytes(int win) {
    size_t stage = (size_t)(win + KT * TN) * PITCH * sizeof(bf16);
    size_t epi = (size_t)TM * OPITCH * sizeof(float);
    return STAGES * stage > epi ? STAGES * stage : epi;
  }
};

// in: hs (KT = 7) or h2 (KT = 1), bf16 [B, T, C]; S: the weight sets
// (resunit_groups.cuh), block z reading set z % S.n: w this unit's packed
// bf16 weights, [KT][C_out][C_in], bias, alpha_out, alpha_next.
// KT = 7: out = h2 bf16 [B, T, C]; alpha_out = a2; resid, alpha_next and
//         hs_next unused.
// KT = 1: resid (type TX) and out (type TO) are [B, C, T] when CF (K1), else
//         [B, T, C]; alpha_out = the trailing snake or null; with hs_next not
//         null (not the last unit), hs_next = bf16(snake_alpha_next(x')) [B,
//         T, C]. K1 rounds x' to bf16 (its carry) before either snake; K3's
//         carry x' stays fp32.
// (two blocks an SM, which their shared memory allows: registers up to 128)
template <int KT, int TM, int TN, int WM, int WN, bool CF, typename TX, typename TO>
__global__ void __launch_bounds__(32 * WM * WN, 2)
mma_unit_kernel(const bf16* __restrict__ in, const Sets S, const void* __restrict__ resid_,
                void* __restrict__ out_, bf16* __restrict__ hs_next, int C, int Tlen,
                int dil) {
  using G = Tile<KT, TM, TN, WM, WN>;
  constexpr bool OUT_CF = KT == 1 && CF;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = blockIdx.x * TM, co0 = blockIdx.y * TN;
  const size_t base = (size_t)blockIdx.z * C * Tlen;
  const int grp = blockIdx.z % S.n;               // this row's weight set
  const bf16* __restrict__ w = (const bf16*)pick(S.w, grp);
  const float* __restrict__ bias = pick(S.bias, grp);
  const float* __restrict__ alpha_out = pick(S.alpha_out, grp);
  const float* __restrict__ alpha_next = pick(S.alpha_next, grp);
  const int halo = (KT - 1) / 2 * dil;
  const int win = TM + 2 * halo;
  const int stage_elems = (win + KT * TN) * PITCH;
  const bool async = C % 8 == 0;       // rows of 16-byte aligned segments
  const int wm = (warp / WN) * (TM / WM), wn = (warp % WN) * (TN / WN);

  // This thread's copies, the same for every chunk but for the channel
  // offset c0: shared-memory offset (-1: no copy) and element offset of the
  // 16 bytes at c0 = 0 (-1: outside the signal or past C_out, zero-filled).
  // Its segment within a row is the same for all of them.
  const int seg = 8 * (tid % G::SEGS);
  int h_dst[G::H_SLOTS], h_src[G::H_SLOTS], w_dst[G::W_SLOTS], w_src[G::W_SLOTS];
#pragma unroll
  for (int s = 0; s < G::H_SLOTS; ++s) {
    const int r = (tid + s * G::THREADS) / G::SEGS, t = t0 - halo + r;
    h_dst[s] = r < win ? r * PITCH + seg : -1;
    h_src[s] = t >= 0 && t < Tlen ? t * C + seg : -1;
  }
#pragma unroll
  for (int s = 0; s < G::W_SLOTS; ++s) {
    const int row = (tid + s * G::THREADS) / G::SEGS;   // j * TN + n
    const int co = co0 + row % TN;
    w_dst[s] = row < KT * TN ? row * PITCH + seg : -1;
    w_src[s] = co < C ? ((row / TN) * C + co) * C + seg : -1;
  }

  // chunk c0 .. c0 + 32 of input channels into a stage: H rows t0 - halo ..
  // and W rows (j, co0 ..); zero outside [0, T) and past C
  auto fetch = [&](int stage, int c0) {
    bf16* H = (bf16*)smem + stage * stage_elems;
    bf16* W = H + win * PITCH;
    if (async) {
      const bool in_c = c0 + seg < C;
#pragma unroll
      for (int s = 0; s < G::H_SLOTS; ++s)
        if (h_dst[s] >= 0) {
          const bool ok = in_c && h_src[s] >= 0;
          cp_async16(H + h_dst[s], in + base + (ok ? h_src[s] + c0 : 0), ok ? 16 : 0);
        }
#pragma unroll
      for (int s = 0; s < G::W_SLOTS; ++s)
        if (w_dst[s] >= 0) {
          const bool ok = in_c && w_src[s] >= 0;
          cp_async16(W + w_dst[s], w + (ok ? w_src[s] + c0 : 0), ok ? 16 : 0);
        }
    } else {
      const bf16 zero = __float2bfloat16(0.f);
      for (int i = tid; i < win * CK; i += G::THREADS) {
        const int r = i / CK, c = i % CK;
        const int t = t0 - halo + r, ci = c0 + c;
        H[r * PITCH + c] = (t >= 0 && t < Tlen && ci < C) ? in[base + (size_t)t * C + ci] : zero;
      }
      for (int i = tid; i < KT * TN * CK; i += G::THREADS) {
        const int row = i / CK, c = i % CK;
        const int j = row / TN, co = co0 + row % TN, ci = c0 + c;
        W[row * PITCH + c] = (co < C && ci < C) ? w[((size_t)j * C + co) * C + ci] : zero;
      }
    }
  };

  float acc[G::MI][G::NI][4];
#pragma unroll
  for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < G::NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  auto compute = [&](int stage) {
    const bf16* H = (const bf16*)smem + stage * stage_elems;
    const bf16* W = H + win * PITCH;
#pragma unroll
    for (int kk = 0; kk < CK; kk += 16)
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        uint32_t b[G::NI][2];
#pragma unroll
        for (int nb = 0; nb < G::NI / 2; ++nb)
          ldmatrix_x4(W + (j * TN + wn + 16 * nb + (lane & 7) + (lane >> 4) * 8) * PITCH
                          + kk + ((lane >> 3) & 1) * 8,
                      b[2 * nb][0], b[2 * nb][1], b[2 * nb + 1][0], b[2 * nb + 1][1]);
#pragma unroll
        for (int mi = 0; mi < G::MI; ++mi) {
          uint32_t a[4];
          ldmatrix_x4(H + (wm + 16 * mi + j * dil + (lane & 15)) * PITCH + kk
                          + (lane >> 4) * 8,
                      a[0], a[1], a[2], a[3]);
#pragma unroll
          for (int ni = 0; ni < G::NI; ++ni) mma_bf16(acc[mi][ni], a, b[ni]);
        }
      }
  };

  // ring of STAGES: chunk k is computed while chunks k + 1, k + 2 are in flight
  const int nchunks = (C + CK - 1) / CK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nchunks) fetch(s, s * CK);
    cp_async_commit();
  }
  for (int k = 0; k < nchunks; ++k) {
    cp_async_wait<STAGES - 2>();      // this thread's copies of chunk k landed
    __syncthreads();                  // everyone's, and chunk k - 1's stage is free
    const int kn = k + STAGES - 1;
    if (kn < nchunks) fetch(kn % STAGES, kn * CK);
    cp_async_commit();
    compute(k % STAGES);
  }
  cp_async_wait<0>();
  __syncthreads();

  // accumulators -> shared fp32 tile -> epilogue in the output's order
  float* O = (float*)smem;
  {
    const int g = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < G::NI; ++ni) {
        const int r = wm + 16 * mi + g, c = wn + 8 * ni + 2 * tq;
        O[r * G::OPITCH + c] = acc[mi][ni][0];
        O[r * G::OPITCH + c + 1] = acc[mi][ni][1];
        O[(r + 8) * G::OPITCH + c] = acc[mi][ni][2];
        O[(r + 8) * G::OPITCH + c + 1] = acc[mi][ni][3];
      }
  }
  __syncthreads();
  for (int i = tid; i < TM * TN; i += G::THREADS) {
    const int r = OUT_CF ? i % TM : i / TN;
    const int c = OUT_CF ? i / TM : i % TN;
    const int t = t0 + r, co = co0 + c;
    if (t >= Tlen || co >= C) continue;
    float v = O[r * G::OPITCH + c] + bias[co];
    if (KT == 7) {
      ((bf16*)out_)[base + (size_t)t * C + co] = __float2bfloat16(snake(v, alpha_out[co]));
    } else {
      const size_t o = OUT_CF ? base + (size_t)co * Tlen + t : base + (size_t)t * C + co;
      v = to_f(((const TX*)resid_)[o]) + v;
      if (OUT_CF) v = __bfloat162float(__float2bfloat16(v));   // K1's bf16 carry
      if (alpha_out != nullptr) v = snake(v, alpha_out[co]);
      ((TO*)out_)[o] = from_f<TO>(v);
      O[r * G::OPITCH + c] = v;
    }
  }
  if (KT == 1 && hs_next != nullptr) {     // the next unit's operand, time-major
    __syncthreads();
    for (int i = tid; i < TM * TN; i += G::THREADS) {
      const int r = i / TN, c = i % TN;
      const int t = t0 + r, co = co0 + c;
      if (t < Tlen && co < C)
        hs_next[base + (size_t)t * C + co] =
            __float2bfloat16(snake(O[r * G::OPITCH + c], alpha_next[co]));
    }
  }
}

// The fp32 weights of G stacks of n units: w7[s] [C, C, 7] and w1[s] [C, C, 1]
// (nn.Conv1d) of set g's unit u at s = g n + u.
constexpr int MAX_STACKED = MAX_GROUPS * MAX_UNITS;
struct StackWeights {
  const float* w7[MAX_STACKED];
  const float* w1[MAX_STACKED];
};

// Unit u's k = KT weights W[co, ci, j] (fp32, nn.Conv1d layout) rounded to
// bf16 into dst + u * 8 C^2 as [j][co][ci], for u < n_units (all the sets'
// units, g n + u). An item is one output channel's
// 4 input channels: 4 KT contiguous floats in, KT runs of 4 bf16 out, so
// neighbouring threads read and write neighbouring addresses. vec: C % 4 == 0
// and the weights 16-byte aligned, so an item is KT float4 loads and KT
// 8-byte stores.
template <int KT>
__device__ __forceinline__ void pack_weights(const float* const (&w)[MAX_STACKED], int n_units,
                                             int C, bool vec, bf16* __restrict__ dst,
                                             long long first, long long stride) {
  const int n4 = (C + 3) / 4;
  const long long items = (long long)n_units * C * n4;
  for (long long it = first; it < items; it += stride) {
    const int ci0 = 4 * (int)(it % n4);
    const int co = (int)((it / n4) % C);
    const int u = (int)(it / ((long long)n4 * C));
    const float* src = w[u] + ((size_t)co * C + ci0) * KT;
    bf16* out = dst + (size_t)u * 8 * C * C + (size_t)co * C + ci0;
    float v[4 * KT];                      // v[c * KT + j] = W[co, ci0 + c, j]
    if (vec) {
#pragma unroll
      for (int q = 0; q < KT; ++q) {
        const float4 f = ((const float4*)src)[q];
        v[4 * q] = f.x, v[4 * q + 1] = f.y, v[4 * q + 2] = f.z, v[4 * q + 3] = f.w;
      }
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        __nv_bfloat162 lo = __floats2bfloat162_rn(v[j], v[KT + j]);
        __nv_bfloat162 hi = __floats2bfloat162_rn(v[2 * KT + j], v[3 * KT + j]);
        uint2 pair;
        pair.x = *(uint32_t*)&lo;
        pair.y = *(uint32_t*)&hi;
        *(uint2*)(out + (size_t)j * C * C) = pair;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4 * KT; ++e) v[e] = ci0 + e / KT < C ? src[e] : 0.f;
#pragma unroll
      for (int j = 0; j < KT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (ci0 + c < C) out[(size_t)j * C * C + c] = __float2bfloat16(v[c * KT + j]);
    }
  }
}

// The first snake_blocks blocks: hs = bf16(snake_alpha(x)) [B, T, C] from x
// [B, C, T] (CF) or [B, T, C], in 32 x 32 tiles through shared memory, so
// that reads and writes are both coalesced when the layouts differ; row z
// takes set z % A.n's alpha (A.alpha_in). The other blocks: each stacked
// unit s's weights rounded to bf16 into wp + s * 8 C^2, w7 as
// [7][C_out][C_in], then w1 as [C_out][C_in].
template <bool CF>
__global__ void __launch_bounds__(256)
prologue_kernel(const bf16* __restrict__ x, const Sets A, bf16* __restrict__ hs, int C,
                int Tlen, int snake_blocks, StackWeights sw, int n_units, bool vec,
                bf16* __restrict__ wp) {
  const int tid = threadIdx.x;
  if ((int)blockIdx.x < snake_blocks) {
    __shared__ float tile[32][33];
    const int tiles_t = (Tlen + 31) / 32, tiles_c = (C + 31) / 32;
    const int bt = blockIdx.x % tiles_t, bc = (blockIdx.x / tiles_t) % tiles_c;
    const int z = blockIdx.x / (tiles_t * tiles_c);
    const size_t base = (size_t)z * C * Tlen;
    const float* __restrict__ alpha = pick(A.alpha_in, z % A.n);
    const int t0 = bt * 32, c0 = bc * 32, tx = tid & 31, ty = tid >> 5;
    for (int k = ty; k < 32; k += 8) {
      // CF: lanes along t; time-major: lanes along c
      const int t = CF ? t0 + tx : t0 + k, c = CF ? c0 + k : c0 + tx;
      if (t < Tlen && c < C) {
        const size_t o = CF ? base + (size_t)c * Tlen + t : base + (size_t)t * C + c;
        const float v = snake(__bfloat162float(x[o]), alpha[c]);
        if (CF) tile[k][tx] = v;
        else tile[tx][k] = v;
      }
    }
    __syncthreads();
    for (int k = ty; k < 32; k += 8) {
      const int t = t0 + k, c = c0 + tx;
      if (t < Tlen && c < C) hs[base + (size_t)t * C + c] = __float2bfloat16(tile[tx][k]);
    }
    return;
  }
  const long long first = (long long)(blockIdx.x - snake_blocks) * blockDim.x + tid;
  const long long stride = (long long)(gridDim.x - snake_blocks) * blockDim.x;
  pack_weights<7>(sw.w7, n_units, C, vec, wp, first, stride);
  pack_weights<1>(sw.w1, n_units, C, vec, wp + (size_t)7 * C * C, first, stride);
}

template <int KT, int TM, int TN, int WM, int WN, bool CF, typename TX, typename TO>
int launch_tile(const void* in, const Sets& S, const void* resid, void* out, void* hs_next,
                int B, int C, int Tlen, int dil, void* stream) {
  using G = Tile<KT, TM, TN, WM, WN>;
  auto kernel = mma_unit_kernel<KT, TM, TN, WM, WN, CF, TX, TO>;
  // above 48 KB of dynamic shared memory needs the opt-in, once per kernel
  static const int attr = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::smem_bytes(G::WIN_MAX));
  if (attr != 0) return attr;
  dim3 grid((Tlen + TM - 1) / TM, (C + TN - 1) / TN, B);
  kernel<<<grid, G::THREADS, G::smem_bytes(TM + (KT - 1) * dil), (cudaStream_t)stream>>>(
      (const bf16*)in, S, resid, out, (bf16*)hs_next, C, Tlen, dil);
  return (int)cudaGetLastError();
}

// The tiles (TM, TN) with their warp layouts (WM, WN), as ops/resunit.py's
// TILES lists them: of the tiles and layouts timed on the card (128 or 64
// rows, 32 or 64 channels, warps of 64 x 32 down to 32 x 16), these were
// fastest where the grid fills the card.
#define MMA_TILES(X) X(128, 32, 4, 2) X(64, 32, 2, 2) X(32, 32, 1, 2)

// one unit's launch over the weight sets S (B rows in all) with the (t_tile,
// co_tile) that the wrapper's pick_tile chose
template <int KT, bool CF, typename TX, typename TO>
int launch(int t_tile, int co_tile, const void* in, const Sets& S, const void* resid,
           void* out, void* hs_next, int B, int C, int Tlen, int dil, void* stream) {
  if (S.n < 1 || B % S.n != 0) return (int)cudaErrorInvalidValue;
#define MMA_TILE(TM_, TN_, WM_, WN_)                                                  \
  if (t_tile == TM_ && co_tile == TN_)                                                \
    return launch_tile<KT, TM_, TN_, WM_, WN_, CF, TX, TO>(in, S, resid, out, hs_next, B, \
                                                           C, Tlen, dil, stream);
  MMA_TILES(MMA_TILE)
#undef MMA_TILE
  return (int)cudaErrorInvalidValue;
}

// dynamic shared memory of a launch of the tile at dilation dil (KT = 7)
inline int smem_bytes(int kt, int t_tile, int co_tile, int dil) {
#define MMA_TILE(TM_, TN_, WM_, WN_)                                                  \
  if (t_tile == TM_ && co_tile == TN_)                                                \
    return kt == 7 ? (int)Tile<7, TM_, TN_, WM_, WN_>::smem_bytes(TM_ + 6 * dil)       \
                   : (int)Tile<1, TM_, TN_, WM_, WN_>::smem_bytes(TM_);
  MMA_TILES(MMA_TILE)
#undef MMA_TILE
  return -1;
}

// the prologue of bf16 stacks of n_units over the sets A (A.alpha_in: each
// set's unit-0 snake): x bf16 [B rows]; w7[s], w1[s] fp32 of set g's unit u at
// s = g n_units + u; wp bf16 [A.n n_units 8 C^2]
template <bool CF>
int launch_prologue(const void* x, const Sets& A, void* hs, const void* const* w7,
                    const void* const* w1, int n_units, void* wp, int B, int C, int Tlen,
                    void* stream) {
  if (n_units < 1 || n_units > MAX_UNITS || A.n < 1 || B % A.n != 0)
    return (int)cudaErrorInvalidValue;
  const int stacked = A.n * n_units;
  StackWeights sw = {};
  bool vec = C % 4 == 0;
  for (int u = 0; u < stacked; ++u) {
    sw.w7[u] = (const float*)w7[u];
    sw.w1[u] = (const float*)w1[u];
    vec = vec && (uintptr_t)w7[u] % 16 == 0 && (uintptr_t)w1[u] % 16 == 0;
  }
  const int snake_blocks = ((Tlen + 31) / 32) * ((C + 31) / 32) * B;
  const long long items = (long long)stacked * C * ((C + 3) / 4);   // per kernel size
  const int pack_blocks = (int)((items + 255) / 256 < 4096 ? (items + 255) / 256 : 4096);
  prologue_kernel<CF><<<snake_blocks + pack_blocks, 256, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, A, (bf16*)hs, C, Tlen, snake_blocks, sw, stacked, vec, (bf16*)wp);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace mma_core
