// FFMA product core of the residual-unit stacks K1 (resunit_stack.cu) and
// K3 (resunit_stack_tm.cu), fp32 operands, for Hopper (sm_90a).
//
// An fp32 stack of n units is 2 n launches, each in x's own layout
// (channels-first [B, C, T] for K1, time-major [B, T, C] for K3):
//   KT = 7: h2 = snake_a2(sum_ci sum_j W7[co, ci, j] h[ci, t + (j - 3) d] + b7),
//           where h = snake_a1(x) is snaked on the way in (unit 0: alpha_in
//           given) or read as the previous k=1 launch wrote it (alpha_in null);
//   KT = 1: x' = x + (W1 . h2 + b1), then the trailing snake (last unit), or
//           beside x' the next unit's operand hs = snake_a1'(x'), so that every
//           snake but unit 0's input one runs once per element.
// Rows outside [0, T) and channels past C are zero.
//
// Sum order, which the fp32 gates rest on: every output is one fmaf chain from
// 0 over the input channels in ascending order and, within a channel, over the
// taps in ascending order (j = 0..6); the bias is added after. That is the
// order of cuDNN's fp32 kernels for these convolutions, so K1 is bit-equal to
// its plain version. No split of the reduction, no reordering.
//
// Bound: a unit is 16 C^2 T multiply-adds against about six passes of C T
// fp32 values, 4 C / 6 flops a byte, above the card's 20 (67 TFLOP/s of FFMA
// over 3.35 TB/s) at every width of the model (C >= 64): bound by operations.
// Design:
// - A thread owns 4 output channels x WT = 8 time steps taken at a stride of
//   the dilation d: its "slot" (g, r) holds t = r + d (8 g + k), k = 0..7.
//   The 7 taps of one input channel then slide over one register window of
//   14 inputs, h[r + d (8 g - 3 + i)], whatever d is: 14 shared loads a
//   channel instead of 56. (WT = 4 where the grid would leave SMs short of
//   warps: a 10-input window, twice the threads.) Slots are numbered s = g d + r, and a block takes
//   NTG consecutive ones, so its positions cover a contiguous stretch of time
//   (any d, nothing rounded up per residue), staged as one window.
// - Weights are staged [ci * KT + j][co], so a thread's 4 channels of one tap
//   are one LDS.128: a channel of a k=7 launch is 14 LDS.32 and 7 LDS.128
//   against 224 FFMA; lanes are 4 slots x 8 channel quads. (8 channels a
//   thread, 448 FFMA to 28 loads, timed slower on the H100 at every stack
//   shape, batch 1 and 8.)
// - Input windows and weight chunks (8 input channels, 32 for k = 1) stream
//   through two shared-memory stages filled by cp.async: chunk k + 1 loads
//   while chunk k computes, one __syncthreads a chunk (a third stage, timed,
//   gained nothing on the H100 and cost occupancy). K1 copies 16-byte segments where the
//   rows allow; the weights are read in place from nn.Conv1d's [C_out, C_in,
//   k] layout and transposed by 4-byte copies, lanes 4 channels x 8
//   consecutive (ci, j), so that reads are coalesced and the shared-memory
//   writes conflict-free. Each thread's copy addresses are set up once.
// - Unit 0's snake runs on the staged window (SNAKE): each thread snakes its
//   own 4-byte copies of chunk k + 1 after computing chunk k, so no barrier is
//   added and other warps' products overlap the sinf chains. It is the only
//   snake computed more than once per element (once per channel tile).
// - The tile (t_tile x co_tile) is chosen per shape by the wrapper
//   (ops/resunit.py::pick_ffma_tile).
// - The accumulators go through shared memory to the epilogue, which walks
//   the tile in the output's own order, so stores are coalesced in both
//   layouts.
// Everything here has internal linkage, so two libraries that include this
// header never resolve each other's kernels.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "resunit_groups.cuh"

namespace ffma_core {
namespace {

using resunit_groups::Sets;
using resunit_groups::pick;

constexpr int MAX_DIL = 9;
constexpr int STAGES = 2;       // cp.async ring depth

__device__ __forceinline__ float snake(float x, float a) {
  float s = sinf(a * x);
  return x + s * s / (a + 1e-9f);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 4 bytes global -> shared; ok = false writes zero and reads nothing
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 4 : 0));
}
// 16 bytes global -> shared; ok = false writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The longest input window of a k=7 block of ntg slots of wt steps at any
// d <= MAX_DIL: they span at most (ntg + d - 2) / d + 1 groups of wt d steps,
// with 3 d of halo on each side.
constexpr int win_max(int ntg, int wt) {
  int m = 0;
  for (int d = 1; d <= MAX_DIL; ++d) {
    const int win = wt * d * ((ntg + d - 2) / d + 1) + 6 * d;
    m = win > m ? win : m;
  }
  return m;
}

// A block of WM x WN warps; a warp is 4 slots x 8 quads of channels, a
// thread 4 channels x STEPS steps (8, or 4 where a grid needs more warps).
template <int KT, bool CF, int WM, int WN, int STEPS>
struct Tile {
  static constexpr int WT = STEPS;               // time steps a thread, at a stride of d
  static_assert(WT == 4 || WT == 8, "4 or 8 steps a thread");
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int NTG = 4 * WM;             // slots a block
  static constexpr int TM = WT * NTG;            // outputs along t a block
  static constexpr int TN = 32 * WN;             // output channels a block
  static constexpr int CK = KT == 7 ? 8 : 32;    // input channels a stage
  static constexpr int HALO = (KT - 1) / 2;      // taps each side, in strides
  static constexpr int WIN = WT + 2 * HALO;      // a thread's inputs a channel
  static constexpr int WIN_MAX = KT == 7 ? win_max(NTG, WT) : TM;   // KT = 1: exactly TM
  // input row of a stage, In[c][step]: K1 copies 16-byte segments from a
  // 16-byte aligned start, so up to 3 more steps, in 16-byte rows; K3's
  // transposing copies write a column of channels, odd rows spread them over
  // the banks; KT = 1 reads two LDS.128 a channel, 16-byte rows
  static constexpr int PIN =
      KT == 1 ? TM + 4 : CF ? (WIN_MAX + 3 + 3) / 4 * 4 : WIN_MAX | 1;
  static constexpr int PW = TN + 4;              // weight row: [ci * KT + j][co]
  static constexpr int IN_FLOATS = CK * PIN;
  static constexpr int STAGE = IN_FLOATS + CK * KT * PW;
  static constexpr int NW = WM * WN;
  static constexpr int CV = TN / (4 * NW);       // weight copies a lane: channel quads
  static constexpr int EU = CK * KT / 8;         //   and (ci, j) rows
  static_assert(TN % (4 * NW) == 0 && (CK * KT) % 8 == 0 && STAGE % 4 == 0 &&
                IN_FLOATS % 4 == 0, "tile");

  static constexpr int O_FLOATS = (TM + 4) * (TN + 4);   // the epilogue's tile, either layout
  // the ring, or the epilogue's fp32 tile where that is larger
  static constexpr int smem_bytes() {
    return 4 * (STAGES * STAGE > O_FLOATS ? STAGES * STAGE : O_FLOATS);
  }
  // blocks an SM holds by shared memory (at most 512 threads): the register
  // cap follows, so that what the shared memory allows is not spent on spills
  static constexpr int MIN_BLOCKS =
      232448 / smem_bytes() < 512 / THREADS ? 232448 / smem_bytes() : 512 / THREADS;
};

// in: x or hs (KT = 7), h2 (KT = 1); S: the weight sets (resunit_groups.cuh),
// block z reading set z % S.n: w fp32 [C_out, C_in, KT] (nn.Conv1d), bias,
// alpha_in, alpha_out, alpha_next.
// KT = 7: out = h2; SNAKE: alpha_in = snake_a1, applied to each staged
//         element (unit 0), else `in` is already snaked; alpha_out = a2;
//         resid, alpha_next, hs_next unused.
// KT = 1: out = x' = resid + (W1 . h2 + b1), then snake_alpha_out when
//         alpha_out is not null; with hs_next not null, also hs_next =
//         snake_alpha_next(x'). All [B, C, T] when CF (K1), else [B, T, C].
template <int KT, bool CF, bool SNAKE, int WM, int WN, int STEPS>
__global__ void __launch_bounds__(32 * WM * WN, (Tile<KT, CF, WM, WN, STEPS>::MIN_BLOCKS))
ffma_unit_kernel(const float* __restrict__ in, const Sets S, const float* __restrict__ resid,
                 float* __restrict__ out, float* __restrict__ hs_next, int C, int Tlen,
                 int dil) {
  using G = Tile<KT, CF, WM, WN, STEPS>;
  constexpr int WT = G::WT;
  extern __shared__ __align__(16) float ffma_smem[];
  __shared__ int slot_t[G::NTG];        // each slot's first output step

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int d = KT == 7 ? dil : 1;
  const int s0 = blockIdx.x * G::NTG, co0 = blockIdx.y * G::TN;
  const size_t base = (size_t)blockIdx.z * C * Tlen;
  const int grp = blockIdx.z % S.n;               // this row's weight set
  const float* __restrict__ w = (const float*)pick(S.w, grp);
  const float* __restrict__ bias = pick(S.bias, grp);
  const float* __restrict__ alpha_in = pick(S.alpha_in, grp);
  const float* __restrict__ alpha_out = pick(S.alpha_out, grp);
  const float* __restrict__ alpha_next = pick(S.alpha_next, grp);
  // the block's input window [t_lo, t_lo + win): its slots' g, with the halo
  const int g_lo = s0 / d, g_hi = (s0 + G::NTG - 1) / d;
  const int t_lo = WT * d * g_lo - G::HALO * d;
  const int win = WT * d * (g_hi - g_lo + 1) + 2 * G::HALO * d;
  if (tid < G::NTG) slot_t[tid] = (s0 + tid) % d + WT * d * ((s0 + tid) / d);
  // K1 stages 16-byte segments where rows allow (T % 4 == 0, x 16-byte
  // aligned): from t_w = t_lo rounded down to a multiple of 4, each segment
  // then wholly inside [0, T) or wholly outside; else 4-byte copies from t_lo,
  // and under SNAKE too, so that every thread snakes a share of the window
  const bool vec = CF && !SNAKE && Tlen % 4 == 0 && ((uintptr_t)in & 15) == 0;
  const int t_w = vec ? t_lo & ~3 : t_lo;
  const int wlen = t_lo + win - t_w;              // staged steps a row

  // this thread: slot sl (4 a warp), channels co_w + {0..3}
  const int sl = 4 * wm + (lane >> 3);
  const int my_t = (s0 + sl) % d + WT * d * ((s0 + sl) / d);
  const int p0 = my_t - G::HALO * d - t_w;       // window offset of its input 0
  const int co_w = 32 * wn + 4 * (lane & 7);
  // a warp whose slots all lie past T computes nothing (it still copies)
  const bool active = __any_sync(0xffffffffu, my_t < Tlen);

  // The input copies, the same every chunk but for the channel offset:
  // 16-byte ones, a thread's units u (+ UP ...) of its CPG rows (channels);
  // else 4-byte ones, a thread's channel c of steps r (+ RPP ...), which in
  // K3 transposes rows of C into In[c][step]. A copy not ok (outside [0, T),
  // past C) zero-fills and reads nothing.
  constexpr int NUV = KT == 1 ? G::TM / 4 : (G::WIN_MAX + 6) / 4;   // 16-byte units, at most
  constexpr int UP0 = NUV <= 32 ? 32 : NUV <= 64 ? 64 : 128;
  constexpr int UP = UP0 < G::THREADS ? UP0 : G::THREADS;  // threads a row
  constexpr int CPG = G::CK / (G::THREADS / UP);          // rows a thread
  constexpr int RPP = G::THREADS / G::CK;                 // steps a pass (4-byte)
  const int n_units = (wlen + 3) / 4;
  const int cg0 = tid / UP * CPG;                         // the thread's first row

  // the weights of this thread's copies: channel quads v, rows e_l + 8 u of
  // a stage's Wt[c * KT + j][co]; row 0 stands in past C_out (zero-filled)
  const int e_l = lane >> 2, c_l = lane & 3;
  const float* wsrc[G::CV];
  int wdst[G::CV];
  bool wok[G::CV];
#pragma unroll
  for (int v = 0; v < G::CV; ++v) {
    const int col = 4 * (warp + G::NW * v) + c_l;
    wok[v] = co0 + col < C;
    wsrc[v] = w + (size_t)(wok[v] ? co0 + col : 0) * C * KT + e_l;
    wdst[v] = e_l * G::PW + col;
  }

  // chunk ci0 .. ci0 + CK into a stage
  auto fetch = [&](int stage, int ci0) {
    float* In = ffma_smem + stage * G::STAGE;
    float* Wt = In + G::IN_FLOATS;
    if (vec) {       // K1: a thread's 16-byte units u (+ UP ...) of its CPG rows
      const float* row = in + base + (size_t)(ci0 + cg0) * Tlen + t_w;
      for (int u = tid % UP; u < n_units; u += UP) {
        const int t = t_w + 4 * u;
        const bool t_ok = t >= 0 && t < Tlen;
#pragma unroll
        for (int c = 0; c < CPG; ++c) {
          const bool ok = t_ok && ci0 + cg0 + c < C;
          cp_async16(In + (cg0 + c) * G::PIN + 4 * u, ok ? row + (size_t)c * Tlen + 4 * u : in,
                     ok);
        }
      }
    } else {         // a thread's channel c of steps r (+ RPP ...), 4 bytes each
      const int c = tid % G::CK;
      const bool c_ok = ci0 + c < C;
      for (int r = tid / G::CK; r < wlen; r += RPP) {
        const int t = t_w + r;
        const bool ok = c_ok && t >= 0 && t < Tlen;
        const size_t g = CF ? (size_t)(ci0 + c) * Tlen + t : (size_t)t * C + ci0 + c;
        cp_async4(In + c * G::PIN + r, ok ? in + base + g : in, ok);
      }
    }
    const int lim = (C - ci0) * KT - e_l;      // rows e_l + 8 u < lim hold channels < C
#pragma unroll
    for (int v = 0; v < G::CV; ++v) {
      const float* g = wsrc[v] + ci0 * KT;
#pragma unroll
      for (int u = 0; u < G::EU; ++u)
        cp_async4(Wt + wdst[v] + 8 * u * G::PW, g + 8 * u, wok[v] && 8 * u < lim);
    }
  };

  // SNAKE: snake_a1 on this thread's own (4-byte) copies of a chunk, once
  // they landed (the next __syncthreads publishes them); every element once
  auto snake_own = [&](int stage, int ci0) {
    float* In = ffma_smem + stage * G::STAGE;
    const int c = tid % G::CK;
    if (ci0 + c >= C) return;
    const float a = alpha_in[ci0 + c];
#pragma unroll 4
    for (int r = tid / G::CK; r < wlen; r += RPP)
      if (t_w + r >= 0 && t_w + r < Tlen) In[c * G::PIN + r] = snake(In[c * G::PIN + r], a);
  };

  float acc[4][WT];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int k = 0; k < WT; ++k) acc[c][k] = 0.f;

  auto compute = [&](int stage) {
    const float* In = ffma_smem + stage * G::STAGE + p0;
    const float* Wt = ffma_smem + stage * G::STAGE + G::IN_FLOATS;
#pragma unroll
    for (int c = 0; c < G::CK; ++c) {
      float h[G::WIN];
      if constexpr (KT == 7) {
#pragma unroll
        for (int i = 0; i < G::WIN; ++i) h[i] = In[c * G::PIN + d * i];
      } else {        // d = 1, p0 = 8 sl: two aligned LDS.128
#pragma unroll
        for (int i = 0; i < G::WIN; i += 4) {
          const float4 f = *(const float4*)(In + c * G::PIN + i);
          h[i] = f.x, h[i + 1] = f.y, h[i + 2] = f.z, h[i + 3] = f.w;
        }
      }
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        const float4 f = *(const float4*)(Wt + (c * KT + j) * G::PW + co_w);
        const float wv[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
        for (int k = 0; k < WT; ++k)
#pragma unroll
          for (int n = 0; n < 4; ++n) acc[n][k] = fmaf(wv[n], h[k + j], acc[n][k]);
      }
    }
  };

  // ring of STAGES: chunk k computes while chunk k + 1 loads. Under SNAKE
  // each thread then snakes its copies of chunk k + 1, overlapping other
  // warps' products, before the next iteration's barrier publishes them.
  const int nchunks = (C + G::CK - 1) / G::CK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nchunks) fetch(s, s * G::CK);
    cp_async_commit();
  }
  if constexpr (SNAKE) {
    cp_async_wait<0>();
    snake_own(0, 0);
  }
  for (int k = 0; k < nchunks; ++k) {
    cp_async_wait<STAGES - 2>();      // this thread's copies of chunk k landed
    __syncthreads();                  // everyone's, and chunk k - 1's stage is free
    const int kn = k + STAGES - 1;
    if (kn < nchunks) fetch(kn % STAGES, kn * G::CK);
    cp_async_commit();
    if (active) compute(k % STAGES);
    if constexpr (SNAKE) {
      if (k + 1 < nchunks) {
        cp_async_wait<0>();
        snake_own((k + 1) % STAGES, (k + 1) * G::CK);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // accumulators -> shared fp32 tile, O[co][n] (CF) or O[n][co], n = WT sl + k
  float* O = ffma_smem;
  constexpr int PO = CF ? G::TM + 4 : G::TN + 4;
  if constexpr (CF) {
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int k = 0; k < WT; k += 4)
        *(float4*)(O + (co_w + n) * PO + WT * sl + k) =
            make_float4(acc[n][k], acc[n][k + 1], acc[n][k + 2], acc[n][k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < WT; ++k)
      *(float4*)(O + (WT * sl + k) * PO + co_w) =
          make_float4(acc[0][k], acc[1][k], acc[2][k], acc[3][k]);
  }
  __syncthreads();
#pragma unroll 8
  for (int i = tid; i < G::TM * G::TN; i += G::THREADS) {
    const int col = CF ? i / G::TM : i % G::TN;
    const int n = CF ? i % G::TM : i / G::TN;
    // channels-first at d > 1: consecutive slots (residues) first, so that
    // neighbouring threads store neighbouring steps
    const bool by_slot = CF && d > 1;
    const int s = by_slot ? n % G::NTG : n / WT, k = by_slot ? n / G::NTG : n % WT;
    const int t = slot_t[s] + d * k, co = co0 + col;
    if (t >= Tlen || co >= C) continue;
    float v = O[CF ? col * PO + WT * s + k : (WT * s + k) * PO + col] + bias[co];
    const size_t o = CF ? base + (size_t)co * Tlen + t : base + (size_t)t * C + co;
    if constexpr (KT == 7) {
      out[o] = snake(v, alpha_out[co]);
    } else {
      v = resid[o] + v;
      if (alpha_out != nullptr) v = snake(v, alpha_out[co]);
      out[o] = v;
      if (hs_next != nullptr) hs_next[o] = snake(v, alpha_next[co]);
    }
  }
}

// the grid of a launch: slots of WT d steps each, d to a group of d slots
template <int KT, int WM, int WN, int STEPS>
dim3 grid_of(int B, int C, int Tlen, int dil) {
  using G = Tile<KT, true, WM, WN, STEPS>;
  const int d = KT == 7 ? dil : 1;
  const long long slots = (long long)d * ((Tlen + G::WT * d - 1) / (G::WT * d));
  return dim3((unsigned)((slots + G::NTG - 1) / G::NTG), (C + G::TN - 1) / G::TN, B);
}

template <int KT, bool CF, bool SNAKE, int WM, int WN, int STEPS>
int launch_tile(const void* in, const Sets& S, const void* resid, void* out, void* hs_next,
                int B, int C, int Tlen, int dil, void* stream) {
  using G = Tile<KT, CF, WM, WN, STEPS>;
  auto kernel = ffma_unit_kernel<KT, CF, SNAKE, WM, WN, STEPS>;
  // above 48 KB of dynamic shared memory needs the opt-in, once per kernel
  static const int attr = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::smem_bytes());
  if (attr != 0) return attr;
  kernel<<<grid_of<KT, WM, WN, STEPS>(B, C, Tlen, dil), G::THREADS, G::smem_bytes(),
           (cudaStream_t)stream>>>(
      (const float*)in, S, (const float*)resid, (float*)out, (float*)hs_next, C, Tlen, dil);
  return (int)cudaGetLastError();
}

// The tiles (t_tile, co_tile) with their warps (WM x WN) and steps a thread,
// as ops/resunit.py's FFMA_TILES lists them: of the tiles timed on the H100
// (128 x 64 with 8 channels a thread too), these were fastest, each at the
// stack shapes where the wrapper's pick_ffma_tile chooses it.
#define FFMA_TILES(X) X(64, 64, 2, 2, 8) X(128, 32, 4, 1, 8) X(32, 64, 2, 2, 4) X(64, 32, 2, 1, 8)

// one unit's launch over the weight sets S (B rows in all) with the (t_tile,
// co_tile) that the wrapper's pick_ffma_tile chose; a k=7 launch with
// alpha_in snakes its input while staging it
template <int KT, bool CF>
int launch(int t_tile, int co_tile, const void* in, const Sets& S, const void* resid,
           void* out, void* hs_next, int B, int C, int Tlen, int dil, void* stream) {
  if (S.n < 1 || B % S.n != 0) return (int)cudaErrorInvalidValue;
#define FFMA_TILE(TM_, TN_, WM_, WN_, S_)                                              \
  if (t_tile == TM_ && co_tile == TN_)                                                 \
    return KT == 7 && S.alpha_in[0] != nullptr                                         \
        ? launch_tile<KT, CF, KT == 7, WM_, WN_, S_>(in, S, resid, out, hs_next, B, C,  \
                                                     Tlen, dil, stream)                 \
        : launch_tile<KT, CF, false, WM_, WN_, S_>(in, S, resid, out, hs_next, B, C,    \
                                                   Tlen, dil, stream);
  FFMA_TILES(FFMA_TILE)
#undef FFMA_TILE
  return (int)cudaErrorInvalidValue;
}

// dynamic shared memory of a launch of the tile (kt = 7 or 1) in the
// channels-first (cf) or the time-major layout
inline int smem_bytes(int kt, bool cf, int t_tile, int co_tile) {
#define FFMA_TILE(TM_, TN_, WM_, WN_, S_)                                              \
  if (t_tile == TM_ && co_tile == TN_)                                                 \
    return kt == 7 ? (cf ? Tile<7, true, WM_, WN_, S_>::smem_bytes()                   \
                         : Tile<7, false, WM_, WN_, S_>::smem_bytes())                 \
                   : Tile<1, true, WM_, WN_, S_>::smem_bytes();
  FFMA_TILES(FFMA_TILE)
#undef FFMA_TILE
  return -1;
}

}  // namespace
}  // namespace ffma_core
