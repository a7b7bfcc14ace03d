// Fused residual-VQ lookup (K2), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel multimodal_vqvae_compression_audio_tactile_tpu/
// ops/vq_pallas.py::_rvq_kernel (driven by rvq_lookup_fused). The whole
// residual VQ of x [N, D] against books [use, K, D], in one launch:
//   for each book b, in order:
//     score_k = r . e_k - 0.5 ||e_k||^2             (true fp32)
//     i_b     = the first k of the highest score
//     q_sum  += e_{i_b};  r -= e_{i_b}
// -> q_sum [N, D] fp32, idx [N, use] int32. The indices are the transmitted
// bitstream, so every score is computed in fp32 outside the tensor cores, and
// in a fixed order: the dot product and the squared norm are summed over d =
// 0, 1, .., D-1 with separately rounded products and sums (__fmul_rn,
// __fadd_rn, never contracted to an FMA). ops/vq.py::rvq_lookup_ref repeats
// that order op by op, so the two give bit-equal scores, the same indices
// and, adding the same codes in the same order, bit-equal q_sum.
//
// Bound on this card: 2 N K D operations a book on the fp32 units against
// reading the books once; at an AR chunk's 16 tokens neither, but the chain
// of books (each residual needs the last book's code) and the shared-memory
// reads of every book by every block. The TPU kernel kept every book and a
// 256-token tile in VMEM and gathered with a one-hot matmul. Here tokens are
// independent, so a block takes TN of them (1 to 16, chosen by
// ops/vq.py::pick_tokens so the grid fills the card where N allows) and
// keeps their residuals and q_sum in shared memory across all books. Its
// first 128 threads each own one code of a staged chunk of up to 128 codes
// and score it against the block's tokens in one pass over d, the code's
// squared norm summed in the same pass (once per code and call). A fifth
// warp only issues the copies: the books stream through a two-stage ring,
// chunk g + 1 landing while chunk g is scored, as TMA tensor copies of
// 32-float boxes whose 128-byte swizzle lets a warp's float4 reads hit every
// bank once (4-byte cp.async into the same layout where the rows are not
// whole 16-byte pieces). The argmax is one max- and one min-reduction per
// warp, then one across the four scoring warps through shared memory: two
// barriers a book. When a book fits one stage (K <= 128 at D = 96) the
// chosen code is applied from shared memory, else from the book in device
// memory.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int SCORERS = 128;                // one code of a staged chunk each
constexpr int WARPS = SCORERS / 32;         // scoring warps
constexpr int THREADS = SCORERS + 32;       // and one warp that issues the copies
constexpr int BOX = 32;                     // floats of a code row a copy box spans (128 B)
constexpr int SMEM_MAX = 227 * 1024;        // a block's shared memory on sm_90

__host__ __device__ inline int round_up(int a, int b) { return (a + b - 1) / b * b; }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// A stage holds kcp (kc rounded up to 8) code rows in ceil(D / 32) boxes of
// [kcp][32] floats, each box 1024-byte aligned and, as the tensor copy's
// 128-byte swizzle writes it, its 16-byte pieces XOR-ed with the row: word
// offset of element d of code k. Eight neighbouring codes' float4 at one d
// then lie in eight different bank groups.
__device__ __forceinline__ int staged(int k, int d, int kcp) {
  return (d >> 5) * kcp * BOX + k * BOX + ((((d >> 2) & 7) ^ (k & 7)) << 2) + (d & 3);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)));
}

// one arrival that also expects `bytes` of tensor copies to land
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// TMA: the box at (column c0, row c1) of the books' tensor map into dst
__device__ __forceinline__ void tensor_copy(float* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}

// Start staging kn codes, from book row `row` on, into a stage. tma: the
// copy warp's first lane asks for the ceil(D / 32) boxes of kc rows,
// completing on bar; else every thread copies 4 bytes at a time (cp.async,
// one group), walking its elements by a fixed stride.
__device__ void stage_codes(float* st, const float* books, const CUtensorMap* map, int row,
                            int kn, int kc, int D, bool tma, uint64_t* bar) {
  const int kcp = round_up(kc, 8);
  if (tma) {
    if (threadIdx.x == SCORERS) {
      const int boxes = (D + BOX - 1) / BOX;
      mbar_expect(bar, (unsigned)(boxes * kc * BOX * 4));
      for (int j = 0; j < boxes; ++j) tensor_copy(st + j * kcp * BOX, map, j * BOX, row, bar);
    }
    return;
  }
  const float* src = books + (size_t)row * D;
  const int dk = THREADS / D, dd = THREADS % D;
  int k = threadIdx.x / D, d = threadIdx.x % D;
  while (k < kn) {
    cp_async4(st + staged(k, d, kcp), src + (size_t)k * D + d);
    d += dd;
    k += dk;
    if (d >= D) { d -= D; ++k; }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// A score as an unsigned key in the same order (+0 and -0 alike), so that a
// warp's best is one max-reduction and its first index one min-reduction.
__device__ __forceinline__ unsigned order_key(float s) {
  const unsigned u = __float_as_uint(s == 0.f ? 0.f : s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

template <int TN>
__global__ void __launch_bounds__(THREADS)
rvq_kernel(const __grid_constant__ CUtensorMap map, const float* __restrict__ x,
           const float* __restrict__ books, float* __restrict__ q_out,
           int* __restrict__ idx_out, int N, int K, int D, int use, int kc, int tma) {
  extern __shared__ __align__(16) float smem_raw[];
  // the tensor copies' 128-byte swizzle needs 1024-byte aligned boxes
  float* const smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023) / 4;
  const int kcp = round_up(kc, 8);
  const int stage_floats = (D + BOX - 1) / BOX * kcp * BOX;
  const int ldr = round_up(D, 4);           // residual row
  float* const stage0 = smem;               // [2][stage_floats] the ring
  uint64_t* const bars = (uint64_t*)(smem + 2 * stage_floats);   // one a stage
  float* const r_s = smem + 2 * stage_floats + 4;                 // [TN][ldr] residuals
  float* const q_s = r_s + TN * ldr;        // [TN][ldr] q_sum
  unsigned* const red_k = (unsigned*)(q_s + TN * ldr);   // [WARPS][TN] each warp's best key
  int* const red_i = (int*)(red_k + WARPS * TN);          // and its index

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * TN;
  const int nch = (K + kc - 1) / kc;        // chunks a book
  const int G = use * nch;
  const int d4 = D >> 2;

  if (tid == SCORERS) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  stage_codes(stage0, books, &map, 0, min(kc, K), kc, D, tma, &bars[0]);
  // q_s element (t, d) is only ever touched by thread d % THREADS
#pragma unroll
  for (int t = 0; t < TN; ++t)
    for (int d = tid; d < D; d += THREADS) {
      r_s[t * ldr + d] = (n0 + t < N) ? x[(size_t)(n0 + t) * D + d] : 0.f;
      q_s[t * ldr + d] = 0.f;
    }

  float best_s[TN];
  int best_i[TN];
  for (int g = 0; g < G; ++g) {
    const int b = g / nch, j = g - b * nch;  // book, its chunk
    const int k0 = j * kc, kn = min(kc, K - k0);
    const float* st = stage0 + (g & 1) * stage_floats;
    if (tma)
      mbar_wait(&bars[g & 1], (g >> 1) & 1);
    else
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // chunk g is in; every thread is done with chunk g - 1's stage and has
    // applied the previous book to the residuals
    __syncthreads();
    if (g + 1 < G) {
      const int b1 = (g + 1) / nch, k1 = (g + 1 - b1 * nch) * kc;
      stage_codes(stage0 + ((g + 1) & 1) * stage_floats, books, &map, b1 * K + k1,
                  min(kc, K - k1), kc, D, tma, &bars[(g + 1) & 1]);
    }
    if (j == 0) {
#pragma unroll
      for (int t = 0; t < TN; ++t) { best_s[t] = -INFINITY; best_i[t] = INT32_MAX; }
    }
    if (tid < kn) {
      const float* e = st + tid * BOX;       // this thread's code, in box 0
      const int sw = tid & 7;
      float nrm = 0.f, acc[TN];
#pragma unroll
      for (int t = 0; t < TN; ++t) acc[t] = 0.f;
#pragma unroll 4
      for (int c = 0; c < d4; ++c) {
        const float4 ev =
            *reinterpret_cast<const float4*>(e + (c >> 3) * kcp * BOX + (((c & 7) ^ sw) << 2));
        nrm = __fadd_rn(nrm, __fmul_rn(ev.x, ev.x));
        nrm = __fadd_rn(nrm, __fmul_rn(ev.y, ev.y));
        nrm = __fadd_rn(nrm, __fmul_rn(ev.z, ev.z));
        nrm = __fadd_rn(nrm, __fmul_rn(ev.w, ev.w));
#pragma unroll
        for (int t = 0; t < TN; ++t) {
          const float4 rv = *reinterpret_cast<const float4*>(r_s + t * ldr + 4 * c);
          acc[t] = __fadd_rn(acc[t], __fmul_rn(rv.x, ev.x));
          acc[t] = __fadd_rn(acc[t], __fmul_rn(rv.y, ev.y));
          acc[t] = __fadd_rn(acc[t], __fmul_rn(rv.z, ev.z));
          acc[t] = __fadd_rn(acc[t], __fmul_rn(rv.w, ev.w));
        }
      }
      for (int d = 4 * d4; d < D; ++d) {     // D % 4 trailing terms
        const float ev = st[staged(tid, d, kcp)];
        nrm = __fadd_rn(nrm, __fmul_rn(ev, ev));
#pragma unroll
        for (int t = 0; t < TN; ++t)
          acc[t] = __fadd_rn(acc[t], __fmul_rn(r_s[t * ldr + d], ev));
      }
      const float hn = __fmul_rn(0.5f, nrm);
      // a thread's codes rise with the chunk: a strict > keeps the first
#pragma unroll
      for (int t = 0; t < TN; ++t) {
        const float s = __fsub_rn(acc[t], hn);
        if (s > best_s[t]) { best_s[t] = s; best_i[t] = k0 + tid; }
      }
    }
    if (j < nch - 1) continue;

    // the book's argmax per token: the highest score, then the first index
    // holding it; in each scoring warp, then across them
    if (warp < WARPS) {
#pragma unroll
      for (int t = 0; t < TN; ++t) {
        const unsigned key = order_key(best_s[t]);
        const unsigned top = __reduce_max_sync(0xffffffffu, key);
        const int first = __reduce_min_sync(0xffffffffu, key == top ? best_i[t] : INT32_MAX);
        if (lane == 0) { red_k[warp * TN + t] = top; red_i[warp * TN + t] = first; }
      }
    }
    __syncthreads();
    int sel[TN];
#pragma unroll
    for (int t = 0; t < TN; ++t) {
      unsigned top = red_k[t];
      int i = red_i[t];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) {
        const unsigned ok = red_k[w * TN + t];
        const int oi = red_i[w * TN + t];
        if (ok > top || (ok == top && oi < i)) { top = ok; i = oi; }
      }
      sel[t] = i < K ? i : 0;      // i >= K only when every score is NaN
      if (tid == 0 && n0 + t < N) idx_out[(size_t)(n0 + t) * use + b] = sel[t];
    }
    const float* book = books + (size_t)b * K * D;
    for (int d = tid; d < D; d += THREADS) {
      float q[TN];
#pragma unroll
      for (int t = 0; t < TN; ++t)
        q[t] = nch == 1 ? st[staged(sel[t], d, kcp)] : book[(size_t)sel[t] * D + d];
#pragma unroll
      for (int t = 0; t < TN; ++t) {
        r_s[t * ldr + d] = __fsub_rn(r_s[t * ldr + d], q[t]);
        q_s[t * ldr + d] = __fadd_rn(q_s[t * ldr + d], q[t]);
      }
    }
  }
#pragma unroll
  for (int t = 0; t < TN; ++t)
    if (n0 + t < N)
      for (int d = tid; d < D; d += THREADS) q_out[(size_t)(n0 + t) * D + d] = q_s[t * ldr + d];
}

size_t smem_bytes(int tn, int kc, int D) {
  const size_t stage = (size_t)(D + BOX - 1) / BOX * round_up(kc, 8) * BOX * 4;
  return 1024 + 2 * stage + 16 + (size_t)2 * tn * round_up(D, 4) * 4 + 2 * WARPS * tn * 4;
}

// codes a stage holds: up to SCORERS, at most K, as many as two stages fit
// beside the residuals; 0 when not even one code fits
int chunk_codes(int tn, int K, int D) {
  int kc = std::min(K, SCORERS);
  while (kc > 0 && smem_bytes(tn, kc, D) > (size_t)SMEM_MAX) kc -= (kc > 8 ? 8 : 1);
  return kc;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)p;
  }
  return fn;
}

template <int TN>
int launch(const CUtensorMap& map, const float* x, const float* books, float* q, int* idx, int N,
           int K, int D, int use, int kc, int tma, cudaStream_t stream) {
  // the shared-memory limit raised to the most any launch asks, once a device
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!raised[dev]) {
    e = cudaFuncSetAttribute(rvq_kernel<TN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    raised[dev] = true;
  }
  const size_t smem = smem_bytes(TN, kc, D);
  rvq_kernel<TN><<<(N + TN - 1) / TN, THREADS, smem, stream>>>(map, x, books, q, idx, N, K, D,
                                                               use, kc, tma);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The launch at tn tokens a block: plan = {threads, codes a stage, dynamic
// shared memory bytes}; returns 0, or cudaErrorInvalidValue for a shape the
// kernel does not take.
int rvq_plan(int tn, int K, int D, int* plan) {
  const int kc = (K < 1 || D < 1 || tn < 1) ? 0 : chunk_codes(tn, K, D);
  if (kc == 0) return (int)cudaErrorInvalidValue;
  plan[0] = THREADS;
  plan[1] = kc;
  plan[2] = (int)smem_bytes(tn, kc, D);
  return 0;
}

// x [N, D] fp32, books [use, K, D] fp32 (the books to use, contiguous) ->
// q_sum [N, D] fp32, idx [N, use] int32, tn tokens a block (1, 2, 4, 8, 16)
int rvq_lookup(const void* x, const void* books, void* q_sum, void* idx, int N, int K, int D,
               int use, int tn, void* stream) {
  if (N < 1 || K < 1 || D < 1 || use < 1) return (int)cudaErrorInvalidValue;
  const int kc = chunk_codes(tn, K, D);
  if (kc == 0) return (int)cudaErrorInvalidValue;
  // tensor copies take rows of whole 16-byte pieces from a 16-byte aligned
  // start; other books are staged 4 bytes at a time
  const int tma = D % 4 == 0 && D >= BOX && ((uintptr_t)books & 15) == 0;
  CUtensorMap map = {};
  if (tma) {
    const EncodeTiled encode = encode_tiled();
    if (!encode) return (int)cudaErrorNotSupported;
    const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)use * K};
    const cuuint64_t strides[1] = {(cuuint64_t)D * 4};
    const cuuint32_t box[2] = {BOX, (cuuint32_t)kc};
    const cuuint32_t unit[2] = {1, 1};
    const CUresult r = encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(books),
                              dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  }
  const float* xf = (const float*)x;
  const float* bf = (const float*)books;
  float* qf = (float*)q_sum;
  int* ii = (int*)idx;
  cudaStream_t s = (cudaStream_t)stream;
  switch (tn) {
    case 1: return launch<1>(map, xf, bf, qf, ii, N, K, D, use, kc, tma, s);
    case 2: return launch<2>(map, xf, bf, qf, ii, N, K, D, use, kc, tma, s);
    case 4: return launch<4>(map, xf, bf, qf, ii, N, K, D, use, kc, tma, s);
    case 8: return launch<8>(map, xf, bf, qf, ii, N, K, D, use, kc, tma, s);
    case 16: return launch<16>(map, xf, bf, qf, ii, N, K, D, use, kc, tma, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
