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
// reading the books once, so bound by operations at the head RVQ's shapes.
// The TPU kernel kept every book and a token tile in VMEM and gathered with a
// one-hot matmul. Here a block takes 16 tokens, 16 threads a token, and keeps
// their residuals and q_sum in shared memory across all books. Each book is
// streamed through shared memory 64 codes at a time; the block computes the
// half norms of those codes itself, each thread the scores of its token
// against 4 of them; the best (score, index) is reduced across the token's
// 16 threads with warp shuffles, the higher score winning and, on equal
// scores, the lower index; the chosen code is read from the book in device
// memory (L2) and applied to the residual and q_sum.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE_N = 16;                  // tokens per block
constexpr int LANES = 16;                   // threads per token
constexpr int THREADS = TILE_N * LANES;     // 256
constexpr int K_CHUNK = 64;                 // codes staged per step
constexpr int PER_LANE = K_CHUNK / LANES;   // codes a thread scores per step

__global__ void __launch_bounds__(THREADS)
rvq_kernel(const float* __restrict__ x, const float* __restrict__ books,
           float* __restrict__ q_out, int* __restrict__ idx_out, int N, int K,
           int D, int use) {
  extern __shared__ float smem[];
  const int ld = D + 1;                     // padded rows: no bank conflicts for even D
  float* e_s = smem;                        // [K_CHUNK][ld] codes of this step
  float* r_s = e_s + K_CHUNK * ld;          // [TILE_N][ld] residuals
  float* q_s = r_s + TILE_N * ld;           // [TILE_N][ld] q_sum
  float* hn_s = q_s + TILE_N * ld;          // [K_CHUNK] half squared norms

  const int n0 = blockIdx.x * TILE_N;
  const int tok = threadIdx.x / LANES;
  const int lane = threadIdx.x % LANES;

  for (int i = threadIdx.x; i < TILE_N * D; i += THREADS) {
    int t = i / D, d = i % D;
    r_s[t * ld + d] = (n0 + t < N) ? x[(size_t)(n0 + t) * D + d] : 0.f;
    q_s[t * ld + d] = 0.f;
  }

  for (int b = 0; b < use; ++b) {
    const float* book = books + (size_t)b * K * D;
    float best_s = -INFINITY;
    int best_i = INT32_MAX;
    for (int k0 = 0; k0 < K; k0 += K_CHUNK) {
      const int kc = min(K_CHUNK, K - k0);
      __syncthreads();   // residuals updated; the previous step's codes read
      for (int i = threadIdx.x; i < kc * D; i += THREADS) {
        int k = i / D, d = i % D;
        e_s[k * ld + d] = book[(size_t)(k0 + k) * D + d];
      }
      __syncthreads();
      if (threadIdx.x < kc) {
        const float* e = e_s + threadIdx.x * ld;
        float s = 0.f;
        for (int d = 0; d < D; ++d) s = __fadd_rn(s, __fmul_rn(e[d], e[d]));
        hn_s[threadIdx.x] = __fmul_rn(0.5f, s);
      }
      __syncthreads();
      const float* r = r_s + tok * ld;
      float dot[PER_LANE];
#pragma unroll
      for (int c = 0; c < PER_LANE; ++c) dot[c] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float rv = r[d];
#pragma unroll
        for (int c = 0; c < PER_LANE; ++c)
          dot[c] = __fadd_rn(dot[c], __fmul_rn(rv, e_s[(lane + LANES * c) * ld + d]));
      }
      // this thread's codes rise with c and k0: a strict > keeps the first
#pragma unroll
      for (int c = 0; c < PER_LANE; ++c) {
        const int k = lane + LANES * c;
        if (k < kc) {
          const float s = __fsub_rn(dot[c], hn_s[k]);
          if (s > best_s) { best_s = s; best_i = k0 + k; }
        }
      }
    }
    // across the token's 16 lanes (one half of a warp)
#pragma unroll
    for (int off = LANES / 2; off > 0; off >>= 1) {
      const float os = __shfl_xor_sync(0xffffffffu, best_s, off);
      const int oi = __shfl_xor_sync(0xffffffffu, best_i, off);
      if (os > best_s || (os == best_s && oi < best_i)) { best_s = os; best_i = oi; }
    }
    if (best_i >= K) best_i = 0;   // only when every score is NaN: stay in bounds
    __syncthreads();               // every thread is done reading the residuals
    if (lane == 0 && n0 + tok < N) idx_out[(size_t)(n0 + tok) * use + b] = best_i;
    const float* e = book + (size_t)best_i * D;
    for (int d = lane; d < D; d += LANES) {
      const float q = e[d];
      r_s[tok * ld + d] = __fsub_rn(r_s[tok * ld + d], q);
      q_s[tok * ld + d] = __fadd_rn(q_s[tok * ld + d], q);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TILE_N * D; i += THREADS) {
    int t = i / D, d = i % D;
    if (n0 + t < N) q_out[(size_t)(n0 + t) * D + d] = q_s[t * ld + d];
  }
}

}  // namespace

extern "C" {

// x [N, D] fp32, books [use, K, D] fp32 (the books to use, contiguous) ->
// q_sum [N, D] fp32, idx [N, use] int32
int rvq_lookup(const void* x, const void* books, void* q_sum, void* idx, int N,
               int K, int D, int use, void* stream) {
  if (N < 1 || K < 1 || D < 1 || use < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)(K_CHUNK + 2 * TILE_N) * (D + 1) + K_CHUNK) * sizeof(float);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(rvq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (N + TILE_N - 1) / TILE_N;
  rvq_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)books, (float*)q_sum, (int*)idx, N, K, D, use);
  return (int)cudaGetLastError();
}

}  // extern "C"
