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
// shared memory a block, so each unit is two launches here.
//
// bf16 operands run on the tensor cores through the product core shared with
// K1 (resunit_mma.cuh): with C contiguous each tap is a [rows, C_in] x
// [C_in, C_out] product. A prologue writes unit 0's snaked operand and packs
// the stack's fp32 weights, read in place from PyTorch's [C_out, C_in, k]
// layout, in bf16; each k=1 launch writes the next unit's snaked operand, so
// a bf16 stack of n units is 2 n + 1 launches.
//
// fp32 operands run on FFMA through the product core shared with K1
// (resunit_ffma.cuh), the operand window transposed on staging (rows read
// coalesced along C, stored channel-major) and the epilogue storing rows of
// C: each thread 4 output channels x 8 rows at a stride of the dilation,
// a two-stage cp.async ring, a tile chosen per shape. Unit 0's k=7 launch
// snakes the carry on the way in; each k=1 launch but the last also writes
// the next unit's snaked operand, taken on the fp32 carry. So an fp32 stack
// of n units is 2 n launches, the carry fp32 throughout.
//
// Every launch takes G weight sets (resunit_groups.cuh): G = 2 runs the dual
// encoder's audio and tactile stacks in one launch over [B 2] rows, row
// b 2 + g with set g's weights. Each pointer argument named with [] is a host
// array of G pointers, one a set.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "resunit_groups.cuh"
#include "resunit_ffma.cuh"
#include "resunit_mma.cuh"

namespace {

constexpr int MAX_SHIFT = 27;   // 3 * max dilation (9)

using bf16 = __nv_bfloat16;
using resunit_groups::make_sets;

}  // namespace

extern "C" {

// The prologue of G bf16 stacks of n_units (1..3): hs = bf16(snake_a1(x))
// [B, T, C], unit 0's operand, from x [B, T, C] bf16, row z with set z % G's
// a1[]; and the fp32 weights w7[s] [C, C, 7], w1[s] [C, C, 1] of set g's unit
// u, s = g n_units + u, rounded to bf16 and packed into wp + s * 8 C^2 as
// [7][C_out][C_in] then [C_out][C_in] (the w7[]/w1[] arguments of the bf16
// launches below)
int resunit_tm_prologue(const void* x, int groups, const void* const* a1, void* hs,
                        const void* const* w7, const void* const* w1, int n_units, void* wp,
                        int B, int C, int Tlen, void* stream) {
  return mma_core::launch_prologue<false>(
      x, make_sets(groups, nullptr, nullptr, a1, nullptr, nullptr), hs, w7, w1, n_units, wp,
      B, C, Tlen, stream);
}

// h2 = snake_a2(conv7_dil(snake_a1(acc)) + b7); h2 [B, T, C] in the operand
// type; b7[], a1[], a2[] [C] fp32; the tile (t_tile, co_tile). fp32: acc is
// the fp32 carry [B, T, C], or with a1 null already snake_a1(carry) (hs from
// the previous k=1 launch), w7[] [C, C, 7] (nn.Conv1d layout). bf16: acc is
// hs = bf16(snake_a1(carry)) [B, T, C] (a1 unused), w7[] the unit's packed
// [7][C][C] from the prologue.
int resunit_tm_conv7(const void* acc, int groups, const void* const* w7,
                     const void* const* b7, const void* const* a1, const void* const* a2,
                     void* h2, int B, int C, int Tlen, int dil, int is_bf16, int t_tile,
                     int co_tile, void* stream) {
  if (dil < 1 || 3 * dil > MAX_SHIFT) return (int)cudaErrorInvalidValue;
  if (!is_bf16)
    return ffma_core::launch<7, false>(t_tile, co_tile, acc,
                                       make_sets(groups, w7, b7, a1, a2, nullptr), nullptr,
                                       h2, nullptr, B, C, Tlen, dil, stream);
  return mma_core::launch<7, false, bf16, bf16>(
      t_tile, co_tile, acc, make_sets(groups, w7, b7, nullptr, a2, nullptr), nullptr, h2,
      nullptr, B, C, Tlen, dil, stream);
}

// out = acc + (W1 . h2 + b1), then snake_post when post_alpha is not null;
// out in fp32 when out_f32, else in the operand type; w1[] [C, C, 1] fp32, or
// in bf16 the unit's packed [C][C]. With hs_next not null, also the next
// unit's operand hs_next = snake_a1_next(out) [B, T, C] in the operand type,
// taken on the fp32 sum. fp32: acc, out and hs_next all fp32.
int resunit_tm_conv1(const void* acc, int acc_f32, const void* h2, int groups,
                     const void* const* w1, const void* const* b1,
                     const void* const* post_alpha, const void* const* a1_next,
                     void* hs_next, void* out, int out_f32, int B, int C, int Tlen,
                     int is_bf16, int t_tile, int co_tile, void* stream) {
  const auto sets = make_sets(groups, w1, b1, nullptr, post_alpha, a1_next);
  if (!is_bf16)
    return ffma_core::launch<1, false>(t_tile, co_tile, h2, sets, acc, out, hs_next, B, C,
                                       Tlen, 1, stream);
#define TM_CONV1(TA, TO)                                                              \
  mma_core::launch<1, false, TA, TO>(t_tile, co_tile, h2, sets, acc, out, hs_next, B, C, \
                                     Tlen, 1, stream)
  if (acc_f32) return out_f32 ? TM_CONV1(float, float) : TM_CONV1(float, bf16);
  return out_f32 ? TM_CONV1(bf16, float) : TM_CONV1(bf16, bf16);
#undef TM_CONV1
}

}  // extern "C"
