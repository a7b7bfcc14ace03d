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
// each) against about 6 activation passes of C T elements, so at C >= 64 it is
// bound by operations, not bytes (in fp32 by 67 TFLOP/s of FFMA, in bf16 by
// the tensor cores). The TPU kernel kept a whole stack's weights
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
// fp32 operands run on FFMA through the product core shared with K3
// (resunit_ffma.cuh): each thread 4 output channels x 8 time steps at a
// stride of the unit's dilation, so the 7 taps of an input channel slide over
// one window of 14 inputs in registers; a two-stage cp.async ring of input
// windows and weights; a tile chosen per shape (ops/resunit.py::
// pick_ffma_tile). Each output is one fmaf chain from 0 over the input
// channels, then the taps, in ascending order, the bias added after: cuDNN's
// order, so the fp32 stack is bit-equal to the plain version. Unit 0's k=7
// launch snakes x on the way in; each k=1 launch but the last also writes the
// next unit's snaked operand, which the next k=7 launch reads as it is. So an
// fp32 stack of n units is 2 n launches, h2 channels-first [B, C, T].
//
// Every launch takes G weight sets (resunit_groups.cuh): G = 2 runs the dual
// encoder's audio and tactile stacks in one launch over [B 2] rows, row
// b 2 + g with set g's weights, so a grouped stack is still 2 n (+ 1) launches.
// Each pointer argument named with [] is a host array of G pointers, one a set.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "resunit_groups.cuh"
#include "resunit_ffma.cuh"
#include "resunit_mma.cuh"

namespace {

constexpr int MAX_HALO = 27;    // 3 * max dilation (9)

using resunit_groups::make_sets;

}  // namespace

extern "C" {

// The prologue of G bf16 stacks of n_units (1..3): hs = bf16(snake_a1(x))
// [B, T, C], unit 0's operand, from x [B, C, T] bf16, row z with set z % G's
// a1[]; and the fp32 weights w7[s] [C, C, 7], w1[s] [C, C, 1] of set g's unit
// u, s = g n_units + u (host arrays of G n_units pointers), rounded to bf16 and
// packed into wp + s * 8 C^2 as [7][C_out][C_in] then [C_out][C_in] (the w7[]/
// w1[] arguments of the bf16 launches below)
int resunit_prologue(const void* x, int groups, const void* const* a1, void* hs,
                     const void* const* w7, const void* const* w1, int n_units, void* wp,
                     int B, int C, int Tlen, void* stream) {
  return mma_core::launch_prologue<true>(
      x, make_sets(groups, nullptr, nullptr, a1, nullptr, nullptr), hs, w7, w1, n_units, wp,
      B, C, Tlen, stream);
}

// h2 = snake_a2(conv7_dil(snake_a1(x)) + b7), with the tile (t_tile,
// co_tile). fp32: x and h2 [B, C, T], w7[] [C, C, 7] (nn.Conv1d layout); with
// a1 null, x is already snake_a1(x) (hs from the previous k=1 launch). bf16:
// x is hs = bf16(snake_a1(x)) [B, T, C] (a1 unused), w7[] the unit's packed
// [7][C][C] from the prologue, h2 [B, T, C].
int resunit_conv7(const void* x, int groups, const void* const* w7, const void* const* b7,
                  const void* const* a1, const void* const* a2, void* h2, int B, int C,
                  int Tlen, int dil, int is_bf16, int t_tile, int co_tile, void* stream) {
  if (dil < 1 || 3 * dil > MAX_HALO) return (int)cudaErrorInvalidValue;
  return is_bf16
      ? mma_core::launch<7, true, __nv_bfloat16, __nv_bfloat16>(
            t_tile, co_tile, x, make_sets(groups, w7, b7, nullptr, a2, nullptr), nullptr, h2,
            nullptr, B, C, Tlen, dil, stream)
      : ffma_core::launch<7, true>(t_tile, co_tile, x,
                                   make_sets(groups, w7, b7, a1, a2, nullptr), nullptr, h2,
                                   nullptr, B, C, Tlen, dil, stream);
}

// out = x + W1 . h2 + b1, then snake_post when post_alpha is not null;
// x, out [B, C, T]; h2 as resunit_conv7 wrote it; w1[] [C, C, 1] fp32, or in
// bf16 the unit's packed [C][C]. With hs_next not null, also the next unit's
// operand hs_next = snake_a1_next(out): fp32 [B, C, T], or bf16 [B, T, C].
int resunit_conv1(const void* x, const void* h2, int groups, const void* const* w1,
                  const void* const* b1, const void* const* post_alpha,
                  const void* const* a1_next, void* hs_next, void* out, int B, int C,
                  int Tlen, int is_bf16, int t_tile, int co_tile, void* stream) {
  const auto sets = make_sets(groups, w1, b1, nullptr, post_alpha, a1_next);
  return is_bf16
      ? mma_core::launch<1, true, __nv_bfloat16, __nv_bfloat16>(
            t_tile, co_tile, h2, sets, x, out, hs_next, B, C, Tlen, 1, stream)
      : ffma_core::launch<1, true>(t_tile, co_tile, h2, sets, x, out, hs_next, B, C, Tlen,
                                   1, stream);
}

// dynamic shared memory of one bf16 launch (kt = 7 or 1) of the tile at
// dilation dil, as the build reports it beside ptxas's registers
int resunit_smem_bytes(int kt, int t_tile, int co_tile, int dil) {
  return mma_core::smem_bytes(kt, t_tile, co_tile, dil);
}

// dynamic shared memory of one fp32 launch (kt = 7 or 1) of the tile, any
// dilation
int resunit_ffma_smem_bytes(int kt, int t_tile, int co_tile) {
  return ffma_core::smem_bytes(kt, true, t_tile, co_tile);
}

}  // extern "C"
