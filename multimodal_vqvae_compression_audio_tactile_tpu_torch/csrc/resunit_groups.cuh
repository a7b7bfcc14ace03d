// Weight sets of a grouped launch of the residual-unit stacks K1
// (resunit_stack.cu) and K3 (resunit_stack_tm.cu).
//
// A launch over G weight sets (G = 1, or 2 for the dual encoder of
// models/dac.py, which runs the audio and the tactile encoder's stacks in one
// launch; the JAX package vmaps its encoder over the two parameter sets)
// takes [B G] batch rows, row z = b G + g belonging to set g. Block z of the
// grid reads set z % G; its batch offset, z C T, is what an ungrouped launch
// over B G rows computes. Nothing of an output's sum depends on z, so a
// grouped launch gives each row the bits of an ungrouped launch with that
// row's weights.

#pragma once

#include <cuda_runtime.h>

namespace resunit_groups {
namespace {

constexpr int MAX_GROUPS = 2;

// The per-set pointers of one launch, passed by value: the conv's weights
// (fp32 in nn.Conv1d's layout, or the prologue's packed bf16), its bias, the
// snake applied while staging (fp32 unit 0), the epilogue's snake, and the
// next unit's snake. A pointer that a launch does not use is null in every set.
struct Sets {
  int n;
  const void* w[MAX_GROUPS];
  const float* bias[MAX_GROUPS];
  const float* alpha_in[MAX_GROUPS];
  const float* alpha_out[MAX_GROUPS];
  const float* alpha_next[MAX_GROUPS];
};

// set g's entry, without indexing the parameter space by a register
template <typename T>
__device__ __forceinline__ T pick(const T (&a)[MAX_GROUPS], int g) {
  return g ? a[1] : a[0];
}

// Sets from host arrays of `groups` pointers each (a null array: null
// pointers); groups outside 1..MAX_GROUPS gives n = 0, which launches refuse.
inline Sets make_sets(int groups, const void* const* w, const void* const* bias,
                      const void* const* alpha_in, const void* const* alpha_out,
                      const void* const* alpha_next) {
  Sets s = {};
  if (groups < 1 || groups > MAX_GROUPS) return s;
  s.n = groups;
  for (int g = 0; g < groups; ++g) {
    s.w[g] = w ? w[g] : nullptr;
    s.bias[g] = bias ? (const float*)bias[g] : nullptr;
    s.alpha_in[g] = alpha_in ? (const float*)alpha_in[g] : nullptr;
    s.alpha_out[g] = alpha_out ? (const float*)alpha_out[g] : nullptr;
    s.alpha_next[g] = alpha_next ? (const float*)alpha_next[g] : nullptr;
  }
  return s;
}

}  // namespace
}  // namespace resunit_groups
