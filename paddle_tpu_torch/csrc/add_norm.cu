// Kernel #9 (add + norm) in float32 and bfloat16: x, r and h in one of
// them, the weight in either.  The kernels and their
// notes are in add_norm.cuh; add_norm_half.cu and add_norm_mixed.cu
// build the float16 and mixed-dtype combinations beside this one.
#define PTT_ADD_NORM_CASES                 \
  PTT_CASE(0, float, float, float)         \
  PTT_CASE(1, float, float, bf16)          \
  PTT_CASE(12, bf16, bf16, float)          \
  PTT_CASE(13, bf16, bf16, bf16)

#include "add_norm.cuh"
