// Kernel #9 (add + norm) in its mixed-dtype mode (add_norm.cuh): a
// 16-bit x (bfloat16 or float16: amp O1's block output) over a float32
// residual and h, with a float32 weight (O1) or one in x's dtype (an
// amp O2 decoder whose attention promoted to float32).
#define PTT_ADD_NORM_CASES                 \
  PTT_CASE(9, bf16, float, float)          \
  PTT_CASE(10, bf16, float, bf16)          \
  PTT_CASE(18, __half, float, float)       \
  PTT_CASE(20, __half, float, __half)

#include "add_norm.cuh"
