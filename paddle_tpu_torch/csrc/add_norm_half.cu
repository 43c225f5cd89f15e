// Kernel #9 (add + norm) in float16 (add_norm.cuh): x, r and h float16
// with a float16 or float32 weight (amp O2 and O1 in float16), and a
// float32 h with a float16 weight.
#define PTT_ADD_NORM_CASES                 \
  PTT_CASE(2, float, float, __half)        \
  PTT_CASE(24, __half, __half, float)      \
  PTT_CASE(26, __half, __half, __half)

#include "add_norm.cuh"
