// fused_user: kernel 1i's sixteen instantiations of fused_transport (the
// variants with bit 5, the recorded user programs), built from the same
// source into a library of their own so that nvcc compiles them in parallel
// with the other 24 (physicl_tpu_torch/ops/_build.py starts one nvcc per
// source). Same C interface as fused_transport.cu; ops/fused.py picks the
// library by the plan's variant.

#define PHYSICL_USER_VARIANTS
#include "fused_transport.cu"
