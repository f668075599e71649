// The latency of one dependent step of __fadd_rn, __fdiv_rn or __fsqrt_rn
// on the card, for fold_in_solve's latency floor (bench/kernel_ab.py, the
// serve cases): one thread runs a chain of `steps` of them, and the time
// of the launch over `steps` is the step. Built by kernel_ab with a plain
// C interface; not part of the kernels' library.

#include <cuda_runtime.h>

namespace {

__global__ void step_latency_kernel(float* out, int steps, int op, float a, float b) {
  float v = a;
  if (op == 0) {
#pragma unroll 8
    for (int s = 0; s < steps; ++s) v = __fadd_rn(v, b);
  } else if (op == 1) {
#pragma unroll 8
    for (int s = 0; s < steps; ++s) v = __fdiv_rn(v, b);
  } else {
#pragma unroll 8
    for (int s = 0; s < steps; ++s) v = __fsqrt_rn(v);
  }
  out[0] = v;
}

}  // namespace

// op: 0 __fadd_rn (b the addend), 1 __fdiv_rn (b the divisor), 2
// __fsqrt_rn; out[0] takes the chain's end. Returns the launch's CUDA
// error (0 when there is none).
extern "C" int step_latency(float* out, int steps, int op, float a, float b, void* stream) {
  step_latency_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(out, steps, op, a, b);
  return static_cast<int>(cudaGetLastError());
}
