// Float32 arithmetic for path values, shared by the port's CUDA kernels.
//
// Every sum, difference, product and quotient is rounded on its own: the
// __f*_rn intrinsics are never contracted into an FMA, so a kernel that
// evaluates a path in its plain torch version's association order computes
// that path bit for bit.
#pragma once

namespace optionslab {
namespace fp {

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float quo(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float ind(bool b) { return b ? 1.0f : 0.0f; }

}  // namespace fp
}  // namespace optionslab
