// The GELU of the fused feed-forward kernels (device functions): exact-erf
// GELU with the Abramowitz-Stegun 7.1.26 rational erf (|error| <= 1.5e-7),
// as the TPU kernels compute it (vptr_tpu/ops/fused_conv_ln.py:42-60,
// _erf / _gelu / _gelu_grad: Mosaic has no erf). Its torch twin is
// vptr_tpu_torch/ops/gelu.py. All arithmetic is f32.
#pragma once

#include <math.h>

namespace vptr_gelu {

__device__ __forceinline__ float erf_as(float x) {
  const float ax = fabsf(x);
  const float t = 1.0f / (1.0f + 0.3275911f * ax);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float s = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);   // jnp.sign
  return s * (1.0f - poly * expf(-ax * ax));
}

// 0.5 a (1 + erf(a / sqrt 2))
__device__ __forceinline__ float gelu(float a) {
  return 0.5f * a * (1.0f + erf_as(a / 1.41421356237309515f));
}

// The same A&S GELU for an epilogue that the arithmetic holds back: x / sqrt 2
// as a product, the reciprocal and the exponential on the special-function
// unit (__fdividef, __expf: a few ulp of f32 from gelu, far below a bf16
// rounding of the result), and no division's slow-path branch.
__device__ __forceinline__ float gelu_fast(float a) {
  const float x = a * 0.707106781186547524f;
  const float ax = fabsf(x);
  const float t = __fdividef(1.0f, fmaf(0.3275911f, ax, 1.0f));
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  return 0.5f * a * (1.0f + copysignf(1.0f - poly * __expf(-ax * ax), x));
}

// gelu_fast(a) and gelu_grad(a) together, for the backward's epilogue:
// the pdf's exponential exp(-a^2 / 2) is the erf's exp(-x^2), x = a / sqrt 2,
// so one __expf serves both (a few ulp of f32 from gelu and gelu_grad).
__device__ __forceinline__ void gelu_and_grad_fast(float a, float& h, float& grad) {
  const float x = a * 0.707106781186547524f;
  const float ax = fabsf(x);
  const float t = __fdividef(1.0f, fmaf(0.3275911f, ax, 1.0f));
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float e = __expf(-ax * ax);
  const float cdf = 0.5f * (1.0f + copysignf(1.0f - poly * e, x));
  h = a * cdf;
  grad = fmaf(a * 0.398942280401432678f, e, cdf);
}

// the A&S cdf plus a times the exact normal pdf
__device__ __forceinline__ float gelu_grad(float a) {
  const float cdf = 0.5f * (1.0f + erf_as(a / 1.41421356237309515f));
  const float pdf = expf(-0.5f * a * a) * 0.398942280401432678f;
  return cdf + a * pdf;
}

}  // namespace vptr_gelu
