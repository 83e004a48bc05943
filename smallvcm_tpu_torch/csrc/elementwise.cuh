// What the per-lane kernels (bsdf.cu, lights.cu) share: ATen's
// elementwise semantics in f32, and core/vec3.py and core/vecmath.py over
// one lane's 3-vectors, each torch op one IEEE f32 op in the same order.
//
// The constants are Python's: a product Python folds in double (2.0 *
// PI_F, INV_PI_F * 0.5) is folded in double here and cast to float, as
// ATen casts a Python scalar. `1.0 / t` is ATen's reciprocal times 1.0.
// clamp_min, clamp and torch.maximum propagate NaN as ATen's kernels do
// (fmaxf alone would not). sqrtf is the correctly rounded square root as
// in ATen; sinf, cosf and powf are the CUDA math library's, which ATen's
// torch.sin, torch.cos and torch.pow call. The sources are built with
// -fmad=false, so no product and sum contract into one rounding.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// core/vecmath.py's constants: Python doubles, cast to float where a
// tensor op takes them.
constexpr double kPi = 3.14159265358979;
constexpr double kInvPi = 1.0 / kPi;
#define F(x) ((float)(x))
#define EPS_COSINE F(1e-6)

// An operand over a [rows, n] lane grid, read through its strides.
struct Plane {
  const void* p;
  long long rs, cs;  // element strides along rows and columns
};

template <typename T>
__device__ __forceinline__ T ld(const Plane& a, long long r, long long i) {
  return static_cast<const T*>(a.p)[r * a.rs + i * a.cs];
}

struct V {
  float x, y, z;
};

__device__ __forceinline__ V mk(float x, float y, float z) {
  V v;
  v.x = x;
  v.y = y;
  v.z = z;
  return v;
}

// -- ATen's elementwise semantics ------------------------------------------

__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float maximum(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

__device__ __forceinline__ float recip(float a) {  // `1.0 / t`
  return (1.0f / a) * 1.0f;
}

// -- core/vec3.py and core/vecmath.py ---------------------------------------

__device__ __forceinline__ float dot(V a, V b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

__device__ __forceinline__ V cross(V a, V b) {
  return mk(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x);
}

__device__ __forceinline__ V scale(V a, float s) {
  return mk(a.x * s, a.y * s, a.z * s);
}

__device__ __forceinline__ V add(V a, V b) {
  return mk(a.x + b.x, a.y + b.y, a.z + b.z);
}

__device__ __forceinline__ V pick(bool c, V a, V b) {
  return mk(c ? a.x : b.x, c ? a.y : b.y, c ? a.z : b.z);
}

__device__ __forceinline__ V normalize(V a) {
  const float len = sqrtf(clamp_min(dot(a, a), F(1e-35)));
  return scale(a, recip(len));
}

struct Frame {
  V x, y, z;
};

__device__ __forceinline__ Frame frame_set_from_z(V z) {
  Frame f;
  f.z = normalize(z);
  const bool use_y = fabsf(f.z.x) > F(0.99);
  const V tmp = mk(use_y ? 0.0f : 1.0f, use_y ? 1.0f : 0.0f, 0.0f);
  f.y = normalize(cross(f.z, tmp));
  f.x = cross(f.y, f.z);
  return f;
}

__device__ __forceinline__ V sample_cos_hemisphere(float u1, float u2,
                                                   float* pdf) {
  const float term1 = F(2.0 * kPi) * u1;
  const float term2 = sqrtf(clamp_min(1.0f - u2, F(1e-12)));
  const float z = sqrtf(clamp_min(u2, F(1e-12)));
  *pdf = z * F(kInvPi);
  return mk(cosf(term1) * term2, sinf(term1) * term2, z);
}

}  // namespace
