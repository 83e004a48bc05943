// BSDF::Setup of ops/bsdf.py::setup_plain over one lane, and the material
// table it reads: shared by the BSDF kernel (bsdf.cu) and the cell merge's
// preparation (merge_prep.cu), so the set-up's arithmetic has one copy.
// Each torch op of the plain version is one IEEE f32 operation here, in
// the same order (elementwise.cuh says how).

#pragma once

#include "elementwise.cuh"

namespace {

constexpr int kMatPlanes = 11;
constexpr int kMaxMaterials = 1024;

__device__ __forceinline__ float luminance(V c) {
  return F(0.212671) * c.x + F(0.715160) * c.y + F(0.072169) * c.z;
}

__device__ __forceinline__ V to_local(const Frame& f, V a) {
  return mk(dot(a, f.x), dot(a, f.y), dot(a, f.z));
}

__device__ __forceinline__ float fresnel_dielectric(float cos_inc,
                                                    float ior) {
  const bool inside = cos_inc < 0.0f;
  const float abs_cos = fabsf(cos_inc);
  const float safe_ior = ior <= 0.0f ? 1.5f : ior;
  const float eta = inside ? safe_ior : recip(safe_ior);
  const float sin_t2 = (eta * eta) * (1.0f - abs_cos * abs_cos);
  const float cos_t = sqrtf(clamp_min(1.0f - sin_t2, F(1e-12)));
  const float term1 = eta * cos_t;
  const float r_par =
      (abs_cos - term1) / clamp_min(abs_cos + term1, F(1e-35));
  const float term2 = eta * abs_cos;
  const float r_perp =
      (term2 - cos_t) / clamp_min(term2 + cos_t, F(1e-35));
  const float fres = 0.5f * (r_par * r_par + r_perp * r_perp);
  return ior < 0.0f ? 1.0f : fres;
}

// The material table's 11 planes (m rows each, field order of
// scene.Materials) copied into shared memory by the whole block.
__device__ __forceinline__ void load_materials(float* smat, const Plane* mat,
                                               int m) {
  for (int k = threadIdx.x; k < kMatPlanes * m; k += blockDim.x) {
    smat[k] = ld<float>(mat[k / m], 0, k % m);
  }
  __syncthreads();
}

struct Material {
  V diffuse, phong, mirror;
  float exponent, ior;
};

// Material id's row of the table in shared memory (11 planes of m rows),
// the id clamped to the table as the plain gather's clamp_min(0) does.
__device__ __forceinline__ Material material(const float* smat, int m,
                                             long long id) {
  const int k = (int)min(max(id, 0LL), (long long)(m - 1));
  Material mt;
  mt.diffuse = mk(smat[0 * m + k], smat[1 * m + k], smat[2 * m + k]);
  mt.phong = mk(smat[3 * m + k], smat[4 * m + k], smat[5 * m + k]);
  mt.exponent = smat[6 * m + k];
  mt.mirror = mk(smat[7 * m + k], smat[8 * m + k], smat[9 * m + k]);
  mt.ior = smat[10 * m + k];
  return mt;
}

// A lane's BsdfState, as setup forms it and the other entry points read
// it (the material id apart).
struct State {
  bool valid;
  Frame frame;
  V fix;  // local_dir_fix
  float p_diff, p_phong, p_refl, p_refr, cont, rc;
};

// setup (BSDF::Setup with GetComponentProbabilities).
__device__ __forceinline__ State setup_lane(const float* smat, int m,
                                            V ray_dir, V normal,
                                            long long id, bool hit) {
  State s;
  s.frame = frame_set_from_z(normal);
  s.fix = to_local(s.frame, mk(-ray_dir.x, -ray_dir.y, -ray_dir.z));
  s.valid = hit & (id >= 0) & (fabsf(s.fix.z) >= EPS_COSINE);
  const Material mt = material(smat, m, id);

  s.rc = fresnel_dielectric(s.fix.z, mt.ior);
  const float albedo_diff = luminance(mt.diffuse);
  const float albedo_phong = luminance(mt.phong);
  const float albedo_refl = s.rc * luminance(mt.mirror);
  const float albedo_refr = (1.0f - s.rc) * (mt.ior > 0.0f ? 1.0f : 0.0f);
  const float total = albedo_diff + albedo_phong + albedo_refl + albedo_refr;
  const bool degenerate = total < F(1e-9);
  const float safe_total = degenerate ? 1.0f : total;
  s.p_diff = degenerate ? 0.0f : albedo_diff / safe_total;
  s.p_phong = degenerate ? 0.0f : albedo_phong / safe_total;
  s.p_refl = degenerate ? 0.0f : albedo_refl / safe_total;
  s.p_refr = degenerate ? 0.0f : albedo_refr / safe_total;
  const V c = add(add(mt.diffuse, mt.phong), scale(mt.mirror, s.rc));
  const float cont = maximum(c.x, maximum(c.y, c.z)) + (1.0f - s.rc);
  s.cont = degenerate ? 0.0f : clamp(cont, 0.0f, 1.0f);
  return s;
}

}  // namespace
