// Closest-hit ray sweep over every triangle, then every sphere.
//
// Replaces the TPU kernel smallvcm_tpu/ops/pallas_intersect.py::_kernel
// (driven by _sweep / intersect_pallas). Same loop order, same guards, same
// tie rule: a strict t < best keeps the lowest primitive index.
//
// Design: one thread per ray; the scene tables (SmallVCM has ~20 triangles
// and <= 2 spheres) are staged once per block in shared memory and read as
// broadcasts, so each ray costs 24 bytes in and 12 bytes out and the sweep
// is bound by the per-ray arithmetic (~50 FLOP per triangle) rather than
// by memory. Built with -fmad=false so every product and sum rounds as in
// the plain PyTorch version (ops/sweep.py::sweep_plain), which is what
// makes exact primitive agreement possible on grazing rays.
//
// Tables (planar, f32): tri [10, T] = p0 xyz | p1 xyz | p2 xyz | pad,
// tri_n [4, T] = normal xyz | material, sph [6, max(S,1)] = center xyz |
// radius | material | valid. Outputs: dist [N] f32 (1e36 on a miss),
// prim [N] int64 (-1 on a miss).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr float kBigDist = 1e36f;

__global__ void intersect_sweep_kernel(
    const float* __restrict__ tri, const float* __restrict__ tri_n,
    const float* __restrict__ sph, int n_tri, int n_sph,
    const float* __restrict__ ox_p, const float* __restrict__ oy_p,
    const float* __restrict__ oz_p, const float* __restrict__ dx_p,
    const float* __restrict__ dy_p, const float* __restrict__ dz_p,
    float* __restrict__ dist_out, int64_t* __restrict__ prim_out, int n) {
  extern __shared__ float smem[];
  float* s_tri = smem;                  // [9][n_tri] (pad row dropped)
  float* s_nrm = s_tri + 9 * n_tri;     // [3][n_tri]
  float* s_sph = s_nrm + 3 * n_tri;     // [4][n_sph]
  for (int e = threadIdx.x; e < 9 * n_tri; e += blockDim.x) s_tri[e] = tri[e];
  for (int e = threadIdx.x; e < 3 * n_tri; e += blockDim.x) s_nrm[e] = tri_n[e];
  for (int e = threadIdx.x; e < 4 * n_sph; e += blockDim.x) {
    const int row = e / n_sph, col = e % n_sph;
    s_sph[e] = sph[row * n_sph + col];
  }
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float ox = ox_p[i], oy = oy_p[i], oz = oz_p[i];
  const float dx = dx_p[i], dy = dy_p[i], dz = dz_p[i];

  float best_t = kBigDist;
  int best_p = -1;

  for (int k = 0; k < n_tri; ++k) {
    const float p0x = s_tri[0 * n_tri + k], p0y = s_tri[1 * n_tri + k],
                p0z = s_tri[2 * n_tri + k];
    const float p1x = s_tri[3 * n_tri + k], p1y = s_tri[4 * n_tri + k],
                p1z = s_tri[5 * n_tri + k];
    const float p2x = s_tri[6 * n_tri + k], p2y = s_tri[7 * n_tri + k],
                p2z = s_tri[8 * n_tri + k];
    const float nx = s_nrm[0 * n_tri + k], ny = s_nrm[1 * n_tri + k],
                nz = s_nrm[2 * n_tri + k];

    const float aox = p0x - ox, aoy = p0y - oy, aoz = p0z - oz;
    const float box = p1x - ox, boy = p1y - oy, boz = p1z - oz;
    const float cox = p2x - ox, coy = p2y - oy, coz = p2z - oz;

    // v0 = cross(co, bo).d ; v1 = cross(bo, ao).d ; v2 = cross(ao, co).d
    const float v0d = (coy * boz - coz * boy) * dx +
                      (coz * box - cox * boz) * dy +
                      (cox * boy - coy * box) * dz;
    const float v1d = (boy * aoz - boz * aoy) * dx +
                      (boz * aox - box * aoz) * dy +
                      (box * aoy - boy * aox) * dz;
    const float v2d = (aoy * coz - aoz * coy) * dx +
                      (aoz * cox - aox * coz) * dy +
                      (aox * coy - aoy * cox) * dz;

    const bool inside = (v0d < 0.f && v1d < 0.f && v2d < 0.f) ||
                        (v0d >= 0.f && v1d >= 0.f && v2d >= 0.f);
    const float denom = nx * dx + ny * dy + nz * dz;
    const float t = (nx * aox + ny * aoy + nz * aoz) /
                    (denom == 0.f ? 1.f : denom);
    if (inside && denom != 0.f && t > 0.f && t < best_t) {
      best_t = t;
      best_p = k;
    }
  }

  for (int k = 0; k < n_sph; ++k) {
    const float cx = s_sph[0 * n_sph + k], cy = s_sph[1 * n_sph + k],
                cz = s_sph[2 * n_sph + k], radius = s_sph[3 * n_sph + k];
    const float ocx = ox - cx, ocy = oy - cy, ocz = oz - cz;
    const float a = dx * dx + dy * dy + dz * dz;
    const float bq = 2.f * (dx * ocx + dy * ocy + dz * ocz);
    const float c = ocx * ocx + ocy * ocy + ocz * ocz - radius * radius;

    const float disc = bq * bq - 4.f * a * c;
    const bool valid = disc >= 0.f;
    const float sq = sqrtf(fmaxf(disc, 1e-30f));
    const float qq = bq < 0.f ? (-bq - sq) * 0.5f : (-bq + sq) * 0.5f;
    const float t_a = qq / a;
    const float t_b = c / (qq == 0.f ? 1.f : qq);
    const float t0 = fminf(t_a, t_b);
    const float t1 = fmaxf(t_a, t_b);
    const float t = (valid && t0 > 0.f) ? t0
                    : ((valid && t1 > 0.f) ? t1 : kBigDist);
    if (t < best_t) {
      best_t = t;
      best_p = n_tri + k;
    }
  }

  dist_out[i] = best_t;
  prim_out[i] = best_p;
}

}  // namespace

extern "C" int svcm_intersect_sweep(
    const float* tri, const float* tri_n, const float* sph, int n_tri,
    int n_sph, const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz, float* dist,
    int64_t* prim, int n, void* stream) {
  if (n <= 0) return 0;
  const int grid = (n + kBlock - 1) / kBlock;
  const size_t shmem = sizeof(float) * (12 * n_tri + 4 * n_sph);
  intersect_sweep_kernel<<<grid, kBlock, shmem, (cudaStream_t)stream>>>(
      tri, tri_n, sph, n_tri, n_sph, ox, oy, oz, dx, dy, dz, dist, prim, n);
  return (int)cudaGetLastError();
}
