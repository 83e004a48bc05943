// Ray sweeps over every triangle, then every sphere: a closest-hit entry
// (svcm_intersect_sweep) and a masked any-hit entry for shadow rays
// (svcm_occluded_sweep).
//
// Replaces the TPU kernel smallvcm_tpu/ops/pallas_intersect.py::_kernel
// (driven by _sweep / intersect_pallas; the JAX package's occluded() is a
// closest-hit sweep followed by best_t < tmax). Same loop order, same
// guards, same tie rule: a strict t < best keeps the lowest primitive
// index.
//
// What bounds it on this card: instruction issue. A ray costs 24-28 bytes
// in and 1-12 bytes out, but ~60 f32 operations per triangle, and it is
// built with -fmad=false so that every product and sum rounds as in the
// plain PyTorch version (ops/sweep.py::sweep_plain), one IEEE operation per
// torch operation. That contract is what makes primitive choices on
// grazing rays agree exactly with the plain version and with the JAX
// package on the CPU; it also halves the card's f32 rate (no FMA), so the
// arithmetic floor is ~2x the 67 TFLOP/s bound.
//
// What the design does about it:
// - The scene lives in the constant bank. The host packs it once per
//   scene (ops/sweep.py::pack_scene) into one f32 block, 12 floats per
//   triangle (p0, p1, p2, normal) and 4 per sphere (centre, radius), at a
//   fixed capacity of kMaxTri triangles and kMaxSph spheres; the C entry
//   copies it into a struct passed by value as a __grid_constant__ kernel
//   parameter. The loops are unrolled to the capacity with a warp-uniform
//   break, so every scene field is a constant-bank operand of the
//   arithmetic: no shared-memory staging, no __syncthreads, no loads.
// - The division is deferred. The three signed volumes and the inside
//   test come first; t = n.(p0 - o) / n.d is formed only under
//   inside && n.d != 0, where it can matter (a ray's line crosses ~2 of a
//   closed box's triangles). Spheres take their square root and two
//   divisions only where the discriminant is non-negative. Results are
//   bit for bit those of the branch-free form.
// - Shadow rays take the any-hit entry: origin offset and tmax are formed
//   in the kernel (one IEEE op each, as the torch ops round), a ray stops
//   at its first primitive with 0 < t < tmax, and inactive lanes are
//   answered false without testing anything. The shadow-ray origin may be
//   broadcast: point i of the sweep is point[i % n_point].
//
// The any-hit entry's calls are masked: 4-17% of a call's lanes are live
// on the main path. What bounds a call there is its live rays' arithmetic
// (~60 IEEE f32 operations a triangle, as above) in too few warps to fill
// the card, plus a fixed cost of ~3 us a call (launch, mask read, zero
// answers, two block barriers: a 262,144-lane call with no live lane).
// A block that compacted only its own 256 lanes ran ~10 live rays in one
// part-empty warp at 4% active, so a call's time followed its lanes. So a
// block takes a window of 256 x V lanes, V = 1, 2 or 4 chosen by the host
// from the lanes and the SM count (ops/sweep.py::occluded_plan: the
// widest window that leaves 3 blocks an SM): one V-byte load of the mask
// and one V-byte store of zero answers a thread, a prefix count over the
// block, a list of the live lanes in shared memory in lane order, and all
// the block's warps drain that list in full warps, writing 1 where a ray
// is blocked. Wider windows (8, 16) packed sparse masks a little better
// but left a call whose lanes are all live too few blocks to balance
// (6-13% slower than V = 1), so V stops at 4. No atomics and no host
// read: the plan is static, so a CUDA graph's capture keeps it.
//
// Scene block (f32, kBlockFloats): tri[kMaxTri][12] = p0 xyz | p1 xyz |
// p2 xyz | normal xyz, then sph[kMaxSph][4] = centre xyz | radius.
// Closest hit: dist [N] f32 (1e36 on a miss), prim [N] int64 (-1 on a
// miss). Any hit: out [M] uint8 (1 = blocked), active [M] uint8.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
// Lanes a thread of the any-hit kernel: 1, 2 or 4 (a block's window is
// kBlock of them; ops/sweep.py::occluded_plan picks one).
constexpr int kMaxLanes = 4;
constexpr int kMaxTri = 32;
constexpr int kMaxSph = 4;
constexpr int kTriFloats = 12;
constexpr int kSphFloats = 4;
constexpr int kBlockFloats = kMaxTri * kTriFloats + kMaxSph * kSphFloats;
constexpr float kBigDist = 1e36f;
// ops/intersect.py: origin + direction * EPS_RAY, dist - 2 * EPS_RAY, with
// the Python doubles rounded to f32 as torch rounds a scalar operand.
constexpr float kEpsRay = (float)1e-3;
constexpr float kTwoEpsRay = (float)(2.0 * 1e-3);

struct Scene {
  float tri[kMaxTri * kTriFloats];
  float sph[kMaxSph * kSphFloats];
  int n_tri;
  int n_sph;
};

// Distance along the ray to triangle k if the ray's line crosses it and
// n.d != 0, else a negative value (never a hit). Op order as
// ops/sweep.py::tri_distances.
__device__ __forceinline__ float tri_t(const Scene& s, int k, float ox,
                                       float oy, float oz, float dx,
                                       float dy, float dz) {
  const float* p = s.tri + k * kTriFloats;  // constant-bank operands
  const float aox = p[0] - ox, aoy = p[1] - oy, aoz = p[2] - oz;
  const float box = p[3] - ox, boy = p[4] - oy, boz = p[5] - oz;
  const float cox = p[6] - ox, coy = p[7] - oy, coz = p[8] - oz;

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
  const float denom = p[9] * dx + p[10] * dy + p[11] * dz;
  if (inside && denom != 0.f)
    return (p[9] * aox + p[10] * aoy + p[11] * aoz) / denom;
  return -1.f;
}

// Nearest positive root of sphere k, kBigDist when there is none. Op order
// as ops/sweep.py::sphere_distances.
__device__ __forceinline__ float sph_t(const Scene& s, int k, float ox,
                                       float oy, float oz, float dx,
                                       float dy, float dz) {
  const float* q = s.sph + k * kSphFloats;
  const float ocx = ox - q[0], ocy = oy - q[1], ocz = oz - q[2];
  const float a = dx * dx + dy * dy + dz * dz;
  const float bq = 2.f * (dx * ocx + dy * ocy + dz * ocz);
  const float c = ocx * ocx + ocy * ocy + ocz * ocz - q[3] * q[3];
  const float disc = bq * bq - 4.f * a * c;
  if (!(disc >= 0.f)) return kBigDist;
  const float sq = sqrtf(fmaxf(disc, 1e-30f));
  const float qq = bq < 0.f ? (-bq - sq) * 0.5f : (-bq + sq) * 0.5f;
  const float t_a = qq / a;
  const float t_b = c / (qq == 0.f ? 1.f : qq);
  const float t0 = fminf(t_a, t_b);
  const float t1 = fmaxf(t_a, t_b);
  return t0 > 0.f ? t0 : (t1 > 0.f ? t1 : kBigDist);
}

__global__ void __launch_bounds__(kBlock) intersect_sweep_kernel(
    const __grid_constant__ Scene s, const float* __restrict__ ox_p,
    const float* __restrict__ oy_p, const float* __restrict__ oz_p,
    const float* __restrict__ dx_p, const float* __restrict__ dy_p,
    const float* __restrict__ dz_p, float* __restrict__ dist_out,
    int64_t* __restrict__ prim_out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float ox = ox_p[i], oy = oy_p[i], oz = oz_p[i];
  const float dx = dx_p[i], dy = dy_p[i], dz = dz_p[i];

  float best_t = kBigDist;
  int best_p = -1;
#pragma unroll
  for (int k = 0; k < kMaxTri; ++k) {
    if (k >= s.n_tri) break;
    const float t = tri_t(s, k, ox, oy, oz, dx, dy, dz);
    if (t > 0.f && t < best_t) {
      best_t = t;
      best_p = k;
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxSph; ++k) {
    if (k >= s.n_sph) break;
    const float t = sph_t(s, k, ox, oy, oz, dx, dy, dz);
    if (t < best_t) {
      best_t = t;
      best_p = s.n_tri + k;
    }
  }
  dist_out[i] = best_t;
  prim_out[i] = best_p;
}

// The any-hit test of live lane j: ray j from point[j % n_point] offset by
// EPS_RAY along its direction meets a primitive at 0 < t < tmax.
__device__ __forceinline__ bool ray_blocked(
    const Scene& s, const float* __restrict__ px_p,
    const float* __restrict__ py_p, const float* __restrict__ pz_p,
    int n_point, const float* __restrict__ dx_p,
    const float* __restrict__ dy_p, const float* __restrict__ dz_p,
    const float* __restrict__ dist_p, int j) {
  const int jp = j < n_point ? j : j % n_point;
  const float dx = dx_p[j], dy = dy_p[j], dz = dz_p[j];
  const float ox = px_p[jp] + dx * kEpsRay;
  const float oy = py_p[jp] + dy * kEpsRay;
  const float oz = pz_p[jp] + dz * kEpsRay;
  const float tmax = dist_p[j] - kTwoEpsRay;

  // min_k t_k < tmax, where a missed primitive's t_k is kBigDist.
  bool blocked = kBigDist < tmax;
#pragma unroll
  for (int k = 0; k < kMaxTri; ++k) {
    if (k >= s.n_tri || blocked) break;
    const float t = tri_t(s, k, ox, oy, oz, dx, dy, dz);
    blocked = t > 0.f && t < tmax;
  }
#pragma unroll
  for (int k = 0; k < kMaxSph; ++k) {
    if (k >= s.n_sph || blocked) break;
    blocked = sph_t(s, k, ox, oy, oz, dx, dy, dz) < tmax;
  }
  return blocked;
}

static_assert(kBlock * kMaxLanes <= 65536, "window lanes index as uint16");

// V mask or answer bytes as one load or store.
template <int V> struct Bytes;
template <> struct Bytes<1> { using T = uint8_t; };
template <> struct Bytes<2> { using T = uint16_t; };
template <> struct Bytes<4> { using T = uint32_t; };

// One block takes a window of kBlock * V lanes; thread t owns lanes
// [t * V, t * V + V) of it. Each thread reads its V mask bytes and writes
// V zero answers (one V-byte load and store), the block lists its live
// lanes in shared memory in lane order, and all its warps test the listed
// rays in full warps, writing 1 where a ray is blocked. A window that
// crosses the end of the lanes, or a mask or answer pointer not aligned to
// V bytes, takes one byte at a time instead.
template <int V>
__global__ void __launch_bounds__(kBlock) occluded_sweep_kernel(
    const __grid_constant__ Scene s, const float* __restrict__ px_p,
    const float* __restrict__ py_p, const float* __restrict__ pz_p,
    int n_point, const float* __restrict__ dx_p,
    const float* __restrict__ dy_p, const float* __restrict__ dz_p,
    const float* __restrict__ dist_p, const uint8_t* __restrict__ active,
    uint8_t* __restrict__ out, int m) {
  using T = typename Bytes<V>::T;
  constexpr int kWindow = kBlock * V;
  __shared__ int s_count[kWarps];
  __shared__ uint16_t s_list[kWindow];

  const long long first = (long long)blockIdx.x * kWindow + threadIdx.x * V;
  const bool wide = first + V <= m &&
                    ((reinterpret_cast<uintptr_t>(active) |
                      reinterpret_cast<uintptr_t>(out)) % V) == 0;

  // Bit k of `live`: lane first + k is active.
  unsigned live = 0;
  if (wide) {
    const T v = *reinterpret_cast<const T*>(active + first);
    *reinterpret_cast<T*>(out + first) = T{};
    uint8_t b[V];
    memcpy(b, &v, V);
#pragma unroll
    for (int k = 0; k < V; ++k) live |= (b[k] != 0 ? 1u : 0u) << k;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (first + k < m) {
        live |= (active[first + k] != 0 ? 1u : 0u) << k;
        out[first + k] = 0;
      }
    }
  }

  // Prefix count of live lanes over the block: in the warp, then warps.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int count = __popc(live);
  int incl = count;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += up;
  }
  if (lane == 31) s_count[warp] = incl;
  __syncthreads();
  int pos = incl - count, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    pos += w < warp ? s_count[w] : 0;
    total += s_count[w];
  }
  while (live) {
    const int k = __ffs(live) - 1;
    live &= live - 1;
    s_list[pos++] = (uint16_t)(threadIdx.x * V + k);
  }
  __syncthreads();

  // The zero answers above come first: __syncthreads orders a block's
  // global writes.
  const long long base = (long long)blockIdx.x * kWindow;
  for (int k = threadIdx.x; k < total; k += kBlock) {
    const int j = (int)(base + s_list[k]);
    if (ray_blocked(s, px_p, py_p, pz_p, n_point, dx_p, dy_p, dz_p, dist_p,
                    j))
      out[j] = 1;
  }
}

// Copy the host block into the kernel's by-value scene; false if the
// counts do not fit.
bool load_scene(Scene* s, const float* block, int n_tri, int n_sph) {
  if (n_tri < 1 || n_tri > kMaxTri || n_sph < 0 || n_sph > kMaxSph)
    return false;
  memcpy(s->tri, block, sizeof(s->tri));
  memcpy(s->sph, block + kMaxTri * kTriFloats, sizeof(s->sph));
  s->n_tri = n_tri;
  s->n_sph = n_sph;
  return true;
}

}  // namespace

static_assert(sizeof(Scene) == sizeof(float) * kBlockFloats + 2 * sizeof(int),
              "scene block layout");

extern "C" int svcm_intersect_sweep(
    const float* block, int n_tri, int n_sph, const float* ox,
    const float* oy, const float* oz, const float* dx, const float* dy,
    const float* dz, float* dist, int64_t* prim, int n, void* stream) {
  Scene s;
  if (!load_scene(&s, block, n_tri, n_sph)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const int grid = (n + kBlock - 1) / kBlock;
  intersect_sweep_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      s, ox, oy, oz, dx, dy, dz, dist, prim, n);
  return (int)cudaGetLastError();
}

extern "C" int svcm_occluded_sweep(
    const float* block, int n_tri, int n_sph, const float* px,
    const float* py, const float* pz, int n_point, const float* dx,
    const float* dy, const float* dz, const float* dist,
    const uint8_t* active, uint8_t* out, int m, int lanes_per_thread,
    void* stream) {
  Scene s;
  if (!load_scene(&s, block, n_tri, n_sph)) return (int)cudaErrorInvalidValue;
  if (m <= 0) return 0;
  if (n_point < 1 || active == nullptr) return (int)cudaErrorInvalidValue;
  const long long window = (long long)kBlock * lanes_per_thread;
  const int grid = (int)((m + window - 1) / window);
  cudaStream_t st = (cudaStream_t)stream;
#define SVCM_OCCLUDED(V)                                                \
  occluded_sweep_kernel<V><<<grid, kBlock, 0, st>>>(                    \
      s, px, py, pz, n_point, dx, dy, dz, dist, active, out, m)
  switch (lanes_per_thread) {
    case 1: SVCM_OCCLUDED(1); break;
    case 2: SVCM_OCCLUDED(2); break;
    case 4: SVCM_OCCLUDED(4); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef SVCM_OCCLUDED
  return (int)cudaGetLastError();
}
