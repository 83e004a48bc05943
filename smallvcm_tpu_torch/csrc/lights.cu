// The four light types of ops/lights.py (illuminate, emit, get_radiance),
// one launch a call.
//
// Replaces no TPU kernel: the JAX package's lights (smallvcm_tpu/ops/
// lights.py) are elementwise code that XLA fuses, and the port's plain
// version (ops/lights.py::illuminate_plain and its siblings) runs them as
// a chain of 64-294 single-op ATen kernels a call: every lane gathers all
// 25 planes of its light's record, computes all four light types'
// formulas at full width and keeps one with nested torch.where. It was
// added because those chains were ~49% of a path-tracing iteration's
// kernels and ~27% of a VCM iteration's.
//
// It computes the same bits. A lane branches on its light's kind and
// computes only that type's formula: torch.where keeps the picked type's
// value and discards the other three, so the selected bits are the same.
// Every torch op of the picked formula is one IEEE f32 operation here, in
// the same order (elementwise.cuh says how), with Python's folded
// constants: concentric_disc_pdf_a() * inv_radius_sqr is F(1/pi) times
// the tensor, get_radiance's background emission pdf folds 1/(4 pi) *
// 1/pi in double first, as Python does with two floats.
//
// Bound: bytes. A lane reads its id (8 bytes) and 8-16 bytes of operands
// and writes 20-50 bytes (illuminate 68 bytes a lane, emit 74,
// get_radiance 40) against a few dozen f32 operations, so a call over
// 262,144 lanes moves 10-19 MB: 3.1-5.8 us at 3.35 TB/s.
// Design: one thread a lane, 256 a block; the light table (25 planes of a
// few rows) and the scene sphere's five scalars are read into shared
// memory once a block; each operand is read through its own (row,
// column) strides, so the uniforms are read as columns of the RNG's
// [N, slots] output; outputs are contiguous planes. No atomics, no
// allocation, launched on the caller's stream, so a CUDA graph captures
// it as it is.

#include "elementwise.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kMaxIn = 6;
constexpr int kMaxOut = 14;
constexpr int kTablePlanes = 25;  // Lights' leaves in field order
constexpr int kFloatPlanes = 22;  // p0 ... inv_area (leaves 1-22)
constexpr int kSpherePlanes = 5;  // center (3), radius, inv_radius_sqr
constexpr int kMaxLights = 256;

// Operation codes of ops/lights.py::_OPS.
enum Op { kIlluminate = 0, kEmit = 1, kGetRadiance = 2 };

// Light kinds (scene/scene.py). illuminate and emit take any other kind
// for a background light, as the plain version's selection does.
enum Kind { kArea = 0, kDirectional = 1, kPoint = 2, kBackground = 3 };

struct Args {
  Plane in[kMaxIn];
  void* out[kMaxOut];
  Plane table[kTablePlanes];    // one row; cs: the plane's stride
  const float* sphere[kSpherePlanes];
  int l, rows, n;
};

__device__ __forceinline__ V sub(V a, V b) {
  return mk(a.x - b.x, a.y - b.y, a.z - b.z);
}

__device__ __forceinline__ V neg(V a) { return mk(-a.x, -a.y, -a.z); }

__device__ __forceinline__ V splat(float s) { return mk(s, s, s); }

// -- core/vecmath.py's samplers ----------------------------------------------

// sample_uniform_triangle -> the barycentric pair.
__device__ __forceinline__ void sample_uniform_triangle(float u1, float u2,
                                                        float* a, float* b) {
  const float term = sqrtf(clamp_min(u1, F(1e-12)));
  *a = 1.0f - term;
  *b = u2 * term;
}

__device__ __forceinline__ V sample_uniform_sphere(float u1, float u2,
                                                   float* pdf) {
  const float term1 = F(2.0 * kPi) * u1;
  const float term2 = 2.0f * sqrtf(clamp_min(u2 - u2 * u2, F(1e-12)));
  *pdf = F(kInvPi * 0.25);
  return mk(cosf(term1) * term2, sinf(term1) * term2, 1.0f - 2.0f * u2);
}

__device__ __forceinline__ float safe(float x) { return x == 0.0f ? 1.0f : x; }

// sample_concentric_disc (branch-free in the plain version: every region's
// radius and angle, then selected; the selected ones are computed here).
__device__ __forceinline__ void sample_concentric_disc(float u1, float u2,
                                                       float* x, float* y) {
  const float a = 2.0f * u1 - 1.0f;
  const float b = 2.0f * u2 - 1.0f;
  const float quarter = F(kPi / 4.0);
  const bool reg12 = a > -b;
  const bool reg1 = reg12 && (a > b);
  const bool reg2 = reg12 && !(a > b);
  const bool reg3 = !reg12 && (a < b);
  float r, phi;
  if (reg1) {
    r = a;
    phi = quarter * (b / safe(a));
  } else if (reg2) {
    r = b;
    phi = quarter * (2.0f - a / safe(b));
  } else if (reg3) {
    r = -a;
    phi = quarter * (b / safe(a) + 4.0f);
  } else {
    r = -b;
    phi = b != 0.0f ? quarter * (6.0f - a / safe(b)) : 0.0f;
  }
  *x = r * cosf(phi);
  *y = r * sinf(phi);
}

// -- ops/lights.py --------------------------------------------------------------

struct Light {
  int kind;
  V p0, e1, e2, fx, fy, fz, intensity;
  float inv_area;
  bool is_finite, is_delta;
};

struct Sphere {
  V center;
  float radius, inv_radius_sqr;
};

// The light table in shared memory: its 22 float planes (f), then kind,
// is_finite and is_delta as words (w), l rows each.
struct Table {
  const float* f;
  const int* w;
  int l;
};

// The id's row, the id clamped to the table as the plain gather's
// clamp(0, L - 1) does: lanes with id -1 read light 0.
__device__ __forceinline__ Light light(const Table& t, long long id) {
  const int k = (int)min(max(id, 0LL), (long long)(t.l - 1));
  const int l = t.l;
  const float* f = t.f;
  auto v3 = [&](int plane) {
    return mk(f[plane * l + k], f[(plane + 1) * l + k],
              f[(plane + 2) * l + k]);
  };
  Light lt;
  lt.kind = t.w[k];
  lt.p0 = v3(0);
  lt.e1 = v3(3);
  lt.e2 = v3(6);
  lt.fx = v3(9);
  lt.fy = v3(12);
  lt.fz = v3(15);
  lt.intensity = v3(18);
  lt.inv_area = f[21 * l + k];
  lt.is_finite = t.w[l + k] != 0;
  lt.is_delta = t.w[2 * l + k] != 0;
  return lt;
}

struct Illumination {
  V radiance, dir;
  float distance, direct_pdf, emission_pdf, cos_at_light;
};

// illuminate (AbstractLight::Illuminate).
__device__ __forceinline__ Illumination illuminate_lane(const Light& lt,
                                                        const Sphere& sp,
                                                        V pos, float u1,
                                                        float u2) {
  Illumination o;
  o.radiance = lt.intensity;
  o.cos_at_light = 1.0f;
  if (lt.kind == kArea) {
    float uv0, uv1;
    sample_uniform_triangle(u1, u2, &uv0, &uv1);
    const V lp = add(add(lt.p0, scale(lt.e1, uv0)), scale(lt.e2, uv1));
    const V to_l = sub(lp, pos);
    const float dist_sqr = clamp_min(dot(to_l, to_l), F(1e-30));
    o.distance = sqrtf(dist_sqr);
    o.dir = scale(to_l, recip(o.distance));
    const float cos_normal_dir = dot(lt.fz, neg(o.dir));
    const bool ok = cos_normal_dir >= EPS_COSINE;
    const float safe_cos = safe(ok ? cos_normal_dir : 0.0f);
    o.direct_pdf = (lt.inv_area * dist_sqr) / safe_cos;
    o.emission_pdf = (lt.inv_area * cos_normal_dir) * F(kInvPi);
    o.radiance = ok ? lt.intensity : splat(0.0f);
    o.cos_at_light = ok ? cos_normal_dir : 1.0f;
  } else if (lt.kind == kDirectional) {
    o.dir = neg(lt.fz);
    o.distance = F(1e36);
    o.direct_pdf = 1.0f;
    o.emission_pdf = F(kInvPi) * sp.inv_radius_sqr;
  } else if (lt.kind == kPoint) {
    const V to_l = sub(lt.p0, pos);
    const float dist_sqr = clamp_min(dot(to_l, to_l), F(1e-30));
    o.distance = sqrtf(dist_sqr);
    o.dir = scale(to_l, recip(o.distance));
    o.direct_pdf = dist_sqr;
    o.emission_pdf = F(kInvPi * 0.25);
  } else {  // background
    float pdf;
    o.dir = sample_uniform_sphere(u1, u2, &pdf);
    o.distance = F(1e36);
    o.direct_pdf = pdf;
    o.emission_pdf = (pdf * F(kInvPi)) * sp.inv_radius_sqr;
  }
  return o;
}

struct Emission {
  V energy, position, direction;
  float emission_pdf, direct_pdf, cos_theta;
};

// emit (AbstractLight::Emit): ud* the direction pair, up* the position
// pair.
__device__ __forceinline__ Emission emit_lane(const Light& lt,
                                              const Sphere& sp, float ud1,
                                              float ud2, float up1,
                                              float up2) {
  Emission o;
  o.energy = lt.intensity;
  o.direct_pdf = 1.0f;
  o.cos_theta = 1.0f;
  if (lt.kind == kArea) {
    float uv0, uv1, cos_pdf;
    sample_uniform_triangle(up1, up2, &uv0, &uv1);
    o.position = add(add(lt.p0, scale(lt.e1, uv0)), scale(lt.e2, uv1));
    const V local = sample_cos_hemisphere(ud1, ud2, &cos_pdf);
    o.emission_pdf = cos_pdf * lt.inv_area;
    const float local_z = clamp_min(local.z, EPS_COSINE);
    o.direction = add(add(scale(lt.fx, local.x), scale(lt.fy, local.y)),
                      scale(lt.fz, local_z));
    o.energy = scale(lt.intensity, local_z);
    o.direct_pdf = lt.inv_area;
    o.cos_theta = local_z;
  } else if (lt.kind == kDirectional) {
    float disc_x, disc_y;
    sample_concentric_disc(up1, up2, &disc_x, &disc_y);
    const V t = add(add(neg(lt.fz), scale(lt.fx, disc_x)),
                    scale(lt.fy, disc_y));
    o.position = add(sp.center, scale(t, sp.radius));
    o.direction = lt.fz;
    o.emission_pdf = F(kInvPi) * sp.inv_radius_sqr;
  } else if (lt.kind == kPoint) {
    o.position = lt.p0;
    o.direction = sample_uniform_sphere(ud1, ud2, &o.emission_pdf);
  } else {  // background
    float pdf, disc_x, disc_y;
    o.direction = sample_uniform_sphere(ud1, ud2, &pdf);
    const Frame f = frame_set_from_z(o.direction);
    sample_concentric_disc(up1, up2, &disc_x, &disc_y);
    const V t = add(add(neg(o.direction), scale(f.x, disc_x)),
                    scale(f.y, disc_y));
    o.position = add(sp.center, scale(t, sp.radius));
    o.emission_pdf = (pdf * F(kInvPi)) * sp.inv_radius_sqr;
    o.direct_pdf = pdf;
  }
  return o;
}

struct Radiance {
  V radiance;
  float direct_pdf, emission_pdf;
};

// get_radiance (AbstractLight::GetRadiance): area and background lights;
// every other kind gives zeros.
__device__ __forceinline__ Radiance radiance_lane(const Light& lt,
                                                  const Sphere& sp,
                                                  V ray_dir) {
  Radiance o;
  o.radiance = splat(0.0f);
  o.direct_pdf = 0.0f;
  o.emission_pdf = 0.0f;
  if (lt.kind == kArea) {
    const float cos_out = clamp_min(dot(lt.fz, neg(ray_dir)), 0.0f);
    o.radiance = cos_out > 0.0f ? lt.intensity : splat(0.0f);
    o.direct_pdf = lt.inv_area;
    o.emission_pdf = (cos_out * F(kInvPi)) * lt.inv_area;
  } else if (lt.kind == kBackground) {
    o.radiance = lt.intensity;
    o.direct_pdf = F(kInvPi * 0.25);
    o.emission_pdf = F(kInvPi * 0.25 * kInvPi) * sp.inv_radius_sqr;
  }
  return o;
}

// -- operands -----------------------------------------------------------------

__device__ __forceinline__ V ld3(const Args& a, int k, long long r,
                                 long long i) {
  return mk(ld<float>(a.in[k], r, i), ld<float>(a.in[k + 1], r, i),
            ld<float>(a.in[k + 2], r, i));
}

// Writes the outputs from plane 0 on: st(v) takes the next plane.
struct Writer {
  const Args& a;
  long long t;
  int k;
  template <typename T>
  __device__ __forceinline__ void st(T v) {
    static_cast<T*>(a.out[k++])[t] = v;
  }
  __device__ __forceinline__ void st3(V v) {
    st<float>(v.x);
    st<float>(v.y);
    st<float>(v.z);
  }
};

// One lane of op kOp: operand 0 is the int64 light id, then the op's
// operands and outputs in ops/lights.py::_OUTS's order.
template <int kOp>
__device__ __forceinline__ void lane(const Args& a, const Table& tab,
                                     const Sphere& sp, long long r,
                                     long long i, long long t) {
  Writer w{a, t, 0};
  const Light lt = light(tab, ld<long long>(a.in[0], r, i));
  if constexpr (kOp == kIlluminate) {  // recv_pos (1-3), u1, u2
    const Illumination o =
        illuminate_lane(lt, sp, ld3(a, 1, r, i), ld<float>(a.in[4], r, i),
                        ld<float>(a.in[5], r, i));
    w.st3(o.radiance);
    w.st3(o.dir);
    w.st<float>(o.distance);
    w.st<float>(o.direct_pdf);
    w.st<float>(o.emission_pdf);
    w.st<float>(o.cos_at_light);
  } else if constexpr (kOp == kEmit) {  // ud1, ud2, up1, up2
    const Emission o = emit_lane(
        lt, sp, ld<float>(a.in[1], r, i), ld<float>(a.in[2], r, i),
        ld<float>(a.in[3], r, i), ld<float>(a.in[4], r, i));
    w.st3(o.energy);
    w.st3(o.position);
    w.st3(o.direction);
    w.st<float>(o.emission_pdf);
    w.st<float>(o.direct_pdf);
    w.st<float>(o.cos_theta);
    w.st<bool>(lt.is_finite);
    w.st<bool>(lt.is_delta);
  } else {  // kGetRadiance: ray_dir (1-3)
    const Radiance o = radiance_lane(lt, sp, ld3(a, 1, r, i));
    w.st3(o.radiance);
    w.st<float>(o.direct_pdf);
    w.st<float>(o.emission_pdf);
  }
}

template <int kOp>
__global__ void __launch_bounds__(kBlock)
    lights_kernel(const __grid_constant__ Args a) {
  extern __shared__ float smem[];
  const int l = a.l;
  float* sf = smem;  // the table's float planes, 22 l floats
  int* sw = reinterpret_cast<int*>(smem + kFloatPlanes * l);  // 3 l words
  float* ssph = smem + kTablePlanes * l;  // the sphere's five scalars
  for (int k = threadIdx.x; k < kTablePlanes * l; k += kBlock) {
    const int plane = k / l, row = k - plane * l;
    if (plane == 0) {
      sw[row] = ld<int>(a.table[0], 0, row);
    } else if (plane <= kFloatPlanes) {
      sf[(plane - 1) * l + row] = ld<float>(a.table[plane], 0, row);
    } else {
      sw[(plane - kFloatPlanes) * l + row] =
          ld<bool>(a.table[plane], 0, row) ? 1 : 0;
    }
  }
  if (threadIdx.x < kSpherePlanes) ssph[threadIdx.x] = *a.sphere[threadIdx.x];
  __syncthreads();
  // rows * n < 2^31 (the wrapper's check).
  const unsigned int t = blockIdx.x * kBlock + threadIdx.x;
  if (t >= (unsigned int)a.rows * (unsigned int)a.n) return;
  const unsigned int r = t / (unsigned int)a.n;
  const unsigned int i = t - r * (unsigned int)a.n;
  const Table tab{sf, sw, l};
  Sphere sp;
  sp.center = mk(ssph[0], ssph[1], ssph[2]);
  sp.radius = ssph[3];
  sp.inv_radius_sqr = ssph[4];
  lane<kOp>(a, tab, sp, r, i, t);
}

template <int kOp>
int launch(const Args& a, cudaStream_t s) {
  const long long lanes = (long long)a.rows * a.n;
  const unsigned int grid = (unsigned int)((lanes + kBlock - 1) / kBlock);
  const size_t smem = sizeof(float) * (kTablePlanes * a.l + kSpherePlanes);
  lights_kernel<kOp><<<grid, kBlock, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// op: 0 illuminate, 1 emit, 2 get_radiance. ins: n_in triples (pointer,
// row stride, column stride) of the op's operands over a [rows, n] lane
// grid, in ops/lights.py::lights_kernel's order (the light id first);
// outs: n_out contiguous [rows * n] planes; table: 25 pairs (pointer,
// stride) of the planes of Lights in field order, l rows each (kind
// int32, is_finite and is_delta bool, the rest float32); sphere: the
// device pointers of the scene sphere's center (3), radius and
// inv_radius_sqr.
extern "C" int svcm_lights(int op, const long long* ins, int n_in,
                           void* const* outs, int n_out,
                           const long long* table, int l,
                           const long long* sphere, int rows, int n,
                           void* cuda_stream) {
  static const int kIn[] = {6, 5, 4};
  static const int kOut[] = {10, 14, 5};
  if (op < 0 || op > 2 || n_in != kIn[op] || n_out != kOut[op] || l < 1 ||
      l > kMaxLights || rows < 0 || n < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if ((long long)rows * n == 0) return 0;
  Args a;
  for (int k = 0; k < n_in; ++k) {
    a.in[k].p = reinterpret_cast<const void*>(ins[3 * k]);
    a.in[k].rs = ins[3 * k + 1];
    a.in[k].cs = ins[3 * k + 2];
  }
  for (int k = 0; k < n_out; ++k) a.out[k] = outs[k];
  for (int k = 0; k < kTablePlanes; ++k) {
    a.table[k].p = reinterpret_cast<const void*>(table[2 * k]);
    a.table[k].rs = 0;
    a.table[k].cs = table[2 * k + 1];
  }
  for (int k = 0; k < kSpherePlanes; ++k) {
    a.sphere[k] = reinterpret_cast<const float*>(sphere[k]);
  }
  a.l = l;
  a.rows = rows;
  a.n = n;
  const cudaStream_t s = (cudaStream_t)cuda_stream;
  switch (op) {
    case kIlluminate:
      return launch<kIlluminate>(a, s);
    case kEmit:
      return launch<kEmit>(a, s);
    default:
      return launch<kGetRadiance>(a, s);
  }
}
