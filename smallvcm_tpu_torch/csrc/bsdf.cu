// The four-lobe BSDF of ops/bsdf.py (setup, evaluate, sample), one launch
// a call. Sample also writes pdf's reverse pdf of the sampled direction
// (vcm.py's sample_scattering reads it; pathtracer.py leaves it), and a
// fourth op fuses setup then evaluate (the light vertex of vcm.py's
// connect_vertices), with the bits of the two calls.
//
// Replaces no TPU kernel: the JAX package's BSDF (smallvcm_tpu/ops/bsdf.py)
// is elementwise code that XLA fuses, and the port's plain version
// (ops/bsdf.py::setup_plain and its siblings) runs it as a chain of about
// 150 single-op ATen kernels a call over one plane each: frame building,
// material gathers, Fresnel, the lobe probabilities, the four sampling
// candidates and their selection. It was added because those chains were
// ~60% of an iteration's kernels.
//
// It computes the same bits. Every torch op of the plain version is one
// IEEE f32 operation here, in the same order (elementwise.cuh says how).
// Dead lanes compute everything, as the plain version's do, and give the
// same NaNs.
//
// Bound: bytes. A lane reads 33-89 bytes and writes 24-82 (setup writes
// the whole BsdfState, 21 planes) against a few hundred f32 operations,
// so a call over 262,144 lanes moves 26-35 MB: 8-11 us at 3.35 TB/s. The
// fusion keeps the intermediate state in registers: setup_evaluate over
// a connection window writes 7 planes where setup wrote 21.
// Design: one thread a lane, 256 a block; the material table (11 planes
// of a few rows) is read into shared memory once a block (the set-up and
// the table's reads are bsdf_setup.cuh's, shared with merge_prep.cu);
// each operand is read through its own (row, column) strides, so a state
// expanded from [N] to [w, N] (stride 0 along w) is read from its [N]
// base and never materialised; outputs are contiguous planes. No
// atomics, no allocation, launched on the caller's stream, so a CUDA graph
// captures it as it is.

#include "bsdf_setup.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kMaxIn = 24;
constexpr int kMaxOut = 21;

// Operation codes of ops/bsdf.py::_OPS.
enum Op { kSetup = 0, kEvaluate = 1, kSample = 2, kSetupEvaluate = 3 };

#define EPS_PHONG F(1e-3)

// Event codes (ops/bsdf.py).
constexpr long long kEvDiffuse = 1, kEvPhong = 2, kEvReflect = 4,
                    kEvRefract = 8;

struct Args {
  Plane in[kMaxIn];
  void* out[kMaxOut];
  Plane mat[kMatPlanes];  // one row; cs: the plane's stride
  int m, rows, n;
};

__device__ __forceinline__ V reflect_local(V v) { return mk(-v.x, -v.y, v.z); }

__device__ __forceinline__ V to_world(const Frame& f, V a) {
  return add(add(scale(f.x, a.x), scale(f.y, a.y)), scale(f.z, a.z));
}

__device__ __forceinline__ V sample_power_cos_hemisphere(float u1, float u2,
                                                         float power) {
  const float term1 = F(2.0 * kPi) * u1;
  const float u = clamp_min(u2, F(1e-12));
  const float term2 = powf(u, recip(power + 1.0f));
  const float term3 = sqrtf(clamp_min(1.0f - term2 * term2, F(1e-12)));
  return mk(cosf(term1) * term3, sinf(term1) * term3, term2);
}

__device__ __forceinline__ float power_cos_hemisphere_pdf(V normal, V dir,
                                                          float power) {
  const float cos_theta = clamp_min(dot(normal, dir), 0.0f);
  const float safe = clamp_min(cos_theta, F(1e-20));
  const float val =
      ((power + 1.0f) * powf(safe, power)) * F(kInvPi * 0.5);
  return cos_theta > 0.0f ? val : 0.0f;
}

// -- ops/bsdf.py --------------------------------------------------------------

__device__ __forceinline__ float phong_rho_s(float exponent) {
  return ((exponent + 2.0f) * 0.5f) * F(kInvPi);
}

// _eval_diffuse: value, direct and reverse pdfs.
__device__ __forceinline__ void eval_diffuse(const State& s, V diffuse, V g,
                                             V* value, float* direct,
                                             float* rev) {
  const bool ok =
      (s.p_diff > 0.0f) & (s.fix.z >= EPS_COSINE) & (g.z >= EPS_COSINE);
  const V v = scale(diffuse, F(kInvPi));
  *value = mk(ok ? v.x : 0.0f, ok ? v.y : 0.0f, ok ? v.z : 0.0f);
  *direct = ok ? s.p_diff * clamp_min(g.z * F(kInvPi), 0.0f) : 0.0f;
  *rev = ok ? s.p_diff * clamp_min(s.fix.z * F(kInvPi), 0.0f) : 0.0f;
}

// _eval_phong: value and pdf (the same both ways).
__device__ __forceinline__ void eval_phong(const State& s, V phong,
                                           float exponent, V g, V* value,
                                           float* pdf) {
  const V refl_fix = reflect_local(s.fix);
  const float dot_r_wi = dot(refl_fix, g);
  const bool ok = (s.p_phong > 0.0f) & (s.fix.z >= EPS_COSINE) &
                  (g.z >= EPS_COSINE) & (dot_r_wi > EPS_PHONG);
  const float pdf_w =
      s.p_phong * power_cos_hemisphere_pdf(refl_fix, g, exponent);
  const float rho_s = phong_rho_s(exponent);
  const float lobe = powf(clamp_min(dot_r_wi, EPS_PHONG), exponent);
  const V v = scale(scale(phong, rho_s), lobe);
  *value = mk(ok ? v.x : 0.0f, ok ? v.y : 0.0f, ok ? v.z : 0.0f);
  *pdf = ok ? pdf_w : 0.0f;
}

// _pdf_diffuse (no EPS_COSINE gating).
__device__ __forceinline__ void pdf_diffuse(const State& s, V g,
                                            float* direct, float* rev) {
  const bool ok = s.p_diff > 0.0f;
  *direct = ok ? s.p_diff * clamp_min(g.z * F(kInvPi), 0.0f) : 0.0f;
  *rev = ok ? s.p_diff * clamp_min(s.fix.z * F(kInvPi), 0.0f) : 0.0f;
}

// _pdf_phong.
__device__ __forceinline__ float pdf_phong(const State& s, float exponent,
                                           V g) {
  const V refl_fix = reflect_local(s.fix);
  const float dot_r_wi = dot(refl_fix, g);
  const bool ok = (s.p_phong > 0.0f) & (dot_r_wi > EPS_PHONG);
  const float pdf_w =
      power_cos_hemisphere_pdf(refl_fix, g, exponent) * s.p_phong;
  return ok ? pdf_w : 0.0f;
}

struct Eval {
  V value;
  float cos_gen, direct, rev;
};

// evaluate (BSDF::Evaluate).
__device__ __forceinline__ Eval evaluate_lane(const State& s,
                                              const Material& mt, V dir) {
  const V g = to_local(s.frame, dir);
  const bool same_side = (g.z * s.fix.z >= 0.0f) & s.valid;
  V vd, vp;
  float dd, rd, dp;
  eval_diffuse(s, mt.diffuse, g, &vd, &dd, &rd);
  eval_phong(s, mt.phong, mt.exponent, g, &vp, &dp);
  const V v = add(vd, vp);
  Eval e;
  e.value = mk(same_side ? v.x : 0.0f, same_side ? v.y : 0.0f,
               same_side ? v.z : 0.0f);
  e.cos_gen = fabsf(g.z);
  e.direct = same_side ? dd + dp : 0.0f;
  e.rev = same_side ? rd + dp : 0.0f;
  return e;
}

// pdf (BSDF::Pdf) -> its reverse pdf; *direct gets the direct one.
__device__ __forceinline__ float pdf_lane(const State& s, const Material& mt,
                                          V dir, float* direct) {
  const V g = to_local(s.frame, dir);
  const bool same_side = (g.z * s.fix.z >= 0.0f) & s.valid;
  float dd, rd;
  pdf_diffuse(s, g, &dd, &rd);
  const float dp = pdf_phong(s, mt.exponent, g);
  *direct = same_side ? dd + dp : 0.0f;
  return same_side ? rd + dp : 0.0f;
}

struct Sample {
  V value, world;
  float pdf_w, cos_gen;
  long long event;
  bool keep;
};

// sample (BSDF::Sample): the four candidates, selected by event.
__device__ __forceinline__ Sample sample_lane(const State& s,
                                              const Material& mt, float u1,
                                              float u2, float u3,
                                              bool fix_is_light) {
  const float thr_d = s.p_diff;
  const float thr_p = thr_d + s.p_phong;
  const float thr_r = thr_p + s.p_refl;
  const long long event = u3 < thr_d   ? kEvDiffuse
                          : u3 < thr_p ? kEvPhong
                          : u3 < thr_r ? kEvReflect
                                       : kEvRefract;
  const V fix = s.fix;

  // Diffuse candidate (SampleDiffuse + EvaluatePhong).
  float d_unweighted_pdf;
  const V d_dir = sample_cos_hemisphere(u1, u2, &d_unweighted_pdf);
  const bool d_ok = fix.z >= EPS_COSINE;
  V pv;
  float ppd;
  eval_phong(s, mt.phong, mt.exponent, d_dir, &pv, &ppd);
  const V d_value = add(scale(mt.diffuse, F(kInvPi)), pv);
  const float d_pdf = d_unweighted_pdf * s.p_diff + ppd;

  // Phong candidate (SamplePhong + EvaluateDiffuse).
  const V lobe_dir = sample_power_cos_hemisphere(u1, u2, mt.exponent);
  const V refl_fix = reflect_local(fix);
  const Frame rf = frame_set_from_z(refl_fix);
  const V p_dir = to_world(rf, lobe_dir);
  const float dot_r_wi = dot(refl_fix, p_dir);
  const bool p_ok = dot_r_wi > EPS_PHONG;
  const float p_pdf_d = pdf_phong(s, mt.exponent, p_dir);
  const float lobe = powf(clamp_min(dot_r_wi, EPS_PHONG), mt.exponent);
  V dv;
  float dd_pdf, unused;
  eval_diffuse(s, mt.diffuse, p_dir, &dv, &dd_pdf, &unused);
  const V p_value =
      add(scale(scale(mt.phong, phong_rho_s(mt.exponent)), lobe), dv);
  const float p_pdf = p_pdf_d + dd_pdf;

  // Reflect candidate.
  const float r_cos = clamp_min(fabsf(refl_fix.z), F(1e-30));
  const V r_value = scale(mt.mirror, s.rc / r_cos);

  // Refract candidate.
  const bool inside = fix.z < 0.0f;
  const float safe_ior = mt.ior <= 0.0f ? 1.5f : mt.ior;
  const float eta = inside ? safe_ior : recip(safe_ior);
  const float cos_i = fabsf(fix.z);
  const float cos_t_sign = inside ? 1.0f : -1.0f;
  const float sin_t2 = (eta * eta) * (1.0f - cos_i * cos_i);
  const bool no_tir = sin_t2 < 1.0f;
  const float cos_t =
      cos_t_sign * sqrtf(clamp_min(1.0f - sin_t2, F(1e-12)));
  const V f_dir = mk(-eta * fix.x, -eta * fix.y, cos_t);
  const float refract_coeff = 1.0f - s.rc;
  const float abs_cos_t = clamp_min(fabsf(cos_t), F(1e-30));
  const float f_scalar = fix_is_light
                             ? refract_coeff / abs_cos_t
                             : (refract_coeff * (eta * eta)) / abs_cos_t;
  const bool f_ok = (mt.ior >= 0.0f) & no_tir;

  // Select by event.
  const bool is_d = event == kEvDiffuse;
  const bool is_p = event == kEvPhong;
  const bool is_r = event == kEvReflect;
  const V g = pick(is_d, d_dir,
                   pick(is_p, p_dir, pick(is_r, refl_fix, f_dir)));
  Sample out;
  out.pdf_w = is_d ? d_pdf : is_p ? p_pdf : is_r ? s.p_refl : s.p_refr;
  out.value = pick(is_d, d_value,
                   pick(is_p, p_value,
                        pick(is_r, r_value,
                             mk(f_scalar, f_scalar, f_scalar))));
  const bool ok = is_d ? d_ok : is_p ? p_ok : is_r ? true : f_ok;
  out.cos_gen = fabsf(g.z);
  out.keep = ok & (out.cos_gen >= EPS_COSINE) & s.valid;
  out.world = to_world(s.frame, g);
  out.event = event;
  return out;
}

// -- operands -----------------------------------------------------------------

__device__ __forceinline__ V ld3(const Args& a, int k, long long r,
                                 long long i) {
  return mk(ld<float>(a.in[k], r, i), ld<float>(a.in[k + 1], r, i),
            ld<float>(a.in[k + 2], r, i));
}

// Writes the outputs from plane k on: st(v) takes the next plane.
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

// Inputs 0-20 of evaluate and sample: a BsdfState's planes in field
// order (valid, mat_id, frame_x, frame_y, frame_z, local_dir_fix,
// is_delta, prob_diff, prob_phong, prob_refl, prob_refr, cont_prob,
// reflect_coeff). Sample alone reads prob_refl, prob_refr and
// reflect_coeff; nothing reads is_delta and cont_prob.
template <typename Id, bool kSampling>
__device__ __forceinline__ State load_state(const Args& a, long long r,
                                            long long i, long long* id) {
  State s;
  s.valid = ld<bool>(a.in[0], r, i);
  *id = (long long)ld<Id>(a.in[1], r, i);
  s.frame.x = ld3(a, 2, r, i);
  s.frame.y = ld3(a, 5, r, i);
  s.frame.z = ld3(a, 8, r, i);
  s.fix = ld3(a, 11, r, i);
  s.p_diff = ld<float>(a.in[15], r, i);
  s.p_phong = ld<float>(a.in[16], r, i);
  if (kSampling) {
    s.p_refl = ld<float>(a.in[17], r, i);
    s.p_refr = ld<float>(a.in[18], r, i);
    s.rc = ld<float>(a.in[20], r, i);
  }
  return s;
}

// Inputs 0-7 of setup and setup_evaluate: ray_dir, normal, mat_id,
// hit_mask.
template <typename Id>
__device__ __forceinline__ State setup_from(const Args& a, const float* smat,
                                            long long r, long long i,
                                            long long* id) {
  *id = (long long)ld<Id>(a.in[6], r, i);
  return setup_lane(smat, a.m, ld3(a, 0, r, i), ld3(a, 3, r, i), *id,
                    ld<bool>(a.in[7], r, i));
}

// One lane of op kOp: its operands and outputs in ops/bsdf.py::_OUTS's
// order.
template <int kOp, typename Id>
__device__ __forceinline__ void lane(const Args& a, const float* smat,
                                     long long r, long long i, long long t,
                                     bool fix_is_light) {
  Writer w{a, t, 0};
  long long id;
  if constexpr (kOp == kSetup) {  // -> the BsdfState's 21 planes
    const State s = setup_from<Id>(a, smat, r, i, &id);
    w.st<bool>(s.valid);
    w.st<long long>(id < 0 ? 0LL : id);
    w.st3(s.frame.x);
    w.st3(s.frame.y);
    w.st3(s.frame.z);
    w.st3(s.fix);
    w.st<bool>((s.p_diff == 0.0f) & (s.p_phong == 0.0f));
    w.st<float>(s.p_diff);
    w.st<float>(s.p_phong);
    w.st<float>(s.p_refl);
    w.st<float>(s.p_refr);
    w.st<float>(s.cont);
    w.st<float>(s.rc);
  } else if constexpr (kOp == kSetupEvaluate) {  // + world_dir_gen (8-10)
    const State s = setup_from<Id>(a, smat, r, i, &id);
    const Eval e = evaluate_lane(s, material(smat, a.m, id),
                                 ld3(a, 8, r, i));
    w.st3(e.value);
    w.st<float>(e.cos_gen);
    w.st<float>(e.direct);
    w.st<float>(e.rev);
    w.st<float>(s.cont);
  } else if constexpr (kOp == kEvaluate) {  // + world_dir_gen (21-23)
    const State s = load_state<Id, false>(a, r, i, &id);
    const Eval e =
        evaluate_lane(s, material(smat, a.m, id), ld3(a, 21, r, i));
    w.st3(e.value);
    w.st<float>(e.cos_gen);
    w.st<float>(e.direct);
    w.st<float>(e.rev);
  } else {  // kSample: + u1, u2, u3 (21-23)
    const State s = load_state<Id, true>(a, r, i, &id);
    const Material mt = material(smat, a.m, id);
    const Sample o =
        sample_lane(s, mt, ld<float>(a.in[21], r, i),
                    ld<float>(a.in[22], r, i), ld<float>(a.in[23], r, i),
                    fix_is_light);
    w.st3(o.value);
    w.st3(o.world);
    w.st<float>(o.pdf_w);
    w.st<float>(o.cos_gen);
    w.st<long long>(o.event);
    w.st<bool>(o.keep);
    float direct;  // pdf's reverse pdf of the sampled direction
    w.st<float>(pdf_lane(s, mt, o.world, &direct));
  }
}

template <int kOp, typename Id>
__global__ void __launch_bounds__(kBlock)
    bsdf_kernel(const __grid_constant__ Args a, bool fix_is_light) {
  extern __shared__ float smat[];
  load_materials(smat, a.mat, a.m);
  // rows * n < 2^31 (the wrapper's check).
  const unsigned int t = blockIdx.x * kBlock + threadIdx.x;
  if (t >= (unsigned int)a.rows * (unsigned int)a.n) return;
  const unsigned int r = t / (unsigned int)a.n;
  const unsigned int i = t - r * (unsigned int)a.n;
  lane<kOp, Id>(a, smat, r, i, t, fix_is_light);
}

template <int kOp, typename Id>
int launch(const Args& a, bool fix_is_light, cudaStream_t s) {
  const long long lanes = (long long)a.rows * a.n;
  const unsigned int grid = (unsigned int)((lanes + kBlock - 1) / kBlock);
  const size_t smem = sizeof(float) * kMatPlanes * a.m;
  bsdf_kernel<kOp, Id><<<grid, kBlock, smem, s>>>(a, fix_is_light);
  return (int)cudaGetLastError();
}

template <int kOp>
int launch_op(const Args& a, bool mat_i64, bool fix_is_light,
              cudaStream_t s) {
  return mat_i64 ? launch<kOp, long long>(a, fix_is_light, s)
                 : launch<kOp, int>(a, fix_is_light, s);
}

}  // namespace

// op: 0 setup, 1 evaluate, 2 sample then pdf of the sampled direction,
// 3 setup then evaluate. ins: n_in triples (pointer,
// row stride, column stride) of the op's operands over a [rows, n] lane
// grid, in ops/bsdf.py::bsdf_kernel's order; outs: n_out contiguous
// [rows * n] planes; mats: 11 pairs (pointer, stride) of the planes of
// Materials in field order, m rows each; mat_i64: the mat_id operand is
// int64 (else int32); fix_is_light: sample's refraction leaves out the
// eta^2 factor.
extern "C" int svcm_bsdf(int op, const long long* ins, int n_in,
                         void* const* outs, int n_out,
                         const long long* mats, int m, int rows, int n,
                         int mat_i64, int fix_is_light, void* cuda_stream) {
  static const int kIn[] = {8, 24, 24, 11};
  static const int kOut[] = {21, 6, 11, 7};
  if (op < 0 || op > 3 || n_in != kIn[op] || n_out != kOut[op] || m < 1 ||
      m > kMaxMaterials || rows < 0 || n < 0) {
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
  for (int k = 0; k < kMatPlanes; ++k) {
    a.mat[k].p = reinterpret_cast<const void*>(mats[2 * k]);
    a.mat[k].rs = 0;
    a.mat[k].cs = mats[2 * k + 1];
  }
  a.m = m;
  a.rows = rows;
  a.n = n;
  const cudaStream_t s = (cudaStream_t)cuda_stream;
  const bool i64 = mat_i64 != 0, light = fix_is_light != 0;
  switch (op) {
    case kSetup:
      return launch_op<kSetup>(a, i64, light, s);
    case kEvaluate:
      return launch_op<kEvaluate>(a, i64, light, s);
    case kSample:
      return launch_op<kSample>(a, i64, light, s);
    default:
      return launch_op<kSetupEvaluate>(a, i64, light, s);
  }
}
