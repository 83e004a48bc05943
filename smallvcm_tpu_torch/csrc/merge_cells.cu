// Photon merge as a per-query walk of the 2x2x2 probe cells.
//
// Replaces the TPU kernel smallvcm_tpu/ops/pallas_merge.py::_tile_kernel
// (pallas_merge.py:170; pair math in _dense_block, driven by
// run_tile_kernel). It computes the same per-query RGB sums: every photon
// in the query's probe neighbourhood gets the exact r^2 test and the
// path-length window, the camera BSDF (diffuse + Phong) toward
// -photon.in_dir with its direct/reverse pdfs times continuation
// probabilities, the MIS weight 1/(w_light + 1 + w_camera) (1 for ppm) and
// the photon throughput.
//
// Why a cell walk and not dense tiles: the TPU kernel tests every query of
// a 256-query tile against whole photon rows of the scene (its vector unit
// wants dense 256x128 blocks). On one 512x512 VCM iteration of scene 0
// that is ~835M candidate pairs for ~0.9M within r. Here photons are
// sorted by the full cell key (ops/merge.py::merge_prep), so each probed
// (y, z) row's one or two x cells are one contiguous photon range, and a
// query visits only its own <= 4 ranges (~4.7M candidates, ~7 a query).
//
// Design: one thread per query; queries are sorted by the same cell key,
// so a warp's queries share cells and their photon loads hit in L1
// (read-only path). The walk reads one 16-byte (position, path length)
// row per query and per candidate photon (qpos, ppos); only a pair that
// passes reads the photon's 64-byte row and the query's 128-byte row
// (ptab, qtab) in 16-byte loads. A query has ~1.2 passing pairs, so its
// fields are read at each pass through L1 rather than held in registers
// across the walk (that took 127 registers and a quarter of the SM's
// threads); four 256-thread blocks fit an SM. Planar tables, one array per
// field, cost a 32-byte sector per field of a passing pair and were
// slower. The sum is accumulated in registers in walk order: no atomics,
// so the output is bitwise repeatable.
//
// Bound at the main path's shapes (~690K queries, ~317K photons): the
// ranges table (32 B a query), the query and photon fields that the pairs
// need, and the [3, n_q] output, about 0.1 GB, so ~30 us at 3.35 TB/s; the
// ~0.9M passing pairs at ~80 FLOP are ~1 us of f32 work. It is bound by
// bytes (chip_smoke.py computes the bound from each run's tables). The
// walk alone runs near that bound; the passing pairs' row loads, issued
// after their tests, take most of the time (PERF.md).
//
// Tables (f32 unless noted): qpos [n_q, 4] and ppos [n_p, 4] (x, y, z,
// path length), qtab [n_q, 32], ptab [n_p, 16], ranges [8, n_q] int32
// (rows 0-3 first photon of each probed row, rows 4-7 one past its last).
// n_q and n_p are the static caps of the tables (ops/merge.py::merge_prep);
// the live query count, r^2 and the MIS weight are read from device
// memory, because they change every iteration and a CUDA graph replays
// the launch with the arguments it captured. Rows at or past the live
// count are dead and get 0. Output out [3, n_q]. Field layouts:
// ops/merge.py::merge_prep.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kQRow = 8;   // float4 per query row (32 fields)
constexpr int kPRow = 4;   // float4 per photon row (16 fields)
constexpr int kRows = 4;
constexpr float kEpsCosine = 1e-6f;
constexpr float kEpsPhong = 1e-3f;
// INV_PI_F of core/vecmath.py, rounded to f32 like the reference's float.
constexpr float kInvPi = (float)(1.0 / 3.14159265358979);
constexpr float kHalfInvPi = (float)(0.5 * (1.0 / 3.14159265358979));

__global__ void __launch_bounds__(kBlock, 4)
merge_cells_kernel(const float4* __restrict__ qpos,
                   const float4* __restrict__ qtab,
                   const int* __restrict__ ranges,
                   const float4* __restrict__ ppos,
                   const float4* __restrict__ ptab, float* __restrict__ out,
                   int n_q, const int* __restrict__ n_live,
                   const float* __restrict__ r2_p,
                   const float* __restrict__ vc_w_p, float max_pl,
                   float min_pl, int ppm) {
  const int qi = blockIdx.x * kBlock + threadIdx.x;
  if (qi >= n_q) return;
  if (qi >= __ldg(n_live)) {
    out[qi] = 0.f;
    out[n_q + qi] = 0.f;
    out[2 * n_q + qi] = 0.f;
    return;
  }
  const float r2 = __ldg(r2_p);
  const float vc_w = __ldg(vc_w_p);

  int lo[kRows], hi[kRows];
  int total = 0;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    lo[j] = __ldg(ranges + j * n_q + qi);
    hi[j] = __ldg(ranges + (kRows + j) * n_q + qi);
    total += hi[j] - lo[j];
  }

  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f;
  if (total > 0) {
    const float4 q = __ldg(qpos + qi);
    const float4* qrow = qtab + (size_t)qi * kQRow;

#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      for (int k = lo[j]; k < hi[j]; ++k) {
        // Exact r^2 prefilter + path-length window.
        const float4 p = __ldg(ppos + k);
        const float dx = q.x - p.x;
        const float dy = q.y - p.y;
        const float dz = q.z - p.z;
        const float dist2 = dx * dx + dy * dy + dz * dz;
        const float tlen = q.w + p.w;
        if (!(dist2 <= r2 && tlen <= max_pl && tlen >= min_pl)) continue;

        // The photon: in_dir, throughput, d_vcm, d_vm, cont (fields 3-11).
        const float4* prow = ptab + (size_t)k * kPRow;
        const float4 p0 = __ldg(prow), p1 = __ldg(prow + 1),
                     p2 = __ldg(prow + 2);
        // The query's BSDF frame and lobes (fields 3-27).
        const float4 q0 = __ldg(qrow), q1 = __ldg(qrow + 1),
                     q2 = __ldg(qrow + 2),
                     q3 = __ldg(qrow + 3), q4 = __ldg(qrow + 4),
                     q5 = __ldg(qrow + 5), q6 = __ldg(qrow + 6);

        // Camera BSDF toward light_dir = -photon.in_dir.
        const float ldx = -p0.w, ldy = -p1.x, ldz = -p1.y;
        const float lg_x = q0.w * ldx + q1.x * ldy + q1.y * ldz;
        const float lg_y = q1.z * ldx + q1.w * ldy + q2.x * ldz;
        const float lg_z = q2.y * ldx + q2.z * ldy + q2.w * ldz;
        const float ldf_z = q3.x;
        const bool same = lg_z * ldf_z >= 0.f;
        const float p_diff = q4.x, p_phong = q4.y;

        // Diffuse lobe.
        const bool ok_d = same && p_diff > 0.f && ldf_z >= kEpsCosine &&
                          lg_z >= kEpsCosine;
        const float okd_f = ok_d ? 1.f : 0.f;
        const float dd = p_diff * fmaxf(0.f, lg_z * kInvPi) * okd_f;
        const float rd = p_diff * fmaxf(0.f, ldf_z * kInvPi) * okd_f;

        // Phong lobe: one pow serves value and pdf.
        const float dotr = q3.y * lg_x + q3.z * lg_y + q3.w * lg_z;
        const float expo = q6.w;
        const bool ok_p = same && p_phong > 0.f && ldf_z >= kEpsCosine &&
                          lg_z >= kEpsCosine && dotr > kEpsPhong;
        const float lobe =
            ok_p ? expf(expo * logf(fmaxf(dotr, kEpsPhong))) : 0.f;
        const float pp = p_phong * (expo + 1.f) * lobe * kHalfInvPi;

        const float dir_pdf = (dd + pp) * q4.z;
        const float rev_pdf = (rd + pp) * p2.w;

        float mis = 1.f;
        if (!ppm) {
          const float w_light = p2.y * vc_w + p2.z * dir_pdf;
          const float w_camera = q4.w * vc_w + q5.x * rev_pdf;
          mis = 1.f / (w_light + 1.f + w_camera);
        }
        acc0 += (q5.y * okd_f + q6.x * lobe) * p1.z * mis;
        acc1 += (q5.z * okd_f + q6.y * lobe) * p1.w * mis;
        acc2 += (q5.w * okd_f + q6.z * lobe) * p2.x * mis;
      }
    }
  }
  out[qi] = acc0;
  out[n_q + qi] = acc1;
  out[2 * n_q + qi] = acc2;
}

}  // namespace

extern "C" int svcm_merge_cells(const float* qpos, const float* qtab,
                                const int* ranges, const float* ppos,
                                const float* ptab, float* out, int n_q,
                                const int* n_live, const float* r2,
                                const float* vc_weight,
                                int max_path_length, int min_path_length,
                                int ppm, void* stream) {
  if (n_q <= 0) return 0;
  const int grid = (n_q + kBlock - 1) / kBlock;
  const auto f4 = [](const float* a) {
    return reinterpret_cast<const float4*>(a);
  };
  merge_cells_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      f4(qpos), f4(qtab), ranges, f4(ppos), f4(ptab), out, n_q, n_live, r2,
      vc_weight, (float)max_path_length, (float)min_path_length, ppm);
  return (int)cudaGetLastError();
}
