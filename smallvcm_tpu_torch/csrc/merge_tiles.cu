// Photon merge over cell-sorted query tiles and photon slabs.
//
// Replaces the TPU kernel smallvcm_tpu/ops/pallas_merge.py::_tile_kernel
// (pair math in _dense_block, driven by run_tile_kernel). It computes the
// same per-query RGB sums: for each tile of QTILE cell-sorted camera merge
// queries, every photon of the tile's <= 9 slab runs gets the exact r^2
// test and the path-length window, the camera BSDF (diffuse + Phong)
// toward -photon.in_dir with its direct/reverse pdfs times continuation
// probabilities, the MIS weight 1/(w_light + 1 + w_camera) (1 for ppm) and
// the photon throughput.
//
// Design: one 256-thread block per tile, one thread per query with its 32
// baked fields in registers. The block walks the tile's runs; each 16x128
// photon slab (8 KB) is staged in shared memory with coalesced loads and
// then read as broadcasts while every thread accumulates its query's RGB
// in registers. No atomics: the sum order is fixed, so the output is
// deterministic. The TPU kernel's DMA pipeline and cross-step hand-off are
// not carried over: blocks run in parallel here, and the ~8 resident
// blocks per SM hide each other's slab loads.
//
// Bound: the pair arithmetic (~70 FLOP plus an exp/log per pair that
// passes the r^2 test) over tiles x slabs x 256 x 128 pairs; each slab is
// read once per tile that lists it (8 KB per 32K pairs), far below the
// card's bandwidth, so the kernel is compute- and latency-bound.
//
// Tables: qtab [QF, query_cap] f32 (planar), runs [n_tiles, RUNCOLS] int32
// (col 0 = slab count, then (first slab, cumulative count) per run),
// ptab [PF, photon_cap] f32 (planar). Output out [3, query_cap] f32,
// zeros for tiles without work. Field layouts: ops/merge.py::merge_prep.

#include <cuda_runtime.h>

namespace {

constexpr int kQTile = 256;
constexpr int kSlab = 128;
constexpr int kQF = 32;
constexpr int kPF = 16;
constexpr int kRuns = 9;
constexpr int kRunCols = 1 + 2 * kRuns;
constexpr float kEpsCosine = 1e-6f;
constexpr float kEpsPhong = 1e-3f;
// INV_PI_F of core/vecmath.py, rounded to f32 like the reference's float.
constexpr float kInvPi = (float)(1.0 / 3.14159265358979);
constexpr float kHalfInvPi = (float)(0.5 * (1.0 / 3.14159265358979));

__global__ void __launch_bounds__(kQTile)
merge_tiles_kernel(const float* __restrict__ qtab,
                   const int* __restrict__ runs,
                   const float* __restrict__ ptab, float* __restrict__ out,
                   int query_cap, int photon_cap, float r2, float vc_w,
                   float max_pl, float min_pl, int ppm) {
  __shared__ float slab[kPF][kSlab];
  __shared__ int run_row[kRunCols];

  const int tile = blockIdx.x;
  const int t = threadIdx.x;
  const int qi = tile * kQTile + t;
  if (t < kRunCols) run_row[t] = runs[tile * kRunCols + t];
  __syncthreads();

  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f;
  const int total = run_row[0];
  if (total > 0) {
    float q[kQF];
#pragma unroll
    for (int f = 0; f < kQF; ++f) q[f] = qtab[f * query_cap + qi];

    int prev = 0;
    for (int j = 0; j < kRuns; ++j) {
      const int lo = run_row[1 + 2 * j];
      const int cum = run_row[2 + 2 * j];
      for (int k = prev; k < cum; ++k) {
        const int base = (lo + (k - prev)) * kSlab;
        __syncthreads();  // the previous slab is fully consumed
        for (int e = t; e < kPF * kSlab; e += kQTile) {
          const int f = e / kSlab, c = e % kSlab;
          slab[f][c] = ptab[f * photon_cap + base + c];
        }
        __syncthreads();

        for (int c = 0; c < kSlab; ++c) {
          // Exact r^2 prefilter + path-length window.
          const float dx = q[0] - slab[0][c];
          const float dy = q[1] - slab[1][c];
          const float dz = q[2] - slab[2][c];
          const float dist2 = dx * dx + dy * dy + dz * dz;
          const float tlen = q[28] + slab[12][c];
          if (!(dist2 <= r2 && tlen <= max_pl && tlen >= min_pl)) continue;

          // Camera BSDF toward light_dir = -photon.in_dir.
          const float ldx = -slab[3][c], ldy = -slab[4][c],
                      ldz = -slab[5][c];
          const float lg_x = q[3] * ldx + q[4] * ldy + q[5] * ldz;
          const float lg_y = q[6] * ldx + q[7] * ldy + q[8] * ldz;
          const float lg_z = q[9] * ldx + q[10] * ldy + q[11] * ldz;
          const float ldf_z = q[12];
          const bool same = lg_z * ldf_z >= 0.f;
          const float p_diff = q[16], p_phong = q[17];

          // Diffuse lobe.
          const bool ok_d = same && p_diff > 0.f && ldf_z >= kEpsCosine &&
                            lg_z >= kEpsCosine;
          const float okd_f = ok_d ? 1.f : 0.f;
          const float dd = p_diff * fmaxf(0.f, lg_z * kInvPi) * okd_f;
          const float rd = p_diff * fmaxf(0.f, ldf_z * kInvPi) * okd_f;

          // Phong lobe: one pow serves value and pdf.
          const float dotr = q[13] * lg_x + q[14] * lg_y + q[15] * lg_z;
          const float expo = q[27];
          const bool ok_p = same && p_phong > 0.f && ldf_z >= kEpsCosine &&
                            lg_z >= kEpsCosine && dotr > kEpsPhong;
          const float lobe =
              ok_p ? expf(expo * logf(fmaxf(dotr, kEpsPhong))) : 0.f;
          const float pp = p_phong * (expo + 1.f) * lobe * kHalfInvPi;

          const float dir_pdf = (dd + pp) * q[18];
          const float rev_pdf = (rd + pp) * slab[11][c];

          float mis = 1.f;
          if (!ppm) {
            const float w_light = slab[9][c] * vc_w + slab[10][c] * dir_pdf;
            const float w_camera = q[19] * vc_w + q[20] * rev_pdf;
            mis = 1.f / (w_light + 1.f + w_camera);
          }
          acc0 += (q[21] * okd_f + q[24] * lobe) * slab[6][c] * mis;
          acc1 += (q[22] * okd_f + q[25] * lobe) * slab[7][c] * mis;
          acc2 += (q[23] * okd_f + q[26] * lobe) * slab[8][c] * mis;
        }
      }
      prev = cum;
    }
  }
  out[0 * query_cap + qi] = acc0;
  out[1 * query_cap + qi] = acc1;
  out[2 * query_cap + qi] = acc2;
}

}  // namespace

extern "C" int svcm_merge_tiles(const float* qtab, const int* runs,
                                const float* ptab, float* out, int n_tiles,
                                int query_cap, int photon_cap, float r2,
                                float vc_weight, int max_path_length,
                                int min_path_length, int ppm, void* stream) {
  if (n_tiles <= 0) return 0;
  merge_tiles_kernel<<<n_tiles, kQTile, 0, (cudaStream_t)stream>>>(
      qtab, runs, ptab, out, query_cap, photon_cap, r2, vc_weight,
      (float)max_path_length, (float)min_path_length, ppm);
  return (int)cudaGetLastError();
}
