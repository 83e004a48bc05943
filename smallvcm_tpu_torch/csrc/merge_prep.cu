// The cell merge's preparation (ops/merge.py::merge_prep) on the card:
// the photon bbox and both sides' live counts, every live slot's int32
// cell key, a stable radix sort of each side's live slots by key, and the
// baked tables that merge_cells.cu walks (qpos, qtab, ranges, q_path;
// ppos, ptab), in 17 launches. Bit for bit the plain chain
// (ops/merge.py::merge_prep_plain) in every row at the caps, dead rows and
// the padding past the slot count included, NaN for NaN.
//
// Replaces no TPU kernel: the JAX package's preparation
// (smallvcm_tpu/ops/pallas_merge.py::merge_prep) is XLA code, and the
// port's plain version runs it as ~250 ATen kernels an iteration: a
// 16-plane stack of every vertex slot a side, int64 key chains over every
// slot, two stable sorts of int64 keys over every slot (8 radix passes
// each), the BSDF set-up over the caps, 16- and 32-column stacks and a
// searchsorted. That took ~4.4 ms of a 21.5 ms VCM iteration at 512x512
// (scene 0, an H100 at 700 W) against a ~0.45 ms walk, and grows with
// every rank's photon slots on four cards; it was added for that.
//
// Bound: bytes (chip_smoke.py's prep_bytes counts them): each slot's
// validity read twice (bbox, keys), a live photon's position twice and a
// live query's once, four radix passes that read and write an int32 key
// and slot over the live slots, a cap row's fields, material id and sorted
// slot read once (68 bytes), the baked rows written once (80 bytes a
// photon row, 184 a query row); the ranges' searches read an L2-resident
// key column. At the main path's shapes (2,359,296 photon and 2,621,440
// query slots, ~13% and ~26% of them live, caps of 327,680 photon and
// 786,432 query rows) that is ~0.34 GB, ~0.10 ms at 3.35 TB/s; with four
// ranks' photon slots (the all-gather's 9,437,184, cap 1,310,720) ~0.58
// GB, ~0.17 ms.
// Design:
// - bbox_partials: one block a tile of kTile slots of either side; the
//   live photons' min and max per axis (NaN-propagating, as torch.min; a
//   set's min and max are the same in any order) and the tile's live
//   count, folded in registers, shuffles and shared memory.
// - bbox_final: one block folds the tiles into the bbox, both live counts,
//   1 / (2 r) from the radius in device memory and the bbox padded by r,
//   and scans the tiles' live counts; all left in device memory: no host
//   read, so a CUDA graph holds it.
// - cell_keys: one int32 key a live slot (the f32 steps of _cells_of in
//   order, built with -fmad=false), written with the slot at the slot's
//   place among the side's live slots (ballots and the tile's scanned
//   base); a dead slot goes after them in slot order, where the plain
//   chain's stable sort puts it under the sentinel key. A live slot's
//   fields are also written as one 64-byte row (scratch), so that the
//   bake's gathers in cell order take two sectors a row and not one a
//   plane.
// - the sort (radix_count, radix_scan, radix_scatter, a pass of 8 bits
//   each, 4 passes for the keys' 29 bits): least significant digit first
//   over the live slots alone, their count read from device memory, so a
//   graph's static launches sort what is live (torch.sort would sort every
//   slot: it needs the length on the host; on an H100 at 700 W that took
//   the preparation 0.70 ms of a 512x512 scene-0 VCM iteration against
//   0.52, and the iteration 1.0% longer). Stable: a tile's keys are
//   ranked by digit in slot order (warp match masks, then the warps in
//   order), after the side's lower digits and the earlier tiles' keys of
//   the digit.
// - bake_photons, bake_queries: one thread a row of the cap, whose source
//   slot is the sorted slot at the row (the last one past the slot count,
//   as the plain chain pads); a live row's fields come from its packed
//   row, a dead row's from the vertex planes (in slot order), the BSDF
//   set-up runs in registers (bsdf_setup.cuh, the one copy shared with
//   bsdf.cu), the rows are written in 16-byte stores. A query row then
//   finds its <= 4 probed rows' photon ranges over the live photons'
//   sorted keys: a binary search for the first row's start, galloping
//   searches from the last bound after it (each probed row's keys lie
//   above the row before it). Neighbouring queries share cells, so a
//   warp's searches share cache lines.
// No atomics outside shared memory, no allocation (the wrapper allocates
// outputs and scratch), launched on the caller's stream, so a CUDA graph
// captures it as it is.

#include "bsdf_setup.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kItems = 8;
constexpr int kTile = kBlock * kItems;  // slots a block of the slot passes
constexpr int kGridXY = 1024;           // ops/merge.py's GRID_XY, GRID_Z
constexpr int kGridZ = 512;
constexpr int kKeySent = kGridZ * kGridXY * kGridXY;
constexpr int kRows = 4;     // probed (y, z) rows a query
constexpr int kFields = 14;  // pos3 | in_dir3 | normal3 | throughput3 |
                             // d_vcm | d_vm
constexpr int kRadixBits = 8;
constexpr int kBins = 1 << kRadixBits;
constexpr int kPasses = 4;  // the keys have 29 bits
static_assert(kBins == kBlock, "the sort takes a thread a digit");
static_assert(kPasses * kRadixBits >= 29 && kPasses % 2 == 0,
              "the passes cover the key and end in buffer 0");

// Device scalars (params): the photon bbox's min (0-2) and max (3-5),
// 1 / (2 r) (6), min - r (7-9) and max + r (10-12).
constexpr int kInvCell = 6, kLo = 7, kHi = 10;

// One side's [L, N] vertex planes, contiguous.
struct Side {
  const float* f[kFields];
  const long long* mat;
  const bool* valid;
  long long slots;  // L * N
  long long cols;   // N
};

// A block's fold of the slot pass (bbox_partials writes one a block).
struct Acc {
  float mn[3], mx[3];
  unsigned int n_p, n_q;
};

__device__ __forceinline__ float min_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// Dead photons stand at +-1e36, as the plain chain's torch.where does.
__device__ __forceinline__ Acc acc_empty() {
  Acc a;
  for (int c = 0; c < 3; ++c) {
    a.mn[c] = F(1e36);
    a.mx[c] = F(-1e36);
  }
  a.n_p = a.n_q = 0;
  return a;
}

__device__ __forceinline__ void fold(Acc& a, const Acc& b) {
  for (int c = 0; c < 3; ++c) {
    a.mn[c] = min_nan(a.mn[c], b.mn[c]);
    a.mx[c] = max_nan(a.mx[c], b.mx[c]);
  }
  a.n_p += b.n_p;
  a.n_q += b.n_q;
}

__device__ __forceinline__ Acc fold_warp(Acc a) {
  for (int o = 16; o > 0; o >>= 1) {
    Acc b;
    for (int c = 0; c < 3; ++c) {
      b.mn[c] = __shfl_down_sync(0xffffffffu, a.mn[c], o);
      b.mx[c] = __shfl_down_sync(0xffffffffu, a.mx[c], o);
    }
    b.n_p = __shfl_down_sync(0xffffffffu, a.n_p, o);
    b.n_q = __shfl_down_sync(0xffffffffu, a.n_q, o);
    fold(a, b);
  }
  return a;
}

// The block's fold (kBlock threads, all of them calling), in thread 0.
__device__ __forceinline__ Acc fold_block(Acc a) {
  __shared__ Acc warps[kBlock / 32];
  a = fold_warp(a);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warps[w] = a;
  __syncthreads();
  if (w == 0) {
    a = fold_warp(lane < kBlock / 32 ? warps[lane] : acc_empty());
  }
  return a;
}

// Exclusive scan by the block (kBlock threads, all of them calling) of
// in(0) .. in(len - 1) in chunks of kBlock: out(j, the sum of in(0) ..
// in(j - 1)) for each j -> the total.
template <typename In, typename Out>
__device__ __forceinline__ unsigned int block_scan(int len, In in, Out out) {
  __shared__ unsigned int sums[kBlock / 32];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned int carry = 0;
  for (int c0 = 0; c0 < len; c0 += kBlock) {
    const int j = c0 + threadIdx.x;
    const unsigned int v = j < len ? in(j) : 0u;
    unsigned int x = v;
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) sums[w] = x;
    __syncthreads();
    unsigned int before = 0, total = 0;
    for (int k = 0; k < kBlock / 32; ++k) {
      before += k < w ? sums[k] : 0u;
      total += sums[k];
    }
    if (j < len) out(j, carry + before + x - v);
    carry += total;
    __syncthreads();
  }
  return carry;
}

__global__ void __launch_bounds__(kBlock)
    bbox_partials(const __grid_constant__ Side p,
                  const __grid_constant__ Side q, int nbp,
                  Acc* __restrict__ out) {
  const bool photons = blockIdx.x < nbp;
  const bool* valid = photons ? p.valid : q.valid;
  const long long slots = photons ? p.slots : q.slots;
  const long long base =
      (long long)(photons ? blockIdx.x : blockIdx.x - nbp) * kTile;
  Acc a = acc_empty();
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + k * kBlock + threadIdx.x;
    if (i >= slots || !valid[i]) continue;
    if (!photons) {
      ++a.n_q;
      continue;
    }
    ++a.n_p;
    for (int c = 0; c < 3; ++c) {
      const float v = p.f[c][i];
      a.mn[c] = min_nan(a.mn[c], v);
      a.mx[c] = max_nan(a.mx[c], v);
    }
  }
  a = fold_block(a);
  if (threadIdx.x == 0) out[blockIdx.x] = a;
}

__global__ void __launch_bounds__(kBlock)
    bbox_final(const Acc* __restrict__ parts, int nb,
               const float* __restrict__ radius,
               unsigned int* __restrict__ live_base, float* __restrict__ prm,
               long long* __restrict__ n_p, long long* __restrict__ n_q) {
  // The live slots before each block's tile (the photons' first).
  block_scan(
      nb, [&](int j) { return parts[j].n_p + parts[j].n_q; },
      [&](int j, unsigned int before) { live_base[j] = before; });
  Acc a = acc_empty();
  for (int b = threadIdx.x; b < nb; b += kBlock) fold(a, parts[b]);
  a = fold_block(a);
  if (threadIdx.x != 0) return;
  const float r = *radius;
  for (int c = 0; c < 3; ++c) {
    prm[c] = a.mn[c];
    prm[3 + c] = a.mx[c];
    prm[kLo + c] = a.mn[c] - r;
    prm[kHi + c] = a.mx[c] + r;
  }
  // torch.reciprocal(radius * 2.0): the doubling exact, the division
  // correctly rounded.
  prm[kInvCell] = 1.0f / (r * 2.0f);
  *n_p = a.n_p;
  *n_q = a.n_q;
}

// floor(rel).long().clamp(0, n - 1), NaN -> 0 as the cast then clamp give.
__device__ __forceinline__ int clamp_cell(float rel, int n) {
  const float f = floorf(rel);
  return f >= (float)n ? n - 1 : (f > 0.0f ? (int)f : 0);
}

// _cells_of of a live point: clamped cell coordinates and the side of the
// cell centre it lies on, per axis.
struct Cells {
  int c[3], side[3];
};

__device__ __forceinline__ Cells cells_of(float x, float y, float z,
                                          const float* __restrict__ prm) {
  const float a[3] = {x, y, z};
  Cells o;
  for (int k = 0; k < 3; ++k) {
    const float rel = (a[k] - prm[k]) * prm[kInvCell];
    o.c[k] = clamp_cell(rel, k == 2 ? kGridZ : kGridXY);
    o.side[k] = rel - floorf(rel) < 0.5f ? -1 : 1;
  }
  return o;
}

// The stable radix sort of each side's live slots by key: key[side][buf]
// and idx[side][buf] (side 0 photons, 1 queries) in two buffers that the
// passes alternate between; cell_keys fills buffer 0, where the last pass
// leaves the sorted order, with each side's live slots in slot order and
// then its dead slots in slot order, which the passes leave in place.
struct Sort {
  int* key[2][2];
  int* idx[2][2];
  const long long* n[2];  // live slots a side
  unsigned int* counts;   // [kBins, tiles]: each tile's digit counts
  unsigned int* totals;   // [2, kBins]: each side's digit totals
  int tiles_p, tiles;     // tiles of kTile slots: the photons', all
};

// A block's tile: its side, and the first of the side's kTile slots (the
// slot passes) or live slots (the sort passes) it takes.
__device__ __forceinline__ int tile_side(const Sort& so) {
  return blockIdx.x >= so.tiles_p;
}

__device__ __forceinline__ long long tile_first(const Sort& so, int side) {
  return (long long)(side ? blockIdx.x - so.tiles_p : blockIdx.x) * kTile;
}

__global__ void __launch_bounds__(kBlock)
    cell_keys(const __grid_constant__ Side p, const __grid_constant__ Side q,
              const __grid_constant__ Sort so, const float* __restrict__ prm,
              const unsigned int* __restrict__ live_base,
              float4* __restrict__ ppack, float4* __restrict__ qpack) {
  __shared__ unsigned int warp_live[kBlock / 32];
  const int side = tile_side(so);
  const Side& s = side ? q : p;
  float4* pack = side ? qpack : ppack;
  int* key = so.key[side][0];
  int* idx = so.idx[side][0];
  const long long n_live = *so.n[side];
  // The side's live slots before the next slot of the tile.
  long long before = live_base[blockIdx.x] - (side ? *so.n[0] : 0);
  const long long base = tile_first(so, side);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + k * kBlock + threadIdx.x;
    const bool in = i < s.slots;
    const bool live = in && s.valid[i];
    int v = 0;
    if (live) {
      float f[kFields];
      for (int j = 0; j < kFields; ++j) f[j] = s.f[j][i];
      const Cells c = cells_of(f[0], f[1], f[2], prm);
      v = (c.c[2] * kGridXY + c.c[1]) * kGridXY + c.c[0];
      // The live slot's fields as one 64-byte row, which the bake gathers
      // in cell order (two sectors where the planes take fifteen).
      float4* row = pack + 4 * i;
      row[0] = make_float4(f[0], f[1], f[2], f[3]);
      row[1] = make_float4(f[4], f[5], f[6], f[7]);
      row[2] = make_float4(f[8], f[9], f[10], f[11]);
      row[3] = make_float4(f[12], f[13], __int_as_float((int)s.mat[i]),
                           0.0f);
    }
    const unsigned int ballot = __ballot_sync(0xffffffffu, live);
    if (lane == 0) warp_live[w] = __popc(ballot);
    __syncthreads();
    unsigned int in_warps = 0, total = 0;
    for (int j = 0; j < kBlock / 32; ++j) {
      in_warps += j < w ? warp_live[j] : 0u;
      total += warp_live[j];
    }
    __syncthreads();
    const long long at =
        before + in_warps + __popc(ballot & ((1u << lane) - 1));
    if (live) {
      key[at] = v;
      idx[at] = (int)i;
    } else if (in) {
      idx[n_live + (i - at)] = (int)i;
    }
    before += total;
  }
}

// Pass `pass`: each tile's counts of its keys' digit.
__global__ void __launch_bounds__(kBlock)
    radix_count(const __grid_constant__ Sort so, int pass) {
  __shared__ unsigned int hist[kBins];
  const int side = tile_side(so);
  const long long n = *so.n[side], first = tile_first(so, side);
  if (first >= n) return;
  hist[threadIdx.x] = 0;
  __syncthreads();
  const int* key = so.key[side][pass & 1];
  const int shift = kRadixBits * pass;
  for (int k = 0; k < kItems; ++k) {
    const long long e = first + k * kBlock + threadIdx.x;
    if (e < n) atomicAdd(&hist[(key[e] >> shift) & (kBins - 1)], 1u);
  }
  __syncthreads();
  so.counts[(long long)threadIdx.x * so.tiles + blockIdx.x] =
      hist[threadIdx.x];
}

// Each (side, digit)'s tile counts scanned in place into the tile's first
// position among the side's keys of that digit, and the digit's total.
__global__ void __launch_bounds__(kBlock)
    radix_scan(const __grid_constant__ Sort so) {
  const int side = blockIdx.x / kBins, d = blockIdx.x % kBins;
  const int tiles = (int)((*so.n[side] + kTile - 1) / kTile);
  unsigned int* row =
      so.counts + (long long)d * so.tiles + (side ? so.tiles_p : 0);
  const unsigned int total = block_scan(
      tiles, [&](int j) { return row[j]; },
      [&](int j, unsigned int before) { row[j] = before; });
  if (threadIdx.x == 0) so.totals[side * kBins + d] = total;
}

// Pass `pass`: each tile's keys and slots to their places in the other
// buffer, stably. Warp w takes the tile's slots [w, w + 1) * 32 * kItems,
// 32 at a step, so a key's rank among the warp's earlier keys of its
// digit, then the earlier warps', keeps slot order within the digit.
__global__ void __launch_bounds__(kBlock)
    radix_scatter(const __grid_constant__ Sort so, int pass) {
  __shared__ unsigned int seen[kBlock / 32][kBins];
  __shared__ unsigned int start[kBins];
  const int side = tile_side(so);
  const long long n = *so.n[side], first = tile_first(so, side);
  if (first >= n) return;
  for (int k = threadIdx.x; k < (kBlock / 32) * kBins; k += kBlock) {
    (&seen[0][0])[k] = 0;
  }
  __syncthreads();
  const int* key_in = so.key[side][pass & 1];
  const int* idx_in = so.idx[side][pass & 1];
  int* key_out = so.key[side][(pass + 1) & 1];
  int* idx_out = so.idx[side][(pass + 1) & 1];
  const int shift = kRadixBits * pass;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int key[kItems], idx[kItems], dig[kItems];
  unsigned int rank[kItems];
  for (int k = 0; k < kItems; ++k) {
    const long long e = first + (w * kItems + k) * 32 + lane;
    const bool ok = e < n;
    key[k] = ok ? key_in[e] : 0;
    idx[k] = ok ? idx_in[e] : 0;
    dig[k] = ok ? (key[k] >> shift) & (kBins - 1) : kBins;
    const unsigned int peers = __match_any_sync(0xffffffffu, dig[k]);
    const unsigned int earlier = ok ? seen[w][dig[k]] : 0u;
    __syncwarp();
    if (ok && lane == __ffs(peers) - 1) {
      seen[w][dig[k]] = earlier + __popc(peers);
    }
    __syncwarp();
    rank[k] = earlier + __popc(peers & ((1u << lane) - 1));
  }
  __syncthreads();
  // A thread a digit: the warps' first places within the tile's keys of
  // the digit, and the tile's first place: the side's keys of lower
  // digits, then the earlier tiles' keys of this digit.
  {
    unsigned int run = 0;
    for (int j = 0; j < kBlock / 32; ++j) {
      const unsigned int c = seen[j][threadIdx.x];
      seen[j][threadIdx.x] = run;
      run += c;
    }
  }
  block_scan(
      kBins, [&](int j) { return so.totals[side * kBins + j]; },
      [&](int j, unsigned int lower) {
        start[j] = lower + so.counts[(long long)j * so.tiles + blockIdx.x];
      });
  __syncthreads();
  for (int k = 0; k < kItems; ++k) {
    if (dig[k] == kBins) continue;
    const unsigned int at = start[dig[k]] + seen[w][dig[k]] + rank[k];
    key_out[at] = key[k];
    idx_out[at] = idx[k];
  }
}

// What the bake kernels read and write. Rows past the slot count take the
// last sorted slot. pkey holds the live photons' keys in sorted order, and
// nothing past them.
struct Bake {
  Side p, q;
  const float4* ppack;    // cell_keys' rows of the live slots
  const float4* qpack;
  const int* pidx;        // the sort's slot at each sorted position
  const int* qidx;
  const int* pkey;        // the photons' sorted keys (the live ones')
  int pcap, qcap;
  float* ppos;            // [pcap, 4]
  float* ptab;            // [pcap, 16]
  float* qpos;            // [qcap, 4]
  float* qtab;            // [qcap, 32]
  int* ranges;            // [2 * kRows, qcap]
  long long* q_path;      // [qcap]
  long long n_paths;
  Plane mat[kMatPlanes];
  int m;
  const float* prm;
  const long long* n_p;
  const long long* n_q;
};

__device__ __forceinline__ long long source_slot(const int* idx,
                                                 long long slots, int r) {
  return idx[min((long long)r, slots - 1)];
}

// Slot s's fields and material id (through int32, as the plain chain's f32
// plane carries it): a live row's from its packed row, a dead one's from
// the planes, where the dead rows' slots lie in ascending order.
__device__ __forceinline__ int gather(const Side& side,
                                      const float4* __restrict__ pack,
                                      long long s, bool live, float* f) {
  if (!live) {
    for (int k = 0; k < kFields; ++k) f[k] = side.f[k][s];
    return (int)side.mat[s];
  }
  const float4* row = pack + 4 * s;
  const float4 a = __ldg(row), b = __ldg(row + 1), c = __ldg(row + 2),
               d = __ldg(row + 3);
  const float v[16] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w,
                       c.x, c.y, c.z, c.w, d.x, d.y, d.z, d.w};
  for (int k = 0; k < kFields; ++k) f[k] = v[k];
  return __float_as_int(d.z);
}

__global__ void __launch_bounds__(kBlock)
    bake_photons(const __grid_constant__ Bake b) {
  extern __shared__ float smat[];
  load_materials(smat, b.mat, b.m);
  const int r = blockIdx.x * kBlock + threadIdx.x;
  if (r >= b.pcap) return;
  const long long s = source_slot(b.pidx, b.p.slots, r);
  float f[kFields];
  const int id = gather(b.p, b.ppack, s, r < *b.n_p, f);
  const State st = setup_lane(smat, b.m, mk(f[3], f[4], f[5]),
                              mk(f[6], f[7], f[8]), id, true);
  const float len = (float)(s / b.p.cols + 1);
  reinterpret_cast<float4*>(b.ppos)[r] = make_float4(f[0], f[1], f[2], len);
  float4* row = reinterpret_cast<float4*>(b.ptab) + 4LL * r;
  row[0] = make_float4(f[0], f[1], f[2], f[3]);
  row[1] = make_float4(f[4], f[5], f[9], f[10]);
  row[2] = make_float4(f[11], f[12], f[13], st.cont);
  row[3] = make_float4(len, 0.0f, 0.0f, 0.0f);
}

// The first of keys [lo, hi) that is >= v (hi if none).
__device__ __forceinline__ int lower_bound(const int* __restrict__ keys,
                                           int lo, int hi, int v) {
  while (lo < hi) {
    const int mid = (int)(((unsigned int)lo + (unsigned int)hi) >> 1);
    if (__ldg(keys + mid) < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The first of keys [lo, n) that is >= v, where every key before lo is
// < v: probes at doubling steps, then a binary search.
__device__ __forceinline__ int gallop(const int* __restrict__ keys, int lo,
                                      int n, int v) {
  long long probe = lo;
  long long step = 1;
  while (probe < n && __ldg(keys + probe) < v) {
    lo = (int)probe + 1;
    probe = lo + step;
    step <<= 1;
  }
  return lower_bound(keys, lo, (int)min(probe, (long long)n), v);
}

__global__ void __launch_bounds__(kBlock)
    bake_queries(const __grid_constant__ Bake b) {
  extern __shared__ float smat[];
  load_materials(smat, b.mat, b.m);
  const int r = blockIdx.x * kBlock + threadIdx.x;
  if (r >= b.qcap) return;
  const long long s = source_slot(b.qidx, b.q.slots, r);
  const bool live = r < *b.n_q;
  float f[kFields];
  const long long id = gather(b.q, b.qpack, s, live, f);
  const float* prm = b.prm;
  // Bbox rejection padded by the radius; dead rows are outside too.
  const bool in_bbox = live & (f[0] >= prm[kLo]) & (f[0] <= prm[kHi]) &
                       (f[1] >= prm[kLo + 1]) & (f[1] <= prm[kHi + 1]) &
                       (f[2] >= prm[kLo + 2]) & (f[2] <= prm[kHi + 2]);
  const State st = setup_lane(smat, b.m, mk(f[3], f[4], f[5]),
                              mk(f[6], f[7], f[8]), id, true);
  const Material mt = material(smat, b.m, id);
  const float rho_s = (mt.exponent + 2.0f) * F(0.5 * kInvPi);
  const float len = (float)(s / b.q.cols + 1);
  const float px = in_bbox ? f[0] : F(3e18);
  const float py = in_bbox ? f[1] : F(3e18);
  const float pz = in_bbox ? f[2] : F(3e18);
  const Frame& fr = st.frame;
  reinterpret_cast<float4*>(b.qpos)[r] = make_float4(px, py, pz, len);
  float4* row = reinterpret_cast<float4*>(b.qtab) + 8LL * r;
  row[0] = make_float4(px, py, pz, fr.x.x);
  row[1] = make_float4(fr.x.y, fr.x.z, fr.y.x, fr.y.y);
  row[2] = make_float4(fr.y.z, fr.z.x, fr.z.y, fr.z.z);
  row[3] = make_float4(st.fix.z, -st.fix.x, -st.fix.y, st.fix.z);
  row[4] = make_float4(st.valid ? st.p_diff : 0.0f,
                       st.valid ? st.p_phong : 0.0f, st.cont, f[12]);
  row[5] = make_float4(f[13], mt.diffuse.x * F(kInvPi),
                       mt.diffuse.y * F(kInvPi), mt.diffuse.z * F(kInvPi));
  row[6] = make_float4(mt.phong.x * rho_s, mt.phong.y * rho_s,
                       mt.phong.z * rho_s, mt.exponent);
  row[7] = make_float4(len, f[9], f[10], f[11]);
  b.q_path[r] = live ? s % b.q.cols : b.n_paths;

  // The photon ranges of the probed (y, z) rows: [first, one past last] of
  // the sorted photons in the row's one or two probed x cells; empty
  // (0, 0) for a row off the grid and for a query outside the bbox.
  int out[2 * kRows] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (in_bbox) {
    const Cells c = cells_of(f[0], f[1], f[2], prm);
    int lo[3], hi[3];
    for (int k = 0; k < 3; ++k) {
      const int last = (k == 2 ? kGridZ : kGridXY) - 1;
      lo[k] = max(c.c[k] + min(c.side[k], 0), 0);
      hi[k] = min(c.c[k] + max(c.side[k], 0), last);
    }
    const int n = (int)min(*b.n_p, (long long)b.pcap);
    int base = -1;
    for (int dz = 0; dz < 2; ++dz) {
      for (int dy = 0; dy < 2; ++dy) {
        if (lo[2] + dz > hi[2] || lo[1] + dy > hi[1]) continue;
        const int row_key =
            ((lo[2] + dz) * kGridXY + (lo[1] + dy)) * kGridXY;
        const int first =
            base < 0 ? lower_bound(b.pkey, 0, n, row_key + lo[0])
                     : gallop(b.pkey, base, n, row_key + lo[0]);
        base = gallop(b.pkey, first, n, row_key + hi[0] + 1);
        out[2 * dz + dy] = first;
        out[kRows + 2 * dz + dy] = base;
      }
    }
  }
  for (int k = 0; k < 2 * kRows; ++k) {
    b.ranges[(long long)k * b.qcap + r] = out[k];
  }
}

Side side_of(const long long* planes, long long slots, long long cols) {
  Side s;
  for (int k = 0; k < kFields; ++k) {
    s.f[k] = reinterpret_cast<const float*>(planes[k]);
  }
  s.mat = reinterpret_cast<const long long*>(planes[kFields]);
  s.valid = reinterpret_cast<const bool*>(planes[kFields + 1]);
  s.slots = slots;
  s.cols = cols;
  return s;
}

int blocks(long long n, int per) { return (int)((n + per - 1) / per); }

}  // namespace

// The slot passes and the sort. photon, query: each side's 16 plane
// pointers (position x, y, z, in_dir, normal, throughput, d_vcm, d_vm as
// float32, mat_id int64, valid bool), [slots] each; radius: a float32
// device scalar. Scratch: parts (an Acc, 32 bytes, a tile of kTile slots),
// live_base (a uint32 a tile), sort (8 pointers: photon key and slot
// buffers 0 and 1, then the queries'; int32 [slots] each), counts (uint32
// [kBins, tiles]), totals (uint32 [2, kBins]), ppack and qpack (float32
// [slots, 16]: each live slot's fields, a dead slot's row left
// unwritten). Writes prm (16 float32), the live counts n_p and n_q (int64)
// and in sort's buffers 0 each side's slots in key order, live first, and
// the live slots' keys.
extern "C" int svcm_merge_sort(const long long* photon, long long p_slots,
                               const long long* query, long long q_slots,
                               const void* radius, void* parts,
                               void* live_base, void* const* sort,
                               void* counts, void* totals, void* ppack,
                               void* qpack, void* prm, void* n_p, void* n_q,
                               void* cuda_stream) {
  if (p_slots < 1 || q_slots < 1) return (int)cudaErrorInvalidValue;
  const Side p = side_of(photon, p_slots, 1), q = side_of(query, q_slots, 1);
  const int nbp = blocks(p_slots, kTile), nb = nbp + blocks(q_slots, kTile);
  Sort so;
  for (int side = 0; side < 2; ++side) {
    for (int buf = 0; buf < 2; ++buf) {
      so.key[side][buf] = static_cast<int*>(sort[4 * side + 2 * buf]);
      so.idx[side][buf] = static_cast<int*>(sort[4 * side + 2 * buf + 1]);
    }
  }
  so.n[0] = static_cast<const long long*>(n_p);
  so.n[1] = static_cast<const long long*>(n_q);
  so.counts = static_cast<unsigned int*>(counts);
  so.totals = static_cast<unsigned int*>(totals);
  so.tiles_p = nbp;
  so.tiles = nb;
  const cudaStream_t st = (cudaStream_t)cuda_stream;
  Acc* acc = static_cast<Acc*>(parts);
  unsigned int* base = static_cast<unsigned int*>(live_base);
  float* params = static_cast<float*>(prm);
  bbox_partials<<<nb, kBlock, 0, st>>>(p, q, nbp, acc);
  int err = (int)cudaGetLastError();
  if (err) return err;
  bbox_final<<<1, kBlock, 0, st>>>(
      acc, nb, static_cast<const float*>(radius), base, params,
      static_cast<long long*>(n_p), static_cast<long long*>(n_q));
  err = (int)cudaGetLastError();
  if (err) return err;
  cell_keys<<<nb, kBlock, 0, st>>>(p, q, so, params, base,
                                   static_cast<float4*>(ppack),
                                   static_cast<float4*>(qpack));
  err = (int)cudaGetLastError();
  for (int pass = 0; pass < kPasses && !err; ++pass) {
    radix_count<<<nb, kBlock, 0, st>>>(so, pass);
    err = (int)cudaGetLastError();
    if (err) return err;
    radix_scan<<<2 * kBins, kBlock, 0, st>>>(so);
    err = (int)cudaGetLastError();
    if (err) return err;
    radix_scatter<<<nb, kBlock, 0, st>>>(so, pass);
    err = (int)cudaGetLastError();
  }
  return err;
}

// The bake. photon, query: the 16 plane pointers as above; p_cols, q_cols:
// each side's columns N (a row's path length is slot / N + 1, a query's
// path slot % N); ppack, qpack, prm, n_p, n_q: what svcm_merge_sort
// wrote; pidx, qidx: each side's sorted slots, pkey the photons' sorted
// keys (its sort buffers 0); the outputs at the caps pcap and qcap,
// contiguous; mats: 11 pairs (pointer, stride) of the material planes, m
// rows each.
extern "C" int svcm_merge_bake(
    const long long* photon, long long p_slots, long long p_cols,
    const void* ppack, const void* pidx, const void* pkey, int pcap,
    void* ppos, void* ptab, const long long* query, long long q_slots,
    long long q_cols, const void* qpack, const void* qidx, int qcap,
    void* qpos, void* qtab, void* ranges, void* q_path, long long n_paths,
    const long long* mats, int m, const void* prm, const void* n_p,
    const void* n_q, void* cuda_stream) {
  if (p_slots < 1 || q_slots < 1 || p_cols < 1 || q_cols < 1 || pcap < 0 ||
      qcap < 0 || m < 1 || m > kMaxMaterials) {
    return (int)cudaErrorInvalidValue;
  }
  Bake b;
  b.p = side_of(photon, p_slots, p_cols);
  b.q = side_of(query, q_slots, q_cols);
  b.ppack = static_cast<const float4*>(ppack);
  b.qpack = static_cast<const float4*>(qpack);
  b.pidx = static_cast<const int*>(pidx);
  b.qidx = static_cast<const int*>(qidx);
  b.pkey = static_cast<const int*>(pkey);
  b.pcap = pcap;
  b.qcap = qcap;
  b.ppos = static_cast<float*>(ppos);
  b.ptab = static_cast<float*>(ptab);
  b.qpos = static_cast<float*>(qpos);
  b.qtab = static_cast<float*>(qtab);
  b.ranges = static_cast<int*>(ranges);
  b.q_path = static_cast<long long*>(q_path);
  b.n_paths = n_paths;
  for (int k = 0; k < kMatPlanes; ++k) {
    b.mat[k].p = reinterpret_cast<const void*>(mats[2 * k]);
    b.mat[k].rs = 0;
    b.mat[k].cs = mats[2 * k + 1];
  }
  b.m = m;
  b.prm = static_cast<const float*>(prm);
  b.n_p = static_cast<const long long*>(n_p);
  b.n_q = static_cast<const long long*>(n_q);
  const cudaStream_t st = (cudaStream_t)cuda_stream;
  const size_t smem = sizeof(float) * kMatPlanes * m;
  if (pcap > 0) {
    bake_photons<<<blocks(pcap, kBlock), kBlock, smem, st>>>(b);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  if (qcap > 0) bake_queries<<<blocks(qcap, kBlock), kBlock, smem, st>>>(b);
  return (int)cudaGetLastError();
}
