// Counter-based uniforms of core/rng.py::uniform_slots in one launch.
//
// Replaces no TPU kernel: the JAX package draws its random numbers with
// XLA's fused integer ops (smallvcm_tpu/core/rng.py), and the port's plain
// version (core/rng.py::_uniform_slots_plain) runs the same arithmetic as
// some 180 int64 elementwise kernels a pair of slots. It was added because
// those kernels were ~40% (pt) and ~30% (VCM) of an iteration's launches.
// It computes the same bits: for each path id and pair of slots, the
// Threefry-2x32 block cipher (20 rounds) or the six-round TEA hash, keyed
// by (seed, stream) and counted by (path id, pair); each word's top 24
// bits times 2^-24 as float32, which is exact, so the floats equal the
// plain version's.
//
// Design: one thread a (path, pair of slots). The words stay uint32 in
// registers, every sum wraps as the plain version's mask does, the
// rotations are funnel shifts and the rounds are written out. A thread
// writes its two floats side by side in the [n, n_slots] row-major output
// (torch.stack(..., dim=-1)'s layout), so a warp's stores are contiguous;
// an odd n_slots drops the last pair's second word. The stream word is a
// value, or is read from device memory when a pointer is given: a CUDA
// graph replays the launch with the arguments it captured, so an iteration
// graph's stream (make_stream of its 0-dim iteration buffer) is read at
// replay and is not frozen into the capture.
//
// Bound: instruction issue or bytes. A thread is ~130 SASS instructions
// (chip_smoke.py phase 3 counts them with cuobjdump), so a 4-slot call
// over 262,144 paths is ~2.1 us at 4 warp instructions a clock an SM; it
// reads 2 MB of ids and writes 4 MB of floats, ~1.9 us at 3.35 TB/s. Work
// and bytes are spread evenly, 256 threads a block.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 256;
constexpr float kUnit = 1.0f / 16777216.0f;  // 2^-24

__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1, int r) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r);
  x1 ^= x0;
}

template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void four_rounds(uint32_t& x0, uint32_t& x1) {
  mix(x0, x1, R0);
  mix(x0, x1, R1);
  mix(x0, x1, R2);
  mix(x0, x1, R3);
}

// core/rng.py::threefry2x32: five blocks of four rounds, each followed by
// the key injection of its number.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t c0, uint32_t c1,
                                             uint32_t& w0, uint32_t& w1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = c0 + k0, x1 = c1 + k1;
  four_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k1;
  x1 += k2 + 1u;
  four_rounds<17, 29, 16, 24>(x0, x1);
  x0 += k2;
  x1 += k0 + 2u;
  four_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k0;
  x1 += k1 + 3u;
  four_rounds<17, 29, 16, 24>(x0, x1);
  x0 += k1;
  x1 += k2 + 4u;
  four_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k2;
  x1 += k0 + 5u;
  w0 = x0;
  w1 = x1;
}

// core/rng.py::tea6.
__device__ __forceinline__ void tea6(uint32_t k0, uint32_t k1, uint32_t c0,
                                     uint32_t c1, uint32_t& w0,
                                     uint32_t& w1) {
  uint32_t v0 = k0 + c0, v1 = k1 ^ c1, s = 0;
#pragma unroll
  for (int round = 0; round < 6; ++round) {
    s += 0x9E3779B9u;
    v0 += ((v1 << 4) + 0xA341316Cu) ^ (v1 + s) ^ ((v1 >> 5) + 0xC8013EA4u);
    v1 += ((v0 << 4) + 0xAD90777Du) ^ (v0 + s) ^ ((v0 >> 5) + 0x7E95761Eu);
  }
  w0 = v0;
  w1 = v1;
}

template <bool kTea>
__global__ void __launch_bounds__(kBlock)
    uniform_slots_kernel(float* __restrict__ out,
                         const long long* __restrict__ ids, int n,
                         int n_slots, int pairs, uint32_t seed,
                         uint32_t stream, const long long* stream_ptr) {
  // n * pairs <= n * n_slots < 2^31 (the wrapper's check).
  const unsigned int t = blockIdx.x * kBlock + threadIdx.x;
  if (t >= (unsigned int)n * (unsigned int)pairs) return;
  const int i = (int)(t / (unsigned int)pairs);
  const int p = (int)(t - (unsigned int)i * (unsigned int)pairs);
  const uint32_t k1 =
      stream_ptr != nullptr ? (uint32_t)__ldg(stream_ptr) : stream;
  const uint32_t c0 = (uint32_t)__ldg(ids + i);
  uint32_t w0, w1;
  if (kTea) {
    tea6(seed, k1, c0, (uint32_t)p, w0, w1);
  } else {
    threefry2x32(seed, k1, c0, (uint32_t)p, w0, w1);
  }
  const float u0 = __uint2float_rn(w0 >> 8) * kUnit;
  const float u1 = __uint2float_rn(w1 >> 8) * kUnit;
  float* o = out + (long long)i * n_slots + 2 * p;
  if ((n_slots & 1) == 0) {
    *reinterpret_cast<float2*>(o) = make_float2(u0, u1);
  } else {
    o[0] = u0;
    if (2 * p + 1 < n_slots) o[1] = u1;
  }
}

}  // namespace

// out [n, n_slots] f32; ids [n] int64 (each taken mod 2^32); seed the key's
// first word; the stream word is *stream_ptr mod 2^32 when stream_ptr is
// not NULL (a device int64), else stream; generator 0 Threefry, 1 TEA.
extern "C" int svcm_uniform_slots(float* out, const long long* ids, int n,
                                  int n_slots, unsigned int seed,
                                  unsigned int stream,
                                  const long long* stream_ptr, int generator,
                                  void* cuda_stream) {
  if (n_slots < 1 || (generator != 0 && generator != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n <= 0) return 0;
  const int pairs = (n_slots + 1) / 2;
  const long long threads = (long long)n * pairs;
  const unsigned int grid = (unsigned int)((threads + kBlock - 1) / kBlock);
  const cudaStream_t s = (cudaStream_t)cuda_stream;
  if (generator == 1) {
    uniform_slots_kernel<true><<<grid, kBlock, 0, s>>>(
        out, ids, n, n_slots, pairs, seed, stream, stream_ptr);
  } else {
    uniform_slots_kernel<false><<<grid, kBlock, 0, s>>>(
        out, ids, n, n_slots, pairs, seed, stream, stream_ptr);
  }
  return (int)cudaGetLastError();
}
