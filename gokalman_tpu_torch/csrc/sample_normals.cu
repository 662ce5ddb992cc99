// K2: hand-written Hopper (sm_90a) kernel that draws normals with the
// fused Monte-Carlo kernel's generators.  Plain C interface, bound with
// ctypes (gokalman_tpu_torch/ops/_build.py); its plain PyTorch version is
// gokalman_tpu_torch/ops/fused_mc.py:sample_normals_ref.
//
// sample_normals_kernel replaces gokalman_tpu/ops/pallas_mc.py:
//    sample_normals_pallas (:139-174).  Normals 4i..4i+3 come from the
//    Philox counter (i, 0, 0, 0) under the seed's key: the same draws as
//    K1's first initial-state group of member i, so K2's statistics are
//    K1's generator's.  "box_muller" maps words (0, 1) and (2, 3) to two
//    Box-Muller pairs, "clt" each word to one popcount-CLT normal
//    (philox.cuh).
//
//    What bounds it, at 2^28 draws (1 GiB of float32), on an H100 SXM:
//    - bytes: 1 GiB written at 3.35 TB/s is 0.320 ms.  K2 reads nothing.
//      Each group of four draws is one 16-byte streaming store (__stcs of
//      a float4): neighbouring threads write neighbouring groups, whole
//      32-byte sectors, and the evict-first hint keeps an output far
//      larger than the 50 MB L2 from flushing it.  The ragged tail
//      (count % 4) is one guarded path in one thread.
//    - instruction issue: a group costs one Philox4x32-10 call (ten
//      rounds of two wide multiplies and two 3-way XORs) and, with
//      Box-Muller, two pairs of logf, sqrt.approx and the sincos
//      polynomials: the draw loop is ~167 SASS instructions a group
//      (chip_smoke.py [sass]), ~0.33 ms at 2^28 over 132 SMs x 4
//      schedulers at 1.98 GHz, so Box-Muller is issue-bound.  The CLT map
//      takes ~80 a group and meets the bytes bound.  So the grid is
//      persistent (the occupancy API's blocks per SM times the SM count,
//      computed once at load by sample_normals_init): the index set-up
//      runs once a thread, and every iteration draws UNROLL independent
//      counters, so the dependent multiply chains of their ten rounds
//      interleave (two did better than one, four or eight on the card,
//      where ptxas keeps every choice at <= 32 registers and full
//      occupancy).  The logarithm stays `logf` (philox.cuh:box_muller).
//    At 524,288 draws the work is ~1 us of device time and the launch
//    path dominates, so the round keys are built here from the 64-bit
//    seed rather than by the caller.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 2;  // independent counters per thread and iteration

// The four normals of one Philox output, in the plain version's order.
template <bool FAST>
__device__ __forceinline__ float4 normals4(uint4 w) {
  float4 z;
  if constexpr (FAST) {
    z = make_float4(clt_normal(w.x), clt_normal(w.y), clt_normal(w.z),
                    clt_normal(w.w));
  } else {
    box_muller(w.x, w.y, z.x, z.y);
    box_muller(w.z, w.w, z.z, z.w);
  }
  return z;
}

__device__ __forceinline__ uint4 group_words(long long i, const KeySchedule& ks) {
  return philox4x32_10(make_uint4(static_cast<uint32_t>(i), 0u, 0u, 0u), ks);
}

// `groups` = count / 4 whole groups as float4s, then `tail` = count % 4
// draws of group `groups`.  `out` is 16-byte aligned.
template <bool FAST>
__global__ void __launch_bounds__(THREADS)
sample_normals_kernel(float* __restrict__ out, long long groups, int tail,
                      const __grid_constant__ KeySchedule keys) {
  float4* out4 = reinterpret_cast<float4*>(out);
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  for (; i + (UNROLL - 1) * stride < groups; i += UNROLL * stride) {
    uint4 w[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) w[u] = group_words(i + u * stride, keys);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) __stcs(out4 + i + u * stride, normals4<FAST>(w[u]));
  }
  for (; i < groups; i += stride) __stcs(out4 + i, normals4<FAST>(group_words(i, keys)));
  if (tail > 0 && blockIdx.x == 0 && threadIdx.x == 0) {
    const float4 z = normals4<FAST>(group_words(groups, keys));
    float* t = out + 4 * groups;
    t[0] = z.x;
    if (tail > 1) t[1] = z.y;
    if (tail > 2) t[2] = z.z;
  }
}

// Persistent grid per generator (index FAST), set by sample_normals_init.
int g_grid[2] = {0, 0};

template <bool FAST>
cudaError_t persistent_grid(int sms, int* grid) {
  int per_sm = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, sample_normals_kernel<FAST>, THREADS, 0);
  *grid = per_sm * sms;
  return e;
}

}  // namespace

// Computes each generator's persistent grid on the current device: the
// blocks the occupancy API fits on one SM times the SM count.  Called
// once, when the library is loaded.
extern "C" int sample_normals_init() {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = persistent_grid<false>(sms, &g_grid[0]);
  if (e == cudaSuccess) e = persistent_grid<true>(sms, &g_grid[1]);
  return static_cast<int>(e);
}

extern "C" int sample_normals_grid(int fast_rng) { return g_grid[fast_rng != 0]; }

extern "C" int sample_normals_threads() { return THREADS; }

// The 20 round keys of `seed` into `out` (uint32 [2 * 10]), as the launch
// builds them; checked against ops/philox.py:key_schedule.
extern "C" void philox_key_schedule(uint64_t seed, uint32_t* out) {
  const KeySchedule ks = key_schedule(seed);
  for (int i = 0; i < 2 * PHILOX_ROUNDS; ++i) out[i] = ks.k[i];
}

// `count` normals into `out` (16-byte aligned) on `stream`.  The grid is
// the persistent one, cut to the blocks that have a group to draw.
extern "C" int sample_normals_launch(float* out, long long count, uint64_t seed,
                                     int fast_rng, void* stream) {
  const long long groups = count / 4;
  const int tail = static_cast<int>(count % 4);
  const long long need = (groups + THREADS - 1) / THREADS;
  const int full = g_grid[fast_rng != 0];
  const dim3 grid(static_cast<unsigned>(need < full ? (need > 0 ? need : 1) : full));
  const KeySchedule keys = key_schedule(seed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fast_rng) {
    sample_normals_kernel<true><<<grid, THREADS, 0, s>>>(out, groups, tail, keys);
  } else {
    sample_normals_kernel<false><<<grid, THREADS, 0, s>>>(out, groups, tail, keys);
  }
  return static_cast<int>(cudaGetLastError());
}
