// Hand-written Hopper (sm_90a) kernels of the fused Monte-Carlo +
// chi-square main path.  Plain C interface, bound with ctypes
// (gokalman_tpu_torch/ops/_build.py); plain PyTorch versions of both
// kernels live in gokalman_tpu_torch/ops/fused_mc.py and ops/philox.py.
//
// K1 fused_mc_kernel replaces gokalman_tpu/ops/pallas_mc.py:_build
//    (kernel_body, the pallas_call of `run`).  One thread per ensemble
//    member: the truth and estimate states (2n floats) stay in registers
//    across an in-kernel loop over the T steps.  Per step and member:
//      x_t <- F x_t (+ G u_k) + L_q w;   x^- = F x_e (+ G u_k)
//      nu  = H_k (x_t - x^-) + L_R,k v;  x_e <- x^- + K_k nu
//      NEES = e' P+_k^-1 e (e = x_t - x_e);  NIS = nu' S_k^-1 nu
//    and per step and block: sums of NEES, NIS and x_t, and the block's
//    sum of squared deviations from its own mean.  Partials go to
//    [blocks, 2 + 2n, T]; the host pools them (Chan's formula for the
//    variance).  No atomics and no cross-block carry: the result is
//    deterministic.
//    What bounds it: instruction issue, not memory.  Each member-step
//    costs 3 Philox4x32-10 calls, 5 log/sqrt/sincos Box-Muller pairs,
//    ~200 FMAs of filter algebra and 2 block reductions (1,234 SASS
//    instructions for n=6, p=3; on an H100 SXM at 700 W the kernel runs
//    at ~78% of the 4-instructions-per-clock-per-SM issue bound), while
//    it reads one broadcast path row (~250 B, L1-resident) and writes
//    nothing per member.  The design keeps every per-member quantity in
//    registers, F/L_q/H/L_R/x0/L0 in the parameter (constant) bank as
//    FMA operands, and the path rows as uniform __ldg loads.  At
//    S = 98,304 one thread per member fills ~36% of the card's 270k
//    thread slots; occupancy tuning, wgmma and TMA are later work.
//
// K2 sample_normals_kernel replaces gokalman_tpu/ops/pallas_mc.py:
//    sample_normals_pallas.  Thread i writes normals 4i..4i+3 from the
//    counter (i, 0, 0, 0): the same draws as K1's first initial-state
//    group of member i, so K2's statistics are K1's generator's.  Per 16
//    bytes written it does one Philox call and two Box-Muller pairs, so
//    it is arithmetic-bound at scale; at 524,288 draws (~2 us on an H100)
//    launch latency dominates.
//
// Random numbers: Philox4x32-10 keyed by the 64-bit seed, counter
// (member, draw, group, 0) with draw 0 for the initial state and t + 1
// for step t.  K1's member word is the global member index,
// member_offset + the thread's index in the launch, so the ranks of a
// sharded run (parallel/mesh.py) draw the members of one unsharded run.
// This replaces the TPU kernel's prng_seed(seed + tile_id), under which
// neighbouring tiles and devices shared streams.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef KBLOCK
#define KBLOCK 256
#endif

namespace {

constexpr uint32_t PHILOX_M0 = 0xD2511F53u, PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u, PHILOX_W1 = 0xBB67AE85u;
// 1/sqrt(6 + (1 - 2^-16)/12): unit variance for popcount24 + dither.
constexpr float CLT_SCALE = 0.40544246941340006f;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = PHILOX_M0 * c.x, hi0 = __umulhi(PHILOX_M0, c.x);
    const uint32_t lo1 = PHILOX_M1 * c.z, hi1 = __umulhi(PHILOX_M1, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += PHILOX_W0;
    k1 += PHILOX_W1;
  }
  return c;
}

// (cos 2 pi u, sin 2 pi u), u in [0, 1): pallas_mc.py:_sincos_turns.
__device__ __forceinline__ void sincos_turns(float u, float& c, float& s) {
  const float t4 = 4.0f * u;
  const float q = floorf(t4);
  const float x = t4 - q;
  const float x2 = x * x;
  const float sp = x * (1.5707963257f + x2 * (-0.6459638093f
                   + x2 * (0.0796899578f + x2 * (-0.0046740125f
                   + x2 * 0.0001515384f))));
  const float cp = 1.0f + x2 * (-1.2336986638f + x2 * (0.2536513764f
                   + x2 * (-0.0208101642f + x2 * 0.0008574517f)));
  const int qi = static_cast<int>(q);
  const bool swap = (qi & 1) == 1;
  const float c0 = swap ? sp : cp;
  const float s0 = swap ? cp : sp;
  c = (qi == 1 || qi == 2) ? -c0 : c0;
  s = (qi == 2 || qi == 3) ? -s0 : s0;
}

// Both branches of one Box-Muller pair: pallas_mc.py:_normal_pair.
__device__ __forceinline__ void box_muller(uint32_t b1, uint32_t b2,
                                           float& a, float& b) {
  const float u1 = static_cast<float>(b1 & 0xFFFFFFu) * 0x1p-24f + 0x1p-25f;
  const float u2 = static_cast<float>(b2 & 0xFFFFFFu) * 0x1p-24f;
  const float r = sqrtf(-2.0f * logf(u1));
  float c, s;
  sincos_turns(u2, c, s);
  a = r * c;
  b = r * s;
}

// Popcount-CLT normal from one word: pallas_mc.py:_normal_clt.
__device__ __forceinline__ float clt_normal(uint32_t bits) {
  const int pc = __popc((bits >> 8) & 0xFFFFFFu);
  const float dither =
      (static_cast<float>(bits & 0xFFu) + 0.5f) * (1.0f / 256.0f) - 0.5f;
  return (static_cast<float>(pc) - 12.0f + dither) * CLT_SCALE;
}

// COUNT normals of one member's draw index `draw` (ops/philox.py:normals).
template <int COUNT, bool FAST>
__device__ __forceinline__ void draw_normals(uint32_t member, uint32_t draw,
                                             uint32_t k0, uint32_t k1,
                                             float (&out)[COUNT]) {
  constexpr int WORDS = FAST ? COUNT : 2 * ((COUNT + 1) / 2);
  constexpr int GROUPS = (WORDS + 3) / 4;
  uint32_t w[GROUPS * 4];
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    const uint4 r = philox4x32_10(
        make_uint4(member, draw, static_cast<uint32_t>(g), 0u), k0, k1);
    w[4 * g] = r.x;
    w[4 * g + 1] = r.y;
    w[4 * g + 2] = r.z;
    w[4 * g + 3] = r.w;
  }
  if constexpr (FAST) {
#pragma unroll
    for (int i = 0; i < COUNT; ++i) out[i] = clt_normal(w[i]);
  } else {
#pragma unroll
    for (int j = 0; j < (COUNT + 1) / 2; ++j) {
      float a, b;
      box_muller(w[2 * j], w[2 * j + 1], a, b);
      out[2 * j] = a;
      if (2 * j + 1 < COUNT) out[2 * j + 1] = b;
    }
  }
}

template <int M>
__device__ __forceinline__ void warp_sum(float (&v)[M]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int q = 0; q < M; ++q) v[q] += __shfl_xor_sync(0xFFFFFFFFu, v[q], off);
  }
}

// Offsets of the packed path row and fixed array (ops/fused_mc.py:_layout).
template <int N, int P, bool TV, bool CTRL>
struct Layout {
  static constexpr int K = 0;
  static constexpr int PINV = K + N * P;
  static constexpr int SINV = PINV + N * N;
  static constexpr int H = SINV + P * P;
  static constexpr int LR = H + (TV ? P * N : 0);
  static constexpr int GU = LR + (TV ? P * P : 0);
  static constexpr int ROW = GU + (CTRL ? N : 0);
  static constexpr int F = 0;
  static constexpr int LQ = F + N * N;
  static constexpr int FH = LQ + N * N;
  static constexpr int FLR = FH + P * N;
  static constexpr int X0 = FLR + P * P;
  static constexpr int L0 = X0 + N;
  static constexpr int FIXED = L0 + N * N;
};

template <int LEN>
struct Fixed {
  float v[LEN];
};

template <int N, int P, bool TV, bool CTRL, bool FAST>
__global__ void __launch_bounds__(KBLOCK)
fused_mc_kernel(const float* __restrict__ path,
                const __grid_constant__ Fixed<Layout<N, P, TV, CTRL>::FIXED> fx,
                int steps, int samples, uint32_t member_offset, uint32_t k0,
                uint32_t k1, float* __restrict__ partials) {
  using L = Layout<N, P, TV, CTRL>;
  constexpr int ROWS = 2 + 2 * N;
  constexpr int WARPS = KBLOCK / 32;
  __shared__ float red_a[WARPS][2 + N];
  __shared__ float red_b[WARPS][N];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int member = blockIdx.x * KBLOCK + tid;
  // Philox member word: the global index.  `valid`, `count` and the
  // block partials keep the index in this launch.
  const uint32_t ctr = member_offset + static_cast<uint32_t>(member);
  // Members past `samples` run along (they take part in the barriers)
  // and add zeros to every sum.
  const bool valid = member < samples;
  const float count =
      static_cast<float>(min(KBLOCK, samples - static_cast<int>(blockIdx.x) * KBLOCK));
  float* out = partials + static_cast<size_t>(blockIdx.x) * ROWS * steps;

  float xt[N], xe[N];
  {
    float z[N];
    draw_normals<N, FAST>(ctr, 0u, k0, k1, z);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float acc = fx.v[L::X0 + i];
#pragma unroll
      for (int j = 0; j < N; ++j) acc += fx.v[L::L0 + i * N + j] * z[j];
      xt[i] = acc;
      xe[i] = fx.v[L::X0 + i];
    }
  }

  for (int t = 0; t < steps; ++t) {
    const float* row = path + static_cast<size_t>(t) * L::ROW;
    float d[N + P];  // w = d[0:N], v = d[N:N+P]
    draw_normals<N + P, FAST>(ctr, static_cast<uint32_t>(t + 1), k0, k1, d);

    float xn[N], xp[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float a = 0.0f, b = 0.0f;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        a += fx.v[L::F + i * N + j] * xt[j];
        b += fx.v[L::F + i * N + j] * xe[j];
      }
#pragma unroll
      for (int j = 0; j < N; ++j) a += fx.v[L::LQ + i * N + j] * d[j];
      if constexpr (CTRL) {
        const float gu = __ldg(row + L::GU + i);
        a += gu;
        b += gu;
      }
      xn[i] = a;
      xp[i] = b;
    }

    float nu[P];
#pragma unroll
    for (int i = 0; i < P; ++i) {
      float a = 0.0f;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float h = TV ? __ldg(row + L::H + i * N + j) : fx.v[L::FH + i * N + j];
        a += h * (xn[j] - xp[j]);
      }
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const float lr = TV ? __ldg(row + L::LR + i * P + j) : fx.v[L::FLR + i * P + j];
        a += lr * d[N + j];
      }
      nu[i] = a;
    }

    float err[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float u = xp[i];
#pragma unroll
      for (int j = 0; j < P; ++j) u += __ldg(row + L::K + i * P + j) * nu[j];
      xe[i] = u;
      xt[i] = xn[i];
      err[i] = xn[i] - u;
    }

    // Quadratic forms of the symmetric weights: diagonal + 2 x upper.
    float nees = 0.0f, nis = 0.0f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      nees += __ldg(row + L::PINV + i * N + i) * err[i] * err[i];
#pragma unroll
      for (int j = i + 1; j < N; ++j)
        nees += 2.0f * __ldg(row + L::PINV + i * N + j) * err[i] * err[j];
    }
#pragma unroll
    for (int i = 0; i < P; ++i) {
      nis += __ldg(row + L::SINV + i * P + i) * nu[i] * nu[i];
#pragma unroll
      for (int j = i + 1; j < P; ++j)
        nis += 2.0f * __ldg(row + L::SINV + i * P + j) * nu[i] * nu[j];
    }

    // Block sums of NEES, NIS and x_t: warp butterflies, then one
    // shared-memory row per warp.
    float sa[2 + N];
    sa[0] = valid ? nees : 0.0f;
    sa[1] = valid ? nis : 0.0f;
#pragma unroll
    for (int i = 0; i < N; ++i) sa[2 + i] = valid ? xt[i] : 0.0f;
    warp_sum<2 + N>(sa);
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < 2 + N; ++q) red_a[warp][q] = sa[q];
    }
    __syncthreads();
    if (tid < 2 + N) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += red_a[w][tid];
      out[tid * steps + t] = s;
    }
    // Squared deviations from the block's own mean (Chan pooling on the
    // host; no f32 sum-of-squares cancellation).
    float sb[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += red_a[w][2 + i];
      const float dx = xt[i] - s / count;
      sb[i] = valid ? dx * dx : 0.0f;
    }
    warp_sum<N>(sb);
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < N; ++i) red_b[warp][i] = sb[i];
    }
    __syncthreads();
    if (tid < N) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += red_b[w][tid];
      out[(2 + N + tid) * steps + t] = s;
    }
  }
}

template <bool FAST>
__global__ void __launch_bounds__(KBLOCK)
sample_normals_kernel(float* __restrict__ out, long long count, uint32_t k0,
                      uint32_t k1) {
  const long long i = static_cast<long long>(blockIdx.x) * KBLOCK + threadIdx.x;
  const long long base = 4 * i;
  if (base >= count) return;
  float z[4];
  draw_normals<4, FAST>(static_cast<uint32_t>(i), 0u, k0, k1, z);
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    if (base + l < count) out[base + l] = z[l];
  }
}

}  // namespace

extern "C" int sample_normals_launch(float* out, long long count, uint32_t k0,
                                     uint32_t k1, int fast_rng, void* stream) {
  const long long threads = (count + 3) / 4;
  const dim3 grid(static_cast<unsigned>((threads + KBLOCK - 1) / KBLOCK));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fast_rng) {
    sample_normals_kernel<true><<<grid, KBLOCK, 0, s>>>(out, count, k0, k1);
  } else {
    sample_normals_kernel<false><<<grid, KBLOCK, 0, s>>>(out, count, k0, k1);
  }
  return static_cast<int>(cudaGetLastError());
}

// K1 is specialised per build: -DKN=<n> -DKP=<p> -DKTV=<0|1> -DKCTRL=<0|1>.
#ifdef KN
using KLayout = Layout<KN, KP, KTV != 0, KCTRL != 0>;

extern "C" int fused_mc_row_len() { return KLayout::ROW; }
extern "C" int fused_mc_fixed_len() { return KLayout::FIXED; }

// `fixed_host` is a host array of fused_mc_fixed_len() floats, passed to
// the kernel by value (it lands in the constant bank).
extern "C" int fused_mc_launch(const float* path, const float* fixed_host,
                               int steps, int samples, uint32_t member_offset,
                               uint32_t k0, uint32_t k1, int fast_rng,
                               float* partials, void* stream) {
  Fixed<KLayout::FIXED> fx;
  for (int i = 0; i < KLayout::FIXED; ++i) fx.v[i] = fixed_host[i];
  const dim3 grid((samples + KBLOCK - 1) / KBLOCK);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fast_rng) {
    fused_mc_kernel<KN, KP, KTV != 0, KCTRL != 0, true>
        <<<grid, KBLOCK, 0, s>>>(path, fx, steps, samples, member_offset, k0,
                                 k1, partials);
  } else {
    fused_mc_kernel<KN, KP, KTV != 0, KCTRL != 0, false>
        <<<grid, KBLOCK, 0, s>>>(path, fx, steps, samples, member_offset, k0,
                                 k1, partials);
  }
  return static_cast<int>(cudaGetLastError());
}
#endif
