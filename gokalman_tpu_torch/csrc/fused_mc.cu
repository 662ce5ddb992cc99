// Hand-written Hopper (sm_90a) kernel of the fused Monte-Carlo +
// chi-square main path.  Plain C interface, bound with ctypes
// (gokalman_tpu_torch/ops/_build.py); its plain PyTorch version lives in
// gokalman_tpu_torch/ops/fused_mc.py and ops/philox.py.
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
//
//    What bounds it: instruction issue, not memory.  Per member-step it
//    does ~430 FP32 operations of filter algebra and statistics (n = 6,
//    p = 3: 4.2e10 at 98,304 x 1,000, 0.63 ms at the H100's 67 TFLOP/s),
//    3 Philox4x32-10 calls (60 32x32->64-bit multiplies) and 5
//    Box-Muller pairs; it reads one path row per step, shared by the
//    whole ensemble, and writes nothing per member.  So the design cuts
//    instructions that are not this work:
//    - Steps run in chunks of C (sized from the row length, Layout::C).
//      One thread bulk-copies the path rows of the next chunks into a
//      two-stage ring in shared memory (cp.async.bulk, completion on an
//      mbarrier); every member reads each row as float4 broadcasts.
//    - Per step each warp sums its 2 + 2n statistics with a transpose
//      butterfly: at each level a lane sends half of its values and
//      keeps half, so 16 values cost 16 shuffles, not 80.  The x_t
//      components are summed shifted by lane 0's x_t, so each warp has
//      (count, sum d, sum d^2) with no f32 sum x^2 - S mean^2
//      cancellation.  The warps' sums of a chunk wait in shared memory;
//      after the chunk the block combines the warps of each step with
//      Chan's formula and writes C consecutive steps per partials row.
//      Two barriers per chunk, none per step.
//    - F, L_q, H, L_R, x0, L0 and the Philox round keys (built from the
//      seed by the launch function) sit in the __grid_constant__
//      parameter struct, so they are constant-bank operands.  The
//      NEES/NIS weights are upper triangles with the off-diagonal
//      entries pre-summed (P_ij + P_ji), so a quadratic form costs
//      n(n+1)/2 + n FMAs.
//    - Box-Muller's square root is the hardware approximation
//      (philox.cuh:box_muller), so the IEEE sqrtf slow-path call is gone.
//    With 256 threads a block and at most 64 KB of shared memory, three
//    blocks fit on an SM: at S = 98,304 all 384 blocks are resident.
//
// Random numbers (philox.cuh): Philox4x32-10 keyed by the 64-bit seed,
// counter (member, draw, group, 0) with draw 0 for the initial state and
// t + 1 for step t.  K1's member word is the global member index,
// member_offset + the thread's index in the launch, so the ranks of a
// sharded run (parallel/mesh.py) draw the members of one unsharded run.
// This replaces the TPU kernel's prng_seed(seed + tile_id), under which
// neighbouring tiles and devices shared streams.  The launch function
// builds the round keys from the seed.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

#ifndef KBLOCK
#define KBLOCK 256
#endif

namespace {

constexpr int WARPS = KBLOCK / 32;
// Shared memory one K1 block may take: three fit in an SM's 227 KB.
constexpr int SMEM_BUDGET = 64 * 1024;

// Transpose butterfly over the warp, level LVL (lane bit 16 >> LVL):
// while a lane holds more than one value it keeps half and sends half,
// afterwards it adds its partner's one value.  After all five levels
// lane l holds the warp's sums of values (l >> (5 - L)) * R + i, i < R,
// with L = min(log2 M, 5) halving levels and R = M >> L.
template <int M, int LVL>
__device__ __forceinline__ void transpose_sum(float (&v)[M], int lane) {
  constexpr int OFF = 16 >> LVL;
  constexpr int HALF = M >> (LVL + 1);
  if constexpr (HALF >= 1) {
    const bool upper = (lane & OFF) != 0;
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
      const float send = upper ? v[i] : v[i + HALF];
      const float keep = upper ? v[i + HALF] : v[i];
      v[i] = keep + __shfl_xor_sync(0xFFFFFFFFu, send, OFF);
    }
  } else {
    v[0] += __shfl_xor_sync(0xFFFFFFFFu, v[0], OFF);
  }
  if constexpr (LVL < 4) transpose_sum<M, LVL + 1>(v, lane);
}

constexpr int pad4(int x) { return (x + 3) / 4 * 4; }

constexpr int pow2_at_least(int x) {
  int m = 1;
  while (m < x) m *= 2;
  return m;
}

constexpr int log2_exact(int m) {
  int l = 0;
  while ((1 << l) < m) ++l;
  return l;
}

constexpr int smem_bytes(int chunk, int row, int slot) {
  return 16 + 4 * chunk * (2 * row + WARPS * slot);
}

// Steps per chunk: the largest power of two up to 32 whose ring and
// staging fit in SMEM_BUDGET.
constexpr int chunk_steps(int row, int slot) {
  int c = 32;
  while (c > 1 && smem_bytes(c, row, slot) > SMEM_BUDGET) c /= 2;
  return c;
}

// Offsets of the packed path row and fixed array (ops/fused_mc.py:_layout),
// and the shared-memory plan.  Every row segment starts on 16 bytes, so it
// reads as float4s and a chunk of rows is one bulk copy.
template <int N, int P, bool TV, bool CTRL>
struct Layout {
  static constexpr int K = 0;
  static constexpr int PINV = K + pad4(N * P);
  static constexpr int SINV = PINV + pad4(N * (N + 1) / 2);
  static constexpr int H = SINV + pad4(P * (P + 1) / 2);
  static constexpr int LR = H + (TV ? pad4(P * N) : 0);
  static constexpr int GU = LR + (TV ? pad4(P * P) : 0);
  static constexpr int ROW = GU + (CTRL ? pad4(N) : 0);
  static constexpr int F = 0;
  static constexpr int LQ = F + N * N;
  static constexpr int FH = LQ + N * N;
  static constexpr int FLR = FH + P * N;
  static constexpr int X0 = FLR + P * P;
  static constexpr int L0 = X0 + N;
  static constexpr int FIXED = L0 + N * N;
  // A warp's statistics of one step: NEES, NIS, sum d (n), sum d^2 (n),
  // padded to M for the butterfly; staged as VA values then n shifts.
  static constexpr int V = 2 + 2 * N;
  static constexpr int M = pow2_at_least(V);
  static constexpr int LEVELS = log2_exact(M) < 5 ? log2_exact(M) : 5;
  static constexpr int R = M >> LEVELS;
  static constexpr int VA = pad4(V);
  static constexpr int SLOT = VA + pad4(N);
  static constexpr int C = chunk_steps(ROW, SLOT);
  static constexpr int SMEM = smem_bytes(C, ROW, SLOT);
};

template <int LEN>
struct Params {
  float v[LEN];
  KeySchedule keys;
};

// LEN floats of a 16-byte-aligned row segment in shared memory.
template <int LEN>
__device__ __forceinline__ void load_row(const float* src, float (&dst)[LEN]) {
#pragma unroll
  for (int q = 0; q < LEN; q += 4) {
    const float4 f = *reinterpret_cast<const float4*>(src + q);
    dst[q] = f.x;
    if (q + 1 < LEN) dst[q + 1] = f.y;
    if (q + 2 < LEN) dst[q + 2] = f.z;
    if (q + 3 < LEN) dst[q + 3] = f.w;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@!p bra WAIT;\n\t}"
      :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// One thread: `bytes` from global `src` to shared `dst`, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

template <int N, int P, bool TV, bool CTRL, bool FAST>
__global__ void __launch_bounds__(KBLOCK, N <= 8 ? 3 : 1)
fused_mc_kernel(const float* __restrict__ path,
                const __grid_constant__ Params<Layout<N, P, TV, CTRL>::FIXED> prm,
                int steps, int samples, uint32_t member_offset,
                float* __restrict__ partials) {
  using L = Layout<N, P, TV, CTRL>;
  constexpr int C = L::C;
  constexpr int ROWS = 2 + 2 * N;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);  // one per ring stage
  float* ring = reinterpret_cast<float*>(smem + 16);  // [2][C][ROW]
  float* staged = ring + 2 * C * L::ROW;              // [C][WARPS][SLOT]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int member = blockIdx.x * KBLOCK + tid;
  // Philox member word: the global index.  `valid`, the counts and the
  // block partials keep the index in this launch.
  const uint32_t ctr = member_offset + static_cast<uint32_t>(member);
  // Members past `samples` run along (they take part in the shuffles)
  // and add zeros to every sum.
  const bool valid = member < samples;
  const int block_count =
      min(KBLOCK, samples - static_cast<int>(blockIdx.x) * KBLOCK);
  float* out = partials + static_cast<size_t>(blockIdx.x) * ROWS * steps;

  // Chunk k's rows into ring stage k & 1 (one thread).
  auto load_chunk = [&](int k) {
    const int rows = min(C, steps - k * C);
    bulk_load(ring + (k & 1) * C * L::ROW,
              path + static_cast<size_t>(k) * C * L::ROW,
              static_cast<uint32_t>(rows * L::ROW * sizeof(float)), &bar[k & 1]);
  };
  if (tid == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && steps > 0) {
    load_chunk(0);
    if (C < steps) load_chunk(1);
  }

  float xt[N], xe[N];
  {
    float z[N];
    draw_normals<N, FAST>(ctr, 0u, prm.keys, z);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float acc = prm.v[L::X0 + i];
#pragma unroll
      for (int j = 0; j < N; ++j) acc += prm.v[L::L0 + i * N + j] * z[j];
      xt[i] = acc;
      xe[i] = prm.v[L::X0 + i];
    }
  }

  for (int k = 0, t0 = 0; t0 < steps; ++k, t0 += C) {
    const int len = min(C, steps - t0);
    mbar_wait(&bar[k & 1], (k >> 1) & 1);
    const float* rows = ring + (k & 1) * C * L::ROW;

#pragma unroll 1
    for (int j = 0; j < len; ++j) {
      const float* row = rows + j * L::ROW;
      float d[N + P];  // w = d[0:N], v = d[N:N+P]
      draw_normals<N + P, FAST>(ctr, static_cast<uint32_t>(t0 + j + 1),
                                prm.keys, d);

      float gu[CTRL ? N : 1];
      if constexpr (CTRL) load_row(row + L::GU, gu);
      float xn[N], xp[N];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        float a = 0.0f, b = 0.0f;
#pragma unroll
        for (int j2 = 0; j2 < N; ++j2) {
          a += prm.v[L::F + i * N + j2] * xt[j2];
          b += prm.v[L::F + i * N + j2] * xe[j2];
        }
#pragma unroll
        for (int j2 = 0; j2 < N; ++j2) a += prm.v[L::LQ + i * N + j2] * d[j2];
        if constexpr (CTRL) {
          a += gu[i];
          b += gu[i];
        }
        xn[i] = a;
        xp[i] = b;
      }

      float hm[P * N], lrm[P * P];
      if constexpr (TV) {
        load_row(row + L::H, hm);
        load_row(row + L::LR, lrm);
      } else {
#pragma unroll
        for (int q = 0; q < P * N; ++q) hm[q] = prm.v[L::FH + q];
#pragma unroll
        for (int q = 0; q < P * P; ++q) lrm[q] = prm.v[L::FLR + q];
      }
      float nu[P];
#pragma unroll
      for (int i = 0; i < P; ++i) {
        float a = 0.0f;
#pragma unroll
        for (int j2 = 0; j2 < N; ++j2) a += hm[i * N + j2] * (xn[j2] - xp[j2]);
#pragma unroll
        for (int j2 = 0; j2 < P; ++j2) a += lrm[i * P + j2] * d[N + j2];
        nu[i] = a;
      }

      float km[N * P];
      load_row(row + L::K, km);
      float err[N];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        float u = xp[i];
#pragma unroll
        for (int j2 = 0; j2 < P; ++j2) u += km[i * P + j2] * nu[j2];
        xe[i] = u;
        xt[i] = xn[i];
        err[i] = xn[i] - u;
      }

      // Quadratic forms of the packed upper triangles: row i of the
      // triangle starts at i*n - i(i-1)/2 and holds P_ii, then P_ij + P_ji.
      float pw[N * (N + 1) / 2], sw[P * (P + 1) / 2];
      load_row(row + L::PINV, pw);
      load_row(row + L::SINV, sw);
      float nees = 0.0f, nis = 0.0f;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int base = i * N - i * (i - 1) / 2 - i;
        float s = 0.0f;
#pragma unroll
        for (int j2 = i; j2 < N; ++j2) s += pw[base + j2] * err[j2];
        nees += s * err[i];
      }
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int base = i * P - i * (i - 1) / 2 - i;
        float s = 0.0f;
#pragma unroll
        for (int j2 = i; j2 < P; ++j2) s += sw[base + j2] * nu[j2];
        nis += s * nu[i];
      }

      // The warp's statistics: NEES, NIS, and x_t - x_t(lane 0) and its
      // square per component.
      float v[L::M];
      float ref[N];
      v[0] = valid ? nees : 0.0f;
      v[1] = valid ? nis : 0.0f;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        ref[i] = __shfl_sync(0xFFFFFFFFu, xt[i], 0);
        const float dx = valid ? xt[i] - ref[i] : 0.0f;
        v[2 + i] = dx;
        v[2 + N + i] = dx * dx;
      }
#pragma unroll
      for (int i = L::V; i < L::M; ++i) v[i] = 0.0f;
      transpose_sum<L::M, 0>(v, lane);
      float* slot = staged + (j * WARPS + warp) * L::SLOT;
      if ((lane & ((1 << (5 - L::LEVELS)) - 1)) == 0) {
        const int first = (lane >> (5 - L::LEVELS)) * L::R;
#pragma unroll
        for (int i = 0; i < L::R; ++i) {
          if (first + i < L::V) slot[first + i] = v[i];
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int q = 0; q < N; q += 4) {
          float4 f;
          f.x = ref[q];
          f.y = q + 1 < N ? ref[q + 1] : 0.0f;
          f.z = q + 2 < N ? ref[q + 2] : 0.0f;
          f.w = q + 3 < N ? ref[q + 3] : 0.0f;
          *reinterpret_cast<float4*>(slot + L::VA + q) = f;
        }
      }
    }

    // The chunk's warp sums are staged and its ring stage is read.
    __syncthreads();
    if (tid == 0 && t0 + 2 * C < steps) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      load_chunk(k + 2);
    }
    // Block partials of the chunk's steps: NEES and NIS sum over the
    // warps; x_t pools the warps' (count, shift, sum d, sum d^2) with
    // Chan's formula about warp 0's shift r0.
    for (int job = tid; job < (2 + N) * len; job += KBLOCK) {
      const int q = job / len;
      const int j = job - q * len;
      const float* s = staged + j * WARPS * L::SLOT;
      float* o = out + t0 + j;
      if (q < 2) {
        float sum = 0.0f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) sum += s[w * L::SLOT + q];
        o[q * steps] = sum;
        continue;
      }
      const int i = q - 2;
      const float r0 = s[L::VA + i];
      float dsum = 0.0f;  // sum over the block of x_t - r0
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const int c = min(32, block_count - 32 * w);
        if (c > 0) {
          dsum += static_cast<float>(c) * (s[w * L::SLOT + L::VA + i] - r0) +
                  s[w * L::SLOT + 2 + i];
        }
      }
      const float mean = dsum / static_cast<float>(block_count);  // minus r0
      float m2 = 0.0f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const int c = min(32, block_count - 32 * w);
        if (c > 0) {
          const float cf = static_cast<float>(c);
          const float sd = s[w * L::SLOT + 2 + i];
          const float dm = (s[w * L::SLOT + L::VA + i] - r0) + sd / cf - mean;
          m2 += (s[w * L::SLOT + 2 + N + i] - sd * sd / cf) + cf * dm * dm;
        }
      }
      o[(2 + i) * steps] = static_cast<float>(block_count) * r0 + dsum;
      o[(2 + N + i) * steps] = m2;
    }
    // The staging is free for the next chunk.
    __syncthreads();
  }
}

}  // namespace

// K1 is specialised per build: -DKN=<n> -DKP=<p> -DKTV=<0|1> -DKCTRL=<0|1>.
#ifdef KN
using KLayout = Layout<KN, KP, KTV != 0, KCTRL != 0>;

extern "C" int fused_mc_row_len() { return KLayout::ROW; }
extern "C" int fused_mc_fixed_len() { return KLayout::FIXED; }
extern "C" int fused_mc_chunk_steps() { return KLayout::C; }
extern "C" int fused_mc_smem_bytes() { return KLayout::SMEM; }

// `fixed_host` (fused_mc_fixed_len() floats, a host array) and the
// round keys of `seed` are passed to the kernel by value: they land in
// the constant bank.
extern "C" int fused_mc_launch(const float* path, const float* fixed_host,
                               uint64_t seed, int steps, int samples,
                               uint32_t member_offset, int fast_rng,
                               float* partials, void* stream) {
  Params<KLayout::FIXED> prm;
  for (int i = 0; i < KLayout::FIXED; ++i) prm.v[i] = fixed_host[i];
  prm.keys = key_schedule(seed);
  auto kernel = fast_rng ? fused_mc_kernel<KN, KP, KTV != 0, KCTRL != 0, true>
                         : fused_mc_kernel<KN, KP, KTV != 0, KCTRL != 0, false>;
  if (KLayout::SMEM > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, KLayout::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((samples + KBLOCK - 1) / KBLOCK);
  kernel<<<grid, KBLOCK, KLayout::SMEM, static_cast<cudaStream_t>(stream)>>>(
      path, prm, steps, samples, member_offset, partials);
  return static_cast<int>(cudaGetLastError());
}
#endif
