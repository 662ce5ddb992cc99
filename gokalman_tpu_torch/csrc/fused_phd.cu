// Hand-written Hopper (sm_90a) kernel: the reduce of a GM-PHD step (Vo &
// Ma 2006) for every scene of a bank in one launch: truncation, Table II's
// cluster merge into j_max slots, the rescale to the truncated total weight
// and the stable descending sort.  Plain C interface, bound with ctypes
// (gokalman_tpu_torch/ops/fused_phd.py); its plain version is
// gokalman_tpu_torch/filters/phd.py:reduce (truncation, gsf.cluster_reduce,
// sort_by_weight), which the CPU and every call ops/fused_phd.takes refuses
// run.
//
// fused_phd_reduce_kernel replaces no Pallas kernel: the JAX package leaves
//    the merge (gokalman_tpu/filters/gsf.py:cluster_reduce) to XLA.  It was
//    added because on the card that merge was over 90% of a GM-PHD step's
//    device time: each of its j_max rounds picks a seed by argmax and reads
//    every one of the C = Jp (1 + m_max) components (13,416 at Vo's widths)
//    through one-hot products, ~80 kernels a round, though truncation leaves
//    a few dozen of them with any weight, and though the C covariances are
//    copies of 2 Jp distinct ones.
//
//    What it computes is phd.reduce, scene by scene, in f32: w > trunc keeps
//    a component (the total of what is kept is the step's cardinality); then
//    at most j_max rounds, each taking the heaviest remaining component (the
//    lowest index on ties, as torch.argmax) as the seed and merging every
//    remaining one whose squared Mahalanobis distance in the seed's
//    covariance is below merge_dist: the weight sum W, the mean
//    x* + sum w d / W and the covariance sum w (sym(P) + d d') / W - delta
//    delta' with d = x - x* and delta = sum w d / W, which is the plain
//    path's spread about the cluster mean shifted by the seed, so it does
//    not cancel at positions of a kilometre.  The seed's inverse is
//    inv_psd's: Cholesky of the lower triangle, then two triangular solves
//    against I, NaN where a pivot is not positive.  Rounds stop when nothing
//    remains (every later round of the plain path writes an empty slot:
//    weight 0, mean 0, covariance I).  The weights are scaled by the kept
//    total over their sum, and the slots ranked by weight, ties in slot
//    order, as torch.argsort(-w, stable=True).  IEEE division and square
//    root throughout (no fast-math), so every comparison that decides (w >
//    trunc, md2 < merge_dist, the argmax, w > 0.5) sees the plain path's
//    arithmetic up to the order of its sums.
//
//    What bounds it: latency, not bytes or operations.  Per scene it reads
//    the C weights (53.7 KB at Vo's widths), the kept components' means and
//    the 2 Jp covariances (13.3 KB), and writes j_max (1 + n + n^2) floats
//    (8.4 KB): ~9.7 MB a step of 128 scenes, 2.9 us at 3.35 TB/s.  The
//    merge is a chain of up to j_max dependent rounds over a few dozen kept
//    components.  The design:
//    - One block of 256 threads a scene: 128 scenes are one wave.
//    - Truncation keeps the components in index order: each warp counts its
//      contiguous chunk by ballots, eight loads in flight a lane, then
//      writes its kept components (weight, covariance index, mean) at its
//      prefix.
//      They go to shared memory, or to the wrapper's scratch in device
//      memory where more are kept than fit.
//    - The 2 Jp distinct covariances and their inverses sit in shared
//      memory, each inverted once a step by one thread; a kept component's
//      covariance is found from its index.
//    - A round is one pass over the kept components: each thread tests its
//      remaining ones against the seed, sums the members' W, w d and
//      w (sym(P) + d d') (its lower triangle) and marks them taken (weight
//      0), and keeps the argmax of the rest by kept index (the kept order is
//      the components' order), which is the next round's seed.  Each warp
//      folds its lanes by shuffles (a warp with nothing left skips them);
//      after one barrier every thread adds the warps' partials in warp
//      order, so all hold the cluster and the next seed with no second
//      barrier (the partials alternate between two buffers by round), and
//      the last warp, the first idle, writes the slot, an entry a lane.  Fixed orders throughout,
//      so a run repeats bit for bit.
//    - The sort counts, for each slot, the slots that precede it (NaN last,
//      as torch.sort puts it): a permutation, written straight to the
//      outputs.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#ifndef KN
#error "KN, the state dimension, must be defined"
#endif

namespace {

constexpr int N = KN;
constexpr int NN = N * N;
constexpr int TRI = N * (N + 1) / 2;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 8;         // weights loaded ahead by each lane in truncation
constexpr unsigned FULL = 0xffffffffu;
constexpr int SUMS = 1 + N + TRI;  // W, sum w d, sum w (sym(P) + d d'), lower triangle
constexpr int PART = SUMS + 2;     // a warp's partial: SUMS and its argmax (weight, index)
constexpr float TINY = 1e-30f;     // gsf.cluster_reduce's clamp in float32

// Dynamic shared memory, in floats from the front: the 2 jp covariances and
// their inverses, the j_max slots' weights, means and covariances, the
// warps' partials of a round (two sets, by round parity), then `cap` kept
// components (weights, indices, means).
struct Layout {
  int inv, sw, sm, sp, part, kept, floats;
};

__host__ __device__ inline Layout layout(int jp, int j_max, int cap) {
  Layout l;
  l.inv = 2 * jp * NN;
  l.sw = l.inv + 2 * jp * NN;
  l.sm = l.sw + j_max;
  l.sp = l.sm + j_max * N;
  l.part = l.sp + j_max * NN;
  l.kept = l.part + 2 * WARPS * PART;
  l.floats = l.kept + cap * (N + 2);
  return l;
}

// The kept components of a scene, in index order: weight (0 once merged),
// the index of its covariance among the 2 jp, mean.
struct Kept {
  float* w;
  int* cov;
  float* m;
  __device__ Kept(float* base, int cap)
      : w(base), cov(reinterpret_cast<int*>(base + cap)), m(base + 2 * cap) {}
};

// (w2, k2) wins the argmax over (w1, k1): heavier, or as heavy and earlier.
__device__ __forceinline__ bool better(float w2, int k2, float w1, int k1) {
  return w2 > w1 || (w2 == w1 && k2 < k1);
}

// Slot j precedes slot i in torch.argsort(-w, stable=True): heavier, or as
// heavy and earlier; NaN after every number, in slot order.
__device__ __forceinline__ bool precedes(float wj, int j, float wi, int i) {
  if (isnan(wi)) return !isnan(wj) || j < i;
  return !isnan(wj) && (wj > wi || (wj == wi && j < i));
}

// The covariance of component c: its predicted component's for a miss term
// (c < jp), else the updated one of component (c - jp) / m_max.
__device__ __forceinline__ int cov_of(int c, int jp, int m_max) {
  return c < jp ? c : jp + (c - jp) / m_max;
}

// Row and column of entry t of the packed lower triangle.
__device__ __forceinline__ void tri_rc(int t, int& i, int& j) {
  i = 0;
  while (t > i) t -= ++i;
  j = t;
}

// x = a^-1 as linalg.inv_psd computes it: L from a's lower triangle, then
// L y = I and L' x = y; NaN everywhere where a pivot is not positive.
__device__ void inv_psd(const float* a, float* x) {
  float l[N][N], y[N][N], z[N][N];
  bool ok = true;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float s = a[j * N + j];
#pragma unroll
    for (int k = 0; k < j; ++k) s -= l[j][k] * l[j][k];
    ok = ok && s > 0.f;
    const float d = sqrtf(s);
    l[j][j] = d;
#pragma unroll
    for (int i = j + 1; i < N; ++i) {
      float t = a[i * N + j];
#pragma unroll
      for (int k = 0; k < j; ++k) t -= l[i][k] * l[j][k];
      l[i][j] = t / d;
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float t = i == j ? 1.f : 0.f;
#pragma unroll
      for (int k = 0; k < i; ++k) t -= l[i][k] * y[k][j];
      y[i][j] = t / l[i][i];
    }
#pragma unroll
    for (int i = N - 1; i >= 0; --i) {
      float t = y[i][j];
#pragma unroll
      for (int k = i + 1; k < N; ++k) t -= l[k][i] * z[k][j];
      z[i][j] = t / l[i][i];
    }
  }
  const float nan = __int_as_float(0x7fc00000);
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) x[i * N + j] = ok ? z[i][j] : nan;
}

// A warp's sums of v[K] and argmax (bw, bk) into `part` (lane 0 writes),
// by a shuffle tree; a warp whose lanes hold nothing writes zeros.
template <int K>
__device__ void warp_partial(float (&v)[K], float bw, int bk, bool any, float* part) {
  if (__any_sync(FULL, any)) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int k = 0; k < K; ++k) v[k] += __shfl_down_sync(FULL, v[k], off);
      const float ow = __shfl_down_sync(FULL, bw, off);
      const int ok = __shfl_down_sync(FULL, bk, off);
      if (better(ow, ok, bw, bk)) bw = ow, bk = ok;
    }
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) part[k] = v[k];
    part[K] = bw;
    part[K + 1] = __int_as_float(bk);
  }
}

// The argmax of a round from the warps' partials (K sums and the argmax
// each), the same in every thread.
template <int K>
__device__ void block_argmax(const float* part, float& bw, int& bk) {
  bw = 0.f;
  bk = INT_MAX;
  for (int w = 0; w < WARPS; ++w, part += K + 2) {
    const int ok = __float_as_int(part[K + 1]);
    if (better(part[K], ok, bw, bk)) bw = part[K], bk = ok;
  }
}

// Sum e of the warps' partials, added in warp order.
template <int K>
__device__ float block_sum(const float* part, int e) {
  float v = 0.f;
  for (int w = 0; w < WARPS; ++w) v += part[w * (K + 2) + e];
  return v;
}

struct In {
  const float* w;       // [B, comps] the components' weights before truncation
  const float* m;       // [B, comps, N]
  const float* p_pred;  // [B, jp, N, N]
  const float* p_upd;   // [B, jp, N, N]
  int comps, jp, m_max, j_max, cap;
  float trunc, merge_dist;
  float* spill;  // [B, comps (N + 2)] where comps > cap, else unused
};

struct Out {
  float* total;  // [B] the kept weights' sum
  float* w;      // [B, j_max] by descending weight
  float* m;      // [B, j_max, N]
  float* p;      // [B, j_max, N, N]
  int* n;        // [B] slots of weight above 0.5
};

__global__ void __launch_bounds__(THREADS) fused_phd_reduce_kernel(In in, Out out) {
  extern __shared__ float smem[];
  __shared__ int warp_kept[WARPS];
  __shared__ int seed_s, extracted_s;
  __shared__ float scale_s;
  const Layout lay = layout(in.jp, in.j_max, in.cap);
  float* cov = smem;
  float* inv = smem + lay.inv;
  float* sw = smem + lay.sw;
  float* sm = smem + lay.sm;
  float* sp = smem + lay.sp;
  float* part = smem + lay.part;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long b = blockIdx.x;
  const int comps = in.comps, jp = in.jp, j_max = in.j_max;
  const float* w_b = in.w + b * comps;
  const float* m_b = in.m + b * comps * N;

#pragma unroll 4
  for (int i = tid; i < jp * NN; i += THREADS) {
    cov[i] = in.p_pred[b * jp * NN + i];
    cov[jp * NN + i] = in.p_upd[b * jp * NN + i];
  }

  // Truncation, first pass: each warp's contiguous chunk counted (UNROLL
  // loads in flight a lane); the kept total and the first seed.
  const int chunk = (comps + WARPS - 1) / WARPS;
  const int lo = min(comps, warp * chunk), hi = min(comps, lo + chunk);
  int kept = 0;
  float total[1] = {0.f};
  float bw = 0.f;
  int bc = INT_MAX;
  for (int i0 = lo; i0 < hi; i0 += 32 * UNROLL) {
    float v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + 32 * u + lane;
      v[u] = i < hi ? w_b[i] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const bool keep = v[u] > in.trunc;
      kept += __popc(__ballot_sync(FULL, keep));
      if (keep) {
        total[0] += v[u];
        if (better(v[u], i0 + 32 * u + lane, bw, bc)) bw = v[u], bc = i0 + 32 * u + lane;
      }
    }
  }
  if (lane == 0) warp_kept[warp] = kept;
  warp_partial(total, bw, bc, true, part + warp * 3);
  __syncthreads();
  block_argmax<1>(part, bw, bc);  // every thread: the first seed's index c, and Σw kept
  const float kept_total = block_sum<1>(part, 0);
  int n_kept = 0, at = 0;
  for (int k = 0; k < WARPS; ++k) {
    at += k < warp ? warp_kept[k] : 0;
    n_kept += warp_kept[k];
  }

  // Second pass: the kept components in index order.
  const Kept s = n_kept <= in.cap ? Kept(smem + lay.kept, in.cap)
                                  : Kept(in.spill + b * comps * (N + 2), comps);
  for (int i0 = lo; i0 < hi; i0 += 32 * UNROLL) {
    float v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + 32 * u + lane;
      v[u] = i < hi ? w_b[i] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + 32 * u + lane;
      const bool keep = v[u] > in.trunc;
      const unsigned ballot = __ballot_sync(FULL, keep);
      if (keep) {
        const int k = at + __popc(ballot & ((1u << lane) - 1u));
        s.w[k] = v[u];
        s.cov[k] = cov_of(i, jp, in.m_max);
#pragma unroll
        for (int e = 0; e < N; ++e) s.m[k * N + e] = m_b[(long long)i * N + e];
        if (i == bc) seed_s = k;
      }
      at += __popc(ballot);
    }
  }
  for (int i = tid; i < 2 * jp; i += THREADS) inv_psd(cov + i * NN, inv + i * NN);
  __syncthreads();

  // The merge: one round a slot while anything remains.  The seed and the
  // next one are kept indices k, whose order is the components' order.
  int seed = bw > 0.f ? seed_s : -1, r = 0;
  for (; r < j_max && seed >= 0; ++r) {
    float xs[N], xi[NN];
    const float* seed_inv = inv + s.cov[seed] * NN;
#pragma unroll
    for (int e = 0; e < N; ++e) xs[e] = s.m[seed * N + e];
#pragma unroll
    for (int e = 0; e < NN; ++e) xi[e] = seed_inv[e];
    float acc[SUMS];
#pragma unroll
    for (int e = 0; e < SUMS; ++e) acc[e] = 0.f;
    float nw = 0.f;
    int nk = INT_MAX;
    bool any = false;
    for (int k = tid; k < n_kept; k += THREADS) {
      const float wk = s.w[k];
      if (!(wk > 0.f)) continue;
      any = true;
      float d[N];
#pragma unroll
      for (int e = 0; e < N; ++e) d[e] = s.m[k * N + e] - xs[e];
      float md2 = 0.f;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        float t = 0.f;
#pragma unroll
        for (int j = 0; j < N; ++j) t += xi[i * N + j] * d[j];
        md2 += d[i] * t;
      }
      if (md2 < in.merge_dist) {
        const float* pc = cov + s.cov[k] * NN;
        acc[0] += wk;
#pragma unroll
        for (int i = 0; i < N; ++i) acc[1 + i] += wk * d[i];
        int t = 1 + N;
#pragma unroll
        for (int i = 0; i < N; ++i)
#pragma unroll
          for (int j = 0; j <= i; ++j, ++t)
            acc[t] += wk * (0.5f * (pc[i * N + j] + pc[j * N + i]) + d[i] * d[j]);
        s.w[k] = 0.f;
      } else if (better(wk, k, nw, nk)) {
        nw = wk, nk = k;
      }
    }
    float* round_part = part + (r & 1) * WARPS * PART;
    warp_partial(acc, nw, nk, any, round_part + warp * PART);
    __syncthreads();
    block_argmax<SUMS>(round_part, nw, nk);
    // The last warp, whose lanes hold the last kept components and so are
    // the first idle, writes the slot, a lane an entry (the mean's, then
    // the covariance's lower triangle and its mirror), each summing from
    // the partials what it needs.
    if (warp == WARPS - 1 && lane < TRI) {
      const float wsum = block_sum<SUMS>(round_part, 0);
      const float safe = fmaxf(wsum, TINY);
      int i, j;
      tri_rc(lane, i, j);
      const float di = block_sum<SUMS>(round_part, 1 + i) / safe;
      const float dj = block_sum<SUMS>(round_part, 1 + j) / safe;
      const float v = block_sum<SUMS>(round_part, 1 + N + lane) / safe - di * dj;
      const bool has = wsum > 0.f;
      sp[r * NN + i * N + j] = has ? v : (i == j ? 1.f : 0.f);
      sp[r * NN + j * N + i] = has ? v : (i == j ? 1.f : 0.f);
      if (lane < N)
        sm[r * N + lane] =
            has ? s.m[seed * N + lane] + block_sum<SUMS>(round_part, 1 + lane) / safe : 0.f;
      if (lane == 0) sw[r] = has ? wsum : 0.f;
    }
    seed = nw > 0.f ? nk : -1;
  }

  // The slots no round filled; the rescale to the kept total.
  for (int i = r + tid; i < j_max; i += THREADS) {
    sw[i] = 0.f;
#pragma unroll
    for (int e = 0; e < N; ++e) sm[i * N + e] = 0.f;
#pragma unroll
    for (int e = 0; e < NN; ++e) sp[i * NN + e] = e % (N + 1) == 0 ? 1.f : 0.f;
  }
  __syncthreads();
  if (warp == 0) {
    float t = 0.f;
    for (int i = lane; i < j_max; i += 32) t += sw[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) t += __shfl_down_sync(FULL, t, off);
    if (lane == 0) {
      scale_s = kept_total / fmaxf(t, TINY);
      extracted_s = 0;
    }
  }
  __syncthreads();
  for (int i = tid; i < j_max; i += THREADS) sw[i] *= scale_s;
  __syncthreads();

  // The sort: each slot straight to its rank.
  int extracted = 0;
  for (int i = tid; i < j_max; i += THREADS) {
    const float wi = sw[i];
    int rank = 0;
#pragma unroll 4
    for (int j = 0; j < j_max; ++j) rank += precedes(sw[j], j, wi, i);
    const long long o = b * j_max + rank;
    out.w[o] = wi;
#pragma unroll
    for (int e = 0; e < N; ++e) out.m[o * N + e] = sm[i * N + e];
#pragma unroll
    for (int e = 0; e < NN; ++e) out.p[o * NN + e] = sp[i * NN + e];
    extracted += wi > 0.5f;
  }
  if (extracted) atomicAdd(&extracted_s, extracted);
  __syncthreads();
  if (tid == 0) {
    out.total[b] = kept_total;
    out.n[b] = extracted_s;
  }
}

}  // namespace

// Dynamic shared memory of a launch, in bytes, with `cap` kept components.
extern "C" int fused_phd_smem_bytes(int jp, int j_max, int cap) {
  return layout(jp, j_max, cap).floats * static_cast<int>(sizeof(float));
}

// Every pointer is a device pointer to float32 (n_extracted int32),
// contiguous: w [B, comps], m [B, comps, KN], p_pred and p_upd [B, jp, KN,
// KN]; spill [B, comps (KN + 2)] where comps > cap (else unused); the
// outputs total [B], w [B, j_max], m [B, j_max, KN], p [B, j_max, KN, KN],
// n_extracted [B].  One block a scene.
extern "C" int fused_phd_launch(const float* w, const float* m, const float* p_pred,
                                const float* p_upd, int scenes, int comps, int jp, int m_max,
                                int j_max, int cap, float trunc, float merge_dist, float* spill,
                                float* total, float* w_out, float* m_out, float* p_out,
                                int* n_extracted, void* stream) {
  const int bytes = fused_phd_smem_bytes(jp, j_max, cap);
  cudaError_t e = cudaFuncSetAttribute(fused_phd_reduce_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const In in{w, m, p_pred, p_upd, comps, jp, m_max, j_max, cap, trunc, merge_dist, spill};
  const Out out{total, w_out, m_out, p_out, n_extracted};
  fused_phd_reduce_kernel<<<scenes, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(in, out);
  return static_cast<int>(cudaGetLastError());
}
