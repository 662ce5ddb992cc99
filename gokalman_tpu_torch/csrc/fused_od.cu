// Hand-written Hopper (sm_90a) kernel: the whole SRIF orbit determination of
// a catalog (`od.run_srif_od` with state-noise compensation), every step of
// every object, in one launch.  Plain C interface, bound with ctypes
// (gokalman_tpu_torch/ops/fused_od.py); its plain version is the ops/scan path
// of gokalman_tpu_torch/od.py:run_srif_od (`run_srif_od(..., graph=False)`).
//
// fused_srif_od_kernel replaces no Pallas kernel: the JAX package leaves the
//    OD step to XLA (gokalman_tpu/od.py).  It was added because on the card
//    the SRIF step of a catalog ran as 893 dependent small kernels a step
//    (PyTorch's elementwise kernels over 1,024 objects, ~1.6 us each),
//    replayed from a CUDA graph 5,120 times a request.
//
//    What it computes is `od._srif_body`'s step in float64, per object and
//    step, the scan path's mathematics:
//    - the RK4 step of the reference under two-body + J2 (`gravity.eom`,
//      degree 2), each primal operation in the scan path's order and
//      rounding, and its STM, the Jacobian of the discrete RK4 map: the
//      stage tangents I + c dt K pushed through the gravity gradient G at
//      each stage's state (what `integrators.x_and_jac`'s jvp computes);
//    - the Dyer-McReynolds time update with SNC: R_bar = R Phi^-1, Phi^-1 by
//      the LU of Phi with partial pivoting, then one Householder pass over the
//      (q + n) x (q + n + 1) stack [[R_w, 0 | 0], [-R_bar Gamma, R_bar | b]];
//    - where the object has a measurement, the station's ECI state at the
//      step's Earth angle theta0 + Omega_E t (its cos and sin computed by
//      the wrapper as the scan path computes them), range, range-rate and
//      H~ (`stations.obs_and_jacobian`), the whitening W y, W H~ and a
//      Householder pass over [[R_bar, b_bar], [W H~, W y]]; else the
//      predict branch;
//    - both passes in `linalg.householder_triangularize`'s convention
//      (sigma = sign_db(A_kk) |A_k:,k|, the diagonal -sigma, exact zeros
//      below it), so R and b match the scan path entry by entry, not up to
//      row signs;
//    - the read-outs x = R^-1 b and P = R^-1 R^-T by back substitution on
//      the upper-triangular R, and the estimate x_ref + x.
//    It writes every field `run_srif_od` returns, float64, in the scan
//    path's storage: time-major [T, K, ...], which the wrapper hands on as
//    [K, T, ...] views, as the scan path does.
//
//    What bounds it: one object's step is a serial chain of ~3,000 FP64
//    instructions (RK4 with its tangents ~1,000, the two Householder
//    passes ~800, the LU inverse ~400, read-outs ~250), and objects never
//    exchange anything, so the T loop runs inside the kernel with each
//    object's state on chip between steps.  The work is 4,472 FP64
//    operations an object-step (h100_bench/work/od.py: 0.35 ms for a
//    1,024 x 5,120 request at 67 TFLOP/s), and the outputs are 1,392 bytes
//    an object-step (7.3 GB, 2.2 ms at 3.35 TB/s).  1,024 objects are 32
//    warps' worth of lanes, so the card is far from either bound: a step
//    is latency-bound.  One warp doing the whole step, one object a lane,
//    ran ~21,700 cycles a step against ~6,600 of issue on an H100 (55-58
//    ms a 1,024 x 5,120 request).  The design shortens the chain:
//    - The step runs as a pipeline of four stages: the reference trajectory
//      (RK4 with the STM), its linearization (Phi^-1 by partial-pivot LU,
//      the station geometry, the whitened W H~ and W (y - h)), the filter
//      (R_bar = R Phi^-1, both Householder passes) and the read-outs with
//      the stores.  Only the filter depends on the filter's state, so the
//      stages work on successive steps at once and a step costs the longest
//      stage rather than their sum.
//    - Each stage runs on an SM of its own: a cluster of four blocks, block
//      rank r on stage r, each of `groups` compute warps of 32 objects, one
//      object a lane (warp g of every rank on the same objects), and as
//      many mover warps.  As four warps of one block the stages met on a
//      named barrier every step, and each ran 1.3-2.2x slower than
//      alone (1,024 x 5,120, clock64 cycles a step on an H100: trajectory
//      8,620 against 5,964 alone, linearization 8,244 / 4,491, filter
//      10,887 / 8,082, read-outs 5,983 / 4,916; ~11,400 a step), which the
//      four code streams of the ~9,000-instruction kernel through one SM's
//      instruction fetch would explain.  On an SM of its own each stage
//      fetches only its own code: ~7,900 cycles a step, the filter's own
//      ~7,200 and its waits (20.5 ms a request against 31 ms for the
//      four-warp block, in one call).
//    - A stage hands its step to the next rank through distributed shared
//      memory (see `move`): it writes the hand-off into staging in its own
//      shared memory, and its mover warp copies it into a ring of two slots
//      in the consumer's, so the wait for remote stores to complete falls
//      on the mover, off the stage's chain.  A stage waits only on its
//      input and on its mover having taken the step before.
//    - Shared memory caps the warps a block: the read-out block holds two
//      ring slots of B3 (31.7 KB a warp each) and its 44.5 KB output stage
//      a warp, so 227 KB takes one or two warps (`groups`, a launch
//      argument; MAX_W).  ops/fused_od.cluster_plan picks the fewest for
//      which a catalog's clusters are resident at once
//      (`fused_od_clusters`: 30 clusters of four on an H100 SXM, so 1,024
//      objects run as 16 clusters of two warps, 1,920 at most in a wave).
//    - A group of lanes an object is slower: the filter stage alone took
//      ~6,170 cycles a step (15.9 ms) at one object a lane and 22.3 ms
//      (~8,700 cycles) at 16 lanes an object over 128 SMs, a stack column a
//      lane with the pivot column, sigma and beta broadcast by __shfl_sync,
//      both bit-identical: a column's square root, division and broadcast
//      come one after another, while one lane overlaps the columns'
//      independent updates.
//    - Each lane runs its object's stage fully unrolled in registers.  The
//      measurement pass touches only row k and the two measurement rows of
//      each reflection: R_bar is upper triangular, and the full pass leaves
//      the exact zeros between them as they are.
//    - Each read-out warp keeps one step's output rows of its 32 objects in
//      shared memory (its "stage"), field by field in the output layout,
//      so each field of a step goes out as one contiguous run of 32 rows
//      in 16-byte streaming stores, every load of a field before its
//      stores.  __syncwarp orders it.
//    - The run's inputs (P0's diagonal, Q, R, the stations' coordinates,
//      the step, the Earth constants) sit in shared memory, beside what
//      the prologue derives from them as srif.new and
//      Station.ecef_position do (R0, R_w = chol(Q)^-1, W = chol(R)^-1,
//      the stations' ECEF positions), so a call launches nothing else;
//      the step's Earth angle comes as its cos and sin.
//    - IEEE float64 throughout (no fast math).  The reference trajectory
//      accumulates over the arc, so its primal arithmetic is written with
//      explicit roundings (__dadd_rn, __dmul_rn, fma where PyTorch's
//      `add(..., alpha=)` contracts, the three-term sum in the order
//      torch.sum takes it, pow as torch.pow calls it) in the scan path's
//      order: on an H100 it matches the scan path bit for bit over the
//      whole 5,120-step arc.  (1 / (s sqrt(s)) for pow(s, -1.5) was 3-8%
//      faster and lost that.)
//    FUSED_OD_CLOCKS=1 builds a diagnostic copy that sums clock64 per phase
//    and per wait for lane 0 of warp 0 (a compute warp) of each block of
//    cluster 0 (`fused_od_read_clocks`).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int LANES = 32;  // objects a warp, one a lane
constexpr int MAX_S = 8;   // stations the parameter block holds

// The parameter block (ops/fused_od.py:pack_params), doubles: the run's
// inputs, then the stations' geodetic coordinates; after them in shared
// memory what the prologue derives from them, as srif.new and
// Station.ecef_position do.
struct Plan {
  static constexpr int P0 = 0;               // [6] diagonal of P0
  static constexpr int Q = P0 + 6;           // [3][3] SNC acceleration PSD
  static constexpr int RN = Q + 9;           // [2][2] measurement noise R
  static constexpr int DT = RN + 4;          // filter step
  static constexpr int G1 = DT + 1;          // 0.5 dt dt, Gamma = [G1 I; dt I] (od.snc_gamma)
  static constexpr int GM = G1 + 1;          // km^3/s^2
  static constexpr int J2K = GM + 1;         // -1.5 J2 GM R_E^2
  static constexpr int OMEGA = J2K + 1;      // Earth rotation rate
  static constexpr int RE = OMEGA + 1;       // Earth radius
  static constexpr int FIXED = RE + 1;       // then latitude, longitude, altitude [S] each
  static constexpr int LEN_MAX = FIXED + 3 * MAX_S;
  // Derived in the prologue.
  static constexpr int R0 = LEN_MAX;         // [6] diagonal of R0 = chol(P0^-1)'
  static constexpr int RW = R0 + 6;          // [3][3] R_w = chol(Q)^-1
  static constexpr int W = RW + 9;           // [2][2] whitening chol(R)^-1
  static constexpr int ECEF = W + 4;         // [MAX_S][3] station positions
  static constexpr int SHARED = (ECEF + 3 * MAX_S + 1) / 2 * 2;  // 16-byte aligned stage after it
};

// Output fields, in the order of `Out` and of the stage.
enum Field { EST, DEV, COV, INNOV, REF, PHI, SQINFO, MEAS, OBSDEV, RK, PRED, NFIELDS };
__host__ __device__ constexpr int width(int f) {
  return f == COV || f == PHI || f == RK || f == PRED ? 36 : (f == INNOV || f == MEAS || f == OBSDEV ? 2 : 6);
}
__host__ __device__ constexpr int stage_off(int f) {
  int off = 0;
  for (int g = 0; g < f; ++g) off += LANES * width(g);
  return off;
}
constexpr int STAGE = stage_off(NFIELDS);  // 32 x 174 doubles

struct Out {
  double* f[NFIELDS];
};

struct In {
  const double* x0;       // [K, 6]
  const double* obs;      // obs[k * obs_k + t * obs_t + {0, 1}]
  const long long* idx;   // idx[k * idx_k + t * idx_t], int64
  const uint8_t* has;     // has[k * has_k + t * has_t]
  const double* trig;     // [T][2]: cos and sin of the Earth angle at step t
  long long obs_k, obs_t, idx_k, idx_t, has_k, has_t;  // object strides 0: a shared schedule
};

// linalg.sign_db: |v| <= 1e-12 -> +1, else torch.sign (0 for NaN).
__device__ __forceinline__ double sign_db(double v) {
  return fabs(v) <= 1e-12 ? 1.0 : (v > 0.0 ? 1.0 : (v < 0.0 ? -1.0 : 0.0));
}

// linalg.householder_triangularize of the first K columns of a.
template <int ROWS, int COLS, int K>
__device__ __forceinline__ void householder(double (&a)[ROWS][COLS]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    // Two interleaved partial sums halve each dependent chain.
    double ss0 = 0.0, ss1 = 0.0;
#pragma unroll
    for (int i = k; i < ROWS; i += 2) ss0 = fma(a[i][k], a[i][k], ss0);
#pragma unroll
    for (int i = k + 1; i < ROWS; i += 2) ss1 = fma(a[i][k], a[i][k], ss1);
    const double ss = ss0 + ss1;
    const double akk = a[k][k];
    const double sigma = sqrt(ss) * sign_db(akk);
    const double ukk = akk + sigma;
    const double denom = sigma * ukk;
    const double beta = denom == 0.0 ? 0.0 : 1.0 / denom;
#pragma unroll
    for (int j = k + 1; j < COLS; ++j) {
      double g0 = ukk * a[k][j], g1 = 0.0;
#pragma unroll
      for (int i = k + 1; i < ROWS; i += 2) g1 = fma(a[i][k], a[i][j], g1);
#pragma unroll
      for (int i = k + 2; i < ROWS; i += 2) g0 = fma(a[i][k], a[i][j], g0);
      const double g = (g0 + g1) * beta;
      a[k][j] = fma(-ukk, g, a[k][j]);
#pragma unroll
      for (int i = k + 1; i < ROWS; ++i) a[i][j] = fma(-a[i][k], g, a[i][j]);
    }
    a[k][k] = -sigma;
#pragma unroll
    for (int i = k + 1; i < ROWS; ++i) a[i][k] = 0.0;
  }
}

// The measurement update's Householder pass over [[R, b], [W H~, W y]]
// (8 x 7, its first 6 columns) in householder()'s convention, for an upper
// triangular R: below the diagonal only the two measurement rows m are
// nonzero, so each reflection touches row k and m alone (the rows between
// hold exact zeros, which the full pass leaves as they are).
__device__ __forceinline__ void measurement_pass(double (&r)[6][6], double (&b)[6],
                                                 double (&m)[2][7]) {
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const double akk = r[k][k];
    const double ss = fma(akk, akk, fma(m[0][k], m[0][k], m[1][k] * m[1][k]));
    const double sigma = sqrt(ss) * sign_db(akk);
    const double ukk = akk + sigma;
    const double denom = sigma * ukk;
    const double beta = denom == 0.0 ? 0.0 : 1.0 / denom;
#pragma unroll
    for (int j = k + 1; j < 7; ++j) {
      double& top = j < 6 ? r[k][j] : b[k];
      const double g = fma(m[1][k], m[1][j], fma(m[0][k], m[0][j], ukk * top)) * beta;
      top = fma(-ukk, g, top);
      m[0][j] = fma(-m[0][k], g, m[0][j]);
      m[1][j] = fma(-m[1][k], g, m[1][j]);
    }
    r[k][k] = -sigma;
    m[0][k] = 0.0;
    m[1][k] = 0.0;
  }
}

// gravity.acceleration (degree 2) at r, each operation as the scan path
// rounds it, and its gradient G = da/dr.
__device__ __forceinline__ void gravity(const double* prm, const double (&r)[3], double (&a)[3],
                                        double (&g)[3][3]) {
  const double gm = prm[Plan::GM], j2k = prm[Plan::J2K];
  // torch.sum over the three: (x^2 + z^2) + y^2 on the card.
  const double s = __dadd_rn(__dadd_rn(__dmul_rn(r[0], r[0]), __dmul_rn(r[2], r[2])),
                             __dmul_rn(r[1], r[1]));
  const double p = pow(s, -1.5);
  const double m = __dmul_rn(-gm, p);
  const double z = r[2];
  const double q = __ddiv_rn(__dmul_rn(z, z), s);
  const double t = __dsub_rn(1.0, __dmul_rn(5.0, q));
  const double k2 = __ddiv_rn(__dmul_rn(j2k, p), s);
  const double tz = __dadd_rn(t, 2.0);
  const double c[3] = {__dmul_rn(r[0], t), __dmul_rn(r[1], t), __dmul_rn(z, tz)};
#pragma unroll
  for (int i = 0; i < 3; ++i) a[i] = __dadd_rn(__dmul_rn(r[i], m), __dmul_rn(k2, c[i]));
  // Forward derivatives of the same expressions along r_j.
  const double inv_s = 1.0 / s;
  double dm[3], dt[3], dk2[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const double ds = 2.0 * r[j];
    const double dp = -1.5 * p * inv_s * ds;
    dm[j] = -gm * dp;
    const double dq = ((j == 2 ? 2.0 * z : 0.0) - q * ds) * inv_s;
    dt[j] = -5.0 * dq;
    dk2[j] = (j2k * dp - k2 * ds) * inv_s;
  }
  const double tt[3] = {t, t, tz};
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      g[i][j] = (i == j ? m + k2 * tt[i] : 0.0) + r[i] * (dm[j] + k2 * dt[j]) + c[i] * dk2[j];
}

// One RK4 step of x (integrators.rk4_step of gravity.eom) and its STM phi.
__device__ __forceinline__ void rk4_stm(const double* prm, const double (&x)[6],
                                        double (&xn)[6], double (&phi)[6][6]) {
  const double h = prm[Plan::DT], hh = 0.5 * h, h6 = h / 6.0;
  double a[3], g[3][3], k[6], ks[6], kp[6][6], kt[6][6];
  {
    const double r[3] = {x[0], x[1], x[2]};
    gravity(prm, r, a, g);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    k[i] = x[3 + i];
    k[3 + i] = a[i];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) ks[i] = k[i];
#pragma unroll
  for (int r = 0; r < 6; ++r)
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      kp[r][c] = r < 3 ? (c == r + 3 ? 1.0 : 0.0) : (c < 3 ? g[r - 3][c] : 0.0);
      kt[r][c] = kp[r][c];
    }
#pragma unroll
  for (int s = 1; s < 4; ++s) {
    const double cs = s < 3 ? hh : h;
    double xs[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) xs[i] = fma(cs, k[i], x[i]);  // torch.add(x, k, alpha=cs)
    {
      const double r[3] = {xs[0], xs[1], xs[2]};
      gravity(prm, r, a, g);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      k[i] = xs[3 + i];
      k[3 + i] = a[i];
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) ks[i] = s < 3 ? fma(2.0, k[i], ks[i]) : __dadd_rn(ks[i], k[i]);
    // Stage tangents X = I + cs K_prev, column by column, then K = A(xs) X.
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      double xi[6];
#pragma unroll
      for (int r = 0; r < 6; ++r) xi[r] = fma(cs, kp[r][c], r == c ? 1.0 : 0.0);
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        kp[r][c] = xi[3 + r];
        kp[3 + r][c] = g[r][0] * xi[0] + g[r][1] * xi[1] + g[r][2] * xi[2];
      }
#pragma unroll
      for (int r = 0; r < 6; ++r) kt[r][c] = s < 3 ? fma(2.0, kp[r][c], kt[r][c]) : kt[r][c] + kp[r][c];
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) xn[i] = fma(h6, ks[i], x[i]);  // torch.add(x, ks, alpha=h/6)
#pragma unroll
  for (int r = 0; r < 6; ++r)
#pragma unroll
    for (int c = 0; c < 6; ++c) phi[r][c] = fma(h6, kt[r][c], r == c ? 1.0 : 0.0);
}

// Phi^-1 (srif._time_update's inv(Phi)): Phi = P' L U by partial
// pivoting, then U^-1 L^-1 P, the row interchanges undone on the columns
// in reverse order.  Select-based swaps keep every index static.
__device__ __forceinline__ void phi_inverse(const double (&phi)[6][6], double (&z)[6][6]) {
  double lu[6][6];
  int piv[6];
#pragma unroll
  for (int r = 0; r < 6; ++r)
#pragma unroll
    for (int c = 0; c < 6; ++c) lu[r][c] = phi[r][c];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    int p = k;
    double best = fabs(lu[k][k]);
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const double v = fabs(lu[i][k]);
      if (v > best) {
        best = v;
        p = i;
      }
    }
    piv[k] = p;
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const bool sw = p == i;
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        const double top = lu[k][c], low = lu[i][c];
        lu[k][c] = sw ? low : top;
        lu[i][c] = sw ? top : low;
      }
    }
    const double inv = 1.0 / lu[k][k];
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const double l = lu[i][k] * inv;
      lu[i][k] = l;
#pragma unroll
      for (int c = k + 1; c < 6; ++c) lu[i][c] = fma(-l, lu[k][c], lu[i][c]);
    }
  }
  // U^-1 (upper), column by column.
  double dinv[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) dinv[j] = 1.0 / lu[j][j];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
#pragma unroll
    for (int i = j + 1; i < 6; ++i) z[i][j] = 0.0;
    z[j][j] = dinv[j];
#pragma unroll
    for (int i = j - 1; i >= 0; --i) {
      double s = 0.0;
#pragma unroll
      for (int k = i + 1; k <= j; ++k) s = fma(lu[i][k], z[k][j], s);
      z[i][j] = -s * dinv[i];
    }
  }
  // z L = U^-1 (unit lower), backward over the columns of each row.
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 4; j >= 0; --j) {
      double s = z[i][j];
#pragma unroll
      for (int k = j + 1; k < 6; ++k) s = fma(-z[i][k], lu[k][j], s);
      z[i][j] = s;
    }
#pragma unroll
  for (int k = 4; k >= 0; --k)
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const bool sw = piv[k] == i;
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        const double a = z[r][k], b = z[r][i];
        z[r][k] = sw ? b : a;
        z[r][i] = sw ? a : b;
      }
    }
}

// linalg.chol_lower of the N x N matrix a (its lower triangle), then the
// inverse of the factor by forward substitution (srif._lower_inv); NaN
// throughout where a is not positive definite, as chol_lower gives.
template <int N>
__device__ void lower_inv(const double* a, double* out) {
  double l[N][N] = {}, x[N][N] = {};
  bool bad = false;
  for (int j = 0; j < N; ++j) {
    double d = a[j * N + j];
    for (int k = 0; k < j; ++k) d -= l[j][k] * l[j][k];
    bad |= !(d > 0.0);
    l[j][j] = sqrt(d);
    for (int i = j + 1; i < N; ++i) {
      double v = a[i * N + j];
      for (int k = 0; k < j; ++k) v -= l[i][k] * l[j][k];
      l[i][j] = v / l[j][j];
    }
  }
  for (int c = 0; c < N; ++c)
    for (int i = c; i < N; ++i) {
      double v = i == c ? 1.0 : 0.0;
      for (int k = c; k < i; ++k) v -= l[i][k] * x[k][c];
      x[i][c] = v / l[i][i];
    }
  const double nan = __longlong_as_double(0x7ff8000000000000LL);
  for (int i = 0; i < N * N; ++i) out[i] = bad ? nan : x[i / N][i % N];
}

// What srif.new and Station.ecef_position derive from the inputs, into
// the parameter area: R0's diagonal sqrt(1 / P0_ii) (the Cholesky factor
// of a diagonal matrix), R_w, W and the stations' ECEF positions.
__device__ void derive(double* prm, int stations) {
  for (int i = 0; i < 6; ++i) prm[Plan::R0 + i] = sqrt(1.0 / prm[Plan::P0 + i]);
  lower_inv<3>(prm + Plan::Q, prm + Plan::RW);
  lower_inv<2>(prm + Plan::RN, prm + Plan::W);
  for (int j = 0; j < stations; ++j) {
    const double lat = prm[Plan::FIXED + j], lon = prm[Plan::FIXED + stations + j];
    const double rho = __dadd_rn(prm[Plan::RE], prm[Plan::FIXED + 2 * stations + j]);
    const double cl = cos(lat);
    double* e = prm + Plan::ECEF + 3 * j;
    e[0] = __dmul_rn(rho, __dmul_rn(cl, cos(lon)));
    e[1] = __dmul_rn(rho, __dmul_rn(cl, sin(lon)));
    e[2] = __dmul_rn(rho, sin(lat));
  }
}

// A lane's row of a hand-off field: its double2 i at p + 2 * LANES * i.
struct Hand {
  double* p;
};

template <int N>
__device__ __forceinline__ void put(Hand dst, const double* v) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i)
    reinterpret_cast<double2*>(dst.p)[LANES * i] = make_double2(v[2 * i], v[2 * i + 1]);
}

template <int N>
__device__ __forceinline__ void get(Hand src, double* v) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const double2 e = reinterpret_cast<const double2*>(src.p)[LANES * i];
    v[2 * i] = e.x;
    v[2 * i + 1] = e.y;
  }
}

template <int N>
__device__ __forceinline__ void put(double* dst, const double* v) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) reinterpret_cast<double2*>(dst)[i] = make_double2(v[2 * i], v[2 * i + 1]);
}

template <int N>
__device__ __forceinline__ void get(const double* src, double* v) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const double2 e = reinterpret_cast<const double2*>(src)[i];
    v[2 * i] = e.x;
    v[2 * i + 1] = e.y;
  }
}

// The hand-offs between the four stages of the step pipeline, per object:
// fields of `width` doubles, 32 objects' each, in the producer's staging
// slot and in the consumer's ring of two slots (steps s mod 2), one of
// each a warp.  In a field the warp's lanes sit side by side a double2 at
// a time (`Hand`), so each 16-byte warp store into the next block is one
// contiguous run of 512 bytes (a row a lane, 288 bytes apart, took the
// filter ~3,000 cycles a step more when it wrote the next block itself).
//   B1  trajectory -> linearize: Phi, x_ref
//   B2  linearize -> filter: Phi^-1, W H~, W (y - h), has, and Phi, x_ref,
//       the measurement passed on
//   B3  filter -> read-out: R, b, R_bar, and Phi, x_ref, the measurement
//       and the whitened residual passed on
enum B1F { B1_PHI, B1_REF, NB1 };
enum B2F { B2_INV, B2_HW, B2_YW, B2_HAS, B2_PHI, B2_REF, B2_MEAS, NB2 };
enum B3F { B3_RK, B3_SQ, B3_PRED, B3_PHI, B3_REF, B3_MEAS, B3_YW, NB3 };
__host__ __device__ constexpr int b1_width(int f) { return f == B1_PHI ? 36 : 6; }
__host__ __device__ constexpr int b2_width(int f) {
  return f == B2_INV || f == B2_PHI ? 36 : (f == B2_HW ? 12 : (f == B2_REF ? 6 : 2));
}
__host__ __device__ constexpr int b3_width(int f) {
  return f == B3_RK || f == B3_PRED || f == B3_PHI ? 36 : (f == B3_SQ || f == B3_REF ? 6 : 2);
}
__host__ __device__ constexpr int b1_off(int f) {
  int off = 0;
  for (int g = 0; g < f; ++g) off += LANES * b1_width(g);
  return off;
}
__host__ __device__ constexpr int b2_off(int f) {
  int off = 0;
  for (int g = 0; g < f; ++g) off += LANES * b2_width(g);
  return off;
}
__host__ __device__ constexpr int b3_off(int f) {
  int off = 0;
  for (int g = 0; g < f; ++g) off += LANES * b3_width(g);
  return off;
}
constexpr int B1 = b1_off(NB1), B2 = b2_off(NB2), B3 = b3_off(NB3);  // one slot each
constexpr int STATE = LANES * 42;  // the filter's own (R, b) of each object

// A cluster of four blocks, block rank r on stage r, each block `groups`
// compute warps of 32 objects and as many mover warps.  Every block's
// shared memory: the parameters, the barriers, then a warp's each of: its
// input ring (two slots of B1, B2 or B3 in ranks 1-3), its output's
// staging slot (ranks 0-2), and the filter's state (rank 2) or the output
// stage (rank 3).  A ring's `full` barriers sit with it, in the consumer;
// its `empty` ones with the producer's mover, which fills it.
constexpr int RANKS = 4;
constexpr int MAX_W = 2;  // compute warps a block: the read-out block's rings hold no more
constexpr int BARS = Plan::SHARED;
constexpr int RING = BARS + 4 * MAX_W;  // uint64 full[MAX_W][2], empty[MAX_W][2]
__host__ __device__ constexpr int in_width(int rank) {
  return rank == 1 ? B1 : (rank == 2 ? B2 : (rank == 3 ? B3 : 0));
}
__host__ __device__ constexpr int out_width(int rank) { return in_width(rank + 1); }
__host__ __device__ constexpr int block_doubles(int rank, int groups) {
  return RING + groups * (2 * in_width(rank) + out_width(rank) +
                          (rank == 2 ? STATE : (rank == 3 ? STAGE : 0)));
}

// Phase clocks of the diagnostic build, lane 0 of warp 0 (a compute warp)
// of each block of cluster 0: each stage's waits on its input's `full`
// barrier and for its mover to have taken the last step out of staging,
// and its phases; then the read-out block's whole loop.
enum Clocks {
  TRAJ_WAIT_EMPTY, TRAJ_RK4,                                      // rank 0
  LIN_WAIT_FULL, LIN_WAIT_EMPTY, LIN_PHI_INV, LIN_GEOMETRY,       // rank 1
  FILTER_WAIT_FULL, FILTER_WAIT_EMPTY, FILTER_TIME, FILTER_MEAS,  // rank 2
  READ_WAIT_FULL, READ_READOUTS, READ_STORES, LOOP,               // rank 3
  NCLOCKS
};
__device__ unsigned long long fused_od_clocks[NCLOCKS];
__host__ __device__ constexpr int first_clock(int rank) {
  return rank == 0 ? TRAJ_WAIT_EMPTY
                   : (rank == 1 ? LIN_WAIT_FULL : (rank == 2 ? FILTER_WAIT_FULL : READ_WAIT_FULL));
}

template <bool CLOCKS>
struct Clock {
  unsigned long long c[NCLOCKS] = {};
  long long mark = 0;
  __device__ __forceinline__ void start() {
    if constexpr (CLOCKS) mark = clock64();
  }
  __device__ __forceinline__ void tick(int phase, unsigned mask) {
    if constexpr (CLOCKS) {
      __syncwarp(mask);
      const long long now = clock64();
      c[phase] += now - mark;
      mark = now;
    }
  }
};

// Rank 0, step s: the reference state x (in registers) one RK4 step on,
// with its STM.
template <bool CLOCKS>
__device__ __forceinline__ void trajectory(const double* prm, double (&x)[6],
                                           const Hand (&b1)[NB1], unsigned mask,
                                           Clock<CLOCKS>& clk) {
  double xn[6], phi[6][6];
  rk4_stm(prm, x, xn, phi);
  put<36>(b1[B1_PHI], &phi[0][0]);
  put<6>(b1[B1_REF], xn);
#pragma unroll
  for (int i = 0; i < 6; ++i) x[i] = xn[i];
  clk.tick(TRAJ_RK4, mask);
}

// Rank 1, step s: Phi^-1 (srif._time_update's inv(Phi)) and, where the
// object has a measurement, the station geometry at the new reference,
// whitened: W H~, W (y - h(x_ref)).  None of it depends on the filter.
template <bool CLOCKS>
__device__ __forceinline__ void linearize(const double* prm, const Hand (&b1)[NB1],
                                          const double (&cs)[2], const double (&y)[2],
                                          long long sidx, bool has, int stations,
                                          const Hand (&b2)[NB2], unsigned mask,
                                          Clock<CLOCKS>& clk) {
  double xn[6];
  get<6>(b1[B1_REF], xn);
  {
    double phi[6][6], inv[6][6];
    get<36>(b1[B1_PHI], &phi[0][0]);
    put<36>(b2[B2_PHI], &phi[0][0]);
    put<6>(b2[B2_REF], xn);
    phi_inverse(phi, inv);
    put<36>(b2[B2_INV], &inv[0][0]);
  }
  clk.tick(LIN_PHI_INV, mask);
  double meas[2] = {0.0, 0.0}, yw[2] = {0.0, 0.0}, hw[2][6] = {};
  if (has) {
    // The station's ECI state at the step's Earth angle (cos, sin in `cs`).
    const double w = prm[Plan::OMEGA];
    const int s = sidx < 0 ? 0 : static_cast<int>(sidx < stations ? sidx : MAX_S);
    const double nan = __longlong_as_double(0x7ff8000000000000LL);
    const double* e = prm + Plan::ECEF + 3 * (s < MAX_S ? s : 0);
    const double ex = s < MAX_S ? e[0] : nan, ey = e[1], ez = e[2];
    const double ct = cs[0], sn = cs[1];
    const double rs[3] = {__dsub_rn(__dmul_rn(ct, ex), __dmul_rn(sn, ey)),
                          __dadd_rn(__dmul_rn(sn, ex), __dmul_rn(ct, ey)), ez};
    const double vs[3] = {__dmul_rn(-w, rs[1]), __dmul_rn(w, rs[0]), 0.0};
    double dr[3], dv[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      dr[i] = __dsub_rn(xn[i], rs[i]);
      dv[i] = __dsub_rn(xn[3 + i], vs[i]);
    }
    const double rho = sqrt(fma(dr[2], dr[2], fma(dr[1], dr[1], dr[0] * dr[0])));
    const double rr = __ddiv_rn(__dadd_rn(__dadd_rn(__dmul_rn(dr[0], dv[0]), __dmul_rn(dr[2], dv[2])),
                                          __dmul_rn(dr[1], dv[1])), rho);
    double ht[2][6];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const double u = __ddiv_rn(dr[i], rho);
      ht[0][i] = u;
      ht[0][3 + i] = 0.0;
      ht[1][i] = __ddiv_rn(__dsub_rn(dv[i], __dmul_rn(rr, u)), rho);
      ht[1][3 + i] = u;
    }
    meas[0] = y[0];
    meas[1] = y[1];
    const double res[2] = {y[0] - rho, y[1] - rr};
    const double* wm = prm + Plan::W;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int c = 0; c < 6; ++c) hw[i][c] = fma(wm[2 * i], ht[0][c], wm[2 * i + 1] * ht[1][c]);
      yw[i] = fma(wm[2 * i], res[0], wm[2 * i + 1] * res[1]);
    }
  }
  const double flag[2] = {has ? 1.0 : 0.0, 0.0};
  put<2>(b2[B2_MEAS], meas);
  put<2>(b2[B2_YW], yw);
  put<12>(b2[B2_HW], &hw[0][0]);
  put<2>(b2[B2_HAS], flag);
  clk.tick(LIN_GEOMETRY, mask);
}

// Rank 2, step s: the filter.  The time update R_bar = R Phi^-1 (R upper
// triangular) and Dyer-McReynolds [[R_w, 0 | 0], [-R_bar Gamma, R_bar | b]],
// then where the object has a measurement the update
// [[R_bar, b_bar], [W H~, W y]].  Its (R, b) lives in `state`.
template <bool CLOCKS>
__device__ __forceinline__ void filter(const double* prm, const Hand (&b2)[NB2],
                                       double* state, const Hand (&b3)[NB3], unsigned mask,
                                       Clock<CLOCKS>& clk) {
  double rb[6][6], b[6];
  {
    double r[6][6], inv[6][6];
    get<36>(state, &r[0][0]);
    get<36>(b2[B2_INV], &inv[0][0]);
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        double s = 0.0;
#pragma unroll
        for (int k = i; k < 6; ++k) s = fma(r[i][k], inv[k][j], s);
        rb[i][j] = s;
      }
  }
  {
    const double h = prm[Plan::DT], g1 = prm[Plan::G1];
    double a[9][10];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 10; ++j) a[i][j] = j < 3 ? prm[Plan::RW + 3 * i + j] : 0.0;
    get<6>(state + 36, b);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) a[3 + i][j] = -fma(rb[i][3 + j], h, rb[i][j] * g1);
#pragma unroll
      for (int j = 0; j < 6; ++j) a[3 + i][3 + j] = rb[i][j];
      a[3 + i][9] = b[i];
    }
    householder<9, 10, 9>(a);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int j = 0; j < 6; ++j) rb[i][j] = a[3 + i][3 + j];
      b[i] = a[3 + i][9];
    }
  }
  put<36>(b3[B3_PRED], &rb[0][0]);
  clk.tick(FILTER_TIME, mask);
  double flag[2], yw[2];
  get<2>(b2[B2_HAS], flag);
  get<2>(b2[B2_YW], yw);
  if (flag[0] != 0.0) {
    double m[2][7], hw[2][6];
    get<12>(b2[B2_HW], &hw[0][0]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int c = 0; c < 6; ++c) m[i][c] = hw[i][c];
      m[i][6] = yw[i];
    }
    measurement_pass(rb, b, m);
  }
  put<36>(state, &rb[0][0]);
  put<6>(state + 36, b);
  put<36>(b3[B3_RK], &rb[0][0]);
  put<6>(b3[B3_SQ], b);
  put<2>(b3[B3_YW], yw);
  {
    double phi[36], xn[6], meas[2];
    get<36>(b2[B2_PHI], phi);
    get<6>(b2[B2_REF], xn);
    get<2>(b2[B2_MEAS], meas);
    put<36>(b3[B3_PHI], phi);
    put<6>(b3[B3_REF], xn);
    put<2>(b3[B3_MEAS], meas);
  }
  clk.tick(FILTER_MEAS, mask);
}

// Rank 3, step s: the read-outs x = R^-1 b, S = R^-1 (upper), P = S S',
// the estimate x_ref + x, and every field of the step into the stage.
template <bool CLOCKS>
__device__ __forceinline__ void readout(const Hand (&b3)[NB3], double* const (&row)[NFIELDS],
                                        unsigned mask, Clock<CLOCKS>& clk) {
  {
    double phi[36], pred[36], yw[2], meas[2];
    get<36>(b3[B3_PHI], phi);
    get<36>(b3[B3_PRED], pred);
    get<2>(b3[B3_YW], yw);
    get<2>(b3[B3_MEAS], meas);
    put<36>(row[PHI], phi);
    put<36>(row[PRED], pred);
    put<2>(row[MEAS], meas);
    put<2>(row[OBSDEV], yw);
    put<2>(row[INNOV], yw);
  }
  double r[6][6], b[6], xn[6], dinv[6], dev[6], sinv[6][6];
  get<36>(b3[B3_RK], &r[0][0]);
  get<6>(b3[B3_SQ], b);
  get<6>(b3[B3_REF], xn);
  put<36>(row[RK], &r[0][0]);
  put<6>(row[SQINFO], b);
  put<6>(row[REF], xn);
#pragma unroll
  for (int i = 0; i < 6; ++i) dinv[i] = 1.0 / r[i][i];
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    double s = b[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s = fma(-r[i][k], dev[k], s);
    dev[i] = s * dinv[i];
  }
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    sinv[j][j] = dinv[j];
#pragma unroll
    for (int i = j - 1; i >= 0; --i) {
      double s = 0.0;
#pragma unroll
      for (int k = i + 1; k <= j; ++k) s = fma(r[i][k], sinv[k][j], s);
      sinv[i][j] = -s * dinv[i];
    }
  }
  double p[6][6];
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = i; j < 6; ++j) {
      double s = 0.0;
#pragma unroll
      for (int k = j; k < 6; ++k) s = fma(sinv[i][k], sinv[j][k], s);
      p[i][j] = s;
      p[j][i] = s;
    }
  double est[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) est[i] = __dadd_rn(xn[i], dev[i]);
  put<6>(row[DEV], dev);
  put<6>(row[EST], est);
  put<36>(row[COV], &p[0][0]);
  clk.tick(READ_READOUTS, mask);
}

// A full warp's rows of field F from the stage to device memory: every
// load of the field first, then its 16-byte streaming stores.
template <int F>
__device__ __forceinline__ void flush(const Out& out, size_t first, const double* st, int lane) {
  constexpr int IT = width(F) / 2;  // double2 a lane
  const double2* src = reinterpret_cast<const double2*>(st + stage_off(F));
  double2* dst = reinterpret_cast<double2*>(out.f[F] + first * width(F));
  double2 v[IT];
#pragma unroll
  for (int i = 0; i < IT; ++i) v[i] = src[lane + LANES * i];
#pragma unroll
  for (int i = 0; i < IT; ++i) __stcs(dst + lane + LANES * i, v[i]);
}

// The hand-off of step s from compute warp g of rank r to compute warp g
// of rank r + 1.  The stage writes it into its staging slot in its own
// shared memory and arrives on named barrier `filled`; its mover warp
// loads the slot into registers, arrives on `drained` (the stage may
// write the next step), then writes the step into slot s mod 2 of the
// consumer's ring in the next block (16 bytes a lane, each warp store one
// contiguous 512-byte run) and every lane arrives on that slot's `full`
// barrier with release semantics at cluster scope.  The consumer waits on
// `full` and reads the slot locally; once it has filled its own staging,
// its mover (the read-out warp itself, which has none) frees the slot:
// every lane arrives on the producer's `empty` barrier of the slot.  So a
// stage's stores stay local, and the waits for remote operations to
// complete, which each release implies, fall on the movers.  On an H100
// (clock64), the filter writing the next block itself cost it ~2,400-3,400
// cycles a step, its own release to the block before ~1,000, and a bulk
// copy (cp.async.bulk shared::cta -> shared::cluster) ~5,000 from its
// start to the consumer's take.
__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(shared_addr(bar)), "r"(count)
               : "memory");
}
// Waits until the phase of `parity` has completed (parity 1 of a fresh
// barrier counts as completed).
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = shared_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}
// The lane arrives on the barrier at `bar`'s place in block `rank` of the
// cluster.
__device__ __forceinline__ void bar_arrive(uint64_t* bar, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(shared_addr(bar)), "r"(rank));
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(remote)
               : "memory");
}
// Named barriers between compute warp g and its mover (64 threads): ids
// 1 + 2g (`filled`) and 2 + 2g (`drained`); 0 is __syncthreads'.
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void pair_arrive(int id) {
  asm volatile("bar.arrive %0, 64;" ::"r"(id) : "memory");
}

// Mover warp of rank `rank` - 1, step s: the staging slot `src` (N double2
// a lane) into the consumer's ring slot `dst` (a pointer into block
// `rank`), once `empty` says the consumer has read the slot's last step.
// Past rank 0 it also frees the stage's own input slot of step s in the
// block before (`upstream`): the stage has read it when it fills staging.
template <int N>
__device__ __forceinline__ void move(const double* src, double* dst, int s, int steps, int filled,
                                     int drained, uint64_t* upstream, uint64_t* empty,
                                     uint64_t* full, int lane, uint32_t rank) {
  double2 v[N];
  pair_sync(filled);
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = reinterpret_cast<const double2*>(src)[lane + LANES * i];
  if (s + 1 < steps) pair_arrive(drained);
  if (rank > 1) bar_arrive(upstream, rank - 2);
  bar_wait(empty, ((s >> 1) & 1) ^ 1);
#pragma unroll
  for (int i = 0; i < N; ++i) reinterpret_cast<double2*>(dst)[lane + LANES * i] = v[i];
  bar_arrive(full, rank);
}

// One cluster of four blocks runs the step pipeline of `groups` groups of
// 32 objects, one object a lane: block rank 0 the trajectory, 1 the
// linearization, 2 the filter, 3 the read-outs and stores, each on an SM
// of its own.  Compute warp g of a block hands step s to compute warp g of
// the next rank through its mover (see `move`), so a stage waits only on
// its input and on its mover having taken the step before.
template <bool CLOCKS>
__global__ void __cluster_dims__(RANKS, 1, 1) __launch_bounds__(2 * MAX_W * LANES, 1)
fused_srif_od_kernel(const double* __restrict__ params, In in, int steps, int objects,
                     int stations, Out out) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) double smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int groups = blockDim.x / (2 * LANES);
  const int warp = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  const bool mover = warp >= groups;
  const int group = mover ? warp - groups : warp;
  for (int e = threadIdx.x; e < Plan::FIXED + 3 * stations; e += blockDim.x) smem[e] = params[e];
  __syncthreads();
  uint64_t* const bars = reinterpret_cast<uint64_t*>(smem + BARS);
  uint64_t* const full = bars + 2 * group;              // this group's input ring
  uint64_t* const empty = bars + 2 * MAX_W + 2 * group;  // the ring it fills in rank + 1
  if (threadIdx.x == 0) {
    derive(smem, stations);
    for (int i = 0; i < 4 * MAX_W; ++i) bar_init(bars + i, LANES);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster.sync();  // every block's parameters derived and barriers set
  const double* prm = smem;
  double* const ring = smem + RING + group * 2 * in_width(rank);
  double* const staging = smem + RING + groups * 2 * in_width(rank) + group * out_width(rank);
  const int filled = 1 + 2 * group, drained = 2 + 2 * group;
  const int b0 = (blockIdx.x / RANKS * groups + group) * LANES;
  const int count = min(LANES, objects - b0);
  Clock<CLOCKS> clk;
  const long long start = CLOCKS ? clock64() : 0;
  if (count > 0 && mover && rank < RANKS - 1) {
    // This group's ring in the next block.
    double* const next =
        cluster.map_shared_rank(smem + RING + group * 2 * out_width(rank), rank + 1);
    for (int s = 0; s < steps; ++s) {
      const int d = s & 1;
      if (rank == 0)
        move<B1 / (2 * LANES)>(staging, next + d * B1, s, steps, filled, drained, nullptr,
                               empty + d, full + d, lane, 1);
      else if (rank == 1)
        move<B2 / (2 * LANES)>(staging, next + d * B2, s, steps, filled, drained, empty + d,
                               empty + d, full + d, lane, 2);
      else
        move<B3 / (2 * LANES)>(staging, next + d * B3, s, steps, filled, drained, empty + d,
                               empty + d, full + d, lane, 3);
    }
  } else if (count > 0 && !mover) {
    const bool live = lane < count;
    const unsigned mask = count >= LANES ? 0xffffffffu : (1u << count) - 1u;  // the live lanes
    const long long k = b0 + (live ? lane : 0);
    // Step s's slot of the input ring, once filled.
    auto take = [&](int s) {
      bar_wait(full + (s & 1), (s >> 1) & 1);
      return ring + (s & 1) * in_width(rank);
    };
    // The staging slot is free once the mover has taken step s - 1.
    auto stage = [&](int s) {
      if (s > 0) pair_sync(drained);
    };
    if (rank == 0) {
      double x[6];
      if (live) {
#pragma unroll
        for (int i = 0; i < 6; ++i) x[i] = in.x0[6 * k + i];
      }
      Hand b1[NB1];
#pragma unroll
      for (int f = 0; f < NB1; ++f) b1[f] = {staging + b1_off(f) + 2 * lane};
      for (int s = 0; s < steps; ++s) {
        clk.start();
        stage(s);
        clk.tick(TRAJ_WAIT_EMPTY, 0xffffffffu);
        if (live) trajectory<CLOCKS>(prm, x, b1, mask, clk);
        pair_arrive(filled);
      }
    } else if (rank == 1) {
      Hand b2[NB2];
#pragma unroll
      for (int f = 0; f < NB2; ++f) b2[f] = {staging + b2_off(f) + 2 * lane};
      for (int s = 0; s < steps; ++s) {
        const double y[2] = {__ldg(in.obs + k * in.obs_k + s * in.obs_t),
                             __ldg(in.obs + k * in.obs_k + s * in.obs_t + 1)};
        const double cs[2] = {__ldg(in.trig + 2 * s), __ldg(in.trig + 2 * s + 1)};
        const long long sidx = __ldg(in.idx + k * in.idx_k + s * in.idx_t);
        const bool hs = __ldg(in.has + k * in.has_k + s * in.has_t) != 0;
        clk.start();
        double* const src = take(s);
        clk.tick(LIN_WAIT_FULL, 0xffffffffu);
        stage(s);
        clk.tick(LIN_WAIT_EMPTY, 0xffffffffu);
        Hand b1[NB1];
#pragma unroll
        for (int f = 0; f < NB1; ++f) b1[f] = {src + b1_off(f) + 2 * lane};
        if (live) linearize<CLOCKS>(prm, b1, cs, y, sidx, hs, stations, b2, mask, clk);
        pair_arrive(filled);  // and the input slot is read: the mover frees it
      }
    } else if (rank == 2) {
      double* const state = smem + RING + groups * (2 * B2 + B3) + group * STATE + lane * 42;
      if (live) {
        double r0[36], b[6] = {};  // b0 = R0 x0 with the deviation x0 = 0
#pragma unroll
        for (int i = 0; i < 36; ++i) r0[i] = i % 7 == 0 ? prm[Plan::R0 + i / 7] : 0.0;
        put<36>(state, r0);
        put<6>(state + 36, b);
      }
      Hand b3[NB3];
#pragma unroll
      for (int f = 0; f < NB3; ++f) b3[f] = {staging + b3_off(f) + 2 * lane};
      for (int s = 0; s < steps; ++s) {
        clk.start();
        double* const src = take(s);
        clk.tick(FILTER_WAIT_FULL, 0xffffffffu);
        stage(s);
        clk.tick(FILTER_WAIT_EMPTY, 0xffffffffu);
        Hand b2[NB2];
#pragma unroll
        for (int f = 0; f < NB2; ++f) b2[f] = {src + b2_off(f) + 2 * lane};
        if (live) filter<CLOCKS>(prm, b2, state, b3, mask, clk);
        pair_arrive(filled);  // and the input slot is read: the mover frees it
      }
    } else {
      double* const st = smem + RING + groups * 2 * B3 + group * STAGE;  // this warp's stage
      double* row[NFIELDS];
#pragma unroll
      for (int f = 0; f < NFIELDS; ++f) row[f] = st + stage_off(f) + lane * width(f);
      for (int s = 0; s < steps; ++s) {
        clk.start();
        double* const src = take(s);
        clk.tick(READ_WAIT_FULL, 0xffffffffu);
        Hand b3[NB3];
#pragma unroll
        for (int f = 0; f < NB3; ++f) b3[f] = {src + b3_off(f) + 2 * lane};
        if (live) readout<CLOCKS>(b3, row, mask, clk);
        bar_arrive(empty + (s & 1), 2);  // the slot is read: all of it is in the stage
        __syncwarp();
        // The step's rows: each field one contiguous run of `count` rows at
        // row s K + b0, in 16-byte streaming stores.
        const size_t first = static_cast<size_t>(s) * objects + b0;
        if (count == LANES) {
          flush<EST>(out, first, st, lane);
          flush<DEV>(out, first, st, lane);
          flush<COV>(out, first, st, lane);
          flush<INNOV>(out, first, st, lane);
          flush<REF>(out, first, st, lane);
          flush<PHI>(out, first, st, lane);
          flush<SQINFO>(out, first, st, lane);
          flush<MEAS>(out, first, st, lane);
          flush<OBSDEV>(out, first, st, lane);
          flush<RK>(out, first, st, lane);
          flush<PRED>(out, first, st, lane);
        } else {
#pragma unroll
          for (int f = 0; f < NFIELDS; ++f) {
            const int n2 = count * width(f) / 2;
            const double2* src2 = reinterpret_cast<const double2*>(st + stage_off(f));
            double2* dst2 = reinterpret_cast<double2*>(out.f[f] + first * width(f));
            for (int e = lane; e < n2; e += LANES) __stcs(dst2 + e, src2[e]);
          }
        }
        __syncwarp();
        clk.tick(READ_STORES, 0xffffffffu);
      }
    }
  }
  if constexpr (CLOCKS) {
    if (blockIdx.x < RANKS && threadIdx.x == 0) {
      if (rank == RANKS - 1) clk.c[LOOP] = clock64() - start;
      const int lo = first_clock(rank), hi = rank == RANKS - 1 ? NCLOCKS : first_clock(rank + 1);
#pragma unroll
      for (int i = 0; i < NCLOCKS; ++i)
        if (i >= lo && i < hi) fused_od_clocks[i] = clk.c[i];
    }
  }
  cluster.sync();  // no block leaves while a neighbour may still reach its shared memory
}

// The dynamic shared memory of a launch of `groups` warps a block, into
// `bytes`: the largest block's (the read-out's), and at least half an SM's
// so that no two blocks share an SM; 0 where it does not fit on the current
// device.
cudaError_t layout(int groups, int& bytes) {
  bytes = 0;
  int device = 0, limit = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  if (e != cudaSuccess || groups < 1 || groups > MAX_W) return e;
  int most = per_sm / 2;
  for (int r = 0; r < RANKS; ++r) {
    const int n = static_cast<int>(sizeof(double)) * block_doubles(r, groups);
    most = n > most ? n : most;
  }
  bytes = most <= limit ? most : 0;
  return cudaSuccess;
}

}  // namespace

#ifndef FUSED_OD_CLOCKS
#define FUSED_OD_CLOCKS 0
#endif

// The parameter block's length with `stations` stations.
extern "C" int fused_od_param_len(int stations) { return Plan::FIXED + 3 * stations; }
extern "C" int fused_od_max_stations() { return MAX_S; }

// How many clusters of `groups` warps a block can be resident at once on
// the current device (cudaOccupancyMaxActiveClusters at that launch's
// shared memory), into *clusters; 0 where the rings do not fit.
extern "C" int fused_od_clusters(int groups, int* clusters) {
  *clusters = 0;
  int bytes = 0;
  cudaError_t e = layout(groups, bytes);
  if (e != cudaSuccess || bytes == 0) return static_cast<int>(e);
  auto kernel = fused_srif_od_kernel<FUSED_OD_CLOCKS != 0>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(RANKS);
  cfg.blockDim = dim3(2 * groups * LANES);
  cfg.dynamicSmemBytes = bytes;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg));
}

// Every pointer is a device pointer: params (fused_od_param_len(stations)
// doubles), x0 [K, 6], the schedule (obs, station index int64, mask uint8)
// read at k * <field>_k + t * <field>_t, the Earth angle's cos and sin
// [T, 2], and the eleven outputs [T, K, ...] in `Field` order, each
// 16-byte aligned.  ceil(K / (32 groups)) clusters of four blocks of
// `groups` warps (1 to MAX_W; cudaErrorInvalidValue where the rings do not
// fit).
extern "C" int fused_od_launch(const double* params, const double* x0, const double* obs,
                               const long long* idx, const uint8_t* has, const double* trig,
                               long long obs_k, long long obs_t, long long idx_k,
                               long long idx_t, long long has_k, long long has_t, int steps,
                               int objects, int stations, int groups, double* est, double* dev,
                               double* cov, double* innov, double* ref, double* phi,
                               double* sqinfo, double* meas, double* obs_dev, double* rk,
                               double* pred, void* stream) {
  const In in{x0, obs, idx, has, trig, obs_k, obs_t, idx_k, idx_t, has_k, has_t};
  const Out out{{est, dev, cov, innov, ref, phi, sqinfo, meas, obs_dev, rk, pred}};
  int bytes = 0;
  cudaError_t e = layout(groups, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (bytes == 0) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = fused_srif_od_kernel<FUSED_OD_CLOCKS != 0>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int per = LANES * groups;
  const dim3 grid(RANKS * ((objects + per - 1) / per));
  kernel<<<grid, 2 * per, bytes, static_cast<cudaStream_t>(stream)>>>(params, in, steps,
                                                                      objects, stations, out);
  return static_cast<int>(cudaGetLastError());
}

// The diagnostic build's phase clocks of its last launch (NCLOCKS counters).
extern "C" int fused_od_read_clocks(unsigned long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, fused_od_clocks, sizeof(fused_od_clocks)));
}
