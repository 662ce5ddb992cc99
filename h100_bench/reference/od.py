"""Plain square-root information filter (SRIF) orbit determination of a
catalog, and the scenes it is run on.

The scenario is gokalman's SRIF OD test (srif_test.go:66-341): two-body
+ J2 gravity, RK4 at a fixed step, range and range-rate from the first
ground station above its elevation mask, R = diag(σ_ρ², σ_ρ̇²) and a
diagonal P0.  A catalog runs it for every object of a Walker-delta
shell i:T/P/F (Walker 1984, J. Br. Interplanet. Soc. 37) at the
reference's orbit; objects are independent and are held on a leading
batch axis only so that the reference finishes in time; the loop runs
over the time steps.

The filter (Tapley, Schutz & Born, "Statistical Orbit Determination",
§5.7; Bierman 1977) carries (R, b) with x = R⁻¹ b, P = R⁻¹ R⁻ᵀ, the
deviation from a reference trajectory that is never reset (a CKF).  A
step:

- propagates the reference by RK4 and its state transition matrix Φ,
  the Jacobian of the discrete RK4 step, carried by hand through the four
  stages with the analytic gradient of the J2 gravity (`rk4_stm`);
- time update with state-noise compensation: u ~ N(0, σ² I) enters as
  x_{k+1} = Φ x_k + Γ u, Γ = [Δt²/2 I; Δt I]; with R̄ = R Φ⁻¹ (solved
  from R̄ Φ = R) and R_w = chol(Q)⁻¹, the R factor of the QR of

      [ R_w      0   0 ]
      [ −R̄ Γ    R̄   b ]

  holds the propagated (R̄', b̄') in its last n rows and columns (the
  Dyer–McReynolds update; b̄ = R̄ Φ x̂ = R x̂ = b);
- where a station sees the object: the measurement update, the R factor
  of the QR of [[R̄', b̄'], [W H̃, W (y − h(x_ref))]], W = chol(R)⁻¹, H̃
  the analytic range / range-rate Jacobian at the reference;
- reads x and P out by triangular solves of R.

Departures from srif.go and TSB: srif.go refuses process noise
(srif.go:77-79) and here SNC is always on; the QRs are
`torch.linalg.qr`'s (LAPACK / cuBLAS Householder), so rows of (R, b) may
carry other signs than srif.go's Householder (helper.go:142-172) gives,
which changes neither x nor P; Φ⁻¹ is never formed; a step without a
measurement is the time update alone (srif.go's Prepare without a
measurement); the truth and the filter share the force model and the
integrator, as the reference's own tests do.
"""

from __future__ import annotations

import contextlib
import math

import torch

F64 = torch.float64


@contextlib.contextmanager
def no_tf32():
    """Full-precision products: TF32 off for cuBLAS and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def acceleration(r: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Two-body + J2 acceleration [km/s²] at ECI positions r [..., 3]."""
    gm, re, j2 = cfg["gm"], cfg["r_earth"], cfg["j2"]
    r2 = (r * r).sum(-1, keepdim=True)
    rn = torch.sqrt(r2)
    u = r[..., 2:] ** 2 / r2
    g = torch.cat([1.0 - 5.0 * u, 1.0 - 5.0 * u, 3.0 - 5.0 * u], -1)
    f = -1.5 * j2 * gm * re * re / (r2 * r2 * rn)
    return -gm * r / (r2 * rn) + f * r * g


def gravity_gradient(r: torch.Tensor, cfg: dict) -> torch.Tensor:
    """∂a/∂r [..., 3, 3] of `acceleration`, in closed form.

    Two-body: −μ/r³ I + 3μ r rᵀ/r⁵.  J2: a_i = f r_i g_i with f = k/r⁵,
    u = z²/r², g = (1 − 5u, 1 − 5u, 3 − 5u), so
    ∂a_i/∂r_j = f (δ_ij g_i − 5 r_i g_i r_j/r² − 10 r_i (z δ_j3 − u r_j)/r²)."""
    gm, re, j2 = cfg["gm"], cfg["r_earth"], cfg["j2"]
    r2 = (r * r).sum(-1)[..., None, None]
    rn = torch.sqrt(r2)
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    rr = r[..., :, None] * r[..., None, :]
    two_body = -gm / (r2 * rn) * eye + 3.0 * gm / (r2 * r2 * rn) * rr
    z = r[..., 2]
    u = (z * z)[..., None, None] / r2
    g = torch.stack([1.0 - 5.0 * u[..., 0, 0], 1.0 - 5.0 * u[..., 0, 0],
                     3.0 - 5.0 * u[..., 0, 0]], -1)
    f = -1.5 * j2 * gm * re * re / (r2 * r2 * rn)
    ez = torch.zeros_like(r)
    ez[..., 2] = z
    j2_part = f * (torch.diag_embed(g) - 5.0 / r2 * (r * g)[..., :, None] * r[..., None, :]
                   - 10.0 / r2 * r[..., :, None] * ez[..., None, :] + 10.0 * u / r2 * rr)
    return two_body + j2_part


def _deriv(x: torch.Tensor, cfg: dict) -> torch.Tensor:
    return torch.cat([x[..., 3:], acceleration(x[..., :3], cfg)], -1)


def rk4(x: torch.Tensor, dt: float, cfg: dict) -> torch.Tensor:
    """One RK4 step of the PV states x [..., 6]."""
    k1 = _deriv(x, cfg)
    k2 = _deriv(x + 0.5 * dt * k1, cfg)
    k3 = _deriv(x + 0.5 * dt * k2, cfg)
    k4 = _deriv(x + dt * k3, cfg)
    return x + dt / 6.0 * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def rk4_stm(x: torch.Tensor, dt: float, cfg: dict):
    """(x_next, Φ) of one RK4 step: Φ = ∂x_next/∂x [..., 6, 6], the
    tangents carried through the stages by hand.  Stage i evaluates
    k_i = f(x_i) at x_i = x + c_i Δt k_{i−1}, whose Jacobian is
    K_i = A(x_i) (I + c_i Δt K_{i−1}) with A = [[0, I], [G(r_i), 0]]."""
    eye = torch.eye(6, dtype=x.dtype, device=x.device).expand(x.shape[:-1] + (6, 6))
    ks, jacs = [], []
    xi, mi = x, eye
    for c_next in (0.5, 0.5, 1.0, None):
        k = _deriv(xi, cfg)
        jac = torch.cat([mi[..., 3:, :], gravity_gradient(xi[..., :3], cfg) @ mi[..., :3, :]],
                        -2)
        ks.append(k)
        jacs.append(jac)
        if c_next is not None:
            xi = x + c_next * dt * k
            mi = eye + c_next * dt * jac
    x_next = x + dt / 6.0 * (ks[0] + 2.0 * ks[1] + 2.0 * ks[2] + ks[3])
    phi = eye + dt / 6.0 * (jacs[0] + 2.0 * jacs[1] + 2.0 * jacs[2] + jacs[3])
    return x_next, phi


def oe_to_rv(a, e, i, raan, argp, nu, gm: float) -> torch.Tensor:
    """Classical elements (tensors [K], radians) to PV states [K, 6]."""
    p = a * (1.0 - e * e)
    rad = p / (1.0 + e * torch.cos(nu))
    r_pqw = torch.stack([rad * torch.cos(nu), rad * torch.sin(nu), torch.zeros_like(nu)], -1)
    s = torch.sqrt(gm / p)
    v_pqw = torch.stack([-s * torch.sin(nu), s * (e + torch.cos(nu)), torch.zeros_like(nu)], -1)
    co, so = torch.cos(raan), torch.sin(raan)
    cw, sw = torch.cos(argp), torch.sin(argp)
    ci, si = torch.cos(i), torch.sin(i)
    rot = torch.stack([
        torch.stack([co * cw - so * sw * ci, -co * sw - so * cw * ci, so * si], -1),
        torch.stack([so * cw + co * sw * ci, -so * sw + co * cw * ci, -co * si], -1),
        torch.stack([sw * si, cw * si, ci], -1)], -2)
    return torch.cat([(rot @ r_pqw[..., None])[..., 0], (rot @ v_pqw[..., None])[..., 0]], -1)


def walker_slots(cfg: dict, objects: int) -> torch.Tensor:
    """The shell's slots a catalog of `objects` holds: all of them at the
    configuration's size, else `objects` slots spread evenly over it."""
    total = cfg["walker"]["total"]
    if objects > total:
        raise ValueError(f"the shell has {total} slots, not {objects}")
    return torch.arange(objects, dtype=torch.int64) * (total // objects)


def catalog(cfg: dict, slots: torch.Tensor, device) -> torch.Tensor:
    """The epoch states [K, 6] (float64) of the objects in the shell's
    `slots`: slot s = j S + m (plane j of P, S = T/P a plane) at the
    reference's a, e, i and ω, RAAN Ω0 + 360° j/P and true anomaly
    ν0 + 360° (m/S + F j/T)."""
    w = cfg["walker"]
    per_plane = w["total"] // w["planes"]
    slot = torch.as_tensor(slots).to(F64)
    plane, m = torch.div(slot, per_plane, rounding_mode="floor"), torch.remainder(slot, per_plane)
    d2r = math.pi / 180.0
    raan = (cfg["raan_deg"] + 360.0 * plane / w["planes"]) * d2r
    nu = (cfg["nu_deg"] + 360.0 * (m / per_plane + w["phasing"] * plane / w["total"])) * d2r
    full = lambda v: torch.full_like(slot, v)
    x = oe_to_rv(full(cfg["sma_km"]), full(cfg["ecc"]), full(cfg["inc_deg"] * d2r), raan,
                 full(cfg["argp_deg"] * d2r), nu, cfg["gm"])
    return x.to(device)


def stations_ecef(cfg: dict, dtype, device) -> torch.Tensor:
    """[S, 3] ECEF positions of the stations (geocentric latitude,
    longitude in degrees, altitude in km)."""
    d2r = math.pi / 180.0
    st = torch.tensor(cfg["stations"], dtype=F64)
    lat, lon, rho = st[:, 0] * d2r, st[:, 1] * d2r, cfg["r_earth"] + st[:, 2]
    ecef = rho[:, None] * torch.stack([torch.cos(lat) * torch.cos(lon),
                                       torch.cos(lat) * torch.sin(lon), torch.sin(lat)], -1)
    return ecef.to(device, dtype)


def station_eci(ecef: torch.Tensor, theta: torch.Tensor, omega: float):
    """ECI position and velocity of stations ecef [..., 3] at Earth angles
    theta (broadcast against ecef's leading dims)."""
    c, s = torch.cos(theta), torch.sin(theta)
    x, y, z = ecef[..., 0], ecef[..., 1], ecef[..., 2]
    r = torch.stack([c * x - s * y, s * x + c * y, z.expand_as(c * x)], -1)
    v = torch.stack([-omega * r[..., 1], omega * r[..., 0], torch.zeros_like(r[..., 0])], -1)
    return r, v


def range_rate(state: torch.Tensor, r_s: torch.Tensor, v_s: torch.Tensor):
    """([ρ, ρ̇] [..., 2], H̃ = ∂[ρ, ρ̇]/∂state [..., 2, 6]) from stations
    at (r_s, v_s)."""
    dr, dv = state[..., :3] - r_s, state[..., 3:] - v_s
    rho = torch.sqrt((dr * dr).sum(-1))
    u = dr / rho[..., None]
    rdot = (u * dv).sum(-1)
    d_rdot = (dv - rdot[..., None] * u) / rho[..., None]
    ht = torch.stack([torch.cat([u, torch.zeros_like(u)], -1), torch.cat([d_rdot, u], -1)], -2)
    return torch.stack([rho, rdot], -1), ht


def scene(cfg: dict, slots: torch.Tensor, steps: int, seed: int, device,
          truth: torch.Tensor = None) -> dict:
    """One scene of the catalog (float64, on `device`): the Earth angle at
    epoch θ0 ~ U[0, 2π), the a-priori reference states x0_ref [K, 6]
    (truth + σ z per axis), and each object's pass schedule: obs
    [K, T, 2] (range, range-rate from the first station above its mask,
    plus chol(R) z; 0 where none), station_idx [K, T] (−1 where none)
    and has_meas [K, T].  Draws from a generator on `device` seeded with
    `seed`.  `truth` [T + 1, K, 6] is `truth_states`' (made here when
    not given)."""
    if truth is None:
        truth = truth_states(cfg, slots, steps, device)
    objects = truth.shape[1]
    gen = torch.Generator(device=device).manual_seed(seed)
    theta0 = float(2.0 * math.pi * torch.rand((), generator=gen, dtype=F64, device=device))
    sig = torch.tensor(cfg["apriori_sigma"], dtype=F64, device=device)
    z0 = torch.randn((objects, 6), generator=gen, dtype=F64, device=device)
    x0_ref = truth[0] + z0 * sig.repeat_interleave(3)
    ecef = stations_ecef(cfg, F64, device)
    mask = math.sin(cfg["elevation_mask_deg"] * math.pi / 180.0)
    times = cfg["dt"] * torch.arange(1, steps + 1, dtype=F64, device=device)
    obs = torch.empty(steps, objects, 2, dtype=F64, device=device)
    idx = torch.empty(steps, objects, dtype=torch.int64, device=device)
    for lo in range(0, steps, 512):  # in blocks of steps: [B, K, S, ...] fits anywhere
        hi = min(lo + 512, steps)
        theta = (theta0 + cfg["omega_earth"] * times[lo:hi])[:, None, None]
        r_s, v_s = station_eci(ecef, theta, cfg["omega_earth"])  # [B, 1, S, 3]
        x = truth[lo + 1:hi + 1, :, None, :]
        ob, _ = range_rate(x, r_s, v_s)  # [B, K, S, 2]
        zenith = r_s / torch.sqrt((r_s * r_s).sum(-1, keepdim=True))
        sin_el = ((x[..., :3] - r_s) * zenith).sum(-1) / ob[..., 0]
        vis = sin_el >= mask
        first = torch.argmax(vis.to(torch.int8), -1)
        seen = vis.any(-1)
        pick = torch.take_along_dim(ob, first[..., None, None], -2)[..., 0, :]
        obs[lo:hi] = torch.where(seen[..., None], pick, 0.0)
        idx[lo:hi] = torch.where(seen, first, -1)
    has = idx >= 0
    lr = torch.sqrt(torch.tensor(cfg["r"], dtype=F64, device=device))
    noise = torch.randn((steps, objects, 2), generator=gen, dtype=F64, device=device) * lr
    obs = obs + torch.where(has[..., None], noise, 0.0)
    return {"theta0": theta0, "x0_ref": x0_ref, "obs": obs.transpose(0, 1).contiguous(),
            "station_idx": idx.transpose(0, 1).contiguous(),
            "has_meas": has.transpose(0, 1).contiguous()}


def truth_states(cfg: dict, slots: torch.Tensor, steps: int, device) -> torch.Tensor:
    """The truth [T + 1, K, 6] (float64) of the objects in `slots` from
    epoch on: RK4 of two-body + J2 at the configuration's step."""
    x = catalog(cfg, slots, device)
    out = torch.empty((steps + 1,) + x.shape, dtype=F64, device=device)
    out[0] = x
    for k in range(steps):
        x = rk4(x, cfg["dt"], cfg)
        out[k + 1] = x
    return out


def _r_factor(a: torch.Tensor) -> torch.Tensor:
    return torch.linalg.qr(a, mode="r")[1]


def run(cfg: dict, sc: dict, dtype, visit) -> None:
    """The SRIF of every object of the scene `sc` in `dtype` (float64 the
    reference, float32 the control), from the a-priori reference states
    at epoch; calls visit(t, est [K, 6], cov [K, 6, 6]) after step t,
    est = x_ref + x the full-state estimate."""
    with no_tf32():
        _run(cfg, sc, dtype, visit)


def _run(cfg, sc, dtype, visit):
    x_ref = sc["x0_ref"].to(dtype)
    device = x_ref.device
    k_obj, steps = sc["has_meas"].shape
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    dt = cfg["dt"]
    eye3 = torch.eye(3, dtype=dtype, device=device)
    eye6 = torch.eye(6, dtype=dtype, device=device)
    gamma = torch.cat([0.5 * dt * dt * eye3, dt * eye3])  # [6, 3]
    # R_w = chol(Q)⁻¹, W = chol(R)⁻¹ (both diagonal here, taken in general form)
    lq = torch.linalg.cholesky(cfg["snc_sigma"] ** 2 * eye3)
    r_w = torch.linalg.solve_triangular(lq, eye3, upper=False)
    w = torch.linalg.solve_triangular(torch.linalg.cholesky(torch.diag(as_t(cfg["r"]))),
                                      torch.eye(2, dtype=dtype, device=device), upper=False)
    # R0 = chol(P0⁻¹)ᵀ = diag(1/σ), b0 = R0 x0 = 0 (the deviation starts at 0)
    r = torch.diag(1.0 / torch.sqrt(as_t(cfg["p0"]))).expand(k_obj, 6, 6).clone()
    b = torch.zeros(k_obj, 6, dtype=dtype, device=device)
    top = torch.cat([r_w, torch.zeros(3, 7, dtype=dtype, device=device)], -1).expand(
        k_obj, 3, 10)
    ecef = stations_ecef(cfg, dtype, device)
    theta0 = sc["theta0"]
    obs, idx, has = sc["obs"].to(dtype), sc["station_idx"], sc["has_meas"]
    for t in range(steps):
        x_ref, phi = rk4_stm(x_ref, dt, cfg)
        # time update: R̄ = R Φ⁻¹, then the Dyer–McReynolds stack
        r_bar = torch.linalg.solve(phi, r, left=False)
        bot = torch.cat([-(r_bar @ gamma), r_bar, b[..., None]], -1)
        tri = _r_factor(torch.cat([top, bot], -2))  # [K, 9, 10]
        r_bar, b_bar = tri[..., 3:, 3:9], tri[..., 3:, 9]
        # measurement update where a station sees the object
        theta = as_t(theta0 + cfg["omega_earth"] * dt * (t + 1))
        r_s, v_s = station_eci(ecef[torch.clamp(idx[:, t], min=0)], theta,
                               cfg["omega_earth"])
        computed, ht = range_rate(x_ref, r_s, v_s)
        y_w = (w @ (obs[:, t] - computed)[..., None])[..., 0]
        stack = torch.cat([torch.cat([r_bar, b_bar[..., None]], -1),
                           torch.cat([w @ ht, y_w[..., None]], -1)], -2)  # [K, 8, 7]
        upd = _r_factor(stack)  # [K, 7, 7]
        seen = has[:, t, None, None]
        r = torch.where(seen, upd[..., :6, :6], r_bar)
        b = torch.where(seen[..., 0], upd[..., :6, 6], b_bar)
        # read-outs
        x = torch.linalg.solve_triangular(r, b[..., None], upper=True)[..., 0]
        r_inv = torch.linalg.solve_triangular(r, eye6.expand_as(r), upper=True)
        visit(t, x_ref + x, r_inv @ r_inv.transpose(-1, -2))
