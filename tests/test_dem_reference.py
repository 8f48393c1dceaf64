"""DEM subcycle against an independent numpy reference: brute-force
O(N^2) pairs, per-pair loops, tangential history keyed by (i, j).

Covers the mechanisms the cell list, the pruned candidate slots and the
per-slot history carry: Cundall-Strack springs across LBM steps (the
history is re-matched to fresh candidate lists by partner id), fixed
(infinite-mass) disks mixed with mobile ones, and minimum-image contacts
across a periodic seam. f64 on both sides: agreement to roundoff.
"""

import jax
import numpy as np
import pytest

from lbmdem.config import DiskSpec, SimConfig
from lbmdem.ops import dem
from lbmdem.ops.dem import DemGrid


def _pair(cfg, xi_pos, vi, omi, ri, xj_pos, vj, omj, rj, xi_t, h, wrap):
    """Force on i from j, torque on i, new stretch, touching."""
    d = np.asarray(xi_pos - xj_pos, float)
    for a, L in enumerate(wrap):
        if L:
            d[a] -= L * np.round(d[a] / L)
    dist = max(np.hypot(*d), 1e-12)
    delta = ri + rj - dist
    if delta <= 0:
        return np.zeros(2), 0.0, 0.0, False
    n = d / dist
    t = np.array([-n[1], n[0]])
    li, lj = ri - 0.5 * delta, rj - 0.5 * delta
    vrel = vi - vj - (omi * li + omj * lj) * t
    vn, vt = vrel @ n, vrel @ t
    fn = cfg.kn * delta - cfg.gamma_n * vn
    cap = cfg.mu * abs(fn)
    if cfg.kt > 0:
        s = xi_t + vt * h
        ft = np.clip(-cfg.kt * s - cfg.gamma_t * vt, -cap, cap)
        xi_new = -(ft + cfg.gamma_t * vt) / cfg.kt
    else:
        ft = np.clip(-cfg.gamma_t * vt, -cap, cap)
        xi_new = 0.0
    return fn * n + ft * t, -li * ft, xi_new, True


def _walls(cfg):
    out = []
    if cfg.bc_west == "wall":
        out.append((0, 0, -0.5))
    if cfg.bc_east == "wall":
        out.append((1, 0, cfg.nx - 0.5))
    if cfg.bc_south == "wall":
        out.append((2, 1, -0.5))
    if cfg.bc_north == "wall":
        out.append((3, 1, cfg.ny - 0.5))
    return out


def _forces(cfg, x, v, om, r, act, hist, whist, h, fh, th, body):
    """Total force/torque on every disk; returns updated histories."""
    n = len(r)
    wrap = (cfg.wrap_lx, cfg.wrap_ly)
    F = np.zeros((n, 2))
    T = np.zeros(n)
    new_hist, new_whist, nc = {}, dict(whist), 0
    for i in range(n):
        if not act[i]:
            continue
        for j in range(n):
            if j == i or not act[j]:
                continue
            f, tq, xi, touch = _pair(cfg, x[i], v[i], om[i], r[i], x[j],
                                     v[j], om[j], r[j],
                                     hist.get((i, j), 0.0), h, wrap)
            if touch:
                F[i] += f
                T[i] += tq
                new_hist[(i, j)] = xi
                nc += 1
        for slot, axis, pos in _walls(cfg):
            xw = x[i].copy()
            xw[axis] = pos
            f, tq, xi, touch = _pair(cfg, x[i], v[i], om[i], r[i], xw,
                                     np.zeros(2), 0.0, 0.0,
                                     whist.get((i, slot), 0.0), h, (0, 0))
            F[i] += f
            T[i] += tq
            new_whist[(i, slot)] = xi if touch else 0.0
        F[i] += fh[i] + body[i]
        T[i] += th[i]
    return F, T, new_hist, new_whist, nc // 2


def _ref_subcycle(cfg, st, fh, th):
    """One LBM step of velocity-Verlet substeps (dem.dem_subcycle's
    scheme: force carried across substeps, history advanced at h)."""
    x, v, om, theta = st["x"], st["v"], st["om"], st["theta"]
    r, act, mob = st["r"], st["act"], st["mob"]
    h = 1.0 / cfg.n_sub
    m = st["mass"]
    inv_m = np.where(act & mob, 1.0 / m, 0.0)
    inv_i = np.where(act & mob, 1.0 / st["inertia"], 0.0)
    m_eff = m - (cfg.rho0 * np.pi * r * r if cfg.buoyancy else 0.0)
    body = m_eff[:, None] * np.array([cfg.g_px, cfg.g_py]) * act[:, None]
    F, T, _, _, nc = _forces(cfg, x, v, om, r, act, st["hist"],
                             st["whist"], 0.0, fh, th, body)
    hist, whist = st["hist"], st["whist"]
    for _ in range(cfg.n_sub):
        vh = v + 0.5 * h * F * inv_m[:, None]
        omh = om + 0.5 * h * T * inv_i
        x = x + h * vh * act[:, None]
        theta = theta + h * omh * act
        F, T, hist, whist, n2 = _forces(cfg, x, vh, omh, r, act, hist,
                                        whist, h, fh, th, body)
        nc = max(nc, n2)
        v = (vh + 0.5 * h * F * inv_m[:, None]) * act[:, None]
        om = (omh + 0.5 * h * T * inv_i) * act
    return dict(st, x=x, v=v, om=om, theta=theta, hist=hist,
                whist=whist), nc


def _state_np(d):
    return dict(x=np.asarray(d.x), v=np.asarray(d.v),
                om=np.asarray(d.omega), theta=np.asarray(d.theta),
                r=np.asarray(d.r), act=np.asarray(d.active),
                mob=np.asarray(d.mobile), mass=np.asarray(d.mass),
                inertia=np.asarray(d.inertia), hist={}, whist={})


_CASES = {
    # frictionless dashpot contacts against walls and each other
    "dashpot": (dict(kt=0.0, gamma_t=0.3, mu=0.4), False, "wall"),
    # Cundall-Strack springs carried across three LBM steps
    "kt_history": (dict(kt=0.6, gamma_t=0.2, mu=0.3), False, "wall"),
    # fixed obstacles among mobile disks (infinite mass, prescribed v)
    "fixed": (dict(kt=0.6, gamma_t=0.2, mu=0.3), True, "wall"),
    # contacts across the periodic x seam (minimum image)
    "periodic": (dict(kt=0.6, gamma_t=0.2, mu=0.3), False, "periodic"),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_dem_subcycle_matches_numpy_reference(case):
    extra, with_fixed, xbc = _CASES[case]
    cfg = SimConfig(nx=40, ny=30, dtype="float64", kn=2.0, gamma_n=0.8,
                    n_sub=6, g_py=-2e-4, rho_s=2.0, buoyancy=True,
                    bc_west=xbc, bc_east=xbc, max_disks=7, **extra)
    specs = [
        DiskSpec(10.0, 3.2, 2.8),                   # resting on the floor
        DiskSpec(15.4, 3.5, 2.8, omega=0.05),       # overlapping neighbour
        DiskSpec(22.0, 15.0, 2.5, vx=0.06),         # head-on pair
        DiskSpec(26.8, 15.2, 2.5, vx=-0.06),
        DiskSpec(1.0, 24.0, 2.5, vx=-0.03),         # at the x edge / seam
        DiskSpec(37.9, 24.3, 2.5, vx=0.02),
        DiskSpec(30.0, 27.2, 2.4, vy=0.01),         # near the roof
    ]
    if with_fixed:
        specs[1] = DiskSpec(15.4, 3.5, 2.8, fixed=True)
        specs[3] = DiskSpec(26.8, 15.2, 2.5, vx=-0.01, fixed=True)
    disks = dem.make_disk_state(specs, cfg)
    grid = DemGrid.build(cfg, 2.8)
    rng = np.random.default_rng(0)
    fh = rng.uniform(-1e-3, 1e-3, (7, 2))
    th = rng.uniform(-1e-3, 1e-3, 7)
    sub = jax.jit(dem.dem_subcycle, static_argnums=(3, 4))
    ref = _state_np(disks)
    for _ in range(3):
        disks, ovf, nc = sub(disks, fh, th, grid, cfg)
        ref, nc_ref = _ref_subcycle(cfg, ref, fh, th)
        assert int(ovf) == 0
        assert int(nc) == nc_ref
    assert nc_ref > 0
    np.testing.assert_allclose(np.asarray(disks.x), ref["x"], rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(disks.v), ref["v"], rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(disks.omega), ref["om"], rtol=0,
                               atol=1e-12)
    if cfg.kt > 0:
        assert any(abs(xi) > 0 for xi in ref["hist"].values())
    if with_fixed:
        v0 = np.array([[0.0, 0.0], [-0.01, 0.0]])
        np.testing.assert_array_equal(np.asarray(disks.v)[[1, 3]], v0)
