"""IMB coupling unit tests (C9/C10/C12): stamp accuracy, NT limits,
zero-force consistency, force sign/direction.
"""

import jax.numpy as jnp
import numpy as np

from lbmdem.config import SimConfig, window_for_radius
from lbmdem.ops import imb, lbm


def _cfg(nx=48, ny=48, r=4.0, **kw):
    base = dict(nx=nx, ny=ny, tau=0.8, dtype="float64",
                window=window_for_radius(r), max_disks=1,
                bc_west="wall", bc_east="wall")
    base.update(kw)
    return SimConfig(**base)


def _one_disk(cfg, x, y, r, vx=0.0, vy=0.0, om=0.0):
    xp = jnp.asarray([[x, y]], jnp.float64)
    vp = jnp.asarray([[vx, vy]], jnp.float64)
    omega = jnp.asarray([om], jnp.float64)
    rr = jnp.asarray([r], jnp.float64)
    act = jnp.asarray([True])
    return imb.stamp_solid_fraction(xp, vp, omega, rr, act, cfg)


def test_stamp_total_area():
    cfg = _cfg(eps_samples=8)
    eps, _, _ = _one_disk(cfg, 24.3, 23.7, 4.0)
    np.testing.assert_allclose(float(jnp.sum(eps)), np.pi * 16.0, rtol=5e-3)
    assert float(jnp.max(eps)) <= 1.0 + 1e-12
    assert float(jnp.min(eps)) >= 0.0


def test_stamp_r_shift_shrinks_hydro_radius():
    """eps_r_shift shrinks the COVERAGE area to pi*(r+shift)^2 without
    touching the nominal radius anywhere else (the DEM contact law and
    binning keep r); empty slots stay empty."""
    cfg = _cfg(eps_samples=8, eps_r_shift=-0.4)
    eps, _, _ = _one_disk(cfg, 24.3, 23.7, 4.0)
    np.testing.assert_allclose(float(jnp.sum(eps)), np.pi * 3.6**2,
                               rtol=5e-3)
    # inactive slot yields nothing even with the shift applied
    xp = jnp.asarray([[24.3, 23.7]], jnp.float64)
    z = jnp.zeros((1, 2), jnp.float64)
    eps0, _, _ = imb.stamp_solid_fraction(
        xp, z, jnp.zeros((1,), jnp.float64), jnp.zeros((1,), jnp.float64),
        jnp.asarray([False]), cfg)
    assert float(jnp.sum(eps0)) == 0.0


def test_stamp_rigid_rotation_velocity():
    cfg = _cfg()
    eps, usx, usy = _one_disk(cfg, 24.0, 24.0, 4.0, om=0.1)
    # at cell (24, 27): rel=(3,0) -> us = omega x r = (0.1 * -0, 0.1*3)
    assert abs(float(usy[24, 27]) - 0.3) < 1e-9
    assert abs(float(usx[24, 27])) < 1e-9
    # pure rotation: coverage-weighted net momentum ~ 0
    assert abs(float(jnp.sum(eps * usx))) < 1e-9


def test_nt_weight_limits():
    tau = 0.8
    assert float(imb.nt_weight(jnp.asarray(0.0), tau)) == 0.0
    assert abs(float(imb.nt_weight(jnp.asarray(1.0), tau)) - 1.0) < 1e-12
    b = float(imb.nt_weight(jnp.asarray(0.5), tau))
    assert 0.0 < b < 1.0


def test_collide_imb_reduces_to_bgk_without_solid():
    cfg = _cfg()
    rng = np.random.default_rng(0)
    f = jnp.asarray(
        np.abs(rng.standard_normal((9, cfg.ny, cfg.nx))) * 0.1 + 0.1, jnp.float64
    )
    zero = jnp.zeros((cfg.ny, cfg.nx), jnp.float64)
    fpost, phix, phiy = imb.collide_imb(f, zero, zero, zero, cfg)
    fbgk = lbm.collide(f, cfg.tau)
    np.testing.assert_allclose(np.asarray(fpost), np.asarray(fbgk), atol=1e-13)
    assert float(jnp.max(jnp.abs(phix))) == 0.0


def test_no_force_when_comoving():
    """Solid moving with the fluid at equal velocity => Omega = 0."""
    cfg = _cfg()
    u = 0.02
    rho = jnp.ones((cfg.ny, cfg.nx), jnp.float64)
    f = lbm.equilibrium(rho, jnp.full_like(rho, u), jnp.zeros_like(rho))
    eps, usx, usy = _one_disk(cfg, 24.0, 24.0, 4.0, vx=u)
    fpost, phix, phiy = imb.collide_imb(f, eps, usx, usy, cfg)
    assert float(jnp.max(jnp.abs(phix))) < 1e-12
    assert float(jnp.max(jnp.abs(phiy))) < 1e-12


def test_drag_force_direction():
    """Static disk in a uniform flow feels a downstream force."""
    cfg = _cfg()
    u = 0.05
    rho = jnp.ones((cfg.ny, cfg.nx), jnp.float64)
    f = lbm.equilibrium(rho, jnp.full_like(rho, u), jnp.zeros_like(rho))
    eps, usx, usy = _one_disk(cfg, 24.0, 24.0, 4.0)
    fpost, phix, phiy = imb.collide_imb(f, eps, usx, usy, cfg)
    xp = jnp.asarray([[24.0, 24.0]], jnp.float64)
    F, T = imb.reduce_hydro_forces(
        xp, jnp.asarray([4.0]), jnp.asarray([True]), eps, phix, phiy, cfg
    )
    assert float(F[0, 0]) > 0.0  # drag pushes the disk downstream
    assert abs(float(F[0, 1])) < 1e-9  # symmetric -> no lift
    assert abs(float(T[0])) < 1e-9  # no spin

    # momentum bookkeeping: the force on the solid equals the momentum
    # the fluid lost in the collision
    dpx = float(jnp.sum(fpost * jnp.asarray([0, 1, 0, -1, 0, 1, -1, -1, 1.0])[:, None, None])) - u * cfg.nx * cfg.ny
    np.testing.assert_allclose(float(jnp.sum(phix)), -dpx, rtol=1e-8)


def test_force_attribution_splits_overlap():
    """Two fully overlapping identical disks split the cell force 50/50."""
    cfg = _cfg(max_disks=2)
    u = 0.05
    rho = jnp.ones((cfg.ny, cfg.nx), jnp.float64)
    f = lbm.equilibrium(rho, jnp.full_like(rho, u), jnp.zeros_like(rho))
    xp = jnp.asarray([[24.0, 24.0], [24.0, 24.0]], jnp.float64)
    vp = jnp.zeros((2, 2), jnp.float64)
    om = jnp.zeros((2,), jnp.float64)
    rr = jnp.asarray([4.0, 4.0], jnp.float64)
    act = jnp.asarray([True, True])
    eps, usx, usy = imb.stamp_solid_fraction(xp, vp, om, rr, act, cfg)
    fpost, phix, phiy = imb.collide_imb(f, eps, usx, usy, cfg)
    F, T = imb.reduce_hydro_forces(xp, rr, act, eps, phix, phiy, cfg)
    np.testing.assert_allclose(float(F[0, 0]), float(F[1, 0]), rtol=1e-12)
    np.testing.assert_allclose(float(F[0, 0] + F[1, 0]), float(jnp.sum(phix)), rtol=1e-9)


def test_exact_coverage_beats_sampling():
    """The analytic tangent-plane overlap ("exact") must beat 4x4
    subgrid sampling against a fine-sampled (64^2/cell) ground truth:
    >=5x smaller max per-cell error and a near-zero total-area bias
    (the rc = r - 1/(24r) curvature fold). Also pins the edge cases the
    formula special-cases: a disk centered exactly on a cell center
    (relx = rely = 0 -> the d2 < 0.01 override) and exactly on a cell
    row (rely == 0 -> the axis-aligned clip limit)."""
    W = 24
    cells = jnp.arange(W, dtype=jnp.float64) - W // 2
    for r, cx, cy in [(4.0, 0.0, 0.0), (4.0, 0.37, -0.21), (8.0, 0.5, 0.13),
                      (3.0, 0.25, 0.0)]:
        relx = jnp.broadcast_to((cells - cx)[None, :], (W, W))
        rely = jnp.broadcast_to((cells - cy)[:, None], (W, W))

        def sampled(ns):
            offs = (jnp.arange(ns, dtype=jnp.float64) + 0.5) / ns - 0.5
            px = relx[..., None, None] + offs[None, None, :, None]
            py = rely[..., None, None] + offs[None, None, None, :]
            return jnp.mean(
                ((px**2 + py**2) <= r * r).astype(jnp.float64), axis=(-2, -1)
            )

        truth = sampled(64)
        err_s4 = float(jnp.max(jnp.abs(sampled(4) - truth)))
        cov = imb.exact_coverage(relx, rely, jnp.float64(r))
        err_ex = float(jnp.max(jnp.abs(cov - truth)))
        assert err_ex < 0.2 * err_s4, (r, cx, cy, err_ex, err_s4)
        area_bias = float(jnp.sum(cov) - jnp.sum(truth)) / float(jnp.sum(truth))
        assert abs(area_bias) < 2e-3, (r, cx, cy, area_bias)
    # empty slot (rr == 0): identically zero everywhere, incl. d == 0
    relx0 = jnp.broadcast_to(cells[None, :], (W, W))
    rely0 = jnp.broadcast_to(cells[:, None], (W, W))
    assert float(jnp.max(imb.exact_coverage(relx0, rely0, jnp.float64(0.0)))) == 0.0
