"""DEM unit tests (C13-C16): cell-list vs brute force, Newton's third
law, momentum conservation, restitution damping, wall contact, overflow
detection.
"""

import jax
import jax.numpy as jnp
import numpy as np

from lbmdem.config import DiskSpec, SimConfig
from lbmdem.ops import dem
from lbmdem.ops.dem import DemGrid


_subcycle = jax.jit(dem.dem_subcycle, static_argnums=(3, 4))


def _cfg(**kw):
    base = dict(nx=64, ny=64, tau=0.8, dtype="float64", max_disks=16,
                kn=1.0, gamma_n=0.05, gamma_t=0.02, mu=0.4, rho_s=2.0,
                n_sub=50, bc_west="wall", bc_east="wall", g_px=0.0,
                g_py=0.0, buoyancy=False)
    base.update(kw)
    return SimConfig(**base)


def _random_disks(cfg, n, r=1.5, seed=0, lo=3.0, hi=None):
    rng = np.random.default_rng(seed)
    specs = [
        DiskSpec(
            x=rng.uniform(lo, hi if hi else cfg.nx - 3),
            y=rng.uniform(lo, hi if hi else cfg.ny - 3),
            r=r,
            vx=rng.uniform(-0.05, 0.05),
            vy=rng.uniform(-0.05, 0.05),
            omega=rng.uniform(-0.01, 0.01),
        )
        for _ in range(n)
    ]
    return dem.make_disk_state(specs, cfg, "float64")


def _brute_force(disks, cfg):
    """O(N^2) oracle using the same pair law."""
    n = disks.x.shape[0]
    dt = disks.x.dtype
    xi = disks.x[:, None, :]
    xj = disks.x[None, :, :]
    mask = (disks.active[:, None] & disks.active[None, :]) & ~jnp.eye(n, dtype=bool)
    F, T, _, _ = dem._pair_force(
        xi, disks.v[:, None, :], disks.omega[:, None], disks.r[:, None],
        xj, disks.v[None, :, :], disks.omega[None, :], disks.r[None, :],
        mask, cfg, dt,
    )
    return jnp.sum(F, axis=1), jnp.sum(T, axis=1)


def test_cell_list_matches_brute_force():
    cfg = _cfg(max_disks=24)
    disks = _random_disks(cfg, 24, r=2.0, seed=3)
    grid = DemGrid.build(cfg, 2.0)
    table, ovf = dem.build_cell_table(disks.x, disks.active, grid)
    assert int(ovf) == 0
    Fc, Tc, _ = dem.contact_forces(disks, table, grid, cfg)
    Fb, Tb = _brute_force(disks, cfg)
    np.testing.assert_allclose(np.asarray(Fc), np.asarray(Fb), atol=1e-12)
    np.testing.assert_allclose(np.asarray(Tc), np.asarray(Tb), atol=1e-12)


def test_newtons_third_law_and_angular_momentum():
    cfg = _cfg(max_disks=12)
    disks = _random_disks(cfg, 12, r=3.0, seed=7, lo=22.0, hi=42.0)  # dense -> contacts
    grid = DemGrid.build(cfg, 3.0)
    table, _ = dem.build_cell_table(disks.x, disks.active, grid)
    F, T, nc = dem.contact_forces(disks, table, grid, cfg)
    assert int(nc) > 0
    np.testing.assert_allclose(np.asarray(jnp.sum(F, axis=0)), 0.0, atol=1e-12)
    # total angular momentum torque: sum_i (x_i x F_i) + T_i = 0
    lz = jnp.sum(disks.x[:, 0] * F[:, 1] - disks.x[:, 1] * F[:, 0] + T)
    assert abs(float(lz)) < 1e-10


def test_head_on_collision_momentum_and_damping():
    cfg = _cfg(max_disks=2, kn=0.5, gamma_n=0.05, n_sub=200)
    specs = [DiskSpec(28, 32, 2.0, vx=0.05), DiskSpec(36, 32, 2.0, vx=-0.05)]
    disks = dem.make_disk_state(specs, cfg, "float64")
    grid = DemGrid.build(cfg, 2.0)
    zero = jnp.zeros((2, 2), jnp.float64)
    zt = jnp.zeros((2,), jnp.float64)
    p0 = float(jnp.sum(disks.mass[:, None] * disks.v))
    e0 = float(jnp.sum(0.5 * disks.mass * jnp.sum(disks.v**2, -1)))
    for _ in range(60):
        disks, ovf, _ = _subcycle(disks, zero, zt, grid, cfg)
    assert int(ovf) == 0
    p1 = float(jnp.sum(disks.mass[:, None] * disks.v))
    e1 = float(jnp.sum(0.5 * disks.mass * jnp.sum(disks.v**2, -1)))
    assert abs(p1 - p0) < 1e-12          # momentum conserved
    assert e1 < e0                        # dashpot dissipates
    assert float(disks.v[0, 0]) < 0 and float(disks.v[1, 0]) > 0  # rebounded


def test_disk_settles_on_wall():
    # near-critical damping (gamma_crit = 2 sqrt(kn m) ~ 10) so it settles
    cfg = _cfg(max_disks=1, g_py=-1e-4, kn=1.0, gamma_n=8.0, n_sub=100)
    disks = dem.make_disk_state([DiskSpec(32, 3, 2.0)], cfg, "float64")
    grid = DemGrid.build(cfg, 2.0)
    zero = jnp.zeros((1, 2), jnp.float64)
    zt = jnp.zeros((1,), jnp.float64)
    for _ in range(400):
        disks, _, _ = _subcycle(disks, zero, zt, grid, cfg)
    y = float(disks.x[0, 1])
    # rests near wall contact: y ~ -0.5 + r - gravity compression
    assert abs(y - (-0.5 + 2.0)) < 0.05
    assert abs(float(disks.v[0, 1])) < 1e-4


def test_cell_overflow_detected():
    cfg = _cfg(max_disks=12)
    # 12 coincident disks in one cell with capacity 8 -> overflow
    specs = [DiskSpec(32, 32, 1.0) for _ in range(12)]
    disks = dem.make_disk_state(specs, cfg, "float64")
    grid = DemGrid.build(cfg, 1.0, capacity=8)
    _, ovf = dem.build_cell_table(disks.x, disks.active, grid)
    assert int(ovf) == 4


def test_inactive_slots_do_not_interact():
    cfg = _cfg(max_disks=8)
    disks = _random_disks(cfg, 3, r=2.0, seed=1)
    grid = DemGrid.build(cfg, 2.0)
    zero = jnp.zeros((8, 2), jnp.float64)
    zt = jnp.zeros((8,), jnp.float64)
    d1, ovf, _ = _subcycle(disks, zero, zt, grid, cfg)
    assert int(ovf) == 0
    np.testing.assert_array_equal(np.asarray(d1.x[3:]), np.asarray(disks.x[3:]))
    np.testing.assert_array_equal(np.asarray(d1.v[3:]), 0.0)


def test_tangential_history_spring():
    """kt > 0: a spinning disk in wall contact grips via the history
    spring - friction torque despins it and drives rolling translation."""
    cfg = _cfg(max_disks=1, kt=0.5, gamma_t=0.1, mu=0.5, g_py=-1e-3,
               kn=2.0, gamma_n=5.0, n_sub=100, buoyancy=False)
    # start resting on the south wall, spinning
    disks = dem.make_disk_state([DiskSpec(32, 1.45, 2.0, omega=0.05)], cfg,
                                "float64")
    grid = DemGrid.build(cfg, 2.0)
    zero = jnp.zeros((1, 2), jnp.float64)
    zt = jnp.zeros((1,), jnp.float64)
    om0 = float(disks.omega[0])
    for _ in range(40):
        disks, ovf, _ = _subcycle(disks, zero, zt, grid, cfg)
    assert int(ovf) == 0
    om1 = float(disks.omega[0])
    vx1 = float(disks.v[0, 0])
    assert abs(om1) < abs(om0)          # friction despins
    # wall contact with omega>0 (ccw): surface at contact moves -x,
    # friction pushes disk -x -> rolling to the left
    assert vx1 < 0
    # history spring stored on the south wall slot
    assert float(jnp.abs(disks.wall_xi[0, 2])) >= 0.0


def test_tangential_spring_symmetry():
    """Newton's 3rd law still holds with history springs active."""
    cfg = _cfg(max_disks=2, kt=0.5, gamma_t=0.1, mu=0.8, n_sub=20)
    specs = [DiskSpec(30, 32, 2.0, vy=0.02, omega=0.03),
             DiskSpec(33.5, 32, 2.0, vy=-0.02)]
    disks = dem.make_disk_state(specs, cfg, "float64")
    grid = DemGrid.build(cfg, 2.0)
    zero = jnp.zeros((2, 2), jnp.float64)
    zt = jnp.zeros((2,), jnp.float64)
    p0 = np.asarray(jnp.sum(disks.mass[:, None] * disks.v, axis=0))
    for _ in range(10):
        disks, _, _ = _subcycle(disks, zero, zt, grid, cfg)
    p1 = np.asarray(jnp.sum(disks.mass[:, None] * disks.v, axis=0))
    np.testing.assert_allclose(p1, p0, atol=1e-13)  # momentum conserved
    # angular momentum about origin conserved (no external torque)
    def ang(d):
        return float(jnp.sum(d.mass * (d.x[:, 0] * d.v[:, 1] - d.x[:, 1] * d.v[:, 0])
                             + d.inertia * d.omega))
    # (recompute initial from fresh state)
    d0 = dem.make_disk_state(specs, cfg, "float64")
    assert abs(ang(disks) - ang(d0)) < 1e-10
