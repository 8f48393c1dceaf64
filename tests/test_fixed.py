"""Fixed (infinite-mass) obstacle disks: DiskSpec.fixed end-to-end.

SURVEY.md SS2 C11/C16 extension: stationary obstacles and prescribed-
motion boundaries (towed/rotating cylinders, porous beds) reuse the IMB
coupling unchanged; the DEM never changes a fixed disk's velocity but
still integrates its position from the constant v/omega.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lbmdem.config import (
    DiskSpec, SimConfig, load_particle_file, save_particle_file,
)
from lbmdem.ops import dem
from lbmdem.ops.dem import DemGrid
from lbmdem.simulation import Simulation


def _cfg(**kw):
    base = dict(nx=128, ny=128, tau=0.8, dtype="float32", max_disks=8,
                kn=2.0, gamma_n=1.0, gamma_t=0.3, mu=0.4, rho_s=2.0,
                n_sub=10, bc_west="wall", bc_east="wall", g_py=-1e-4,
                buoyancy=False)
    base.update(kw)
    return SimConfig(**base)


def test_particle_file_fixed_roundtrip(tmp_path):
    disks = [DiskSpec(10.0, 20.0, 3.0, 0.01, -0.02, 0.003, fixed=True),
             DiskSpec(40.0, 20.0, 2.0)]
    p = str(tmp_path / "disks.txt")
    save_particle_file(p, disks)
    back = load_particle_file(p)
    assert back == disks
    # 6-column files (no fixed column) default to mobile
    save_particle_file(p, [DiskSpec(1.0, 2.0, 3.0)])
    assert load_particle_file(p)[0].fixed is False


def test_fixed_disk_ignores_all_forces():
    """Overlapping contact + gravity: the fixed disk stays exactly put,
    the mobile one accelerates away."""
    cfg = _cfg(max_disks=2)
    specs = [DiskSpec(60.0, 60.0, 4.0, fixed=True),
             DiskSpec(60.0, 66.0, 4.0)]  # 2-cell overlap from above
    disks = dem.make_disk_state(specs, cfg, "float32")
    grid = DemGrid.build(cfg, 4.0)
    z2 = jnp.zeros((2, 2), jnp.float32)
    z1 = jnp.zeros((2,), jnp.float32)
    d, ovf, nc = jax.jit(dem.dem_subcycle, static_argnums=(3, 4))(
        disks, z2, z1, grid, cfg)
    assert int(nc) >= 1
    np.testing.assert_array_equal(np.asarray(d.x[0]), [60.0, 60.0])
    np.testing.assert_array_equal(np.asarray(d.v[0]), [0.0, 0.0])
    assert float(d.v[1, 1]) > 0.0  # pushed up by the contact spring
    assert float(d.x[1, 1]) > 66.0


def test_prescribed_motion_is_exactly_linear():
    """A fixed disk with nonzero v/omega translates/rotates at exactly
    that rate, through gravity and a contact with a mobile disk."""
    cfg = _cfg(max_disks=2, g_py=-1e-3)
    vx, vy, om = 0.02, -0.01, 0.005
    specs = [DiskSpec(60.0, 60.0, 4.0, vx, vy, om, fixed=True),
             DiskSpec(60.0, 67.0, 4.0)]
    disks = dem.make_disk_state(specs, cfg, "float32")
    grid = DemGrid.build(cfg, 4.0)
    z2 = jnp.zeros((2, 2), jnp.float32)
    z1 = jnp.zeros((2,), jnp.float32)
    sub = jax.jit(dem.dem_subcycle, static_argnums=(3, 4))
    d = disks
    for _ in range(3):  # 3 LBM steps of n_sub substeps each
        d, _, _ = sub(d, z2, z1, grid, cfg)
    np.testing.assert_allclose(np.asarray(d.x[0]),
                               [60.0 + 3 * vx, 60.0 + 3 * vy], atol=1e-4)
    np.testing.assert_allclose(float(d.theta[0]), 3 * om, atol=1e-6)
    np.testing.assert_allclose(np.asarray(d.v[0]), [vx, vy], atol=0)
    np.testing.assert_allclose(float(d.omega[0]), om, atol=0)


def test_mobile_bounces_off_fixed():
    """Head-on approach: momentum is NOT conserved (the fixed disk is an
    external boundary); the mobile disk rebounds, the fixed disk holds."""
    cfg = _cfg(max_disks=2, g_py=0.0, kn=5.0, gamma_n=0.0, n_sub=40)
    specs = [DiskSpec(60.0, 60.0, 4.0, fixed=True),
             DiskSpec(69.0, 60.0, 4.0, vx=-0.2)]
    disks = dem.make_disk_state(specs, cfg, "float32")
    grid = DemGrid.build(cfg, 4.0)
    z2 = jnp.zeros((2, 2), jnp.float32)
    z1 = jnp.zeros((2,), jnp.float32)
    sub = jax.jit(dem.dem_subcycle, static_argnums=(3, 4))
    d = disks
    for _ in range(20):
        d, _, _ = sub(d, z2, z1, grid, cfg)
    np.testing.assert_array_equal(np.asarray(d.x[0]), [60.0, 60.0])
    assert float(d.v[1, 0]) > 0.05  # rebounded
    # undamped spring: |v_out| ~= |v_in|
    np.testing.assert_allclose(abs(float(d.v[1, 0])), 0.2, rtol=0.05)


def test_simulation_all_fixed_uses_drift():
    """All-fixed scenes skip contact mechanics entirely (dem_mode
    'drift') and still couple to the fluid through IMB."""
    cfg = _cfg(nx=64, ny=64, max_disks=2, gx=1e-5, g_py=0.0,
               bc_west="periodic", bc_east="periodic")
    specs = [DiskSpec(20.0, 32.0, 4.0, fixed=True),
             DiskSpec(44.0, 32.0, 4.0, vx=0.01, fixed=True)]
    sim = Simulation(cfg, specs)
    assert sim.dem_mode == "drift"
    sim.run(5)
    d = sim.disk_arrays()
    np.testing.assert_allclose(d["x"][0], [20.0, 32.0], atol=1e-6)
    np.testing.assert_allclose(d["x"][1], [44.0 + 5 * 0.01, 32.0],
                               atol=1e-5)
    # the body-force-driven channel exerts a downstream drag on the
    # stationary obstacle
    F, T = sim.hydro_forces()
    assert F[0, 0] > 0.0


def test_particle_file_rho_s_roundtrip(tmp_path):
    disks = [DiskSpec(10.0, 20.0, 3.0, rho_s=3.5),
             DiskSpec(40.0, 20.0, 2.0, fixed=True)]
    p = str(tmp_path / "disks.txt")
    save_particle_file(p, disks)
    assert load_particle_file(p) == disks


def test_per_disk_density_masses():
    """DiskSpec.rho_s overrides the global solid density per disk."""
    cfg = _cfg(max_disks=2, rho_s=2.0)
    specs = [DiskSpec(30.0, 30.0, 3.0), DiskSpec(60.0, 30.0, 3.0, rho_s=5.0)]
    d = dem.make_disk_state(specs, cfg, "float32")
    import math
    np.testing.assert_allclose(np.asarray(d.mass),
                               [2.0 * math.pi * 9, 5.0 * math.pi * 9],
                               rtol=1e-6)
    # denser disk accelerates less under the same applied force
    grid = DemGrid.build(cfg, 3.0)
    F = jnp.asarray([[0.0, -1.0], [0.0, -1.0]], jnp.float32)
    z1 = jnp.zeros((2,), jnp.float32)
    out, _, _ = jax.jit(dem.dem_subcycle, static_argnums=(3, 4))(
        d, F, z1, grid, cfg.replace(g_py=0.0))
    v = np.asarray(out.v)
    np.testing.assert_allclose(v[0, 1] / v[1, 1], 5.0 / 2.0, rtol=1e-4)


@pytest.mark.slow
def test_tow_equivalence():
    """Galilean check of the IMB obstacle coupling: a FIXED disk in a
    uniform stream U and a disk TOWED at -U through quiescent fluid
    (both fully periodic, no driving) are the same flow in different
    frames, so the relative velocity u_rel = <u_fluid> - v_disk must
    decay identically. The towed disk crosses cells (and the periodic
    seam), so agreement bounds the discretization error of moving-vs-
    static coverage stamping."""
    U = 0.04
    base = dict(nx=128, ny=96, tau=0.7, dtype="float64", max_disks=1,
                bc_west="periodic", bc_east="periodic",
                bc_south="periodic", bc_north="periodic", n_sub=1)
    steps = 800

    def u_rel(u0x, vx):
        cfg = SimConfig(u0x=u0x, **base)
        sim = Simulation(cfg, [DiskSpec(64.0, 48.0, 6.0, vx=vx, fixed=True)])
        sim.run(steps)
        rho, ux, _ = sim.macroscopic()
        return float(np.mean(ux)) - vx

    rel_fixed = u_rel(U, 0.0)
    rel_towed = u_rel(0.0, -U)
    assert rel_fixed < 0.98 * U  # the wake actually developed
    np.testing.assert_allclose(rel_towed, rel_fixed, rtol=0.02)


def test_fixed_drag_momentum_bookkeeping():
    """Fully periodic box, uniform initial flow, one fixed disk, no
    driving: the fluid's momentum loss each step equals the hydro force
    on the obstacle (the only momentum sink)."""
    cfg = SimConfig(nx=96, ny=96, tau=0.8, dtype="float64", max_disks=1,
                    bc_south="periodic", bc_north="periodic",
                    u0x=0.05, n_sub=1)
    specs = [DiskSpec(48.0, 48.0, 6.0, fixed=True)]
    sim = Simulation(cfg, specs)

    def px():
        ex = jnp.asarray([0, 1, 0, -1, 0, 1, -1, -1, 1.0], jnp.float64)
        return float(jnp.sum(sim.state.f * ex[:, None, None]))

    for _ in range(5):
        p0 = px()
        F, _ = sim.hydro_forces()  # force the NEXT collide will apply
        sim.step()
        np.testing.assert_allclose(px() - p0, -F[0, 0], rtol=1e-9,
                                   atol=1e-15)
        assert F[0, 0] > 0.0  # drag points downstream


def test_hydro_forces_on_mesh_matches_single_chip():
    """Simulation.hydro_forces() on a mesh-sharded run: the observation
    closure jits the oracle over the globally-sharded f without
    shard_map (fine single-chip); this pins its mesh behavior - the
    observed obstacle drag must match the single-chip observation of
    the identical (bitwise, XLA f64 path) state."""
    from lbmdem.parallel import make_mesh

    if len(jax.devices()) < 4:
        pytest.skip("need 4 devices")
    mesh = make_mesh(jax.devices()[:4], (2, 2))
    cfg = _cfg(max_disks=2, dtype="float64", gx=1e-5, g_py=0.0)
    specs = [DiskSpec(40.0, 64.0, 4.0, fixed=True),
             DiskSpec(80.0, 64.0, 4.0, fixed=True)]
    sim1 = Simulation(cfg, specs)
    simm = Simulation(cfg, specs, mesh=mesh)
    sim1.run(5)
    simm.run(5)
    np.testing.assert_array_equal(np.asarray(sim1.state.f),
                                  np.asarray(simm.state.f))
    F1, T1 = sim1.hydro_forces()
    Fm, Tm = simm.hydro_forces()
    np.testing.assert_allclose(Fm, F1, rtol=1e-12, atol=1e-18)
    np.testing.assert_allclose(Tm, T1, rtol=1e-12, atol=1e-18)
    assert F1[0, 0] > 0.0  # the body-force channel drags the obstacles
