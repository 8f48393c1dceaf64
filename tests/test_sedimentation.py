"""BASELINE config #2/#3 physics benchmarks (SURVEY.md SS4):
single-disk settling (force balance, precision parity, golden
trajectory regression) and drafting-kissing-tumbling signature.

Settling-velocity parity is THE metric (BASELINE.json). The C reference
is unavailable (SURVEY SS0), so the oracle float64 trajectory is the
pinned ground truth: the force-balance identity (hydro force -> net
buoyant weight at terminal state) validates the absolute force scale
against first principles, and the golden CSV guards regressions.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lbmdem.config import DiskSpec, SimConfig
from lbmdem.ops import imb
from lbmdem.simulation import Simulation, make_step_fn

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _settling_cfg(dtype="float64"):
    return SimConfig(nx=64, ny=192, tau=0.65, dtype=dtype, g_py=-2e-5,
                     rho_s=1.5, kn=0.5, gamma_n=1.0, n_sub=10, buoyancy=True,
                     bc_west="wall", bc_east="wall")


def _run(cfg, disks, steps, every=100):
    sim = Simulation(cfg, disks)
    step = make_step_fn(sim.cfg, sim.grid)
    chunk = jax.jit(lambda st: jax.lax.fori_loop(0, every, lambda _, x: step(x), st))
    s = sim.state
    rows = []
    for _ in range(steps // every):
        s = chunk(s)
        rows.append((int(s.step), float(s.disks.x[0, 1]), float(s.disks.v[0, 1])))
    return sim, s, np.asarray(rows)


@pytest.fixture(scope="module")
def settling_f64():
    """One 3000-step f64 settling run shared by the force-balance/golden
    and fp32-parity tests (rows are logged every 100 steps)."""
    cfg = _settling_cfg()
    sim, s, rows = _run(cfg, [DiskSpec(32.3, 150.0, 5.0)], 3000)
    return cfg, sim, s, rows


def test_settling_force_balance_and_golden(settling_f64):
    cfg, sim, s, rows = settling_f64

    # near-terminal: y-acceleration decayed to <4%/100 steps
    v1, v2 = rows[-2, 2], rows[-1, 2]
    assert abs(v2 - v1) < 0.04 * abs(v2)
    # sanity band for the settling velocity
    assert 5e-4 < -v2 < 5e-3

    # force balance: hydro force supports ~ the net buoyant weight
    d = s.disks
    eps, usx, usy = imb.stamp_solid_fraction(d.x, d.v, d.omega, d.r, d.active, sim.cfg)
    _, phix, phiy = imb.collide_imb(s.f, eps, usx, usy, sim.cfg)
    F, _ = imb.reduce_hydro_forces(d.x, d.r, d.active, eps, phix, phiy, sim.cfg)
    weight = (cfg.rho_s - 1.0) * np.pi * 25.0 * 2e-5
    assert abs(float(F[0, 1]) / weight - 1.0) < 0.03

    # mass conservation through the coupled run
    assert abs(float(jnp.sum(s.f)) / (cfg.nx * cfg.ny) - 1.0) < 1e-9

    # golden regression: trajectory matches the pinned oracle run
    gold = np.loadtxt(os.path.join(GOLDEN, "settling_r5_f64.csv"))
    np.testing.assert_allclose(rows[:, 1], gold[:, 1], rtol=1e-8)
    np.testing.assert_allclose(rows[:, 2], gold[:, 2], rtol=1e-6, atol=1e-12)


def test_settling_fp32_parity(settling_f64):
    """FP32 must track the FP64 trajectory within the <1% parity budget.

    The f64 side reuses the shared 3000-step run's row at step 2000
    (rows are every 100 steps; index 19)."""
    *_, r64 = settling_f64
    _, _, r32 = _run(_settling_cfg("float32"), [DiskSpec(32.3, 150.0, 5.0)], 2000)
    row64 = r64[19]
    assert int(row64[0]) == 2000 == int(r32[-1, 0])
    v64, v32 = row64[2], r32[-1, 2]
    assert abs(v32 - v64) < 0.01 * abs(v64)
    assert abs(r32[-1, 1] - row64[1]) < 0.05  # position drift < 0.05 cells


@pytest.fixture(scope="module")
def dkt_run():
    """One 3000-step DKT two-disk f64 run shared by the drafting and
    golden-trajectory tests (12 chunks of 250 steps)."""
    cfg = SimConfig(nx=64, ny=256, tau=0.56, dtype="float64", g_py=-1e-4,
                    rho_s=2.0, kn=1.0, gamma_n=1.0, mu=0.1, n_sub=10,
                    buoyancy=True, bc_west="wall", bc_east="wall")
    disks = [DiskSpec(32.2, 220.0, 5.0), DiskSpec(31.8, 204.0, 5.0)]
    sim = Simulation(cfg, disks)
    step = make_step_fn(sim.cfg, sim.grid, False)
    chunk = jax.jit(lambda st: jax.lax.fori_loop(0, 250, lambda _, x: step(x), st))
    s = sim.state
    gap0 = float(s.disks.x[0, 1] - s.disks.x[1, 1])
    rows = []
    for _ in range(12):
        s = chunk(s)
        rows.append((int(s.step),
                     float(s.disks.x[0, 0]), float(s.disks.x[0, 1]),
                     float(s.disks.x[1, 0]), float(s.disks.x[1, 1])))
    return gap0, s, np.asarray(rows)


def test_dkt_drafting(dkt_run):
    """Two-disk DKT (config #3): the trailing disk drafts in the leader's
    wake and closes the gap - the defining early-phase signature.
    Re ~ 10 at terminal: drafting closes the 16-cell gap by >3 cells
    within 3000 steps (verified against the oracle run)."""
    gap0, s, _ = dkt_run
    gap1 = float(s.disks.x[0, 1] - s.disks.x[1, 1])
    assert gap1 < gap0 - 3.0, f"no drafting: gap {gap0} -> {gap1}"
    # both falling
    assert float(s.disks.v[0, 1]) < 0 and float(s.disks.v[1, 1]) < 0
    # trailing disk falls faster (wake suction)
    assert float(s.disks.v[0, 1]) < float(s.disks.v[1, 1])


def test_dkt_golden_trajectory(dkt_run):
    """Regression-pin the DKT two-disk trajectory (f64 oracle)."""
    *_, rows = dkt_run
    gold = np.loadtxt(os.path.join(GOLDEN, "dkt_f64.csv"))
    np.testing.assert_allclose(rows, gold, rtol=1e-7, atol=1e-9)
