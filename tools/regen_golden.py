"""Regenerate the pinned f64 oracle golden trajectories (tests/golden/).

The goldens pin the repo's float64 oracle under the DEFAULT SimConfig
numerics (SURVEY SS0: the C reference is unavailable, so the oracle is
ground truth; the force-balance test anchors the absolute scale). Run
this ONLY when a deliberate physics-model change (e.g. the eps_method
default) moves the oracle itself, then re-run the full suite and
tools/validate.py:

    python -m tools.regen_golden
"""

import os

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

from lbmdem.config import DiskSpec, SimConfig  # noqa: E402
from lbmdem.simulation import Simulation, make_step_fn  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "..", "tests", "golden")


def _run(cfg, disks, chunks, every, record):
    sim = Simulation(cfg, disks)
    step = make_step_fn(sim.cfg, sim.grid)
    chunk = jax.jit(
        lambda st: jax.lax.fori_loop(0, every, lambda _, x: step(x), st)
    )
    s = sim.state
    rows = []
    for _ in range(chunks):
        s = chunk(s)
        rows.append(record(s))
    return np.asarray(rows)


def settling(nx, path, fmt):
    cfg = SimConfig(nx=nx, ny=192, tau=0.65, dtype="float64", g_py=-2e-5,
                    rho_s=1.5, kn=0.5, gamma_n=1.0, n_sub=10, buoyancy=True,
                    bc_west="wall", bc_east="wall")
    x0 = nx / 2 + 0.3
    if fmt == "test":  # tests/test_sedimentation.py: step y vy
        rows = _run(cfg, [DiskSpec(x0, 150.0, 5.0)], 30, 100,
                    lambda s: (int(s.step), float(s.disks.x[0, 1]),
                               float(s.disks.v[0, 1])))
        np.savetxt(path, rows, header="step y vy")
    else:  # tools/validate.py: step,x,y,vx,vy (csv + header)
        rows = _run(cfg, [DiskSpec(x0, 150.0, 5.0)], 30, 100,
                    lambda s: (int(s.step),
                               float(s.disks.x[0, 0]), float(s.disks.x[0, 1]),
                               float(s.disks.v[0, 0]), float(s.disks.v[0, 1])))
        np.savetxt(path, rows, delimiter=",", header="step,x,y,vx,vy",
                   comments="")
    print(f"wrote {path} (final vy {rows[-1, -1]:.6e})")


def dkt(nx, path, fmt):
    cfg = SimConfig(nx=nx, ny=256, tau=0.56, dtype="float64", g_py=-1e-4,
                    rho_s=2.0, kn=1.0, gamma_n=1.0, mu=0.1, n_sub=10,
                    buoyancy=True, bc_west="wall", bc_east="wall")
    x0 = nx / 2
    disks = [DiskSpec(x0 + 0.2, 220.0, 5.0), DiskSpec(x0 - 0.2, 204.0, 5.0)]
    if fmt == "test":  # tests: step x0 y0 x1 y1, 12 chunks of 250
        rows = _run(cfg, disks, 12, 250,
                    lambda s: (int(s.step),
                               float(s.disks.x[0, 0]), float(s.disks.x[0, 1]),
                               float(s.disks.x[1, 0]), float(s.disks.x[1, 1])))
        np.savetxt(path, rows, header="step x0 y0 x1 y1")
    else:  # tools/validate.py: step,x0,y0,x1,y1,vy0,vy1 csv, 30 x 100
        rows = _run(cfg, disks, 30, 100,
                    lambda s: (int(s.step),
                               float(s.disks.x[0, 0]), float(s.disks.x[0, 1]),
                               float(s.disks.x[1, 0]), float(s.disks.x[1, 1]),
                               float(s.disks.v[0, 1]), float(s.disks.v[1, 1])))
        np.savetxt(path, rows, delimiter=",",
                   header="step,x0,y0,x1,y1,vy0,vy1", comments="")
    print(f"wrote {path}")


if __name__ == "__main__":
    settling(64, os.path.join(GOLDEN, "settling_r5_f64.csv"), "test")
    settling(128, os.path.join(GOLDEN, "settling_r5_nx128_f64.csv"), "device")
    dkt(64, os.path.join(GOLDEN, "dkt_f64.csv"), "test")
    dkt(128, os.path.join(GOLDEN, "dkt_nx128_f64.csv"), "device")
