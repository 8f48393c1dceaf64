"""Card-only checks: the f32 step compiled for the GPU against the f64
step on the CPU. Marked `gpu`; the `gpu` fixture skips them where JAX
finds no GPU. On a card:

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/

Tolerances as in test_xla_step.py (f32 rounding over two steps), which
also cover the GPU's atomic scatter-adds: they reorder the stamp's sums
from run to run, a last-bit effect on eps.
"""

import jax
import numpy as np
import pytest

from lbmdem.config import DiskSpec, SimConfig
from lbmdem.simulation import Simulation, make_step_fn

pytestmark = pytest.mark.gpu


def _pair(gpu, dtype_hi="float64", **kw):
    cfg = dict(nx=64, ny=48, tau=0.8, g_py=-1e-4, rho_s=2.0, kn=0.5,
               gamma_n=0.5, n_sub=4, bc_west="wall", bc_east="wall", **kw)
    disks = [DiskSpec(20.0, 24.0, 3.0, vx=0.01),
             DiskSpec(20.3, 29.9, 3.0), DiskSpec(45.0, 12.2, 2.5)]
    with jax.default_device(gpu):
        a = Simulation(SimConfig(dtype="float32", **cfg), disks)
        sa = jax.jit(make_step_fn(a.cfg, a.grid))
        st_a = sa(sa(a.state))
    with jax.default_device(jax.devices("cpu")[0]):
        b = Simulation(SimConfig(dtype=dtype_hi, **cfg), disks)
        sb = jax.jit(make_step_fn(b.cfg, b.grid))
        st_b = sb(sb(b.state))
    return st_a, st_b


@pytest.mark.parametrize("extra", [dict(), dict(eps_method="ramp"),
                                   dict(kt=0.4, gamma_t=0.2, mu=0.3)])
def test_gpu_coupled_step_matches_cpu_f64(gpu, extra):
    st_a, st_b = _pair(gpu, **extra)
    assert list(st_a.f.devices())[0].platform == "gpu"
    np.testing.assert_allclose(np.asarray(st_a.f), np.asarray(st_b.f),
                               rtol=0, atol=2e-6)
    np.testing.assert_allclose(np.asarray(st_a.disks.x),
                               np.asarray(st_b.disks.x), rtol=0, atol=1e-5)
    assert int(st_a.overflow) == 0
