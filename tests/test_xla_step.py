"""The float32 step (the path the GPU runs) against the float64 step,
the chunked driver against single steps, and shifted-bf16 storage.

Tolerances: one f32 step rounds each of ~100 operations per population
to 2^-24 relative, on values f ~ w_i (<= 4/9); two steps of that stay
below ~1e-6 absolute, far below any physics difference (a wrong
boundary or forcing term moves f by >= 1e-4 on these states).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lbmdem import lattice
from lbmdem.config import DiskSpec, SimConfig
from lbmdem.ops import lbm
from lbmdem.simulation import Simulation, make_step_fn

# The boundary/collision matrix the fused-kernel tests covered: periodic
# and wall sides, forcing, LES, moving walls, TRT (+ LES), open BCs.
FLUID_CASES = [
    dict(),  # periodic x, walls y
    dict(bc_west="wall", bc_east="wall"),
    dict(bc_south="periodic", bc_north="periodic"),
    dict(gx=1e-5, gy=-2e-5),
    dict(bc_west="wall", bc_east="wall", gy=-1e-5),
    dict(smagorinsky=0.16, gx=2e-5),
    dict(bc_west="wall", bc_east="wall", uw_north=0.08),
    dict(bc_west="wall", bc_east="wall", uw_west=0.05, uw_south=-0.02,
         uw_east=-0.03, uw_north=0.04),
    dict(collision="trt"),
    dict(collision="trt", bc_west="wall", bc_east="wall", gx=2e-5),
    dict(collision="trt", smagorinsky=0.16, gx=1e-5),
    dict(bc_west="inlet", bc_east="outlet", u_inlet=0.05,
         inlet_profile="poiseuille"),
    dict(bc_west="inlet", bc_east="outlet", u_inlet=0.04,
         bc_south="periodic", bc_north="periodic"),
]

COUPLED_CASES = [
    dict(),
    dict(eps_method="ramp"),
    dict(eps_method="exact", eps_r_shift=-0.3),
    dict(collision="trt", gx=1e-5),
    dict(kt=0.4, gamma_t=0.2, mu=0.3),
    dict(bc_west="periodic", bc_east="periodic"),
    dict(bc_west="inlet", bc_east="outlet", u_inlet=0.04),
]


def _rand_f(ny, nx, dtype, seed=0):
    rng = np.random.default_rng(seed)
    base = lattice.W[:, None, None]
    pert = 1.0 + 0.05 * rng.standard_normal((9, ny, nx))
    return jnp.asarray(base * pert, dtype)


def _coupled_scene(**extra):
    kw = dict(nx=48, ny=32, tau=0.8, g_py=-1e-4, buoyancy=True,
              rho_s=2.0, kn=0.5, gamma_n=0.5, n_sub=4,
              bc_west="wall", bc_east="wall")
    kw.update(extra)
    disks = [DiskSpec(14.0, 16.0, 3.0, vx=0.01),
             DiskSpec(14.3, 21.9, 3.0, omega=0.004),
             DiskSpec(33.0, 10.2, 2.5, vx=-0.01)]
    return kw, disks


@pytest.mark.parametrize("overrides", FLUID_CASES)
def test_fluid_f32_step_matches_f64(overrides):
    cfg32 = SimConfig(nx=48, ny=16, tau=0.8, dtype="float32", **overrides)
    cfg64 = cfg32.replace(dtype="float64")
    f64 = _rand_f(16, 48, jnp.float64)
    f32 = f64.astype(jnp.float32)
    s32 = jax.jit(lambda f: lbm.step_pure_fluid(lbm.step_pure_fluid(
        f, cfg32), cfg32))
    s64 = jax.jit(lambda f: lbm.step_pure_fluid(lbm.step_pure_fluid(
        f, cfg64), cfg64))
    got, ref = np.asarray(s32(f32)), np.asarray(s64(f64))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("overrides", COUPLED_CASES)
def test_coupled_f32_step_matches_f64(overrides):
    """The whole coupled step (stamp, NT collide, stream, boundaries,
    force reduction, DEM subcycle) in f32 vs f64 over two steps. Disk
    positions move ~1e-2 cells per step; f32 keeps them to ~1e-6."""
    kw, disks = _coupled_scene(**overrides)
    s32 = Simulation(SimConfig(dtype="float32", **kw), disks)
    s64 = Simulation(SimConfig(dtype="float64", **kw), disks)
    a, b = s32.state, s64.state
    st32 = jax.jit(make_step_fn(s32.cfg, s32.grid))
    st64 = jax.jit(make_step_fn(s64.cfg, s64.grid))
    for _ in range(2):
        a, b = st32(a), st64(b)
    assert int(a.overflow) == 0 and int(b.overflow) == 0
    np.testing.assert_allclose(np.asarray(a.f), np.asarray(b.f),
                               rtol=0, atol=2e-6)
    np.testing.assert_allclose(np.asarray(a.disks.x), np.asarray(b.disks.x),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(a.disks.v), np.asarray(b.disks.v),
                               rtol=0, atol=1e-6)
    assert int(a.n_contacts) == int(b.n_contacts)


_CHUNK_CASES = [
    (dict(nx=32, ny=16, tau=0.8, gx=1e-5), False),
    (dict(nx=32, ny=16, tau=0.7, bc_west="wall", bc_east="wall",
          uw_north=0.05, collision="trt"), False),
    (dict(nx=32, ny=16, tau=0.8, bc_west="inlet", bc_east="outlet",
          u_inlet=0.05, inlet_profile="poiseuille"), False),
    (dict(nx=32, ny=16, tau=0.8, gx=1e-5, f_storage="bfloat16"), False),
    (dict(), True),
    (dict(bc_west="periodic", bc_east="periodic"), True),
]


@pytest.mark.parametrize("cfg_kw,coupled", _CHUNK_CASES)
def test_run_chunk_matches_step_calls(cfg_kw, coupled):
    """Simulation.run(n) (one jitted fori_loop chunk, state donated) ==
    n Simulation.step() calls, bitwise: the chunk is the same step."""
    disks = []
    if coupled:
        cfg_kw, disks = _coupled_scene(**cfg_kw)
    cfg = SimConfig(dtype="float32", out_interval=5, **cfg_kw)
    a, b = Simulation(cfg, disks), Simulation(cfg, disks)
    a.run(5)
    for _ in range(5):
        b.step()
    assert int(a.state.step) == int(b.state.step) == 5
    np.testing.assert_array_equal(np.asarray(a.state.f, np.float32),
                                  np.asarray(b.state.f, np.float32))
    np.testing.assert_array_equal(np.asarray(a.state.disks.x),
                                  np.asarray(b.state.disks.x))


def test_bf16_rest_state_exact():
    """Shifted storage's design invariant: equilibrium at rest is
    g = feq - w*rho0 = 0 EXACTLY in bf16, and stays exactly 0 through
    unforced steps."""
    cfg = SimConfig(nx=32, ny=16, tau=0.8, f_storage="bfloat16",
                    bc_west="wall", bc_east="wall")
    sim = Simulation(cfg)
    assert sim.state.f.dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(sim.state.f, np.float32), 0.0)
    sim.run(3)
    np.testing.assert_array_equal(np.asarray(sim.state.f, np.float32), 0.0)


@pytest.mark.parametrize("overrides,coupled", [
    (dict(gx=1e-5), False),
    (dict(bc_west="inlet", bc_east="outlet", u_inlet=0.05), False),
    (dict(), True),
])
def test_bf16_step_is_quantized_f32_step(overrides, coupled):
    """The bf16 step is exactly: dequantize -> f32 step -> requantize
    (one storage rounding per step), checked against that emulation
    built from the f32 config."""
    disks = []
    if coupled:
        kw, disks = _coupled_scene(**overrides)
    else:
        kw = dict(nx=32, ny=16, tau=0.8, **overrides)
    cfg = SimConfig(f_storage="bfloat16", **kw)
    cfg32 = cfg.replace(f_storage="float32")
    sim = Simulation(cfg, disks)
    ref = Simulation(cfg32, disks)
    f0 = lbm.to_storage(_rand_f(cfg.ny, cfg.nx, jnp.float32, seed=3), cfg)
    st_b = jax.jit(make_step_fn(sim.cfg, sim.grid))
    st_f = jax.jit(make_step_fn(ref.cfg, ref.grid))
    a = sim.state._replace(f=f0)
    b = ref.state._replace(f=lbm.from_storage(f0, cfg))
    a = st_b(a)
    b = st_f(b)
    emu = lbm.to_storage(b.f, cfg)
    assert a.f.dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(a.f, np.float32),
                                  np.asarray(emu, np.float32))


def test_bf16_tracks_f32_over_many_steps():
    """bf16 storage rounds g (|g| ~ w Ma) to 8 mantissa bits (2^-8
    relative) every step; through the 200-step forced start-up those
    roundings accumulate (about 2% here), so the velocity field stays
    within 5% of the f32 run's peak velocity - a bound a wrong shift or
    a lost forcing term breaks by orders of magnitude."""
    kw = dict(nx=32, ny=24, tau=0.8, gx=1e-5, bc_west="periodic",
              bc_east="periodic")
    a = Simulation(SimConfig(**kw, f_storage="bfloat16"))
    b = Simulation(SimConfig(**kw))
    a.run(200)
    b.run(200)
    _, ua, _ = a.macroscopic()
    _, ub, _ = b.macroscopic()
    assert np.abs(ub).max() > 1e-4
    assert np.abs(ua - ub).max() < 0.05 * np.abs(ub).max()
