"""Pure-fluid LBM oracle tests: equilibrium, streaming, bounce-back,
Poiseuille channel (BASELINE config #1), lid-driven cavity no-slip.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lbmdem import lattice
from lbmdem.config import SimConfig
from lbmdem.ops import lbm
from lbmdem.simulation import Simulation


def _rand_f(ny, nx, seed=0, dtype=jnp.float64):
    rng = np.random.default_rng(seed)
    base = lattice.W[:, None, None] * np.ones((9, ny, nx))
    return jnp.asarray(base * (1.0 + 0.01 * rng.standard_normal((9, ny, nx))), dtype)


def test_equilibrium_moments_exact():
    rho = jnp.asarray(np.random.default_rng(1).uniform(0.8, 1.2, (4, 6)))
    ux = jnp.full((4, 6), 0.03, jnp.float64)
    uy = jnp.full((4, 6), -0.02, jnp.float64)
    feq = lbm.equilibrium(rho, ux, uy)
    r2, u2x, u2y = lbm.moments(feq)
    np.testing.assert_allclose(r2, rho, rtol=1e-14)
    np.testing.assert_allclose(u2x, ux, atol=1e-14)
    np.testing.assert_allclose(u2y, uy, atol=1e-14)
    # second moment: sum feq e e = rho (cs2 I + u u)
    pxx = jnp.sum(feq * (lattice.EX**2)[:, None, None], axis=0)
    np.testing.assert_allclose(pxx, rho * (lattice.CS2 + ux * ux), rtol=1e-12)


def test_stream_is_permutation():
    f = _rand_f(8, 16)
    fs = lbm.stream(f)
    # per-population global sums conserved exactly (pure gather)
    np.testing.assert_array_equal(
        np.sort(np.asarray(f).reshape(9, -1)), np.sort(np.asarray(fs).reshape(9, -1))
    )


def test_rest_state_is_fixed_point():
    cfg = SimConfig(nx=12, ny=10, tau=0.8, bc_west="wall", bc_east="wall",
                    dtype="float64")
    f0 = lbm.init_equilibrium(cfg)
    f = f0
    for _ in range(5):
        f = lbm.step_pure_fluid(f, cfg)
    np.testing.assert_allclose(np.asarray(f), np.asarray(f0), atol=1e-14)


def test_mass_conserved_with_walls():
    cfg = SimConfig(nx=16, ny=12, tau=0.7, dtype="float64")
    f = _rand_f(12, 16)
    m0 = float(jnp.sum(f))
    for _ in range(20):
        f = lbm.step_pure_fluid(f, cfg)
    assert abs(float(jnp.sum(f)) - m0) < 1e-11 * m0


def test_poiseuille_profile():
    """BASELINE config #1: gravity-driven channel vs analytic parabola."""
    ny, nx = 32, 4
    tau, g = 0.9, 1e-6
    cfg = SimConfig(nx=nx, ny=ny, tau=tau, gx=g, dtype="float64",
                    out_interval=2000)
    sim = Simulation(cfg)
    sim.run(16000)
    _, ux, _ = sim.macroscopic()
    prof = ux.mean(axis=1)
    y = np.arange(ny) + 0.5  # wall at y=-0.5 -> distance from wall
    H = float(ny)
    analytic = g / (2.0 * cfg.nu) * y * (H - y)
    # rtol covers the bulk; atol covers the O(1e-7) half-way-BB discrete
    # slip at the near-wall cells (0.02% of u_max).
    np.testing.assert_allclose(prof, analytic, rtol=2e-3, atol=3e-7)


def test_trt_poiseuille_exact_walls():
    """The TRT selling point: with magic Lambda = 3/16 the half-way
    bounce-back wall sits EXACTLY mid-link at any tau, so body-force
    Poiseuille converges to the discrete parabola to near machine
    precision - while BGK's wall slip error grows ~(tau - 1/2)^2."""
    ny, nx = 24, 4
    tau, g = 1.5, 1e-6  # coarse channel + large tau: worst case for BGK
    y = np.arange(ny) + 0.5
    H = float(ny)

    def profile_err(collision):
        cfg = SimConfig(nx=nx, ny=ny, tau=tau, gx=g, dtype="float64",
                        collision=collision)
        nu = cfg.nu
        analytic = g / (2.0 * nu) * y * (H - y)
        sim = Simulation(cfg)
        sim.run(12000)
        _, ux, _ = sim.macroscopic()
        prof = ux.mean(axis=1)
        return float(np.max(np.abs(prof - analytic)) / analytic.max())

    err_bgk = profile_err("bgk")
    err_trt = profile_err("trt")
    assert err_trt < 1e-9, f"TRT(3/16) Poiseuille not exact: {err_trt}"
    assert err_bgk > 100 * err_trt  # and BGK really is the one slipping


def test_trt_reduces_to_bgk_at_matched_rates():
    """With Lambda = (tau - 1/2)^2 both rates equal 1/tau: TRT == BGK."""
    cfg_b = SimConfig(nx=16, ny=12, tau=0.8, gx=1e-5, dtype="float64")
    lam = (cfg_b.tau - 0.5) ** 2
    cfg_t = cfg_b.replace(collision="trt", trt_magic=lam)
    f = _rand_f(12, 16)
    fb, ft = f, f
    for _ in range(3):
        fb = lbm.step_pure_fluid(fb, cfg_b)
        ft = lbm.step_pure_fluid(ft, cfg_t)
    np.testing.assert_allclose(np.asarray(ft), np.asarray(fb), rtol=1e-13,
                               atol=1e-18)


def test_cavity_no_slip_and_circulation():
    """Moving north lid: no-slip at static walls, lid drags fluid."""
    cfg = SimConfig(nx=24, ny=24, tau=0.8, bc_west="wall", bc_east="wall",
                    dtype="float64")
    f = lbm.init_equilibrium(cfg)
    step = jax.jit(lambda f: lbm.step_pure_fluid(f, cfg, wall_speed=(0, 0, 0, 0.05)))
    for _ in range(3000):
        f = step(f)
    rho, ux, uy = lbm.moments(f)
    ux = np.asarray(ux)
    # fluid near the lid moves with it; near the bottom it back-flows
    assert ux[-1].mean() > 0.02
    assert ux[1].mean() < 0.0
    # mass conserved
    assert abs(float(jnp.sum(f)) / (cfg.nx * cfg.ny) - 1.0) < 1e-10


def test_smagorinsky_reduces_to_bgk_at_equilibrium():
    cfg = SimConfig(nx=8, ny=8, tau=0.8, dtype="float64")
    f = lbm.init_equilibrium(cfg)
    f_les = lbm.collide(f, cfg.tau, smagorinsky=0.1)
    f_bgk = lbm.collide(f, cfg.tau)
    np.testing.assert_allclose(np.asarray(f_les), np.asarray(f_bgk), atol=1e-14)


def test_taylor_green_viscosity():
    """Taylor-Green vortex decay: the measured exponential decay rate
    recovers nu = (tau - 1/2)/3 within 1% (quantitative transport
    validation, fully periodic)."""
    n = 64
    tau = 0.8
    cfg = SimConfig(nx=n, ny=n, tau=tau, dtype="float64",
                    bc_south="periodic", bc_north="periodic")
    k = 2.0 * np.pi / n
    u0 = 0.01
    x = np.arange(n)[None, :] * 1.0
    y = np.arange(n)[:, None] * 1.0
    ux = -u0 * np.cos(k * x) * np.sin(k * y)
    uy = u0 * np.sin(k * x) * np.cos(k * y)
    rho = 1.0 - (3.0 * u0 * u0 / 4.0) * (np.cos(2 * k * x) + np.cos(2 * k * y))
    f = lbm.equilibrium(jnp.asarray(rho), jnp.asarray(ux), jnp.asarray(uy))

    step = jax.jit(lambda g: lbm.step_pure_fluid(g, cfg))
    def ke(g):
        r, vx, vy = lbm.moments(g)
        return float(jnp.sum(r * (vx * vx + vy * vy)))

    t_skip, t_meas = 200, 800  # skip the initialization transient
    for _ in range(t_skip):
        f = step(f)
    e1 = ke(f)
    for _ in range(t_meas):
        f = step(f)
    e2 = ke(f)
    # KE ~ exp(-4 nu k^2 t)
    nu_meas = -np.log(e2 / e1) / (4.0 * k * k * t_meas)
    nu_true = (tau - 0.5) / 3.0
    assert abs(nu_meas / nu_true - 1.0) < 0.01, (nu_meas, nu_true)


def test_taylor_green_viscous_decay():
    """Doubly-periodic Taylor-Green vortex vs the analytic Navier-Stokes
    solution: kinetic energy decays as exp(-4 nu k^2 t). An INDEPENDENT
    analytic validation of the viscosity calibration nu = (tau-1/2)/3
    and the periodic streaming (the channel/cavity legs pin walls; this
    pins the bulk operator)."""
    n = 64
    tau = 0.8
    nu = (tau - 0.5) / 3.0
    cfg = SimConfig(nx=n, ny=n, tau=tau, dtype="float64",
                    bc_south="periodic", bc_north="periodic")
    k = 2.0 * np.pi / n
    u0 = 0.02
    x = (jnp.arange(n, dtype=jnp.float64))[None, :] * k
    y = (jnp.arange(n, dtype=jnp.float64))[:, None] * k
    ux = -u0 * jnp.cos(x) * jnp.sin(y)
    uy = u0 * jnp.sin(x) * jnp.cos(y)
    # consistent initial pressure field (else an acoustic transient
    # rings for ~n/cs steps and pollutes the early decay)
    rho = 1.0 - (3.0 * u0 * u0 / 4.0) * (jnp.cos(2 * x) + jnp.cos(2 * y))
    f = lbm.equilibrium(rho, ux, uy)

    @jax.jit
    def chunk(f):
        return jax.lax.fori_loop(
            0, 100, lambda _, g: lbm.step_pure_fluid(g, cfg), f
        )

    def ke(f):
        _, vx, vy = lbm.moments(f)
        return float(jnp.sum(vx * vx + vy * vy))

    f = chunk(f)  # settle the O(Ma^2) initialization transient
    e1 = ke(f)
    for _ in range(3):
        f = chunk(f)
    e2 = ke(f)
    rate = -np.log(e2 / e1) / 300.0
    analytic = 4.0 * nu * k * k
    err = abs(rate - analytic) / analytic
    assert err < 0.02, (
        f"TGV decay rate {rate:.6e} vs analytic {analytic:.6e} "
        f"({err:.2%} off, budget 2%)"
    )
