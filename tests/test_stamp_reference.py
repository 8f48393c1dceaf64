"""Solid-fraction stamp and hydrodynamic force reduction against an
independent numpy reference (per-disk, per-cell loops; f64).

The reference visits every cell within r + 1 of each disk center
instead of the stamp's static window, so it also checks that the
window covers the disk. Sample membership uses the same inequality
(dx^2 <= r^2 - dy^2), so in f64 the two agree to roundoff.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from lbmdem.config import SimConfig, window_for_radius
from lbmdem.ops import imb

_EPS_MIN = 1e-7


def _scene(seed=0, n=6, nx=40, ny=32):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.uniform(6.0, nx - 6.0, n),
                  rng.uniform(6.0, ny - 6.0, n)], axis=1)
    x[1] = x[0] + [4.1, 1.3]  # an overlapping pair shares cells
    v = rng.uniform(-0.02, 0.02, (n, 2))
    om = rng.uniform(-0.01, 0.01, n)
    r = rng.uniform(2.0, 3.5, n)
    act = np.ones(n, bool)
    act[-1] = False  # an inactive slot stamps nothing
    return x, v, om, r, act


def _coverage(px, py, r, cx, cy, method, ns, r_shift):
    """Coverage of cell (cx, cy) (center at integer coords) by a disk."""
    if r_shift:
        r = max(r + r_shift, 0.05)
    if method == "ramp":
        d = np.hypot(cx - px, cy - py)
        return min(max(r + 0.5 - d, 0.0), 1.0)
    offs = (np.arange(ns) + 0.5) / ns - 0.5
    hits = 0
    for oy in offs:
        dy = cy + oy - py
        t = r * r - dy * dy
        for ox in offs:
            dx = cx + ox - px
            hits += dx * dx <= t
    return hits / (ns * ns)


def _ref_covers(cfg, x, r, act):
    """{disk: {(iy, ix): coverage}} over every in-domain cell near it."""
    out = {}
    for i in range(len(r)):
        out[i] = {}
        if not act[i]:
            continue
        reach = int(np.ceil(r[i])) + 1
        cx0, cy0 = int(np.floor(x[i, 0])), int(np.floor(x[i, 1]))
        for iy in range(cy0 - reach, cy0 + reach + 2):
            for ix in range(cx0 - reach, cx0 + reach + 2):
                if not (0 <= iy < cfg.ny and 0 <= ix < cfg.nx):
                    continue
                c = _coverage(x[i, 0], x[i, 1], r[i], ix, iy,
                              cfg.eps_method, cfg.eps_samples,
                              cfg.eps_r_shift)
                if c > 0:
                    out[i][(iy, ix)] = c
    return out


def _ref_stamp(cfg, x, v, om, r, act):
    eps = np.zeros((cfg.ny, cfg.nx))
    mx = np.zeros_like(eps)
    my = np.zeros_like(eps)
    for i, cells in _ref_covers(cfg, x, r, act).items():
        for (iy, ix), c in cells.items():
            eps[iy, ix] += c
            mx[iy, ix] += c * (v[i, 0] - om[i] * (iy - x[i, 1]))
            my[iy, ix] += c * (v[i, 1] + om[i] * (ix - x[i, 0]))
    inv = 1.0 / np.maximum(eps, _EPS_MIN)
    return eps, mx * inv, my * inv


def _cfg(method, r_shift=0.0):
    return SimConfig(nx=40, ny=32, dtype="float64", max_disks=6,
                     window=window_for_radius(3.5), eps_method=method,
                     eps_r_shift=r_shift)


def _jax_args(x, v, om, r, act):
    return (jnp.asarray(x), jnp.asarray(v), jnp.asarray(om),
            jnp.asarray(r), jnp.asarray(act))


_METHODS = [("sample", 0.0), ("ramp", 0.0), ("sample", -0.35),
            ("ramp", -0.2)]


@pytest.mark.parametrize("method,r_shift", _METHODS)
def test_stamp_matches_numpy_reference(method, r_shift):
    cfg = _cfg(method, r_shift)
    x, v, om, r, act = _scene(seed=1)
    eps, usx, usy = imb.stamp_solid_fraction(*_jax_args(x, v, om, r, act),
                                             cfg)
    e_ref, ux_ref, uy_ref = _ref_stamp(cfg, x, v, om, r, act)
    np.testing.assert_allclose(np.asarray(eps), e_ref, rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(usx), ux_ref, rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(usy), uy_ref, rtol=0, atol=1e-12)


@pytest.mark.parametrize("method,r_shift", _METHODS)
def test_reduce_matches_numpy_reference(method, r_shift):
    """Per-disk force and torque: phi gathered over each disk's cells,
    weighted by the disk's share of the cell's total coverage."""
    cfg = _cfg(method, r_shift)
    x, v, om, r, act = _scene(seed=2)
    rng = np.random.default_rng(3)
    phix = rng.standard_normal((cfg.ny, cfg.nx))
    phiy = rng.standard_normal((cfg.ny, cfg.nx))
    eps, _, _ = _ref_stamp(cfg, x, v, om, r, act)
    F, T = imb.reduce_hydro_forces(jnp.asarray(x), jnp.asarray(r),
                                   jnp.asarray(act), jnp.asarray(eps),
                                   jnp.asarray(phix), jnp.asarray(phiy),
                                   cfg)
    F_ref = np.zeros((len(r), 2))
    T_ref = np.zeros(len(r))
    for i, cells in _ref_covers(cfg, x, r, act).items():
        for (iy, ix), c in cells.items():
            share = c / max(eps[iy, ix], _EPS_MIN)
            fx, fy = phix[iy, ix] * share, phiy[iy, ix] * share
            F_ref[i] += (fx, fy)
            T_ref[i] += (ix - x[i, 0]) * fy - (iy - x[i, 1]) * fx
    np.testing.assert_allclose(np.asarray(F), F_ref, rtol=0, atol=1e-11)
    np.testing.assert_allclose(np.asarray(T), T_ref, rtol=0, atol=1e-10)
    assert np.all(np.asarray(F)[~act] == 0.0)


@pytest.mark.parametrize("method", ["sample", "ramp"])
def test_stamp_per_disk_area(method):
    """Each isolated disk stamps its own area: pi r^2 to the coverage
    model's accuracy (4x4 sampling ~ a few %, the ramp's linear profile
    integrates to pi r^2 + pi/12 exactly in the continuum limit)."""
    cfg = _cfg(method).replace(max_disks=3)
    x = np.array([[8.3, 8.1], [20.0, 16.4], [31.2, 23.7]])
    r = np.array([2.0, 3.0, 3.5])
    z2 = np.zeros((3, 2))
    eps, _, _ = imb.stamp_solid_fraction(
        *_jax_args(x, z2, np.zeros(3), r, np.ones(3, bool)), cfg)
    eps = np.asarray(eps)
    for (px, py), rr in zip(x, r):
        iy0, ix0 = int(py) - 5, int(px) - 5
        area = eps[iy0:iy0 + 11, ix0:ix0 + 11].sum()
        assert abs(area - np.pi * rr * rr) < 0.05 * np.pi * rr * rr


def test_reduce_momentum_balance():
    """The reduction splits every covered cell's phi among the disks
    covering it (shares sum to 1), so the summed per-disk force equals
    phi summed over the covered cells - no momentum is lost or made,
    even where disks overlap."""
    cfg = _cfg("sample")
    x, v, om, r, act = _scene(seed=4)
    eps, _, _ = imb.stamp_solid_fraction(*_jax_args(x, v, om, r, act), cfg)
    rng = np.random.default_rng(5)
    phix = jnp.asarray(rng.standard_normal((cfg.ny, cfg.nx)))
    phiy = jnp.asarray(rng.standard_normal((cfg.ny, cfg.nx)))
    F, _ = imb.reduce_hydro_forces(jnp.asarray(x), jnp.asarray(r),
                                   jnp.asarray(act), eps, phix, phiy, cfg)
    covered = np.asarray(eps) > 0
    np.testing.assert_allclose(
        np.asarray(F).sum(axis=0),
        [np.asarray(phix)[covered].sum(), np.asarray(phiy)[covered].sum()],
        rtol=1e-12, atol=1e-12)
