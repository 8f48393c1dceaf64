"""Pure-fluid D2Q9 LBM ops, plain-JAX reference implementation.

Covers SURVEY.md SS2 C2 (equilibrium), C3 (BGK collide), C4 (streaming),
C5 (macroscopic moments incl. Guo half-force correction), C6 (half-way
bounce-back walls, optionally moving), C7 (Guo body force) and C8
(Smagorinsky LES relaxation time).

This module is a straightforward, vectorized implementation: it is the
reference the tests hold every configuration to, and the production
path, jitted whole by XLA (the elementwise collide chain fuses; each
streamed population is a shifted copy).

Array convention: `f` has shape (9, ny, nx), indexed [i, y, x]; cell
(iy, ix) center at (x=ix, y=iy) lattice units. See `lattice.py`.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from lbmdem import lattice
from lbmdem.config import SimConfig, WALL


def equilibrium(rho: jax.Array, ux: jax.Array, uy: jax.Array) -> jax.Array:
    """f_eq_i = w_i rho [1 + 3(e.u) + 9/2 (e.u)^2 - 3/2 u^2]  (C2)."""
    dt = rho.dtype
    w = jnp.asarray(lattice.W, dt)[:, None, None]
    ex = jnp.asarray(lattice.EX, dt)[:, None, None]
    ey = jnp.asarray(lattice.EY, dt)[:, None, None]
    eu = ex * ux + ey * uy
    usq = ux * ux + uy * uy
    return w * rho * (1.0 + 3.0 * eu + 4.5 * eu * eu - 1.5 * usq)


def moments(
    f: jax.Array, gx: float = 0.0, gy: float = 0.0
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """rho = sum_i f_i; u = (sum_i f_i e_i + F/2) / rho  (C5).

    The + F/2 term is the standard second-order velocity shift that
    accompanies Guo forcing; with zero body force it reduces to the
    bare first moment.
    """
    dt = f.dtype
    ex = jnp.asarray(lattice.EX, dt)[:, None, None]
    ey = jnp.asarray(lattice.EY, dt)[:, None, None]
    rho = jnp.sum(f, axis=0)
    inv_rho = 1.0 / rho
    ux = (jnp.sum(f * ex, axis=0) + 0.5 * gx) * inv_rho
    uy = (jnp.sum(f * ey, axis=0) + 0.5 * gy) * inv_rho
    return rho, ux, uy


def storage_shift(cfg: SimConfig):
    """Per-population storage shift of f, or None for plain storage.

    f_storage='bfloat16' stores g_i = f_i - w_i*rho0 (the rest state is
    exactly 0 in bf16, and the residual g ~ O(w Ma) keeps the 8-bit
    mantissa on the hydrodynamic signal instead of the w_i DC term).
    Moments of g need only a rho0 offset: sum(w)=1, sum(w e)=0."""
    if cfg.f_storage == "bfloat16":
        return (lattice.W * cfg.rho0).astype(np.float32)[:, None, None]
    return None


def to_storage(f: jax.Array, cfg: SimConfig) -> jax.Array:
    """Physical f (compute dtype) -> stored representation (shifted
    bf16 when cfg.f_storage='bfloat16', identity otherwise)."""
    s = storage_shift(cfg)
    if s is None:
        return f
    return (f - s).astype(jnp.bfloat16)


def from_storage(fs: jax.Array, cfg: SimConfig) -> jax.Array:
    """Stored representation -> physical f in float32."""
    s = storage_shift(cfg)
    if s is None:
        return fs
    return fs.astype(jnp.float32) + s


def smagorinsky_tau(
    f: jax.Array, feq: jax.Array, rho: jax.Array, tau0: float, cs_const: float
) -> jax.Array:
    """Effective relaxation time from the non-equilibrium stress (C8).

    Pi_ab = sum_i e_ia e_ib (f_i - f_eq_i);  ||Pi|| = sqrt(Pi:Pi);
    tau_eff = 1/2 (tau0 + sqrt(tau0^2 + 18 sqrt(2) Cs^2 ||Pi|| / rho)).
    Reduces to tau0 when the flow is at equilibrium.
    """
    dt = f.dtype
    ex = jnp.asarray(lattice.EX, dt)[:, None, None]
    ey = jnp.asarray(lattice.EY, dt)[:, None, None]
    fneq = f - feq
    pxx = jnp.sum(fneq * ex * ex, axis=0)
    pyy = jnp.sum(fneq * ey * ey, axis=0)
    pxy = jnp.sum(fneq * ex * ey, axis=0)
    pnorm = jnp.sqrt(pxx * pxx + pyy * pyy + 2.0 * pxy * pxy)
    # a Python float is weakly typed: the result keeps f's dtype
    c = 18.0 * float(np.sqrt(2.0)) * cs_const * cs_const
    return 0.5 * (tau0 + jnp.sqrt(tau0 * tau0 + c * pnorm / rho))


def _guo_proj(ux: jax.Array, uy: jax.Array, gx: float, gy: float) -> jax.Array:
    """w_i [3 (e_i - u) + 9 (e_i . u) e_i] . F — the Guo projection
    WITHOUT the relaxation prefactor (BGK and TRT scale it differently)."""
    dt = ux.dtype
    w = jnp.asarray(lattice.W, dt)[:, None, None]
    ex = jnp.asarray(lattice.EX, dt)[:, None, None]
    ey = jnp.asarray(lattice.EY, dt)[:, None, None]
    eu = ex * ux + ey * uy
    proj = 3.0 * ((ex - ux) * gx + (ey - uy) * gy) + 9.0 * eu * (ex * gx + ey * gy)
    return w * proj


def guo_force_term(
    ux: jax.Array, uy: jax.Array, tau, gx: float, gy: float
) -> jax.Array:
    """Guo et al. forcing source S_i (C7), to be added post-relaxation.

    S_i = w_i (1 - 1/(2 tau)) [3 (e_i - u) + 9 (e_i . u) e_i] . F
    `tau` may be a scalar or a per-cell array (LES).
    """
    return (1.0 - 0.5 / tau) * _guo_proj(ux, uy, gx, gy)


def trt_tau_minus(tau, trt_magic: float):
    """Odd-moment relaxation time from the magic parameter:
    Lambda = (tau+ - 1/2)(tau- - 1/2). `tau` may be a per-cell array."""
    return 0.5 + trt_magic / (tau - 0.5)


def collide(
    f: jax.Array,
    tau: float,
    gx: float = 0.0,
    gy: float = 0.0,
    smagorinsky: float = 0.0,
    trt_magic: float = 0.0,
) -> jax.Array:
    """BGK/TRT relaxation + optional Guo forcing + optional LES
    (C3/C7/C8; trt_magic > 0 selects TRT, see SimConfig.collision).

    TRT: the even/odd parts of f - feq (under e -> -e) relax at 1/tau
    and 1/tau-, with tau- from the magic parameter (trt_tau_minus).
    tau keeps setting the viscosity (and the LES closure); the Guo
    source splits the same way, each part scaled by (1 - 1/(2 tau±)).
    """
    rho, ux, uy = moments(f, gx, gy)
    feq = equilibrium(rho, ux, uy)
    tau_eff = (
        smagorinsky_tau(f, feq, rho, tau, smagorinsky) if smagorinsky > 0.0 else tau
    )
    forced = gx != 0.0 or gy != 0.0
    if trt_magic <= 0.0:
        fpost = f - (f - feq) / tau_eff
        if forced:
            fpost = fpost + guo_force_term(ux, uy, tau_eff, gx, gy)
        return fpost
    opp = lattice.OPP
    tau_m = trt_tau_minus(tau_eff, trt_magic)
    ne = f - feq
    ne_o = ne[opp]
    fpost = (
        f
        - (0.5 / tau_eff) * (ne + ne_o)
        - (0.5 / tau_m) * (ne - ne_o)
    )
    if forced:
        S = _guo_proj(ux, uy, gx, gy)
        S_o = S[opp]
        fpost = (
            fpost
            + (1.0 - 0.5 / tau_eff) * 0.5 * (S + S_o)
            + (1.0 - 0.5 / tau_m) * 0.5 * (S - S_o)
        )
    return fpost


def stream(fpost: jax.Array) -> jax.Array:
    """Periodic pull streaming: f_i(x, t+1) = f_i^post(x - e_i, t)  (C4).

    Implemented as a circular shift by +e_i per population; domain-edge
    corrections (walls) are applied afterwards by `apply_bounce_back`.
    A permutation of cells per population => conserves every moment's
    global sum exactly (up to FP reordering: it's a pure gather).

    The optimization barrier makes XLA write f_post out before the
    shifted reads. Without it XLA fuses the collision into the streaming
    fusion, which then reads the loop-carried f while writing the new
    one, so every step of a jitted loop ends with a full copy of f back
    into the carry buffer (on an H100 at 4096^2: a 0.39 ms memcpy per
    2.2 ms step; with the barrier the copy is gone, 2.13 ms/step).
    """
    fpost = jax.lax.optimization_barrier(fpost)
    out = []
    for i in range(lattice.Q):
        ex, ey = int(lattice.E[i, 0]), int(lattice.E[i, 1])
        out.append(jnp.roll(fpost[i], shift=(ey, ex), axis=(0, 1)))
    return jnp.stack(out)


def apply_bounce_back(
    fnew: jax.Array,
    fpost: jax.Array,
    cfg: SimConfig,
    wall_speed: Tuple[float, float, float, float] = None,
) -> jax.Array:
    """Half-way bounce-back at wall sides (C6).

    For a boundary cell x_b and a link i whose reverse crosses the wall:
        f_i(x_b, t+1) = f_opp(i)^post(x_b, t) + 6 w_i rho0 (e_i . u_w)
    The wall sits half a link outside the outermost cell centers. The
    optional tangential wall speeds (west, east, south, north) give
    moving-wall (lid-driven-cavity) support; rho_w is approximated by
    the reference density rho0.

    Corners are consistent: a diagonal population at a corner cell is
    assigned the same value by both adjacent sides' rules.
    """
    dt = fnew.dtype
    w = lattice.W
    e = lattice.E
    opp = lattice.OPP
    if wall_speed is None:
        wall_speed = (cfg.uw_west, cfg.uw_east, cfg.uw_south, cfg.uw_north)
    uw_w, uw_e, uw_s, uw_n = wall_speed
    rho0 = cfg.rho0

    def fix(fnew, idxs, sl_y, sl_x, uwx, uwy):
        for i in idxs:
            i = int(i)
            corr = lattice.wall_corr(i, uwx, uwy, rho0)
            fnew = fnew.at[i, sl_y, sl_x].set(
                fpost[int(opp[i]), sl_y, sl_x] + jnp.asarray(corr, dt)
            )
        return fnew

    all_y, all_x = slice(None), slice(None)
    if cfg.bc_south == WALL:  # wall below row 0; set populations with ey=+1
        fnew = fix(fnew, lattice.IN_N, 0, all_x, uw_s, 0.0)
    if cfg.bc_north == WALL:  # wall above row ny-1; set populations with ey=-1
        fnew = fix(fnew, lattice.IN_S, cfg.ny - 1, all_x, uw_n, 0.0)
    if cfg.bc_west == WALL:  # wall left of col 0; set populations with ex=+1
        fnew = fix(fnew, lattice.IN_E, all_y, 0, 0.0, uw_w)
    if cfg.bc_east == WALL:  # wall right of col nx-1; set populations with ex=-1
        fnew = fix(fnew, lattice.IN_W, all_y, cfg.nx - 1, 0.0, uw_e)
    return fnew


def inlet_profile_array(cfg: SimConfig) -> np.ndarray:
    """(ny,) inlet x-velocity profile (host constant, baked into jit).

    'poiseuille' peaks at u_inlet mid-channel and hits zero exactly at
    the half-way wall planes y = -1/2 and ny - 1/2, matching the
    bounce-back wall position."""
    y = np.arange(cfg.ny, dtype=np.float64) + 0.5
    H = float(cfg.ny)
    if cfg.inlet_profile == "poiseuille":
        return (4.0 * cfg.u_inlet / (H * H) * y * (H - y)).astype(cfg.dtype)
    return np.full(cfg.ny, cfg.u_inlet, cfg.dtype)


def zou_he_inlet(fs, uw):
    """Zou/He west-inlet closure: reconstruct the unknown populations
    (1, 5, 8) at an inlet cell with prescribed u = (uw, 0) from the
    post-stream knowns of the SAME cell:
        rho = (f0 + f2 + f4 + 2 (f3 + f6 + f7)) / (1 - uw)
        f1 = f3 + (2/3) rho u
        f5 = f7 - (f2 - f4)/2 + (1/6) rho u
        f8 = f6 + (f2 - f4)/2 + (1/6) rho u
    `fs` is the 9-sequence of same-shaped arrays. THE single definition
    shared by the single-device step and the sharded edge fixup (the
    closure algebra must never diverge between them)."""
    f0, f1, f2, f3, f4, f5, f6, f7, f8 = fs
    knowns = f0 + f2 + f4 + 2.0 * (f3 + f6 + f7)
    rho_w = knowns / (1.0 - uw)
    d24 = 0.5 * (f2 - f4)
    ru = rho_w * uw
    return (f3 + (2.0 / 3.0) * ru,
            f7 - d24 + (1.0 / 6.0) * ru,
            f6 + d24 + (1.0 / 6.0) * ru)


def zou_he_outlet(fs, rho_o):
    """Zou/He east-outlet closure (prescribed rho = rho_o, v = 0):
    reconstruct populations (3, 7, 6) with the normal velocity from
        u = -1 + (f0 + f2 + f4 + 2 (f1 + f5 + f8)) / rho_o."""
    f0, f1, f2, f3, f4, f5, f6, f7, f8 = fs
    knowns = f0 + f2 + f4 + 2.0 * (f1 + f5 + f8)
    ue = -1.0 + knowns / rho_o
    d24 = 0.5 * (f2 - f4)
    rue = rho_o * ue
    return (f1 - (2.0 / 3.0) * rue,
            f5 + d24 - (1.0 / 6.0) * rue,
            f8 - d24 - (1.0 / 6.0) * rue)


def apply_open_boundaries(fnew: jax.Array, cfg: SimConfig) -> jax.Array:
    """Zou/He open boundaries (zou_he_inlet / zou_he_outlet closures).

    Applied AFTER bounce-back so wall corners supply the tangential
    knowns (f2/f4); with the poiseuille profile u -> 0 there, the
    corner closure degrades gracefully to a resting-wall cell."""
    if cfg.bc_west != "inlet":
        return fnew
    dt = fnew.dtype
    u_in = jnp.asarray(inlet_profile_array(cfg), dt)  # (ny,)

    f1, f5, f8 = zou_he_inlet(tuple(fnew[i, :, 0] for i in range(9)), u_in)
    rho_o = jnp.asarray(cfg.rho_outlet or cfg.rho0, dt)
    f3, f7, f6 = zou_he_outlet(tuple(fnew[i, :, -1] for i in range(9)), rho_o)
    fnew = fnew.at[1, :, 0].set(f1)
    fnew = fnew.at[5, :, 0].set(f5)
    fnew = fnew.at[8, :, 0].set(f8)
    fnew = fnew.at[3, :, -1].set(f3)
    fnew = fnew.at[7, :, -1].set(f7)
    fnew = fnew.at[6, :, -1].set(f6)
    return fnew


def step_pure_fluid(
    f: jax.Array,
    cfg: SimConfig,
    wall_speed: Tuple[float, float, float, float] = None,
) -> jax.Array:
    """One pure-fluid LBM step (SURVEY SS3.3 fast path): collide-stream-BB."""
    fpost = collide(f, cfg.tau, cfg.gx, cfg.gy, cfg.smagorinsky,
                    cfg.trt_lambda)
    fnew = stream(fpost)
    fnew = apply_bounce_back(fnew, fpost, cfg, wall_speed)
    return apply_open_boundaries(fnew, cfg)


def init_equilibrium(cfg: SimConfig) -> jax.Array:
    """Initial distributions at (rho0, u0) (SURVEY SS3.1 initEquilibrium)."""
    dt = cfg.np_dtype
    shape = (cfg.ny, cfg.nx)
    rho = jnp.full(shape, cfg.rho0, dt)
    ux = jnp.full(shape, cfg.u0x, dt)
    uy = jnp.full(shape, cfg.u0y, dt)
    return equilibrium(rho, ux, uy)
