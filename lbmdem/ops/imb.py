"""Noble-Torczynski immersed-moving-boundary (IMB) coupling.

Covers SURVEY.md SS2 C9 (solid-fraction field), C10 (NT modified
collision) and C12 (hydrodynamic force/torque reduction onto disks).

Design (fixed shapes):
- Each disk stamps its area coverage into a static `window x window`
  cell neighborhood around its center via subgrid sampling
  (`eps_samples^2` points per cell), vmapped over disks and combined
  with one scatter-add (C9). Out-of-window cells are impossible by
  construction of the window size; out-of-domain cells are masked.
  On a GPU the scatter-add uses atomics, so where windows overlap the
  summation order (and the last bits of eps) can change from run to
  run; on the CPU it is sequential and reproducible.
- The NT-blended collision is a pure elementwise field op fused by XLA
  (C10). It also emits a per-cell momentum-exchange field
  phi = -B * sum_i Omega_i e_i, the force per cell exerted on the solid
  phase.
- Per-disk forces/torques are recovered by *gathering* phi over each
  disk's window, weighted by that disk's share of the cell's total
  coverage (C12) - a gather, so the reduction itself needs no atomics
  (the reference uses CUDA atomicAdd here).

Sign convention: with Omega_i = f_opp - f_i + f_i^eq(rho,u_s) -
f_opp^eq(rho,u), the post-collision fluid momentum change per cell is
B sum_i Omega_i e_i; momentum conservation puts the opposite on the
solid, hence phi = -B sum_i Omega_i e_i is the force *on the disks*
(validated by the settling-velocity benchmark, tests/test_sedimentation.py).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from lbmdem import lattice
from lbmdem.config import SimConfig
from lbmdem.ops.lbm import equilibrium, guo_force_term, moments, smagorinsky_tau

_EPS_MIN = 1e-7


def exact_coverage(relx, rely, rr):
    """Analytic circle-cell overlap area (the "exact" eps_method).

    The cell is cut by the tangent line at the nearest boundary point,
    for which the half-plane x unit-square intersection area has a
    closed form; the mean circular-segment sliver the tangent line
    misses folds into an effective radius shift rc = r - 1/(24 r)
    (a per-disk SCALAR - the curvature correction costs zero vector
    ops). ~10x more accurate than 4x4 subgrid sampling at r >= 3 (see
    tests/test_imb.py accuracy test); assumes r >= 1 (below that the
    single center cell saturates wrongly). Offered for accuracy-critical
    runs; "sample" stays the default (the reference's model).

    Numerics: the textbook evaluation sums +-(S +- C)^2 terms whose f32
    cancellation is catastrophic for interior cells, so each difference
    h(t+B) - h(t) is factored as B * alpha * (v + u) with the B divided
    out analytically (alpha = clip(t2/B, 0, 1)); normal components are
    ordered so the small one only ever appears inside that clip, which
    degrades gracefully to the axis-aligned step limit at B == 0
    (disks sitting exactly on a cell row/column - common in packed
    initial conditions). Empty slots (rr == 0) yield zero coverage
    everywhere, including at distance 0 (the center-cell override is
    gated on rr > 0.81).
    """
    dt = relx.dtype
    ax = jnp.abs(relx)
    ay = jnp.abs(rely)
    A = jnp.maximum(ax, ay)
    Bc = jnp.minimum(ax, ay)
    d2 = relx * relx + rely * rely
    d = jnp.sqrt(d2)
    rc = rr - 1.0 / (24.0 * jnp.maximum(rr, 1e-6))
    S = d * (rc - d)
    C1 = 0.5 * (A - Bc)
    C2 = 0.5 * (A + Bc)
    t1 = S + C1
    t2 = S + C2
    t3 = S - C1
    t4 = S - C2
    u = jnp.maximum(t1, 0.0)
    v = jnp.maximum(t2, 0.0)
    p = jnp.maximum(t3, 0.0)
    q = jnp.maximum(t4, 0.0)
    inv_b = 1.0 / jnp.maximum(Bc, 1e-4)
    alpha = jnp.clip(t2 * inv_b, 0.0, 1.0)
    beta = jnp.clip(t3 * inv_b, 0.0, 1.0)
    num = alpha * (v + u) - beta * (p + q)
    cov = num * (0.5 / jnp.maximum(A, 1e-6))
    cov = jnp.clip(cov, 0.0, 1.0)
    full = jnp.asarray(rr > 0.81, dt)
    return jnp.where(d2 < 0.01, full, cov)


def _coverage_window(x, y, r, active, window: int, ns: int, dtype,
                     method="sample", r_shift=0.0):
    """Coverage of each cell in the disk's window, plus base cell indices.

    Returns (cov[window, window], by, bx): cov[wy, wx] is the sampled
    area fraction of cell (by+wy, bx+wx) inside the disk. `r_shift`
    (cfg.eps_r_shift) shrinks the hydrodynamic radius for the coverage
    evaluation only; empty slots (r == 0) stay empty.
    """
    if r_shift:
        r = jnp.where(r > 0, jnp.maximum(r + dtype.type(r_shift), 0.05), 0.0)
    half = window // 2
    bx = jnp.floor(x + 0.5).astype(jnp.int32) - half
    by = jnp.floor(y + 0.5).astype(jnp.int32) - half
    cells = jnp.arange(window, dtype=dtype)
    offs = (jnp.arange(ns, dtype=dtype) + 0.5) / ns - 0.5
    # Sample coordinates relative to disk center, separable in x and y.
    if method == "ramp":
        cy = (by.astype(dtype) + cells) - y  # (W,) cell-center offsets
        cx = (bx.astype(dtype) + cells) - x
        d = jnp.sqrt(cy[:, None] ** 2 + cx[None, :] ** 2)
        cov = jnp.clip(r + 0.5 - d, 0.0, 1.0)
    elif method == "exact":
        cy = (by.astype(dtype) + cells) - y
        cx = (bx.astype(dtype) + cells) - x
        cov = exact_coverage(
            jnp.broadcast_to(cx[None, :], (window, window)),
            jnp.broadcast_to(cy[:, None], (window, window)),
            r,
        )
    else:
        px = (bx.astype(dtype) + cells[:, None] + offs[None, :]) - x  # (W, ns)
        py = (by.astype(dtype) + cells[:, None] + offs[None, :]) - y
        dx2 = px * px  # (W, ns)
        # t-form: a sample is inside when dx^2 <= r^2 - dy^2
        t = r * r - py * py
        inside = dx2[None, :, None, :] <= t[:, None, :, None]
        cov = jnp.mean(inside.astype(dtype), axis=(2, 3))  # (Wy, Wx)
    return cov * active, by, bx


def stamp_solid_fraction(
    xp: jax.Array,  # (N, 2) disk centers
    vp: jax.Array,  # (N, 2) disk velocities
    omega: jax.Array,  # (N,) angular velocities
    r: jax.Array,  # (N,) radii
    active: jax.Array,  # (N,) 0/1 mask
    cfg: SimConfig,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Solid fraction + coverage-weighted solid velocity fields (C9).

    Returns (eps_raw, us_x, us_y):
      eps_raw: (ny, nx) unclipped sum of per-disk coverages (can exceed 1
               transiently where disks overlap during contact).
      us_x/us_y: (ny, nx) coverage-weighted mean solid velocity at each
               cell, including the rigid-rotation term v + omega x r.
    """
    W, ns = cfg.window, cfg.eps_samples
    dt = jnp.dtype(cfg.dtype)

    def one(px, py, vx, vy, om, rr, act):
        cov, by, bx = _coverage_window(px, py, rr, act, W, ns, dt,
                                       cfg.eps_method, cfg.eps_r_shift)
        iy = jnp.broadcast_to(by + jnp.arange(W, dtype=jnp.int32)[:, None], (W, W))
        ix = jnp.broadcast_to(bx + jnp.arange(W, dtype=jnp.int32)[None, :], (W, W))
        # NOTE: negative indices wrap in JAX even under scatter mode='drop',
        # so out-of-domain cells (incl. shard-local frames) must be masked
        # explicitly and their indices clipped.
        valid = (iy >= 0) & (iy < cfg.ny) & (ix >= 0) & (ix < cfg.nx)
        cov = jnp.where(valid, cov, 0.0)
        iy = jnp.clip(iy, 0, cfg.ny - 1)
        ix = jnp.clip(ix, 0, cfg.nx - 1)
        # Rigid-body velocity at each covered cell center.
        relx = ix.astype(dt) - px
        rely = iy.astype(dt) - py
        usx = vx + om * (-rely)
        usy = vy + om * relx
        # stack the three scattered channels so XLA emits ONE scatter
        vals = jnp.stack([cov, cov * usx, cov * usy], axis=-1)  # (W, W, 3)
        return vals, iy, ix

    vals, iy, ix = jax.vmap(one)(
        xp[:, 0], xp[:, 1], vp[:, 0], vp[:, 1], omega, r, active.astype(dt)
    )
    iy, ix = iy.reshape(-1), ix.reshape(-1)
    fields = jnp.zeros((cfg.ny, cfg.nx, 3), dt).at[iy, ix, :].add(
        vals.reshape(-1, 3)
    )
    eps = fields[..., 0]
    inv = 1.0 / jnp.maximum(eps, _EPS_MIN)
    return eps, fields[..., 1] * inv, fields[..., 2] * inv


def mask_open_columns(eps, usx, usy):
    """Force the open-boundary columns (global x = 0 and nx-1) to pure
    fluid by zeroing the stamped solid fields there.

    The Zou/He closure reconstructs the unknown populations assuming the
    boundary node is FLUID; a disk straddling the inlet/outlet stamping
    eps > 0 onto that column makes the prescribed-density/velocity
    constraint fight the NT solid collision and blows the column up
    (measured: rho collapses within ~20 steps of a disk reaching the
    outlet column). Zeroing the first/last column restricts the
    coupling to the disk's interior footprint - the standard
    outflow-zone truncation; with eps = 0 the NT blend reduces to pure
    BGK there and the momentum exchange phi (hence the hydro force
    contribution from that column) is exactly zero, so the force
    reduction needs no masking of its own. Callers apply this only on GLOBAL domain frames (the
    sharded paths mask shard-locally on the edge shards).
    """
    return (
        eps.at[:, 0].set(0.0).at[:, -1].set(0.0),
        usx.at[:, 0].set(0.0).at[:, -1].set(0.0),
        usy.at[:, 0].set(0.0).at[:, -1].set(0.0),
    )


# --- periodic ghost disks -------------------------------------------
#
# The stamp/reduce paths work in absolute cell coordinates, so a disk
# whose window crosses a periodic edge must ALSO stamp on the wrapped
# side. Rather than teaching the stamp to wrap, disks near a periodic
# edge get a "ghost": a min-image shifted copy appended to the arrays
# fed to stamping and reduction. Ghost hydro forces fold
# back into their parents afterwards. Contacts do NOT use ghosts - the
# DEM broadphase wraps cell adjacency and the pair law uses minimum-
# image distances (ops/dem.py).


def default_ghost_cap(n: int, cfg: SimConfig) -> int:
    """Per-block ghost capacity: the expected near-edge disk count for a
    uniform spatial distribution, with 4x headroom (the paranoid channel
    counts overflow, so a burst is detected, never silent)."""
    t = cfg.window // 2 + 2
    frac = 0.0
    if cfg.wrap_lx:
        frac = max(frac, 2.0 * t / cfg.wrap_lx)
    if cfg.wrap_ly:
        frac = max(frac, 2.0 * t / cfg.wrap_ly)
    cap = int(4.0 * n * frac) + 8
    return min((cap + 7) & ~7, max(n, 8))


def ghost_selection(
    x: jax.Array, active: jax.Array, cfg: SimConfig
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Fixed-capacity selection of disks needing a periodic ghost.

    Returns (parent (G,) i32 with -1 = empty slot, axes (G, 2) i32 with
    1 where the ghost shifts on that axis, overflow () i32). G is
    static: cfg.ghost_cap slots per needed block (x-edge, y-edge,
    corner); zero periodic axes give G == 0. The ghost SHIFT itself is
    computed from the parent's side at apply time (`apply_ghosts`).
    """
    lx, ly = cfg.wrap_lx, cfg.wrap_ly
    cap = cfg.ghost_cap
    if not (lx or ly):
        z = jnp.zeros((0,), jnp.int32)
        return z, jnp.zeros((0, 2), jnp.int32), jnp.zeros((), jnp.int32)
    assert cap > 0, "cfg.ghost_cap must be set (Simulation derives it)"
    t = cfg.window // 2 + 2

    kk = min(cap, x.shape[0])  # top_k cannot exceed the row count
    pad = jnp.full((cap - kk,), -1, jnp.int32)

    def pack(flag):
        vals, idx = jax.lax.top_k(flag.astype(jnp.float32), kk)
        parent = jnp.where(vals > 0, idx.astype(jnp.int32), -1)
        ovf = (jnp.sum(flag, dtype=jnp.int32)
               - jnp.sum(vals > 0, dtype=jnp.int32))
        return jnp.concatenate([parent, pad]), ovf

    near_x = active & ((x[:, 0] < t) | (x[:, 0] > lx - 1 - t)) if lx else None
    near_y = active & ((x[:, 1] < t) | (x[:, 1] > ly - 1 - t)) if ly else None
    parents, axes, ovf = [], [], jnp.zeros((), jnp.int32)
    blocks = []
    if lx:
        blocks.append((near_x, (1, 0)))
    if ly:
        blocks.append((near_y, (0, 1)))
    if lx and ly:
        blocks.append((near_x & near_y, (1, 1)))
    for flag, ax in blocks:
        p, o = pack(flag)
        parents.append(p)
        axes.append(jnp.broadcast_to(jnp.asarray(ax, jnp.int32), (cap, 2)))
        ovf = ovf + o
    return jnp.concatenate(parents), jnp.concatenate(axes), ovf


def apply_ghosts(
    parent: jax.Array, axes: jax.Array, x, v, omega, r, active,
    cfg: SimConfig,
):
    """Append min-image shifted ghost rows to the disk arrays.

    The shift side is chosen from the parent's position (a parent in
    the west half gets its ghost at +L, east half at -L). Returns
    (x_aug, v_aug, omega_aug, r_aug, active_aug) with N + G rows; empty
    slots are inactive and parked far outside the domain.
    """
    G = parent.shape[0]
    if G == 0:
        return x, v, omega, r, active
    ok = parent >= 0
    j = jnp.maximum(parent, 0)
    gx = x[j]
    dt = x.dtype
    cols = [gx[:, 0], gx[:, 1]]
    for a, L in ((0, cfg.wrap_lx), (1, cfg.wrap_ly)):
        if L:
            c = cols[a]
            shifted = jnp.where(c < 0.5 * (L - 1.0), c + L, c - L)
            cols[a] = jnp.where(axes[:, a] > 0, shifted, c)
    gxy = jnp.stack(cols, axis=1)
    g_act = ok & active[j]
    gxy = jnp.where(g_act[:, None], gxy, jnp.asarray(-1e6, dt))
    return (
        jnp.concatenate([x, gxy]),
        jnp.concatenate([v, jnp.where(g_act[:, None], v[j], 0.0)]),
        jnp.concatenate([omega, jnp.where(g_act, omega[j], 0.0)]),
        jnp.concatenate([r, jnp.where(g_act, r[j], 1.0)]),
        jnp.concatenate([active, g_act]),
    )


def fold_ghost_forces(
    F: jax.Array, T: jax.Array, parent: jax.Array, n: int
) -> Tuple[jax.Array, jax.Array]:
    """Sum ghost-row hydro forces/torques back into their parents (a
    scatter-add: atomics on a GPU, see the module docstring)."""
    if parent.shape[0] == 0:
        return F, T
    j = jnp.where(parent >= 0, parent, n)  # n = out of bounds -> dropped
    return (
        F[:n].at[j].add(F[n:], mode="drop"),
        T[:n].at[j].add(T[n:], mode="drop"),
    )


def periodic_ghosts(x, v, omega, r, active, cfg: SimConfig):
    """Wrap + select + augment in one call — the sanctioned entry point
    for every coupling path (positions must wrap EXACTLY at selection
    points, see wrap_positions). Returns (x_wrapped, augmented_arrays,
    parent, axes, overflow) where augmented_arrays is the
    (x, v, omega, r, active) tuple with ghost rows appended."""
    xw = wrap_positions(x, active, cfg)
    parent, axes, ovf = ghost_selection(xw, active, cfg)
    aug = apply_ghosts(parent, axes, xw, v, omega, r, active, cfg)
    return xw, aug, parent, axes, ovf


def wrap_positions(x: jax.Array, active: jax.Array, cfg: SimConfig):
    """Wrap ACTIVE disk centers into the periodic domain [-1/2, L-1/2).

    Inactive slots are parked far outside the domain on purpose
    (make_disk_state) and must stay there. Idempotent for in-domain
    positions."""
    lx, ly = cfg.wrap_lx, cfg.wrap_ly
    if not (lx or ly):
        return x
    cols = [x[:, 0], x[:, 1]]
    for a, L in ((0, lx), (1, ly)):
        if L:
            c = cols[a]
            cols[a] = c - L * jnp.floor((c + 0.5) / L)
    return jnp.where(active[:, None], jnp.stack(cols, axis=1), x)


def nt_weight(eps: jax.Array, tau, mode: str = "nt") -> jax.Array:
    """Noble-Torczynski blending B(eps, tau) = eps tm / ((1-eps) + tm).

    mode="nt" (default): tm = tau - 1/2, the published NT weight.
    mode="lambda" (cfg.nt_mode, VERDICT r4 #7): tm = tau^- - 1/2 =
    Lambda/(tau - 1/2) with Lambda = 3/16 - the TRT odd relaxation
    rate that places plane bounce-back walls exactly mid-link. The NT
    solid operator Omega_s is a non-equilibrium bounce-back, i.e. an
    ODD-mode operation, so a Lambda-consistent blend weights it by the
    odd relaxation depth instead of the even (viscous) one. Measured
    verdict on the 2D-1 cylinder drag at D=20 lives in
    docs/performance.md (the A/B this flag exists for)."""
    tm = tau - 0.5
    if mode == "lambda":
        tm = 0.1875 / tm
    return eps * tm / ((1.0 - eps) + tm)


def collide_imb(
    f: jax.Array,
    eps_raw: jax.Array,
    us_x: jax.Array,
    us_y: jax.Array,
    cfg: SimConfig,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """NT-blended BGK/TRT collision (C10) + momentum-exchange field (C12).

    f <- f - (1-B)[(f - f_eq)/tau - S_i] + B Omega_i,
    Omega_i = f_opp - f_i + f_i^eq(rho, u_s) - f_opp^eq(rho, u).

    Returns (f_post, phi_x, phi_y) with phi = -B sum_i Omega_i e_i, the
    per-cell force on the solid phase.
    """
    dt = f.dtype
    tau = cfg.tau
    rho, ux, uy = moments(f, cfg.gx, cfg.gy)
    feq = equilibrium(rho, ux, uy)
    tau_eff = (
        smagorinsky_tau(f, feq, rho, tau, cfg.smagorinsky)
        if cfg.smagorinsky > 0.0
        else tau
    )
    eps = jnp.clip(eps_raw, 0.0, 1.0)
    B = nt_weight(eps, tau_eff, cfg.nt_mode)

    feq_s = equilibrium(rho, us_x, us_y)
    opp = lattice.OPP  # numpy index array -> static gather
    f_opp = f[opp]
    feq_opp = feq[opp]
    omega_s = f_opp - f + feq_s - feq_opp

    trt = cfg.trt_lambda
    forced = cfg.gx != 0.0 or cfg.gy != 0.0
    if trt <= 0.0:
        fpost = f - (1.0 - B) * (f - feq) / tau_eff + B * omega_s
        if forced:
            fpost = fpost + (1.0 - B) * guo_force_term(
                ux, uy, tau_eff, cfg.gx, cfg.gy
            )
    else:
        # TRT fluid relaxation under the same (1-B) NT blend: even/odd
        # parts of f - feq relax at 1/tau and 1/tau- (lbm.collide)
        from lbmdem.ops.lbm import _guo_proj, trt_tau_minus

        tau_m = trt_tau_minus(tau_eff, trt)
        ne = f - feq
        ne_o = ne[opp]
        relax = (0.5 / tau_eff) * (ne + ne_o) + (0.5 / tau_m) * (ne - ne_o)
        fpost = f - (1.0 - B) * relax + B * omega_s
        if forced:
            S = _guo_proj(ux, uy, cfg.gx, cfg.gy)
            S_o = S[opp]
            src = (1.0 - 0.5 / tau_eff) * 0.5 * (S + S_o) + (
                1.0 - 0.5 / tau_m
            ) * 0.5 * (S - S_o)
            fpost = fpost + (1.0 - B) * src

    ex = jnp.asarray(lattice.EX, dt)[:, None, None]
    ey = jnp.asarray(lattice.EY, dt)[:, None, None]
    phi_x = -jnp.sum(B * omega_s * ex, axis=0)
    phi_y = -jnp.sum(B * omega_s * ey, axis=0)
    return fpost, phi_x, phi_y


def reduce_hydro_forces(
    xp: jax.Array,
    r: jax.Array,
    active: jax.Array,
    eps_raw: jax.Array,
    phi_x: jax.Array,
    phi_y: jax.Array,
    cfg: SimConfig,
) -> Tuple[jax.Array, jax.Array]:
    """Per-disk hydrodynamic force (N,2) and torque (N,) from phi (C12).

    Each disk gathers phi over its stamp window, weighted by its share
    of the cell's total coverage, so overlapping disks split a cell's
    momentum exchange proportionally. Gather-based, so it needs no
    atomics and is trivially correct under vmap.
    """
    W, ns = cfg.window, cfg.eps_samples
    dt = phi_x.dtype
    # one fused gather for (eps, phi_x, phi_y)
    fields = jnp.stack([eps_raw, phi_x, phi_y], axis=-1)

    def one(px, py, rr, act):
        cov, by, bx = _coverage_window(px, py, rr, act, W, ns, dt,
                                       cfg.eps_method, cfg.eps_r_shift)
        iy = by + jnp.arange(W, dtype=jnp.int32)[:, None]
        ix = bx + jnp.arange(W, dtype=jnp.int32)[None, :]
        # Negative indices wrap in JAX gathers: mask + clip explicitly.
        valid = (iy >= 0) & (iy < cfg.ny) & (ix >= 0) & (ix < cfg.nx)
        iyc = jnp.clip(iy, 0, cfg.ny - 1)
        ixc = jnp.clip(ix, 0, cfg.nx - 1)
        g = fields[iyc, ixc]  # (W, W, 3)
        tot = jnp.where(valid, g[..., 0], 1.0)
        share = cov * valid / jnp.maximum(tot, _EPS_MIN)
        fx_c = g[..., 1] * share
        fy_c = g[..., 2] * share
        relx = ix.astype(dt) - px
        rely = iy.astype(dt) - py
        fx = jnp.sum(fx_c)
        fy = jnp.sum(fy_c)
        tq = jnp.sum(relx * fy_c - rely * fx_c)
        return jnp.stack([fx, fy]), tq

    F, T = jax.vmap(one)(xp[:, 0], xp[:, 1], r, active.astype(dt))
    return F, T
