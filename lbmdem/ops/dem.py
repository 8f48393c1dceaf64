"""Discrete-element method for circular disks.

Covers SURVEY.md SS2 C13 (broadphase), C14 (spring-dashpot contacts),
C15 (wall contacts) and C16 (velocity-Verlet integration with DEM
subcycling inside the jitted step).

Design:
- Fixed-capacity cell list (C13): disks are bucketed into a uniform
  grid of cells (side >= 2 r_max) with a static per-cell capacity K.
  The table is built with one sort + rank trick (deterministic, no
  atomics); overflowing entries are *counted* and surfaced as a
  diagnostic instead of being silently dropped (SURVEY SS7 hard parts).
- Narrowphase (C14) evaluates all 9K candidate pairs per disk with
  masked vectorized math - no data-dependent shapes. Each disk computes
  the force on itself from every neighbor, so Newton's third law holds
  by antisymmetry of the formulas (tested).
- Tangential friction: with kt > 0, a contact-history spring (Cundall-
  Strack / Luding): the tangential stretch xi integrates v_t while the
  contact persists, force -kt xi - gamma_t v_t with Coulomb cap
  mu |F_n| and slip-consistent xi truncation. History lives in fixed
  (N, contact_cap) slots carried in DiskState and is re-matched to the
  new candidate list by partner id each LBM step. With kt == 0, a
  tangential dashpot with the same Coulomb cap.
- Integration (C16) is velocity-Verlet with one force evaluation per
  substep (force carried across substeps), run as a `lax.scan` of
  `n_sub` substeps per LBM step, entirely on device.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from lbmdem.config import SimConfig, WALL


@dataclasses.dataclass(frozen=True)
class DemGrid:
    """Static broadphase grid geometry (baked into the jitted step)."""

    cell_size: float
    ncx: int
    ncy: int
    capacity: int
    # the skin the grid was built with; the subcycle prunes its tight
    # candidate list at this same gap so both stay consistent
    skin: float = 1.0
    # periodic wrap lengths for disks (0.0 = that axis has walls); on a
    # wrapped axis cells EXACTLY tile the domain (cell_s* >= cell_size)
    # so 3x3 cell adjacency modulo nc* is the true wrap adjacency
    wrap_lx: float = 0.0
    wrap_ly: float = 0.0
    cell_sx: float = 0.0  # per-axis cell size (0 -> cell_size)
    cell_sy: float = 0.0

    @property
    def csx(self) -> float:
        return self.cell_sx or self.cell_size

    @property
    def csy(self) -> float:
        return self.cell_sy or self.cell_size

    @staticmethod
    def build(
        cfg: SimConfig, r_max: float, capacity: int = 8, skin: float = 1.0
    ) -> "DemGrid":
        """`skin` (lattice units) widens cells beyond 2 r_max so a
        candidate list built once per LBM step stays valid through the
        whole DEM subcycle (valid while per-step travel < skin/2; fluid
        velocities are O(0.1) in lattice units, so 1.0 is generous)."""
        cell = max(2.0 * float(r_max) + skin, 1.0)
        lx, ly = cfg.wrap_lx, cfg.wrap_ly

        def axis(n, L, name):
            if not L:
                return max(int(n / cell) + 1, 1), cell
            # exact tiling: a partial last cell would break wrap
            # adjacency (a disk 2 cells from the seam can be within
            # reach of cell 0 through a narrow last cell)
            nc = max(int(n / cell), 1)
            if nc < 3:
                raise ValueError(
                    f"periodic {name}-extent {n} holds only {nc} DEM "
                    f"cells of size ~{cell:.1f}; need >= 3 for wrapped "
                    f"3x3 adjacency (smaller disks or a larger domain)"
                )
            return nc, n / nc

        ncx, csx = axis(cfg.nx, lx, "x")
        ncy, csy = axis(cfg.ny, ly, "y")
        return DemGrid(cell_size=cell, ncx=ncx, ncy=ncy, capacity=capacity,
                       skin=skin, wrap_lx=lx, wrap_ly=ly,
                       cell_sx=csx, cell_sy=csy)


class DiskState(NamedTuple):
    """SoA disk state pytree (C11). Fixed capacity N = cfg.max_disks."""

    x: jax.Array  # (N, 2) centers
    v: jax.Array  # (N, 2) velocities
    theta: jax.Array  # (N,) orientation
    omega: jax.Array  # (N,) angular velocity
    r: jax.Array  # (N,) radii
    mass: jax.Array  # (N,) rho_s * pi r^2 (unit depth)
    inertia: jax.Array  # (N,) 0.5 m r^2
    active: jax.Array  # (N,) bool
    # (N,) bool; False = infinite-mass disk (DiskSpec.fixed): forces
    # never change v/omega, but x/theta still drift at the constant
    # v/omega (stationary obstacles and prescribed-motion boundaries)
    mobile: jax.Array
    # tangential contact history (kt > 0): per-slot partner id and
    # spring stretch, re-matched to the fresh candidate list each step
    ct_j: jax.Array  # (N, contact_cap) int32, -1 = no contact
    ct_xi: jax.Array  # (N, contact_cap) tangential stretch
    wall_xi: jax.Array  # (N, 4) stretch vs west/east/south/north wall


def _cell_ids(x: jax.Array, active: jax.Array, grid: DemGrid) -> jax.Array:
    # Clipping also absorbs small periodic excursions: positions wrap
    # only at ghost-selection points (imb.wrap_positions), so a disk can
    # sit slightly past the seam - the clipped edge cell is the correct
    # wrapped-adjacency home for it.
    cx = jnp.clip(jnp.floor((x[:, 0] + 0.5) / grid.csx), 0, grid.ncx - 1)
    cy = jnp.clip(jnp.floor((x[:, 1] + 0.5) / grid.csy), 0, grid.ncy - 1)
    cid = (cy * grid.ncx + cx).astype(jnp.int32)
    return jnp.where(active, cid, -1)


def _min_image(d: jax.Array, lx: float, ly: float) -> jax.Array:
    """Minimum-image displacement (..., 2) under periodic wrap lengths
    (0 = no wrap on that axis)."""
    if not (lx or ly):
        return d
    cx, cy = d[..., 0], d[..., 1]
    if lx:
        cx = cx - lx * jnp.round(cx / lx)
    if ly:
        cy = cy - ly * jnp.round(cy / ly)
    return jnp.stack([cx, cy], axis=-1)


def build_cell_table(
    x: jax.Array, active: jax.Array, grid: DemGrid
) -> Tuple[jax.Array, jax.Array]:
    """Bucket disks into cells. Returns (table (ncells, K), overflow count).

    table[c, k] is the index of the k-th disk in cell c, or -1. Built via
    argsort on cell id + within-cell rank (deterministic scatter).
    """
    n = x.shape[0]
    k = grid.capacity
    ncells = grid.ncx * grid.ncy
    cid = _cell_ids(x, active, grid)
    iota = jnp.arange(n, dtype=jnp.int32)
    scid, order = jax.lax.sort((cid, iota), num_keys=1)
    is_start = jnp.concatenate([jnp.ones((1,), bool), scid[1:] != scid[:-1]])
    first = jax.lax.cummax(jnp.where(is_start, iota, 0))
    rank = iota - first
    valid = (scid >= 0) & (rank < k)
    slot = jnp.where(valid, scid * k + rank, ncells * k)  # OOB -> dropped
    table = (
        jnp.full((ncells * k,), -1, jnp.int32)
        .at[slot]
        .set(order, mode="drop")
        .reshape(ncells, k)
    )
    overflow = jnp.sum((scid >= 0) & (rank >= k)).astype(jnp.int32)
    return table, overflow


def _pair_force(pxi, vi, omi, ri, xj, vj, omj, rj, mask, cfg: SimConfig, dt,
                xi=None, h=0.0):
    """Spring-dashpot force/torque on disk i from disk(s)/wall(s) j (C14).

    n points from j to i. `xi` is the tangential spring stretch carried
    per slot (kt > 0); it advances by v_t * h here (h=0 evaluates force
    without advancing). Returns (F (..., 2), T (...,), xi', touching).
    """
    d = pxi - xj
    dist = jnp.sqrt(jnp.sum(d * d, axis=-1))
    dist = jnp.maximum(dist, jnp.asarray(1e-12, dt))
    delta = ri + rj - dist
    touching = mask & (delta > 0)
    n = d / dist[..., None]
    t = jnp.stack([-n[..., 1], n[..., 0]], axis=-1)
    # Lever arms reach the mid-overlap contact point (r - delta/2); using
    # the full radius would create spurious net angular momentum ft*delta.
    li = ri - 0.5 * delta
    lj = rj - 0.5 * delta
    vrel = vi - vj - (omi * li + omj * lj)[..., None] * t
    vn = jnp.sum(vrel * n, axis=-1)
    vt = jnp.sum(vrel * t, axis=-1)
    fn = cfg.kn * delta - cfg.gamma_n * vn
    ft_cap = cfg.mu * jnp.abs(fn)
    if cfg.kt > 0.0:
        # Cundall-Strack history spring with slip-consistent truncation
        xi_t = jnp.where(touching, xi + vt * h, 0.0)
        ft = jnp.clip(-cfg.kt * xi_t - cfg.gamma_t * vt, -ft_cap, ft_cap)
        xi_new = jnp.where(touching, -(ft + cfg.gamma_t * vt) / cfg.kt, 0.0)
    else:
        ft = jnp.clip(-cfg.gamma_t * vt, -ft_cap, ft_cap)
        xi_new = jnp.zeros_like(vt) if xi is None else jnp.zeros_like(xi)
    fn = jnp.where(touching, fn, 0.0)
    ft = jnp.where(touching, ft, 0.0)
    F = fn[..., None] * n + ft[..., None] * t
    # Torque on i: (c - x_i) x F = (-l_i n) x F = -l_i * ft  (n x t = 1).
    T = -li * ft
    return F, T, xi_new, touching


def candidate_list(
    disks: DiskState, table: jax.Array, grid: DemGrid
) -> jax.Array:
    """Per-disk candidate neighbor indices from the 3x3 cell patch.

    Returns (N, 9K) int32, -1 = empty/self/inactive. Built once per LBM
    step; thanks to the grid skin it remains a superset of all possibly-
    touching pairs for the whole DEM subcycle (Verlet-list pattern).
    """
    k = grid.capacity
    cx = jnp.clip(
        jnp.floor((disks.x[:, 0] + 0.5) / grid.csx), 0, grid.ncx - 1
    ).astype(jnp.int32)
    cy = jnp.clip(
        jnp.floor((disks.x[:, 1] + 0.5) / grid.csy), 0, grid.ncy - 1
    ).astype(jnp.int32)
    offs = jnp.array(
        [[-1, -1], [0, -1], [1, -1], [-1, 0], [0, 0], [1, 0], [-1, 1], [0, 1], [1, 1]],
        jnp.int32,
    )
    nbx = cx[:, None] + offs[None, :, 0]  # (N, 9)
    nby = cy[:, None] + offs[None, :, 1]
    # Periodic axes wrap the 3x3 patch across the seam (cells exactly
    # tile wrapped axes, so modular adjacency IS wrap adjacency; the
    # >= 3 cells guarantee from DemGrid.build keeps the 9 patch cells
    # distinct). Wall axes clamp as before.
    if grid.wrap_lx:
        nbx = jax.lax.rem(nbx + grid.ncx, jnp.int32(grid.ncx))
        valid_x = jnp.ones(nbx.shape, bool)
    else:
        valid_x = (nbx >= 0) & (nbx < grid.ncx)
    if grid.wrap_ly:
        nby = jax.lax.rem(nby + grid.ncy, jnp.int32(grid.ncy))
        valid_y = jnp.ones(nby.shape, bool)
    else:
        valid_y = (nby >= 0) & (nby < grid.ncy)
    valid_c = valid_x & valid_y
    cidn = jnp.where(valid_c, nby * grid.ncx + nbx, 0)
    cand = table[cidn]  # (N, 9, K)
    cand = jnp.where(valid_c[:, :, None], cand, -1)
    cand = cand.reshape(disks.x.shape[0], 9 * k)
    idx = jnp.arange(disks.x.shape[0], dtype=jnp.int32)[:, None]
    cand = jnp.where(cand == idx, -1, cand)  # drop self
    cand = jnp.where(disks.active[:, None], cand, -1)  # inactive rows empty
    return cand


def prune_candidates(
    disks: DiskState, cand: jax.Array, cap: int, skin: float,
    wrap: Tuple[float, float] = (0.0, 0.0),
) -> Tuple[jax.Array, jax.Array]:
    """Keep only candidates with surface gap <= skin, compacted to a
    (N, cap) list. Gathers once per LBM step so the substep cycle
    works on a tight list (typical contact coordination is <= 6-8, so
    each substep gathers cap rows instead of 9K).
    `wrap` = periodic (lx, ly) for minimum-image gaps (0 = walls).
    Returns (tight (N, cap), overflow count)."""
    mask = cand >= 0
    j = jnp.maximum(cand, 0)
    dt = disks.x.dtype
    # one wide gather of every field the test needs
    packed = jnp.concatenate(
        [disks.x, disks.r[:, None], disks.active[:, None].astype(dt)], axis=1
    )
    g = packed[j]  # (N, S, 4)
    d = _min_image(disks.x[:, None, :] - g[..., 0:2], *wrap)
    dist2 = jnp.sum(d * d, axis=-1)
    reach = disks.r[:, None] + g[..., 2] + skin
    keep = mask & (g[..., 3] > 0) & (dist2 <= reach * reach)
    # compact kept entries to the front via top_k over the 9K slots
    # (deterministic, and cheaper than a row-wise argsort)
    vals, order = jax.lax.top_k(keep.astype(jnp.float32), cap)
    tight = jnp.take_along_axis(jnp.where(keep, cand, -1), order, axis=1)
    tight = jnp.where(vals > 0, tight, -1)
    overflow = jnp.sum(keep, dtype=jnp.int32) - jnp.sum(tight >= 0, dtype=jnp.int32)
    return tight, overflow


def contact_forces_from_candidates(
    disks: DiskState, cand: jax.Array, cfg: SimConfig, xi=None, h=0.0
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Vectorized spring-dashpot forces over the fixed candidate slots.
    Returns (F, T, xi', n_contacts)."""
    dt = disks.x.dtype
    mask = cand >= 0
    j = jnp.maximum(cand, 0)
    if xi is None:
        xi = jnp.zeros(cand.shape, dt)
    # one wide gather of every neighbour field the pair law reads
    packed = jnp.concatenate(
        [disks.x, disks.v, disks.omega[:, None], disks.r[:, None],
         disks.active[:, None].astype(dt)], axis=1,
    )
    g = packed[j]  # (N, S, 7)
    # Periodic contacts: replace each neighbor's position by its
    # minimum image relative to disk i (the pair law only reads the
    # displacement, so shifting xj is exact).
    wrap = (cfg.wrap_lx, cfg.wrap_ly)
    xj = g[..., 0:2]
    if wrap[0] or wrap[1]:
        xj = disks.x[:, None, :] - _min_image(disks.x[:, None, :] - xj, *wrap)
    F, T, xi_new, touching = _pair_force(
        disks.x[:, None, :],
        disks.v[:, None, :],
        disks.omega[:, None],
        disks.r[:, None],
        xj,
        g[..., 2:4],
        g[..., 4],
        g[..., 5],
        mask & (g[..., 6] > 0),
        cfg,
        dt,
        xi=xi,
        h=h,
    )
    # Every contact is counted by both members.
    nc = jnp.sum(touching, dtype=jnp.int32) // 2
    return jnp.sum(F, axis=1), jnp.sum(T, axis=1), xi_new, nc


def contact_forces(
    disks: DiskState, table: jax.Array, grid: DemGrid, cfg: SimConfig
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Disk-disk contact forces via the cell list. Returns (F, T, n_contacts)."""
    cand = candidate_list(disks, table, grid)
    F, T, _, nc = contact_forces_from_candidates(disks, cand, cfg)
    return F, T, nc


def wall_forces(
    disks: DiskState, cfg: SimConfig, wall_xi=None, h=0.0
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Disk-wall contacts (C15): same contact law vs static wall planes.

    Walls sit at -0.5 / n-0.5 (matching the half-way bounce-back fluid
    walls), only on sides configured as `wall`. `wall_xi` (N, 4) carries
    the tangential history per wall. Returns (F, T, wall_xi')."""
    dt = disks.x.dtype
    x, y = disks.x[:, 0], disks.x[:, 1]
    zero = jnp.zeros_like(x)
    F = jnp.zeros_like(disks.x)
    T = jnp.zeros_like(disks.omega)
    if wall_xi is None:
        wall_xi = jnp.zeros((disks.x.shape[0], 4), dt)
    xi_new = wall_xi
    # (slot, side active, wall coordinate along axis, axis)
    walls = [
        (0, cfg.bc_west == WALL, -0.5, 0),
        (1, cfg.bc_east == WALL, cfg.nx - 0.5, 0),
        (2, cfg.bc_south == WALL, -0.5, 1),
        (3, cfg.bc_north == WALL, cfg.ny - 0.5, 1),
    ]
    for slot, on, wpos, axis in walls:
        if not on:
            continue
        # Mirror trick: treat the wall as a disk of radius 0 located at
        # the closest point on the wall plane, with zero velocity.
        xj = disks.x.at[:, axis].set(jnp.asarray(wpos, dt))
        Fw, Tw, xw, _ = _pair_force(
            disks.x,
            disks.v,
            disks.omega,
            disks.r,
            xj,
            jnp.zeros_like(disks.v),
            zero,
            zero,
            disks.active,
            cfg,
            dt,
            xi=wall_xi[:, slot],
            h=h,
        )
        F = F + Fw
        T = T + Tw
        xi_new = xi_new.at[:, slot].set(xw)
    return F, T, xi_new


def body_forces(disks: DiskState, cfg: SimConfig) -> jax.Array:
    """Gravity + optional analytic buoyancy on each disk (C16 inputs)."""
    dt = disks.x.dtype
    g = jnp.asarray([cfg.g_px, cfg.g_py], dt)
    m_eff = disks.mass
    if cfg.buoyancy:
        m_fluid = cfg.rho0 * jnp.pi * disks.r * disks.r
        m_eff = disks.mass - m_fluid
    return m_eff[:, None] * g[None, :] * disks.active[:, None]


def dem_subcycle(
    disks: DiskState,
    f_hydro: jax.Array,  # (N, 2) held constant over the subcycle
    t_hydro: jax.Array,  # (N,)
    grid: DemGrid,
    cfg: SimConfig,
) -> Tuple[DiskState, jax.Array, jax.Array]:
    """n_sub velocity-Verlet DEM substeps per LBM step (C16).

    Returns (new_disks, cell_overflow_count, contact_count).
    """
    dt = disks.x.dtype
    h = jnp.asarray(1.0 / cfg.n_sub, dt)
    # fixed (non-mobile) disks: inv mass/inertia 0 -> velocity-Verlet
    # kicks vanish, but the drift x += h v still applies, so they move
    # at their prescribed constant v/omega
    free = disks.active & disks.mobile
    inv_m = jnp.where(free, 1.0 / disks.mass, 0.0)
    inv_i = jnp.where(free, 1.0 / disks.inertia, 0.0)
    act2 = disks.active[:, None]

    # Verlet-list pattern: the cell table + candidate list are built once
    # per LBM step (the grid skin guarantees validity through the whole
    # subcycle), then pruned by actual gap to a tight contact list so
    # each substep gathers ~contact_cap rows instead of 9*K.
    table, ovf = build_cell_table(disks.x, disks.active, grid)
    cand = candidate_list(disks, table, grid)
    cand, ovf_p = prune_candidates(disks, cand, cfg.contact_cap,
                                   skin=grid.skin,
                                   wrap=(cfg.wrap_lx, cfg.wrap_ly))
    ovf = jnp.maximum(ovf, ovf_p)
    body_f = body_forces(disks, cfg)  # position-independent

    # Re-match tangential history to the fresh candidate list by partner
    # id (each disk keeps <= contact_cap springs; a pair persisting
    # across steps keeps its stretch, new pairs start at 0).
    if cfg.kt > 0.0:
        same = (cand[:, :, None] == disks.ct_j[:, None, :]) & (
            disks.ct_j[:, None, :] >= 0
        )
        xi0 = jnp.sum(jnp.where(same, disks.ct_xi[:, None, :], 0.0), axis=2)
        wxi0 = disks.wall_xi
    else:
        xi0 = jnp.zeros(cand.shape, dt)
        wxi0 = disks.wall_xi

    def total_force(d: DiskState, xi, wxi, h_adv):
        Fc, Tc, xi2, nc = contact_forces_from_candidates(d, cand, cfg, xi, h_adv)
        Fw, Tw, wxi2 = wall_forces(d, cfg, wxi, h_adv)
        F = Fc + Fw + f_hydro + body_f
        return F * act2, (Tc + Tw + t_hydro) * d.active, xi2, wxi2, nc

    F0, T0, _, _, nc0 = total_force(disks, xi0, wxi0, 0.0)

    def body(carry, _):
        d, F, T, xi, wxi, nc = carry
        vh = d.v + (0.5 * h) * F * inv_m[:, None]
        omh = d.omega + (0.5 * h) * T * inv_i
        d = d._replace(
            x=d.x + h * vh * act2,
            theta=d.theta + h * omh * d.active,
        )
        F2, T2, xi, wxi, n2 = total_force(d._replace(v=vh, omega=omh), xi, wxi, h)
        d = d._replace(
            v=(vh + (0.5 * h) * F2 * inv_m[:, None]) * act2,
            omega=(omh + (0.5 * h) * T2 * inv_i) * d.active,
        )
        return (d, F2, T2, xi, wxi, jnp.maximum(nc, n2)), None

    (disks, _, _, xi, wxi, nc), _ = jax.lax.scan(
        body, (disks, F0, T0, xi0, wxi0, nc0), None, length=cfg.n_sub
    )
    disks = disks._replace(ct_j=cand, ct_xi=xi, wall_xi=wxi)
    return disks, ovf, nc


def cull_open_boundaries(disks: DiskState, cfg: SimConfig) -> DiskState:
    """Deactivate mobile disks advected fully past an open boundary.

    With Zou/He inlet/outlet sides (cfg.bc_west == 'inlet') a mobile
    disk can leave the domain through the open x ends. Once its whole
    footprint is outside (center beyond the boundary plane by more than
    its radius) it stops stamping coverage, exerting/receiving forces,
    and integrating: the slot is deactivated and parked far outside,
    exactly like an initially-unused slot (make_disk_state). While it
    straddles the boundary only its in-domain part couples (the stamp
    masks out-of-domain cells), the standard outflow truncation. Fixed
    disks are exempt - a prescribed motion may carry them back in.
    """
    x0 = disks.x[:, 0]
    gone = (
        disks.active
        & disks.mobile
        & ((x0 - disks.r > cfg.nx - 0.5) | (x0 + disks.r < -0.5))
    )
    park = jnp.asarray([-1.0e6, -1.0e6], disks.x.dtype)
    return disks._replace(
        active=disks.active & ~gone,
        x=jnp.where(gone[:, None], park[None, :], disks.x),
        v=jnp.where(gone[:, None], jnp.zeros_like(disks.v), disks.v),
        omega=jnp.where(gone, jnp.zeros_like(disks.omega), disks.omega),
    )


def make_disk_state(specs, cfg: SimConfig, dtype=None) -> DiskState:
    """Build a fixed-capacity DiskState from a list of DiskSpec (C11/C19)."""
    import numpy as np

    dt = np.dtype(dtype or cfg.dtype)
    n = max(cfg.max_disks, len(specs), 1)
    x = np.zeros((n, 2), dt)
    v = np.zeros((n, 2), dt)
    theta = np.zeros((n,), dt)
    om = np.zeros((n,), dt)
    r = np.ones((n,), dt)  # inactive slots keep r=1 to avoid div-by-zero
    active = np.zeros((n,), bool)
    mobile = np.ones((n,), bool)
    rho = np.full((n,), cfg.rho_s, np.float64)
    for i, s in enumerate(specs):
        x[i] = (s.x, s.y)
        v[i] = (s.vx, s.vy)
        om[i] = s.omega
        r[i] = s.r
        active[i] = True
        mobile[i] = not getattr(s, "fixed", False)
        if getattr(s, "rho_s", 0.0):
            rho[i] = s.rho_s
    # Park inactive disks far outside the domain so they never stamp
    # coverage or enter the cell table (cid is masked anyway).
    x[len(specs):] = (-1e6, -1e6)
    mass = rho * np.pi * r * r
    inertia = 0.5 * mass * r * r
    return DiskState(
        x=jnp.asarray(x),
        v=jnp.asarray(v),
        theta=jnp.asarray(theta),
        omega=jnp.asarray(om),
        r=jnp.asarray(r),
        mass=jnp.asarray(mass.astype(dt)),
        inertia=jnp.asarray(inertia.astype(dt)),
        active=jnp.asarray(active),
        mobile=jnp.asarray(mobile),
        ct_j=jnp.full((n, cfg.contact_cap), -1, jnp.int32),
        ct_xi=jnp.zeros((n, cfg.contact_cap), dt),
        wall_xi=jnp.zeros((n, 4), dt),
    )
