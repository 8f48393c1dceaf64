"""Lattice domain decomposition over a device mesh (SURVEY.md SS5.7/5.8).

The reference is single-GPU (SURVEY SS2 "Parallelism strategies"); this
layer is new distribution work:

- The f-array (9, ny, nx) is sharded over a 2D device mesh with axes
  ('y', 'x') - the spatial analogue of sequence/context parallelism.
- Each step performs a width-1 halo exchange of the *outgoing* D2Q9
  populations with `lax.ppermute` per axis: 3 populations per face, x
  axis first, then y including the x-halo columns so corner (diagonal)
  links propagate through two hops (SURVEY SS7 hard part #5).
- Disks are replicated on every device; each shard stamps/collides/
  gathers only its local cells and the per-disk partial hydrodynamic
  forces are `psum`-reduced over the mesh (the "allreduce of particle
  forces" in BASELINE.json). DEM then integrates redundantly per device
  - cheap, identical on every shard, and avoids sharding particle
  ownership.
- Bounce-back walls apply only on shards holding a global domain edge,
  selected by `lax.axis_index`.

Halo wrap-around across the ring IS the periodic BC; on wall sides the
wrapped halo values are only ever pulled into populations that the
bounce-back rule overwrites, so no special-casing is needed (the same
invariant the single-chip jnp.roll implementation relies on).

Validated by tests/test_sharding.py: the sharded step on a simulated
CPU mesh matches the single-device step to FP equality (f64).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lbmdem import lattice
from lbmdem.config import SimConfig, WALL
from lbmdem.ops import dem, imb, lbm
from lbmdem.ops.dem import DemGrid

# Populations needed in each halo for pull streaming: a cell at the low
# edge pulls f_i from (x - e_i) outside the shard iff e_i points *into*
# the shard from that side.
_NEED_W = lattice.IN_E  # left halo feeds populations moving +x
_NEED_E = lattice.IN_W
_NEED_S = lattice.IN_N  # bottom halo feeds populations moving +y
_NEED_N = lattice.IN_S


def make_mesh(devices=None, shape: Optional[Tuple[int, int]] = None) -> Mesh:
    """A ('y', 'x') mesh over the given devices (default: all).

    With an explicit `shape` but default devices, the first y*x
    available devices are used (a 2x2 mesh on an 8-device host is
    legal - e.g. `cli.py --mesh 2x2`)."""
    explicit = devices is not None
    devices = list(devices if explicit else jax.devices())
    n = len(devices)
    if shape is None:
        # favor squarish splits; fall back to 1 x n
        ysz = int(np.sqrt(n))
        while n % ysz:
            ysz -= 1
        shape = (ysz, n // ysz)
    elif not explicit:
        want = shape[0] * shape[1]
        if want > n:
            raise ValueError(
                f"mesh {shape[0]}x{shape[1]} needs {want} devices, "
                f"only {n} available"
            )
        devices = devices[:want]
    arr = np.asarray(devices).reshape(shape)
    return Mesh(arr, ("y", "x"))


def state_specs():
    """PartitionSpecs for a SimState: lattice sharded, disks replicated."""
    from lbmdem.simulation import SimState

    return SimState(
        f=P(None, "y", "x"),
        disks=dem.DiskState(*(P() for _ in dem.DiskState._fields)),
        step=P(),
        overflow=P(),
        n_contacts=P(),
        fail_step=P(),
    )


def shard_state(state, mesh: Mesh):
    """Place a SimState onto the mesh according to `state_specs`."""
    specs = state_specs()
    return jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), state, specs,
        is_leaf=lambda x: isinstance(x, jax.Array) or hasattr(x, "shape"),
    )


def _ring_perm(n: int, shift: int):
    """ppermute permutation moving data `shift` steps along a ring."""
    return [(i, (i + shift) % n) for i in range(n)]


def exchange_halo(fpost: jax.Array, mesh: Mesh) -> jax.Array:
    """Build the (9, h+2, w+2) halo-extended post-collision array.

    Two sequential axis exchanges (x then y, y including the x-halo
    columns) so that diagonal populations cross shard corners correctly.
    Only the 3 populations entering through each face are transferred;
    the remaining halo entries stay zero and are never read.
    """
    nx_sh = mesh.shape["x"]
    ny_sh = mesh.shape["y"]
    q, h, w = fpost.shape
    dt = fpost.dtype

    ext = jnp.zeros((q, h + 2, w + 2), dt)
    ext = ext.at[:, 1:-1, 1:-1].set(fpost)

    # --- x axis: receive left halo from west neighbor, right from east.
    send_e = fpost[np.asarray(_NEED_W), :, -1]  # (3, h) our east edge
    send_w = fpost[np.asarray(_NEED_E), :, 0]  # (3, h) our west edge
    recv_w = jax.lax.ppermute(send_e, "x", _ring_perm(nx_sh, +1))
    recv_e = jax.lax.ppermute(send_w, "x", _ring_perm(nx_sh, -1))
    ext = ext.at[np.asarray(_NEED_W), 1:-1, 0].set(recv_w)
    ext = ext.at[np.asarray(_NEED_E), 1:-1, -1].set(recv_e)

    # --- y axis on the x-extended rows, so corners carry diagonal links.
    send_n = ext[np.asarray(_NEED_S), -2, :]  # (3, w+2) our north edge row
    send_s = ext[np.asarray(_NEED_N), 1, :]  # (3, w+2) our south edge row
    recv_s = jax.lax.ppermute(send_n, "y", _ring_perm(ny_sh, +1))
    recv_n = jax.lax.ppermute(send_s, "y", _ring_perm(ny_sh, -1))
    ext = ext.at[np.asarray(_NEED_S), 0, :].set(recv_s)
    ext = ext.at[np.asarray(_NEED_N), -1, :].set(recv_n)
    return ext


def stream_from_halo(ext: jax.Array) -> jax.Array:
    """Pull streaming from a halo-extended array: static shifted slices."""
    q, hp, wp = ext.shape
    h, w = hp - 2, wp - 2
    outs = []
    for i in range(lattice.Q):
        ex, ey = int(lattice.E[i, 0]), int(lattice.E[i, 1])
        outs.append(jax.lax.dynamic_slice(ext[i], (1 - ey, 1 - ex), (h, w)))
    return jnp.stack(outs)


def _wall_corr(i: int, uwx: float, uwy: float, cfg: SimConfig) -> float:
    """Half-way moving-wall term (shared formula: lattice.wall_corr)."""
    return lattice.wall_corr(i, uwx, uwy, cfg.rho0)


def _apply_bounce_back_sharded(
    fnew: jax.Array, fpost: jax.Array, cfg: SimConfig, ny_sh: int, nx_sh: int
) -> jax.Array:
    """Half-way bounce-back (incl. moving walls), applied only on shards
    at a global edge."""
    opp = lattice.OPP

    def fix_row(fnew, idxs, row, is_edge, uwx):
        for i in idxs:
            i = int(i)
            cur = fnew[i, row, :]
            fnew = fnew.at[i, row, :].set(
                jnp.where(is_edge,
                          fpost[int(opp[i]), row, :] + _wall_corr(i, uwx, 0.0, cfg),
                          cur)
            )
        return fnew

    def fix_col(fnew, idxs, col, is_edge, uwy):
        for i in idxs:
            i = int(i)
            cur = fnew[i, :, col]
            fnew = fnew.at[i, :, col].set(
                jnp.where(is_edge,
                          fpost[int(opp[i]), :, col] + _wall_corr(i, 0.0, uwy, cfg),
                          cur)
            )
        return fnew

    iy = jax.lax.axis_index("y")
    ix = jax.lax.axis_index("x")
    if cfg.bc_south == WALL:
        fnew = fix_row(fnew, lattice.IN_N, 0, iy == 0, cfg.uw_south)
    if cfg.bc_north == WALL:
        fnew = fix_row(fnew, lattice.IN_S, -1, iy == ny_sh - 1, cfg.uw_north)
    if cfg.bc_west == WALL:
        fnew = fix_col(fnew, lattice.IN_E, 0, ix == 0, cfg.uw_west)
    if cfg.bc_east == WALL:
        fnew = fix_col(fnew, lattice.IN_W, -1, ix == nx_sh - 1, cfg.uw_east)
    return fnew


def _apply_open_boundaries_sharded(
    fnew: jax.Array, cfg: SimConfig, h: int, nx_sh: int
) -> jax.Array:
    """Zou/He open boundaries on the edge shards (single-device twin:
    lbm.apply_open_boundaries - same operation ORDER so the sharded
    step stays bitwise-identical to the unsharded one). The inlet
    profile is evaluated at GLOBAL y from the shard's row offset."""
    if cfg.bc_west != "inlet":
        return fnew
    dt = fnew.dtype
    iy = jax.lax.axis_index("y")
    ix = jax.lax.axis_index("x")
    # the shard's rows of the GLOBAL host-precomputed profile (the same
    # numpy values the single-device step bakes in - a traced one would
    # differ by an FMA ulp and break the sharded-parity tests)
    u_glob = jnp.asarray(lbm.inlet_profile_array(cfg), dt)
    uw = jax.lax.dynamic_slice(u_glob, (iy * h,), (h,))

    at_w = ix == 0
    w_cols = tuple(fnew[i, :, 0] for i in range(9))
    n1, n5, n8 = lbm.zou_he_inlet(w_cols, uw)
    at_e = ix == nx_sh - 1
    rho_o = jnp.asarray(cfg.rho_outlet or cfg.rho0, dt)
    e_cols = tuple(fnew[i, :, -1] for i in range(9))
    n3, n7, n6 = lbm.zou_he_outlet(e_cols, rho_o)

    fnew = fnew.at[1, :, 0].set(jnp.where(at_w, n1, w_cols[1]))
    fnew = fnew.at[5, :, 0].set(jnp.where(at_w, n5, w_cols[5]))
    fnew = fnew.at[8, :, 0].set(jnp.where(at_w, n8, w_cols[8]))
    fnew = fnew.at[3, :, -1].set(jnp.where(at_e, n3, e_cols[3]))
    fnew = fnew.at[7, :, -1].set(jnp.where(at_e, n7, e_cols[7]))
    fnew = fnew.at[6, :, -1].set(jnp.where(at_e, n6, e_cols[6]))
    return fnew


def make_sharded_step(
    cfg: SimConfig, grid: Optional[DemGrid], mesh: Mesh,
) -> Callable:
    """The full coupled step as a shard_map over the mesh.

    Returns step(SimState) -> SimState operating on globally-shaped
    arrays with shardings from `state_specs()`.
    """
    from lbmdem.simulation import SimState

    coupled = cfg.max_disks > 0
    periodic_dem = coupled and bool(cfg.wrap_lx or cfg.wrap_ly)
    ny_sh, nx_sh = mesh.shape["y"], mesh.shape["x"]
    assert cfg.ny % ny_sh == 0 and cfg.nx % nx_sh == 0, (
        f"lattice {cfg.ny}x{cfg.nx} must tile the mesh {ny_sh}x{nx_sh}"
    )
    h, w = cfg.ny // ny_sh, cfg.nx // nx_sh
    if cfg.f_storage != "float32":
        raise ValueError(
            "f_storage='bfloat16' is single-device only: the sharded "
            "step is float32-storage only (it consumes raw f32 f and "
            "would collide shifted-bf16 g as f: rho = sum(g) = 0 at rest)"
        )
    # Local view: the shard behaves like a small lattice of shape (h, w)
    # whose cells map to globals via the (oy, ox) offset.
    local_cfg = cfg.replace(nx=w, ny=h)

    def local_step(state: SimState) -> SimState:
        f = state.f
        dty = f.dtype
        oy = (jax.lax.axis_index("y") * h).astype(dty)
        ox = (jax.lax.axis_index("x") * w).astype(dty)

        if coupled:
            d = state.disks
            govf = jnp.zeros((), jnp.int32)
            if periodic_dem:
                # wrap + ghost-select at GLOBAL coords (disk state is
                # replicated, so every shard computes the same
                # augmentation) BEFORE the local-frame shift
                xw, aug, gparent, _, govf = imb.periodic_ghosts(
                    d.x, d.v, d.omega, d.r, d.active, cfg
                )
                d = d._replace(x=xw)
                xa, va, oma, ra, acta = aug
            else:
                xa, va, oma, ra, acta = d.x, d.v, d.omega, d.r, d.active
            # Shift replicated disk coords into this shard's local frame;
            # stamping/gathering then drops out-of-shard cells naturally.
            shift = jnp.stack([ox, oy])
            xloc = xa - shift[None, :]
            eps, usx, usy = imb.stamp_solid_fraction(
                xloc, va, oma, ra, acta, local_cfg
            )
            if cfg.bc_west == "inlet":
                # Zou/He boundary columns stay pure fluid
                # (imb.mask_open_columns) - shard-local edition: zero the
                # local first/last column only on the global-edge shards
                ix_sh = jax.lax.axis_index("x")
                at_w = ix_sh == 0
                at_e = ix_sh == nx_sh - 1
                eps, usx, usy = (
                    a.at[:, 0].set(jnp.where(at_w, 0.0, a[:, 0]))
                    .at[:, -1].set(jnp.where(at_e, 0.0, a[:, -1]))
                    for a in (eps, usx, usy)
                )
            fpost, phix, phiy = imb.collide_imb(f, eps, usx, usy, local_cfg)
        else:
            fpost = lbm.collide(f, cfg.tau, cfg.gx, cfg.gy, cfg.smagorinsky,
                                cfg.trt_lambda)

        ext = exchange_halo(fpost, mesh)
        fnew = stream_from_halo(ext)
        fnew = _apply_bounce_back_sharded(fnew, fpost, cfg, ny_sh, nx_sh)
        fnew = _apply_open_boundaries_sharded(fnew, cfg, h, nx_sh)

        if coupled:
            fh_part, th_part = imb.reduce_hydro_forces(
                xloc, ra, acta, eps, phix, phiy, local_cfg
            )
            fh = jax.lax.psum(fh_part, ("y", "x"))
            th = jax.lax.psum(th_part, ("y", "x"))
            if periodic_dem:
                fh, th = imb.fold_ghost_forces(
                    fh, th, gparent, d.x.shape[0]
                )
            # DEM runs redundantly on every device on replicated state.
            disks, ovf, nc = dem.dem_subcycle(d, fh, th, grid, cfg)
            if cfg.bc_west == "inlet":
                # mobile disks leaving through the open x ends (disk
                # state is replicated: every shard culls identically)
                disks = dem.cull_open_boundaries(disks, cfg)
            return SimState(
                f=fnew,
                disks=disks,
                step=state.step + 1,
                overflow=jnp.maximum(state.overflow, jnp.maximum(ovf, govf)),
                n_contacts=nc,
                fail_step=state.fail_step,
            )
        return state._replace(f=fnew, step=state.step + 1)

    specs = state_specs()
    stepfn = jax.shard_map(
        local_step, mesh=mesh, in_specs=(specs,), out_specs=specs
    )
    if cfg.paranoia:
        from lbmdem.simulation import paranoid_wrap

        stepfn = paranoid_wrap(stepfn, cfg)
    return stepfn
