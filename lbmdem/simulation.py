"""Simulation state + driver (SURVEY.md SS2 C21, SS3 call stacks).

The reference's `main()` time loop (SURVEY SS3.2) becomes a pure jitted
step function over a `SimState` pytree, run in `lax.fori_loop` chunks
between host-side snapshot dumps - the only recurring host crossing,
exactly as SURVEY SS3.2 mandates for the rebuild.

    sim = Simulation(cfg, disks)
    sim.run(cfg.steps)          # chunked by cfg.out_interval
    rho, ux, uy = sim.macroscopic()
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from lbmdem.config import DiskSpec, SimConfig, window_for_radius
from lbmdem.ops import dem, imb, lbm
from lbmdem.ops.dem import DemGrid, DiskState


class SimulationDiverged(RuntimeError):
    """Raised by paranoid mode; .step is the first failing step."""

    def __init__(self, msg: str, step: int):
        super().__init__(msg)
        self.step = step


class FluidState(NamedTuple):
    """Fluid-only view (kept for API symmetry with the reference's arrays)."""

    f: jax.Array  # (9, ny, nx)


class SimState(NamedTuple):
    """Full simulation state pytree: everything the step loop touches."""

    f: jax.Array  # (9, ny, nx) distributions
    disks: DiskState
    step: jax.Array  # () int32
    overflow: jax.Array  # () int32, max cell-list overflow seen
    n_contacts: jax.Array  # () int32, contacts at last step
    # () int32: first step whose state failed paranoid validation
    # (-1 = healthy). Only written when cfg.paranoia; once set, the
    # step function freezes the state so the failing fields survive
    # the rest of the fori_loop chunk (SURVEY SS5.2/5.3).
    fail_step: jax.Array = None


def state_ok(cfg: SimConfig, new: SimState):
    """() bool: paranoid validity of `new` (SURVEY SS5.2/5.3): all f
    finite, rho > 0 everywhere, disk state finite, no capacity
    overflow. Works on a shard-local state too (combine shard results
    with lax.pmin before paranoid_commit)."""
    ok = jnp.all(jnp.isfinite(new.f))
    # bf16 storage holds g = f - w*rho0: rho = sum(g) + rho0
    rho = jnp.sum(new.f.astype(jnp.float32), axis=0)
    if cfg.f_storage == "bfloat16":
        rho = rho + cfg.rho0
    ok &= jnp.all(rho > 0.0)
    if cfg.max_disks > 0:
        d = new.disks
        ok &= jnp.all(jnp.isfinite(d.x)) & jnp.all(jnp.isfinite(d.v))
        ok &= jnp.all(jnp.isfinite(d.omega))
    ok &= new.overflow == 0
    return ok


def paranoid_commit(old: SimState, new: SimState, ok) -> SimState:
    """Freeze-on-failure commit: once fail_step is set, every later
    commit is identity (the failing fields survive the rest of the
    chunk for inspection); an `ok=False` commit records new.step as the
    failing step. The freeze is a value-level select, not lax.cond, so
    the wrapped step compiles like the plain one (a cond duplicates the
    step into two branches). Post-failure steps waste compute, but
    failure is terminal: the chunk ends anyway."""
    frozen = old.fail_step >= 0
    out = jax.tree.map(
        lambda o, fresh: jnp.where(frozen, o, fresh), old, new
    )
    return out._replace(
        fail_step=jnp.where(
            frozen, old.fail_step,
            jnp.where(ok, jnp.int32(-1), new.step),
        )
    )


def paranoid_wrap(step: Callable, cfg: SimConfig) -> Callable:
    """Per-step in-chunk validation (SURVEY SS5.2/5.3 paranoid mode).

    After each step: state_ok; on the first violation the state freezes
    (the remaining fori_loop iterations become identity), so
    `state.fail_step` reports the exact failing step and the failing
    fields are inspectable - instead of a NaN silently surfacing at the
    next out_interval.
    """

    def wrapped(state: SimState) -> SimState:
        # The step runs UNCONDITIONALLY; freeze semantics and the
        # cond-vs-select rationale live in paranoid_commit.
        new = step(state)
        return paranoid_commit(state, new, state_ok(cfg, new))

    return wrapped


def make_step_fn(
    cfg: SimConfig, grid: Optional[DemGrid], dem_mode: str = "subcycle",
) -> Callable[[SimState], SimState]:
    """Build the per-step function (SURVEY SS3.2 rebuilt).

    With disks: eps-stamp -> NT collide(+forcing) -> stream -> bounce-back
    -> hydro force reduction -> DEM subcycle. Without: pure collide-
    stream-BB fast path (SS3.3). `dem_mode="drift"` (every disk fixed)
    replaces the DEM subcycle by a constant-velocity drift.
    """
    coupled = cfg.max_disks > 0
    periodic_dem = coupled and bool(cfg.wrap_lx or cfg.wrap_ly)
    # Zou/He channels: mobile disks leaving through the open x ends are
    # deactivated once fully outside (dem.cull_open_boundaries)
    open_cull = coupled and cfg.bc_west == "inlet"

    def advance_disks(d, fh, th):
        # dem_mode "drift" (every disk fixed, e.g. a porous bed or a
        # periodic obstacle array): no contact machinery at all - fixed
        # disks just translate/rotate at their prescribed constant
        # v/omega over the LBM step (dt = 1)
        if dem_mode == "drift":
            nd = d._replace(
                x=d.x + d.v * d.active[:, None],
                theta=d.theta + d.omega * d.active,
            )
            z = jnp.zeros((), jnp.int32)
            return nd, z, z
        return dem.dem_subcycle(d, fh, th, grid, cfg)

    def step(state: SimState) -> SimState:
        if not coupled:
            fnew = lbm.to_storage(
                lbm.step_pure_fluid(lbm.from_storage(state.f, cfg), cfg),
                cfg,
            )
            return state._replace(f=fnew, step=state.step + 1)
        d = state.disks
        n_real = d.x.shape[0]
        govf = jnp.zeros((), jnp.int32)
        gparent = None
        if periodic_dem:
            # wrap positions, then select the disks whose stamp window
            # can cross a periodic seam - their min-image ghost copies
            # feed the stamp and the force reduction, and their hydro
            # forces fold back into the parents
            xw, (xa, va, oma, ra, acta), gparent, _, govf = (
                imb.periodic_ghosts(d.x, d.v, d.omega, d.r, d.active, cfg)
            )
            d = d._replace(x=xw)
        else:
            xa, va, oma, ra, acta = d.x, d.v, d.omega, d.r, d.active
        eps, usx, usy = imb.stamp_solid_fraction(xa, va, oma, ra, acta, cfg)
        if open_cull:
            eps, usx, usy = imb.mask_open_columns(eps, usx, usy)
        # bf16 storage: physical compute between quantized states
        f_phys = lbm.from_storage(state.f, cfg)
        fpost, phix, phiy = imb.collide_imb(f_phys, eps, usx, usy, cfg)
        fnew = lbm.stream(fpost)
        fnew = lbm.to_storage(
            lbm.apply_open_boundaries(
                lbm.apply_bounce_back(fnew, fpost, cfg), cfg
            ),
            cfg,
        )
        fh, th = imb.reduce_hydro_forces(xa, ra, acta, eps, phix, phiy, cfg)
        if periodic_dem:
            fh, th = imb.fold_ghost_forces(fh, th, gparent, n_real)
        disks, ovf, nc = advance_disks(d, fh, th)
        if open_cull:
            disks = dem.cull_open_boundaries(disks, cfg)
        return SimState(
            f=fnew,
            disks=disks,
            step=state.step + 1,
            overflow=jnp.maximum(state.overflow, jnp.maximum(ovf, govf)),
            n_contacts=nc,
            fail_step=state.fail_step,
        )

    if cfg.paranoia:
        step = paranoid_wrap(step, cfg)
    return step


class Simulation:
    """User-facing driver (C21): owns config, state and the jitted loops."""

    def __init__(
        self,
        cfg: SimConfig,
        disks: Sequence[DiskSpec] = (),
        mesh=None,
    ):
        """`mesh` (a jax.sharding.Mesh with axes ('y','x'), e.g. from
        parallel.make_mesh) shards the lattice spatially over the mesh
        devices and replicates disks with force-psum - the run()/step()
        API is unchanged (SURVEY SS5.7/5.8)."""
        disks = list(disks)
        if disks:
            r_max = max(d.r for d in disks)
            if cfg.window <= 0:
                cfg = cfg.replace(window=window_for_radius(r_max))
            if cfg.max_disks < len(disks):
                cfg = cfg.replace(max_disks=len(disks))
            self.grid = DemGrid.build(cfg, r_max)
        elif cfg.max_disks > 0:
            self.grid = DemGrid.build(cfg, 1.0)
            if cfg.window <= 0:
                cfg = cfg.replace(window=window_for_radius(1.0))
        else:
            self.grid = None
        cfg.validate_periodic_dem()
        if (cfg.max_disks > 0 and (cfg.wrap_lx or cfg.wrap_ly)
                and cfg.ghost_cap <= 0):
            cfg = cfg.replace(
                ghost_cap=imb.default_ghost_cap(cfg.max_disks, cfg)
            )
        self.cfg = cfg
        self.mesh = mesh
        # every disk fixed -> no contact mechanics at all: positions
        # just drift at the prescribed v/omega (obstacle arrays, beds)
        self.dem_mode = (
            "drift" if disks and all(d.fixed for d in disks) else "subcycle"
        )
        self.state = SimState(
            f=lbm.to_storage(lbm.init_equilibrium(cfg), cfg),
            disks=dem.make_disk_state(disks, cfg),
            step=jnp.zeros((), jnp.int32),
            overflow=jnp.zeros((), jnp.int32),
            n_contacts=jnp.zeros((), jnp.int32),
            fail_step=jnp.full((), -1, jnp.int32),
        )
        if mesh is not None:
            from lbmdem.parallel import make_sharded_step, shard_state

            self._step = make_sharded_step(cfg, self.grid, mesh)
            self.state = shard_state(self.state, mesh)
        else:
            self._step = make_step_fn(cfg, self.grid, dem_mode=self.dem_mode)
        self._chunk_cache = {}
        self.mlups_last = 0.0

    # --- stepping ---
    def step(self) -> None:
        self.state = jax.jit(self._step, donate_argnums=0)(self.state)

    def _chunk_fn(self, n: int):
        """Jitted n-step chunk (state donated)."""
        if n not in self._chunk_cache:
            step = self._step

            def chunk(state):
                return jax.lax.fori_loop(0, n, lambda _, s: step(s), state)

            self._chunk_cache[n] = jax.jit(chunk, donate_argnums=0)
        return self._chunk_cache[n]

    def run(
        self,
        steps: Optional[int] = None,
        callback: Optional[Callable[["Simulation"], None]] = None,
    ) -> float:
        """Run `steps` LBM steps (default cfg.steps), invoking `callback`
        every cfg.out_interval steps. Returns achieved MLUPS."""
        steps = int(steps if steps is not None else self.cfg.steps)
        interval = self.cfg.out_interval or steps
        done = 0
        t0 = time.perf_counter()
        while done < steps:
            n = min(interval, steps - done)
            self.state = self._chunk_fn(n)(self.state)
            done += n
            if self.cfg.paranoia:
                self.check_health()
            if callback is not None:
                self._sync()
                callback(self)
        self._sync()
        dt_s = time.perf_counter() - t0
        self.mlups_last = self.cfg.nx * self.cfg.ny * steps / dt_s / 1e6
        return self.mlups_last

    def check_health(self) -> None:
        """Raise if paranoid validation tripped (reports the exact step)."""
        fail = int(self.state.fail_step)
        if fail >= 0:
            raise SimulationDiverged(
                f"paranoid check failed at step {fail}: non-finite f, "
                f"rho <= 0, non-finite disk state, or capacity overflow "
                f"(overflow={int(self.state.overflow)}); state frozen at "
                f"the failing step for inspection", fail,
            )

    def _sync(self) -> None:
        """Wait for all queued device work."""
        jax.block_until_ready(self.state)

    # --- observation ---
    def macroscopic(self):
        """(rho, ux, uy) on host."""
        rho, ux, uy = lbm.moments(lbm.from_storage(self.state.f, self.cfg),
                                  self.cfg.gx, self.cfg.gy)
        return np.asarray(rho), np.asarray(ux), np.asarray(uy)

    def solid_fraction(self):
        d = self.state.disks
        cfg = self.cfg
        x, v, om, r, act = d.x, d.v, d.omega, d.r, d.active
        if cfg.max_disks > 0 and (cfg.wrap_lx or cfg.wrap_ly):
            _, (x, v, om, r, act), _, _, _ = imb.periodic_ghosts(
                x, v, om, r, act, cfg
            )
        eps, _, _ = imb.stamp_solid_fraction(x, v, om, r, act, cfg)
        return np.asarray(jnp.clip(eps, 0.0, 1.0))

    def disk_arrays(self):
        d = self.state.disks
        return {k: np.asarray(v) for k, v in d._asdict().items()}

    def hydro_forces(self):
        """(F (N, 2), T (N,)) hydrodynamic force/torque per disk, from
        one oracle IMB evaluation of the CURRENT state (observation
        only - the step computes its own inside the chunk). The primary
        use is reading the drag on fixed obstacle disks (DiskSpec.fixed),
        whose forces never feed back into motion. Jitted and cached, so
        repeated observations reuse one compiled program."""
        cfg = self.cfg

        if not hasattr(self, "_hydro_fn"):
            periodic = cfg.max_disks > 0 and bool(cfg.wrap_lx or cfg.wrap_ly)

            def observe(f, d):
                n_real = d.x.shape[0]
                x, v, om, r, act = d.x, d.v, d.omega, d.r, d.active
                gparent = None
                if periodic:
                    _, (x, v, om, r, act), gparent, _, _ = (
                        imb.periodic_ghosts(x, v, om, r, act, cfg)
                    )
                eps, usx, usy = imb.stamp_solid_fraction(x, v, om, r, act, cfg)
                if cfg.bc_west == "inlet":
                    eps, usx, usy = imb.mask_open_columns(eps, usx, usy)
                f_phys = lbm.from_storage(f, cfg)
                _, phix, phiy = imb.collide_imb(f_phys, eps, usx, usy, cfg)
                fh, th = imb.reduce_hydro_forces(
                    x, r, act, eps, phix, phiy, cfg
                )
                if gparent is not None:
                    fh, th = imb.fold_ghost_forces(fh, th, gparent, n_real)
                return fh, th

            self._hydro_fn = jax.jit(observe)
        fh, th = self._hydro_fn(self.state.f, self.state.disks)
        return np.asarray(fh), np.asarray(th)
