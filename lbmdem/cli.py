"""Command-line driver (SURVEY.md SS2 C21): `python -m lbmdem.cli
run.par` mirrors the reference's `./lbmdem <paramfile>` entry point.

Runs the jitted step loop in out_interval chunks; each interval writes
VTK snapshots, appends the metrics CSV and particle trajectory log, and
(optionally) a restart checkpoint - the only recurring host crossings
(SURVEY SS3.2).
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="lbmdem",
        description="2D coupled LBM-DEM solver",
    )
    ap.add_argument("paramfile", help="reference-format parameter file")
    ap.add_argument("--out", default="out", help="output directory")
    ap.add_argument("--steps", type=int, default=None, help="override steps")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    metavar="N", help="write restart checkpoint every N steps")
    ap.add_argument("--restore", default=None, metavar="CKPT",
                    help="resume from checkpoint file")
    ap.add_argument("--ascii-vtk", action="store_true")
    ap.add_argument("--log-forces", action="store_true",
                    help="append per-disk hydrodynamic force/torque to "
                         "forces.csv at every output interval (drag/lift "
                         "time series; one extra IMB observation per "
                         "dump - Simulation.hydro_forces)")
    ap.add_argument("--sync-io", action="store_true",
                    help="write snapshots inline instead of overlapping "
                         "file I/O with the next chunk's device execution "
                         "(utils/async_io.py)")
    ap.add_argument("--paranoid", action="store_true",
                    help="validate f/rho/disks after every step inside "
                         "the jitted chunk and abort at the failing step "
                         "(SURVEY 5.2/5.3 debug mode)")
    ap.add_argument("--mesh", default=None, metavar="YxX",
                    help="shard the lattice over a device mesh, e.g. "
                         "'2x4' (y-by-x) or 'auto' for all devices")
    ap.add_argument("--distributed", action="store_true",
                    help="call jax.distributed.initialize() first "
                         "(multi-host runs; see parallel/launch.py)")
    ap.add_argument("--profile", default=None, metavar="LOGDIR",
                    help="capture a jax.profiler trace of the run")
    ap.add_argument("--scenario", default=None,
                    help="run a built-in scenario instead of a paramfile "
                         "(poiseuille|sedimentation|dkt|settling_column|"
                         "column_collapse); paramfile arg is ignored")
    args = ap.parse_args(argv)

    from lbmdem.config import load_param_file, load_particle_file
    from lbmdem.simulation import Simulation
    from lbmdem.utils import checkpoint as ckpt
    from lbmdem.utils.compile_cache import enable_compile_cache
    from lbmdem.utils.io_vtk import (
        append_force_csv, append_particle_csv, write_fluid_vtk,
        write_particles_vtk,
    )
    from lbmdem.utils.metrics import MetricsLogger

    if args.scenario:
        from lbmdem.models import make_scenario

        cfg, disks = make_scenario(args.scenario)
    else:
        cfg, pfile = load_param_file(args.paramfile)
        disks = load_particle_file(pfile, units=cfg.units) if pfile else []
    if args.steps is not None:
        cfg = cfg.replace(steps=args.steps)
    if args.paranoid:
        cfg = cfg.replace(paranoia=True)
    if cfg.dtype == "float64":
        import jax

        jax.config.update("jax_enable_x64", True)
    enable_compile_cache()

    mesh = None
    if args.distributed:
        from lbmdem.parallel import init_distributed, process_info

        init_distributed()
        pid, pn, loc, glob = process_info()
        print(f"distributed: process {pid}/{pn}, {loc} local / "
              f"{glob} global devices", file=sys.stderr)
    if args.mesh:
        from lbmdem.parallel import make_mesh

        if args.mesh == "auto":
            mesh = make_mesh()
        else:
            ysz, xsz = (int(t) for t in args.mesh.lower().split("x"))
            mesh = make_mesh(shape=(ysz, xsz))

    sim = Simulation(cfg, disks, mesh=mesh)
    cfg = sim.cfg  # Simulation derives max_disks/window/ghost_cap
    if args.restore:
        sim.state = ckpt.load_state(args.restore, sim.state)
        print(f"restored from {args.restore} at step {int(sim.state.step)}")

    os.makedirs(args.out, exist_ok=True)
    logger = MetricsLogger(os.path.join(args.out, "metrics.csv"))
    from lbmdem.utils.async_io import AsyncWriter

    writer = AsyncWriter(max_pending=0 if args.sync_io else 2)

    def emit(fn, *a, **kw):
        # --sync-io: run inline (debugging / strict-ordering needs);
        # default: overlap file work with the next chunk (the args are
        # host numpy arrays, so the device buffers stay donatable)
        if args.sync_io:
            fn(*a, **kw)
        else:
            writer.submit(fn, *a, **kw)

    def snapshot(s: Simulation):
        step = int(s.state.step)
        row = logger.log(s)
        print(
            f"step {step:8d}  mass={row['mass']:.6e}  max_u={row['max_u']:.4f}"
            f"  contacts={int(row['n_contacts'])}  overflow={int(row['overflow'])}"
            f"  {row['mlups']:.0f} MLUPS",
            flush=True,
        )
        if row["nan"]:
            raise RuntimeError(f"NaN in distributions at step {step}")
        rho, ux, uy = s.macroscopic()
        eps = s.solid_fraction() if cfg.max_disks else None
        emit(
            write_fluid_vtk,
            os.path.join(args.out, f"fluid_{step:08d}.vtk"),
            rho, ux, uy, eps, binary=not args.ascii_vtk,
        )
        if cfg.max_disks:
            d = s.disk_arrays()
            emit(
                write_particles_vtk,
                os.path.join(args.out, f"particles_{step:08d}.vtk"), d,
            )
            emit(
                append_particle_csv,
                os.path.join(args.out, "trajectories.csv"), step, d,
            )
            if args.log_forces:
                # hydro_forces() syncs device->host here; only the file
                # append rides the async pipeline
                F, T = s.hydro_forces()
                emit(
                    append_force_csv,
                    os.path.join(args.out, "forces.csv"), step,
                    d["active"], F, T,
                )
        if args.checkpoint_every and step % args.checkpoint_every == 0:
            import jax

            # materialize BEFORE queueing: the next chunk donates the
            # device buffers, so the worker must never touch s.state
            host_state = jax.device_get(s.state)
            emit(
                ckpt.save_state,
                os.path.join(args.out, "restart.npz"), host_state, s.cfg,
            )

    remaining = cfg.steps - int(sim.state.step)
    if remaining <= 0:
        print("nothing to do (steps already completed)", file=sys.stderr)
        return 0
    run_failed = False
    try:
        if args.profile:
            from lbmdem.utils.profiling import trace

            with trace(args.profile):
                mlups = sim.run(remaining, callback=snapshot)
        else:
            mlups = sim.run(remaining, callback=snapshot)
    except BaseException:
        run_failed = True
        raise
    finally:
        try:
            writer.close()  # drain pending frames; surface write errors
        except Exception:
            if not run_failed:  # never mask a run() failure
                raise
    print(f"done: {remaining} steps, {mlups:.0f} MLUPS overall")
    return 0


if __name__ == "__main__":
    sys.exit(main())
