"""Smoke test of the coupled LBM-DEM system on NVIDIA GPUs.

Run from the repository root:

    python chip_smoke.py             # one card: phases 1-6
    python chip_smoke.py --cards 4   # four cards: the sharded phase only

Every phase drives the system through `Simulation.run` or the CLI's
`main`, in this process, checks what comes out and prints its readings;
a phase that fails ends the run with a non-zero exit. Without a GPU the
script exits non-zero before any phase. The last line of stdout is one
JSON object naming the device JAX reports.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BIG = 10**9  # out_interval that never fires inside a timed chunk


def log(msg: str) -> None:
    print(msg, flush=True)


def _timed_run(sim, steps: int, repeats: int):
    """(setup_s, best_s): the first Simulation.run compiles the chunk,
    the repeats re-run the compiled chunk."""
    t0 = time.perf_counter()
    sim.run(steps)
    setup = time.perf_counter() - t0
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        sim.run(steps)
        best = min(best, time.perf_counter() - t0)
    return setup, best


def _peak_gb() -> float:
    from lbmdem.utils import device

    return device.peak_bytes_in_use() / 1e9


def phase_fluid(n: int = 4096, steps: int = 200, repeats: int = 3) -> dict:
    """Pure fluid, f32: MLUPS over re-runs of the compiled chunk, set-up
    (compile) seconds and relative mass drift over the whole run."""
    import jax.numpy as jnp
    import numpy as np

    from lbmdem.config import SimConfig
    from lbmdem.simulation import Simulation

    sim = Simulation(SimConfig(nx=n, ny=n, tau=0.8, gx=1e-6,
                               bc_west="wall", bc_east="wall",
                               out_interval=BIG))
    def mass(f):
        # per-row f32 sums on the device, their total in f64 on the host
        return float(np.asarray(jnp.sum(f, axis=(0, 2)), np.float64).sum())

    m0 = mass(sim.state.f)
    setup, best = _timed_run(sim, steps, repeats)
    drift = abs(mass(sim.state.f) - m0) / m0
    if not bool(jnp.all(jnp.isfinite(sim.state.f))):
        raise FloatingPointError("fluid: non-finite f")
    if drift > 1e-5:  # walls and Guo forcing conserve mass exactly
        raise AssertionError(f"fluid: mass drift {drift:.3e} > 1e-5")
    r = {"n": n, "steps": steps, "setup_s": setup,
         "ms_per_step": 1e3 * best / steps,
         "mlups": n * n * steps / best / 1e6, "mass_drift": drift,
         "peak_gb": _peak_gb()}
    log(f"[fluid {n}^2 f32] setup {setup:.1f} s  {r['ms_per_step']:.4f} "
        f"ms/step  {r['mlups']:.1f} MLUPS  mass drift {drift:.2e}  "
        f"process peak {r['peak_gb']:.2f} GB")
    return r


def _check_coupled(sim, label: str) -> None:
    import jax.numpy as jnp
    import numpy as np

    st = sim.state
    if not bool(jnp.all(jnp.isfinite(st.f))):
        raise FloatingPointError(f"{label}: non-finite f")
    if int(st.overflow) != 0:
        raise AssertionError(f"{label}: overflow {int(st.overflow)}")
    d = sim.disk_arrays()
    x = d["x"][d["active"]]
    inside = ((x[:, 0] > -0.5) & (x[:, 0] < sim.cfg.nx - 0.5)
              & (x[:, 1] > -0.5) & (x[:, 1] < sim.cfg.ny - 0.5))
    if not (np.isfinite(x).all() and inside.all()):
        raise AssertionError(f"{label}: disks outside the domain")


def phase_coupled(n: int = 4096, n_disks: int = 10000, steps: int = 100,
                  repeats: int = 3, f_storage: str = "float32",
                  eps_method: str = "sample") -> dict:
    """The BASELINE north-star deck (column collapse): finite f, no
    capacity overflow, every disk inside the domain; MLUPS and peak."""
    from lbmdem.models import column_collapse
    from lbmdem.simulation import Simulation

    cfg, disks = column_collapse(nx=n, ny=n, n_disks=n_disks)
    cfg = cfg.replace(out_interval=BIG, f_storage=f_storage,
                      eps_method=eps_method)
    sim = Simulation(cfg, disks)
    setup, best = _timed_run(sim, steps, repeats)
    label = f"coupled {n}^2/{n_disks} {f_storage}/{eps_method}"
    _check_coupled(sim, label)
    r = {"n": n, "n_disks": n_disks, "f_storage": f_storage,
         "eps_method": eps_method, "steps": steps, "setup_s": setup,
         "ms_per_step": 1e3 * best / steps,
         "mlups": n * n * steps / best / 1e6,
         "contacts": int(sim.state.n_contacts), "peak_gb": _peak_gb()}
    log(f"[{label}] setup {setup:.1f} s  {r['ms_per_step']:.4f} ms/step  "
        f"{r['mlups']:.1f} MLUPS  contacts {r['contacts']}  "
        f"process peak {r['peak_gb']:.2f} GB")
    return r


def phase_settling() -> float:
    """Settling parity vs the f64 golden (tools/validate.py), < 1%."""
    from tools.validate import settling_parity

    err = settling_parity()
    log(f"[settling parity] max |dv|/scale {err:.6f} ({100 * err:.4f}%, "
        f"limit 1%)  process peak {_peak_gb():.2f} GB")
    return err


def phase_cli(steps: int = 1500, deck: str = "settling_column.par",
              out: str = os.path.join(ROOT, ".smoke_out")) -> dict:
    """The CLI on an example deck (a name under examples/ or a path),
    snapshots on, async writer."""
    from lbmdem import cli

    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    rc = cli.main([os.path.join(ROOT, "examples", deck), "--out", out,
                   "--steps", str(steps)])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli: exit code {rc}")
    files = sorted(os.listdir(out))
    fluid = [f for f in files if f.startswith("fluid_")]
    with open(os.path.join(out, "metrics.csv")) as fh:
        rows = fh.read().strip().splitlines()[1:]
    if not fluid or len(rows) != len(fluid):
        raise AssertionError(f"cli: {len(fluid)} snapshots, "
                             f"{len(rows)} metric rows")
    r = {"deck": deck, "steps": steps, "wall_s": wall,
         "snapshots": len(fluid), "files": len(files)}
    log(f"[cli {deck}] {steps} steps in {wall:.1f} s (compile + output "
        f"included), {len(fluid)} fluid snapshots, {len(files)} files")
    shutil.rmtree(out, ignore_errors=True)
    return r


def _traced(sim, steps: int, logdir: str) -> dict:
    """Kernel statistics of one traced Simulation.run(steps) (the chunk
    is already compiled), plus the compiled chunk's memory analysis."""
    import jax

    from lbmdem.utils import device

    shutil.rmtree(logdir, ignore_errors=True)
    with jax.profiler.trace(logdir):
        sim.run(steps)
    stats = device.kernel_stats(logdir, steps)
    mem = sim._chunk_fn(steps).lower(sim.state).compile().memory_analysis()
    if mem is not None:
        stats["temp_bytes"] = int(mem.temp_size_in_bytes)
        stats["argument_bytes"] = int(mem.argument_size_in_bytes)
        stats["alias_bytes"] = int(mem.alias_size_in_bytes)
    stats["f_bytes"] = int(sim.state.f.size * sim.state.f.dtype.itemsize)
    return stats


def phase_roofline(fluid: dict, coupled: dict, n: int = 4096,
                   n_disks: int = 10000, trace_steps: int = 20) -> dict:
    """Kernels per step, achieved bandwidth from the bytes-per-site model
    against a large copy measured here and the published peak, and
    whether the chunk holds an extra f buffer."""
    from lbmdem.config import SimConfig
    from lbmdem.models import column_collapse
    from lbmdem.simulation import Simulation
    from lbmdem.utils import device

    copy = device.copy_rate_gbs()
    hbm = device.peak(device.describe()["kind"])["hbm_gbs"]
    logroot = os.path.join(ROOT, "chiprun_out", "traces")
    out = {"copy_gbs": copy, "peak_hbm_gbs": hbm}
    sim = Simulation(SimConfig(nx=n, ny=n, tau=0.8, gx=1e-6,
                               bc_west="wall", bc_east="wall",
                               out_interval=BIG))
    sim.run(trace_steps)
    tf = _traced(sim, trace_steps, os.path.join(logroot, "fluid"))
    del sim
    cfg, disks = column_collapse(nx=n, ny=n, n_disks=n_disks)
    sim = Simulation(cfg.replace(out_interval=BIG), disks)
    cs = max(trace_steps // 4, 1)
    sim.run(cs)
    tc = _traced(sim, cs, os.path.join(logroot, "coupled"))
    del sim
    for name, rec, tr, coupled_ in (("fluid", fluid, tf, False),
                                    ("coupled", coupled, tc, True)):
        gbs = rec["mlups"] * device.bytes_per_site(coupled_) / 1e3
        out[name] = {"gbs_model": gbs, "share_of_copy": gbs / copy,
                     "share_of_peak": gbs / hbm, **tr}
        log(f"[roofline {name} {n}^2] {tr['kernels_per_step']:.1f} "
            f"kernels/step, device busy {tr.get('busy_ms_per_step', 0):.4f}"
            f" ms/step, idle share {tr.get('idle_share', 0):.4f}; model "
            f"{device.bytes_per_site(coupled_):.0f} B/site -> {gbs:.1f} "
            f"GB/s = {gbs / copy:.4f} of the {copy:.1f} GB/s copy, "
            f"{gbs / hbm:.4f} of the {hbm:.0f} GB/s peak; temp "
            f"{tr.get('temp_bytes', -1) / 1e9:.3f} GB vs f "
            f"{tr['f_bytes'] / 1e9:.3f} GB")
        for kname, ms, count in tr.get("top", []):
            log(f"    {ms:10.4f} ms/step  x{count:5.1f}  {kname}")
        log(f"    trace lines: {tr['lines']}")
    return out


def phase_sharded(n: int = 8192, n_disks: int = 40000, steps: int = 20,
                  mesh_shape=(4, 1), tol_f: float = 1e-4,
                  tol_x: float = 1e-4, tol_v: float = 1e-5) -> dict:
    """The sharded step on a mesh vs the same deck on one device after
    `steps` steps, both through Simulation.run. f32 on cards: the stamp
    and ghost-fold scatter-adds use atomics, and the per-disk force is a
    psum of shard partials, so sums are taken in another order than on
    one device; the tolerances bound that drift over `steps` steps and
    are far below what a wrong halo or a lost force would cause (O(1e-2)
    in f and O(1e-1) in x within a few steps)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from lbmdem.models import column_collapse
    from lbmdem.parallel import make_mesh
    from lbmdem.simulation import Simulation

    cfg, disks = column_collapse(nx=n, ny=n, n_disks=n_disks)
    cfg = cfg.replace(out_interval=BIG)
    mesh = make_mesh(shape=mesh_shape)
    cards = mesh_shape[0] * mesh_shape[1]
    sh = Simulation(cfg, disks, mesh=mesh)
    t0 = time.perf_counter()
    sh.run(steps)
    setup_sh = time.perf_counter() - t0
    ref = Simulation(cfg, disks)
    t0 = time.perf_counter()
    ref.run(steps)
    setup_ref = time.perf_counter() - t0
    _check_coupled(sh, "sharded")
    f_sh = jax.device_put(sh.state.f, jax.devices()[0])
    df = float(jnp.max(jnp.abs(f_sh - ref.state.f)))
    del f_sh
    d_sh, d_ref = sh.disk_arrays(), ref.disk_arrays()
    dx = float(np.abs(d_sh["x"] - d_ref["x"]).max())
    dv = float(np.abs(d_sh["v"] - d_ref["v"]).max())
    log(f"[sharded {n}^2/{n_disks} on {mesh_shape[0]}x{mesh_shape[1]}] "
        f"after {steps} steps vs one device: max|df| {df:.3e} (tol "
        f"{tol_f:g}), max|dx| {dx:.3e} (tol {tol_x:g}), max|dv| {dv:.3e} "
        f"(tol {tol_v:g})")
    if not (df <= tol_f and dx <= tol_x and dv <= tol_v):
        raise AssertionError("sharded step disagrees with one device")
    best_sh = best_ref = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        sh.run(steps)
        best_sh = min(best_sh, time.perf_counter() - t0)
        t0 = time.perf_counter()
        ref.run(steps)
        best_ref = min(best_ref, time.perf_counter() - t0)
    mlups_sh = n * n * steps / best_sh / 1e6
    mlups_ref = n * n * steps / best_ref / 1e6
    r = {"n": n, "n_disks": n_disks, "steps": steps, "cards": cards,
         "max_df": df, "max_dx": dx, "max_dv": dv,
         "setup_s_sharded": setup_sh, "setup_s_one": setup_ref,
         "mlups_sharded": mlups_sh, "mlups_per_card": mlups_sh / cards,
         "mlups_one_card": mlups_ref, "peak_gb_card0": _peak_gb()}
    log(f"[sharded {n}^2/{n_disks}] {mlups_sh:.1f} MLUPS on {cards} cards"
        f" = {mlups_sh / cards:.1f} MLUPS/card; one card "
        f"{mlups_ref:.1f} MLUPS; set-up {setup_sh:.1f} s / "
        f"{setup_ref:.1f} s; card-0 process peak "
        f"{r['peak_gb_card0']:.2f} GB")
    return r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded phase on four cards")
    args = ap.parse_args(argv)

    import jax

    from lbmdem.utils import device
    from lbmdem.utils.compile_cache import enable_compile_cache

    try:
        dev = device.require_gpu()
    except RuntimeError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if len(jax.devices()) < args.cards:
        print(f"chip_smoke: --cards {args.cards} needs {args.cards} GPUs, "
              f"have {len(jax.devices())}", file=sys.stderr)
        return 2
    cache = enable_compile_cache()
    log(device.nvidia_smi_line())
    log(f"device_kind {dev.device_kind}; {len(jax.devices())} device(s); "
        f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}"
        f"; compile cache {cache}")
    t_start = time.perf_counter()
    if args.cards == 4:
        phase_sharded()
    else:
        fluid = phase_fluid()
        coupled = phase_coupled()
        phase_coupled(f_storage="bfloat16", eps_method="ramp")
        phase_settling()
        phase_cli()
        phase_roofline(fluid, coupled)
    log(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
