"""Benchmark: lattice updates per second (MLUPS) of the coupled LBM-DEM
step on one GPU, one JSON line per stage.

    python bench.py                # every stage, smallest first
    BENCH_ONLY=4096 python bench.py

Each stage builds its deck, runs one chunk to compile (reported as
set-up seconds), then re-runs the same compiled chunk `repeats` times
and keeps the best. Every line names the device (platform, device_kind,
count, nvidia-smi name and power limit, XLA_FLAGS) and carries the
achieved bandwidth from the bytes-per-site model, as a share of the
published peak and of a large copy measured in the same process. The
last line repeats the best coupled stage with every stage's numbers.
There is no CPU fallback: without a GPU the run fails.
"""

import json
import os
import sys
import time


def _timed(sim, chunk, repeats):
    """(setup_s, best_s) for Simulation.run(chunk): the first run
    compiles, the repeats re-run the compiled chunk."""
    t0 = time.perf_counter()
    sim.run(chunk)
    setup = time.perf_counter() - t0
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        sim.run(chunk)
        best = min(best, time.perf_counter() - t0)
    return setup, best


def _fluid(n, storage):
    from lbmdem.config import SimConfig

    return SimConfig(nx=n, ny=n, tau=0.8, gx=1e-6, f_storage=storage,
                     out_interval=10**9), []


def _coupled(n, n_disks, storage, eps):
    from lbmdem.models import column_collapse

    cfg, disks = column_collapse(nx=n, ny=n, n_disks=n_disks)
    return cfg.replace(out_interval=10**9, eps_method=eps,
                       f_storage=storage), disks


def _static(n, n_disks):
    """A bed of fixed disks at rest (every disk fixed: the DEM subcycle
    reduces to a drift)."""
    import numpy as np

    from lbmdem.config import DiskSpec, SimConfig

    rng = np.random.default_rng(0)
    side = int(np.ceil(np.sqrt(n_disks)))
    pitch = (n - 40.0) / side
    disks = []
    for i in range(n_disks):
        gy, gx = divmod(i, side)
        disks.append(DiskSpec(
            20.0 + (gx + 0.5) * pitch + rng.uniform(-2, 2),
            20.0 + (gy + 0.5) * pitch + rng.uniform(-2, 2),
            4.0, fixed=True,
        ))
    return SimConfig(nx=n, ny=n, tau=0.8, gx=1e-6, max_disks=n_disks,
                     out_interval=10**9), disks


# (label, deck builder, builder args, coupled, chunk, repeats)
STAGES = [
    ("fluid/4096/float32", _fluid, (4096, "float32"), False, 400, 3),
    ("fluid/4096/bfloat16", _fluid, (4096, "bfloat16"), False, 400, 3),
    ("static/4096/4096", _static, (4096, 4096), True, 200, 3),
    ("coupled/1024/640/float32/sample", _coupled,
     (1024, 640, "float32", "sample"), True, 400, 3),
    ("coupled/2048/2500/float32/sample", _coupled,
     (2048, 2500, "float32", "sample"), True, 200, 3),
    ("coupled/4096/10000/float32/sample", _coupled,
     (4096, 10000, "float32", "sample"), True, 100, 3),
    ("coupled/4096/10000/bfloat16/ramp", _coupled,
     (4096, 10000, "bfloat16", "ramp"), True, 100, 3),
    ("coupled/8192/40000/float32/sample", _coupled,
     (8192, 40000, "float32", "sample"), True, 50, 2),
]


def main():
    import jax
    import numpy as np

    from lbmdem.simulation import Simulation
    from lbmdem.utils import device
    from lbmdem.utils.compile_cache import enable_compile_cache

    device.require_gpu()
    cache = enable_compile_cache()
    dev = device.describe()
    pk = device.peak(dev["kind"])
    copy_gbs = device.copy_rate_gbs()
    print(f"bench: {dev['nvidia_smi']} | {dev['kind']} x{dev['count']} | "
          f"copy {copy_gbs:.1f} GB/s | cache {cache}", file=sys.stderr)
    only = os.environ.get("BENCH_ONLY")
    stages, best = {}, None
    for label, build, bargs, coupled, chunk, repeats in STAGES:
        if only and bargs[0] != int(only):
            continue
        cfg, disks = build(*bargs)
        sim = Simulation(cfg, disks)
        setup_s, best_s = _timed(sim, chunk, repeats)
        f = np.asarray(sim.state.f[:, ::64, ::64], np.float32)
        if not np.isfinite(f).all():
            raise FloatingPointError(f"{label}: non-finite f")
        if int(sim.state.overflow) != 0:
            raise RuntimeError(f"{label}: capacity overflow")
        mlups = cfg.nx * cfg.ny * chunk / best_s / 1e6
        gbs = mlups * device.bytes_per_site(coupled, cfg.f_storage) / 1e3
        rec = {
            "metric": f"MLUPS ({label})",
            "value": mlups,
            "unit": "MLUPS",
            "ms_per_step": 1e3 * best_s / chunk,
            "setup_s": setup_s,
            "gbs_model": gbs,
            "share_of_copy": gbs / copy_gbs,
            "share_of_peak_hbm": gbs / pk["hbm_gbs"],
            "copy_gbs": copy_gbs,
            "peak_bytes_in_use": device.peak_bytes_in_use(),
            "device": dev,
        }
        stages[label] = {k: rec[k] for k in
                         ("value", "ms_per_step", "setup_s", "gbs_model")}
        print(json.dumps(rec), flush=True)
        if label.startswith("coupled/") and (
                best is None or mlups > best["value"]):
            best = rec
        del sim
        jax.clear_caches()
    if best is None:
        raise SystemExit("bench: no coupled stage ran")
    print(json.dumps({**best, "stages": stages}), flush=True)


if __name__ == "__main__":
    main()
