"""What the measurement paths know about the device they run on.

`bench.py` and `chip_smoke.py` share these: the published peak of each
supported card, the line that names the device beside every number,
the large-copy rate measured in the same process, the bytes-per-site
model the achieved bandwidth is computed from, and the reduction of a
profiler trace to kernels per step and device busy time.
"""

from __future__ import annotations

import glob
import os
import subprocess
import time

import jax
import jax.numpy as jnp

# Published peaks, keyed by jax.devices()[0].device_kind. Source:
# NVIDIA H100 Tensor Core GPU data sheet, SXM part (80 GB HBM3 at
# 3.35 TB/s; 67 TFLOP/s float32 outside the tensor cores), at the full
# 700 W power limit. A device missing here is an error, not a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_gbs": 3350.0, "f32_tflops": 67.0},
}


def peak(kind: str) -> dict:
    """The PEAKS row for a device_kind; raises for an unknown device."""
    try:
        return PEAKS[kind]
    except KeyError:
        raise ValueError(
            f"no published peak for device_kind {kind!r}; add it to "
            f"lbmdem.utils.device.PEAKS with its source"
        ) from None


def require_gpu() -> jax.Device:
    """The first device, which must be a GPU: a measurement that finds
    no card fails instead of timing the CPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's first device is {dev.platform!r} "
            f"({dev.device_kind}); device numbers need the card"
        )
    return dev


def nvidia_smi_line() -> str:
    """`name, power.limit` of the cards as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def describe() -> dict:
    """Platform, device_kind, device count, card name + power limit and
    XLA_FLAGS: the fields every reported number carries."""
    dev = jax.devices()[0]
    return {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
        "nvidia_smi": nvidia_smi_line(),
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
    }


def bytes_per_site(coupled: bool, f_storage: str = "float32") -> float:
    """Model bytes per lattice site per step: the 9 populations read
    once and written once, plus, when coupled, the 3-plane float32
    solid stack (eps, us_x, us_y) counted once. Achieved GB/s is
    MLUPS x this; extra passes over f show as a shortfall against the
    measured copy rate."""
    f_bytes = 2 if f_storage == "bfloat16" else 4
    return 2 * 9 * f_bytes + (12 if coupled else 0)


def copy_rate_gbs(nbytes: int = 4 << 30, repeats: int = 5) -> float:
    """Bytes moved per second by a large elementwise pass (read nbytes,
    write nbytes) on the default device, best of `repeats`."""
    n = nbytes // 4
    x = jnp.ones((n,), jnp.float32)
    f = jax.jit(lambda a: a + 1.0)
    jax.block_until_ready(f(x))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(f(x))
        best = min(best, time.perf_counter() - t0)
    del x
    return 2 * nbytes / best / 1e9


def peak_bytes_in_use() -> int:
    """Process peak of device memory held by arrays (0 when the backend
    keeps no statistics)."""
    stats = jax.devices()[0].memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", 0))


def union_length(spans) -> float:
    """Total length covered by (start, end) intervals (overlaps counted
    once): the device's busy time when the spans are its kernels."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def kernel_stats(logdir: str, steps: int) -> dict:
    """Reduce the newest profiler trace under `logdir` to device terms.

    Kernel events are those on the device planes' stream lines; the XLA
    module and op summary lines are skipped. Returns kernels per step,
    the union of kernel intervals (busy) and the window they span, and
    the heaviest kernels by summed device time."""
    from jax.profiler import ProfileData

    paths = sorted(glob.glob(os.path.join(logdir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no trace under {logdir}")
    pd = ProfileData.from_file(paths[-1])
    spans, per_name, lines = [], {}, {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            evs = list(line.events)
            lines[f"{plane.name}|{line.name}"] = len(evs)
            if "XLA Modules" in line.name or "XLA Ops" in line.name \
                    or "Steps" in line.name or "Source" in line.name:
                continue
            for e in evs:
                spans.append((e.start_ns, e.start_ns + e.duration_ns))
                tot, cnt = per_name.get(e.name, (0.0, 0))
                per_name[e.name] = (tot + e.duration_ns, cnt + 1)
    if not spans:
        return {"lines": lines, "kernels_per_step": 0.0}
    busy = union_length(spans)
    window = max(e for _, e in spans) - min(s for s, _ in spans)
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {
        "lines": lines,
        "kernels_per_step": len(spans) / steps,
        "busy_ms_per_step": busy / steps / 1e6,
        "window_ms": window / 1e6,
        "idle_share": 1.0 - busy / window if window else 0.0,
        "top": [(name[:80], round(t / steps / 1e6, 4), c / steps)
                for name, (t, c) in top],
    }
