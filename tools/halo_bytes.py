"""Halo bytes of the sharded step, from the exchange geometry and as the
compiler emits them (SURVEY.md SS5.7/SS7).

The sharded step (parallel/sharding.py) exchanges width-1 halos of the
3 populations that enter through each face: x faces first, then y
faces including the x-halo columns so corners ride the y exchange. Per
step and shard (local h x w, B bytes per value):

    y faces: 2 * 3 * (w + 2) * B
    x faces: 2 * 3 * h * B

Coupled runs add one psum of the per-disk force and torque (3 values
per disk slot). `witness()` lowers the real sharded program on a
virtual CPU mesh and checks the compiled collective-permute payload
against the formula, so the table is the compiler's, not only derived.
Time spent in the exchange is a device measurement (a profiler trace on
the cards), not something this table can give.

Usage:
    python -m tools.halo_bytes                       # 8192^2 on 4x1
    python -m tools.halo_bytes --ny 4096 --nx 4096 --mesh 2x2
    python -m tools.halo_bytes --witness --mesh 2x2  # fresh process
"""

import argparse
import re


def xla_bytes(h, w, B):
    """(y-face bytes, x-face bytes) one shard sends per step."""
    return 2 * 3 * (w + 2) * B, 2 * 3 * h * B


_DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s64": 8,
                "s32": 4, "u32": 4, "s16": 2, "u16": 2, "s8": 1,
                "u8": 1, "pred": 1}


def _type_elems_bytes(type_str):
    """(elements, bytes) of an HLO result type like 'f32[9,8,256]{2,1,0}'
    or a tuple '(f32[16,2], f32[16])'."""
    elems = tot = 0
    for dt, dims in re.findall(r"(\w+)\[([\d,]*)\]", type_str):
        size = _DTYPE_BYTES.get(dt)
        if size is None:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        elems += n
        tot += n * size
    return elems, tot


def hlo_collective_bytes(txt):
    """(ppermute_elems, ppermute_bytes, allreduce_bytes) summed over the
    collective ops of a compiled HLO module text — the compiler-witnessed
    per-shard traffic of ONE call of the lowered program."""
    pe = pb = ar = 0
    for m in re.finditer(
        r"=\s*(\([^)]*\)|\S+)\s+(collective-permute|all-reduce)"
        r"(?:-start)?\(", txt
    ):
        e, b = _type_elems_bytes(m.group(1))
        if m.group(2) == "collective-permute":
            pe += e
            pb += b
        else:
            ar += b
    return pe, pb, ar


def witness(mesh_shape=(2, 2)):
    """Compile the sharded step on a virtual CPU mesh and check the
    compiled collective-permute bytes against xla_bytes. Must run in a
    fresh process (sets the XLA device-count flag before importing
    jax)."""
    import os

    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count="
          f"{mesh_shape[0] * mesh_shape[1]}"
    ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)  # the f64 rows are real f64
    from lbmdem.config import DiskSpec, SimConfig
    from lbmdem.parallel import make_mesh, make_sharded_step
    from lbmdem.simulation import Simulation

    mesh = make_mesh(jax.devices()[: mesh_shape[0] * mesh_shape[1]],
                     mesh_shape)
    ny_sh, nx_sh = mesh_shape

    def lower_bytes(cfg, disks=()):
        sim = Simulation(cfg, list(disks), mesh=mesh)
        step = make_sharded_step(sim.cfg, sim.grid, mesh)
        txt = jax.jit(step).lower(sim.state).compile().as_text()
        return hlo_collective_bytes(txt)

    cfg = SimConfig(nx=32 * nx_sh, ny=16 * ny_sh, tau=0.8, gx=1e-6,
                    dtype="float64")
    want = sum(xla_bytes(cfg.ny // ny_sh, cfg.nx // nx_sh, 8))
    checks = [("fluid f64", *lower_bytes(cfg)[:2])]
    disks = [DiskSpec(10.3, 10.2, 3.0), DiskSpec(40.0, 20.0, 3.0)]
    pe, pb, ar = lower_bytes(cfg.replace(max_disks=2, n_sub=2), disks)
    checks.append(("coupled f64 halos", pe, pb))
    force_bytes = 2 * 3 * 8  # psum of (N,2) force + (N,) torque, f64
    assert ar >= force_bytes, f"force psum missing: {ar} < {force_bytes}"
    print(f"coupled all-reduce bytes: {ar} (>= force psum {force_bytes})")
    for name, pe, pb in checks:
        status = "OK" if pb == want else "MISMATCH"
        print(f"{name:<20} HLO {pe:>7} elems/{pb:>8} B  "
              f"model {want // 8:>7} elems/{want:>8} B  {status}")
        assert pb == want, f"{name}: compiled {pb} B != model {want}"
    print("HALO WITNESS OK: compiled collective bytes == model")
    return checks


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ny", type=int, default=8192)
    ap.add_argument("--nx", type=int, default=8192)
    ap.add_argument("--mesh", default="4x1")
    ap.add_argument("--max-disks", type=int, default=40000)
    ap.add_argument("--witness", action="store_true",
                    help="compile the sharded step on a virtual CPU mesh "
                         "and assert the HLO collective bytes match the "
                         "model (fresh process required)")
    args = ap.parse_args(argv)
    ny_sh, nx_sh = (int(t) for t in args.mesh.split("x"))
    if args.witness:
        witness((ny_sh, nx_sh))
        return
    h, w = args.ny // ny_sh, args.nx // nx_sh
    yb, xb = xla_bytes(h, w, 4)
    halo = (yb if ny_sh > 1 else 0) + (xb if nx_sh > 1 else 0)
    psum = 3 * args.max_disks * 4
    f_bytes = 2 * 9 * h * w * 4
    print(f"{args.ny}x{args.nx} f32 on a {ny_sh}x{nx_sh} mesh, shard "
          f"{h}x{w}:")
    print(f"  halo sent/step/shard  {halo:>12} B")
    print(f"  force psum payload    {psum:>12} B ({args.max_disks} disks)")
    print(f"  f read+write/step     {f_bytes:>12} B "
          f"(halo = {halo / f_bytes:.2e} of it)")


if __name__ == "__main__":
    main()
