"""Distributed step vs single-device oracle on a simulated CPU mesh
(SURVEY.md SS4 "Distributed"): halo exchange, edge-selective bounce-back
and particle-force psum must reproduce the unsharded step exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lbmdem.config import DiskSpec, SimConfig
from lbmdem.parallel import make_mesh, make_sharded_step, shard_state
from lbmdem.simulation import Simulation, make_step_fn


def _mesh(ysz, xsz):
    devs = jax.devices()[: ysz * xsz]
    if len(devs) < ysz * xsz:
        pytest.skip(f"need {ysz * xsz} devices")
    return make_mesh(devs, (ysz, xsz))


def _run_both(cfg, disks, mesh, nsteps):
    sim = Simulation(cfg, disks)
    step_ref = jax.jit(make_step_fn(sim.cfg, sim.grid))
    step_sh = jax.jit(make_sharded_step(sim.cfg, sim.grid, mesh))
    s_ref = sim.state
    s_sh = shard_state(sim.state, mesh)
    for _ in range(nsteps):
        s_ref = step_ref(s_ref)
        s_sh = step_sh(s_sh)
    return s_ref, s_sh


@pytest.mark.parametrize("meshdims", [(2, 4), (1, 8), (4, 2)])
def test_pure_fluid_sharded_matches(meshdims):
    mesh = _mesh(*meshdims)
    cfg = SimConfig(nx=32, ny=16, tau=0.8, gx=1e-5, dtype="float64")
    rng = np.random.default_rng(0)
    sref, ssh = _run_both(cfg, [], mesh, 5)
    np.testing.assert_array_equal(np.asarray(sref.f), np.asarray(ssh.f))


def test_pure_fluid_all_walls_sharded_matches():
    mesh = _mesh(2, 2)
    cfg = SimConfig(nx=16, ny=16, tau=0.7, gy=-1e-5, dtype="float64",
                    bc_west="wall", bc_east="wall")
    sref, ssh = _run_both(cfg, [], mesh, 6)
    np.testing.assert_array_equal(np.asarray(sref.f), np.asarray(ssh.f))


@pytest.mark.parametrize("meshdims", [(2, 2), (4, 1)])
def test_openbc_sharded_matches(meshdims):
    """Zou/He inlet/outlet on the sharded XLA step: the edge-shard
    reconstruction (global-y inlet profile sliced from the SAME host
    array the oracle bakes in, outlet closure) must reproduce the
    unsharded oracle to f64 roundoff. Not bitwise like the wall tests:
    the closure's mul-add chains FMA-fuse differently in the two
    program shapes (observed 1-2 ulp at single inlet rows)."""
    mesh = _mesh(*meshdims)
    cfg = SimConfig(nx=32, ny=16, tau=0.8, dtype="float64",
                    bc_west="inlet", bc_east="outlet", u_inlet=0.06,
                    inlet_profile="poiseuille")
    sref, ssh = _run_both(cfg, [], mesh, 6)
    np.testing.assert_allclose(np.asarray(sref.f), np.asarray(ssh.f),
                               rtol=0, atol=1e-14)


def test_openbc_sharded_with_obstacle():
    """Fixed obstacle + open boundaries on a 2x2 mesh."""
    mesh = _mesh(2, 2)
    cfg = SimConfig(nx=32, ny=16, tau=0.8, dtype="float64", max_disks=1,
                    window=9, bc_west="inlet", bc_east="outlet",
                    u_inlet=0.06, inlet_profile="poiseuille")
    disks = [DiskSpec(16.0, 8.0, 3.0, fixed=True)]
    sref, ssh = _run_both(cfg, disks, mesh, 4)
    np.testing.assert_allclose(np.asarray(sref.f), np.asarray(ssh.f),
                               rtol=0, atol=1e-15)


def test_coupled_sharded_matches():
    """Disks straddling shard boundaries: stamping, force psum, DEM."""
    mesh = _mesh(2, 2)
    cfg = SimConfig(
        nx=32, ny=32, tau=0.8, dtype="float64", g_py=-1e-4, buoyancy=True,
        rho_s=2.5, kn=0.5, gamma_n=0.5, n_sub=5,
        bc_west="wall", bc_east="wall",
    )
    disks = [
        DiskSpec(16.0, 16.0, 3.0),   # dead center: straddles all 4 shards
        DiskSpec(8.2, 24.1, 2.5),    # interior of one shard
        DiskSpec(15.0, 7.5, 2.0, vx=0.01),  # straddles x boundary
    ]
    sref, ssh = _run_both(cfg, disks, mesh, 4)
    np.testing.assert_allclose(np.asarray(sref.f), np.asarray(ssh.f),
                               rtol=0, atol=1e-15)
    np.testing.assert_allclose(np.asarray(sref.disks.x), np.asarray(ssh.disks.x),
                               rtol=0, atol=1e-15)
    np.testing.assert_allclose(np.asarray(sref.disks.v), np.asarray(ssh.disks.v),
                               rtol=0, atol=1e-15)
    np.testing.assert_allclose(np.asarray(sref.disks.omega),
                               np.asarray(ssh.disks.omega), rtol=0, atol=1e-15)
    assert int(ssh.overflow) == 0


def test_cavity_sharded_matches():
    """Moving-wall (lid-driven cavity) corrections on edge shards."""
    mesh = _mesh(2, 2)
    cfg = SimConfig(nx=16, ny=16, tau=0.7, dtype="float64",
                    bc_west="wall", bc_east="wall", uw_north=0.08,
                    uw_west=0.02)
    sref, ssh = _run_both(cfg, [], mesh, 6)
    np.testing.assert_array_equal(np.asarray(sref.f), np.asarray(ssh.f))


def test_sharded_mass_conservation():
    mesh = _mesh(2, 4)
    cfg = SimConfig(nx=64, ny=32, tau=0.9, gx=1e-6, dtype="float64")
    sim = Simulation(cfg)
    step = jax.jit(make_sharded_step(cfg, None, mesh))
    s = shard_state(sim.state, mesh)
    m0 = float(jnp.sum(s.f))
    for _ in range(20):
        s = step(s)
    assert abs(float(jnp.sum(s.f)) - m0) < 1e-10 * m0


# Mesh x boundary/physics cases on the sharded step: every case must
# reproduce the single-device step. f64 on the CPU: the operation order
# is the same on both sides, so walls, TRT, LES and the coupled paths
# agree to roundoff (1e-13 leaves room for FMA-contraction differences
# between the two program shapes, as in the open-boundary tests above).
_SHARDED_CASES = [
    ((2, 2), dict(collision="trt", gx=1e-5, bc_west="wall",
                  bc_east="wall"), False),
    ((4, 1), dict(smagorinsky=0.16, gx=2e-5), False),
    ((1, 4), dict(bc_west="wall", bc_east="wall", uw_north=0.05,
                  uw_south=-0.02, gy=-1e-5), False),
    ((2, 2), dict(bc_south="periodic", bc_north="periodic", gx=1e-5,
                  gy=5e-6), False),
    ((4, 1), dict(bc_west="inlet", bc_east="outlet", u_inlet=0.05,
                  bc_south="periodic", bc_north="periodic"), False),
    ((2, 2), dict(eps_method="ramp"), True),
    ((4, 1), dict(kt=0.4, gamma_t=0.2, mu=0.3), True),
    ((2, 2), dict(collision="trt", eps_method="exact"), True),
]


@pytest.mark.parametrize("meshdims,extra,coupled", _SHARDED_CASES)
def test_sharded_cases_match(meshdims, extra, coupled):
    mesh = _mesh(*meshdims)
    kw = dict(nx=32, ny=32, tau=0.8, dtype="float64")
    disks = []
    if coupled:
        kw.update(g_py=-1e-4, buoyancy=True, rho_s=2.0, kn=0.5,
                  gamma_n=0.5, n_sub=4, bc_west="wall", bc_east="wall")
        disks = [
            DiskSpec(16.0, 16.0, 3.0),           # straddles the seams
            DiskSpec(16.2, 21.9, 3.0),           # overlapping pair
            DiskSpec(7.5, 8.2, 2.5, vx=0.01, omega=0.003),
        ]
    kw.update(extra)
    sref, ssh = _run_both(SimConfig(**kw), disks, mesh, 3)
    np.testing.assert_allclose(np.asarray(sref.f), np.asarray(ssh.f),
                               rtol=0, atol=1e-13)
    if coupled:
        assert int(ssh.overflow) == 0
        for name in ("x", "v", "omega", "ct_xi"):
            np.testing.assert_allclose(
                np.asarray(getattr(sref.disks, name)),
                np.asarray(getattr(ssh.disks, name)), rtol=0, atol=1e-13)
        np.testing.assert_array_equal(np.asarray(sref.disks.ct_j),
                                      np.asarray(ssh.disks.ct_j))
        if extra.get("kt"):
            assert np.abs(np.asarray(sref.disks.ct_xi)).max() > 0


def test_bf16_mesh_rejections():
    """bf16 storage is single-device only: the sharded step consumes raw
    f32 f, and shifted-bf16 g would silently collide to NaN (rho =
    sum(g) = 0 at rest). Both the driver and the step builder refuse."""
    mesh = _mesh(2, 2)
    cfg = SimConfig(nx=64, ny=32, dtype="float32", f_storage="bfloat16",
                    bc_west="wall", bc_east="wall")
    with pytest.raises(ValueError, match="raw f32"):
        Simulation(cfg, mesh=mesh)
    with pytest.raises(ValueError, match="float32-storage"):
        make_sharded_step(cfg, None, mesh)


def test_mesh_bf16_storage_rejected():
    """The refusal holds for coupled decks and 1D meshes too, and the
    same deck runs on one device."""
    mesh = _mesh(4, 1)
    cfg = SimConfig(nx=64, ny=32, tau=0.8, dtype="float32",
                    f_storage="bfloat16", max_disks=1)
    disks = [DiskSpec(30.0, 16.0, 3.0)]
    with pytest.raises(ValueError, match="raw f32"):
        Simulation(cfg, disks, mesh=mesh)
    sim = Simulation(cfg, disks)
    sim.run(2)
    assert int(sim.state.step) == 2


def test_simulation_mesh_api_matches():
    """User-facing Simulation(mesh=...) == unsharded Simulation.run."""
    mesh = _mesh(2, 4)
    cfg = SimConfig(nx=64, ny=32, tau=0.8, gx=1e-5, dtype="float64",
                    out_interval=4)
    s1 = Simulation(cfg)
    s2 = Simulation(cfg, mesh=mesh)
    s1.run(8)
    s2.run(8)
    np.testing.assert_array_equal(np.asarray(s1.state.f), np.asarray(s2.state.f))


def test_sharded_paranoia_runs():
    """Regression: paranoia=True on the sharded XLA path used to crash
    at trace time (paranoid_wrap passes f_scratch into what was a 1-arg
    shard_map signature)."""
    mesh = _mesh(2, 4)
    cfg = SimConfig(nx=32, ny=16, tau=0.8, gx=1e-5, dtype="float64",
                    paranoia=True, out_interval=2)
    sim = Simulation(cfg, mesh=mesh)
    sim.run(4)
    assert int(sim.state.fail_step) == -1


_DIST2_WORKER = """
import os
import numpy as np
# LAST flag wins: the pytest parent leaks an 8-device flag via env
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=4"
)
import jax
jax.config.update("jax_platforms", "cpu")
from lbmdem.parallel import init_distributed
init_distributed()  # topology from JAX_* env vars
from jax.sharding import NamedSharding, PartitionSpec as P
from lbmdem.config import SimConfig
from lbmdem.parallel import make_mesh, make_sharded_step
from lbmdem.parallel.sharding import state_specs
from lbmdem.simulation import Simulation, make_step_fn

assert jax.process_count() == 2 and jax.device_count() == 8
cfg = SimConfig(nx=32, ny=16, tau=0.8, gx=1e-5, dtype="float64",
                bc_west="wall", bc_east="wall", uw_north=0.05)
sim = Simulation(cfg)
# single-device reference, computed redundantly on each process
step_ref = jax.jit(make_step_fn(cfg, None))
s_ref = sim.state
for _ in range(5):
    s_ref = step_ref(s_ref)
ref_f = np.asarray(s_ref.f)

mesh = make_mesh()  # all 8 global devices -> (2, 4)
specs = state_specs()

def globalize(x, spec):
    x = np.asarray(x)
    sh = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(x.shape, sh, lambda idx: x[idx])

leaves, treedef = jax.tree.flatten(sim.state)
spec_leaves = jax.tree.flatten(
    specs, is_leaf=lambda s: isinstance(s, P))[0]
state = jax.tree.unflatten(
    treedef, [globalize(l, s) for l, s in zip(leaves, spec_leaves)])
step = jax.jit(make_sharded_step(cfg, None, mesh))
for _ in range(5):
    state = step(state)
# each process checks ITS addressable shards against the reference
for shard in state.f.addressable_shards:
    np.testing.assert_array_equal(np.asarray(shard.data),
                                  ref_f[shard.index])
assert int(state.step) == 5
print("DIST2_OK", jax.process_index(), flush=True)
"""


def test_init_distributed_two_processes():
    """SURVEY 5.8, actually multi-process: two CPU processes x 4 virtual
    devices each form one 8-device (2, 4) mesh; the sharded step's
    ppermute halo exchange and edge-selective bounce-back cross the
    process boundary, and every process's addressable shards must equal
    the single-device reference exactly."""
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:  # pick a free coordinator port
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ,
               JAX_COORDINATOR_ADDRESS=f"localhost:{port}",
               JAX_NUM_PROCESSES="2")
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _DIST2_WORKER],
            env=dict(env, JAX_PROCESS_ID=str(i)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=420)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (rc, out, err) in enumerate(outs):
        assert rc == 0 and f"DIST2_OK {i}" in out, (
            f"process {i}: rc={rc}\n{err[-3000:]}"
        )


def test_init_distributed_single_process():
    """SURVEY 5.8: the multi-process launch path, exercised with the
    1-process topology (same code path a pod launch takes). Runs in a
    subprocess: jax.distributed.initialize must precede any backend use,
    and this pytest process has long since initialized it."""
    import subprocess
    import sys

    code = """
import jax
jax.config.update('jax_platforms', 'cpu')
from lbmdem.parallel import init_distributed, process_info
init_distributed(coordinator_address='localhost:12399',
                 num_processes=1, process_id=0)
pid, pn, loc, glob = process_info()
assert (pid, pn) == (0, 1), (pid, pn)
assert loc == glob == len(jax.devices())
init_distributed()  # idempotent
print('DIST_OK')
"""
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=240,
    )
    assert "DIST_OK" in out.stdout, out.stderr[-2000:]


def test_ici_witness_xla_bytes():
    """The halo-bytes model of the sharded step vs the compiler: lower
    the sharded f64 step on a (2,2) mesh and assert the summed
    collective-permute payload in the optimized HLO equals
    xla_bytes(h, w, 8) exactly (tools/halo_bytes.py --witness runs the
    same check plus the coupled force psum)."""
    from tools.halo_bytes import hlo_collective_bytes, xla_bytes

    mesh = _mesh(2, 2)
    cfg = SimConfig(nx=64, ny=32, tau=0.8, gx=1e-6, dtype="float64")
    sim = Simulation(cfg, mesh=mesh)
    step = make_sharded_step(sim.cfg, sim.grid, mesh)
    txt = jax.jit(step).lower(sim.state).compile().as_text()
    pe, pb, ar = hlo_collective_bytes(txt)
    want = sum(xla_bytes(16, 32, 8))
    assert pb == want, f"compiled {pb} B != analytic {want} B"
    assert ar == 0  # pure fluid: no force psum


@pytest.mark.slow  # two sharded lowerings
def test_ici_witness_full_table():
    """tools/halo_bytes.py --witness in-process: the fluid and coupled
    sharded steps' compiled collectives match the model."""
    from tools.halo_bytes import witness

    if len(jax.devices()) < 4:
        pytest.skip("need 4 devices")
    witness((2, 2))


def test_dryrun_multichip_four_devices():
    """The driver-facing dry run: the coupled sharded step on a
    4-device virtual mesh matches the unsharded step."""
    from __graft_entry__ import dryrun_multichip

    dryrun_multichip(4)
