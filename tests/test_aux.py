"""Aux subsystems (SURVEY.md SS5): checkpoint/resume identity, metrics
logging, VTK snapshot output, and the CLI end-to-end."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lbmdem.config import DiskSpec, SimConfig
from lbmdem.simulation import Simulation, make_step_fn
from lbmdem.utils import checkpoint as ckpt
from lbmdem.utils.io_vtk import write_fluid_vtk, write_particles_vtk
from lbmdem.utils.metrics import MetricsLogger, compute_diagnostics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli_env():
    """Environment for a CLI subprocess: CPU, this checkout importable."""
    return dict(os.environ, JAX_PLATFORMS="cpu",
                PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))


def _cfg(**kw):
    base = dict(nx=32, ny=48, tau=0.8, dtype="float64", g_py=-1e-4,
                rho_s=2.0, kn=0.5, gamma_n=0.5, n_sub=5,
                bc_west="wall", bc_east="wall")
    base.update(kw)
    return SimConfig(**base)


def test_checkpoint_resume_identical_trajectory(tmp_path):
    cfg = _cfg()
    disks = [DiskSpec(16.2, 40.0, 3.0)]
    sim = Simulation(cfg, disks)
    step = jax.jit(make_step_fn(sim.cfg, sim.grid, False))

    s = sim.state
    for _ in range(10):
        s = step(s)
    path = str(tmp_path / "ckpt.npz")
    ckpt.save_state(path, s, cfg)

    # continue 10 more steps from the live state
    s_cont = s
    for _ in range(10):
        s_cont = step(s_cont)

    # resume from disk and run the same 10 steps
    s_res = ckpt.load_state(path, sim.state)
    assert int(s_res.step) == 10
    for _ in range(10):
        s_res = step(s_res)

    np.testing.assert_array_equal(np.asarray(s_cont.f), np.asarray(s_res.f))
    np.testing.assert_array_equal(np.asarray(s_cont.disks.x), np.asarray(s_res.disks.x))
    np.testing.assert_array_equal(np.asarray(s_cont.disks.v), np.asarray(s_res.disks.v))


def test_checkpoint_resharding_roundtrip(tmp_path):
    """The checkpoint.py claim 'resumable into a differently-sharded
    run' (SURVEY SS5.4), tested in every direction: a single-chip
    checkpoint restored into (2,2)- and (1,8)-mesh runs, a mesh
    checkpoint restored into a (2,4) mesh of a different shape, and a
    mesh checkpoint restored single-chip - all continuing the exact
    trajectory of the uninterrupted single-chip run (the XLA sharded
    step is bitwise on f and disk x; disk v absorbs the force-psum's
    reduction-order ulp, so it gets a ~1e-11-relative tolerance)."""
    from lbmdem.parallel import make_mesh, make_sharded_step, shard_state

    if len(jax.devices()) < 8:
        pytest.skip("need 8 devices")
    cfg = _cfg()
    disks = [DiskSpec(16.2, 40.0, 3.0)]
    sim = Simulation(cfg, disks)
    step1 = jax.jit(make_step_fn(sim.cfg, sim.grid, False))
    s = sim.state
    for _ in range(6):
        s = step1(s)
    path = str(tmp_path / "ckpt.npz")
    ckpt.save_state(path, s, cfg)
    for _ in range(6):
        s = step1(s)
    ref = s  # uninterrupted single-chip trajectory at step 12

    def run_mesh(shape, src_path):
        mesh = make_mesh(jax.devices()[: shape[0] * shape[1]], shape)
        tpl = shard_state(sim.state, mesh)
        st = ckpt.load_state(src_path, tpl)
        # the restore really landed the template's mesh layout
        assert st.f.sharding == tpl.f.sharding and st.f.committed
        stepm = jax.jit(make_sharded_step(sim.cfg, sim.grid, mesh))
        for _ in range(6):
            st = stepm(st)
        return st

    for shape in ((2, 2), (1, 8)):
        st = run_mesh(shape, path)
        np.testing.assert_array_equal(np.asarray(ref.f), np.asarray(st.f))
        np.testing.assert_array_equal(np.asarray(ref.disks.x),
                                      np.asarray(st.disks.x))
        np.testing.assert_allclose(np.asarray(ref.disks.v),
                                   np.asarray(st.disks.v),
                                   rtol=1e-11, atol=1e-20)

    # mesh -> differently-shaped mesh: re-save from the (1,8) run's
    # checkpoint point and continue on (2,4)
    mesh18 = make_mesh(jax.devices()[:8], (1, 8))
    st18 = ckpt.load_state(path, shard_state(sim.state, mesh18))
    path2 = str(tmp_path / "ckpt_mesh.npz")
    ckpt.save_state(path2, st18, cfg)  # save from SHARDED state
    st24 = run_mesh((2, 4), path2)
    np.testing.assert_array_equal(np.asarray(ref.f), np.asarray(st24.f))

    # mesh checkpoint -> single-chip resume
    s1 = ckpt.load_state(path2, sim.state)
    for _ in range(6):
        s1 = step1(s1)
    np.testing.assert_array_equal(np.asarray(ref.f), np.asarray(s1.f))
    np.testing.assert_array_equal(np.asarray(ref.disks.x),
                                  np.asarray(s1.disks.x))


def test_cli_restore_into_mesh(tmp_path):
    """cli.py --restore + --mesh: a single-chip checkpoint resumes into
    a mesh run end-to-end through the CLI (VERDICT r3 missing #2)."""
    cfg = _cfg(steps=4, out_interval=4)
    sim = Simulation(cfg, [DiskSpec(16.2, 40.0, 3.0)])
    for _ in range(4):
        sim.step()
    path = str(tmp_path / "ckpt.npz")
    ckpt.save_state(path, sim.state, cfg)
    deck = tmp_path / "deck.txt"
    deck.write_text(
        "nx 32\nny 48\ntau 0.8\ng_py -1e-4\nrho_s 2.0\nkn 0.5\n"
        "gamma_n 0.5\nn_sub 5\ndtype float64\nsteps 4\nout_interval 4\n"
        "bc west wall\nbc east wall\nmax_disks 1\nparticles disks.txt\n"
    )
    (tmp_path / "disks.txt").write_text("16.2 40.0 3.0\n")
    # the subprocess runs on the simulated CPU mesh
    env = dict(_cli_env(),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run(
        [sys.executable, "-m", "lbmdem.cli", str(deck),
         "--restore", path, "--mesh", "2x2",
         "--out", str(tmp_path / "out")],
        capture_output=True, text=True, timeout=600, cwd=REPO, env=env,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert "restored from" in r.stdout


def test_checkpoint_bf16_storage_roundtrips_exact(tmp_path):
    """bf16 f-storage widens to f32 in the .npz (numpy has no bf16) and
    casts back on load - bitwise roundtrip of the stored g values."""
    cfg = _cfg(max_disks=0, f_storage="bfloat16", dtype="float32")
    sim = Simulation(cfg)
    step = jax.jit(make_step_fn(sim.cfg, None))
    s = sim.state
    for _ in range(5):
        s = step(s)
    assert s.f.dtype == jnp.bfloat16
    path = str(tmp_path / "b.npz")
    ckpt.save_state(path, s, cfg)
    s_res = ckpt.load_state(path, sim.state)
    assert s_res.f.dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(s.f, np.float32),
                                  np.asarray(s_res.f, np.float32))


def test_checkpoint_storage_change_rejected(tmp_path):
    """Resuming a float32-storage checkpoint into a bf16-storage run
    would silently reinterpret physical f as shifted g - load_state
    must refuse dtype changes (it only undoes its own bf16 widening)."""
    cfg = _cfg(max_disks=0, dtype="float32")
    sim = Simulation(cfg)
    path = str(tmp_path / "s.npz")
    ckpt.save_state(path, sim.state, cfg)
    other = Simulation(_cfg(max_disks=0, dtype="float32",
                            f_storage="bfloat16"))
    try:
        ckpt.load_state(path, other.state)
        assert False, "expected dtype mismatch"
    except AssertionError as e:
        assert "dtype" in str(e)


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    cfg = _cfg()
    sim = Simulation(cfg, [DiskSpec(16.2, 40.0, 3.0)])
    path = str(tmp_path / "c.npz")
    ckpt.save_state(path, sim.state)
    other = Simulation(_cfg(nx=64), [DiskSpec(16.2, 40.0, 3.0)])
    try:
        ckpt.load_state(path, other.state)
        assert False, "expected shape mismatch"
    except AssertionError as e:
        assert "shape" in str(e)


def test_metrics_logger(tmp_path):
    cfg = _cfg()
    sim = Simulation(cfg, [DiskSpec(16.2, 40.0, 3.0)])
    logger = MetricsLogger(str(tmp_path / "m.csv"), str(tmp_path / "m.jsonl"))
    row = logger.log(sim)
    assert abs(row["mass"] - cfg.nx * cfg.ny) < 1e-6
    assert row["nan"] == 0
    sim.run(5)
    row2 = logger.log(sim)
    assert row2["step"] == 5
    assert row2["mlups"] > 0
    lines = open(tmp_path / "m.csv").read().strip().splitlines()
    assert len(lines) == 3  # header + 2 rows
    import json
    assert json.loads(open(tmp_path / "m.jsonl").read().splitlines()[1])["step"] == 5


def test_vtk_output(tmp_path):
    cfg = _cfg()
    sim = Simulation(cfg, [DiskSpec(16.2, 40.0, 3.0)])
    rho, ux, uy = sim.macroscopic()
    p1 = str(tmp_path / "f.vtk")
    write_fluid_vtk(p1, rho, ux, uy, sim.solid_fraction(), binary=True)
    head = open(p1, "rb").read(300).decode(errors="replace")
    assert "STRUCTURED_POINTS" in head and f"DIMENSIONS {cfg.nx} {cfg.ny} 1" in head
    assert os.path.getsize(p1) > cfg.nx * cfg.ny * 4 * 5  # rho + vel3 + eps

    p2 = str(tmp_path / "p.vtk")
    write_particles_vtk(p2, sim.disk_arrays())
    txt = open(p2).read()
    assert "POINTS 1 float" in txt and "radius" in txt and "velocity" in txt


def test_cli_end_to_end(tmp_path):
    (tmp_path / "run.par").write_text(
        "nx 32\nny 64\ntau 0.8\nsteps 20\nout_interval 10\n"
        "bc west wall\nbc east wall\nbc south wall\nbc north wall\n"
        "kn 0.5\ngamma_n 0.5\nrho_s 2.0\nn_sub 5\ng_py -1e-4\n"
        "particles d.txt\ndtype float64\n"
    )
    (tmp_path / "d.txt").write_text("16 50 3.0\n")
    out = subprocess.run(
        [sys.executable, "-m", "lbmdem.cli", str(tmp_path / "run.par"),
         "--out", str(tmp_path / "out"),
         "--checkpoint-every", "10", "--log-forces"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=_cli_env(),
    )
    assert out.returncode == 0, out.stderr
    assert "done: 20 steps" in out.stdout
    od = tmp_path / "out"
    assert (od / "metrics.csv").exists()
    assert (od / "trajectories.csv").exists()
    flog = (od / "forces.csv").read_text().splitlines()
    assert flog[0] == "step,id,fx,fy,torque"
    # settling disk: hydro drag opposes the fall (fy > 0), one row per dump
    assert len(flog) == 3 and float(flog[-1].split(",")[3]) > 0.0
    assert (od / "restart.npz").exists()
    assert (od / "fluid_00000010.vtk").exists()
    assert (od / "particles_00000020.vtk").exists()


def test_native_writer_matches_python(tmp_path):
    """C++ snapshot writer produces byte-identical VTK to the Python
    oracle (and the trajectory CSV parses identically)."""
    from lbmdem.utils import native
    from lbmdem.utils import io_vtk

    if native.get_lib() is None:
        import pytest
        pytest.skip("no native toolchain")
    rng = np.random.default_rng(0)
    rho = rng.standard_normal((24, 40)).astype(np.float32)
    ux = rng.standard_normal((24, 40)).astype(np.float32)
    uy = rng.standard_normal((24, 40)).astype(np.float32)
    eps = rng.random((24, 40)).astype(np.float32)
    p_native = str(tmp_path / "n.vtk")
    assert native.write_fluid_vtk(p_native, rho, ux, uy, eps)
    # force the python path by writing via the internal fallback
    import lbmdem.utils.native as nat
    orig = nat.write_fluid_vtk
    nat.write_fluid_vtk = lambda *a, **k: False
    try:
        p_py = str(tmp_path / "p.vtk")
        io_vtk.write_fluid_vtk(p_py, rho, ux, uy, eps, binary=True)
    finally:
        nat.write_fluid_vtk = orig
    assert open(p_native, "rb").read() == open(p_py, "rb").read()

    # trajectory CSV: native and python rows agree
    cfg = _cfg()
    sim = Simulation(cfg, [DiskSpec(16.25, 40.5, 3.0, vx=0.125)])
    d = sim.disk_arrays()
    from lbmdem.utils.io_vtk import append_particle_csv
    pn = str(tmp_path / "tn.csv")
    append_particle_csv(pn, 7, d)   # native (or fallback)
    rows = open(pn).read().splitlines()
    assert rows[0] == "step,id,x,y,vx,vy,theta,omega"
    vals = rows[1].split(",")
    assert vals[0] == "7" and float(vals[2]) == 16.25 and float(vals[4]) == 0.125


def test_profiling_timer_and_mlups():
    from lbmdem.utils import profiling
    import jax.numpy as jnp

    x = jnp.ones((64, 64))
    with profiling.Timer(sync=x * 2.0) as t:
        y = (x * 2.0).sum()
    assert t.seconds > 0
    assert profiling.mlups(1024, 1024, 100, 1.0) == 1024 * 1024 * 100 / 1e6


def test_unit_system_workflow():
    """Physical-units workflow: water in a 0.1 mm grid, tau from nu."""
    from lbmdem import units, lattice

    us = units.UnitSystem(dx=1e-4, dt=2e-6, rho0=1000.0)
    nu_lat = us.nu_to_lattice(1e-6)  # water
    tau = lattice.tau_from_nu(nu_lat)
    assert 0.5 < tau < 2.0
    g_lat = us.accel_to_lattice(9.81)
    assert 0 < g_lat < 1e-2
    # round trip a settling velocity
    v = us.velocity_from_lattice(0.01)
    assert abs(us.velocity_to_lattice(v) - 0.01) < 1e-15


def test_paranoid_mode_reports_failing_step():
    """SURVEY 5.2/5.3: a NaN injected mid-run is caught AT its step
    inside the jitted chunk (not at the next out_interval), the state
    freezes there, and run() raises with the step number."""
    import jax.numpy as jnp
    import pytest

    from lbmdem.config import SimConfig
    from lbmdem.simulation import Simulation, SimulationDiverged

    cfg = SimConfig(nx=32, ny=16, tau=0.8, gx=1e-5, paranoia=True,
                    out_interval=100)
    sim = Simulation(cfg)
    sim.run(3)
    assert int(sim.state.fail_step) == -1
    sim.state = sim.state._replace(
        f=sim.state.f.at[0, 5, 7].set(jnp.nan)
    )
    with pytest.raises(SimulationDiverged) as ei:
        sim.run(50)  # one 50-step chunk; must stop at step 4
    assert ei.value.step == 4
    assert int(sim.state.step) == 4  # frozen at the failing step


def test_paranoid_mode_coupled_and_clean():
    """Healthy coupled run: paranoia on, no false positives; and the
    coupled validation catches a NaN disk position."""
    import jax.numpy as jnp
    import pytest

    from lbmdem.config import DiskSpec, SimConfig
    from lbmdem.simulation import Simulation, SimulationDiverged

    cfg = SimConfig(nx=32, ny=32, tau=0.8, paranoia=True, g_py=-1e-4,
                    rho_s=2.0, kn=0.5, gamma_n=0.5, n_sub=5,
                    bc_west="wall", bc_east="wall", out_interval=100)
    sim = Simulation(cfg, [DiskSpec(16.0, 20.0, 3.0)])
    sim.run(5)
    assert int(sim.state.fail_step) == -1
    d = sim.state.disks
    sim.state = sim.state._replace(
        disks=d._replace(x=d.x.at[0, 1].set(jnp.nan))
    )
    with pytest.raises(SimulationDiverged):
        sim.run(10)


def test_async_writer_ordering_and_backpressure(tmp_path):
    """utils/async_io.AsyncWriter: FIFO ordering (trajectory appends
    depend on it), bounded-queue backpressure, clean drain on close."""
    import time

    from lbmdem.utils.async_io import AsyncWriter

    log = tmp_path / "order.txt"
    running = []

    def slow_append(tag):
        time.sleep(0.02)
        with open(log, "a") as fh:
            fh.write(f"{tag}\n")
        running.append(tag)

    w = AsyncWriter(max_pending=2)
    t0 = time.perf_counter()
    for i in range(8):
        w.submit(slow_append, i)
    submit_t = time.perf_counter() - t0
    # 8 x 20 ms of work through a 2-deep queue: submits must have
    # blocked (backpressure), not buffered everything instantly
    assert submit_t > 0.05
    w.close()
    assert log.read_text().splitlines() == [str(i) for i in range(8)]


def test_async_writer_error_surfaces():
    import pytest

    from lbmdem.utils.async_io import AsyncWriter

    w = AsyncWriter(max_pending=1)

    def boom():
        raise OSError("disk full")

    w.submit(boom)
    with pytest.raises(RuntimeError, match="snapshot write failed"):
        # the failure surfaces on a later submit or at close
        for _ in range(4):
            w.submit(lambda: None)
        w.close()


@pytest.mark.slow  # two CLI subprocesses (~22 s); the async-writer
# units above and test_cli_end_to_end keep quick-lane coverage
def test_cli_async_matches_sync_io(tmp_path):
    """--sync-io and the default async pipeline must produce byte-
    identical outputs (same frames, same trajectory CSV order)."""
    (tmp_path / "run.par").write_text(
        "nx 32\nny 64\ntau 0.8\nsteps 20\nout_interval 10\n"
        "bc west wall\nbc east wall\nbc south wall\nbc north wall\n"
        "kn 0.5\ngamma_n 0.5\nrho_s 2.0\nn_sub 5\ng_py -1e-4\n"
        "particles d.txt\ndtype float64\n"
    )
    (tmp_path / "d.txt").write_text("16 50 3.0\n")
    outs = {}
    for mode, extra in (("async", []), ("sync", ["--sync-io"])):
        r = subprocess.run(
            [sys.executable, "-m", "lbmdem.cli",
             str(tmp_path / "run.par"),
             "--out", str(tmp_path / mode)] + extra,
            capture_output=True, text=True, timeout=300, cwd=REPO,
            env=_cli_env(),
        )
        assert r.returncode == 0, r.stderr
        outs[mode] = tmp_path / mode
    for name in ("fluid_00000020.vtk", "particles_00000020.vtk",
                 "trajectories.csv"):
        a = (outs["async"] / name).read_bytes()
        b = (outs["sync"] / name).read_bytes()
        assert a == b, f"{name} differs between async and sync I/O"
