"""Parameter / particle file parsing (C18/C19)."""

import numpy as np
import pytest

from lbmdem.config import (
    SimConfig, load_param_file, load_particle_file, save_particle_file,
    window_for_radius,
)


def test_param_roundtrip(tmp_path):
    p = tmp_path / "run.par"
    p.write_text(
        """
        # channel with particles
        nx 128
        ny 64
        nu 0.1333333333333333
        gx 1e-6
        steps 1000
        out_interval 100
        bc west periodic
        bc east periodic
        bc south wall
        bc north wall
        kn 1.0
        gamma_n 0.1
        mu 0.3
        rho_s 2.5
        n_sub 20
        particles disks.txt
        dtype float64
        """
    )
    (tmp_path / "disks.txt").write_text("10 20 3.0\n30.5 20 3.0 0.1 -0.1 0.02\n")
    cfg, pf = load_param_file(str(p))
    assert (cfg.nx, cfg.ny) == (128, 64)
    assert abs(cfg.tau - 0.9) < 1e-12
    assert cfg.bc_south == "wall" and cfg.bc_west == "periodic"
    assert cfg.n_sub == 20 and cfg.rho_s == 2.5
    disks = load_particle_file(pf)
    assert len(disks) == 2
    assert disks[1].vx == 0.1 and disks[1].omega == 0.02


def test_particle_save_load(tmp_path):
    from lbmdem.config import DiskSpec
    disks = [DiskSpec(1, 2, 0.5, 0.1, 0.2, 0.3)]
    path = str(tmp_path / "d.txt")
    save_particle_file(path, disks)
    assert load_particle_file(path) == disks


def test_config_validation():
    with pytest.raises(ValueError):
        SimConfig(nx=4, ny=4, tau=0.4)
    with pytest.raises(ValueError):
        SimConfig(nx=4, ny=4, bc_west="periodic", bc_east="wall")
    with pytest.raises(ValueError):
        SimConfig(nx=4, ny=4, bc_south="slippery")


def test_f_storage_validation():
    with pytest.raises(ValueError, match="f_storage"):
        SimConfig(nx=4, ny=4, f_storage="fp8")
    with pytest.raises(ValueError, match="float32"):
        SimConfig(nx=4, ny=4, f_storage="bfloat16", dtype="float64")
    # bf16 storage has no lattice-shape gate: any ny steps
    import jax.numpy as jnp

    from lbmdem.simulation import Simulation

    sim = Simulation(SimConfig(nx=40, ny=24, f_storage="bfloat16"))
    sim.step()
    assert sim.state.f.dtype == jnp.bfloat16


def test_window_covers_disk():
    for r in (0.8, 1.5, 3.2, 7.9):
        w = window_for_radius(r)
        # the window half-width must exceed r + sample slack
        assert w // 2 >= r + 0.5
        assert w % 2 == 1


def test_dem_periodic_geometry_validated():
    # disks + periodic sides are supported (minimum-image contacts +
    # ghost stamping, tests/test_periodic.py), but the wrapped extent
    # must dominate the stamp window or the nearest image is ambiguous
    cfg = SimConfig(nx=8, ny=8, max_disks=2, window=9)
    with pytest.raises(ValueError, match="too small"):
        cfg.validate_periodic_dem()
    SimConfig(nx=64, ny=8, max_disks=2, window=9).validate_periodic_dem()
    # wall-only geometry never trips it
    SimConfig(nx=8, ny=8, max_disks=2, window=9, bc_west="wall",
              bc_east="wall", bc_south="wall",
              bc_north="wall").validate_periodic_dem()


def _write_si_deck(tmp_path):
    """An SI deck and its hand-converted lattice-unit twin.

    Scales: dx=1e-3 m, dt=1e-4 s, rho=1000 kg/m^3 =>
    stiffness_scale = rho dx^3/dt^2 = 100 N/m per lattice unit,
    damping_scale = rho dx^3/dt = 1e-2 N s/m per lattice unit,
    accel_scale = dx/dt^2 = 1e5 m/s^2.
    """
    import textwrap

    si = tmp_path / "si.par"
    si.write_text(textwrap.dedent("""
        nx 64
        ny 32
        dx 1e-3
        dt_phys 1e-4
        rho_phys 1000.0
        nu_phys 2e-4        # -> nu_lat=0.02, tau=0.56
        g_py_phys -9.81     # m/s^2
        rho_s_phys 2500.0   # -> rho_s 2.5
        kn_phys 10.0        # N/m
        gamma_n_phys 1e-2   # N s/m
        t_end_phys 0.05     # -> 500 steps
        bc west wall
        bc east wall
        n_sub 5
        particles si_disks.txt
    """))
    # same disk at x=16e-3 m = 16 lat, r=2e-3 m = 2 lat, vy=-0.1 m/s=-0.01 lat
    (tmp_path / "si_disks.txt").write_text("16e-3 24e-3 2e-3 0 -1.0 5.0\n")
    lat = tmp_path / "lat.par"
    lat.write_text(textwrap.dedent("""
        nx 64
        ny 32
        nu 0.02
        g_py -9.81e-5
        rho_s 2.5
        kn 0.1
        gamma_n 1.0
        steps 500
        bc west wall
        bc east wall
        n_sub 5
        particles lat_disks.txt
    """))
    (tmp_path / "lat_disks.txt").write_text("16 24 2 0 -0.1 5e-4\n")
    return si, lat


def test_si_deck_matches_lattice_deck(tmp_path):
    """SURVEY C17/C18: a deck written in SI reproduces the lattice deck's
    trajectory exactly (same lattice-unit parameters after conversion)."""
    import numpy as np

    from lbmdem.simulation import Simulation

    si, lat = _write_si_deck(tmp_path)
    cfg_si, pf_si = load_param_file(str(si))
    cfg_lat, pf_lat = load_param_file(str(lat))
    assert cfg_si.units is not None and cfg_lat.units is None
    for fld in ("tau", "g_py", "rho_s", "kn", "gamma_n", "steps"):
        np.testing.assert_allclose(
            getattr(cfg_si, fld), getattr(cfg_lat, fld), rtol=1e-12,
            err_msg=fld,
        )
    d_si = load_particle_file(pf_si, units=cfg_si.units)
    d_lat = load_particle_file(pf_lat)
    np.testing.assert_allclose(
        [d_si[0].x, d_si[0].y, d_si[0].r, d_si[0].vy, d_si[0].omega],
        [d_lat[0].x, d_lat[0].y, d_lat[0].r, d_lat[0].vy, d_lat[0].omega],
        rtol=1e-12,
    )
    # identical lattice-unit inputs => identical trajectories (20 steps
    # suffice: the converted parameters feed every term from step 1)
    s1 = Simulation(cfg_si.replace(steps=20), d_si)
    s2 = Simulation(cfg_lat.replace(steps=20), d_lat)
    s1.run(20)
    s2.run(20)
    np.testing.assert_allclose(
        np.asarray(s1.state.disks.x), np.asarray(s2.state.disks.x),
        rtol=0, atol=1e-12,
    )


def test_si_deck_requires_base_scales(tmp_path):
    p = tmp_path / "bad.par"
    p.write_text("nx 8\nny 8\nnu_phys 1e-6\n")
    with pytest.raises(ValueError, match="base scales"):
        load_param_file(str(p))


def test_periodic_pairing_bidirectional():
    # a lone periodic EAST side used to slip through (the check keyed
    # only off bc_west): fluid would wrap against a wall side and disks
    # would get neither wall forces nor wrap on that axis
    with pytest.raises(ValueError, match="pair"):
        SimConfig(nx=16, ny=16, bc_west="wall", bc_east="periodic")
    with pytest.raises(ValueError, match="pair"):
        SimConfig(nx=16, ny=16, bc_south="periodic", bc_north="wall",
                  bc_west="wall", bc_east="wall")


def test_si_open_boundary_keywords(tmp_path):
    """u_inlet_phys / rho_outlet_phys convert through the unit system,
    and SI particle files carry the fixed/rho_s columns."""
    import textwrap

    si = tmp_path / "si_open.par"
    si.write_text(textwrap.dedent("""
        nx 64
        ny 32
        dx 1e-3
        dt_phys 1e-4
        rho_phys 1000.0
        nu_phys 2e-4
        u_inlet_phys 0.5      # m/s -> 0.05 lattice (vel scale 10 m/s)
        rho_outlet_phys 1100  # kg/m^3 -> 1.1 lattice
        inlet_profile poiseuille
        bc west inlet
        bc east outlet
        particles si_open_disks.txt
    """))
    # fixed dense obstacle: r=2e-3 m, rho_s 2500 kg/m^3
    (tmp_path / "si_open_disks.txt").write_text(
        "16e-3 16e-3 2e-3 0 0 0 1 2500\n"
    )
    cfg, pf = load_param_file(str(si))
    assert cfg.bc_west == "inlet" and cfg.bc_east == "outlet"
    np.testing.assert_allclose(cfg.u_inlet, 0.05, rtol=1e-12)
    np.testing.assert_allclose(cfg.rho_outlet, 1.1, rtol=1e-12)
    d = load_particle_file(pf, units=cfg.units)[0]
    assert d.fixed
    np.testing.assert_allclose(d.r, 2.0, rtol=1e-12)
    np.testing.assert_allclose(d.rho_s, 2.5, rtol=1e-12)


def test_eps_method_deck_keyword(tmp_path):
    """eps_method is deck-settable (sample = reference parity default;
    ramp = speed tier, exact = accuracy tier - tools/ab_eps.py)."""
    import pytest

    p = tmp_path / "run.par"
    base = "nx 32\nny 32\ntau 0.8\nsteps 10\nout_interval 10\n"
    p.write_text(base + "eps_method ramp\n")
    cfg, _ = load_param_file(str(p))
    assert cfg.eps_method == "ramp"
    p.write_text(base + "eps_method voxel\n")
    with pytest.raises(ValueError, match="eps_method"):
        load_param_file(str(p))


@pytest.mark.parametrize("line", [
    "coupling_k 4", "tile_cap 32", "paranoia chunk", "paranoia step",
])
def test_removed_deck_keywords_raise(tmp_path, line):
    """Keywords of the removed fused-kernel paths fail with a named
    ValueError instead of running some other configuration."""
    p = tmp_path / "run.par"
    p.write_text("nx 32\nny 32\ntau 0.8\n" + line + "\n")
    with pytest.raises(ValueError, match="removed|paranoia"):
        load_param_file(str(p))


def test_nt_mode_deck_keyword(tmp_path):
    """nt_mode is deck-settable (nt = published NT blend default;
    lambda = the TRT/Lambda-consistent experiment - refuted on 2D-1
    drag but kept as a measured verdict, docs/performance.md)."""
    import pytest

    p = tmp_path / "run.par"
    base = "nx 32\nny 32\ntau 0.8\nsteps 10\nout_interval 10\n"
    p.write_text(base + "nt_mode lambda\n")
    cfg, _ = load_param_file(str(p))
    assert cfg.nt_mode == "lambda"
    p.write_text(base + "nt_mode bogus\n")
    with pytest.raises(ValueError, match="nt_mode"):
        load_param_file(str(p))
