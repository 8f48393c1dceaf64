"""Periodic DEM: minimum-image contacts, ghost-disk stamping, wrap.

The reference rejects nothing here (SURVEY.md SS2 C13/C15 is silent on
periodicity), but periodic sedimentation channels are a standard
LBM-DEM configuration; round-1 VERDICT asked for wrap-or-reject and
this implements wrap: contacts use minimum-image displacements over a
wrapped cell adjacency (ops/dem.py), while the coupling paths stamp
min-image ghost copies of near-seam disks and fold their hydro forces
back into the parents (ops/imb.py ghost helpers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lbmdem.config import DiskSpec, SimConfig, window_for_radius
from lbmdem.ops import dem, imb
from lbmdem.ops.dem import DemGrid, DiskState
from lbmdem.simulation import Simulation, make_step_fn


def _disk_state(cfg, rows, dtype=jnp.float64):
    """rows: list of (x, y, r, vx, vy, omega)."""
    specs = [DiskSpec(x, y, r, vx, vy, om) for x, y, r, vx, vy, om in rows]
    return dem.make_disk_state(specs, cfg, dtype=dtype)


def _pcfg(nx=64, ny=48, r=2.5, **kw):
    base = dict(nx=nx, ny=ny, tau=0.8, dtype="float64",
                window=window_for_radius(r), max_disks=4, ghost_cap=8,
                kn=0.5, gamma_n=0.2, n_sub=4,
                bc_west="periodic", bc_east="periodic",
                bc_south="wall", bc_north="wall")
    base.update(kw)
    return SimConfig(**base)


def test_pair_force_across_seam_matches_center_pair():
    """An overlapping pair straddling the x seam must feel exactly the
    force of the same pair at the domain center (minimum image)."""
    cfg = _pcfg()
    grid = DemGrid.build(cfg, 2.5)
    L = cfg.nx
    # overlap depth 0.5 across the seam: gap centers 4.5 apart, r+r=5
    seam = _disk_state(cfg, [(L - 2.0, 24.0, 2.5, 0.01, 0.0, 0.0),
                             (2.5 - L + L, 24.0, 2.5, -0.01, 0.0, 0.0)])
    center = _disk_state(cfg, [(30.0, 24.0, 2.5, 0.01, 0.0, 0.0),
                               (34.5, 24.0, 2.5, -0.01, 0.0, 0.0)])
    table_s, ovf_s = dem.build_cell_table(seam.x, seam.active, grid)
    table_c, _ = dem.build_cell_table(center.x, center.active, grid)
    Fs, Ts, ncs = dem.contact_forces(seam, table_s, grid, cfg)
    Fc, Tc, ncc = dem.contact_forces(center, table_c, grid, cfg)
    assert int(ncs) == 1 and int(ncc) == 1
    np.testing.assert_allclose(np.asarray(Fs), np.asarray(Fc),
                               rtol=0, atol=1e-12)
    # Newton's third law through the seam
    np.testing.assert_allclose(np.asarray(Fs[0] + Fs[1]),
                               np.zeros(2), atol=1e-14)


def test_wrapped_candidates_found_in_edge_cells():
    """Two disks in the first/last DEM cells must see each other as
    candidates through the wrapped 3x3 patch."""
    cfg = _pcfg()
    grid = DemGrid.build(cfg, 2.5)
    st = _disk_state(cfg, [(0.5, 24.0, 2.5, 0, 0, 0),
                           (cfg.nx - 1.5, 24.0, 2.5, 0, 0, 0)])
    table, _ = dem.build_cell_table(st.x, st.active, grid)
    cand = dem.candidate_list(st, table, grid)
    assert 1 in np.asarray(cand[0])
    assert 0 in np.asarray(cand[1])


def test_stamp_area_conserved_across_seam():
    """Ghost stamping: total coverage equals the disk area no matter
    where the disk sits relative to the seam."""
    cfg = _pcfg(max_disks=1, eps_samples=8)
    sh = cfg.nx // 2

    def area_at(x0):
        st = _disk_state(cfg, [(x0, 24.0, 2.5, 0, 0, 0)])
        p, a, ovf = imb.ghost_selection(st.x, st.active, cfg)
        assert int(ovf) == 0
        xa, va, oma, ra, acta = imb.apply_ghosts(
            p, a, st.x, st.v, st.omega, st.r, st.active, cfg
        )
        eps, _, _ = imb.stamp_solid_fraction(xa, va, oma, ra, acta, cfg)
        return float(jnp.sum(eps))

    for x0 in (0.2, cfg.nx - 0.7, cfg.nx - 2.9):
        a_seam = area_at(x0)
        # same subcell alignment shifted into the bulk by an integer:
        # sampling quantization cancels, so the split stamp must match
        # the unsplit one to roundoff
        a_bulk = area_at((x0 + sh) % cfg.nx)
        np.testing.assert_allclose(a_seam, a_bulk, rtol=1e-12)
        np.testing.assert_allclose(a_seam, np.pi * 2.5**2, rtol=1e-2)


@pytest.mark.slow  # oracle-only physics invariance (no kernel parity);
# the seam force/stamp tests are the quick periodic representatives
def test_oracle_trajectory_translation_invariant():
    """The strong invariance test: shifting the whole scene by nx/2
    along the periodic axis must shift the trajectory and nothing else
    - including while a disk crosses the wrap seam."""
    cfg = _pcfg(ny=40)
    L = cfg.nx
    sh = L // 2
    rows = [
        # starts 0.2 cells from the wrap threshold moving east:
        # crosses the seam mid-run
        (L - 0.7, 20.0, 2.5, 0.08, 0.0, 0.0),
        # near-seam neighbor at a different height (grazing contact)
        (3.6, 25.2, 2.5, -0.02, 0.0, 0.01),
        # bystander in the bulk
        (20.0, 28.0, 2.0, 0.0, -0.01, 0.0),
    ]
    rows_shifted = [((x + sh) % L, y, r, vx, vy, om)
                    for x, y, r, vx, vy, om in rows]
    sims = []
    for rr in (rows, rows_shifted):
        sim = Simulation(cfg, [DiskSpec(*r) for r in rr])
        sim.run(60)
        sims.append(sim)
    a, b = sims[0].state.disks, sims[1].state.disks
    n = len(rows)
    dx = (np.asarray(b.x[:n, 0]) - np.asarray(a.x[:n, 0]) - sh) % L
    dx = np.minimum(dx, L - dx)  # distance to 0 mod L
    np.testing.assert_allclose(dx, 0.0, atol=1e-9)
    np.testing.assert_allclose(np.asarray(a.x[:n, 1]),
                               np.asarray(b.x[:n, 1]), atol=1e-9)
    np.testing.assert_allclose(np.asarray(a.v[:n]), np.asarray(b.v[:n]),
                               atol=1e-9)
    np.testing.assert_allclose(np.asarray(a.omega[:n]),
                               np.asarray(b.omega[:n]), atol=1e-9)
    # the crossing actually happened and got wrapped back in-domain
    assert int(sims[0].state.overflow) == 0
    x_final = float(a.x[0, 0])
    assert -0.5 <= x_final < L - 0.5
    assert x_final < 10.0  # crossed the seam and wrapped to the west


def test_sharded_periodic_coupled_matches():
    """Sharded XLA path with a disk straddling the periodic seam (which
    is also the x shard boundary of the ('y','x') mesh)."""
    from lbmdem.parallel import make_mesh, make_sharded_step, shard_state

    devs = jax.devices()[:4]
    if len(devs) < 4:
        pytest.skip("need 4 devices")
    mesh = make_mesh(devs, (2, 2))
    cfg = _pcfg(nx=64, ny=48, g_py=-5e-5)
    disks = [DiskSpec(63.0, 24.0, 2.5, vx=0.02),
             DiskSpec(3.0, 23.5, 2.5),
             DiskSpec(30.0, 30.0, 2.0)]
    sim = Simulation(cfg, disks)
    step_ref = jax.jit(make_step_fn(sim.cfg, sim.grid))
    step_sh = jax.jit(make_sharded_step(sim.cfg, sim.grid, mesh))
    s_ref = sim.state
    s_sh = shard_state(sim.state, mesh)
    for _ in range(4):
        s_ref = step_ref(s_ref)
        s_sh = step_sh(s_sh)
    np.testing.assert_allclose(np.asarray(s_ref.f), np.asarray(s_sh.f),
                               rtol=0, atol=1e-14)
    np.testing.assert_allclose(np.asarray(s_ref.disks.x),
                               np.asarray(s_sh.disks.x), rtol=0, atol=1e-14)
    np.testing.assert_allclose(np.asarray(s_ref.disks.v),
                               np.asarray(s_sh.disks.v), rtol=0, atol=1e-14)


def test_small_periodic_domain_rejected():
    cfg = _pcfg(nx=32, r=4.0, window=window_for_radius(4.0))
    with pytest.raises(ValueError, match="too small"):
        Simulation(cfg, [DiskSpec(16.0, 24.0, 4.0)])
