"""Physics validation on the device: the float32 path vs the pinned
float64 goldens and published anchors.

Settling-velocity parity is THE parity metric (BASELINE.json; the C
reference is unavailable, so the f64 trajectory is the pinned ground
truth - SURVEY SS0/SS4). The CPU test suite checks the same physics at
small sizes; this tool runs the legs on the accelerator through
Simulation.run and holds each to its stated tolerance.

Run from the repository root:
    python -m tools.validate                  # settling, dkt, periodic,
                                              # cavity, trt, cylinder,
                                              # shedding
    python -m tools.validate settling dkt     # selected legs
"""

import os

import numpy as np


def _golden(name):
    return np.loadtxt(
        os.path.join(os.path.dirname(__file__), "..", "tests", "golden",
                     name),
        delimiter=",", skiprows=1,
    )


def _trajectory(sim, n_rows):
    """Run n_rows output intervals through Simulation.run, recording
    (y, vy) of every disk at each one."""
    rows = []

    def record(s):
        d = s.disk_arrays()
        rows.append(np.stack([d["x"][:, 1], d["v"][:, 1]], axis=1))

    sim.run(n_rows * sim.cfg.out_interval, callback=record)
    return np.asarray(rows)  # (n_rows, n_disks, 2)


def settling_parity() -> float:
    """Single-disk settling vs the repo's f64 golden (the SURVEY's
    headline parity metric): the largest instantaneous-velocity error
    over the back half (acceleration + near-terminal), as a fraction of
    the golden's velocity scale. Must stay under 1%."""
    import jax

    from lbmdem.config import DiskSpec, SimConfig
    from lbmdem.simulation import Simulation

    golden = _golden("settling_r5_nx128_f64.csv")
    # the golden holds one row per 100 steps
    cfg = SimConfig(nx=128, ny=192, tau=0.65, dtype="float32", g_py=-2e-5,
                    rho_s=1.5, kn=0.5, gamma_n=1.0, n_sub=10, buoyancy=True,
                    bc_west="wall", bc_east="wall", out_interval=100)
    sim = Simulation(cfg, [DiskSpec(64.3, 150.0, 5.0)])
    rows = _trajectory(sim, golden.shape[0])[:, 0, :]
    half = len(rows) // 2
    vy_t = rows[half:, 1]
    vy_g = golden[half:, 4]
    err = float(np.abs(vy_t - vy_g).max() / np.abs(vy_g).max())
    print(f"settling ({jax.devices()[0].platform}): vy {vy_t[-1]:.6e} vs "
          f"golden {vy_g[-1]:.6e}; max |dv|/scale over back half "
          f"{err:.4%}; final y {rows[-1, 0]:.4f} vs golden "
          f"{golden[-1, 2]:.4f}")
    assert err < 0.01, f"settling-velocity parity {err:.4%} exceeds 1%"
    return err


def _dkt():
    """DKT vs the f64 golden: quantitative early-phase trajectory
    (pre-kissing; the post-tumble phase is chaotic) + the qualitative
    drafting signature over the full run."""
    from lbmdem.config import DiskSpec, SimConfig
    from lbmdem.simulation import Simulation

    golden = _golden("dkt_nx128_f64.csv")
    cfg = SimConfig(nx=128, ny=256, tau=0.56, dtype="float32", g_py=-1e-4,
                    rho_s=2.0, kn=1.0, gamma_n=1.0, mu=0.1, n_sub=10,
                    buoyancy=True, bc_west="wall", bc_east="wall",
                    out_interval=100)
    disks = [DiskSpec(64.2, 220.0, 5.0), DiskSpec(63.8, 204.0, 5.0)]
    rows = _trajectory(Simulation(cfg, disks), golden.shape[0])[:, :, 0]
    # early phase (first half): y-trajectories within 2% of a radius
    half = len(rows) // 2
    err = np.abs(rows[:half] - golden[:half, [2, 4]]).max()
    print(f"DKT early-phase max |dy|: {err:.4f} cells (budget 0.1)")
    assert err < 0.1, f"DKT early trajectory diverged: {err}"
    # full-run drafting signature
    gap0 = 16.0
    gap1 = rows[-1, 0] - rows[-1, 1]
    print(f"DKT drafting: gap {gap0} -> {gap1:.2f} "
          f"(golden {golden[-1, 2] - golden[-1, 4]:.2f})")
    assert gap1 < gap0 - 3.0, "no drafting"
    print("DKT OK")


def _dkt_literature():
    """DKT at the PUBLISHED configuration (tools/dkt_study.py:
    Feng-Hu-Joseph lineage 2x8 cm channel, d=0.2 cm, rho_s/rho_f=1.01) -
    kissing time, drafting ratio and tumbling asserted against
    literature numbers, not repo goldens. CPU f64/f32 calibration:
    t_kiss=1.505 s, draft ratio 1.139."""
    from tools.dkt_study import PIN_NX128, check_literature, run_study

    m = run_study(nx=128, dtype="float32", sample_every=50)
    # outer literature window + recorded-value pin (1.505 s +-15%,
    # ratio 1.139 +-10%): a 2x kissing-time regression cannot hide
    # inside the [0.8, 3.5] s cross-method window
    check_literature(m, pin=PIN_NX128)
    print(f"DKT literature: t_kiss={m['t_kiss_s']:.3f} s, draft ratio "
          f"{m['draft_ratio']:.3f}, post-kiss |dx| "
          f"{m['max_dx_post_kiss_cm']:.3f} cm")
    print("DKT-LITERATURE OK")


def _cavity():
    """Lid-driven cavity at Re=100 (moving-wall bounce-back) vs the
    Ghia, Ghia & Shin (1982) benchmark extrema.

    External ground truth (the only one available to this repo - the C
    reference publishes no fields): the centerline velocity extrema of
    the steady Re=100 cavity, u_min = -0.2109 on the vertical
    centerline, v_max = 0.1753 / v_min = -0.2453 on the horizontal
    centerline (normalized by lid speed). A 128^2 D2Q9 BGK solution
    with half-way bounce-back should land within a few % of the
    spectral values; budget 4%."""
    import jax.numpy as jnp

    from lbmdem.config import SimConfig
    from lbmdem.ops import lbm
    from lbmdem.simulation import Simulation

    n, u_lid = 128, 0.1
    nu = u_lid * n / 100.0  # Re = U L / nu = 100
    cfg = SimConfig(nx=n, ny=n, tau=3.0 * nu + 0.5, dtype="float32",
                    bc_west="wall", bc_east="wall", uw_north=u_lid,
                    out_interval=5000)
    sim = Simulation(cfg, [])
    prev = None
    for i in range(40):  # up to 200k steps; diffusive time ~ L^2/nu = 128k
        sim.run(5000)
        s = sim.state
        _, ux, uy = lbm.moments(lbm.from_storage(s.f, sim.cfg))
        ux, uy = np.asarray(ux), np.asarray(uy)
        if prev is not None:
            d = max(np.abs(ux - prev[0]).max(), np.abs(uy - prev[1]).max())
            if d < 5e-6:  # above the measured f32 limit-cycle floor
                break     # (~4e-6/5k steps at 150-200k steps)
        prev = (ux, uy)
    converged = d < 5e-6
    print(f"cavity: {'steady' if converged else 'NOT converged'} after "
          f"{(i + 1) * 5000} steps (d={d:.2e})")
    assert d < 1e-5, f"cavity far from steady state (d={d:.2e})"
    # centerlines: cell centers at (j+0.5)/n; x=0.5 is between columns
    u_c = 0.5 * (ux[:, n // 2 - 1] + ux[:, n // 2]) / u_lid
    v_c = 0.5 * (uy[n // 2 - 1, :] + uy[n // 2, :]) / u_lid
    checks = [
        ("u_min (vert centerline)", float(u_c.min()), -0.2109),
        ("v_max (horiz centerline)", float(v_c.max()), 0.1753),
        ("v_min (horiz centerline)", float(v_c.min()), -0.2453),
    ]
    for name, got, ref in checks:
        err = abs(got - ref) / abs(ref)
        print(f"cavity {name}: {got:.4f} vs Ghia {ref:.4f} ({err:.2%})")
        assert err < 0.04, f"cavity {name} off by {err:.2%} (budget 4%)"
    y_min = (float(np.argmin(u_c)) + 0.5) / n
    print(f"cavity u_min location y={y_min:.4f} (Ghia 0.4531)")
    assert abs(y_min - 0.4531) < 0.05
    assert bool(jnp.all(jnp.isfinite(s.f)))
    print("CAVITY OK")


def _periodic():
    """Periodic-DEM invariance: shifting the scene by nx/2 along the
    periodic axis must shift the trajectory (ghost stamping + min-image
    contacts), including through a seam crossing."""
    from lbmdem.config import DiskSpec, SimConfig, window_for_radius
    from lbmdem.simulation import Simulation

    cfg = SimConfig(nx=256, ny=64, tau=0.8, dtype="float32",
                    window=window_for_radius(4.0), max_disks=3,
                    kn=0.5, gamma_n=0.2, n_sub=4, out_interval=10**9,
                    bc_west="periodic", bc_east="periodic")
    rows = [(255.3, 32.0, 4.0, 0.06, 0.0, 0.0),
            (6.0, 44.0, 4.0, -0.02, 0.0, 0.01),
            (100.0, 30.0, 3.0, 0.0, -0.01, 0.0)]
    sh, L = 128, cfg.nx
    outs = []
    for shift in (0, sh):
        disks = [DiskSpec((x + shift) % L, y, r, vx, vy, om)
                 for x, y, r, vx, vy, om in rows]
        sim = Simulation(cfg, disks)
        sim.run(50)
        outs.append(np.asarray(sim.state.disks.x[:3]))
        assert int(sim.state.overflow) == 0, "periodic leg overflow"
    dx = (outs[1][:, 0] - outs[0][:, 0] - sh) % L
    dx = np.minimum(dx, L - dx)
    dy = np.abs(outs[1][:, 1] - outs[0][:, 1])
    print(f"periodic invariance: max|dx mod L|={dx.max():.2e} "
          f"max|dy|={dy.max():.2e} crosser at x={outs[0][0, 0]:.2f}")
    assert dx.max() < 1e-3 and dy.max() < 1e-3, "PERIODIC INVARIANCE FAIL"
    assert outs[0][0, 0] < 20.0, "seam crossing did not happen"
    print("PERIODIC OK")


def _trt():
    """TRT leg: magic Lambda = 3/16 pins the bounce-back wall exactly
    mid-link, so body-force Poiseuille in f32 must sit on the analytic
    parabola to f32 roundoff while BGK at the same tau carries a real
    slip error.

    The forcing must be strong enough that the signal clears the f32
    noise floor: the velocity is a near-cancelling moment of f ~ 0.1,
    so |u| carries ~2e-9 absolute rounding noise regardless of gx.
    Measured (CPU, 12k steps): gx=1e-6 -> trt 5.9e-3 / bgk 5.9e-3 (both
    noise-dominated, u_max 3.8e-4); gx=5e-5 -> trt 1.6e-5 / bgk 4.2e-3
    (TRT at the floor, BGK at its genuine slip; u_max 1.9e-2, still
    laminar Re ~ 2)."""
    from lbmdem.config import SimConfig
    from lbmdem.simulation import Simulation

    errs = {}
    for coll in ("trt", "bgk"):
        cfg = SimConfig(nx=128, ny=32, tau=1.5, gx=5e-5, dtype="float32",
                        collision=coll, out_interval=10**9)
        sim = Simulation(cfg)
        sim.run(12000)
        _, ux, _ = sim.macroscopic()
        y = np.arange(cfg.ny) + 0.5
        analytic = cfg.gx / (2.0 * cfg.nu) * y * (cfg.ny - y)
        prof = np.asarray(ux).mean(axis=1)
        errs[coll] = float(np.abs(prof - analytic).max() / analytic.max())
    print(f"poiseuille tau=1.5 rel err: trt {errs['trt']:.2e} "
          f"bgk {errs['bgk']:.2e}")
    assert errs["trt"] < 2e-4, "TRT(3/16) wall not exact"
    assert errs["bgk"] > 50 * errs["trt"], "BGK/TRT contrast missing"
    print("TRT OK")


def _cylinder():
    """Schafer-Turek 2D-1 at scale 2 (880x164, D=40): the recorded
    grid-convergence point (tools/benchmark_cylinder.py) - cD within 2%
    of the published converged 5.5795."""
    from tools.benchmark_cylinder import main as cyl

    cd, cl = cyl(["--scale", "2"])
    dev = abs(cd - 5.5795) / 5.5795
    assert dev < 0.02, f"scale-2 cylinder drag off by {dev:.2%} (budget 2%)"
    assert 0.008 < cl < 0.013, f"scale-2 lift {cl:.4f} implausible"


def _rshift():
    """eps_r_shift hydrodynamic-radius calibration at both calibrated
    points: D=20 s=-0.35 (recorded cD=5.5899, +0.19%) and D=40 s=-0.14
    (recorded cD=5.5764, -0.06%; uncalibrated D=20 reads +4.4%). Budget
    1.5% per point - generous vs the recorded deviations so
    last-interval noise (dcD ~1e-2) cannot flake it, tight enough that
    a coverage/force-share regression in the shifted-radius path cannot
    hide."""
    from tools.benchmark_cylinder import main as cyl

    cd, cl = cyl(["--r-shift=-0.35"])
    dev = abs(cd - 5.5795) / 5.5795
    assert dev < 0.015, f"calibrated D=20 drag off by {dev:.2%} (budget 1.5%)"
    cd40, _ = cyl(["--scale=2", "--r-shift=-0.14"])
    dev40 = abs(cd40 - 5.5795) / 5.5795
    assert dev40 < 0.015, (
        f"calibrated D=40 drag off by {dev40:.2%} (budget 1.5%)"
    )
    print("RSHIFT OK")


def _shedding():
    """Schafer-Turek 2D-2 (Re=100 vortex shedding): the Strouhal number
    is the discretization-robust observable - recorded 0.3007 at D=20
    (published interval 0.2950..0.3050; the force maxima carry the
    D=20 diffuse-interface bias, so they are reported but not
    asserted)."""
    import contextlib
    import io

    from tools.benchmark_cylinder import main as cyl

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cyl(["--unsteady"])
    out = buf.getvalue()
    print(out[out.index("FINAL"):].strip())
    st = float(out.split("St=")[1].split()[0])
    assert 0.290 <= st <= 0.310, f"2D-2 Strouhal {st} off the interval"
    print("SHEDDING OK")


def _collapse():
    """Submerged column collapse runout-vs-aspect (the reference's
    headline application, SURVEY SS0): four aspect ratios on ONE
    compiled program, asserting monotone runout, a power-law exponent
    in the literature band, and settled deposits
    (tools/collapse_study.py). The pin is the recorded fit
    dL/L0 = 0.60 * a^1.32 over a = 0.46/0.98/1.96/3.97 (f32, 1024x576,
    r=4, L0=112, kt springs)."""
    from tools.collapse_study import check_scaling, run_study

    results = run_study()
    # pinned on the recorded fit (lambda 0.60, alpha 1.32): the
    # literature band alone would pass dry-granular (creeping) behavior
    lam, alpha = check_scaling(results, pin=(0.60, 1.32))
    print(f"collapse scaling: dL/L0 = {lam:.2f} * a^{alpha:.2f} over "
          f"a = {[round(r['aspect'], 2) for r in results]}")
    print("COLLAPSE OK")


def main():
    settling_parity()
    _dkt()
    _periodic()
    _cavity()
    _trt()
    _cylinder()
    _shedding()
    print("PHYSICS VALIDATION OK")


if __name__ == "__main__":
    import sys

    stages = {"settling": settling_parity, "dkt": _dkt,
              "periodic": _periodic, "cavity": _cavity, "trt": _trt,
              "cylinder": _cylinder, "shedding": _shedding,
              "collapse": _collapse, "dktlit": _dkt_literature,
              "rshift": _rshift}
    picked = sys.argv[1:]
    if picked:
        for name in picked:
            stages[name]()
        print("SELECTED VALIDATION OK")
    else:
        main()
