"""Drafting-kissing-tumbling vs the published literature case
(SURVEY SS4 benchmark #3; VERDICT r3 weak #4 - DKT was the one
benchmark pinned only against this repo's own f64 oracle).

The canonical 2D DKT configuration of the Feng, Hu & Joseph (1994)
lineage, reused by essentially every particulate-flow validation since
(Feng & Michaelides 2004 JCP 195; Niu et al. 2006 Phys. Lett. A;
Glowinski et al. 2001 variants; the LBM-IMB papers in PAPERS.md):

  channel 2 cm x 8 cm, two rigid circles d = 0.2 cm,
  rho_s / rho_f = 1.01, nu = 0.01 cm^2/s, g = 980 cm/s^2,
  released horizontally centered (with the customary ~0.001 cm
  symmetry-breaking offset) at heights 7.2 and 6.8 cm.

The trailing (upper) disk drafts in the leading disk's wake, falls
faster, kisses, and the unstable doublet tumbles apart. Exact phase
times are famously sensitive to discretization (the kissing contact is
a singular lubrication event), so published kissing times SPREAD across
methods - roughly t_kiss ~ 1-3 s in the FEM/DLM/LBM literature (Feng &
Michaelides 2004 report kissing near ~2 s at this density ratio; the
ALE and DLM studies bracket it). The study therefore asserts the
method-independent quantitative signatures:

  1. drafting: the trailing disk's mean settling speed exceeds the
     leading disk's from release to kissing (wake shielding),
  2. kissing: first contact lands inside the published cross-method
     window 0.8 s < t_kiss < 3.5 s,
  3. gap closure: the surface gap shrinks from 0.2 cm (= d) at release
     to contact, monotonically in the smoothed sense (no rebound before
     the kiss),
  4. tumbling: within 2 s after the kiss the doublet breaks laterally
     (|dx| between centers exceeds d/2) - the vertical pair is unstable
     at rho_s/rho_f = 1.01.

Run: python -m tools.dkt_study [--fast]   (f64 by default; used by
tests/test_scenarios.py::test_dkt_literature_anchor and the
tools/validate.py 'dktlit' leg, which runs the f32 path on the device.)
"""

from __future__ import annotations

import argparse
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

# --- physical configuration (cgs units, the literature case) ---
WIDTH_CM = 2.0
HEIGHT_CM = 8.0
D_CM = 0.2
RHO_RATIO = 1.01
NU_CM2S = 0.01
G_CMS2 = 980.0
Y0_TRAIL = 7.2
Y0_LEAD = 6.8
X_OFF = 0.001  # customary symmetry-breaking offset (cm)


def build(nx=120, tau=0.55, dtype="float64", n_sub=10):
    """(cfg, disks, dt_s, dx_cm): the literature DKT deck in lattice
    units at `nx` cells across the 2 cm channel. dt follows from
    matching nu: nu_lat = (tau - 1/2)/3 = nu_phys * dt / dx^2."""
    from lbmdem.config import DiskSpec, SimConfig

    dx = WIDTH_CM / nx
    ny = int(round(HEIGHT_CM / dx))
    nu_lat = (tau - 0.5) / 3.0
    dt = nu_lat * dx * dx / NU_CM2S
    g_lat = G_CMS2 * dt * dt / dx
    r_lat = 0.5 * D_CM / dx
    # contact stiffness: stiff enough that contact overlap stays well
    # under a cell at the drafting impact speed (spring-dashpot, C14)
    cfg = SimConfig(
        nx=nx, ny=ny, tau=tau, dtype=dtype, rho_s=RHO_RATIO,
        g_py=-g_lat, buoyancy=True, kn=2.0, gamma_n=1.0, gamma_t=0.3,
        mu=0.1, n_sub=n_sub, bc_west="wall", bc_east="wall",
        max_disks=2, out_interval=10 ** 9,
    )
    disks = [
        DiskSpec((WIDTH_CM / 2 - X_OFF) / dx, Y0_TRAIL / dx, r_lat),
        DiskSpec((WIDTH_CM / 2 + X_OFF) / dx, Y0_LEAD / dx, r_lat),
    ]
    return cfg, disks, dt, dx


def run_study(nx=120, tau=0.55, dtype="float64",
              t_max_s=5.0, sample_every=25, verbose=True):
    """Run until kiss + 2 s (or t_max_s); return a dict of phase
    metrics in PHYSICAL units (seconds / cm)."""
    import jax

    from lbmdem.simulation import Simulation

    cfg, disks, dt, dx = build(nx=nx, tau=tau, dtype=dtype)
    sim = Simulation(cfg, disks)
    max_steps = int(t_max_s / dt)
    rows = []  # (t_s, y_trail, y_lead, x_trail, x_lead, n_contacts)
    t_kiss = None
    steps_after_kiss = int(2.0 / dt)
    kiss_step = None
    step = 0
    while step < max_steps:
        sim.run(sample_every)
        step += sample_every
        d = sim.state.disks
        x = np.asarray(d.x)
        nc = int(sim.state.n_contacts)
        rows.append((step * dt, x[0, 1] * dx, x[1, 1] * dx,
                     x[0, 0] * dx, x[1, 0] * dx, nc))
        if t_kiss is None and nc >= 1:
            t_kiss = step * dt
            kiss_step = step
            if verbose:
                print(f"kiss at t={t_kiss:.3f} s (step {step})",
                      flush=True)
        if kiss_step is not None and step >= kiss_step + steps_after_kiss:
            break
        # stop early if the pair approaches the bottom wall
        if min(x[0, 1], x[1, 1]) * dx < 1.0:
            break
    rows = np.array(rows)
    t = rows[:, 0]
    gap = rows[:, 1] - rows[:, 2] - D_CM  # surface gap (cm)
    dx_lat = np.abs(rows[:, 3] - rows[:, 4])  # lateral separation (cm)
    pre = t < (t_kiss if t_kiss is not None else t[-1])
    # mean settling speeds over the drafting phase (release -> kiss)
    if pre.sum() >= 2:
        vy_trail = (rows[pre][-1, 1] - rows[pre][0, 1]) / (
            t[pre][-1] - t[pre][0])
        vy_lead = (rows[pre][-1, 2] - rows[pre][0, 2]) / (
            t[pre][-1] - t[pre][0])
    else:
        vy_trail = vy_lead = float("nan")
    # smoothed gap monotonicity before the kiss: compare a coarse
    # moving average (the raw gap carries sub-cell stamp noise)
    k = max(1, pre.sum() // 10)
    g_s = np.convolve(gap[pre], np.ones(k) / k, mode="valid")
    rebound = float((np.diff(g_s) > 0.05 * D_CM).sum())
    out = {
        "t_kiss_s": t_kiss,
        "vy_trail_cms": vy_trail,
        "vy_lead_cms": vy_lead,
        "draft_ratio": vy_trail / vy_lead if vy_lead else float("nan"),
        "gap0_cm": gap[0],
        "rebound_events": rebound,
        "max_dx_post_kiss_cm": (
            float(dx_lat[t >= t_kiss].max()) if t_kiss is not None else 0.0
        ),
        "t_end_s": float(t[-1]),
        "rows": rows,
        "dt_s": dt,
        "dx_cm": dx,
    }
    if verbose:
        print(f"drafting speeds: trail {vy_trail:.3f} lead {vy_lead:.3f} "
              f"cm/s (ratio {out['draft_ratio']:.3f})")
        print(f"post-kiss lateral separation max "
              f"{out['max_dx_post_kiss_cm']:.3f} cm")
    return out


# Recorded calibration of the production-resolution published-geometry
# runs (nx=120 f64 and nx=128 f32 agree - the
# anchors are not precision-marginal): kissing at 1.505 s, drafting
# ratio 1.139.
PIN_NX128 = (1.505, 1.139)


def check_literature(m, pin=None):
    """The external-anchor asserts (numbers from the DKT literature,
    not from this repo - see module docstring for provenance).

    pin=(t_kiss_s, draft_ratio): additionally pin the RECORDED
    calibration values of a specific configuration (+-15% / +-10%), so
    a regression cannot hide inside the wide cross-method literature
    window (VERDICT r4 weak #4 - the same outer-window + recorded-pin
    pattern as the collapse runout fit). The literature window stays
    the outer gate; the pin guards this framework's own trajectory."""
    assert m["t_kiss_s"] is not None, "no kiss: DKT never made contact"
    if pin is not None:
        t_ref, r_ref = pin
        assert abs(m["t_kiss_s"] - t_ref) <= 0.15 * t_ref, (
            f"kissing time drifted off the recorded calibration: "
            f"t={m['t_kiss_s']:.3f} s vs pinned {t_ref:.3f} s +-15%"
        )
        assert abs(m["draft_ratio"] - r_ref) <= 0.10 * r_ref, (
            f"draft ratio drifted off the recorded calibration: "
            f"{m['draft_ratio']:.3f} vs pinned {r_ref:.3f} +-10%"
        )
    assert 0.8 < m["t_kiss_s"] < 3.5, (
        f"kissing at t={m['t_kiss_s']:.2f} s outside the published "
        f"cross-method window [0.8, 3.5] s (Feng & Michaelides 2004 "
        f"~2 s at rho_s/rho_f=1.01; FEM/DLM studies bracket it)"
    )
    # drafting: the trailing disk must fall measurably faster (wake
    # shielding); published velocity plots show a 10-50% excess during
    # the drafting phase at this density ratio
    assert m["draft_ratio"] > 1.05, (
        f"no drafting: trailing/leading settling-speed ratio "
        f"{m['draft_ratio']:.3f} (literature: clearly > 1)"
    )
    # gap closes from d to contact without rebound before the kiss
    assert abs(m["gap0_cm"] - D_CM) < 0.02, "bad release geometry"
    assert m["rebound_events"] == 0, (
        f"gap rebounded before kissing ({m['rebound_events']} events)"
    )
    # tumbling: the vertical doublet is unstable - it must break
    # laterally by more than d/2 within 2 s of the kiss
    assert m["max_dx_post_kiss_cm"] > 0.5 * D_CM, (
        f"no tumbling: post-kiss lateral separation "
        f"{m['max_dx_post_kiss_cm']:.3f} cm < d/2"
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="force CPU")
    ap.add_argument("--fast", action="store_true",
                    help="nx=80 f64 oracle (CPU-test size)")
    ap.add_argument("--f32", action="store_true",
                    help="float32 at nx=128 (the device configuration)")
    args = ap.parse_args(argv)
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if not args.f32:
        # the f64 oracle needs x64 enabled (outside pytest's conftest);
        # calibration note: the study also passes in f32 (t_kiss 1.505 s,
        # draft ratio 1.139 measured with x64 off) - the anchors are not
        # precision-marginal
        jax.config.update("jax_enable_x64", True)
    pin = None
    if args.fast:
        m = run_study(nx=80)
    elif args.f32:
        m = run_study(nx=128, dtype="float32")
        pin = PIN_NX128  # recorded on this config (f32)
    else:
        m = run_study()
        pin = PIN_NX128  # f64 oracle tracks the f32 value closely
    check_literature(m, pin=pin)
    print(f"t_kiss={m['t_kiss_s']:.3f} s, draft ratio "
          f"{m['draft_ratio']:.3f}, post-kiss |dx| "
          f"{m['max_dx_post_kiss_cm']:.3f} cm")
    print("DKT LITERATURE ANCHOR OK")
    return m


if __name__ == "__main__":
    main()
