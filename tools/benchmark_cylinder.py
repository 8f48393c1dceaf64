"""Schafer-Turek 2D-1 benchmark: steady cylinder drag/lift at Re = 20.

External validation of the whole coupled stack (Zou/He inlet/outlet,
half-way BB walls, IMB obstacle coupling, hydro force reduction)
against the published benchmark interval: the 1996 "Benchmark
computations of laminar flow around a cylinder" (Schafer & Turek)
reference values for the 2D-1 steady case are

    cD = 5.5700 .. 5.5900   (converged value 5.5795)
    cL = 0.0104 .. 0.0110   (converged value 0.0106)

with cD = 2 Fx / (rho u_mean^2 D), u_mean = (2/3) u_max. Measured here
(f64 oracle, D = 20 cells, 30k steps): cD = 5.827 (+4.4% vs 5.5795),
cL = 0.0095 - the expected bias of a diffuse-interface IMB at this
resolution (the partially-saturated boundary cells act as an
effectively slightly larger cylinder); finer grids converge toward
the reference (pass --scale 2).

Run (GPU, f32): python -m tools.benchmark_cylinder
Run (CPU): add --cpu (float64; slower but exactly the test paths)
"""

import argparse
import time


def measure_strouhal(hist, D, u_mean, tail_frac=0.6):
    """Strouhal number from a (step, cD, cL) history: mean period
    between upward zero crossings of the mean-removed lift signal over
    the last (1 - tail_frac) of the run, averaged first-to-last
    crossing (endpoint quantization ~ sample_interval / (n_periods *
    period)). Returns (St, n_periods, cD_max, cL_max) or None if fewer
    than 3 crossings (not yet periodic). Unit-tested on synthetic
    signals in tests/test_openbc.py."""
    import numpy as np

    tail = np.asarray(hist)[int(tail_frac * len(hist)):]  # (m, 3)
    cl_sig = tail[:, 2] - tail[:, 2].mean()
    up = np.where((cl_sig[:-1] < 0) & (cl_sig[1:] >= 0))[0]
    if len(up) < 3:
        return None
    period = (tail[up[-1], 0] - tail[up[0], 0]) / (len(up) - 1)
    return (D / (period * u_mean), len(up) - 1,
            float(tail[:, 1].max()), float(tail[:, 2].max()))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="force CPU float64")
    ap.add_argument("--scale", type=int, default=1,
                    help="grid refinement factor (1 -> 440x82, D=20)")
    ap.add_argument("--steps", type=int, default=0,
                    help="override total steps (0 -> auto by scale)")
    ap.add_argument("--trt", action="store_true",
                    help="steady 2D-1 with TRT collision (Lambda=3/16 "
                         "exact mid-link channel walls): probes how much "
                         "of the D=20 cD bias is wall slip vs the "
                         "diffuse IMB interface")
    ap.add_argument("--eps-method", default=None,
                    choices=("sample", "exact", "ramp"),
                    help="override the coverage model (interface-bias "
                         "diagnostics)")
    ap.add_argument("--r-shift", type=float, default=0.0,
                    help="eps_r_shift hydrodynamic-radius calibration "
                         "(cells, in [-1, 0]): the interface-side "
                         "mitigation of the diffuse-IMB drag bias "
                         "(calibrated r4: -0.35 at D=20, -0.14 at D=40 "
                         "land cD within 0.2% of the published 5.5795)")
    ap.add_argument("--nt-mode", default=None, choices=("nt", "lambda"),
                    help="NT blend weighting (cfg.nt_mode): 'lambda' = "
                    "the TRT/Lambda-consistent B variant (VERDICT r4 #7 "
                    "interface-side A/B)")
    ap.add_argument("--unsteady", action="store_true",
                    help="2D-2 case: Re=100 vortex shedding; measures the "
                         "Strouhal number from the lift zero crossings "
                         "(published St = 0.295..0.305, cD ~ 3.23, "
                         "cL ~ 1.0; runs TRT - BGK at tau 0.53 is "
                         "marginal on a D=20 grid)")
    args = ap.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from lbmdem.models import make_scenario
    from lbmdem.simulation import Simulation

    s = args.scale
    cfg, disks = make_scenario(
        "schafer_turek", nx=440 * s, ny=82 * s, r=10.0 * s,
        cx=40.0 * s - 0.5, cy=40.0 * s - 0.5,
        u_max=0.075 / s,  # keep Re fixed: u ~ 1/s, D ~ s, nu fixed
    )
    cfg = cfg.replace(dtype="float64" if args.cpu else "float32",
                      out_interval=10**9)
    if args.trt:
        cfg = cfg.replace(collision="trt")
    if args.eps_method:
        cfg = cfg.replace(eps_method=args.eps_method)
    if args.r_shift:
        cfg = cfg.replace(eps_r_shift=args.r_shift)
    if args.nt_mode:
        cfg = cfg.replace(nt_mode=args.nt_mode)
    if args.unsteady:
        # Re = 100: nu = u_mean D / 100; TRT keeps the coarse grid
        # well-behaved at the resulting tau ~ 0.53
        u_mean = (2.0 / 3.0) * cfg.u_inlet
        nu = u_mean * 2.0 * disks[0].r / 100.0
        cfg = cfg.replace(tau=3.0 * nu + 0.5, collision="trt")
    steps = args.steps or (50000 if args.unsteady else 30000) * s * s
    sim = Simulation(cfg, disks)

    u_mean = (2.0 / 3.0) * cfg.u_inlet
    D = 2.0 * disks[0].r
    denom = 0.5 * cfg.rho0 * u_mean * u_mean * D

    print(f"platform {jax.devices()[0].platform}; grid {cfg.nx}x{cfg.ny}, "
          f"D={D:.0f}, u_max={cfg.u_inlet}, tau={cfg.tau:.4f} "
          f"({cfg.collision}), Re={u_mean * D / cfg.nu:.1f}, steps={steps}")
    t0 = time.perf_counter()
    # unsteady: fine sampling over the back 40% for the lift signal -
    # the shedding period is ~ D/(St u_mean) ~ 1330 steps at scale 1,
    # so sample ~8x per period (the St estimate averages first-to-last
    # crossing over all periods, so per-endpoint quantization ~
    # chunk/(n_periods * period) stays well under 1%)
    chunk = max(steps // (400 if args.unsteady else 10), 1)
    done = 0
    hist = []
    while done < steps:
        sim.run(chunk)
        done += chunk
        F, T = sim.hydro_forces()
        cd = float(F[0, 0]) / denom
        cl = float(F[0, 1]) / denom
        hist.append((done, cd, cl))
        if not args.unsteady or done % (10 * chunk) == 0:
            print(f"  step {done}: cD={cd:.4f} cL={cl:.5f} "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
    if args.unsteady:
        import numpy as np

        res = measure_strouhal(hist, D, u_mean)
        if res is not None:
            st, n_per, cd_max, cl_max = res
            print(f"FINAL St={st:.4f} cD_max={cd_max:.4f} "
                  f"cL_max={cl_max:.4f} ({n_per} periods measured)")
            print("published 2D-2: St in [0.2950, 0.3050], cD_max ~ 3.23, "
                  "cL_max ~ 1.0")
        else:
            tail = np.array(hist[int(0.6 * len(hist)):])
            print(f"shedding not (yet) periodic; "
                  f"cL range [{tail[:, 2].min():.4f}, {tail[:, 2].max():.4f}]")
        return
    cd, cl = hist[-1][1], hist[-1][2]
    dcd = abs(hist[-1][1] - hist[-2][1]) if len(hist) > 1 else float("nan")
    print(f"FINAL cD={cd:.4f} cL={cl:.5f} (last-interval dcD={dcd:.1e})")
    print(f"published 2D-1: cD in [5.57, 5.59] (5.5795), "
          f"cL in [0.0104, 0.0110] (0.0106)")
    print(f"cD deviation from 5.5795: {abs(cd - 5.5795) / 5.5795:.2%}")
    return cd, cl


# Grid-convergence record (f32, 2026-08-19):
#   scale 1 (440x82,  D=20, 30k steps):  cD=5.8267 (+4.43%), cL=0.00940
#   scale 2 (880x164, D=40, 120k steps): cD=5.6316 (+0.93%), cL=0.01003
# The +4.4% coarse-grid bias shrinks ~x4.8 on grid doubling - it is the
# diffuse-IMB interface at D=20 (partially-saturated boundary cells act
# as a slightly larger cylinder), not a coupling bug; cL lands at the
# published interval's edge at scale 2. tools/validate.py asserts
# the scale-2 cD within 2% on every validation run.
#
# eps_r_shift calibration record (f32, 2026-08-20; the interface-side
# mitigation):
#   D=20 sweep: cD(s) is LINEAR in the shift over s = 0/-0.25/-0.45/
#   -0.65 -> 5.8267/5.6555/5.5050/5.3831 (slope ~0.75 per cell; the
#   first-principles cD*2/D = 0.56 underestimates by ~1.34x).
#   Interpolating to the published 5.5795 gives s = -0.35; confirmed:
#     scale 1, s=-0.35: cD=5.5899 (+0.19%, INSIDE [5.57, 5.59])
#   Applying the same 1.34x slope factor at scale 2 PREDICTS s = -0.14
#   for the residual +0.93% bias; the recorded run (120k steps) landed
#   on the prediction:
#     scale 2, s=-0.14: cD=5.5764 (-0.06%, inside the interval)
#   The calibrated shift scales with the residual bias (~1/D with the
#   bias's own super-linear convergence on top), so it is a
#   PER-RESOLUTION accuracy knob: calibrate at the resolution you run;
#   leaving it 0 keeps the scheme's native convergence (the bias
#   already shrinks ~4.8x on grid doubling). cL loses a little under
#   the shift (0.0094 -> 0.0076 at D=20) - the published 0.0104..0.0110
#   needs scale 2 regardless. `tools/validate.py rshift` pins both
#   calibrated points.
#
# 2D-2 unsteady record (f32, TRT, 2026-08-19, --unsteady):
#   scale 1 (D=20, 50k steps):  St=0.3007, cD_max=3.75,  cL_max=1.20
#   scale 2 (D=40, 200k steps): St=0.3007, cD_max=3.547, cL_max=1.060
#   (published St in 0.2950..0.3050, cD_max ~ 3.23, cL_max ~ 1.0).
#   The Strouhal number is the discretization-robust observable and
#   lands mid-interval AT BOTH RESOLUTIONS; the force maxima carry the
#   diffuse-interface bias of 2D-1 and converge the same way on grid
#   doubling (cD_max +16% -> +9.8%, cL_max +20% -> +6%).

if __name__ == "__main__":
    main()
