"""Regenerate the example decks from the scenario constructors.

Each BASELINE.json config ships as a reference-format deck + particle
file so the CLI surface (`python -m lbmdem.cli <deck>`) covers the
whole benchmark suite (SURVEY.md SS4). Run from the repo root:

    python examples/generate.py
"""

from __future__ import annotations

import os

from lbmdem.config import SimConfig, save_particle_file
from lbmdem.models import make_scenario

HERE = os.path.dirname(os.path.abspath(__file__))

_DEFAULTS = SimConfig(nx=1, ny=1)

# deck fields in emission order; bc handled separately
_FIELDS = [
    "nx", "ny", "tau", "gx", "gy", "steps", "out_interval",
    "kn", "kt", "gamma_n", "gamma_t", "mu", "rho_s", "n_sub",
    "g_px", "g_py", "buoyancy", "smagorinsky",
    "uw_west", "uw_east", "uw_south", "uw_north",
    "u_inlet", "inlet_profile", "rho_outlet", "dtype",
]


def cfg_to_deck(cfg: SimConfig, header: str, particles: str | None) -> str:
    lines = [f"# {h}" for h in header.splitlines()]
    for k in _FIELDS:
        v = getattr(cfg, k)
        if v == getattr(_DEFAULTS, k) and k not in ("nx", "ny", "tau", "steps"):
            continue
        if isinstance(v, bool):
            v = int(v)
        lines.append(f"{k} {v}")
    for side in ("west", "east", "south", "north"):
        lines.append(f"bc {side} {getattr(cfg, f'bc_{side}')}")
    if particles:
        lines.append(f"particles {particles}")
    return "\n".join(lines) + "\n"


def emit(name: str, scenario: str, header: str, **overrides) -> None:
    cfg, disks = make_scenario(scenario, **overrides)
    pfile = f"{name}_disks.txt" if disks else None
    with open(os.path.join(HERE, f"{name}.par"), "w") as fh:
        fh.write(cfg_to_deck(cfg, header, pfile))
    if pfile:
        save_particle_file(os.path.join(HERE, pfile), disks)


def main() -> None:
    emit("dkt", "dkt", (
        "Drafting-kissing-tumbling: two disks, the trailing one drafts\n"
        "into the leader's wake, they kiss, then tumble apart\n"
        "(BASELINE config #3).\n"
        "Run:  python -m lbmdem.cli examples/dkt.par --out out/"
    ))
    emit("settling_column", "settling_column", (
        "1000-disk settling column: cell-list broadphase + contact\n"
        "mechanics under gravity (BASELINE config #4).\n"
        "Run:  python -m lbmdem.cli examples/settling_column.par --out out/"
    ))
    emit("column_collapse", "column_collapse", (
        "Submerged granular column collapse, 4096^2 lattice with 10000\n"
        "disks - the headline benchmark config (BASELINE config #5;\n"
        "bench.py measures MLUPS on it). Sized for a GPU; scale\n"
        "nx/ny down for CPU smoke runs.\n"
        "Run:  python -m lbmdem.cli examples/column_collapse.par --out out/"
    ))
    emit("column_collapse_friction", "column_collapse", (
        "Column collapse with Cundall-Strack friction springs (kt > 0):\n"
        "the runout is visibly shorter than the dashpot-only deck\n"
        "(2048^2, 2500 disks).\n"
        "Run:  python -m lbmdem.cli examples/column_collapse_friction.par"
        " --out out/"
    ), nx=2048, ny=2048, n_disks=2500, kt=25.0)
    emit("cavity", "cavity", (
        "Lid-driven cavity: moving north wall (moving-wall half-way\n"
        "bounce-back, SURVEY C6).\n"
        "Run:  python -m lbmdem.cli examples/cavity.par --out out/"
    ))
    emit("cylinder", "cylinder", (
        "Flow past a fixed cylinder: a body-force-driven periodic-x\n"
        "channel with an infinite-mass obstacle disk (fixed=1 in the\n"
        "particle file); drag via Simulation.hydro_forces. Re ~ 25.\n"
        "Run:  python -m lbmdem.cli examples/cylinder.par --out out/"
    ))
    emit("porous_bed", "porous_bed", (
        "Darcy flow through a square array of fixed cylinders (fully\n"
        "periodic, body-force driven): permeability K = <u> nu / g.\n"
        "Run:  python -m lbmdem.cli examples/porous_bed.par --out out/"
    ))
    emit("suspension_channel", "suspension_channel", (
        "Dilute suspension transport: mobile near-neutrally-buoyant\n"
        "disks carried through a Zou/He inlet/outlet channel; disks\n"
        "deactivate as they exit the outlet (outflow culling).\n"
        "Run:  python -m lbmdem.cli examples/suspension_channel.par"
        " --out out/"
    ))
    emit("schafer_turek", "schafer_turek", (
        "Schafer-Turek 2D-1: steady flow past a cylinder in a channel at\n"
        "Re = 20 - parabolic Zou/He inlet, pressure outlet, fixed obstacle\n"
        "disk. Published cD = 5.5795, cL = 0.0106; measure ours with\n"
        "tools/benchmark_cylinder.py.\n"
        "Run:  python -m lbmdem.cli examples/schafer_turek.par --out out/"
    ))


if __name__ == "__main__":
    main()
