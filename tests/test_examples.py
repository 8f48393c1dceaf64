"""Every example deck parses, builds, and steps (SURVEY.md SS4: the five
BASELINE configs are the integration suite; decks are the user surface).
"""

import glob
import os

import numpy as np
import pytest

from lbmdem.config import load_param_file, load_particle_file
from lbmdem.simulation import Simulation

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
DECKS = sorted(glob.glob(os.path.join(EXAMPLES, "*.par")))

# decks small enough to actually step on the CPU test runner; the
# column-collapse deck is the 4096^2 headline config (bench.py territory)
_STEP_CELL_CAP = 512 * 1024


def test_all_five_baseline_decks_present():
    names = {os.path.basename(p) for p in DECKS}
    assert {
        "poiseuille.par", "sedimentation.par", "dkt.par",
        "settling_column.par", "column_collapse.par",
    } <= names


def test_all_decks_parse_and_validate():
    """EVERY deck parses, validates, and its particles land in-domain
    (cheap - no stepping); the stepping test below runs the BASELINE
    decks quick and the rest slow (r5 lane trim)."""
    assert DECKS
    for deck in DECKS:
        cfg, pfile = load_param_file(deck)
        disks = load_particle_file(pfile, units=cfg.units) if pfile else []
        if pfile:
            assert len(disks) > 0, deck
            for d in disks:
                assert 0 <= d.x < cfg.nx and 0 <= d.y < cfg.ny and d.r > 0


# the five BASELINE decks (SURVEY SS4) step in the quick lane; the rest
# are feature decks whose machinery has dedicated parity tests - they
# still step under -m slow
_QUICK_STEP = {"poiseuille.par", "sedimentation.par", "dkt.par",
               "settling_column.par", "column_collapse.par"}


@pytest.mark.parametrize(
    "deck",
    [d if os.path.basename(d) in _QUICK_STEP
     else pytest.param(d, marks=pytest.mark.slow) for d in DECKS],
    ids=os.path.basename)
def test_deck_parses_and_steps(deck):
    cfg, pfile = load_param_file(deck)
    disks = load_particle_file(pfile, units=cfg.units) if pfile else []
    if cfg.nx * cfg.ny > _STEP_CELL_CAP:
        return  # parse/validate only (headline-size deck)
    sim = Simulation(cfg.replace(out_interval=2), disks)
    sim.run(2)
    assert int(sim.state.step) == 2
    assert int(sim.state.overflow) == 0
    assert np.isfinite(np.asarray(sim.state.f)).all()
