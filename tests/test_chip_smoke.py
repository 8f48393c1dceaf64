"""chip_smoke.py's phases rehearsed on the CPU at toy sizes: the same
code paths and checks the card run takes, minus the device numbers
(those need the card; chip_smoke itself refuses the CPU, see
test_device.py). The sharded phase runs on four virtual CPU devices."""

import numpy as np

import chip_smoke


def test_phase_fluid_cpu():
    r = chip_smoke.phase_fluid(n=32, steps=4, repeats=1)
    assert r["mlups"] > 0 and r["mass_drift"] < 1e-5


def test_phase_coupled_cpu():
    r = chip_smoke.phase_coupled(n=128, n_disks=7, steps=3, repeats=1)
    assert r["steps"] == 3 and r["mlups"] > 0


def test_phase_coupled_bf16_ramp_cpu():
    r = chip_smoke.phase_coupled(n=128, n_disks=7, steps=3, repeats=1,
                                 f_storage="bfloat16", eps_method="ramp")
    assert r["f_storage"] == "bfloat16"


def test_phase_cli_cpu(tmp_path):
    r = chip_smoke.phase_cli(steps=20, deck="sedimentation.par",
                             out=str(tmp_path / "out"))
    assert r["snapshots"] == 1
    assert not (tmp_path / "out").exists()  # the phase cleans up


def test_phase_sharded_cpu():
    """The four-card phase's program and comparison on a (4, 1) virtual
    mesh. On the CPU the sums run in the same order on both sides."""
    r = chip_smoke.phase_sharded(n=128, n_disks=7, steps=3,
                                 mesh_shape=(4, 1))
    assert r["cards"] == 4
    assert np.isfinite(r["mlups_per_card"])
    assert r["max_df"] <= 1e-6 and r["max_dx"] <= 1e-6
