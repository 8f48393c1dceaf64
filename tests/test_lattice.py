"""D2Q9 invariants + unit conversion (SURVEY.md SS4 unit tests)."""

import numpy as np

from lbmdem import lattice, units


def test_weights_sum_to_one():
    assert abs(lattice.W.sum() - 1.0) < 1e-15


def test_velocity_moments():
    # sum_i w_i e_i = 0
    assert np.allclose(lattice.W @ lattice.E, 0.0, atol=1e-15)
    # sum_i w_i e_ia e_ib = cs^2 delta_ab
    second = np.einsum("i,ia,ib->ab", lattice.W, lattice.E, lattice.E)
    assert np.allclose(second, lattice.CS2 * np.eye(2), atol=1e-15)
    # fourth moment isotropy: sum w e_a e_b e_c e_d = cs^4 (d_ab d_cd + ...)
    fourth = np.einsum("i,ia,ib,ic,id->abcd", lattice.W, lattice.E, lattice.E, lattice.E, lattice.E)
    cs4 = lattice.CS2**2
    eye = np.eye(2)
    expect = cs4 * (
        np.einsum("ab,cd->abcd", eye, eye)
        + np.einsum("ac,bd->abcd", eye, eye)
        + np.einsum("ad,bc->abcd", eye, eye)
    )
    assert np.allclose(fourth, expect, atol=1e-15)


def test_opposite_table():
    assert np.all(lattice.E[lattice.OPP] == -lattice.E)
    assert np.all(lattice.OPP[lattice.OPP] == np.arange(9))


def test_tau_nu_roundtrip():
    assert abs(lattice.nu_from_tau(lattice.tau_from_nu(0.123)) - 0.123) < 1e-15


def test_unit_system_roundtrip():
    us = units.UnitSystem(dx=2e-4, dt=5e-6, rho0=1250.0)
    assert np.isclose(us.velocity_from_lattice(us.velocity_to_lattice(3.2)), 3.2)
    assert np.isclose(us.nu_to_lattice(1e-6), 1e-6 * us.dt / us.dx**2)
    assert np.isclose(us.accel_to_lattice(9.81) * us.accel_scale, 9.81)
    assert np.isclose(us.force_scale, us.rho0 * us.dx**4 / us.dt**2)
