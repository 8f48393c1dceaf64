"""Snapshot output (SURVEY.md SS2 C20): legacy-VTK fluid fields and
particle files, ParaView-compatible, plus a CSV trajectory log.

Fluid fields go out as STRUCTURED_POINTS (rho, velocity, eps), binary
big-endian by default (ASCII optional for diffing). Particles go out as
POLYDATA vertices with radius/velocity/omega attributes - matching the
reference's ParaView workflow (SURVEY SS1 L6).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def _vtk_array(fh, arr: np.ndarray, binary: bool):
    if binary:
        fh.write(arr.astype(">f4").tobytes())
        fh.write(b"\n")
    else:
        import io

        buf = io.StringIO()
        np.savetxt(buf, arr.reshape(-1, arr.shape[-1] if arr.ndim > 2 else 1),
                   fmt="%.7g")
        fh.write(buf.getvalue().encode())


def write_fluid_vtk(
    path: str,
    rho: np.ndarray,
    ux: np.ndarray,
    uy: np.ndarray,
    eps: Optional[np.ndarray] = None,
    binary: bool = True,
) -> None:
    """Write (ny, nx) fluid fields as legacy VTK STRUCTURED_POINTS."""
    ny, nx = rho.shape
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if binary:
        from lbmdem.utils import native

        if native.write_fluid_vtk(path, rho, ux, uy, eps):
            return
    with open(path, "wb") as fh:
        w = lambda s: fh.write(s.encode())
        w("# vtk DataFile Version 3.0\n")
        w("lbmdem fluid snapshot\n")
        w("BINARY\n" if binary else "ASCII\n")
        w("DATASET STRUCTURED_POINTS\n")
        w(f"DIMENSIONS {nx} {ny} 1\n")
        w("ORIGIN 0 0 0\n")
        w("SPACING 1 1 1\n")
        w(f"POINT_DATA {nx * ny}\n")
        w("SCALARS rho float 1\nLOOKUP_TABLE default\n")
        _vtk_array(fh, rho, binary)
        w("VECTORS velocity float\n")
        vel = np.stack([ux, uy, np.zeros_like(ux)], axis=-1)
        _vtk_array(fh, vel, binary)
        if eps is not None:
            w("SCALARS eps float 1\nLOOKUP_TABLE default\n")
            _vtk_array(fh, eps, binary)


def write_particles_vtk(path: str, disks: dict, binary: bool = False) -> None:
    """Write active disks as VTK POLYDATA vertices (x, r, v, omega)."""
    act = np.asarray(disks["active"])
    x = np.asarray(disks["x"])[act]
    v = np.asarray(disks["v"])[act]
    r = np.asarray(disks["r"])[act]
    om = np.asarray(disks["omega"])[act]
    th = np.asarray(disks["theta"])[act]
    n = x.shape[0]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        fh.write("# vtk DataFile Version 3.0\n")
        fh.write("lbmdem particles\n")
        fh.write("ASCII\n")
        fh.write("DATASET POLYDATA\n")
        fh.write(f"POINTS {n} float\n")
        for i in range(n):
            fh.write(f"{x[i, 0]} {x[i, 1]} 0\n")
        fh.write(f"VERTICES {n} {2 * n}\n")
        for i in range(n):
            fh.write(f"1 {i}\n")
        fh.write(f"POINT_DATA {n}\n")
        fh.write("SCALARS radius float 1\nLOOKUP_TABLE default\n")
        for i in range(n):
            fh.write(f"{r[i]}\n")
        fh.write("SCALARS omega float 1\nLOOKUP_TABLE default\n")
        for i in range(n):
            fh.write(f"{om[i]}\n")
        fh.write("SCALARS theta float 1\nLOOKUP_TABLE default\n")
        for i in range(n):
            fh.write(f"{th[i]}\n")
        fh.write("VECTORS velocity float\n")
        for i in range(n):
            fh.write(f"{v[i, 0]} {v[i, 1]} 0\n")


def append_force_csv(path: str, step: int, active, F, T) -> None:
    """Per-frame hydrodynamic force/torque log: step, id, fx, fy, torque
    (lattice units). Companion to trajectories.csv for drag/lift time
    series on obstacle disks (Simulation.hydro_forces is the source)."""
    act = np.asarray(active)
    F = np.asarray(F)
    T = np.asarray(T)
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    new = not os.path.exists(path)
    # bulk-format the active rows (np.savetxt, one write): a per-disk
    # Python f-string loop is O(N) host work per frame on the async
    # writer thread, noticeable at 10k-disk suspension scales
    ids = np.nonzero(act)[0]
    rows = np.column_stack(
        [ids.astype(np.float64), F[ids, 0], F[ids, 1], T[ids]]
    )
    with open(path, "a") as fh:
        if new:
            fh.write("step,id,fx,fy,torque\n")
        if rows.size:
            np.savetxt(fh, rows, fmt=f"{step},%d,%.17g,%.17g,%.17g")


def append_particle_csv(path: str, step: int, disks: dict) -> None:
    """Per-frame particle trajectory log: step, id, x, y, vx, vy, theta,
    omega (the reference's trajectory-log analogue)."""
    from lbmdem.utils import native

    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    if native.append_particle_csv(path, step, disks):
        return
    act = np.asarray(disks["active"])
    x = np.asarray(disks["x"])
    v = np.asarray(disks["v"])
    th = np.asarray(disks["theta"])
    om = np.asarray(disks["omega"])
    new = not os.path.exists(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    with open(path, "a") as fh:
        if new:
            fh.write("step,id,x,y,vx,vy,theta,omega\n")
        for i in np.nonzero(act)[0]:
            fh.write(
                f"{step},{i},{x[i,0]},{x[i,1]},{v[i,0]},{v[i,1]},"
                f"{th[i]},{om[i]}\n"
            )
