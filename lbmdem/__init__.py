"""lbmdem: a 2D coupled LBM-DEM simulation engine in JAX.

A JAX/XLA framework with the capabilities of cb-geo/2d-lbm-dem (see
SURVEY.md for the capability analysis):

- D2Q9 BGK lattice-Boltzmann fluid with half-way bounce-back walls and
  Guo body-force driving (SURVEY.md SS2 C1-C7).
- Noble-Torczynski immersed-moving-boundary (IMB) solid-fraction coupling
  to circular DEM disks with hydrodynamic force/torque feedback (C9-C12).
- Linear spring-dashpot DEM with fixed-capacity cell-list broadphase,
  wall contacts and velocity-Verlet subcycling (C13-C16).
- The whole coupled step jitted by XLA, and multi-device lattice
  sharding over a device mesh via shard_map with per-step halo exchange
  and particle-force psum (SURVEY.md SS5.7/5.8).

NOTE on citations: the reference mount /root/reference was empty in every
session so far (SURVEY.md SS0); component IDs cite SURVEY.md's inventory,
which is pinned by BASELINE.json's driver-provided capability surface.
"""

from lbmdem import lattice, units
from lbmdem.config import SimConfig, DiskSpec, load_param_file, load_particle_file
from lbmdem.simulation import Simulation, SimState, FluidState, DiskState

__version__ = "0.1.0"

__all__ = [
    "lattice",
    "units",
    "SimConfig",
    "DiskSpec",
    "load_param_file",
    "load_particle_file",
    "Simulation",
    "SimState",
    "FluidState",
    "DiskState",
]
