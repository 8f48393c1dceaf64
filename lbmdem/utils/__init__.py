"""Aux subsystems: metrics, checkpointing, VTK I/O (+native writer),
profiling (SURVEY.md SS5)."""

from lbmdem.utils import checkpoint, io_vtk, metrics, profiling

__all__ = ["checkpoint", "io_vtk", "metrics", "profiling"]
