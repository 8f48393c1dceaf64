"""Compute ops: the D2Q9 fluid, the IMB coupling and the DEM."""
