"""Observability (SURVEY.md SS5.5): on-device diagnostics + structured logs.

The reference prints step/mass to stdout; here a single jitted function
computes the full scalar panel on device (one tiny transfer), and
`MetricsLogger` appends CSV/JSONL rows. Mass-conservation drift is the
canary (SS5.5); cell-list/contact/ghost overflow counters surface
silent-capacity failures (SS5.2/5.3 analogue).
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Dict, Optional

import jax
import jax.numpy as jnp

from lbmdem.config import SimConfig
from lbmdem.ops import lbm


def compute_diagnostics(state, cfg: SimConfig) -> Dict[str, jax.Array]:
    """All scalar diagnostics in one jittable pass over the state."""
    f = lbm.from_storage(state.f, cfg)
    rho, ux, uy = lbm.moments(f, cfg.gx, cfg.gy)
    umag2 = ux * ux + uy * uy
    out = {
        "step": state.step,
        "mass": jnp.sum(rho),
        "mom_x": jnp.sum(rho * ux),
        "mom_y": jnp.sum(rho * uy),
        "fluid_ke": 0.5 * jnp.sum(rho * umag2),
        "max_u": jnp.sqrt(jnp.max(umag2)),
        "min_rho": jnp.min(rho),
        "nan": jnp.sum(~jnp.isfinite(f)).astype(jnp.int32),
    }
    d = state.disks
    act = d.active
    out.update(
        {
            "disk_ke": 0.5 * jnp.sum(jnp.where(act, d.mass * jnp.sum(d.v**2, -1), 0.0)),
            "disk_rot_ke": 0.5 * jnp.sum(jnp.where(act, d.inertia * d.omega**2, 0.0)),
            "max_disk_v": jnp.sqrt(
                jnp.max(jnp.where(act, jnp.sum(d.v**2, -1), 0.0))
            ),
            "n_contacts": state.n_contacts,
            "overflow": state.overflow,
        }
    )
    return out


class MetricsLogger:
    """Appends diagnostics to CSV (and optionally JSONL) with wall-clock
    MLUPS computed between calls."""

    def __init__(self, path_csv: str, path_jsonl: Optional[str] = None):
        self.path_csv = path_csv
        self.path_jsonl = path_jsonl
        self._fields = None
        self._t_last = None
        self._step_last = 0
        self._diag = None

    def log(self, sim) -> Dict[str, float]:
        if self._diag is None:
            self._diag = jax.jit(
                lambda s: compute_diagnostics(s, sim.cfg)
            )
        row = {k: v.item() for k, v in self._diag(sim.state).items()}
        now = time.perf_counter()
        if self._t_last is not None and row["step"] > self._step_last:
            cells = sim.cfg.nx * sim.cfg.ny * (row["step"] - self._step_last)
            row["mlups"] = cells / (now - self._t_last) / 1e6
        else:
            row["mlups"] = 0.0
        self._t_last = now
        self._step_last = row["step"]

        if self._fields is None:
            self._fields = list(row)
            new = not os.path.exists(self.path_csv)
            os.makedirs(os.path.dirname(self.path_csv) or ".", exist_ok=True)
            with open(self.path_csv, "a", newline="") as fh:
                w = csv.DictWriter(fh, fieldnames=self._fields)
                if new:
                    w.writeheader()
                w.writerow(row)
        else:
            with open(self.path_csv, "a", newline="") as fh:
                csv.DictWriter(fh, fieldnames=self._fields).writerow(row)
        if self.path_jsonl:
            with open(self.path_jsonl, "a") as fh:
                fh.write(json.dumps(row) + "\n")
        return row
