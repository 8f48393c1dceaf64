"""Checkpoint / resume (SURVEY.md SS5.4).

The reference loses a run on crash; here the full SimState pytree
(distributions, disk SoA, step counter, diagnostics) serializes to one
.npz - no external services, portable across hosts, resumable into the
same or a differently-sharded run (arrays are global). Identical-
trajectory resume is enforced by tests/test_aux.py.
"""

from __future__ import annotations

import os

import jax
import numpy as np

_MAGIC = "lbmdem_ckpt_v1"


def save_state(path: str, state, cfg=None) -> None:
    import dataclasses
    import json

    def host(x):
        a = np.asarray(x)
        # bf16 isn't a native numpy dtype (.npz can't store it); widen
        # to f32 on save (exact), load_state casts back via the template
        return a.astype(np.float32) if a.dtype.name == "bfloat16" else a

    leaves, _ = jax.tree.flatten(state)
    arrs = {f"leaf_{i}": host(x) for i, x in enumerate(leaves)}
    meta = {
        "magic": _MAGIC,
        "n_leaves": len(leaves),
        # original (pre-widening) dtypes: load_state refuses to cast
        # across a REAL dtype change (e.g. a float32-storage checkpoint
        # resumed into a bf16-storage run would silently reinterpret
        # physical f as shifted g)
        "dtypes": [np.dtype(x.dtype).name for x in leaves],
    }
    if cfg is not None:
        meta["config"] = dataclasses.asdict(cfg)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp.npz"  # atomic write: tmp + rename
    np.savez(tmp, __meta__=np.asarray(json.dumps(meta)), **arrs)
    os.replace(tmp, path)


def load_state(path: str, like) -> "SimState":
    """Restore into the structure of `like` (a SimState template)."""
    import json

    with np.load(path, allow_pickle=False) as z:
        n = len([k for k in z.files if k.startswith("leaf_")])
        leaves = [z[f"leaf_{i}"] for i in range(n)]
        meta = json.loads(str(z["__meta__"])) if "__meta__" in z.files else {}
    template_leaves, treedef = jax.tree.flatten(like)
    assert len(leaves) == len(template_leaves), (
        f"checkpoint has {len(leaves)} leaves, state needs "
        f"{len(template_leaves)} - the checkpoint was written by a "
        f"different framework version (the SimState/DiskState pytree "
        f"gained or lost fields, e.g. DiskState.mobile); re-create the "
        f"state from the deck and copy fields over manually to migrate"
    )
    orig_dtypes = meta.get("dtypes") or [a.dtype.name for a in leaves]
    for got, want, odt in zip(leaves, template_leaves, orig_dtypes):
        assert got.shape == want.shape, (
            f"checkpoint leaf shape {got.shape} != state {want.shape} "
            f"(different lattice/disk capacity?)"
        )
        assert odt == np.dtype(want.dtype).name, (
            f"checkpoint leaf dtype {odt} != state {np.dtype(want.dtype).name}"
            f" - resuming across an f_storage/dtype change would silently "
            f"reinterpret the data (convert explicitly instead)"
        )
    # the only cast this performs is undoing save_state's bf16->f32
    # widening (exact roundtrip); real dtype changes were rejected above.
    # Arrays are global, so a checkpoint restores into ANY sharding: when
    # the template leaf is a committed sharded jax.Array (a mesh run,
    # e.g. from parallel.shard_state), device_put lays the restored leaf
    # out the same way - single-chip -> mesh, mesh -> mesh of a different
    # shape, and mesh -> single-chip all work (tests/test_aux.py
    # ::test_checkpoint_resharding_*).
    def restore(x, w):
        a = jax.numpy.asarray(x).astype(w.dtype)
        sharding = getattr(w, "sharding", None)
        if sharding is not None and getattr(w, "committed", False):
            a = jax.device_put(a, sharding)
        return a

    return jax.tree.unflatten(
        treedef,
        [restore(x, w) for x, w in zip(leaves, template_leaves)],
    )
