"""Checkpoint / resume as one .npz file (SURVEY.md §7 "Checkpoint / resume").

The reference has no checkpointing; here any pipeline state (FrontendState,
PFState, PoseGraph — all NamedTuples of arrays) saves and restores
mid-log, which is also the artifact format handed to the viz/metrics tools.
A checkpoint is a directory holding `state.npz`: the flattened pytree's
leaves, each leaf's dtype name, and the treedef's string form, which
load_state checks against its template.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

_FILE = "state.npz"


def _raw(a: np.ndarray) -> np.ndarray:
    """Leaf as a dtype numpy can store: extension dtypes (bfloat16, PRNG
    key data) travel as unsigned ints of the same width."""
    if a.dtype.kind in "biufc":
        return a
    return a.view(np.dtype(f"u{a.dtype.itemsize}"))


def save_state(path: str, state) -> str:
    """Save a NamedTuple-of-arrays pipeline state to `path` (a directory)."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    leaves, treedef = jax.tree.flatten(state)
    leaves = [np.asarray(x) for x in leaves]
    arrays = {f"leaf_{i}": _raw(a) for i, a in enumerate(leaves)}
    np.savez(
        os.path.join(path, _FILE),
        __treedef__=np.asarray(str(treedef)),
        __dtypes__=np.asarray([a.dtype.name for a in leaves]),
        **arrays,
    )
    return path


def load_state(path: str, template):
    """Restore a state saved by save_state; `template` supplies the pytree
    structure and dtypes/shapes (e.g. a freshly-initialized state)."""
    leaves_t, treedef = jax.tree.flatten(template)
    with np.load(os.path.join(os.path.abspath(path), _FILE)) as z:
        if str(z["__treedef__"]) != str(treedef):
            raise ValueError(
                "checkpoint structure does not match the template:\n"
                f"  saved:    {z['__treedef__']}\n  template: {treedef}"
            )
        dtypes = [str(d) for d in z["__dtypes__"]]
        leaves = []
        for i, (t, name) in enumerate(zip(leaves_t, dtypes)):
            a = z[f"leaf_{i}"].view(jnp.dtype(name))
            t = np.asarray(t)
            if a.shape != t.shape or a.dtype != t.dtype:
                raise ValueError(
                    f"leaf {i}: saved {a.dtype}{list(a.shape)} vs template "
                    f"{t.dtype}{list(t.shape)}"
                )
            leaves.append(a)
    return jax.tree.unflatten(treedef, leaves)
