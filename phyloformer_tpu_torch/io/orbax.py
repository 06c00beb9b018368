"""Read the JAX trainer's Orbax checkpoint directories without JAX.

The JAX package's ``CheckpointManager.save`` (``io/checkpoint.py``) writes
one directory a step under the run's directory::

    <run>/<step>/_CHECKPOINT_METADATA        JSON; marks the step committed
    <run>/<step>/metadata/metadata           JSON: step, config, train_config, val
    <run>/<step>/state/_METADATA             JSON: each leaf's key path
    <run>/<step>/state/manifest.ocdbt, d/, ocdbt.process_0/   the arrays (OCDBT)

The arrays are zarr arrays (zarr v3 where ``_METADATA`` says
``use_zarr3``) in an OCDBT key-value store, one under each leaf's key path
joined by dots (``params.layers.0.row_attn.wq``).  They are read with
``tensorstore``, imported where they are read: ``orbax.checkpoint`` imports
JAX, ``tensorstore`` does not.  Where ``tensorstore`` is missing the read
raises a message that names it and the route around it.
"""

from __future__ import annotations

import json
import pathlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

_COMMITTED = "_CHECKPOINT_METADATA"
_SEQUENCE = 1  # key_type of a list or tuple index in _METADATA; 2 is a dict key


def steps(run_dir) -> List[int]:
    """The committed steps of a JAX run directory, in order ([] if none)."""
    root = pathlib.Path(run_dir)
    if not root.is_dir():
        return []
    return sorted(int(p.name) for p in root.iterdir()
                  if p.name.isdigit() and (p / _COMMITTED).is_file())


def is_orbax_dir(path) -> bool:
    """Whether ``path`` is a run directory of the JAX trainer."""
    return bool(steps(path))


def _tensorstore():
    try:
        import tensorstore
    except ImportError as e:
        raise ImportError(
            "reading the JAX trainer's Orbax checkpoint directories needs the tensorstore "
            "package, which is not installed here; convert the directory with the JAX "
            "package's `pf-ckpt convert DIR out.npz` (or this package's `pf-ckpt-torch "
            "convert` on a host that has tensorstore) and pass the .npz") from e
    return tensorstore


def _step_dir(run_dir, step: Optional[int]) -> Tuple[pathlib.Path, int]:
    found = steps(run_dir)
    if not found:
        raise FileNotFoundError(f"{run_dir}: no committed step of the JAX trainer")
    step = found[-1] if step is None else int(step)
    if step not in found:
        raise FileNotFoundError(f"{run_dir}: no committed step {step} (steps: {found})")
    return pathlib.Path(run_dir) / str(step), step


def read_metadata(run_dir, step: Optional[int] = None) -> Dict[str, Any]:
    """The JSON metadata saved with ``step`` (the latest if None); ``{}``
    where the step saved none."""
    path = _step_dir(run_dir, step)[0] / "metadata" / "metadata"
    return json.loads(path.read_text()) if path.is_file() else {}


def _lists(node):
    """Dicts whose keys are all sequence indices → lists, recursively."""
    if not isinstance(node, dict):
        return node
    if node and all(isinstance(k, int) for k in node):
        return [_lists(node[k]) for k in sorted(node)]
    return {k: _lists(v) for k, v in node.items()}


def read_state(run_dir, step: Optional[int] = None) -> Tuple[Dict[str, Any], int]:
    """``(state, step)``: the tree saved at ``step`` (the latest if None) as
    nested dicts and lists of numpy arrays (optax's named tuples become
    dicts of their fields, tuples lists; empty nodes are left out)."""
    ts = _tensorstore()
    sdir, step = _step_dir(run_dir, step)
    meta = json.loads((sdir / "state" / "_METADATA").read_text())
    driver = "zarr3" if meta.get("use_zarr3") else "zarr"
    base = {"driver": "ocdbt", "base": (sdir / "state").absolute().as_uri()}
    context = ts.Context()
    pending = []
    for entry in meta["tree_metadata"].values():
        if entry["value_metadata"].get("skip_deserialize"):
            continue
        keys = [(int(k["key"]) if k["key_type"] == _SEQUENCE else k["key"])
                for k in entry["key_metadata"]]
        spec = {"driver": driver,
                "kvstore": {**base, "path": ".".join(map(str, keys)) + "/"}}
        pending.append((keys, ts.open(spec, open=True, context=context)))
    reads = [(keys, store.result().read()) for keys, store in pending]
    root: Dict[Any, Any] = {}
    for keys, read in reads:
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = np.asarray(read.result())
    return _lists(root), step
