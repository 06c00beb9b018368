"""Training checkpoints, and parameter files shared with the JAX package.

- :class:`CheckpointManager`: one ``torch.save`` file per saved step in a
  directory (``ckpt_<step>.pt``: parameters, optimizer state, step and
  metadata), written atomically, with ``latest_step``, ``restore`` and a
  ``max_to_keep`` policy.  It takes the place of the JAX package's Orbax
  manager; the port reads Orbax directories (:mod:`.orbax`), and writes
  only its own.
- :func:`save_params_npz` / :func:`load_params_npz`: a parameter tree as a
  flat ``.npz`` with ``/``-joined keys (``layers/0/ffn/w1``), the JAX
  package's layout, so that either package reads the other's file;
  :func:`_infer_config` reads the architecture off such a tree.
"""

from __future__ import annotations

import os
import pathlib
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.params import PhyloformerConfig

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_cpu(v) for v in tree]
    if torch.is_tensor(tree):
        return tree.detach().cpu().clone()
    return tree


class CheckpointManager:
    """Checkpoints of a training run in ``directory``; ``max_to_keep=None``
    keeps them all."""

    def __init__(self, directory, max_to_keep: Optional[int] = None):
        self.directory = pathlib.Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def path(self, step: int) -> pathlib.Path:
        return self.directory / f"ckpt_{int(step)}.pt"

    def all_steps(self) -> List[int]:
        steps = [int(m.group(1)) for p in self.directory.iterdir()
                 if (m := _NAME.match(p.name))]
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Dict[str, Any], metadata: Optional[Dict] = None) -> None:
        """``state``: ``{"params", "opt_state", "step"}``; an ``opt_state``
        with a ``state_dict`` method is saved through it."""
        opt = state.get("opt_state")
        payload = {
            "params": _to_cpu(state["params"]),
            "opt_state": _to_cpu(opt.state_dict() if hasattr(opt, "state_dict") else opt),
            "step": int(state["step"]),
            "metadata": metadata,
        }
        out = self.path(step)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        torch.save(payload, tmp)
        os.replace(tmp, out)
        if self.max_to_keep:
            for old in self.all_steps()[:-self.max_to_keep]:
                self.path(old).unlink(missing_ok=True)

    def restore(self, step: Optional[int] = None) -> Tuple[Dict[str, Any], int]:
        """The saved ``{"params", "opt_state", "step", "metadata"}`` (on
        the CPU) of ``step`` (default: the latest) and that step."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return torch.load(self.path(step), map_location="cpu", weights_only=True), step

    def restore_metadata(self, step: Optional[int] = None) -> Dict:
        try:
            return self.restore(step)[0].get("metadata") or {}
        except FileNotFoundError:
            return {}

    def close(self) -> None:
        pass


def save_params_npz(path, params: Dict[str, Any]) -> None:
    """Flatten a parameter tree (tensors or arrays) into an ``.npz``."""
    flat = {}

    def rec(prefix, tree):
        if isinstance(tree, dict):
            for k, v in tree.items():
                rec(f"{prefix}/{k}" if prefix else k, v)
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                rec(f"{prefix}/{i}", v)
        else:
            flat[prefix] = (tree.detach().cpu().numpy() if torch.is_tensor(tree)
                            else np.asarray(tree))

    rec("", params)
    np.savez_compressed(path, **flat)


def load_params_npz(path) -> Dict[str, Any]:
    """Inverse of :func:`save_params_npz`: the tree of numpy arrays."""
    root: Dict[str, Any] = {}
    for key, val in dict(np.load(path)).items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def fix_lists(node):
        if isinstance(node, dict):
            keys = list(node.keys())
            if keys and all(k.isdigit() for k in keys):
                return [fix_lists(node[str(i)]) for i in range(len(keys))]
            return {k: fix_lists(v) for k, v in node.items()}
        return node

    return fix_lists(root)


def _infer_config(params: Dict[str, Any]) -> PhyloformerConfig:
    """The architecture of a parameter tree (arrays or tensors), from its
    shapes: the embedding's width, the number of layers and the q
    projection's heads."""
    d = int(params["embed"]["w"].shape[1])
    n_heads = int(params["layers"][0]["row_attn"]["wq"].shape[1])
    return PhyloformerConfig(n_blocks=len(params["layers"]), n_heads=n_heads, embed_dim=d)
