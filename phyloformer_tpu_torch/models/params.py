"""Model configuration and parameter trees.

Parameters are nested dicts of fp32 tensors with the JAX package's keys and
channel-last layout: every linear weight is stored ``(in, out)`` so
application is ``x @ w + b``.  The architecture defaults are the published
Phyloformer's: 6 blocks, 4 heads, d=64, dropout 0.0 — 308,449 parameters.

Tree layout::

    {"embed": {"w": (22, d), "b": (d,)},
     "layers": [{"row_norm": {"scale", "bias"},
                 "row_attn": {"wq": (d, H), "bq", "wk": (d, H), "bk",
                              "wv": (d, d), "bv", "wo": (d, d), "bo"},
                 "col_norm": ..., "col_attn": ..., "ffn_norm": ...,
                 "ffn": {"w1": (d, 4d), "b1", "w2": (4d, d), "b2"}}, ...],
     "head": {"w": (d, 1), "b": (1,)}}
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch


MATMUL_PRECISIONS = ("float32", "tensorfloat32", "default")


@dataclasses.dataclass(frozen=True)
class PhyloformerConfig:
    n_blocks: int = 6
    n_heads: int = 4
    embed_dim: int = 64
    dropout: float = 0.0
    in_channels: int = 22  # alphabet size
    ln_eps: float = 1e-5
    # Products of the forward kernels: "float32" = three TF32 passes (split
    # TF32, the fp32 bar); "tensorfloat32" and "default" = one TF32 pass.  On
    # the TPU the JAX package runs these two as 3-pass and 1-pass bf16 on the
    # MXU; one TF32 pass is the nearest single form on Hopper, so both map
    # to it.  Inference only: the trainer runs "float32".
    matmul_precision: str = "float32"

    def __post_init__(self):
        if self.matmul_precision not in MATMUL_PRECISIONS:
            raise ValueError(f"matmul_precision={self.matmul_precision!r}: expected one of "
                             f"{MATMUL_PRECISIONS}")

    @property
    def ffn_dim(self) -> int:
        return 4 * self.embed_dim

    @classmethod
    def from_reference_hparams(cls, hp: Dict[str, Any]) -> "PhyloformerConfig":
        """Build from a reference checkpoint's ``hyper_parameters`` dict.

        The reference checkpoints store ``nb_blocks/nb_heads/embed_dim`` while
        its constructor takes ``n_blocks/n_heads/h_dim``; both spellings are
        read here.
        """
        def pick(*names, default):
            for n in names:
                if n in hp:
                    return hp[n]
            return default

        return cls(
            n_blocks=int(pick("nb_blocks", "n_blocks", default=6)),
            n_heads=int(pick("nb_heads", "n_heads", default=4)),
            embed_dim=int(pick("embed_dim", "h_dim", default=64)),
            dropout=float(pick("dropout", default=0.0)),
        )


Params = Dict[str, Any]


def _uniform(shape, bound: float, generator: torch.Generator) -> torch.Tensor:
    return (torch.rand(shape, generator=generator, dtype=torch.float32) * 2.0 - 1.0) * bound


def _linear_init(fan_in: int, fan_out: int, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """torch.nn.Linear / 1x1 Conv2d default init: kaiming-uniform (a = √5)
    weights and U(-1/√fan_in, 1/√fan_in) biases, as the JAX package draws
    them (its ``_linear_init``)."""
    bound_w = math.sqrt(6.0 / fan_in) / math.sqrt(2.0)
    w = _uniform((fan_in, fan_out), bound_w, generator)
    return {"w": w, "b": _uniform((fan_out,), 1.0 / math.sqrt(fan_in), generator)}


def _attn_init(cfg: PhyloformerConfig, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    d, h = cfg.embed_dim, cfg.n_heads
    out = {}
    for name, width in (("q", h), ("k", h), ("v", d), ("o", d)):
        lin = _linear_init(d, width, generator)
        out["w" + name], out["b" + name] = lin["w"], lin["b"]
    return out


def _norm_init(cfg: PhyloformerConfig) -> Dict[str, torch.Tensor]:
    return {"scale": torch.ones(cfg.embed_dim), "bias": torch.zeros(cfg.embed_dim)}


def init_params(cfg: PhyloformerConfig, generator: Optional[torch.Generator] = None) -> Params:
    """A fresh parameter tree on the CPU with the distributions of the JAX
    package's ``init_params``, drawn from ``generator`` (default: seed 0).
    The random streams differ from JAX's."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    layers: List[Dict[str, Any]] = []
    for _ in range(cfg.n_blocks):
        row, col = _attn_init(cfg, generator), _attn_init(cfg, generator)
        l1 = _linear_init(cfg.embed_dim, cfg.ffn_dim, generator)
        l2 = _linear_init(cfg.ffn_dim, cfg.embed_dim, generator)
        layers.append({
            "row_norm": _norm_init(cfg), "row_attn": row,
            "col_norm": _norm_init(cfg), "col_attn": col,
            "ffn_norm": _norm_init(cfg),
            "ffn": {"w1": l1["w"], "b1": l1["b"], "w2": l2["w"], "b2": l2["b"]},
        })
    return {"embed": _linear_init(cfg.in_channels, cfg.embed_dim, generator),
            "layers": layers,
            "head": _linear_init(cfg.embed_dim, 1, generator)}


def params_from_numpy(tree: Any, device: Union[str, torch.device] = "cpu") -> Any:
    """Nested dict/list of numpy arrays (the JAX package's parameter tree, or
    any array-likes) → the same tree of fp32 tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    return torch.as_tensor(np.asarray(tree, dtype=np.float32)).to(device)


def map_params(fn, tree: Any) -> Any:
    """Apply ``fn`` to every tensor leaf of a parameter tree."""
    if isinstance(tree, dict):
        return {k: map_params(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_params(fn, v) for v in tree]
    return fn(tree)


def count_params(params: Params) -> int:
    sizes = []
    map_params(lambda t: sizes.append(int(t.numel())), params)
    return sum(sizes)
