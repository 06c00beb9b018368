"""Load reference PyTorch checkpoints into the port's parameter trees.

Key schema of the 161-tensor reference state dict::

    model.embedding_block.0.{weight,bias}                 Conv1x1 22→64
    model.attention_blocks.{i}.{row,col}_attention.{k,q,v,out}_proj.{weight,bias}
    model.attention_blocks.{i}.{row,col,ffn}_norm.{weight,bias}
    model.attention_blocks.{i}.ffn.{0,3}.{weight,bias}    Conv1x1 64→256→64
    model.pwFNN.0.{weight,bias}                           Conv1x1 64→1
    model.seq2pair                                        (C(n,2), n) buffer — dropped

Torch Conv2d 1x1 kernels are ``(out, in, 1, 1)`` and Linear weights
``(out, in)``; the port stores ``(in, out)`` so application is ``x @ w``.
Orbax directories are not yet ported; ``.npz`` parameter files load with
:func:`.checkpoint.load_params_npz`.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import torch

from ..models.params import Params, PhyloformerConfig


def _lin(state: Dict[str, torch.Tensor], key: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """torch Linear/Conv1x1 -> (w (in, out), b (out,)) fp32."""
    w = state[f"{key}.weight"].to(torch.float32)
    b = state[f"{key}.bias"].to(torch.float32).contiguous()
    if w.ndim == 4:  # Conv2d 1x1: (out, in, 1, 1)
        w = w[:, :, 0, 0]
    return w.t().contiguous(), b


def params_from_state_dict(
    state: Dict[str, torch.Tensor], cfg: PhyloformerConfig
) -> Params:
    p = "model." if any(k.startswith("model.") for k in state) else ""

    def norm(key: str) -> Dict[str, torch.Tensor]:
        return {"scale": state[f"{key}.weight"].to(torch.float32).contiguous(),
                "bias": state[f"{key}.bias"].to(torch.float32).contiguous()}

    def attn(key: str) -> Dict[str, torch.Tensor]:
        out = {}
        for ours, theirs in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                             ("o", "out_proj")):
            out["w" + ours], out["b" + ours] = _lin(state, f"{key}.{theirs}")
        return out

    layers = []
    for i in range(cfg.n_blocks):
        base = f"{p}attention_blocks.{i}"
        w1, b1 = _lin(state, f"{base}.ffn.0")
        w2, b2 = _lin(state, f"{base}.ffn.3")
        layers.append({
            "row_norm": norm(f"{base}.row_norm"),
            "row_attn": attn(f"{base}.row_attention"),
            "col_norm": norm(f"{base}.col_norm"),
            "col_attn": attn(f"{base}.col_attention"),
            "ffn_norm": norm(f"{base}.ffn_norm"),
            "ffn": {"w1": w1, "b1": b1, "w2": w2, "b2": b2},
        })

    ew, eb = _lin(state, f"{p}embedding_block.0")
    hw, hb = _lin(state, f"{p}pwFNN.0")
    return {"embed": {"w": ew, "b": eb}, "layers": layers, "head": {"w": hw, "b": hb}}


def load_pretrained(path: "str | os.PathLike") -> Tuple[Params, PhyloformerConfig, Dict[str, Any]]:
    """Reference ``.ckpt`` → ``(params on the CPU, config, hyper_parameters)``."""
    if os.path.isdir(path) or str(path).endswith(".npz"):
        raise ValueError(
            f"{path}: Orbax directories are not yet ported, see ROADMAP.md; .npz "
            "parameter files load with io.checkpoint.load_params_npz; pass a reference .ckpt")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    hparams = dict(ckpt.get("hyper_parameters") or {})
    cfg = PhyloformerConfig.from_reference_hparams(hparams)
    return params_from_state_dict(ckpt["state_dict"], cfg), cfg, hparams
