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

:func:`load_pretrained` reads a reference ``.ckpt``, an ``.npz`` parameter
file (either package's), a directory of the port's trainer and one of the
JAX trainer's (Orbax, through :mod:`.orbax`, which needs ``tensorstore``);
:func:`save_reference_checkpoint` writes the reference format back.
"""

from __future__ import annotations

import collections
import os
import pathlib
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..data.pairs import pair_indices
from ..models.params import Params, PhyloformerConfig, params_from_numpy
from ..spans import setup_span
from . import orbax
from .checkpoint import CheckpointManager, _infer_config, load_params_npz


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
    """Model weights from any container the port reads → ``(params on the
    CPU, config, metadata)``:

    - a reference ``.ckpt``: metadata is its ``hyper_parameters``;
    - an ``.npz`` parameter file (:func:`.checkpoint.save_params_npz`, or
      the JAX package's): the config is read off the shapes, metadata ``{}``;
    - a directory of the port's trainer (:class:`.checkpoint.CheckpointManager`):
      the latest step's parameters, the config it saved and
      ``{"step": step, **metadata}``;
    - a run directory of the JAX trainer (Orbax, told by its committed
      ``<step>/`` directories): the same three, as the JAX package's
      ``load_pretrained`` returns them, the config read off the shapes where
      the step saved none.  Raises where ``tensorstore`` is missing.
    """
    with setup_span("setup.weights"):
        return _load_pretrained(path)


def _load_pretrained(path) -> Tuple[Params, PhyloformerConfig, Dict[str, Any]]:
    p = pathlib.Path(path)
    if p.is_dir() and orbax.is_orbax_dir(p):
        state, step = orbax.read_state(p)
        meta = orbax.read_metadata(p, step)
        params = params_from_numpy(state["params"] if "params" in state else state)
        cfg = PhyloformerConfig(**meta["config"]) if meta.get("config") else _infer_config(params)
        return params, cfg, {"step": step, **meta}
    if p.is_dir():
        mgr = CheckpointManager(p)
        if mgr.latest_step() is None:
            raise ValueError(f"{path}: neither a ckpt_<step>.pt of the port's trainer nor a "
                             "committed <step>/ directory of the JAX trainer")
        state, step = mgr.restore()
        meta = state.get("metadata") or {}
        if "config" not in meta:
            raise ValueError(f"{path}: step {step} has no metadata['config']; the port's "
                             "trainer writes one with every checkpoint")
        return state["params"], PhyloformerConfig(**meta["config"]), {"step": step, **meta}
    if p.suffix == ".npz":
        params = params_from_numpy(load_params_npz(p))
        return params, _infer_config(params), {}
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    hparams = dict(ckpt.get("hyper_parameters") or {})
    cfg = PhyloformerConfig.from_reference_hparams(hparams)
    return params_from_state_dict(ckpt["state_dict"], cfg), cfg, hparams


def _f32(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().to("cpu", torch.float32).contiguous()


def _to_conv(w) -> torch.Tensor:
    """(in, out) → torch Conv2d 1x1 ``(out, in, 1, 1)``."""
    return _f32(w).t().contiguous()[:, :, None, None]


def state_dict_from_params(params: Params, cfg: PhyloformerConfig, include_seq2pair: bool = True,
                           seq2pair_n: int = 50) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`params_from_state_dict`: the reference's
    ``model.``-prefixed state dict (160 keys, 161 with the buffer) in torch
    layouts — Conv2d 1x1 ``(out, in, 1, 1)`` for the embedding, FFN and head,
    Linear ``(out, in)`` for the attention projections — and, with
    ``include_seq2pair``, the non-learnable ``model.seq2pair`` buffer
    ``(C(n, 2), n)`` the published checkpoints carry at n = 50."""
    state: Dict[str, torch.Tensor] = collections.OrderedDict()

    def put_norm(key, p):
        state[f"{key}.weight"] = _f32(p["scale"])
        state[f"{key}.bias"] = _f32(p["bias"])

    def put_attn(key, p):
        for ours, theirs in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                             ("o", "out_proj")):
            state[f"{key}.{theirs}.weight"] = _f32(p["w" + ours]).t().contiguous()
            state[f"{key}.{theirs}.bias"] = _f32(p["b" + ours])

    state["model.embedding_block.0.weight"] = _to_conv(params["embed"]["w"])
    state["model.embedding_block.0.bias"] = _f32(params["embed"]["b"])
    for i, layer in enumerate(params["layers"]):
        base = f"model.attention_blocks.{i}"
        put_norm(f"{base}.row_norm", layer["row_norm"])
        put_attn(f"{base}.row_attention", layer["row_attn"])
        put_norm(f"{base}.col_norm", layer["col_norm"])
        put_attn(f"{base}.col_attention", layer["col_attn"])
        put_norm(f"{base}.ffn_norm", layer["ffn_norm"])
        state[f"{base}.ffn.0.weight"] = _to_conv(layer["ffn"]["w1"])
        state[f"{base}.ffn.0.bias"] = _f32(layer["ffn"]["b1"])
        state[f"{base}.ffn.3.weight"] = _to_conv(layer["ffn"]["w2"])
        state[f"{base}.ffn.3.bias"] = _f32(layer["ffn"]["b2"])
    state["model.pwFNN.0.weight"] = _to_conv(params["head"]["w"])
    state["model.pwFNN.0.bias"] = _f32(params["head"]["b"])
    if include_seq2pair:
        i_idx, j_idx = pair_indices(seq2pair_n)
        m = np.zeros((len(i_idx), seq2pair_n), np.float32)
        m[np.arange(len(i_idx)), i_idx] = 1.0
        m[np.arange(len(j_idx)), j_idx] = 1.0
        state["model.seq2pair"] = torch.from_numpy(m)
    return state


def save_reference_checkpoint(path, params: Params, cfg: PhyloformerConfig,
                              include_seq2pair: bool = True) -> None:
    """Write a reference-format ``.ckpt`` with ``torch.save``: ``state_dict``
    (:func:`state_dict_from_params`) and ``hyper_parameters`` in both
    spellings — the published checkpoints' ``nb_blocks/nb_heads/embed_dim``
    and the reference constructor's ``n_blocks/n_heads/h_dim``, which
    swallows unknown names, so a non-default architecture needs the second."""
    torch.save({
        "state_dict": state_dict_from_params(params, cfg, include_seq2pair),
        "hyper_parameters": {
            "nb_blocks": int(cfg.n_blocks), "nb_heads": int(cfg.n_heads),
            "embed_dim": int(cfg.embed_dim), "n_blocks": int(cfg.n_blocks),
            "n_heads": int(cfg.n_heads), "h_dim": int(cfg.embed_dim),
            "dropout": float(cfg.dropout),
        },
    }, path)
