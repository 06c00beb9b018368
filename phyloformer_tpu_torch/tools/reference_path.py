"""The reference pipeline's execution structure, measured on this card.

A PyTorch transcription of the reference's ``infer_alns.py`` execution
pattern, not the port's path (the JAX package's
``tools/reference_path_tpu.py``):

- serial, batch 1: one alignment at a time, copied to the device and its
  distances back to the host each time;
- one-hot ``(22, L, n)`` input and a 1x1 ``Conv2d`` embedding;
- the materialised ``(P, n)`` seq2pair matrix, multiplied with the embedded
  alignment (:func:`..data.pairs.seq2pair_matrix`);
- channel-first ``(1, d, P, L)`` activations, LayerNorm over the channels
  between two transposes, a permute before and after each attention, 1x1
  ``Conv2d`` FFN;
- fp32 with TF32 off (PyTorch's default for matmuls).

Plain PyTorch on purpose: it is the reference's structure, the denominator
beside the engine's kernels on the same card.  Prints one JSON line.

    python -m phyloformer_tpu_torch.tools.reference_path WEIGHTS [--device cpu]

``WEIGHTS`` is anything ``load_pretrained`` reads.  Runs on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

N_TIPS, SEQ_LEN = 60, 250
N_ALIGNMENTS = 64


def reference_params(params, device=None) -> Dict:
    """The port's parameter tree (``x @ w`` layout) in the reference
    modules' layout: ``Conv2d`` weights ``(out, in, 1, 1)`` for the embedding
    and the FFN, ``Linear`` weights ``(out, in)`` for the attention
    projections and the head, LayerNorm ``weight`` / ``bias``."""

    def t(x):
        x = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
        return x.detach().to(device or x.device, torch.float32)

    def conv(w, b):
        return {"weight": t(w).t().contiguous()[:, :, None, None], "bias": t(b)}

    def linear(w, b):
        return {"weight": t(w).t().contiguous(), "bias": t(b)}

    def norm(p):
        return {"weight": t(p["scale"]), "bias": t(p["bias"])}

    def attn(p):
        return {k: linear(p["w" + k], p["b" + k]) for k in ("q", "k", "v", "o")}

    return {
        "embed": conv(params["embed"]["w"], params["embed"]["b"]),
        "layers": [{"row_norm": norm(lay["row_norm"]), "row_attn": attn(lay["row_attn"]),
                    "col_norm": norm(lay["col_norm"]), "col_attn": attn(lay["col_attn"]),
                    "ffn_norm": norm(lay["ffn_norm"]),
                    "ffn1": conv(lay["ffn"]["w1"], lay["ffn"]["b1"]),
                    "ffn2": conv(lay["ffn"]["w2"], lay["ffn"]["b2"])}
                   for lay in params["layers"]],
        "head": linear(params["head"]["w"], params["head"]["b"]),
    }


def _layer_norm(x, p, eps=1e-5):
    """LayerNorm over dim 1 of ``(1, d, P, L)``: transpose, normalise, transpose."""
    xt = x.transpose(1, 3)  # (1, L, P, d)
    return F.layer_norm(xt, xt.shape[-1:], p["weight"], p["bias"], eps).transpose(1, 3)


def _attention(x, p, n_heads):
    """Linear attention over dim -2 of ``(1, A, B, d)``: elu + 1 feature maps,
    q over its mean, k over its sum along the attended axis."""
    q = F.elu(F.linear(x, p["q"]["weight"], p["q"]["bias"])) + 1.0
    k = F.elu(F.linear(x, p["k"]["weight"], p["k"]["bias"])) + 1.0
    v = F.linear(x, p["v"]["weight"], p["v"]["bias"])
    q = q / q.mean(dim=-2, keepdim=True)
    k = k / k.sum(dim=-2, keepdim=True)
    vh = v.reshape(v.shape[:-1] + (n_heads, v.shape[-1] // n_heads))
    ctx = torch.einsum("...ah,...ahd->...hd", k, vh)
    out = torch.einsum("...ah,...hd->...ahd", q, ctx).reshape(v.shape)
    return F.linear(out, p["o"]["weight"], p["o"]["bias"])


def reference_forward(rp, onehot: torch.Tensor, s2p: torch.Tensor, n_heads: int = 4):
    """``(22, L, n)`` one-hot → ``(P,)`` distances with the reference's op
    structure; ``rp`` from :func:`reference_params`, ``s2p`` the ``(P, n)``
    seq2pair matrix."""
    x = F.relu(F.conv2d(onehot[None], rp["embed"]["weight"], rp["embed"]["bias"]))  # (1,d,L,n)
    x = torch.matmul(x, s2p.t())  # (1, d, L, P): the seq2pair product
    x = x.transpose(2, 3)  # (1, d, P, L)
    for lay in rp["layers"]:
        h = _layer_norm(x, lay["row_norm"]).permute(0, 2, 3, 1)  # (1, P, L, d): over sites
        x = x + _attention(h, lay["row_attn"], n_heads).permute(0, 3, 1, 2)
        h = _layer_norm(x, lay["col_norm"]).permute(0, 3, 2, 1)  # (1, L, P, d): over pairs
        x = x + _attention(h, lay["col_attn"], n_heads).permute(0, 3, 2, 1)
        h = _layer_norm(x, lay["ffn_norm"])
        h = F.gelu(F.conv2d(h, lay["ffn1"]["weight"], lay["ffn1"]["bias"]))
        x = x + F.conv2d(h, lay["ffn2"]["weight"], lay["ffn2"]["bias"])
    h = F.linear(x.permute(0, 2, 3, 1), rp["head"]["weight"], rp["head"]["bias"])
    return F.softplus(h)[..., 0].mean(dim=-1)[0]  # (P,)


def random_onehots(rng: np.random.Generator, k: int = None) -> List[np.ndarray]:
    """``k`` (default ``N_ALIGNMENTS``) random ``(22, SEQ_LEN, N_TIPS)``
    one-hot alignments of the 20 amino acids, drawn as the JAX tool draws them."""
    from ..data.fasta import Alignment

    return [Alignment(rng.integers(0, 20, size=(N_TIPS, SEQ_LEN)), []).one_hot_ref_layout()
            for _ in range(N_ALIGNMENTS if k is None else k)]


def run(params, onehots: List[np.ndarray], device) -> Dict:
    """One untimed forward on the first alignment, then each alignment
    serially: to the device, forward, distances to the host.  Returns the
    distances (numpy, one ``(P,)`` a alignment) and the seconds of the loop."""
    from ..data.pairs import seq2pair_matrix
    from ..device import tf32_products

    rp = reference_params(params, device)
    s2p = torch.as_tensor(seq2pair_matrix(onehots[0].shape[2]), device=device)
    preds = []
    with torch.no_grad(), tf32_products(False):
        warm = reference_forward(rp, torch.from_numpy(onehots[0]).to(device), s2p).cpu()
        assert warm.shape == (s2p.shape[0],)
        t0 = time.perf_counter()
        for oh in onehots:
            preds.append(reference_forward(rp, torch.from_numpy(oh).to(device), s2p)
                         .cpu().numpy())
        elapsed = time.perf_counter() - t0
    return {"preds": preds, "seconds": elapsed}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m phyloformer_tpu_torch.tools.reference_path",
                                 description="aln/s of the reference's execution structure")
    ap.add_argument("weights")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)

    from ..device import resolve_device
    from ..io.ckpt_import import load_pretrained

    device = resolve_device(args.device)
    params, _, _ = load_pretrained(args.weights)
    r = run(params, random_onehots(np.random.default_rng(0)), device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(json.dumps({
        "structure": "reference (batch=1 serial, seq2pair matmul, fp32)",
        "device": f"{device} ({name})",
        "aln_per_s": N_ALIGNMENTS / r["seconds"],
        "s_per_aln": r["seconds"] / N_ALIGNMENTS,
        "n_alignments": N_ALIGNMENTS,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
