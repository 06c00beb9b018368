"""fp32 accuracy oracles: the references the reduced-precision paths are
gated against.

- :func:`predict_fp32_chunked`: the sequential pair-chunked full-fp32
  forward, the counterpart of the JAX package's ``infer/oracle.py``.  The
  model's only coupling across pairs is the column-attention sums (Σ_P φk,
  Σ_P φq, Σ_P φk·v per site and block), so one alignment of any pair count
  runs in sequential chunks of the pair axis, two passes a block: pass 1
  (row attention + residual → x1, the column stats summed over the chunks
  in fp32) and pass 2 (column attention finalized from the global stats +
  FFN → x3).  Peak memory is the ``(P, L, d)`` fp32 activations, held as a
  list of chunks (5.1 GB at 200 tips × 1000 sites), plus one chunk of
  temporaries.  The op order within a chunk is the eager model's; only the
  summation order of the three stats differs.
- :func:`predict_fp32_eager`: the plain eager model
  (:func:`..models.phyloformer.forward`) on each alignment at its exact
  shape, where its activations fit on the device.

Both are plain PyTorch (the JAX oracle is XLA code, not a Pallas kernel),
and on the card both run with TF32 off for PyTorch's products and cuDNN
(:func:`..device.tf32_products`), so every product is IEEE fp32.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..data.fasta import Alignment
from ..data.pairs import pair_indices
from ..device import tf32_products
from ..models.params import PhyloformerConfig, map_params
from ..models.phyloformer import embed_alignment, forward
from ..ops.attention import layer_norm, phi, scaled_linear_attention


def _pass1_chunk(x_c: torch.Tensor, layer, n_heads: int, eps: float):
    """Row sub-block + this chunk's column stats.  ``x_c`` ``(Pc, L, d)``.
    Returns ``(x1_c, (k_sum, q_sum, kv))``, stats ``(L, H)``, ``(L, H)``,
    ``(L, H, hd)``."""
    d = x_c.shape[-1]
    hd = d // n_heads
    rn = layer["row_norm"]
    h = layer_norm(x_c, rn["scale"], rn["bias"], eps)
    x1 = x_c + scaled_linear_attention(h, layer["row_attn"], n_heads)

    ca, cn = layer["col_attn"], layer["col_norm"]
    hc = layer_norm(x1, cn["scale"], cn["bias"], eps)
    q = phi(hc @ ca["wq"] + ca["bq"])  # (Pc, L, H)
    k = phi(hc @ ca["wk"] + ca["bk"])
    v = hc @ ca["wv"] + ca["bv"]  # (Pc, L, d)
    v_heads = v.reshape(v.shape[:-1] + (n_heads, hd))
    return x1, (k.sum(dim=0), q.sum(dim=0), torch.einsum("plh,plhd->lhd", k, v_heads))


def _pass2_chunk(x1_c: torch.Tensor, stats, layer, n_heads: int, eps: float,
                 n_pairs: int) -> torch.Tensor:
    """Column attention finalized from the global stats + FFN for one chunk."""
    k_sum, q_sum, kv = stats
    ca, cn = layer["col_attn"], layer["col_norm"]
    hc = layer_norm(x1_c, cn["scale"], cn["bias"], eps)
    q = phi(hc @ ca["wq"] + ca["bq"])  # (Pc, L, H)
    q_mean = q_sum / float(n_pairs)  # (L, H)
    qn = q / q_mean[None]
    ctx = kv / k_sum[..., None]  # (L, H, hd)
    out = torch.einsum("plh,lhd->plhd", qn, ctx).reshape(x1_c.shape)
    x2 = x1_c + (out @ ca["wo"] + ca["bo"])

    ffn, fn = layer["ffn"], layer["ffn_norm"]
    h = layer_norm(x2, fn["scale"], fn["bias"], eps)
    h = F.gelu(h @ ffn["w1"] + ffn["b1"], approximate="none")
    return x2 + (h @ ffn["w2"] + ffn["b2"])


def _head_chunk(x_c: torch.Tensor, head) -> torch.Tensor:
    h = F.softplus((x_c @ head["w"] + head["b"])[..., 0])
    return h.mean(dim=-1)  # (Pc,)


def predict_fp32_chunked(
    params: Dict[str, Any],
    codes: np.ndarray,
    n_heads: int = 4,
    eps: float = 1e-5,
    n_chunks: int = 10,
    device="cpu",
) -> np.ndarray:
    """Full-fp32 distances for one alignment of exact shape (no padding).

    ``codes`` ``(n, L)`` integer alignment codes; ``n_chunks`` pair-axis
    chunks (peak temporary memory ∝ P / n_chunks); ``device`` where it runs
    (the parameters are copied there).  Returns ``(P,)`` float32 distances
    in upper-triangle order."""
    device = torch.device(device)
    params = map_params(lambda t: t.to(device, torch.float32), params)
    n, _ = codes.shape
    i_idx, j_idx = pair_indices(n)
    p = len(i_idx)
    bounds = np.linspace(0, p, n_chunks + 1).astype(int)
    spans = [(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:]) if b > a]

    with tf32_products(False), torch.inference_mode():
        codes_t = torch.as_tensor(np.asarray(codes, np.int32), device=device)
        emb = embed_alignment(params, codes_t[None])[0]  # (n, L, d)
        # the gather-add pair build, one chunk at a time
        chunks = []
        for a, b in spans:
            ii = torch.as_tensor(i_idx[a:b], dtype=torch.long, device=device)
            jj = torch.as_tensor(j_idx[a:b], dtype=torch.long, device=device)
            chunks.append(emb.index_select(0, ii) + emb.index_select(0, jj))

        for layer in params["layers"]:
            stats = None
            for c in range(len(chunks)):
                x1, s = _pass1_chunk(chunks[c], layer, n_heads, eps)
                chunks[c] = x1
                stats = s if stats is None else tuple(acc + new for acc, new in zip(stats, s))
            for c in range(len(chunks)):
                chunks[c] = _pass2_chunk(chunks[c], stats, layer, n_heads, eps, p)

        outs = [_head_chunk(c, params["head"]).cpu().numpy() for c in chunks]
    return np.concatenate(outs).astype(np.float32)


def predict_fp32_eager(params: Dict[str, Any], cfg: PhyloformerConfig,
                       alns: Sequence[Alignment], device="cpu") -> List[np.ndarray]:
    """The plain eager fp32 model on each alignment at its exact shape:
    one ``(C(n, 2),)`` float32 array per alignment."""
    device = torch.device(device)
    params = map_params(lambda t: t.to(device, torch.float32), params)
    out = []
    with tf32_products(False), torch.inference_mode():
        for a in alns:
            codes = torch.as_tensor(np.asarray(a.codes, np.int32), device=device)[None]
            out.append(forward(params, codes, cfg)[0].cpu().numpy().astype(np.float32))
    return out
