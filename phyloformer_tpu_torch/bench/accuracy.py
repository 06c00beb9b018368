"""Drift of the reduced-precision path against an fp32 oracle by (n, L):
``pf-bench-torch accuracy-grid``, the port of the JAX package's
``bench/accuracy.py``.

At each corner the fast side is the engine at ``matmul_precision=
"tensorfloat32"`` (one TF32 pass), with bf16 storage of x1 between the
pipeline's kernels where fp32 storage would not fit; the oracle is chosen as
JAX chooses it, from the pair-tokens of the corner's bucket:

- ``xla_fp32``: the plain eager fp32 model (JAX: its XLA path), TF32 off
  (:func:`..infer.oracle.predict_fp32_eager`), where its activations fit;
- ``fused_highest``: the engine at ``matmul_precision="float32"`` (three
  TF32 passes, fp32 storage) above that;
- ``fp32_chunked``: the sequential pair-chunked fp32 forward
  (:func:`..infer.oracle.predict_fp32_chunked`) where the fast side stores
  bf16, so the storage rounding is measured there, not cancelled.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data.fasta import Alignment
from ..infer.engine import InferenceConfig, InferenceEngine

# The measurable single-card corners, JAX's grid: up to the reference's
# largest supported shape, 200 tips × 1000 sites.
DEFAULT_GRID: Tuple[Tuple[int, int], ...] = (
    (50, 250), (100, 250), (100, 1000), (200, 250), (200, 1000),
)
# pair-tokens ceiling of the eager fp32 oracle (JAX: of its XLA fp32 path)
XLA_FP32_MAX_TOKENS = 100 * 99 // 2 * 1024
# above this the fast side stores x1 as bf16 and the oracle is the chunked
# fp32 forward
FP32_STORAGE_MAX_TOKENS = 200 * 199 // 2 * 256


def _bucket(n: int, l: int) -> Dict:
    # the envelope's corners land on the 256 / 1024 rungs; the small rungs
    # keep CPU test corners cheap
    if l <= 32:
        lb = 32
    elif l <= 64:
        lb = 64
    else:
        lb = 256 if l <= 250 else 1024
    return dict(n_buckets=(n,), l_buckets=(lb,))


def corner_plan(n: int, l: int) -> Tuple[str, str]:
    """(fast side's storage, oracle name) of one corner, from the pair-tokens
    of the bucket the engines run."""
    buckets = _bucket(n, l)
    pairs_tokens = n * (n - 1) // 2 * buckets["l_buckets"][0]
    act = "bfloat16" if pairs_tokens > FP32_STORAGE_MAX_TOKENS else "float32"
    if pairs_tokens <= XLA_FP32_MAX_TOKENS:
        return act, "xla_fp32"
    return act, "fused_highest" if act == "float32" else "fp32_chunked"


def make_engines(params, cfg, n: int, l: int, device=None):
    """(fast engine, oracle, oracle name) for one grid corner; the oracle is
    an engine (``predict``) or a callable on a list of alignments.  Nothing
    runs here."""
    buckets = _bucket(n, l)
    act, name = corner_plan(n, l)
    fast = InferenceEngine(params, cfg, InferenceConfig(
        matmul_precision="tensorfloat32", pipeline_act_dtype=act,
        max_batch_tokens=1 << 23, **buckets), device=device)
    if name == "fused_highest":
        oracle = InferenceEngine(params, cfg, InferenceConfig(
            matmul_precision="float32", pipeline_act_dtype=act, max_batch_tokens=1 << 23,
            **buckets), device=device)
        return fast, oracle, name

    from ..infer.oracle import predict_fp32_chunked, predict_fp32_eager

    dev = fast.device
    if name == "xla_fp32":
        def oracle(alns):
            return predict_fp32_eager(params, cfg, alns, dev)
    else:
        def oracle(alns):
            return [predict_fp32_chunked(params, a.codes, n_heads=cfg.n_heads, eps=cfg.ln_eps,
                                         device=dev) for a in alns]
    return fast, oracle, name


def _predict(oracle, alns) -> List[np.ndarray]:
    return oracle.predict(alns) if hasattr(oracle, "predict") else oracle(alns)


def drift_grid(
    weights: str,
    grid: Sequence[Tuple[int, int]] = DEFAULT_GRID,
    reps: int = 2,
    seed: int = 0,
    device=None,
    on_row: Optional[Callable[[Dict], None]] = None,
) -> List[Dict]:
    """Fast-vs-oracle drift at each (n, L) on ``reps`` random alignments; one
    row per corner (``on_row`` sees each as it is measured).  A corner that
    fails (out of memory, say) gives an ``error`` row."""
    import torch

    from ..io.ckpt_import import load_pretrained

    params, cfg, _ = load_pretrained(weights)
    rng = np.random.default_rng(seed)
    rows: List[Dict] = []
    for n, l in grid:
        alns = [Alignment(codes=rng.integers(0, 20, (n, l)).astype(np.int8),
                          ids=[f"T{j}" for j in range(n)])
                for _ in range(reps)]
        fast, oracle, oracle_name = make_engines(params, cfg, n, l, device)
        try:
            t0 = time.perf_counter()
            got = fast.predict(alns)
            fast_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            want = _predict(oracle, alns)
            oracle_s = time.perf_counter() - t0
        except Exception as err:  # out of memory at a corner
            row = {"n": n, "L": l, "oracle": oracle_name,
                   "error": f"{type(err).__name__}: {err}"[:200]}
        else:
            abs_err = max(float(np.abs(a - b).max()) for a, b in zip(got, want))
            scale = max(float(np.abs(b).max()) for b in want)
            if scale == 0.0:
                row = {"n": n, "L": l, "oracle": oracle_name,
                       "error": "oracle output identically zero"}
            else:
                row = {"n": n, "L": l, "oracle": oracle_name,
                       "storage": fast.icfg.pipeline_act_dtype, "max_abs_err": abs_err,
                       "rel": abs_err / scale, "fused_s": round(fast_s, 3),
                       "oracle_s": round(oracle_s, 3)}
        del fast, oracle
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        rows.append(row)
        if on_row is not None:
            on_row(row)
    return rows


def check_rows(rows: Sequence[Dict], max_rel: float) -> Tuple[bool, str]:
    """(ok, message): every measured corner within the relative envelope."""
    worst: Optional[Dict] = None
    for r in rows:
        if "error" in r:
            return False, f"corner ({r['n']},{r['L']}) failed: {r['error']}"
        if worst is None or r["rel"] > worst["rel"]:
            worst = r
    if worst is None:
        return False, "no corners measured"
    msg = (f"worst rel drift {worst['rel']:.2e} at "
           f"(n={worst['n']}, L={worst['L']}) vs gate {max_rel:g}")
    return worst["rel"] <= max_rel, msg
