"""Batched, bucketed inference engine.

Alignments are padded into a small set of (n, L) buckets (masked, so padding
is an exact no-op), batched under a token budget, and run through the
pipelined forward of :mod:`..ops.kernels.pipeline` where it serves the
bucket (up to 1024 sites at ``matmul_precision="float32"``, 2048 at the
reduced precisions), else through the fused forward
(:func:`..models.phyloformer.forward_fused`, L-tiled above 1024 sites).  On
``cuda`` both always run the hand-written kernels; on ``cpu`` they run
their plain PyTorch versions.

``matmul_precision`` "float32" runs the kernels' products in three TF32
passes (the fp32 bar); "tensorfloat32" and "default" run them in one
(:mod:`..models.params`).  ``pipeline_act_dtype`` stores x1 between the
pipeline's kernels as fp32 or bf16 (compute stays fp32), and
``pipeline_gelu`` picks the pipeline's FFN activation; the fused forward
keeps fp32 storage and exact GELU, as in the JAX package.

``precision="bfloat16"`` rounds the parameters to bf16, as the JAX engine
casts them.  On the kernel route the pipeline then takes JAX's bf16 stages
(the embedding and block 0's pair sum and row LayerNorm at bf16, the rest
fp32: :class:`..ops.kernels.pipeline.PipelineWeights`).  The fused forward
(above the pipeline's site limit, ``use_pipeline=False``, or sharded over
pairs) refuses bf16 parameters: the JAX package's own fused forward raises
on them (``phyloformer_tpu/ops/pallas/axial_block.py:276`` stores kernel A's
fp32 x1 into a bf16 output), so there is no reference to hold such a route
against.  ``use_kernels=False`` (JAX's ``use_pallas=False``)
runs the eager model (:func:`..models.phyloformer.forward`) on the engine's
device, in bf16 throughout at ``precision="bfloat16"``, with PyTorch's fp32
products in one TF32 pass unless ``matmul_precision`` is "float32".

:class:`ShardedInferenceEngine` runs over a ``torch.distributed`` mesh of
ranks (:mod:`..parallel.mesh`): the batch over its data axis, and with a
pair axis the pair activations split over the ranks of a pair row.
"""

from __future__ import annotations

import dataclasses
import time
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.fasta import Alignment
from ..data.pairs import n_pairs, pair_indices
from ..device import resolve_device, tf32_products
from ..models.params import MATMUL_PRECISIONS, Params, PhyloformerConfig, map_params
from ..models.phyloformer import forward, forward_fused
from ..ops.kernels import _build
from ..ops.kernels.axial_block import GELU_MODES
from ..ops.kernels.pipeline import (
    ACT_DTYPES,
    PipelineWeights,
    forward_fused_pipeline,
    pipeline_supported,
)
from ..ops.kernels.sharded import forward_fused_sharded, pair_shard
from ..parallel.mesh import Mesh, batch_slice
from ..spans import setup_span, span

# The parameters' type by the JAX engine's ``precision`` name.
PRECISIONS = {"float32": torch.float32, "bfloat16": torch.bfloat16}

DEFAULT_N_BUCKETS = (10, 20, 30, 40, 50, 60, 80, 100, 120, 150, 200)
DEFAULT_L_BUCKETS = (128, 256, 384, 512, 640, 768, 1024, 1280, 1536, 2048,
                     3072, 4096)


@dataclasses.dataclass(frozen=True)
class InferenceConfig:
    n_buckets: Tuple[int, ...] = DEFAULT_N_BUCKETS
    l_buckets: Tuple[int, ...] = DEFAULT_L_BUCKETS
    # Max activation tokens (B * P * L) per device batch: 2^22 tokens * 64
    # channels * 4 B = 1 GiB per fp32 activation tensor.
    max_batch_tokens: int = 1 << 22
    max_batch_size: int = 64
    precision: str = "float32"  # parameter dtype: "float32" | "bfloat16"
    # Products: "float32" = three TF32 passes; "tensorfloat32" | "default" =
    # one TF32 pass (final distance error ~1e-3 relative, the bench gate).
    matmul_precision: str = "float32"
    pipeline_act_dtype: str = "float32"  # x1 between the pipeline's kernels: | "bfloat16"
    # FFN activation on the pipeline: "exact" (erf) | "tanh" | "sigmoid" |
    # "relu", at either storage
    pipeline_gelu: str = "exact"
    # Pipelined kernels (merged block boundaries, in-kernel pair gather and
    # head).  None = where pipeline_supported holds for the bucket, else the
    # fused forward (exact GELU); True / False force one or the other.
    use_pipeline: Optional[bool] = None
    allow_oversize: bool = True  # n/L beyond the last bucket: exact shape
    # Round batch sizes up to powers of two (padding rows are masked no-ops).
    pad_batch_sizes: bool = False
    # The hand-written kernels (True; JAX's use_pallas) or the eager model.
    use_kernels: bool = True


def _no_bf16_reference(route: str) -> ValueError:
    return ValueError(
        f"precision='bfloat16' on {route}: the JAX package's own fused forward raises on "
        f"bf16 parameters (phyloformer_tpu/ops/pallas/axial_block.py:276 stores an fp32 x1 "
        f"into a bf16 output), so the port has no reference to hold this route against; "
        f"the pipeline (up to 1024 sites, 2048 at one TF32 pass) and the eager route "
        f"(use_kernels=False) run bf16 parameters")


def _bucketize(value: int, buckets: Sequence[int], allow_oversize: bool) -> int:
    for b in buckets:
        if value <= b:
            return b
    if allow_oversize:
        return value
    raise ValueError(f"value {value} exceeds largest bucket {buckets[-1]}")


@lru_cache(maxsize=None)
def real_pair_selector(pad_n: int, n: int) -> np.ndarray:
    """Indices into the padded pair axis that correspond to real pairs,
    in the real upper-triangle order."""
    i_idx, j_idx = pair_indices(pad_n)
    return np.nonzero((i_idx < n) & (j_idx < n))[0]


class InferenceEngine:
    """Runs Phyloformer forward passes over many alignments.

    ``device``: ``None`` or ``"cuda"`` runs the CUDA kernels (the eager
    model with ``use_kernels=False``) and raises without a card; ``"cpu"``
    runs the plain PyTorch versions (or the eager model).
    """

    def __init__(
        self,
        params: Params,
        cfg: PhyloformerConfig,
        icfg: Optional[InferenceConfig] = None,
        device=None,
    ):
        with setup_span("setup.engine"):
            self._init(params, cfg, icfg, device)

    def _init(self, params, cfg, icfg, device) -> None:
        self.device = resolve_device(device)
        self.icfg = icfg or InferenceConfig()
        if self.icfg.precision not in PRECISIONS:
            raise ValueError(f"precision={self.icfg.precision!r}: expected one of "
                             f"{tuple(PRECISIONS)}")
        if self.icfg.matmul_precision not in MATMUL_PRECISIONS:
            raise ValueError(f"matmul_precision={self.icfg.matmul_precision!r}: "
                             f"expected one of {MATMUL_PRECISIONS}")
        if self.icfg.pipeline_act_dtype not in ACT_DTYPES:
            raise ValueError(f"pipeline_act_dtype={self.icfg.pipeline_act_dtype!r}: "
                             f"expected one of {tuple(ACT_DTYPES)}")
        if self.icfg.pipeline_gelu not in GELU_MODES:
            raise ValueError(f"pipeline_gelu={self.icfg.pipeline_gelu!r}: "
                             f"expected one of {GELU_MODES}")
        if cfg.matmul_precision != self.icfg.matmul_precision:
            cfg = dataclasses.replace(cfg, matmul_precision=self.icfg.matmul_precision)
        self.cfg = cfg
        # the JAX engine's rule: fp32-grade products, or one pass otherwise
        self.mxu_precision = "highest" if cfg.matmul_precision == "float32" else "default"
        self.set_params(params)
        # host seconds: building the kernels, in predict; counts: batches,
        # alignments, and the pair-sites of the alignments against those the
        # batches launched (their padded shapes)
        self.stats = {"compile_s": 0.0, "predict_s": 0.0, "batches": 0, "alignments": 0,
                      "pair_sites_real": 0, "pair_sites_padded": 0}

    def set_params(self, params: Params) -> None:
        """Run on ``params`` from now on, a tree of the same architecture:
        the engine, its device and its loaded kernels are kept."""
        dtype = PRECISIONS[self.icfg.precision]
        # to fp32 first, so that every precision rounds from the same values
        params = map_params(lambda t: t.to(self.device, torch.float32).to(dtype), params)
        # the eager route reads the tree, the kernel route its arrangement
        self.params = None if self.icfg.use_kernels else params
        self.weights = PipelineWeights.from_params(params) if self.icfg.use_kernels else None

    def load_kernels(self) -> None:
        """Build (if needed) and load the kernel library now, where this
        engine runs the kernels on the card; otherwise nothing.  Its first
        ``predict`` calls this too."""
        if self.icfg.use_kernels and self.device.type == "cuda":
            t = time.perf_counter()
            _build.load()
            self.stats["compile_s"] += time.perf_counter() - t

    # -- batching ------------------------------------------------------------
    def _plan(self, alns: Sequence[Alignment]):
        """Group alignment indices into (pad_n, pad_l) buckets, then chunk
        into batches under the token budget."""
        groups: Dict[Tuple[int, int], List[int]] = {}
        for idx, a in enumerate(alns):
            pad_n = _bucketize(a.n_seqs, self.icfg.n_buckets, self.icfg.allow_oversize)
            pad_l = _bucketize(a.seq_len, self.icfg.l_buckets, self.icfg.allow_oversize)
            groups.setdefault((pad_n, pad_l), []).append(idx)

        batches = []
        for (pad_n, pad_l), idxs in sorted(groups.items()):
            tokens_per = n_pairs(pad_n) * pad_l
            bsz = max(1, min(self.icfg.max_batch_size,
                             self.icfg.max_batch_tokens // max(tokens_per, 1)))
            if self.icfg.pad_batch_sizes and bsz > 1:
                # round down so the pad-up of partial chunks stays in budget
                bsz = 1 << (bsz.bit_length() - 1)
            for start in range(0, len(idxs), bsz):
                batches.append(((pad_n, pad_l), idxs[start : start + bsz]))
        return batches

    def _padded_bsz(self, n: int) -> int:
        """Rows of a batch of ``n`` alignments: ``n``, or with
        ``pad_batch_sizes`` the next power of two (padding rows are masked
        no-ops)."""
        return 1 << (n - 1).bit_length() if self.icfg.pad_batch_sizes else n

    def _batch_inputs(self, alns, pad_n, pad_l, idxs):
        bsz = self._padded_bsz(len(idxs))
        codes = np.zeros((bsz, pad_n, pad_l), dtype=np.int32)
        site_mask = np.zeros((bsz, pad_l), dtype=bool)
        seq_mask = np.zeros((bsz, pad_n), dtype=bool)
        for row, idx in enumerate(idxs):
            a = alns[idx]
            codes[row, : a.n_seqs, : a.seq_len] = a.codes
            site_mask[row, : a.seq_len] = True
            seq_mask[row, : a.n_seqs] = True
        return tuple(torch.from_numpy(t).to(self.device)
                     for t in (codes, site_mask, seq_mask))

    def predict(self, alns: Sequence[Alignment]) -> List[np.ndarray]:
        """Predict distance vectors for every alignment: one float32 array of
        shape ``(C(n_i, 2),)`` per input, in input order.  All batches are
        queued on the device before any result is copied back."""
        out: List[Optional[np.ndarray]] = [None] * len(alns)
        with span("engine.predict", alignments=len(alns)):
            with span("engine.plan"):
                plan = self._plan(alns)
            if self.stats["batches"] == 0:
                self.load_kernels()
            t0 = time.perf_counter()
            pending = []
            with torch.inference_mode():
                for (pad_n, pad_l), idxs in plan:
                    # each alignment once: a data mesh repeats an index to fill its ranks
                    real = sum(n_pairs(alns[i].n_seqs) * alns[i].seq_len
                               for i in dict.fromkeys(idxs))
                    padded = self._padded_bsz(len(idxs)) * n_pairs(pad_n) * pad_l
                    with span("engine.batch", alignments=len(idxs), real_pair_sites=real,
                              padded_pair_sites=padded):
                        codes, site_mask, seq_mask = self._batch_inputs(alns, pad_n, pad_l, idxs)
                        preds = self._forward(codes, site_mask, seq_mask, pad_n, pad_l)
                    pending.append((pad_n, idxs, preds))
                    self.stats["batches"] += 1
                    self.stats["alignments"] += len(idxs)
                    self.stats["pair_sites_real"] += real
                    self.stats["pair_sites_padded"] += padded
                with span("engine.readback"):
                    for pad_n, idxs, preds in pending:
                        preds = preds.cpu().numpy()  # waits for the device
                        for row, idx in enumerate(idxs):
                            sel = real_pair_selector(pad_n, alns[idx].n_seqs)
                            out[idx] = preds[row, sel].astype(np.float32)
            self.stats["predict_s"] += time.perf_counter() - t0
        return out  # type: ignore[return-value]

    def _forward(self, codes, site_mask, seq_mask, pad_n: int, pad_l: int) -> torch.Tensor:
        """One batch's ``(B, P)`` distances on the configured route."""
        if not self.icfg.use_kernels:
            with tf32_products(self.cfg.matmul_precision != "float32"):
                return forward(self.params, codes, self.cfg, site_mask, seq_mask).float()
        pipeline = self.icfg.use_pipeline
        if pipeline is None:
            pipeline = pipeline_supported(pad_n, pad_l, self.mxu_precision)
        if pipeline:
            return forward_fused_pipeline(
                self.weights, codes, site_mask, seq_mask, eps=self.cfg.ln_eps,
                gelu_mode=self.icfg.pipeline_gelu, mxu_precision=self.mxu_precision,
                act_dtype_name=self.icfg.pipeline_act_dtype)
        if self.icfg.precision != "float32":
            raise _no_bf16_reference(f"the fused forward ({pad_l} sites)")
        return forward_fused(self.weights, codes, self.cfg, site_mask, seq_mask)

    def predict_one(self, aln: Alignment) -> np.ndarray:
        return self.predict([aln])[0]


class ShardedInferenceEngine(InferenceEngine):
    """Inference over a :class:`..parallel.mesh.Mesh` of ranks: the batch
    over its ``data`` axis and, for alignments whose pair axis outgrows one
    card, the activation pair axis over its ``pair`` axis.  Every rank
    calls :meth:`predict` with the same alignments and gets every result.

    The routes are the JAX engine's: with ``pair`` > 1 the kernels run
    :func:`..ops.kernels.sharded.forward_fused_sharded` (kernel A per pair
    shard, the stats all-reduced over the pair row, kernel B local) and
    ``use_kernels=False`` the eager model on its pair shard
    (:func:`..models.phyloformer.forward` with ``shard``, the counterpart of
    JAX's ``act_sharding``).  Otherwise each rank runs the single-card route
    (the pipeline or the fused forward, or the eager model) on its rows of
    the batch; JAX runs XLA there because a Pallas call does not partition
    under GSPMD, a limit of its toolchain, not of the function.  The results
    are gathered over the mesh."""

    def __init__(self, params: Params, cfg: PhyloformerConfig, mesh: Mesh,
                 icfg: Optional[InferenceConfig] = None, device=None):
        super().__init__(params, cfg, icfg, device)
        self.mesh = mesh

    def _plan(self, alns: Sequence[Alignment]):
        """The batches of :meth:`InferenceEngine._plan`, each index list
        rounded up to a multiple of the data axis by repeating its last
        index: the repeats are real forward passes, and ``predict`` writes
        results by index, so they overwrite the same slot."""
        ndata = self.mesh.data
        fixed = []
        for shape, idxs in super()._plan(alns):
            idxs = idxs + idxs[-1:] * (-len(idxs) % ndata)
            fixed.append((shape, idxs))
        return fixed

    def _padded_bsz(self, n: int) -> int:
        """The base rule, then rounded up to a multiple of the data axis."""
        ndata = self.mesh.data
        return -(-super()._padded_bsz(n) // ndata) * ndata

    def _forward(self, codes, site_mask, seq_mask, pad_n: int, pad_l: int) -> torch.Tensor:
        mesh, bsz, p = self.mesh, codes.shape[0], n_pairs(pad_n)
        if mesh.pair > 1 and self.icfg.use_kernels:
            if self.icfg.precision != "float32":
                raise _no_bf16_reference("the pair-sharded fused forward")
            return forward_fused_sharded(self.weights, codes, self.cfg, mesh, site_mask,
                                         seq_mask)[:, :p]
        rows = batch_slice(mesh, bsz)
        if mesh.pair > 1:
            shard = pair_shard(pad_n, mesh, codes.device)
            with tf32_products(self.cfg.matmul_precision != "float32"):
                local = forward(self.params, codes[rows], self.cfg, site_mask[rows],
                                seq_mask[rows], shard=shard).float()
            return mesh.gather(local, bsz, shard.p_pad, pair_sharded=True)[:, :p]
        local = super()._forward(codes[rows], site_mask[rows], seq_mask[rows], pad_n, pad_l)
        return mesh.gather(local, bsz, p, pair_sharded=False)
