"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--reductions | --reduced | --sharded | --sim | --trees]

1. prints the card's name and power limit (nvidia-smi);
2. builds the hand-written CUDA kernels from this checkout's sources (one
   nvcc per source, all in parallel);
3. holds the two slot reductions (``reduce_stats``, ``reduce_partials``) at
   every shape the paths give them, derived from the wrappers' slot rules,
   and at their edges (N = 4999, S = 1, a start 4 bytes into a buffer,
   G = 3) against their ordered twin bit for bit, against
   ``partial.sum(dim=1)`` and against a second run; times each beside
   ``torch.sum``, the twin and the bound (``--reductions``: only this, with
   the rows printed as JSON);
   then counts the tensor-core (HMMA) and fp32 FMA instructions of every
   kernel in the built library (``cuobjdump -sass``; C, D, E and E2 must
   have HMMA), holds every
   kernel of the inference paths against its plain PyTorch version on the
   card (TF32 off for PyTorch; the kernels' own products are split TF32 on
   the tensor cores) and times both with CUDA events, beside the bound of
   the units each uses (the forward kernels: three TF32 passes on the
   tensor cores, with the fp32 SIMT bound for reference):
   - the pipeline's P0, A-only, M and Z at the headline bucket (60 tips,
     256 sites, real pf_mre_r5 weights) and on ragged batches;
   - the fused forward's A and B at the headline bucket, at the training
     shape (4 x 50 tips x 256 sites) and on a 250-site batch (a partial
     64-site tile), each run twice for the same bits; A1, A2 and B at a
     long bucket (60 tips x 1500 sites -> (60, 1536)) and all four on a
     ragged unbucketed pair of alignments of 1100 and 1031 sites;
   - every reduced-precision and activation variant (``VARIANTS``): P0,
     A-only, M and Z at one TF32 pass, at bf16 storage of x1 and at both, M
     and Z with sigmoid and relu at both pass counts and both storage
     types, A, B, A1 and A2 at one pass, at the
     headline bucket, on a ragged batch and at (60, 1536) (the pipeline
     serves up to 2048 sites at one pass), each twice for the same bits,
     against its plain twin (operands rounded to TF32 and x1 to bf16 as the
     kernels round them; one-pass and bf16 bars: ``ONE_PASS_TOL``,
     ``ONE_PASS_P999``, one bf16 ulp), timed beside the three-pass fp32
     kernel on the same inputs (``--reduced``: only the reduced-precision
     phases, those of 5 and 6 to 10 included);
4. drives the main path through the CLI (``pf-infer`` with ``--trees
   --fastme --stats``) on synthetic FASTA files made with numpy from a seed,
   up to 3000 sites, so that buckets up to 1024 sites run the pipeline and
   longer ones the L-tiled A1/A2/B; checks the launch counts, the finiteness
   of every distance and their agreement with the plain eager model run on
   the card;
5. drives the two-kernel fused forward (``InferenceConfig(use_pipeline=
   False)``, kernels A and B) through the engine on the 60 x 250 set, with
   the same checks, and its throughput beside the pipeline's; then the
   bench's fast path (``matmul_precision="tensorfloat32"``, tanh GELU) at
   fp32 and at bf16 storage on the same set (launches, aln/s, distances
   against the plain fp32 model within ``GATE``, also on related 60 x 250
   alignments), 60 x 1500 at one pass through the pipeline against the
   plain model, and ``pf-bench-torch accuracy-grid`` at its five default
   corners (worst relative drift within ``GRID_MAX_REL``);
6. holds the fused backward's kernels C, D and E against their plain
   versions on the residuals of the fused forward (real weights, a seeded
   cotangent) at the training shape 4 x 50 tips x 256 sites and on a ragged
   batch, checks that two runs give the same bits (of D, and of the block
   backward), and times them (split TF32 on the tensor cores, against three
   TF32 passes, with the fp32 SIMT bound beside); then each at one TF32
   pass against its one-pass plain version (every output and weight
   gradient, ``ONE_PASS_TOL`` and ``ONE_PASS_P999``, the same bits twice),
   timed beside its one-pass bound;
7. holds the L-tiled row backward's kernels E1 and E2 (above 1024 sites)
   against their plain versions at the (50, 1536) training bucket and on a
   ragged batch (E1 also against its factored twin), E1 + E2 against kernel
   E at 1024 sites, and two runs of E1, of E2 and of the long block backward
   against each other; times E1 (beside its bytes bound) and E2 (against
   three TF32 passes), C and D at 2 x 1225 x 1536 and E at 1024 sites; then
   C, D and E2 there at one pass against their one-pass plain versions,
   and E1 at one pass against its three-pass bits;
8. drives training through the CLI (``pf-train-torch --base-model
   pf_mre_r5.ckpt --batch-size 4 --loss mre --max-steps 8``) on a synthetic
   corpus of random trees and matching 50-tip alignments, then resumes it
   for 4 more steps; checks the launch counts, the losses, the metrics file
   and the checkpoints; runs the same 8 steps at ``--matmul-precision
   default`` (one TF32 pass in every kernel) and holds each step's loss to
   the fp32 run's (``TRAIN_ONE_PASS_LOSS_TOL``), with the launch counts;
9. holds one step's loss and gradients through the kernels against plain
   eager fp32 autograd on the card, at 1 x 50 x 256, at fp32 and at
   "default" (``STEP_ONE_PASS_TOL``), and times the training step at both
   (ms per step, examples per second, peak memory, three steps traced with
   ``torch.profiler``: device time by kernel, busy share);
10. drives training on long alignments: a synthetic corpus in the
   (50, 1536) bucket packed with ``pf-preprocess-torch``, ``pf-train-torch
   --packed-data --batch-size 2`` for 4 steps and a validation (launch
   counts, losses), the step's time, peak memory and profile at 2 x 50 x
   1536 at fp32 and at "default", ``--profile`` (10 traced steps), and one
   step against plain eager fp32 autograd at 1 x 20 x 1100 sites at both
   precisions;
11. serving and the checkpoint lifecycle: ``pf-ckpt-torch export`` of
   pf_mre_r5.ckpt and ``convert`` of the export to ``.npz``, each loading
   back bit-equal; ``pf-infer-torch`` on phase 8's checkpoint directory,
   its PHYLIP text equal to that of the engine on the restored parameters;
   ``pf-serve-torch``'s server built by ``serve.cli.build_server`` (port 0,
   its default flags: one TF32 pass, the kernels) answering a warm-up
   request, then 24 concurrent requests (16 related 60 x 250 alignments, 8
   ragged ones of 20-50 tips and 100-600 sites as FASTA and JSON bodies) and
   ``?format=phylip``, ``?tree=nj`` and ``?tree=bme``, and the same burst at
   ``--precision float32``: every answer equal to the engine replaying the
   micro-batch it was served in (``KERNEL_TOL``), within ``KERNEL_TOL``
   (three passes) or ``ONE_PASS_TOL`` (one) of an in-process engine given
   all 24 at once (an answer depends on its batch-mates through the batch
   size, which sets the column stats' order of summation), within ``GATE``
   of the plain fp32 model; fewer batches than requests, P0 or A-only, M
   and Z launched; requests/s and p50/p99 latency; the engine at
   ``precision="bfloat16"`` on the kernel route against its plain twins on
   the card (``BF16_TWIN_TOL``), the eager route at fp32 and bf16 (no
   kernel launched; bf16 within ``EAGER_BF16_ULPS`` of the same route on
   the CPU, fp32 beyond it), each route's aln/s and error against the plain
   fp32 model;
12. the ('data', 'pair') mesh on ``torch.distributed`` (``--sharded``: only
   this): every kernel of the sharded paths against its plain version at
   pair-shard shapes (local P with a padding pair, the global pair count),
   and kernel B on a shard of a 200 x 1000 alignment from the global stats
   timed (the row of ``sharded.py:_kernel_b_host``); then two worker ranks
   of this script on the card over gloo (NCCL refuses two ranks on one
   device: the collectives are staged through the host, so the numbers
   measure correctness and overheads, not scaling):
   ``ShardedInferenceEngine`` at data 1 x pair 2 on one related 200 x 1000
   alignment, one 40 x 1100 and a ragged pair with a padding pair, against
   the single-process two-kernel forward (``SHARD_TOL``; both ranks the
   same bits; aln/s and the bytes all-reduced, read from the tensors the
   ranks reduce), at data 2 x pair
   1 on 16 of the 60 x 250 alignments against the single-card engine, and
   one sharded training step (``make_train_step(mesh=..., shard_pairs)``)
   at 4 x 50 x 256 and 2 x 50 x 1536 against the single-process fused step
   (loss ``SHARD_TOL``, every gradient leaf ``SHARD_GRAD_TOL`` of its own
   largest magnitude; C, D, E or E1, E2 launched on each rank), and the
   first with A1 left unreduced, which must break the gradient bar; beside
   them ``pf-infer-torch --distributed-init --mesh-data 1`` at world size 1
   over nccl; then ``pf-serve-torch --distributed-init gloo --mesh-pair 2``
   as two ranks, a burst of 8 requests answered within ``ONE_PASS_TOL`` of
   the unsharded server's;
13. the simulators (``--sim``: only this, no kernel built; plain
   PyTorch, no kernel of their own): ``pf-simulate-trees-torch`` (1024
   birth-death trees of 50 tips), ``pf-simulate-alignments-torch --engine
   device --gamma GC --batch-size 256`` on them at 500 sites, twice at one
   seed (every file written 50 x 500 with distinct rows; the trees left
   out named by the failure summary, each after 20 attempts with duplicate
   rows, the reference's rule; the same bytes twice and as the engine
   called alone), with aln/s with and without the FASTA writes, peak
   memory and the device's busy share of one batch (``torch.profiler``);
   the duplicate rate on 128 of the trees x 8 attempts against JAX's
   engine's (``WITNESS_JAX``), which also bounds the failed share; ``--engine
   native`` on 32 of them for its aln/s; a two-class ``--mdef`` mixture on
   256 (composition within ``COMPOSITION_TOL``); the engine's mean
   p-distance at t = 0.3 over 64 x 6000 sites against the analytic LG
   value and the topology signal on four tips; 10^6 Gumbel-argmax draws on
   the card's generator; duplicate rejection on a zero-length tree (every
   attempt fails, the CLI's failure summary);
   ``pf-simulate-coevolution-torch`` on 4 trees;
14. the tree toolkit end to end (``--trees``: only this, after the build):
   64 birth-death trees of 50 tips (``pf-simulate-trees-torch``, seed
   1234) and 500-site LG alignments evolved on them on the card
   (``--engine device``; those that pass the duplicate check), then
   ``pf-bench-torch pipeline pf_mre_r5.ckpt`` on the kernel route (its
   launches those of the engine's plan) and on the eager fp32 route (TF32
   off, no launch): each exits 0 and writes model_load, data_load,
   inference and a fastme and a compare row per alignment, ``mean_kf``
   finite, the two routes' distances within ``DIST_TOL``, their trees of
   another topology in at most ``TREES_MAX_FLIPS``; printed without a bar:
   the inference stage's aln/s, ms a tree of fastme and compare, mean KF
   and normalised RF of the Phyloformer trees and of
   ``hamming_fastme_tree`` (Poisson) on the same alignments; then the host
   CLIs on the kernel route's matrices, each exiting 0:
   ``pf-tree-torch fastme-dir -j 4`` (the pipeline's trees) and
   ``compare`` (its KF), ``mlrefine`` and ``likelihood`` on 2 alignments,
   ``pf-msa-torch stats`` and ``dedup``, ``pf-bench-torch report`` (the
   pipeline's mean KF);
15. prints the ``kernels`` JSON line (with the row of ``_kernel_b_host``)
   and the throughputs, then, as its last line, ``{"ok": true, "device":
   {...}}``.

Any failed phase exits non-zero before the last line.  Nothing falls back to
the CPU or to a plain version.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, "artifacts", "pf_mre_r5.ckpt")
WORK = os.path.join(ROOT, "runs", "chip_smoke")  # git-ignored
SEED = 1234

# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, dense
# TF32 on the tensor cores, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12
# The forward kernels (P0, A-only, A, M, Z, A1, A2, B) and the backward's C,
# D, E and E2 run their products on the tensor cores in split TF32: three
# passes, so the card does 3x the products' FLOPs.  Every bound counts the
# TPU kernel's function at three such passes, whatever a kernel runs.
TF32_PASSES = 3
# Matmul FLOPs per pair-site: kernel A = 7 d x d products (A1 3 of them, A2
# the other 4 and the q projection again: 5), kernel B = 2 d x d + 2 d x 4d
# products, the head one d-vector.
D = 64
FLOPS_A = 7 * 2 * D * D
FLOPS_A1 = 3 * 2 * D * D
FLOPS_A2 = 5 * 2 * D * D
FLOPS_B = 2 * 2 * D * D + 2 * 2 * D * 4 * D
FLOPS_HEAD = 2 * D
# Backward products per pair-site, the JAX kernels' functions: C = 5 d x 4d +
# 3 d x d + 1 d x H, D = 4 d x d + 6 d x H, E = 5 d x d + 6 d x H.
H = 4
FLOPS_C = 5 * 2 * D * 4 * D + 3 * 2 * D * D + 2 * D * H
FLOPS_D = 4 * 2 * D * D + 6 * 2 * D * H
FLOPS_E = 5 * 2 * D * D + 6 * 2 * D * H
# E1 = the TPU function's q, k (d x H), v and d_attn (d x d) products; E2
# does E's.  E1's bytes (x and g1, 512 B a pair-site) bind it all the same:
# its kernel sums the sites into d x H matrices first and does about
# 2.6 kFLOP a pair-site, fewer than counted here.
FLOPS_E1 = 2 * 2 * D * D + 2 * 2 * D * H
# Tolerances, relative to the reference's largest magnitude (max(1, max|ref|)):
# fp32 sums taken in another order (tiles, blocks, one-pass ctx = Σk·v/Σk).
KERNEL_TOL = 2e-5
# E1's row sums and E2's gx against their plain versions, and E1 + E2
# against kernel E: the sums over a row are taken in another order.
E12_TOL = 1e-5
# Weight gradients of C, D and E sum over every pair-site of the batch
# (1.25 M at the training shape) in another order than the plain versions.
GRAD_TOL = 1e-4
# One training step through the kernels against plain eager autograd.
STEP_LOSS_TOL = 1e-5
STEP_GRAD_TOL = 1e-4
# The same at one TF32 pass (the trainer's "default"), against plain fp32
# autograd: the gate scale of the JAX fast path (bench.py), on the loss
# (relative) and on every leaf (of max(1, max|ref|)).
STEP_ONE_PASS_TOL = 6e-3
# pf-train-torch --matmul-precision default against the fp32 run, step by
# step on the same batches: each loss within 1e-2 relative.
TRAIN_ONE_PASS_LOSS_TOL = 1e-2
# Distances after 6 blocks against the plain eager model on the card.
DIST_TOL = 1e-4
# The reduced-precision variants against their plain twins (which round
# every product's operands to TF32 as the kernels do, and x1 to bf16): one
# TF32 pass leaves the fp32 bar where an operand computed in another order
# lands on the other side of a TF32 rounding boundary (a flip: 2^-10 of the
# operand), and in M a flip in kernel B reaches a whole row through the row
# sums.  The twin on the card and on the CPU (two fp32 orders) differ by as
# much as kernel and twin do (kernel A: 1.84e-4 both, on an H100 at 700 W).
# ONE_PASS_TOL bounds the largest error (measured at most 7.6e-4, M),
# ONE_PASS_P999 the 99.9th percentile (at most 1.2e-4).  x1 stored as bf16
# lies within one bf16 ulp plus the variant's fp32 bar of its twin.
ONE_PASS_TOL = 2e-3
ONE_PASS_P999 = 5e-4
# The fast path against the plain fp32 model: bench.py's gate, max-abs on
# distances of related sequences (where it was calibrated), relative to
# max(1, max|ref|) on random ones; the drift grid's gate (the JAX CLI's
# --max-rel default).
GATE = 6e-3
GRID_MAX_REL = 0.01
# The engine at precision "bfloat16" (kernel route, three passes) against
# its plain twins on the card, relative to max(1, max|ref|): the CPU tests'
# bar for the same route against JAX (tests/test_torch_serve.py).
BF16_TWIN_TOL = 5e-5
# The eager route at bf16 on the card against the same route on the CPU, on
# the first EAGER_CPU_ALNS alignments, in bf16 ulps of max|ref|: the CPU
# tests' bar for that route against JAX's XLA route, which the eager fp32
# route exceeds (tests/test_torch_serve.py).
EAGER_BF16_ULPS = 2
EAGER_CPU_ALNS = 2
# The slot reductions are timed over this many back-to-back launches.  A
# partial of at most L2_MB stays in the 50 MB L2 between its producer and
# the reduction, as on the paths, so a share of the HBM bound above 100%
# there is reported as L2-resident.
REDUCE_LAUNCHES = 20
L2_MB = 50.0


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def gpu_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if res.returncode != 0 or not res.stdout.strip():
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def errors(got, want):
    """(max abs error, max abs error over max(1, max|want|))."""
    want = want.double()
    err = (got.double() - want).abs().max().item()
    return err, err / max(1.0, want.abs().max().item())


def time_ms(fn, setup=None, reps=5) -> float:
    """Median CUDA-event time of fn() over reps runs after one warm-up;
    setup() runs before each, outside the timed window."""
    import torch

    times = []
    for r in range(reps + 1):
        args = setup() if setup else ()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        torch.cuda.synchronize()
        if r:
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def summarize(name, r, tol, where, card) -> bool:
    """Fold a kernel's error lists into its maxima, print them, and say
    whether they hold: outputs to tol, weight gradients (where the kernel
    has any) to GRAD_TOL."""
    errs = r["errs"] + r.get("grad_errs", [])
    r["max_abs_err"] = max(e[0] for e in errs)
    r["max_rel_err"] = max(e[1] for e in r["errs"])
    grads = ""
    if r.get("grad_errs"):
        r["max_rel_err_grads"] = max(e[1] for e in r["grad_errs"])
        grads = f", weight gradients {r['max_rel_err_grads']:.3e} (tol {GRAD_TOL:.0e})"
    print(f"{name}: max abs err {r['max_abs_err']:.3e}, relative {r['max_rel_err']:.3e} "
          f"(tol {tol:.0e}){grads}, {r['ms']:.3f} ms vs plain {r['plain_ms']:.3f} ms, "
          f"bound {r['bound_ms']:.3f} ms ({r['bound_by']}"
          + (f", the work at three TF32 passes; fp32 SIMT bound {r['bound_fp32_simt_ms']:.3f} ms"
             if "bound_fp32_simt_ms" in r else "") + f"){where} [{card}]")
    return r["max_rel_err"] <= tol and r.get("max_rel_err_grads", 0.0) <= GRAD_TOL


def hold_one_pass(o, layout, got, want, again):
    """One TF32 pass: add a backward kernel's comparisons to ``o`` (each
    output, then each weight-gradient leaf of the flat vector laid out as
    ``layout``: its error and the 99.9th percentile of its relative error),
    and whether two runs gave the same bits."""
    import torch

    from phyloformer_tpu_torch.ops.kernels import axial_block_bwd as bw

    *outs, flat = got
    *refs, rflat = want
    g = bw.unpack_grads(layout, flat, D, H, {})
    r = bw.unpack_grads(layout, rflat, D, H, {})
    for a, b in list(zip(outs, refs)) + [(g[k][n], r[k][n]) for k in r for n in r[k]]:
        o["errs"].append(errors(a, b))
        o["p999"].append(flip_stats(a, b)[1])
    o["same_bits"] = o.get("same_bits", True) and all(
        torch.equal(a, b) for a, b in zip(got, again))


def one_pass_row(o, ms, bnd):
    """A kernel's one-pass comparisons folded into its maxima, with its time
    and its bound at one pass."""
    return dict(max_abs_err=max(e[0] for e in o["errs"]),
                max_rel_err=max(e[1] for e in o["errs"]), p999=max(o["p999"]),
                same_bits=o["same_bits"], tolerance=ONE_PASS_TOL,
                tolerance_p999=ONE_PASS_P999, ms=ms, bound_ms=bnd[0], bound_by=bnd[1])


def report_one_pass(name, r, where, card) -> bool:
    """Print a kernel's one-pass row; whether it holds its bars."""
    print(f"{name} at one TF32 pass: max abs err {r['max_abs_err']:.3e}, relative "
          f"{r['max_rel_err']:.3e} (tol {ONE_PASS_TOL:.0e}), 99.9th percentile "
          f"{r['p999']:.3e} (tol {ONE_PASS_P999:.0e}), every output and weight gradient; "
          f"same bits twice {r['same_bits']}; {r['ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
          f"({r['bound_by']}, the work at one pass){where} [{card}]")
    return (r["max_rel_err"] <= ONE_PASS_TOL and r["p999"] <= ONE_PASS_P999
            and r["same_bits"])


def bound(flops, nbytes, peak=PEAK_FP32_FLOPS):
    """(least ms on the card, "operations" or "bytes"): the larger of the
    matmul FLOPs over ``peak`` (by default the fp32 SIMT peak) and the bytes
    over the HBM rate."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def bound_tc(flops, nbytes):
    """The bound of a kernel whose products run on the tensor cores:
    TF32_PASSES x the FLOPs over the dense TF32 peak, or the bytes; with the
    fp32 SIMT bound of the same work (what the kernels ran on before the
    tensor cores), for reference."""
    ms, by = bound(TF32_PASSES * flops, nbytes, PEAK_TF32_FLOPS)
    return ms, by, bound(flops, nbytes)[0]


def sass_counts(lib_path):
    """Tensor-core (HMMA) and fp32 FMA (FFMA) instructions of each kernel in
    the built library, from ``cuobjdump -sass``, by the kernel's short name
    (``kernel_c``; the template argument of ``kernel_a`` appended); None
    where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    res = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                         timeout=300)
    counts, cur = {}, None
    for line in res.stdout.splitlines():
        if "Function :" in line:
            cur = line.split("Function :")[1].strip()
            counts[cur] = {"HMMA": 0, "FFMA": 0}
        elif cur is not None:
            for op in ("HMMA", "FFMA"):
                counts[cur][op] += (" " + op + ".") in line or (" " + op + " ") in line
    short = {}
    for k, v in counts.items():
        m = re.search(r"\d(kernel_[a-z0-9_]+?)(?:E|I(L[^E]*E))", k)
        if m:
            short[m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")] = v
    return short


def random_alignment(rng, n, l, gap_frac=0.02):
    from phyloformer_tpu_torch.data.alphabet import GAP_CODE

    codes = rng.integers(0, 20, (n, l))
    codes[rng.random((n, l)) < gap_frac] = GAP_CODE
    return codes


def batch_inputs(rng, dims, pad_n, pad_l, device):
    """Codes and masks of a padded batch of random alignments of real shapes
    ``dims`` = [(n, l), ...]."""
    import torch

    b = len(dims)
    codes = np.zeros((b, pad_n, pad_l), np.int32)
    smask = np.zeros((b, pad_l), bool)
    qmask = np.zeros((b, pad_n), bool)
    for r, (n, l) in enumerate(dims):
        codes[r, :n, :l] = random_alignment(rng, n, l)
        smask[r, :l] = True
        qmask[r, :n] = True
    return [torch.from_numpy(t).to(device) for t in (codes, smask, qmask)]


def block0_inputs(w, rng, dims, pad_n, pad_l, device):
    """A random padded batch as block 0 sees it: the embedding, the pair
    indices, the float site / pair masks, the real pair counts and the
    gathered pair tensor."""
    import torch

    from phyloformer_tpu_torch.data.pairs import pair_indices

    codes, site_mask, seq_mask = batch_inputs(rng, dims, pad_n, pad_l, device)
    ii, jj = (torch.as_tensor(a, device=device) for a in pair_indices(pad_n))
    emb = torch.relu(w.embed_w[codes.long()] + w.embed_b).contiguous()
    smask = site_mask.float().contiguous()
    pmask = (seq_mask[:, ii.long()] & seq_mask[:, jj.long()]).float().contiguous()
    x0 = (emb[:, ii.long()] + emb[:, jj.long()]).contiguous()
    return emb, ii, jj, smask, pmask, pmask.sum(1), x0


def case_errors(results, case, start):
    """Each kernel's largest relative error over the comparisons of ``case``
    (those after ``start[name]`` in its list), kept under ``cases``."""
    for name, r in results.items():
        if len(r["errs"]) > start[name]:
            r["cases"][case] = max(e[1] for e in r["errs"][start[name]:])


def kernel_checks(weights, device):
    """Each kernel against its plain version on the card, at the headline
    bucket and on a ragged batch; times at the headline shapes."""
    import torch

    from phyloformer_tpu_torch.ops.kernels import pipeline as pipe

    rng = np.random.default_rng(SEED)
    cases = {
        # name: (real dims, pad_n, pad_l); the headline is what the main path
        # gives the kernels for 60 x 250 alignments: a batch of 9
        "headline": ([(60, 250)] * 9, 60, 256),
        # unbucketed (--no-bucketing): a site axis that ends in a partial tile
        "ragged": ([(33, 333), (27, 290), (40, 345)], 40, 345),
        # the A-only shape of the main path: one 110-tip alignment
        "wide": ([(110, 200)], 120, 256),
    }
    w = weights
    eps = 1e-5
    results = {k: {"errs": [], "cases": {}}
               for k in ("kernel_p0", "kernel_a_only", "kernel_m", "kernel_z")}
    timing_inputs = {}
    for case, (dims, pad_n, pad_l) in cases.items():
        b = len(dims)
        start = {k: len(r["errs"]) for k, r in results.items()}
        emb, ii, jj, smask, pmask, pcount, x0 = block0_inputs(w, rng, dims, pad_n, pad_l,
                                                              device)

        # block 0: P0 and A-only
        if case != "wide":
            got = pipe.kernel_p0(emb, ii, jj, smask, pmask, w.row[0], w.col[0], eps)
            want = pipe.kernel_p0_plain(emb, ii, jj, smask, pmask, w.row[0], w.col[0], eps)
            results["kernel_p0"]["errs"] += [errors(got[0], want[0]), errors(got[1], want[1])]
        got = pipe.kernel_a_only(x0.clone(), smask, pmask, w.row[0], w.col[0], eps)
        want = pipe.kernel_a_only_plain(x0, smask, pmask, w.row[0], w.col[0], eps)
        results["kernel_a_only"]["errs"] += [errors(got[0], want[0]), errors(got[1], want[1])]
        x1, stats = want
        # the first block boundary, on the plain block-0 outputs
        for gelu in ("exact", "tanh"):
            got = pipe.kernel_m(x1.clone(), stats, smask, pmask, pcount, w.b[0], w.row[1],
                                w.col[1], eps, gelu)
            want = pipe.kernel_m_plain(x1, stats, smask, pmask, pcount, w.b[0], w.row[1],
                                       w.col[1], eps, gelu)
            results["kernel_m"]["errs"] += [errors(got[0], want[0]), errors(got[1], want[1])]
        # the last block, on the input the main path gives it: the plain
        # versions run through every block boundary
        xz, sz = x1, stats
        for i in range(len(w.row) - 1):
            xz, sz = pipe.kernel_m_plain(xz, sz, smask, pmask, pcount, w.b[i], w.row[i + 1],
                                         w.col[i + 1], eps)
        for gelu in ("exact", "tanh"):
            got = pipe.kernel_z(xz, sz, smask, pcount, w.b[-1], w.head, eps, gelu)
            want = pipe.kernel_z_plain(xz, sz, smask, pcount, w.b[-1], w.head, eps, gelu)
            results["kernel_z"]["errs"].append(errors(got, want))
        torch.cuda.synchronize()
        case_errors(results, case, start)
        if case in ("headline", "wide"):
            timing_inputs[case] = dict(emb=emb, ii=ii, jj=jj, smask=smask, pmask=pmask,
                                       pcount=pcount, x0=x0, x1=x1, stats=stats, xz=xz,
                                       sz=sz, b=b, n=pad_n, p=len(ii), l=pad_l)

    # timing at the main path's shapes
    h, wd = timing_inputs["headline"], timing_inputs["wide"]

    def p0(plain):
        f = pipe.kernel_p0_plain if plain else pipe.kernel_p0
        return lambda: f(h["emb"], h["ii"], h["jj"], h["smask"], h["pmask"], w.row[0],
                         w.col[0], eps)

    def a_only(plain):
        f = pipe.kernel_a_only_plain if plain else pipe.kernel_a_only
        return lambda x: f(x, wd["smask"], wd["pmask"], w.row[0], w.col[0], eps)

    def m(plain):
        f = pipe.kernel_m_plain if plain else pipe.kernel_m
        return lambda x: f(x, h["stats"], h["smask"], h["pmask"], h["pcount"], w.b[0],
                           w.row[1], w.col[1], eps)

    def z(plain):
        f = pipe.kernel_z_plain if plain else pipe.kernel_z
        return lambda: f(h["xz"], h["sz"], h["smask"], h["pcount"], w.b[-1], w.head, eps)

    def clone_of(t):
        return lambda: (t.clone(),)

    hs = h["b"] * h["p"] * h["l"]  # pair-sites
    ws = wd["b"] * wd["p"] * wd["l"]
    act = 4 * D  # bytes of one pair-site row
    stats_b = 4 * h["b"] * h["l"] * 3 * D
    timed = {
        "kernel_p0": (p0(False), p0(True), None,
                      bound_tc(FLOPS_A * hs,
                               4 * h["b"] * h["n"] * h["l"] * D + act * hs + stats_b)),
        "kernel_a_only": (a_only(False), a_only(True), clone_of(wd["x0"]),
                          bound_tc(FLOPS_A * ws, 2 * act * ws + 4 * wd["b"] * wd["l"] * 3 * D)),
        "kernel_m": (m(False), m(True), clone_of(h["x1"]),
                     bound_tc((FLOPS_A + FLOPS_B) * hs, 2 * act * hs + 2 * stats_b)),
        "kernel_z": (z(False), z(True), None,
                     bound_tc((FLOPS_B + FLOPS_HEAD) * hs,
                              act * hs + stats_b + 4 * h["b"] * h["p"])),
    }
    for name, (kern, plain, setup, (bound_ms, bound_by, simt_ms)) in timed.items():
        r = results[name]
        r["ms"] = time_ms(kern, setup)
        r["plain_ms"] = time_ms(plain, setup)
        r["bound_ms"], r["bound_by"], r["bound_fp32_simt_ms"] = bound_ms, bound_by, simt_ms
        r["library_ms"] = None  # no single PyTorch call computes these functions
    return results


def fused_kernel_checks(weights, device):
    """The fused forward's kernels A, B, A1 and A2 against their plain
    versions: A and B at the headline bucket, at the training shape and on
    a 250-site batch (a partial 64-site tile), A1, A2 and B at the long
    bucket, all four on a ragged unbucketed batch; A and B also run twice
    on each, for the same bits.  Times at the main paths' shapes (A at the
    headline and the training shape, B at the long bucket and the headline,
    A1 and A2 at the long bucket)."""
    import torch

    from phyloformer_tpu_torch.ops.kernels import fused
    from phyloformer_tpu_torch.ops.kernels import pipeline as pipe

    rng = np.random.default_rng(SEED + 2)
    cases = {
        # name: (real dims, pad_n, pad_l, kernels checked)
        "headline": ([(60, 250)] * 9, 60, 256, ("kernel_a", "kernel_b")),
        # a training batch: 4 x 1225 pairs x 256 sites
        "train": ([(50, 256)] * 4, 50, 256, ("kernel_a", "kernel_b")),
        # --no-bucketing at 250 sites: the last 64-site tile holds 58
        "ragged250": ([(60, 250), (41, 233)], 60, 250, ("kernel_a", "kernel_b")),
        # one 60 x 1500 alignment in the (60, 1536) bucket: B = 1, P = 1770
        "long": ([(60, 1500)], 60, 1536, ("kernel_a1", "kernel_a2", "kernel_b")),
        # --no-bucketing: 1100 sites end in a partial tile of 12, the second
        # row has 1031 real sites and 33 of 40 sequences
        "ragged": ([(40, 1100), (33, 1031)], 40, 1100,
                   ("kernel_a", "kernel_a1", "kernel_a2", "kernel_b")),
    }
    w, eps = weights, 1e-5
    results = {k: {"errs": [], "cases": {}, "same_bits": True}
               for k in ("kernel_a", "kernel_b", "kernel_a1", "kernel_a2")}
    shapes = {}
    for case, (dims, pad_n, pad_l, names) in cases.items():
        start = {k: len(r["errs"]) for k, r in results.items()}
        _, _, _, smask, pmask, pcount, x0 = block0_inputs(w, rng, dims, pad_n, pad_l, device)
        if "kernel_a" in names:
            got = fused.kernel_a(x0, smask, pmask, w.row[0], w.col[0], eps)
            again = fused.kernel_a(x0, smask, pmask, w.row[0], w.col[0], eps)
            want = pipe.kernel_a_only_plain(x0, smask, pmask, w.row[0], w.col[0], eps)
            results["kernel_a"]["errs"] += [errors(got[0], want[0]), errors(got[1], want[1])]
            results["kernel_a"]["same_bits"] &= bool(torch.equal(got[0], again[0])
                                                     and torch.equal(got[1], again[1]))
            del got, again
        rowstats = fused.kernel_a1_plain(x0, smask, w.row[0], eps)
        if "kernel_a1" in names:
            results["kernel_a1"]["errs"].append(
                errors(fused.kernel_a1(x0, smask, w.row[0], eps), rowstats))
        want = fused.kernel_a2_plain(x0, rowstats, smask, pmask, w.row[0], w.col[0], eps)
        if "kernel_a2" in names:
            got = fused.kernel_a2(x0, rowstats, smask, pmask, w.row[0], w.col[0], eps)
            results["kernel_a2"]["errs"] += [errors(got[0], want[0]), errors(got[1], want[1])]
        x1, stats = want
        got = fused.kernel_b(x1, stats, pcount, w.b[0], eps)
        results["kernel_b"]["errs"].append(
            errors(got, fused.kernel_b_plain(x1, stats, pcount, w.b[0], eps)))
        results["kernel_b"]["same_bits"] &= bool(
            torch.equal(got, fused.kernel_b(x1, stats, pcount, w.b[0], eps)))
        del got
        torch.cuda.synchronize()
        case_errors(results, case, start)
        shapes[case] = dict(smask=smask, pmask=pmask, pcount=pcount, x0=x0, rowstats=rowstats,
                            x1=x1, stats=stats, b=len(dims), p=x0.shape[1], l=pad_l)
        del want, x1, stats

    h, lg, tr = shapes["headline"], shapes["long"], shapes["train"]

    def a(plain, s=h):
        f = pipe.kernel_a_only_plain if plain else fused.kernel_a
        return lambda: f(s["x0"], s["smask"], s["pmask"], w.row[0], w.col[0], eps)

    def b(plain, s):
        f = fused.kernel_b_plain if plain else fused.kernel_b
        return lambda: f(s["x1"], s["stats"], s["pcount"], w.b[0], eps)

    def a1(plain):
        f = fused.kernel_a1_plain if plain else fused.kernel_a1
        return lambda: f(lg["x0"], lg["smask"], w.row[0], eps)

    def a2(plain):
        f = fused.kernel_a2_plain if plain else fused.kernel_a2
        return lambda: f(lg["x0"], lg["rowstats"], lg["smask"], lg["pmask"], w.row[0], w.col[0],
                         eps)

    def sites(s):
        return s["b"] * s["p"] * s["l"]

    act = 4 * D  # bytes of one pair-site row

    def stats_bytes(s):
        return 4 * s["b"] * s["l"] * 3 * D

    rowstats_b = 4 * lg["b"] * lg["p"] * 3 * D
    timed = {
        "kernel_a": (a(False), a(True),
                     bound_tc(FLOPS_A * sites(h), 2 * act * sites(h) + stats_bytes(h))),
        "kernel_b": (b(False, lg), b(True, lg),
                     bound_tc(FLOPS_B * sites(lg), 2 * act * sites(lg) + stats_bytes(lg))),
        "kernel_a1": (a1(False), a1(True),
                      bound_tc(FLOPS_A1 * sites(lg), act * sites(lg) + rowstats_b)),
        "kernel_a2": (a2(False), a2(True),
                      bound_tc(FLOPS_A2 * sites(lg),
                               2 * act * sites(lg) + rowstats_b + stats_bytes(lg))),
    }
    for name, (kern, plain, (bound_ms, bound_by, simt_ms)) in timed.items():
        r = results[name]
        r["ms"] = time_ms(kern)
        r["plain_ms"] = time_ms(plain)
        r["bound_ms"], r["bound_by"], r["bound_fp32_simt_ms"] = bound_ms, bound_by, simt_ms
        r["library_ms"] = None  # no single PyTorch call computes these functions
    # kernel B also runs at the headline bucket on the two-kernel path, and
    # both at the training shape
    ra, rb = results["kernel_a"], results["kernel_b"]
    rb["headline_ms"] = time_ms(b(False, h))
    rb["headline_bound_ms"], _, rb["headline_bound_fp32_simt_ms"] = bound_tc(
        FLOPS_B * sites(h), 2 * act * sites(h) + stats_bytes(h))
    ra["train_ms"] = time_ms(a(False, tr))
    rb["train_ms"] = time_ms(b(False, tr))
    ra["train_bound_ms"] = bound_tc(FLOPS_A * sites(tr), 2 * act * sites(tr) + stats_bytes(tr))[0]
    rb["train_bound_ms"] = bound_tc(FLOPS_B * sites(tr), 2 * act * sites(tr) + stats_bytes(tr))[0]
    return results


def bf16_ulps(got, want):
    """Two bf16 tensors, the same fp32 values rounded by the kernel and by
    its plain version: a dict of the largest |got - want| in units of the
    last place of bf16 at the larger of the two (``ulps``), the share of
    elements that differ (``share``) and that differ by more than one ulp
    (``share_over_1``), the worst element (``worst``: want, got), and
    ``excess``: the largest difference beyond one ulp, over max(1, max|want|).
    Rounded from fp32 values a kernel tolerance ``tol`` apart, two bf16
    values lie within one ulp plus ``tol`` of the scale: ``excess`` is held
    to the variant's fp32 bar."""
    import torch

    g, w = got.float(), want.float()
    diff = (g - w).abs()
    m = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -126)
    ulp = torch.ldexp(torch.ones_like(m), torch.frexp(m)[1] - 8)
    ulps = (diff / ulp).flatten()
    k = int(ulps.argmax())
    return dict(ulps=ulps[k].item(), share=(diff > 0).double().mean().item(),
                share_over_1=(ulps > 1).double().mean().item(),
                worst=(w.flatten()[k].item(), g.flatten()[k].item()),
                excess=((diff - ulp).clamp_min(0).max() / max(1.0, w.abs().max().item())).item())


def flip_stats(got, want):
    """fp32 outputs: (the share of elements off by more than KERNEL_TOL of
    max(1, max|want|), the 99.9th percentile of the relative error)."""
    import torch

    rel = ((got.double() - want.double()).abs()
           / max(1.0, want.abs().max().item())).flatten()
    if rel.numel() > 1 << 24:  # quantile's limit: a strided sample
        rel = rel[::(rel.numel() >> 24) + 1]
    return (rel > KERNEL_TOL).double().mean().item(), torch.quantile(rel, 0.999).item()


# The forward kernels' variants held against their plain versions: name ->
# (kernel, TF32 passes, x1 storage, activation).
VARIANTS = {}
for _k in ("kernel_p0", "kernel_a_only", "kernel_m", "kernel_z"):
    for _np, _st in ((1, "float32"), (3, "bfloat16"), (1, "bfloat16")):
        VARIANTS[f"{_k}/p{_np}-{_st}"] = (_k, _np, _st, "exact")
for _k in ("kernel_m", "kernel_z"):  # the fast path's (tanh) and the other activations
    for _st in ("float32", "bfloat16"):
        VARIANTS[f"{_k}/p1-{_st}-tanh"] = (_k, 1, _st, "tanh")
        for _np in (3, 1):
            for _g in ("sigmoid", "relu"):
                VARIANTS[f"{_k}/p{_np}-{_st}-{_g}"] = (_k, _np, _st, _g)
for _k in ("kernel_a", "kernel_b", "kernel_a1", "kernel_a2"):
    VARIANTS[f"{_k}/p1-float32"] = (_k, 1, "float32", "exact")


# name: (real dims, pad_n, pad_l) of the variant checks
VARIANT_CASES = {
    "headline": ([(60, 250)] * 9, 60, 256),
    "ragged": ([(33, 333), (27, 290), (40, 345)], 40, 345),
    "wide": ([(110, 200)], 120, 256),
    "long": ([(60, 1500)], 60, 1536),
}


def variant_checks(weights, device):
    """Every reduced-precision and activation variant of the forward kernels
    (``VARIANTS``) against its plain version, run twice for the same bits:
    P0, A-only, M and Z at the headline bucket, on a ragged batch and at
    the long bucket (60 x 1500 -> (60, 1536): the pipeline serves it at one
    pass), A-only also at the wide shape; A, B, A1 and A2 where the fused
    forward runs them.  fp32 outputs compare relative to max(1, max|ref|);
    x1 stored as bf16 compares in bf16 ulps, and the stats taken from it
    against the plain stats of the kernel's own x1.  Times at the main paths'
    shapes, beside the three-pass fp32 kernel on the same inputs and the
    bound of the variant's work (one pass: FLOPs over the TF32 peak; bf16:
    2 B a value)."""
    import torch

    from phyloformer_tpu_torch.ops.kernels import fused
    from phyloformer_tpu_torch.ops.kernels import pipeline as pipe
    from phyloformer_tpu_torch.ops.kernels.axial_block import body_col_stats

    rng = np.random.default_rng(SEED + 7)
    cases = VARIANT_CASES
    w, eps = weights, 1e-5
    bf = torch.bfloat16
    res = {v: {"errs": [], "bf16": [], "far_share": [], "p999": [], "same_bits": True,
               "cases": {}}
           for v in VARIANTS}
    keep = {}

    def record(v, case, got, want, again):
        """got/want/again: tuples of outputs."""
        r = res[v]
        errs = []
        for g, t in zip(got, want):
            if t.dtype == bf:
                r["bf16"].append(bf16_ulps(g, t))
            else:
                errs.append(errors(g, t))
                far, p999 = flip_stats(g, t)
                r["far_share"].append(far)
                r["p999"].append(p999)
        r["errs"] += errs
        if errs:
            r["cases"][case] = max(e[1] for e in errs)
        r["same_bits"] &= all(torch.equal(a, b) for a, b in zip(got, again))

    for case, (dims, pad_n, pad_l) in cases.items():
        emb, ii, jj, smask, pmask, pcount, x0 = block0_inputs(w, rng, dims, pad_n, pad_l,
                                                              device)
        ins = {}
        for st in ("float32", "bfloat16"):
            dt = pipe.ACT_DTYPES[st]
            x1, stats = pipe.kernel_p0_plain(emb, ii, jj, smask, pmask, w.row[0], w.col[0], eps,
                                             1, dt)
            ins[st] = (x1, stats)
        for v, (k, npass, st, g) in VARIANTS.items():
            dt = pipe.ACT_DTYPES[st]
            x1, stats = ins[st]
            if k == "kernel_p0":
                if case == "wide":
                    continue
                run = lambda f: f(emb, ii, jj, smask, pmask, w.row[0], w.col[0], eps, npass, dt)
                got, again = run(pipe.kernel_p0), run(pipe.kernel_p0)
                want = pipe.kernel_p0_plain(emb, ii, jj, smask, pmask, w.row[0], w.col[0], eps,
                                            npass, dt)
            elif k == "kernel_a_only":
                xs = (emb.to(dt)[:, ii.long()] + emb.to(dt)[:, jj.long()]).contiguous()
                run = lambda f: f(xs.clone(), smask, pmask, w.row[0], w.col[0], eps, npass)
                got, again = run(pipe.kernel_a_only), run(pipe.kernel_a_only)
                want = pipe.kernel_a_only_plain(xs, smask, pmask, w.row[0], w.col[0], eps, npass)
            elif k == "kernel_m":
                if case == "wide":
                    continue
                run = lambda f: f(x1.clone(), stats, smask, pmask, pcount, w.b[0], w.row[1],
                                  w.col[1], eps, g, npass)
                got, again = run(pipe.kernel_m), run(pipe.kernel_m)
                want = pipe.kernel_m_plain(x1, stats, smask, pmask, pcount, w.b[0], w.row[1],
                                           w.col[1], eps, g, npass)
            elif k == "kernel_z":
                if case == "wide":
                    continue
                run = lambda f: (f(x1, stats, smask, pcount, w.b[-1], w.head, eps, g, npass),)
                got, again = run(pipe.kernel_z), run(pipe.kernel_z)
                want = run(pipe.kernel_z_plain)
            else:
                if case not in ({"kernel_a": ("headline", "ragged"),
                                 "kernel_b": ("headline", "long"),
                                 "kernel_a1": ("long", "ragged"),
                                 "kernel_a2": ("long", "ragged")}[k]):
                    continue
                x1f, statsf = ins["float32"]
                if k == "kernel_a":
                    run = lambda f: f(x0, smask, pmask, w.row[0], w.col[0], eps, npass)
                    got, again, want = (run(fused.kernel_a), run(fused.kernel_a),
                                        run(pipe.kernel_a_only_plain))
                    if case == "ragged":
                        # the same twin on the CPU: fp32 sums in another order
                        # there too, so its distance from the twin on the card
                        # is the TF32 rounding flips' own size
                        cpu = [pipe.WeightGroup(tuple(t.cpu() for t in g.parts), g.flat.cpu(),
                                                g.mma.cpu()) for g in (w.row[0], w.col[0])]
                        twin_cpu = pipe.kernel_a_only_plain(x0.cpu(), smask.cpu(), pmask.cpu(),
                                                            cpu[0], cpu[1], eps, npass)
                        res[v]["twin_card_vs_cpu"] = max(
                            errors(a.cpu(), b)[1] for a, b in zip(want, twin_cpu))
                        del twin_cpu
                elif k == "kernel_b":
                    run = lambda f: (f(x1f, statsf, pcount, w.b[0], eps, npass),)
                    got, again, want = (run(fused.kernel_b), run(fused.kernel_b),
                                        run(fused.kernel_b_plain))
                elif k == "kernel_a1":
                    run = lambda f: (f(x0, smask, w.row[0], eps, npass),)
                    got, again, want = (run(fused.kernel_a1), run(fused.kernel_a1),
                                        run(fused.kernel_a1_plain))
                else:
                    rs = fused.kernel_a1_plain(x0, smask, w.row[0], eps, npass)
                    run = lambda f: f(x0, rs, smask, pmask, w.row[0], w.col[0], eps, npass)
                    got, again, want = (run(fused.kernel_a2), run(fused.kernel_a2),
                                        run(fused.kernel_a2_plain))
            if st == "bfloat16" and k != "kernel_z":
                # the stats are sums over the pairs of the stored x1: a bf16
                # rounding flip (2^-8 of an element) reaches them whole where
                # the pairs are few, so they are held to the plain stats of
                # the kernel's own x1, and to the twin's only for the record
                colg = w.col[1 if k == "kernel_m" else 0]
                own = body_col_stats(got[0].float(), pmask, colg.parts, eps, npass)
                res[v]["stats_vs_twin"] = max(res[v].get("stats_vs_twin", 0.0),
                                              errors(got[1], want[1])[1])
                want = (want[0], own)
            record(v, case, got, want, again)
            del got, again, want
        torch.cuda.synchronize()
        if case in ("headline", "wide", "long"):
            keep[case] = dict(emb=emb, ii=ii, jj=jj, smask=smask, pmask=pmask, pcount=pcount,
                              x0=x0, ins=ins, b=len(dims), n=pad_n, p=len(ii), l=pad_l)
        del emb, x0, ins
        torch.cuda.empty_cache()

    # times: each variant beside the three-pass fp32 kernel on the same shape
    def timer(k, npass, st, g, s):
        dt = pipe.ACT_DTYPES[st]
        x1, stats = s["ins"][st]
        if k == "kernel_p0":
            return (lambda: pipe.kernel_p0(s["emb"], s["ii"], s["jj"], s["smask"], s["pmask"],
                                           w.row[0], w.col[0], eps, npass, dt)), None
        if k == "kernel_a_only":
            xs = (s["emb"].to(dt)[:, s["ii"].long()] + s["emb"].to(dt)[:, s["jj"].long()])
            return (lambda x: pipe.kernel_a_only(x, s["smask"], s["pmask"], w.row[0], w.col[0],
                                                 eps, npass)), (lambda: (xs.clone(),))
        if k == "kernel_m":
            return (lambda x: pipe.kernel_m(x, stats, s["smask"], s["pmask"], s["pcount"],
                                            w.b[0], w.row[1], w.col[1], eps, g, npass)), \
                (lambda: (x1.clone(),))
        if k == "kernel_z":
            return (lambda: pipe.kernel_z(x1, stats, s["smask"], s["pcount"], w.b[-1], w.head,
                                          eps, g, npass)), None
        x1f, statsf = s["ins"]["float32"]
        if k == "kernel_a":
            return (lambda: fused.kernel_a(s["x0"], s["smask"], s["pmask"], w.row[0], w.col[0],
                                           eps, npass)), None
        if k == "kernel_b":
            return (lambda: fused.kernel_b(x1f, statsf, s["pcount"], w.b[0], eps, npass)), None
        if k == "kernel_a1":
            return (lambda: fused.kernel_a1(s["x0"], s["smask"], w.row[0], eps, npass)), None
        rs = fused.kernel_a1_plain(s["x0"], s["smask"], w.row[0], eps, npass)
        return (lambda: fused.kernel_a2(s["x0"], rs, s["smask"], s["pmask"], w.row[0], w.col[0],
                                        eps, npass)), None

    flops = {"kernel_p0": FLOPS_A, "kernel_a_only": FLOPS_A, "kernel_m": FLOPS_A + FLOPS_B,
             "kernel_z": FLOPS_B + FLOPS_HEAD, "kernel_a": FLOPS_A, "kernel_b": FLOPS_B,
             "kernel_a1": FLOPS_A1, "kernel_a2": FLOPS_A2}
    where = {"kernel_p0": "headline", "kernel_a_only": "wide", "kernel_m": "headline",
             "kernel_z": "headline", "kernel_a": "headline", "kernel_b": "long",
             "kernel_a1": "long", "kernel_a2": "long"}
    base = {}
    for v, (k, npass, st, g) in VARIANTS.items():
        s = keep[where[k]]
        sites = s["b"] * s["p"] * s["l"]
        vb = 2 if st == "bfloat16" else 4  # bytes of one stored value
        stats_b = 4 * s["b"] * s["l"] * 3 * D
        nbytes = {"kernel_p0": 4 * s["b"] * s["n"] * s["l"] * D + vb * D * sites + stats_b,
                  "kernel_a_only": 2 * vb * D * sites + stats_b,
                  "kernel_m": 2 * vb * D * sites + 2 * stats_b,
                  "kernel_z": vb * D * sites + stats_b + 4 * s["b"] * s["p"],
                  "kernel_a": 8 * D * sites + stats_b, "kernel_b": 8 * D * sites + stats_b,
                  "kernel_a1": 4 * D * sites + 12 * D * s["b"] * s["p"],
                  "kernel_a2": 8 * D * sites + 12 * D * s["b"] * s["p"] + stats_b}[k]
        r = res[v]
        fn, setup = timer(k, npass, st, g, s)
        r["ms"] = time_ms(fn, setup)
        key = (k, where[k])
        if key not in base:
            fn3, setup3 = timer(k, 3, "float32", "exact", s)
            base[key] = time_ms(fn3, setup3)
        r["p3_f32_ms"] = base[key]
        r["bound_ms"], r["bound_by"] = bound(npass * flops[k] * sites, nbytes, PEAK_TF32_FLOPS)
        r["shape"] = f"{s['b']} x {s['p']} x {s['l']}"
        r["max_abs_err"] = max((e[0] for e in r["errs"]), default=0.0)
        r["max_rel_err"] = max((e[1] for e in r["errs"]), default=0.0)
        r["far_share"] = max(r["far_share"], default=0.0)
        r["p999"] = max(r["p999"], default=0.0)
        if r["bf16"]:
            worst = max(r["bf16"], key=lambda u: u["ulps"])
            r["bf16"] = {k: max(u[k] for u in r["bf16"])
                         for k in ("ulps", "share", "share_over_1", "excess")}
            r["bf16"]["worst"] = worst["worst"]
        else:
            del r["bf16"]
        del r["errs"]
        torch.cuda.empty_cache()
    return res


def time_launches(fns, n=REDUCE_LAUNCHES, reps=9):
    """Device milliseconds per launch of each of ``fns`` (name -> callable),
    taken in turns: per rep, for each in order, one CUDA-event pair around
    ``n`` back-to-back launches; the median over ``reps``, after a warm-up.
    A 10-us kernel timed one launch at a time measures the events and the
    host's dispatch, so the stream first runs a sleep kernel twice as long as
    the host took to issue the ``n`` launches (at most 0.2 s, ~2 GHz clock):
    the launches queue behind it and the events see the device's time only.
    Where the host is still slower, its gaps count."""
    import torch

    sleep = {}
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        sleep[name] = int(min(2e6 * 2e3 * (time.perf_counter() - t0), 4e8))
    times = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(sleep[name])
            start.record()
            for _ in range(n):
                fn()
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end) / n)
    return {name: statistics.median(t) for name, t in times.items()}


def reduction_shapes(device):
    """``(label, wrapper, partial shape)`` of every slot reduction the paths
    launch, from the wrappers' own slot rules at the shapes of section 4 of
    PERF.md (headline, A-only, long inference, training, long training)."""
    from phyloformer_tpu_torch.ops.kernels import axial_block_bwd as bw
    from phyloformer_tpu_torch.ops.kernels import fused
    from phyloformer_tpu_torch.ops.kernels import pipeline as pipe

    def pairs(n):
        return n * (n - 1) // 2

    def a_slots(b, n, l):  # kernel A (two-kernel form, training)
        return min(pipe._slots(pairs(n), b, device), fused._budget_slots(b, l))

    def a2_slots(b, n, l):
        return min(pairs(n), fused.A2_MAX_PAIR_SLOTS, fused._budget_slots(b, l))

    nw = {k: bw.grad_size(k, D, H) for k in ("kernel_c", "kernel_d", "kernel_e")}

    def bwd_slots(name, b, n, l=0):  # per_slot_bytes as the wrappers give them
        per_slot = 4 * (l * D + nw["kernel_c"]) if name == "kernel_c" else 4 * nw[name]
        return bw._bwd_slots(name, b, pairs(n), per_slot, device)

    s3 = (3 * D,)
    # E's partial at 4 x 50 x 256, and E2's at 2 x 50 x 1536 (pair slots x
    # site chunks): one row where the two shapes agree
    e_shape = (1, 4 * bwd_slots("kernel_e", 4, 50), nw["kernel_e"])
    sp, sc = bw.e2_grid(2, pairs(50), 1536, device)
    e2_shape = (1, 2 * sp * sc, nw["kernel_e"])
    e_rows = [("partials, E's and E2's weight gradients (4 x 50 x 256)", "reduce_partials",
               e_shape)] if e2_shape == e_shape else [
        ("partials, E's weight gradients (4 x 50 x 256)", "reduce_partials", e_shape),
        ("partials, E2's weight gradients (2 x 50 x 1536)", "reduce_partials", e2_shape)]
    return [
        ("stats, headline P0/M/A (9 x 60 x 256)", "reduce_stats",
         (9, pipe._slots(pairs(60), 9, device), 256) + s3),
        ("stats, A-only (1 x 120 x 256)", "reduce_stats",
         (1, pipe._slots(pairs(120), 1, device), 256) + s3),
        ("stats, long A2 inference (1 x 60 x 1536)", "reduce_stats",
         (1, a2_slots(1, 60, 1536), 1536) + s3),
        ("stats, training A (4 x 50 x 256)", "reduce_stats", (4, a_slots(4, 50, 256), 256) + s3),
        ("stats, long training A2 (2 x 50 x 1536)", "reduce_stats",
         (2, a2_slots(2, 50, 1536), 1536) + s3),
        ("partials, C's A1 (4 x 50 x 256)", "reduce_partials",
         (4, bwd_slots("kernel_c", 4, 50, 256), 256 * D)),
        ("partials, C's A1 (2 x 50 x 1536)", "reduce_partials",
         (2, bwd_slots("kernel_c", 2, 50, 1536), 1536 * D)),
        ("partials, C's weight gradients (4 x 50 x 256)", "reduce_partials",
         (1, 4 * bwd_slots("kernel_c", 4, 50, 256), nw["kernel_c"])),
        # D's at 2 x 50 x 1536 are the same shape: 2 x 132 pair slots
        ("partials, D's weight gradients (4 x 50 x 256)", "reduce_partials",
         (1, 4 * bwd_slots("kernel_d", 4, 50), nw["kernel_d"])),
    ] + e_rows


# The edges of the slot reduction, checked and not timed: (label, wrapper,
# shape, start offset in floats).
REDUCTION_EDGES = [
    ("N = 4999: the scalar path", "reduce_partials", (1, 37, 4999), 0),
    ("S = 1", "reduce_stats", (2, 1, 256, 3 * D), 0),
    ("start 4 bytes into a buffer: the scalar path", "reduce_partials", (1, 132, 37376), 1),
    ("G = 3, a ragged (40, 345) bucket", "reduce_stats", (3, 23, 345, 3 * D), 0),
    ("G = 3, N = 5000", "reduce_partials", (3, 37, 5000), 0),
]
# The shape of each reduction's row in the kernels line (the one used so far).
REDUCTION_ROW = {"reduce_stats": "stats, headline P0/M/A (9 x 60 x 256)",
                 "reduce_partials": "partials, C's weight gradients (4 x 50 x 256)"}


def reduction_checks(device, card):
    """Both slot reductions at every shape the paths give them and at the
    edges: against the ordered twin (``reduce.reduce_slots_ordered`` on the
    wrapper's plan) bit for bit, within KERNEL_TOL of ``partial.sum(dim=1)``,
    and the same bits from two runs; at the paths' shapes timed
    (:func:`time_launches`) in turns with ``torch.sum(partial, dim=1)``, the
    twin on its own, beside the bound.  Returns the kernels-line results of
    both reductions and the table rows."""
    import torch

    from phyloformer_tpu_torch.ops.kernels import axial_block_bwd as bw
    from phyloformer_tpu_torch.ops.kernels import pipeline as pipe
    from phyloformer_tpu_torch.ops.kernels import reduce as red

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    wrappers = {"reduce_stats": pipe.reduce_stats, "reduce_partials": bw.reduce_partials}
    gen = torch.Generator(device).manual_seed(SEED + 7)
    rows = []
    cases = [(label, name, shape, 0, True) for label, name, shape in reduction_shapes(device)]
    cases += [(label, name, shape, off, False) for label, name, shape, off in REDUCTION_EDGES]
    for label, name, shape, off, timed in cases:
        wrap = wrappers[name]
        numel = math.prod(shape)
        partial = torch.randn(numel + off, device=device, generator=gen)[off:].view(shape)
        G, S, N = shape[0], shape[1], numel // (shape[0] * shape[1])
        got, again = wrap(partial), wrap(partial)
        row = dict(label=label, name=name, shape=list(shape), mb=4 * numel / 1e6,
                   err=errors(got, partial.sum(dim=1)), same_bits=torch.equal(got, again))
        plan = red.reduce_plan(G, S, N, sms)
        row["plan"] = dict(tiles=plan.tiles, warps=plan.warps, blocks=plan.blocks)

        def twin(p=partial.view(G, S, N), plan=plan):
            return red.reduce_slots_ordered(p, plan)

        row["twin_bits"] = torch.equal(got.view(G, N), twin())
        if timed:
            row.update(time_launches({"ms": lambda: wrap(partial),
                                      "library_ms": lambda: torch.sum(partial, dim=1)}))
            # the twin apart: in turns, the L2 lines its writes leave dirty were
            # written back during the next function's launches
            row.update(time_launches({"twin_ms": twin}, reps=3))
            row["bound_ms"], row["bound_by"] = bound(G * (S - 1) * N, 4 * (numel + G * N))
            row["vs_library"] = row["ms"] / row["library_ms"]
            row["bound_share"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        del partial, got, again
        torch.cuda.empty_cache()

    for row in rows:
        plan = row["plan"]
        checks = (f"vs sum {row['err'][1]:.2e}, same bits twice {row['same_bits']}, twin bits "
                  f"{row['twin_bits']}, plan {plan['warps']} warps x {plan['blocks']} blocks")
        if "ms" not in row:
            print(f"{row['name']} {row['shape']} ({row['label']}): {checks}")
            continue
        share = 100 * row["bound_share"]
        where = " (L2-resident)" if share > 100 and row["mb"] <= L2_MB else ""
        print(f"{row['name']} {row['shape']} {row['mb']:.1f} MB ({row['label']}): "
              f"{row['ms']:.4f} ms, torch.sum {row['library_ms']:.4f} ms "
              f"({row['vs_library']:.2f}x), twin {row['twin_ms']:.4f} ms, "
              f"bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}, {share:.0f}% of it{where}); {checks} [{card}]")

    results = {}
    for name, label in REDUCTION_ROW.items():
        mine = [r for r in rows if r["name"] == name]
        row = next(r for r in mine if r["label"] == label)
        worst = max((r for r in mine if "ms" in r), key=lambda r: r["vs_library"])
        results[name] = dict(
            errs=[r["err"] for r in mine], ms=row["ms"], plain_ms=row["twin_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=row["library_ms"],
            shape=row["shape"], twin_bits=all(r["twin_bits"] for r in mine),
            same_bits=all(r["same_bits"] for r in mine), worst_vs_library=worst["vs_library"],
            worst_vs_library_shape=worst["shape"])
    return results, rows


def fasta_text(codes, ids):
    from phyloformer_tpu_torch.data.alphabet import ALPHABET

    return "".join(f">{i}\n{bytes(ALPHABET[c] for c in row).decode()}\n"
                   for i, row in zip(ids, codes))


def write_fasta(path, codes, rng_ids):
    with open(path, "w") as fh:
        fh.write(fasta_text(codes, [f"{rng_ids}_{r}" for r in range(len(codes))]))


def expected_launches(plan, n_blocks, pipelined):
    """Launch counts of a run of ``plan``: per pipelined batch one block-0
    kernel (P0 or A-only) + (n_blocks - 1) M + 1 Z; per fused batch, A1, A2
    and B per block above 1024 sites, A and B per block up to it; n_blocks
    reductions per batch either way."""
    from phyloformer_tpu_torch.ops.kernels import axial_block
    from phyloformer_tpu_torch.ops.kernels import pipeline as pipe

    n = {k: 0 for k in pipe.LAUNCHES}
    for (pad_n, pad_l), _ in plan:
        if pipelined(pad_n, pad_l):
            n["kernel_p0" if pipe.uses_gather(pad_n, pad_l, D) else "kernel_a_only"] += 1
            n["kernel_m"] += n_blocks - 1
            n["kernel_z"] += 1
        elif pad_l > axial_block.RESIDENT_SITES_MAX:
            for k in ("kernel_a1", "kernel_a2", "kernel_b"):
                n[k] += n_blocks
        else:
            n["kernel_a"] += n_blocks
            n["kernel_b"] += n_blocks
        n["reduce_stats"] += n_blocks
    return n


def rel_err(got, want):
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def throughput(engine, alns):
    """Alignments per second of engine.predict after one warm run."""
    import torch

    engine.predict(alns)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.predict(alns)
    return len(alns) / (time.perf_counter() - t0)


def main_path(device):
    """Run the CLI on synthetic alignments of up to 3000 sites; check the
    launch counts, the files and the distances against the plain model.
    Returns the checks' numbers, the 60 x 250 alignments and their plain
    model distances, and the throughputs at 60 x 250 and 60 x 1500."""
    import torch

    from phyloformer_tpu_torch.data.fasta import read_fasta
    from phyloformer_tpu_torch.data.phylip import read_phylip
    from phyloformer_tpu_torch.infer import cli
    from phyloformer_tpu_torch.infer.engine import InferenceConfig, InferenceEngine
    from phyloformer_tpu_torch.io.ckpt_import import load_pretrained
    from phyloformer_tpu_torch.models.params import map_params
    from phyloformer_tpu_torch.models.phyloformer import forward
    from phyloformer_tpu_torch.ops.kernels import pipeline as pipe

    shutil.rmtree(WORK, ignore_errors=True)
    aln_dir, out_dir = os.path.join(WORK, "alns"), os.path.join(WORK, "out")
    os.makedirs(aln_dir)
    rng = np.random.default_rng(SEED + 1)
    dims = ([(60, 250)] * 18 + [(17, 130), (33, 333), (45, 700), (25, 1000), (110, 200)]
            + [(60, 1500)] * 2 + [(100, 2000), (30, 3000)])
    for k, (n, l) in enumerate(dims):
        write_fasta(os.path.join(aln_dir, f"aln{k:02d}.fa"), random_alignment(rng, n, l), k)
    gapped = random_alignment(rng, 12, 150, gap_frac=0.35)
    write_fasta(os.path.join(aln_dir, "gapped.fa"), gapped, "g")
    dims.append((12, 150))

    params, cfg, _ = load_pretrained(CKPT)
    names = sorted(os.listdir(aln_dir))
    alns = [read_fasta(os.path.join(aln_dir, f)) for f in names]
    engine = InferenceEngine(params, cfg, InferenceConfig(), device=device)
    expected = expected_launches(engine._plan(alns), cfg.n_blocks, pipe.pipeline_supported)

    pipe.reset_launch_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main([CKPT, aln_dir, "-o", out_dir, "--trees", "--fastme", "--stats",
                       "--device", "cuda"])
    torch.cuda.synchronize()
    launches = dict(pipe.LAUNCHES)
    if rc != 0:
        fail(f"pf-infer exited {rc}")
    cli_stats = json.loads(out.getvalue().strip().splitlines()[-1])

    # distances: finite, and equal to the plain eager model on the card
    worst, worst_long, refs = 0.0, 0.0, []
    dev_params = map_params(lambda t: t.to(device), params)
    for name, aln in zip(names, alns):
        stem = name[:-3]
        for ext in (".phy", ".nj.nwk", ".nwk"):
            if not os.path.getsize(os.path.join(out_dir, stem + ext)):
                fail(f"{stem}{ext} is empty")
        dm, ids = read_phylip(os.path.join(out_dir, stem + ".phy"))
        if ids != aln.ids or not np.isfinite(dm).all():
            fail(f"{stem}.phy: wrong ids or non-finite distances")
        with torch.inference_mode():
            codes = torch.from_numpy(aln.codes.astype(np.int32))[None].to(device)
            ref = forward(dev_params, codes, cfg)[0].double().cpu().numpy()
        refs.append(ref)
        i, j = np.triu_indices(aln.n_seqs, 1)
        err = rel_err(dm[i, j], ref)
        worst = max(worst, err)
        if aln.seq_len > 1024:
            worst_long = max(worst_long, err)
        torch.cuda.empty_cache()

    head = [k for k, d in enumerate(dims) if d == (60, 250)]
    long = [k for k, d in enumerate(dims) if d == (60, 1500)]
    return dict(launches=launches, expected=expected, dist_err=worst, dist_err_long=worst_long,
                cli_stats=cli_stats, head_alns=[alns[k] for k in head],
                head_refs=[refs[k] for k in head], long_alns=[alns[k] for k in long],
                long_refs=[refs[k] for k in long],
                aln_per_s=throughput(engine, [alns[k] for k in head]),
                long_aln_per_s=throughput(engine, [alns[k] for k in long]),
                n_head=len(head), n_long=len(long))


def two_kernel_path(device, alns, refs):
    """The engine with use_pipeline=False: kernels A and B per block on the
    60 x 250 set.  Returns launches, expected launches, the distance error
    against the plain model and the throughput (aln/s after a warm run)."""
    import torch

    from phyloformer_tpu_torch.infer.engine import InferenceConfig, InferenceEngine
    from phyloformer_tpu_torch.io.ckpt_import import load_pretrained
    from phyloformer_tpu_torch.ops.kernels import pipeline as pipe

    params, cfg, _ = load_pretrained(CKPT)
    engine = InferenceEngine(params, cfg, InferenceConfig(use_pipeline=False), device=device)
    expected = expected_launches(engine._plan(alns), cfg.n_blocks, lambda n, l: False)
    pipe.reset_launch_counts()
    preds = engine.predict(alns)
    torch.cuda.synchronize()
    launches = dict(pipe.LAUNCHES)
    if not all(np.isfinite(p).all() for p in preds):
        fail("two-kernel path: non-finite distances")
    return (launches, expected, max(rel_err(p, r) for p, r in zip(preds, refs)),
            throughput(engine, alns))


def variant_failures(v, r):
    """What keeps a variant from its bars (empty when it holds)."""
    _, npass, _, _ = VARIANTS[v]
    tol = KERNEL_TOL if npass == 3 else ONE_PASS_TOL
    bad = []
    if not r["max_rel_err"] <= tol:
        bad.append(f"max rel {r['max_rel_err']:.2e} > {tol:.0e}")
    if npass == 1 and not r["p999"] <= ONE_PASS_P999:
        bad.append(f"99.9th percentile {r['p999']:.2e} > {ONE_PASS_P999:.0e}")
    if "bf16" in r and not r["bf16"]["excess"] <= tol:
        bad.append(f"bf16 x1 beyond one ulp by {r['bf16']['excess']:.2e}")
    if not r["same_bits"]:
        bad.append("other bits on a second run")
    return bad


def report_variants(var, card):
    """Print each variant's errors and times; return those off their bars."""
    bad = {}
    for v, r in var.items():
        b16 = r.get("bf16")
        extra = (f"; x1 bf16: {b16['share']:.2e} of elements differ, {b16['share_over_1']:.2e} "
                 f"by more than one ulp (worst {b16['ulps']:.1f} ulps, beyond one ulp "
                 f"{b16['excess']:.2e})" if b16 else "")
        if "stats_vs_twin" in r:
            extra += f"; stats against the twin's {r['stats_vs_twin']:.2e}"
        print(f"{v}: max rel err {r['max_rel_err']:.3e} (share beyond {KERNEL_TOL:.0e} "
              f"{r['far_share']:.2e}, 99.9th pct {r['p999']:.2e}){extra}; same bits twice "
              f"{r['same_bits']}; {r['ms']:.3f} ms vs {r['p3_f32_ms']:.3f} ms at three passes "
              f"and fp32 storage, bound {r['bound_ms']:.3f} ms ({r['bound_by']}) at "
              f"{r['shape']}" + (f"; twin card vs CPU {r['twin_card_vs_cpu']:.2e}"
                                 if "twin_card_vs_cpu" in r else "") + f" [{card}]")
        fails = variant_failures(v, r)
        if fails:
            bad[v] = fails
    return bad


def reduced_phases(device, card, alns, refs, long_alns, long_refs):
    """The fast path at fp32 and bf16 storage, 60 x 1500 at one pass and the
    drift grid, each timed; fails on any bar.  Returns their numbers."""
    import torch

    t = time.perf_counter()
    fp = fast_path(device, alns, refs, long_alns, long_refs)
    for st in ("float32", "bfloat16"):
        r = fp[st]
        print(f"fast path (tensorfloat32, tanh, {st} storage): launches {r['launches']}, "
              f"expected {r['expected']}")
        print(f"fast path ({st}): {r['aln_per_s']:.3f} aln/s on {len(alns)} alignments of "
              f"60 x 250; vs the plain fp32 model: random sequences max abs "
              f"{r['random'][0]:.3e}, relative {r['random'][1]:.3e}; related sequences (max "
              f"distance {fp['evolved_max_dist']:.3f}) max abs {r['evolved'][0]:.3e} "
              f"(gate {GATE:.0e}) [{card}]")
        if r["launches"] != r["expected"]:
            fail(f"fast path ({st}): launch counts differ from 1 P0 + 5 M + 1 Z per batch")
        if not (r["evolved"][0] <= GATE and r["random"][1] <= GATE):
            fail(f"fast path ({st}): distances off the {GATE:.0e} gate")
    lg = fp["long"]
    print(f"long at one pass: launches {lg['launches']}, expected {lg['expected']}; "
          f"{lg['aln_per_s']:.3f} aln/s on {len(long_alns)} alignments of 60 x 1500; vs the "
          f"plain fp32 model max abs {lg['err'][0]:.3e}, relative {lg['err'][1]:.3e} "
          f"(gate {GATE:.0e}) [{card}]")
    if lg["launches"] != lg["expected"] or not lg["launches"]["kernel_m"]:
        fail("long at one pass: the pipeline did not serve 60 x 1500")
    if not lg["err"][1] <= GATE:
        fail("long at one pass: distances off the gate")
    print(f"fast path phases: {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    rc, rows, verdict, peak = accuracy_grid(device)
    for row in rows:
        print(f"accuracy grid: {json.dumps(row)}")
    print(f"accuracy grid: {verdict}; exit {rc}; peak device memory {peak:.2f} GB; "
          f"{time.perf_counter() - t:.1f} s [{card}]")
    if rc != 0 or len(rows) != 5:
        fail("accuracy grid: a corner failed or drifted past the gate")
    fp["grid"] = dict(rows=rows, verdict=verdict, peak_gb=peak)
    return fp


def evolved_alignment(rng, n, l, mean_branch=0.02):
    """Codes of n related sequences: a random root sequence split down a
    random binary tree, each branch of exponential length mutating every
    site with probability 1 - exp(-20 t / 19) to one of the other 19 amino
    acids (the Poisson model).  pf_mre_r5 puts their distances near those of
    real MSAs (median about 0.4, at most about 2 at 60 x 250), where the
    fast path's gate was calibrated; random sequences sit at the model's
    saturation (about 12)."""
    seqs = [rng.integers(0, 20, l)]
    while len(seqs) < n:
        parent = seqs.pop(int(rng.integers(len(seqs))))
        for _ in range(2):
            child = parent.copy()
            mut = rng.random(l) < 1.0 - math.exp(-rng.exponential(mean_branch) * 20.0 / 19.0)
            child[mut] = (child[mut] + rng.integers(1, 20, int(mut.sum()))) % 20
            seqs.append(child)
    return np.stack(seqs)


def plain_refs(params, cfg, alns, device):
    """The plain eager fp32 model on the card (TF32 off) on each alignment."""
    from phyloformer_tpu_torch.infer.oracle import predict_fp32_eager

    return predict_fp32_eager(params, cfg, alns, device)


def abs_rel(preds, refs):
    """(max abs error, max abs error over max(1, max|ref|)) over alignments."""
    a = max(float(np.abs(p - r).max()) for p, r in zip(preds, refs))
    return a, a / max(1.0, max(float(np.abs(r).max()) for r in refs))


def fast_path(device, alns, refs, long_alns, long_refs):
    """The bench's headline fast path through the engine (bench.py's config:
    matmul_precision="tensorfloat32", tanh GELU) on the 60 x 250 set, at fp32
    and at bf16 storage: launches, aln/s, the distances against the plain
    fp32 model on the card, on the random set and on evolved 60 x 250
    alignments (the gate's domain); then 60 x 1500 at tensorfloat32 (the
    pipeline serves up to 2048 sites at one pass) against the plain model."""
    import torch

    from phyloformer_tpu_torch.data.fasta import Alignment
    from phyloformer_tpu_torch.infer.engine import InferenceConfig, InferenceEngine
    from phyloformer_tpu_torch.io.ckpt_import import load_pretrained
    from phyloformer_tpu_torch.ops.kernels import pipeline as pipe

    params, cfg, _ = load_pretrained(CKPT)
    rng = np.random.default_rng(SEED + 8)
    evolved = [Alignment(evolved_alignment(rng, 60, 250).astype(np.int8),
                         [f"E{j}" for j in range(60)]) for _ in range(9)]
    evolved_refs = plain_refs(params, cfg, evolved, device)
    out = {"evolved_max_dist": max(float(np.abs(r).max()) for r in evolved_refs)}
    for st in ("float32", "bfloat16"):
        engine = InferenceEngine(params, cfg, InferenceConfig(
            matmul_precision="tensorfloat32", pipeline_gelu="tanh", pipeline_act_dtype=st),
            device=device)
        expected = expected_launches(engine._plan(alns), cfg.n_blocks,
                                     lambda n, l: pipe.pipeline_supported(n, l, "default"))
        pipe.reset_launch_counts()
        preds = engine.predict(alns)
        torch.cuda.synchronize()
        launches = dict(pipe.LAUNCHES)
        if not all(np.isfinite(p).all() for p in preds):
            fail(f"fast path ({st}): non-finite distances")
        out[st] = dict(launches=launches, expected=expected, random=abs_rel(preds, refs),
                       evolved=abs_rel(engine.predict(evolved), evolved_refs),
                       aln_per_s=throughput(engine, alns))
        del engine
        torch.cuda.empty_cache()
    engine = InferenceEngine(params, cfg, InferenceConfig(matmul_precision="tensorfloat32"),
                             device=device)
    expected = expected_launches(engine._plan(long_alns), cfg.n_blocks,
                                 lambda n, l: pipe.pipeline_supported(n, l, "default"))
    pipe.reset_launch_counts()
    preds = engine.predict(long_alns)
    torch.cuda.synchronize()
    out["long"] = dict(launches=dict(pipe.LAUNCHES), expected=expected,
                       err=abs_rel(preds, long_refs), aln_per_s=throughput(engine, long_alns))
    return out


def accuracy_grid(device):
    """``pf-bench-torch accuracy-grid`` at its default grid (the five
    corners, reps 2) through its CLI: the rows it prints, its verdict at the
    JAX CLI's 0.01 gate and the peak device memory."""
    import torch

    from phyloformer_tpu_torch.bench import cli as bench_cli

    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench_cli.main(["accuracy-grid", "--weights", CKPT, "--reps", "2",
                             "--device", "cuda"])
    lines = buf.getvalue().strip().splitlines()
    return rc, [json.loads(x) for x in lines[:-1]], lines[-1], \
        torch.cuda.max_memory_allocated() / 1e9


def backward_kernel_checks(params, device):
    """Kernels C, D and E against their plain versions on the residuals of
    the fused forward (layer 0 of pf_mre_r5, block-0 input of random
    alignments, a seeded cotangent masked as a masked loss makes it) at the
    training shape 4 x 50 x 256 and on a ragged batch (45 of 50 tips, 230 of
    256 sites); every output compared on its own.  Times at the training
    shape, and the same bits from two runs of the whole block backward.
    Then each of C, D and E at one TF32 pass against its one-pass plain
    version on the residuals of the one-pass forward (every output and
    weight gradient, twice for the same bits), timed beside its one-pass
    bound (the row's ``one_pass``)."""
    import torch

    from phyloformer_tpu_torch.ops.kernels import axial_block_bwd as bw
    from phyloformer_tpu_torch.ops.kernels import fused
    from phyloformer_tpu_torch.ops.kernels.autodiff import layer_leaves
    from phyloformer_tpu_torch.ops.kernels.pipeline import PipelineWeights

    layer = params["layers"][0]
    w = bw.BwdWeights.of(layer)
    pw = PipelineWeights.from_params(params)
    rng = np.random.default_rng(SEED + 3)
    cases = {"train": ([(50, 256)] * 4, 50, 256), "ragged": ([(45, 230), (50, 256)], 50, 256)}
    results = {k: {"errs": [], "grad_errs": []} for k in ("kernel_c", "kernel_d", "kernel_e")}
    one = {k: {"errs": [], "p999": []} for k in results}
    shapes, same_bits, d_bits = {}, True, True
    for case, (dims, pad_n, pad_l) in cases.items():
        _, _, _, smask, pmask, pcount, x = block0_inputs(pw, rng, dims, pad_n, pad_l, device)
        _, x1, stats = fused.fused_axial_block_res(x, layer, smask, pmask)
        g3 = (torch.randn(x.shape, device=device,
                          generator=torch.Generator(device).manual_seed(SEED))
              * smask[:, None, :, None] * pmask[:, :, None, None]).contiguous()
        d, h = D, H

        def grad_errs(name, got, want):
            g = bw.unpack_grads(name, got, d, h, {})
            r = bw.unpack_grads(name, want, d, h, {})
            return [errors(g[a][b], r[a][b]) for a in r for b in r[a]]

        got = bw.kernel_c(x1, g3, stats, pmask, pcount, w.c, 1e-5)
        want = bw.kernel_c_plain(x1, g3, stats, pmask, pcount, w.c, 1e-5)
        results["kernel_c"]["errs"] += [errors(got[0], want[0]), errors(got[1], want[1])]
        results["kernel_c"]["grad_errs"] += grad_errs("kernel_c", got[2], want[2])
        g2, a1 = want[0], want[1]
        got = bw.kernel_d(x1, g2, stats, a1, pmask, pcount, w.d, 1e-5)
        want = bw.kernel_d_plain(x1, g2, stats, a1, pmask, pcount, w.d, 1e-5)
        results["kernel_d"]["errs"].append(errors(got[0], want[0]))
        results["kernel_d"]["grad_errs"] += grad_errs("kernel_d", got[1], want[1])
        again = bw.kernel_d(x1, g2, stats, a1, pmask, pcount, w.d, 1e-5)
        d_bits &= torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
        del again
        g1 = want[0]
        got = bw.kernel_e(x, g1, smask, w.e, 1e-5)
        want = bw.kernel_e_plain(x, g1, smask, w.e, 1e-5)
        results["kernel_e"]["errs"].append(errors(got[0], want[0]))
        results["kernel_e"]["grad_errs"] += grad_errs("kernel_e", got[1], want[1])
        first = bw.fused_axial_block_bwd(x, x1, stats, g3, layer, smask, pmask, H)
        second = bw.fused_axial_block_bwd(x, x1, stats, g3, layer, smask, pmask, H)
        same_bits &= torch.equal(first[0], second[0]) and all(
            torch.equal(a, b) for a, b in zip(layer_leaves(first[1]), layer_leaves(second[1])))
        del got, want, first, second
        # one TF32 pass, on the one-pass forward's residuals
        _, x1o, stato = fused.fused_axial_block_res(x, layer, smask, pmask, 1e-5, "default")
        run = lambda f: f(x1o, g3, stato, pmask, pcount, w.c, 1e-5, 1)
        want = run(bw.kernel_c_plain)
        hold_one_pass(one["kernel_c"], "kernel_c", run(bw.kernel_c), want, run(bw.kernel_c))
        g2o, a1o = want[0], want[1]
        run = lambda f: f(x1o, g2o, stato, a1o, pmask, pcount, w.d, 1e-5, 1)
        want = run(bw.kernel_d_plain)
        hold_one_pass(one["kernel_d"], "kernel_d", run(bw.kernel_d), want, run(bw.kernel_d))
        g1o = want[0]
        run = lambda f: f(x, g1o, smask, w.e, 1e-5, 1)
        want = run(bw.kernel_e_plain)
        hold_one_pass(one["kernel_e"], "kernel_e", run(bw.kernel_e), want, run(bw.kernel_e))
        del want
        torch.cuda.synchronize()
        if case == "train":
            shapes = dict(x=x, x1=x1, stats=stats, g3=g3, g2=g2, a1=a1, g1=g1, smask=smask,
                          pmask=pmask, pcount=pcount, b=len(dims), p=x.shape[1], l=pad_l,
                          x1o=x1o, stato=stato, g2o=g2o, a1o=a1o, g1o=g1o)
    torch.cuda.empty_cache()

    t = shapes
    sites = t["b"] * t["p"] * t["l"]
    act = 4 * D * sites  # bytes of one (B, P, L, d) fp32 tensor
    stats_b, a1_b = 4 * t["b"] * t["l"] * 3 * D, 4 * t["b"] * t["l"] * D
    nw = {k: 4 * bw.grad_size(k, D, H) for k in ("kernel_c", "kernel_d", "kernel_e")}
    wb = 4 * bw.group_size(bw.C_PARTS, D, H), 4 * bw.group_size(bw.ATT_PARTS, D, H)

    def c(plain, n=3):
        f = bw.kernel_c_plain if plain else bw.kernel_c
        x1, st = (t["x1"], t["stats"]) if n == 3 else (t["x1o"], t["stato"])
        return lambda: f(x1, t["g3"], st, t["pmask"], t["pcount"], w.c, 1e-5, n)

    def dk(plain, n=3):
        f = bw.kernel_d_plain if plain else bw.kernel_d
        x1, g2, st, a1 = ((t["x1"], t["g2"], t["stats"], t["a1"]) if n == 3
                          else (t["x1o"], t["g2o"], t["stato"], t["a1o"]))
        return lambda: f(x1, g2, st, a1, t["pmask"], t["pcount"], w.d, 1e-5, n)

    def e(plain, n=3):
        f = bw.kernel_e_plain if plain else bw.kernel_e
        g1 = t["g1"] if n == 3 else t["g1o"]
        return lambda: f(t["x"], g1, t["smask"], w.e, 1e-5, n)

    # split TF32 on the tensor cores: the bound at three passes, the fp32
    # SIMT bound beside it; at one pass the FLOPs once
    nbytes = {"kernel_c": 3 * act + stats_b + a1_b + wb[0] + nw["kernel_c"],
              "kernel_d": 3 * act + stats_b + a1_b + wb[1] + nw["kernel_d"],
              "kernel_e": 3 * act + 4 * t["b"] * t["l"] + wb[1] + nw["kernel_e"]}
    flops = {"kernel_c": FLOPS_C, "kernel_d": FLOPS_D, "kernel_e": FLOPS_E}
    timed = {"kernel_c": c, "kernel_d": dk, "kernel_e": e}
    for name, fn in timed.items():
        r = results[name]
        r["ms"] = time_ms(fn(False))
        r["plain_ms"] = time_ms(fn(True))
        r["bound_ms"], r["bound_by"], r["bound_fp32_simt_ms"] = bound_tc(
            flops[name] * sites, nbytes[name])
        r["library_ms"] = None  # no single PyTorch call computes these functions
        r["one_pass"] = one_pass_row(one[name], time_ms(fn(False, 1)), bound(
            flops[name] * sites, nbytes[name], PEAK_TF32_FLOPS))
        torch.cuda.empty_cache()
    results["kernel_d"]["same_bits"] = d_bits
    return results, same_bits


def long_backward_kernel_checks(params, device):
    """Kernels E1 and E2 against their plain versions on the input the fused
    backward gives them above 1024 sites (layer 0 of pf_mre_r5, the block-0
    input of random alignments, g1 from kernels C and D on a seeded masked
    cotangent): at the (50, 1536) training bucket, 2 x 1225 pairs, and on a
    ragged batch (45 of 50 tips, 1100 of 1280 sites), every output compared
    on its own (E1 has no weight gradients; it is also held to its factored
    twin in float64, the exact value of its own association); E1 + E2
    against kernel E at 1024 sites (the same function, written twice); the
    same bits from two runs of E1, of E2 and of the whole block backward.
    Times at the training bucket, C's and D's there too; E1's as device time
    (``time_launches``: one launch takes well under a millisecond, which a
    single launch's events would share with the host's dispatch).  Then, on
    the one-pass forward's residuals at the training bucket and the ragged
    batch, C, D and E2 at one TF32 pass against their one-pass plain
    versions (every output and weight gradient, twice for the same bits),
    timed beside their one-pass bounds, and E1 at one pass against its own
    three-pass bits (it sums in exact fp32 at both)."""
    import torch

    from phyloformer_tpu_torch.ops.kernels import axial_block_bwd as bw
    from phyloformer_tpu_torch.ops.kernels import fused
    from phyloformer_tpu_torch.ops.kernels.autodiff import layer_leaves
    from phyloformer_tpu_torch.ops.kernels.pipeline import PipelineWeights

    layer = params["layers"][0]
    w = bw.BwdWeights.of(layer)
    w64 = bw.att_group(*({k: v.double() for k, v in layer[n].items()}
                         for n in ("row_norm", "row_attn")))
    pw = PipelineWeights.from_params(params)
    rng = np.random.default_rng(SEED + 5)
    cases = {"train": ([(50, 1536)] * 2, 50, 1536), "ragged": ([(45, 1100), (50, 1280)], 50, 1280),
             "l1024": ([(50, 1024), (47, 1000)], 50, 1024)}
    results = {"kernel_e1": {"errs": [], "factored_errs": [], "same_bits": True},
               "kernel_e2": {"errs": [], "grad_errs": [], "same_bits": True}}
    out = {"same_bits": True, "e1_one_pass_bits": True}
    one = {k: {"errs": [], "p999": []} for k in ("kernel_c", "kernel_d", "kernel_e2")}

    def grad_errs(got, want):
        g = bw.unpack_grads("kernel_e", got, D, H, {})
        r = bw.unpack_grads("kernel_e", want, D, H, {})
        return [errors(g[a][b], r[a][b]) for a in r for b in r[a]]

    for case, (dims, pad_n, pad_l) in cases.items():
        _, _, _, smask, pmask, pcount, x = block0_inputs(pw, rng, dims, pad_n, pad_l, device)
        _, x1, stats = fused.fused_axial_block_res(x, layer, smask, pmask)
        g3 = (torch.randn(x.shape, device=device,
                          generator=torch.Generator(device).manual_seed(SEED))
              * smask[:, None, :, None] * pmask[:, :, None, None]).contiguous()
        g2, a1, _ = bw.kernel_c(x1, g3, stats, pmask, pcount, w.c, 1e-5)
        g1, _ = bw.kernel_d(x1, g2, stats, a1, pmask, pcount, w.d, 1e-5)
        if case == "train":
            s = len(dims) * x.shape[1] * pad_l
            out["kernel_d_long_ms"] = time_ms(
                lambda: bw.kernel_d(x1, g2, stats, a1, pmask, pcount, w.d, 1e-5))
            (out["kernel_d_long_bound_ms"], _, out["kernel_d_long_bound_fp32_simt_ms"]) = bound_tc(
                FLOPS_D * s, 3 * 4 * D * s + 4 * len(dims) * pad_l * 4 * D
                + 4 * bw.group_size(bw.ATT_PARTS, D, H) + 4 * bw.grad_size("kernel_d", D, H))
        del g2, a1
        rowsums = bw.kernel_e1_plain(x, g1, smask, w.e, 1e-5)
        want = bw.kernel_e2_plain(x, g1, rowsums, smask, w.e, 1e-5)
        if case == "l1024":
            # the two forms of the row backward: E1 + E2 and kernel E
            got = bw.kernel_e2(x, g1, bw.kernel_e1(x, g1, smask, w.e, 1e-5), smask, w.e, 1e-5)
            ref = bw.kernel_e(x, g1, smask, w.e, 1e-5)
            s = len(dims) * x.shape[1] * pad_l
            out["kernel_e_l1024_ms"] = time_ms(lambda: bw.kernel_e(x, g1, smask, w.e, 1e-5))
            (out["kernel_e_l1024_bound_ms"], _,
             out["kernel_e_l1024_bound_fp32_simt_ms"]) = bound_tc(
                FLOPS_E * s, 3 * 4 * D * s + 4 * len(dims) * pad_l
                + 4 * bw.group_size(bw.ATT_PARTS, D, H) + 4 * bw.grad_size("kernel_e", D, H))
            out["e12_vs_e"] = errors(got[0], ref[0])[1]
            out["e12_vs_e_grads"] = max(e[1] for e in grad_errs(got[1], ref[1]))
            out["e12_vs_e_bits"] = bool(torch.equal(got[0], ref[0]))
            out["e12_vs_e_plain"] = max(errors(got[0], want[0])[1],
                                        max(e[1] for e in grad_errs(got[1], want[1])))
        else:
            got = bw.kernel_e1(x, g1, smask, w.e, 1e-5)
            again = bw.kernel_e1(x, g1, smask, w.e, 1e-5)
            results["kernel_e1"]["errs"].append(errors(got, rowsums))
            results["kernel_e1"]["factored_errs"].append(errors(got, bw.kernel_e1_factored(
                x.double(), g1.double(), smask.double(), w64, 1e-5)))
            results["kernel_e1"]["same_bits"] &= bool(torch.equal(got, again))
            got = bw.kernel_e2(x, g1, rowsums, smask, w.e, 1e-5)
            results["kernel_e2"]["errs"].append(errors(got[0], want[0]))
            results["kernel_e2"]["grad_errs"] += grad_errs(got[1], want[1])
            again = bw.kernel_e2(x, g1, rowsums, smask, w.e, 1e-5)
            results["kernel_e2"]["same_bits"] &= (torch.equal(got[0], again[0])
                                                  and torch.equal(got[1], again[1]))
            del again
        del got, want
        if case != "l1024":
            # one TF32 pass, on the one-pass forward's residuals
            _, x1o, stato = fused.fused_axial_block_res(x, layer, smask, pmask, 1e-5, "default")
            run = lambda f: f(x1o, g3, stato, pmask, pcount, w.c, 1e-5, 1)
            want = run(bw.kernel_c_plain)
            hold_one_pass(one["kernel_c"], "kernel_c", run(bw.kernel_c), want, run(bw.kernel_c))
            g2o, a1o = want[0], want[1]
            del want
            run = lambda f: f(x1o, g2o, stato, a1o, pmask, pcount, w.d, 1e-5, 1)
            want = run(bw.kernel_d_plain)
            hold_one_pass(one["kernel_d"], "kernel_d", run(bw.kernel_d), want, run(bw.kernel_d))
            g1o = want[0]
            del want
            e1 = bw.kernel_e1(x, g1o, smask, w.e, 1e-5, 1)
            out["e1_one_pass_bits"] &= bool(torch.equal(e1, bw.kernel_e1(x, g1o, smask, w.e,
                                                                          1e-5, 3)))
            rso = bw.kernel_e1_plain(x, g1o, smask, w.e, 1e-5, 1)
            run = lambda f: f(x, g1o, rso, smask, w.e, 1e-5, 1)
            want = run(bw.kernel_e2_plain)
            hold_one_pass(one["kernel_e2"], "kernel_e", run(bw.kernel_e2), want,
                          run(bw.kernel_e2))
            del want, e1
            if case == "train":
                s = len(dims) * x.shape[1] * pad_l
                act = 4 * D * s
                wc, wa = (4 * bw.group_size(g, D, H) for g in (bw.C_PARTS, bw.ATT_PARTS))
                for name, fn, flops, nbytes in (
                        ("kernel_c", lambda: bw.kernel_c(x1o, g3, stato, pmask, pcount, w.c,
                                                         1e-5, 1),
                         FLOPS_C, 3 * act + 4 * len(dims) * pad_l * 4 * D + wc
                         + 4 * bw.grad_size("kernel_c", D, H)),
                        ("kernel_d", lambda: bw.kernel_d(x1o, g2o, stato, a1o, pmask, pcount,
                                                         w.d, 1e-5, 1),
                         FLOPS_D, 3 * act + 4 * len(dims) * pad_l * 4 * D + wa
                         + 4 * bw.grad_size("kernel_d", D, H)),
                        ("kernel_e2", lambda: bw.kernel_e2(x, g1o, rso, smask, w.e, 1e-5, 1),
                         FLOPS_E, 3 * act + 4 * len(dims) * x.shape[1] * 4 * D
                         + 4 * len(dims) * pad_l + wa + 4 * bw.grad_size("kernel_e", D, H))):
                    one[name]["time"] = (time_ms(fn), bound(flops * s, nbytes,
                                                            PEAK_TF32_FLOPS))
            del x1o, stato, g2o, a1o, g1o, rso
        if case == "train":
            s = len(dims) * x.shape[1] * pad_l
            out["kernel_c_long_ms"] = time_ms(
                lambda: bw.kernel_c(x1, g3, stats, pmask, pcount, w.c, 1e-5))
            (out["kernel_c_long_bound_ms"], _, out["kernel_c_long_bound_fp32_simt_ms"]) = bound_tc(
                FLOPS_C * s, 3 * 4 * D * s + 4 * len(dims) * pad_l * 4 * D
                + 4 * bw.group_size(bw.C_PARTS, D, H) + 4 * bw.grad_size("kernel_c", D, H))
            first = bw.fused_axial_block_bwd(x, x1, stats, g3, layer, smask, pmask, H)
            second = bw.fused_axial_block_bwd(x, x1, stats, g3, layer, smask, pmask, H)
            out["same_bits"] = torch.equal(first[0], second[0]) and all(
                torch.equal(a, b) for a, b in zip(layer_leaves(first[1]), layer_leaves(second[1])))
            del first, second
            shapes = dict(x=x, g1=g1, smask=smask, rowsums=rowsums, b=len(dims), p=x.shape[1],
                          l=pad_l)
        torch.cuda.synchronize()
        del x, x1, g1, g3, stats
        torch.cuda.empty_cache()

    t = shapes
    sites = t["b"] * t["p"] * t["l"]
    act = 4 * D * sites  # bytes of one (B, P, L, d) fp32 tensor
    rows_b, smask_b = 4 * t["b"] * t["p"] * 4 * D, 4 * t["b"] * t["l"]
    wb, nw = 4 * bw.group_size(bw.ATT_PARTS, D, H), 4 * bw.grad_size("kernel_e", D, H)

    def e1(plain):
        f = bw.kernel_e1_plain if plain else bw.kernel_e1
        return lambda: f(t["x"], t["g1"], t["smask"], w.e, 1e-5)

    def e2(plain):
        f = bw.kernel_e2_plain if plain else bw.kernel_e2
        return lambda: f(t["x"], t["g1"], t["rowsums"], t["smask"], w.e, 1e-5)

    timed = {"kernel_e1": (e1(False), e1(True),
                           bound_tc(FLOPS_E1 * sites, 2 * act + smask_b + wb + rows_b)),
             "kernel_e2": (e2(False), e2(True),
                           bound_tc(FLOPS_E * sites, 3 * act + rows_b + smask_b + wb + nw))}
    for name, (kern, plain, bnd) in timed.items():
        r = results[name]
        r["ms"] = (time_launches({name: kern}, n=10, reps=5)[name] if name == "kernel_e1"
                   else time_ms(kern))
        r["plain_ms"] = time_ms(plain)
        r["bound_ms"], r["bound_by"] = bnd[:2]
        if len(bnd) == 3:
            r["bound_fp32_simt_ms"] = bnd[2]
        r["library_ms"] = None  # no single PyTorch call computes these functions
        torch.cuda.empty_cache()
    r = results["kernel_e1"]
    r["one_launch_ms"] = time_ms(timed["kernel_e1"][0])
    r["max_rel_err_factored"] = max(e[1] for e in r["factored_errs"])
    r["bound_share"] = r["bound_ms"] / r["ms"]
    out["one_pass"] = {k: one_pass_row(o, *o["time"]) for k, o in one.items()}
    return results, out


def random_newick(rng, names):
    """A random binary tree over ``names`` with exponential branch lengths."""
    nodes = [f"{n}:{rng.exponential(0.1):.6f}" for n in names]
    while len(nodes) > 2:
        i, j = sorted(rng.choice(len(nodes), 2, replace=False))
        b, a = nodes.pop(j), nodes.pop(i)
        nodes.append(f"({a},{b}):{rng.exponential(0.1):.6f}")
    return f"({nodes[0]},{nodes[1]});"


def write_corpus(root, rng, dims):
    """``root/trees/exNN.nwk`` and ``root/alns/exNN.fa``, one random tree and
    a matching alignment (about 2% gaps, rows in another order) per (n, L)."""
    from phyloformer_tpu_torch.data.alphabet import ALPHABET

    os.makedirs(os.path.join(root, "trees"))
    os.makedirs(os.path.join(root, "alns"))
    for k, (n, l) in enumerate(dims):
        names = [f"ex{k}_t{i}" for i in range(n)]
        with open(os.path.join(root, "trees", f"ex{k:02d}.nwk"), "w") as fh:
            fh.write(random_newick(rng, names) + "\n")
        codes = random_alignment(rng, n, l)
        with open(os.path.join(root, "alns", f"ex{k:02d}.fa"), "w") as fh:
            for i in rng.permutation(n):
                fh.write(f">{names[i]}\n{bytes(ALPHABET[c] for c in codes[i]).decode()}\n")


def expected_train_launches(steps, evals, n_blocks, long=False):
    """Per train step 6 A + 6 B + 6 C + 6 D + 6 E, with 6 stats reductions
    and 4 x 6 partial reductions (A1, and C's, D's and E's weight
    gradients); per eval batch 6 A + 6 B and 6 stats reductions.  Above 1024
    sites (``long``) A1 + A2 take A's place and E1 + E2 E's, with the same
    reductions (E2's weight gradients take E's)."""
    from phyloformer_tpu_torch.ops.kernels import pipeline as pipe

    fwd = ("kernel_a1", "kernel_a2") if long else ("kernel_a",)
    bwd = ("kernel_e1", "kernel_e2") if long else ("kernel_e",)
    n = {k: 0 for k in pipe.LAUNCHES}
    for k in fwd + ("kernel_b", "reduce_stats"):
        n[k] = n_blocks * (steps + evals)
    for k in ("kernel_c", "kernel_d") + bwd:
        n[k] = n_blocks * steps
    n["reduce_partials"] = 4 * n_blocks * steps
    return n


def training_path(device):
    """pf-train-torch on a synthetic corpus of 40 examples in the (50, 256)
    bucket (36 train, 4 validation): 8 steps at batch 4 with validations at
    steps 4 and 8, then resumed from the checkpoint of step 8 up to step 12.
    Returns the launches and their expectation per run, the step times and
    the checks' numbers."""
    import torch

    from phyloformer_tpu_torch.ops.kernels import pipeline as pipe
    from phyloformer_tpu_torch.train import cli

    root = os.path.join(WORK, "train")
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(SEED + 4)
    dims = [(50, 250)] * 30 + [(45, 250), (50, 230), (42, 200), (48, 256), (50, 180),
                               (44, 240), (50, 250), (47, 210), (50, 256), (49, 222)]
    write_corpus(os.path.join(root, "corpus"), rng, dims)
    out = os.path.join(root, "out")
    common = ["-t", os.path.join(root, "corpus", "trees"),
              "-a", os.path.join(root, "corpus", "alns"), "--base-model", CKPT,
              "--batch-size", "4", "--loss", "mre", "--check-val-every", "4",
              "--log-every", "1", "--warmup-steps", "2", "--learning-rate", "1e-4",
              # random sequences against random trees: the MRE is far above the
              # default divergence ceiling of 3, which would stop the run
              "--hard-loss-ceiling", "1e6",
              # one loading thread: the batches come in the same order in every
              # run, so that the default run sees the fp32 run's batches
              "--device", "cuda", "-o", out, "--num-workers", "1"]
    runs = []
    for extra in (["-n", "smoke", "--max-steps", "8"],
                  ["-n", "smoke", "--max-steps", "12", "--load-checkpoint",
                   os.path.join(out, "checkpoints_smoke")]):
        pipe.reset_launch_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(common + extra)
        torch.cuda.synchronize()
        runs.append(dict(rc=rc, stdout=buf.getvalue(), launches=dict(pipe.LAUNCHES),
                         wall_s=time.perf_counter() - t0))
        if rc != 0:
            fail(f"pf-train-torch exited {rc}")
    records = [json.loads(line) for line in
               open(os.path.join(out, "smoke_metrics.jsonl")).read().splitlines()]
    train_recs = [r for r in records if "train_loss" in r]
    val_steps = [r["step"] for r in records if "val_loss" in r]
    summaries = [json.loads(r["stdout"].strip().splitlines()[-1]) for r in runs]
    for k, (run, summary) in enumerate(zip(runs, summaries)):
        lo, hi = (0, 8) if k == 0 else (8, 12)
        evals = sum(1 for v in val_steps if lo < v <= hi)
        run["expected"] = expected_train_launches(summary["steps"] - lo, evals, 6)
        run["evals"] = evals
    # the metrics file's clock between logged steps of the first run (steps
    # 5 and 9 also hold the validation and checkpoint of steps 4 and 8)
    times = [r["time"] for r in train_recs[:8]]
    step_ms = [1e3 * (b - a) for a, b in zip(times, times[1:])]
    ckpts = sorted(f for f in os.listdir(os.path.join(out, "checkpoints_smoke")))
    return dict(runs=runs, summaries=summaries, train_steps=[r["step"] for r in train_recs],
                losses=[r["train_loss"] for r in train_recs], val_steps=val_steps,
                log_step_ms=step_ms, ckpts=ckpts, args=common, out=out,
                corpus=os.path.join(root, "corpus"))


def training_path_default(tp):
    """``pf-train-torch --matmul-precision default`` for the 8 steps of
    :func:`training_path`'s first run, on its corpus with its seed and
    arguments: the launch counts, each step's loss beside the fp32 run's,
    and the ms between logged steps."""
    import torch

    from phyloformer_tpu_torch.ops.kernels import pipeline as pipe
    from phyloformer_tpu_torch.train import cli

    pipe.reset_launch_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(tp["args"] + ["-n", "smoke_default", "--max-steps", "8",
                                    "--matmul-precision", "default"])
    torch.cuda.synchronize()
    launches, wall_s = dict(pipe.LAUNCHES), time.perf_counter() - t0
    if rc != 0:
        fail(f"pf-train-torch --matmul-precision default exited {rc}")
    records = [json.loads(line) for line in
               open(os.path.join(tp["out"], "smoke_default_metrics.jsonl")).read().splitlines()]
    train_recs = [r for r in records if "train_loss" in r]
    evals = sum(1 for r in records if "val_loss" in r)
    times = [r["time"] for r in train_recs]
    losses = [r["train_loss"] for r in train_recs]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, tp["losses"][:8])]
    return dict(launches=launches, expected=expected_train_launches(8, evals, 6), evals=evals,
                summary=json.loads(buf.getvalue().strip().splitlines()[-1]), wall_s=wall_s,
                steps=[r["step"] for r in train_recs], losses=losses, loss_rel=rel,
                log_step_ms=[1e3 * (b - a) for a, b in zip(times, times[1:])])


def long_training_path(device, n_timed=5, n_steps=2):
    """Training on long alignments: a synthetic corpus of 20 examples in the
    (50, 1536) bucket (42-50 tips, 1290-1536 sites, 2% gaps), packed with
    pf-preprocess-torch, then ``pf-train-torch --packed-data --base-model
    pf_mre_r5.ckpt --batch-size 2`` for 4 steps with one validation (a batch
    of the two held-out examples) at the end.  Then the step on the packed
    batches of 2 x 50 x 1536 at each of ``PRECISIONS`` (:func:`timed_steps`:
    ``n_timed`` timed after a warm-up, with their peak device memory,
    ``n_steps`` more under ``torch.profiler``), and ``--profile`` (10 traced
    steps).  Also writes the one-example corpus (20 tips, 1100 sites) of the
    long one-step check."""
    import torch

    from phyloformer_tpu_torch.ops.kernels import pipeline as pipe
    from phyloformer_tpu_torch.train import cli, cli_preprocess
    from phyloformer_tpu_torch.train.data import LoaderConfig
    from phyloformer_tpu_torch.train.packed import PackedBucketedLoader, PackedDataset, split

    root = os.path.join(WORK, "train_long")
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(SEED + 6)
    dims = [(int(rng.integers(42, 51)), int(rng.integers(1290, 1537))) for _ in range(20)]
    corpus, packed, out = (os.path.join(root, k) for k in ("corpus", "packed", "out"))
    write_corpus(corpus, rng, dims)
    write_corpus(os.path.join(root, "step"), rng, [(20, 1100)])
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_preprocess.main(["-t", os.path.join(corpus, "trees"), "-a",
                                  os.path.join(corpus, "alns"), "-o", packed,
                                  "--shard-size", "8"])
    preprocess_s = time.perf_counter() - t0
    if rc != 0:
        fail(f"pf-preprocess-torch exited {rc}")
    common = ["--packed-data", packed, "--base-model", CKPT, "--batch-size", "2",
              "--loss", "mre", "--warmup-steps", "2", "--learning-rate", "1e-4",
              "--hard-loss-ceiling", "1e6", "--log-every", "1", "--check-val-every", "1000",
              "--device", "cuda", "-o", out, "-n", "long"]
    pipe.reset_launch_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(common + ["--max-steps", "4"])
    torch.cuda.synchronize()
    launches, wall_s = dict(pipe.LAUNCHES), time.perf_counter() - t0
    if rc != 0:
        fail(f"pf-train-torch --packed-data exited {rc}")
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    records = [json.loads(line) for line in
               open(os.path.join(out, "long_metrics.jsonl")).read().splitlines()]

    # the step's time and peak memory at 2 x 50 x 1536, at fp32 and at one pass
    train_ds, _ = split(PackedDataset(packed), 0.1, 1337)
    loader = PackedBucketedLoader(train_ds, LoaderConfig(batch_size=2, shuffle=False))
    batches = [b for _, b in zip(range(1 + n_timed + n_steps), loader)]
    if len(batches) != 1 + n_timed + n_steps or any(
            b["codes"].shape != (2, 50, 1536) for b in batches):
        fail("long training: the packed corpus does not give batches of 2 x 50 x 1536")
    timed = {prec: timed_steps(device, batches, n_timed, prec) for prec in PRECISIONS}
    del batches
    torch.cuda.empty_cache()

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(common + ["--profile"])
    profile_s = time.perf_counter() - t0
    if rc != 0:
        fail(f"pf-train-torch --profile exited {rc}")
    prof = json.loads(buf.getvalue().strip().splitlines()[-1])
    traces = [f for f in os.listdir(prof["profile_dir"]) if f.endswith(".pt.trace.json")]
    torch.cuda.empty_cache()
    return dict(launches=launches, expected=expected_train_launches(summary["steps"], 1, 6, True),
                summary=summary, wall_s=wall_s, preprocess_s=preprocess_s,
                losses=[r["train_loss"] for r in records if "train_loss" in r],
                val_steps=[r["step"] for r in records if "val_loss" in r],
                timed=timed, profile=prof, traces=traces, profile_s=profile_s,
                step_corpus=os.path.join(root, "step"))


def one_step_check(device, corpus, pad_n, pad_l, precision="float32"):
    """One training batch (the first example of the corpus in its
    ``(pad_n, pad_l)`` bucket) through the kernels (forward_fused_ad, at the
    config's ``precision``: "default" runs their products in one TF32 pass)
    and through plain eager autograd in fp32, TF32 off: the loss and every
    gradient leaf.  Batch 1: eager autograd keeps ~25 activation-sized
    tensors and three 4d-wide ones per block, about 18 GB at 1 x 50 x 256
    and ~70 GB at batch 4."""
    import dataclasses

    import torch

    from phyloformer_tpu_torch.io.ckpt_import import load_pretrained
    from phyloformer_tpu_torch.models.params import map_params
    from phyloformer_tpu_torch.ops.kernels import pipeline as pipe
    from phyloformer_tpu_torch.train.data import load_example
    from phyloformer_tpu_torch.models.phyloformer import (
        forward, forward_fused_ad, pair_mask_from_seq_mask)
    from phyloformer_tpu_torch.train.losses import get_loss
    from phyloformer_tpu_torch.train.trainer import batch_to_device, make_batch, param_leaves

    params, cfg, _ = load_pretrained(CKPT)
    aln, vec = load_example(os.path.join(corpus, "trees", "ex00.nwk"),
                            os.path.join(corpus, "alns", "ex00.fa"))
    batch = batch_to_device(make_batch([aln], [vec], pad_n, pad_l), device)
    out = {}
    for fused_path in (True, False):
        p = map_params(lambda t: t.to(device).requires_grad_(True), params)
        pipe.reset_launch_counts()
        run_cfg = dataclasses.replace(cfg, matmul_precision=precision) if fused_path else cfg
        preds = (forward_fused_ad if fused_path else forward)(
            p, batch["codes"], run_cfg, batch["site_mask"], batch["seq_mask"])
        loss = get_loss("mre")(preds, batch["dists"],
                               pair_mask_from_seq_mask(batch["seq_mask"], pad_n))
        grads = torch.autograd.grad(loss, param_leaves(p))
        torch.cuda.synchronize()
        out[fused_path] = (loss.item(), [g.detach() for g in grads], dict(pipe.LAUNCHES))
        del p, loss, grads
        torch.cuda.empty_cache()
    (lk, gk, nk), (lp, gp, _) = out[True], out[False]
    return dict(loss_rel=abs(lk - lp) / abs(lp), loss=lk,
                grad_err=max(errors(a, b)[1] for a, b in zip(gk, gp)),
                launches=nk, n_leaves=len(gk))


# The trainer's matmul precisions timed: fp32 products, and one TF32 pass.
PRECISIONS = ("float32", "default")


def profile_training(device, corpus, n_timed=5, n_steps=3):
    """The training step's time and where it goes, at batch 4 x 50 x 256 on
    the corpus's batches, at each of ``PRECISIONS`` (:func:`timed_steps`)."""
    from phyloformer_tpu_torch.train.data import BucketedLoader, LoaderConfig, make_pairs

    loader = BucketedLoader(make_pairs(os.path.join(corpus, "trees"),
                                       os.path.join(corpus, "alns")),
                            LoaderConfig(batch_size=4, num_workers=1, shuffle=False))
    batches = [b for _, b in zip(range(1 + n_timed + n_steps), loader)]
    if len(batches) != 1 + n_timed + n_steps or any(
            b["codes"].shape != (4, 50, 256) for b in batches):
        fail("profile: the corpus does not give enough batches of 4 x 50 x 256")
    return {prec: timed_steps(device, batches, n_timed, prec) for prec in PRECISIONS}


def timed_steps(device, batches, n_timed, precision):
    """Train steps through ``make_train_step`` (the step ``fit`` runs) from
    pf_mre_r5 at ``precision`` on ``batches``: after one warm-up, the median
    host-clock time of ``n_timed`` steps, each ended by reading the loss,
    and their peak device memory; then the rest under ``torch.profiler``
    (:func:`profile_steps`: the device time per kernel name and step, the
    device's busy share of the wall time)."""
    import dataclasses

    import torch

    from phyloformer_tpu_torch.io.ckpt_import import load_pretrained
    from phyloformer_tpu_torch.train.trainer import (
        TrainConfig, create_train_state, make_train_step)

    params, cfg, _ = load_pretrained(CKPT)
    cfg = dataclasses.replace(cfg, matmul_precision=precision)
    tcfg = TrainConfig(loss="mre", learning_rate=1e-4, warmup_steps=2, total_steps=100,
                       use_pallas=True)
    state, tx = create_train_state(cfg, tcfg, params=params, device=device)
    step = make_train_step(cfg, tcfg, tx)
    state, logs = step(state, batches[0])
    float(logs["train_loss"])
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for b in batches[1:1 + n_timed]:
        t0 = time.perf_counter()
        state, logs = step(state, b)
        float(logs["train_loss"])
        step_ms.append(1e3 * (time.perf_counter() - t0))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prof = profile_steps(step, state, batches[1 + n_timed:])
    del state, tx, step
    torch.cuda.empty_cache()
    return dict(step_ms=statistics.median(step_ms), steps_ms=step_ms, peak_gb=peak_gb, **prof)


def profile_steps(step, state, batches):
    """``len(batches)`` train steps under ``torch.profiler``: the wall time
    per step, the device time per kernel name and step, and their sum, the
    device's busy time (one stream); E1's finalize (``kernel_e1_fin``, part
    of each ``kernel_e1`` launch) apart, as it is short of the top names."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            state, logs = step(state, b)
            float(logs["train_loss"])
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / len(batches)
    by_name = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3 / len(batches)
    return dict(wall_ms=wall_ms, device_ms=sum(by_name.values()),
                top=sorted(by_name.items(), key=lambda kv: -kv[1])[:14],
                e1_fin_ms=sum(ms for k, ms in by_name.items() if "kernel_e1_fin" in k))


def backward_phases(dev_params, device, card):
    """The fused backward's kernels against their plain versions, at three
    TF32 passes and at one: C, D and E at the training shape and ragged,
    then E1 and E2 above 1024 sites (C and D there too, E1 + E2 against E at
    1024 sites).  Prints each, fails on any bar, and returns the kernels'
    rows (with ``one_pass``, and for C, D and E2 ``one_pass_long``)."""
    import torch

    bwd, same_bits = backward_kernel_checks(dev_params, device)
    bad = [n for n, r in bwd.items() if not summarize(n, r, KERNEL_TOL, "", card)]
    bad += [n + " (one pass)" for n, r in bwd.items()
            if not report_one_pass(n, r["one_pass"], " at 4 x 1225 x 256", card)]
    print(f"backward: two runs give the same bits: {same_bits} (the block), "
          f"{bwd['kernel_d']['same_bits']} (kernel D)")
    if bad or not same_bits or not bwd["kernel_d"]["same_bits"]:
        fail(f"backward kernels disagree with their plain versions or between runs: {bad}")
    torch.cuda.empty_cache()

    # the L-tiled row backward (above 1024 sites) against its plain versions
    # and against kernel E
    bwd_long, e12 = long_backward_kernel_checks(dev_params, device)
    bad = [n for n, r in bwd_long.items()
           if not summarize(n, r, E12_TOL, " at 2 x 1225 x 1536", card)]
    bad += [n + " (one pass)" for n, r in e12["one_pass"].items()
            if not report_one_pass(n, r, " at 2 x 1225 x 1536 (and ragged 2 x 1225 x 1280)",
                                   card)]
    e1 = bwd_long["kernel_e1"]
    print(f"kernel_e1: {100 * e1['bound_share']:.1f}% of its {e1['bound_by']} bound "
          f"({e1['bound_ms']:.3f} of {e1['ms']:.3f} ms a launch, 10 queued; "
          f"{e1['one_launch_ms']:.3f} ms one launch alone, the host's dispatch included); "
          f"against its factored twin in float64 {e1['max_rel_err_factored']:.3e} "
          f"(tol {E12_TOL:.0e}); two runs give the same bits: {e1['same_bits']}; at one pass "
          f"its three-pass bits (exact fp32 at both): {e12['e1_one_pass_bits']} [{card}]")
    print(f"E1 + E2 vs kernel E at 1024 sites: gx {e12['e12_vs_e']:.3e} (same bits: "
          f"{e12['e12_vs_e_bits']}), weight gradients {e12['e12_vs_e_grads']:.3e}; vs the plain "
          f"versions {e12['e12_vs_e_plain']:.3e}; two runs give the same bits: "
          f"{bwd_long['kernel_e2']['same_bits']} (kernel E2), {e12['same_bits']} (the long "
          f"block backward)")
    for name, key, where in (("kernel_c", "kernel_c_long", "2 x 1225 x 1536"),
                             ("kernel_d", "kernel_d_long", "2 x 1225 x 1536"),
                             ("kernel_e", "kernel_e_l1024", "2 x 1225 x 1024")):
        for k in ("ms", "bound_ms", "bound_fp32_simt_ms"):
            bwd[name][f"{key[len(name) + 1:]}_{k}"] = e12[f"{key}_{k}"]
        print(f"{name} at {where}: {e12[key + '_ms']:.3f} ms, bound "
              f"{e12[key + '_bound_ms']:.3f} ms (split TF32; fp32 SIMT "
              f"{e12[key + '_bound_fp32_simt_ms']:.3f} ms) [{card}]")
    if (bad or not e12["same_bits"] or not bwd_long["kernel_e2"]["same_bits"]
            or not e1["same_bits"] or not e1["max_rel_err_factored"] <= E12_TOL
            or not e12["e12_vs_e"] <= E12_TOL or not e12["e1_one_pass_bits"]
            or not e12["e12_vs_e_grads"] <= GRAD_TOL or not e12["e12_vs_e_plain"] <= GRAD_TOL):
        fail(f"E1/E2 disagree with their plain versions, with kernel E or between runs: {bad}")
    for name in ("kernel_c", "kernel_d"):
        bwd[name]["one_pass_long"] = e12["one_pass"][name]
    bwd_long["kernel_e2"]["one_pass"] = e12["one_pass"]["kernel_e2"]
    bwd_long["kernel_e1"]["one_pass_bits"] = e12["e1_one_pass_bits"]
    bwd.update(bwd_long)
    torch.cuda.empty_cache()
    return bwd


def check_one_step(device, corpus, pad_n, pad_l, precision, where, long=False):
    """:func:`one_step_check` printed and held to its bars: at fp32 loss
    ``STEP_LOSS_TOL`` and leaves ``STEP_GRAD_TOL``, at one pass both
    ``STEP_ONE_PASS_TOL``; above 1024 sites also the launches of A1, A2, B,
    C, D, E1 and E2."""
    st = one_step_check(device, corpus, pad_n, pad_l, precision)
    lt, gt = ((STEP_LOSS_TOL, STEP_GRAD_TOL) if precision == "float32"
              else (STEP_ONE_PASS_TOL, STEP_ONE_PASS_TOL))
    print(f"one step at {precision}, kernels vs plain fp32 autograd ({where}, "
          f"{st['n_leaves']} leaves): loss {st['loss']:.6f} rel err {st['loss_rel']:.3e} "
          f"(tol {lt:.0e}), gradients {st['grad_err']:.3e} (tol {gt:.0e}), launches "
          f"{st['launches']}")
    if not (st["loss_rel"] <= lt and st["grad_err"] <= gt):
        fail(f"one step ({where}, {precision}): the kernel path's loss or gradients disagree "
             f"with plain autograd")
    if long and st["launches"] != expected_train_launches(1, 0, 6, True):
        fail("long one step: the kernel path did not run A1, A2, B, C, D, E1 and E2 per block")
    return st


def report_timed(label, shape, batch, timed, card):
    """Print the step times, rates, peak memory and profile of
    :func:`timed_steps` at each precision."""
    for prec, r in timed.items():
        print(f"{label} at {prec}: {r['step_ms']:.3f} ms per optimizer step (median after the "
              f"first; steps {[round(v, 3) for v in r['steps_ms']]}), "
              f"{1e3 * batch / r['step_ms']:.3f} examples/s at batch {shape}, peak device "
              f"memory {r['peak_gb']:.2f} GB [{card}]")
        print(f"{label} profile at {prec}: {r['wall_ms']:.3f} ms per step under the profiler, "
              f"device busy {r['device_ms']:.3f} ms "
              f"({100 * r['device_ms'] / r['wall_ms']:.1f}%) [{card}]")
        for name, ms in r["top"]:
            print(f"  {label} profile at {prec}: {ms:9.3f} ms/step  {name[:110]}")
        if r["e1_fin_ms"] > 0:
            print(f"  {label} profile at {prec}: {r['e1_fin_ms']:9.3f} ms/step  kernel_e1_fin "
                  f"(E1's finalize)")
        if r["device_ms"] <= 0:
            fail(f"{label} profile: the trace holds no device time")


def training_phases(device, card):
    """Training: pf-train-torch through the CLI and a resume, the same 8
    steps at ``--matmul-precision default``, one step against plain autograd
    at both precisions, the step's time and profile at both, then the long
    alignments' path (packed corpus, CLI, time and profile at both
    precisions, --profile) and its one-step checks.  Prints each, fails on
    any bar, and returns every run's launches and the numbers for the
    kernels line."""
    tp = training_path(device)
    for k, run in enumerate(tp["runs"]):
        print(f"training run {k + 1}: launches {run['launches']}, expected {run['expected']} "
              f"({run['evals']} eval batches), {run['wall_s']:.1f} s")
    print(f"training: steps {tp['train_steps']}, losses {tp['losses']}, "
          f"validations at {tp['val_steps']}, checkpoints {tp['ckpts']}")
    print("training: ms between logged steps 2-8 of the CLI run (validation and checkpoint "
          f"in 5 and 9): {[round(v, 3) for v in tp['log_step_ms']]}")
    if any(run["launches"] != run["expected"] for run in tp["runs"]):
        fail("training: launch counts differ from 6 A + 6 B + 6 C + 6 D + 6 E per step "
             "and 6 A + 6 B per eval batch")
    if ([s["steps"] for s in tp["summaries"]] != [8, 12]
            or "resumed from step 8" not in tp["runs"][1]["stdout"]
            or tp["train_steps"] != list(range(1, 13)) or tp["val_steps"] != [4, 8, 8, 12, 12]
            or tp["ckpts"] != ["ckpt_12.pt", "ckpt_4.pt", "ckpt_8.pt"]
            or not all(math.isfinite(v) for v in tp["losses"])
            or not all(s["use_pallas"] for s in tp["summaries"])):
        fail("training: steps, resume, validations, checkpoints or losses are not as expected")

    td = training_path_default(tp)
    print(f"training at default: launches {td['launches']}, expected {td['expected']} "
          f"({td['evals']} eval batches), {td['wall_s']:.1f} s; steps {td['steps']}, losses "
          f"{td['losses']}, relative to the fp32 run's {[f'{v:.2e}' for v in td['loss_rel']]} "
          f"(tol {TRAIN_ONE_PASS_LOSS_TOL:.0e})")
    print(f"training: ms between logged steps 2-8, fp32 "
          f"{[round(v, 3) for v in tp['log_step_ms']]}, default "
          f"{[round(v, 3) for v in td['log_step_ms']]} [{card}]")
    if td["launches"] != td["expected"]:
        fail("training at default: launch counts differ from 6 A + 6 B + 6 C + 6 D + 6 E per "
             "step and 6 A + 6 B per eval batch")
    if (td["steps"] != list(range(1, 9)) or td["summary"]["steps"] != 8
            or not td["summary"]["use_pallas"] or len(td["loss_rel"]) != 8
            or not all(v <= TRAIN_ONE_PASS_LOSS_TOL for v in td["loss_rel"])):
        fail("training at default: steps or losses off the fp32 run's")

    st = {prec: check_one_step(device, tp["corpus"], 50, 256, prec, "1 x 50 x 256")
          for prec in PRECISIONS}
    prof = profile_training(device, tp["corpus"])
    report_timed("training", "4 x 50 x 256", 4, prof, card)

    # training on long alignments from a packed corpus
    lt = long_training_path(device)
    print(f"long training: pf-preprocess-torch {lt['preprocess_s']:.1f} s; pf-train-torch "
          f"--packed-data launches {lt['launches']}, expected {lt['expected']}, "
          f"{lt['wall_s']:.1f} s")
    print(f"long training: summary {json.dumps(lt['summary'])}, losses {lt['losses']}, "
          f"validations at {lt['val_steps']}")
    report_timed("long training", "2 x 50 x 1536", 2, lt["timed"], card)
    print(f"long training: --profile {json.dumps(lt['profile'])} in {lt['profile_s']:.1f} s, "
          f"traces {lt['traces']}")
    if lt["launches"] != lt["expected"]:
        fail("long training: launch counts differ from 6 A1 + 6 A2 + 6 B + 6 C + 6 D + 6 E1 "
             "+ 6 E2 per step and 6 A1 + 6 A2 + 6 B per eval batch")
    if (lt["summary"]["steps"] != 4 or not lt["summary"]["use_pallas"]
            or lt["val_steps"] != [4] or len(lt["losses"]) != 4
            or not all(math.isfinite(v) for v in lt["losses"])):
        fail("long training: steps, validation or losses are not as expected")
    if lt["profile"]["steps"] != 10 or len(lt["traces"]) != 1:
        fail("long training: --profile did not trace 10 steps into one trace file")
    st_long = {prec: check_one_step(device, lt["step_corpus"], 20, 1280, prec,
                                    "1 x 20 x 1100 in the (20, 1280) bucket", long=True)
               for prec in PRECISIONS}

    numbers = {"loss_rel_default_vs_fp32": td["loss_rel"],
               "one_step": {f"{prec} {where}": {k: r[k] for k in ("loss_rel", "grad_err")}
                            for where, d in (("1 x 50 x 256", st), ("1 x 20 x 1100", st_long))
                            for prec, r in d.items()}}
    for prec in PRECISIONS:
        for key, batch, timed in (("", 4, prof), ("long_", 2, lt["timed"])):
            r = timed[prec]
            numbers[f"{key}ms_per_step_{prec}"] = r["step_ms"]
            numbers[f"{key}examples_per_s_{prec}"] = 1e3 * batch / r["step_ms"]
            numbers[f"{key}peak_gb_{prec}"] = r["peak_gb"]
            numbers[f"{key}device_busy_{prec}"] = r["device_ms"] / r["wall_ms"]
    return dict(runs=[run["launches"] for run in tp["runs"]] + [td["launches"],
                                                                lt["launches"]],
                numbers=numbers, ckpt_dir=os.path.join(tp["out"], "checkpoints_smoke"),
                alns_dir=os.path.join(tp["corpus"], "alns"))


def plain_pipeline(w, codes, site_mask, seq_mask, passes, eps=1e-5):
    """The pipelined forward through the kernels' plain versions on the
    tensors' device (the engine's kernel route, plain): ``(B, P)``."""
    import torch

    from phyloformer_tpu_torch.data.pairs import pair_indices
    from phyloformer_tpu_torch.ops.kernels import pipeline as pipe

    n, l = codes.shape[1:]
    i, j = pair_indices(n)
    ii, jj = (torch.as_tensor(t, device=codes.device) for t in (i, j))
    emb = torch.relu((w.embed_w[codes.long()] + w.embed_b).to(w.param_dtype)).float()
    smask = site_mask.float()
    pmask = (seq_mask[:, ii.long()] & seq_mask[:, jj.long()]).float()
    pcount = pmask.sum(dim=1)
    if pipe.uses_gather(n, l, D):
        x1, st = pipe.kernel_p0_plain(emb, ii, jj, smask, pmask, w.row[0], w.col[0], eps, passes)
    else:
        x0 = emb[:, ii.long()] + emb[:, jj.long()]
        x1, st = pipe.kernel_a_only_plain(x0, smask, pmask, w.row[0], w.col[0], eps, passes)
    for k in range(len(w.row) - 1):
        x1, st = pipe.kernel_m_plain(x1, st, smask, pmask, pcount, w.b[k], w.row[k + 1],
                                     w.col[k + 1], eps, "exact", passes)
    return pipe.kernel_z_plain(x1, st, smask, pcount, w.b[-1], w.head, eps, "exact", passes)


def engine_vs_plain(engine, alns, passes):
    """The engine's predictions and their largest error (relative to
    max(1, max|ref|)) against :func:`plain_pipeline` on the same batches."""
    import torch

    from phyloformer_tpu_torch.infer.engine import real_pair_selector

    preds, worst = engine.predict(alns), 0.0
    with torch.inference_mode():
        for (pad_n, pad_l), idxs in engine._plan(alns):
            codes, sm, qm = engine._batch_inputs(alns, pad_n, pad_l, idxs)
            plain = plain_pipeline(engine.weights, codes, sm, qm, passes).cpu().numpy()
            for row, idx in enumerate(idxs):
                sel = real_pair_selector(pad_n, alns[idx].n_seqs)
                worst = max(worst, rel_err(preds[idx], plain[row, sel]))
            del codes, sm, qm, plain
            torch.cuda.empty_cache()
    return preds, worst


def post(url, body, ctype="text/plain", timeout=600):
    """(status, body text, seconds) of one POST."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body, headers={"Content-Type": ctype})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            code, text = r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        code, text = e.code, e.read().decode()
    return code, text, time.perf_counter() - t0


def ckpt_round_trip(device, train_dir, alns_dir):
    """pf-ckpt-torch export and convert of pf_mre_r5.ckpt (every parameter
    back bit-equal), then pf-infer-torch on the training phase's checkpoint
    directory against the engine on the restored parameters (the PHYLIP
    text equal).  Returns the numbers and the CLI run's launches."""
    import torch

    from phyloformer_tpu_torch.data.fasta import read_fasta
    from phyloformer_tpu_torch.data.phylip import vec_to_phylip
    from phyloformer_tpu_torch.infer import cli as infer_cli
    from phyloformer_tpu_torch.infer.engine import InferenceEngine
    from phyloformer_tpu_torch.io import cli as ckpt_cli
    from phyloformer_tpu_torch.io.ckpt_import import load_pretrained
    from phyloformer_tpu_torch.models.params import map_params
    from phyloformer_tpu_torch.ops.kernels import pipeline as pipe

    root = os.path.join(WORK, "serve")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    exp, npz = os.path.join(root, "export.ckpt"), os.path.join(root, "export.npz")
    with contextlib.redirect_stderr(io.StringIO()):
        rcs = [ckpt_cli.main(["export", CKPT, exp]), ckpt_cli.main(["convert", exp, npz])]

    def leaves(path):
        out = []
        map_params(out.append, load_pretrained(path)[0])
        return out

    ref = leaves(CKPT)
    bit_equal = {name: len(got) == len(ref) == 160
                 and all(torch.equal(a, b) for a, b in zip(got, ref))
                 for name, got in (("export", leaves(exp)), ("npz", leaves(npz)))}

    out_dir = os.path.join(root, "trained")
    pipe.reset_launch_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        rcs.append(infer_cli.main([train_dir, alns_dir, "-o", out_dir, "--device",
                                   device.type]))
    torch.cuda.synchronize()
    launches = dict(pipe.LAUNCHES)
    params, cfg, meta = load_pretrained(train_dir)
    names = sorted(f for f in os.listdir(alns_dir) if f.endswith(".fa"))
    alns = [read_fasta(os.path.join(alns_dir, f)) for f in names]
    preds = InferenceEngine(params, cfg, device=device).predict(alns)
    same_text = all(open(os.path.join(out_dir, f[:-3] + ".phy")).read()
                    == vec_to_phylip(p, a.ids)[1] for f, a, p in zip(names, alns, preds))
    return dict(rcs=rcs, bit_equal=bit_equal, trained_step=meta.get("step"),
                n_trained_alns=len(alns), same_text=same_text, launches=launches)


# (tips, sites) of the served requests: 16 related, then 8 ragged random ones
SERVE_DIMS = [(60, 250)] * 16 + [(20, 100), (24, 180), (28, 260), (32, 340), (36, 420),
                                 (40, 480), (45, 540), (50, 600)]


def serve_burst(extra_flags, bodies, queries=()):
    """pf-serve-torch's server from serve.cli.build_server (port 0, its
    default flags plus ``extra_flags``) takes one warm-up request, then
    every body at once, then each query on body 16.  The engine's micro-batches are recorded as it served
    them (alignments and predictions, around its predict).  Returns the
    answers, the batches, healthz, the launches and the burst's times."""
    import threading
    import urllib.request

    import torch

    from phyloformer_tpu_torch.ops.kernels import pipeline as pipe
    from phyloformer_tpu_torch.serve import cli as serve_cli

    server = serve_cli.build_server([CKPT, "--port", "0", "--host", "127.0.0.1"]
                                    + extra_flags)
    engine, batches = server.batcher.engine, []
    predict = engine.predict

    def recording(alns):
        preds = predict(alns)
        batches.append((list(alns), preds))
        return preds

    engine.predict = recording
    server.start_background()
    url = f"http://127.0.0.1:{server.port}"
    post(url + "/predict", *bodies[0])  # warm: the server's first request is not timed
    batches.clear()
    engine_s0 = engine.stats["device_s"]
    answers = [None] * len(bodies)

    def worker(k):
        answers[k] = post(url + "/predict", *bodies[k])

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(len(bodies))]
    pipe.reset_launch_counts()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    n_burst, engine_s = len(batches), engine.stats["device_s"] - engine_s0
    extra = {q: post(url + f"/predict?{q}", *bodies[16]) for q in queries}
    torch.cuda.synchronize()
    launches = dict(pipe.LAUNCHES)
    with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
        health = json.loads(r.read().decode())
    server.shutdown()
    if not all(a is not None and a[0] == 200 for a in answers + list(extra.values())):
        fail(f"serving ({extra_flags}): answers {[a and a[0] for a in answers]}, "
             f"{ {q: a[0] for q, a in extra.items()} }")
    return dict(answers=answers, extra=extra, batches=batches, n_burst=n_burst,
                icfg=engine.icfg, health=health, launches=launches, wall_s=wall,
                engine_s=engine_s)


def serving(device, params, cfg):
    """24 concurrent requests to pf-serve-torch's server at its default
    flags (one TF32 pass), then phylip, nj and bme on one of them, and the
    same burst at ``--precision float32``.  Each answer against the engine
    replaying the micro-batch it was served in, against an in-process engine
    of the server's configuration given all 24 at once (how far an answer
    depends on its batch-mates), and against the plain fp32 model.  Returns
    the checks' numbers, the launches, the rates and the latencies."""
    from phyloformer_tpu_torch.data.fasta import Alignment
    from phyloformer_tpu_torch.data.phylip import read_phylip
    from phyloformer_tpu_torch.infer.engine import InferenceEngine

    rng = np.random.default_rng(SEED + 9)
    alns = []
    for k, (n, l) in enumerate(SERVE_DIMS):
        codes = evolved_alignment(rng, n, l) if k < 16 else random_alignment(rng, n, l)
        alns.append(Alignment(codes.astype(np.int8), [f"r{k}_{j}" for j in range(n)]))
    bodies = []
    for k, a in enumerate(alns):
        text = fasta_text(a.codes, a.ids)
        bodies.append((json.dumps({"fasta": text}).encode(), "application/json")
                      if k >= 16 and k % 2 else (text.encode(), "text/plain"))
    on_cpu = ["--device", "cpu"] if device.type == "cpu" else []
    runs = {"one_pass": serve_burst(on_cpu, bodies, ("format=phylip", "tree=nj", "tree=bme")),
            "float32": serve_burst(on_cpu + ["--precision", "float32"], bodies)}

    index = {a.ids[0]: k for k, a in enumerate(alns)}
    out = {}
    for name, run in runs.items():
        served = []
        for a, (_, text, _) in zip(alns, run["answers"]):
            got = json.loads(text)
            if got["ids"] != a.ids:
                fail("serving: an answer's ids differ from its request's")
            i, j = np.triu_indices(a.n_seqs, 1)
            served.append(np.array(got["distances"])[i, j])
        twin = InferenceEngine(params, cfg, run["icfg"], device=device)
        replay, as_served = 0.0, True
        for b, (batch, preds) in enumerate(run["batches"]):
            for a, p, q in zip(batch, preds, twin.predict(batch)):
                replay = max(replay, rel_err(q, p))
                if b < run["n_burst"]:  # the burst's answers are these predictions
                    as_served &= bool(np.array_equal(np.round(p.astype(np.float64), 10),
                                                     served[index[a.ids[0]]]))
        together = twin.predict(alns)
        lat = [a[2] for a in run["answers"]]
        out[name] = dict(
            replay=replay, as_served=as_served,
            batch_mates=max(rel_err(s, w) for s, w in zip(served, together)),
            health=run["health"], launches=run["launches"], engine_s=run["engine_s"],
            burst_batches=run["n_burst"], req_per_s=len(alns) / run["wall_s"], p50_ms=1e3 * float(np.percentile(lat, 50)),
            p99_ms=1e3 * float(np.percentile(lat, 99)), served=served)
    r = out["one_pass"]
    plain = plain_refs(params, cfg, alns, device)
    r["vs_plain"] = max(rel_err(s, p) for s, p in zip(r["served"], plain))
    r["vs_plain_related"] = max(rel_err(s, p) for s, p in zip(r["served"][:16], plain[:16]))
    extra = runs["one_pass"]["extra"]
    dm, ids = read_phylip(extra["format=phylip"][1])
    i, j = np.triu_indices(len(ids), 1)
    r["phylip_ok"] = ids == alns[16].ids and np.abs(dm[i, j] - r["served"][16]).max() <= 1e-9
    r["trees_ok"] = all(sorted(t.split(":")[0].strip("(),;") for t in
                               json.loads(extra[q][1])["newick"].split(","))
                        == sorted(alns[16].ids) for q in ("tree=nj", "tree=bme"))
    for v in out.values():
        del v["served"]
    return out


def routes_on_card(device, params, cfg, alns, refs):
    """The engine at precision "bfloat16" (kernels, three passes) against
    its plain twins on the card, and the eager route at fp32 and bf16: each
    route's aln/s, launches and error against the plain fp32 model."""
    from phyloformer_tpu_torch.infer.engine import InferenceConfig, InferenceEngine
    from phyloformer_tpu_torch.ops.kernels import pipeline as pipe

    out = {}
    for name, icfg in (("kernels_bf16", InferenceConfig(precision="bfloat16")),
                       ("eager_fp32", InferenceConfig(use_kernels=False)),
                       ("eager_bf16", InferenceConfig(use_kernels=False, precision="bfloat16"))):
        eng = InferenceEngine(params, cfg, icfg, device=device)
        pipe.reset_launch_counts()
        rate = throughput(eng, alns)
        launches = dict(pipe.LAUNCHES)
        if name == "kernels_bf16":
            preds, twin = engine_vs_plain(eng, alns, 3)
        else:
            preds, twin = eng.predict(alns), None
        out[name] = dict(aln_per_s=rate, launches=launches, twin_err=twin,
                         finite=all(np.isfinite(p).all() for p in preds),
                         vs_plain=abs_rel(preds, refs), preds=preds)
        del eng
    cpu = InferenceEngine(params, cfg, InferenceConfig(use_kernels=False, precision="bfloat16"),
                          device="cpu").predict(alns[:EAGER_CPU_ALNS])
    ulp = 2.0 ** (np.floor(np.log2(max(float(np.abs(c).max()) for c in cpu))) - 7)
    for name in ("eager_bf16", "eager_fp32"):
        out[name]["vs_cpu_bf16_ulps"] = max(
            float(np.abs(p - c).max()) for p, c in zip(out[name]["preds"], cpu)) / ulp
    return out


def serving_phase(device, card, train_dir, alns_dir, head_alns, head_refs, kernel_rate,
                  kernel_err):
    """The checkpoint round trip, serving through pf-serve-torch's entry
    point, and the bf16 and eager routes on the card; fails on any bar.
    Returns the launches of every run that counts and the numbers."""
    from phyloformer_tpu_torch.io.ckpt_import import load_pretrained

    t = time.perf_counter()
    ck = ckpt_round_trip(device, train_dir, alns_dir)
    print(f"checkpoints: pf-ckpt-torch export / convert / pf-infer-torch exit {ck['rcs']}; "
          f"export and npz bit-equal to pf_mre_r5.ckpt: {ck['bit_equal']}; pf-infer-torch on "
          f"the trainer's directory (step {ck['trained_step']}, {ck['n_trained_alns']} "
          f"alignments) gives the engine's PHYLIP text: {ck['same_text']}; launches "
          f"{ {k: v for k, v in ck['launches'].items() if v} }")
    if ck["rcs"] != [0, 0, 0] or not all(ck["bit_equal"].values()) or not ck["same_text"]:
        fail("checkpoints: the round trip or the trainer directory's predictions differ")

    params, cfg, _ = load_pretrained(CKPT)
    out = serving(device, params, cfg)
    sv, s32 = out["one_pass"], out["float32"]
    for name, r in out.items():
        print(f"serving ({name}): {r['health']['requests']} requests in "
              f"{r['health']['batches']} batches; launches "
              f"{ {k: v for k, v in r['launches'].items() if v} }; {r['req_per_s']:.3f} "
              f"requests/s, latency p50 {r['p50_ms']:.1f} ms, p99 {r['p99_ms']:.1f} ms "
              f"(16 x 60 x 250 related + 8 ragged 20-50 x 100-600; the burst in "
              f"{r['burst_batches']} micro-batches, {r['engine_s']:.3f} s inside the engine's "
              f"predict) [{card}]")
        print(f"serving ({name}): answers vs the engine replaying their micro-batches "
              f"{r['replay']:.3e} (tol {KERNEL_TOL:.0e}; the served JSON is the batch's "
              f"prediction: {r['as_served']}); vs an engine of the server's configuration "
              f"given all 24 at once {r['batch_mates']:.3e} (tol "
              f"{ONE_PASS_TOL if name == 'one_pass' else KERNEL_TOL:.0e})")
    print(f"serving (one_pass): vs the plain fp32 model {sv['vs_plain']:.3e} (related "
          f"{sv['vs_plain_related']:.3e}; gate {GATE:.0e}); phylip {sv['phylip_ok']}, nj/bme "
          f"leaf sets {sv['trees_ok']}")
    for name, r in out.items():
        lc = r["launches"]
        if not (r["health"]["batches"] < r["health"]["requests"] and lc["kernel_m"] > 0
                and lc["kernel_z"] > 0 and lc["kernel_p0"] + lc["kernel_a_only"] > 0):
            fail(f"serving ({name}): no micro-batching, or the served batches did not run "
                 "P0/A-only, M, Z")
        if not (r["replay"] <= KERNEL_TOL and r["as_served"]):
            fail(f"serving ({name}): answers differ from their micro-batches' replay")
    # an answer depends on its batch-mates through the batch size, which
    # sets the column stats' slot count and so their order of summation: an
    # fp32 rounding at three passes, a TF32 rounding flip at one
    if not (s32["batch_mates"] <= KERNEL_TOL and sv["batch_mates"] <= ONE_PASS_TOL):
        fail("serving: answers depend on their batch-mates beyond the bars")
    if not (sv["vs_plain"] <= GATE and sv["phylip_ok"] and sv["trees_ok"]):
        fail("serving: answers off the gate, or phylip/tree answers wrong")

    rt = routes_on_card(device, params, cfg, head_alns, head_refs)
    print(f"routes on {len(head_alns)} alignments of 60 x 250 vs the plain fp32 model (max abs, "
          f"relative): kernels fp32 {kernel_rate:.3f} aln/s (the main path's worst relative "
          f"{kernel_err:.3e}); "
          + "; ".join(f"{n} {r['aln_per_s']:.3f} aln/s ({r['vs_plain'][0]:.3e}, "
                      f"{r['vs_plain'][1]:.3e})" for n, r in rt.items()) + f" [{card}]")
    kb = rt["kernels_bf16"]
    print(f"kernels at bf16 parameters vs their plain twins on the card {kb['twin_err']:.3e} "
          f"(tol {BF16_TWIN_TOL:.0e}); launches {kb['launches']}; eager launches "
          f"{sum(rt['eager_fp32']['launches'].values())}, "
          f"{sum(rt['eager_bf16']['launches'].values())}")
    if not kb["twin_err"] <= BF16_TWIN_TOL or not kb["launches"]["kernel_m"]:
        fail("bf16 kernel route: off its plain twins, or the kernels did not run")
    if any(sum(rt[n]["launches"].values()) for n in ("eager_fp32", "eager_bf16")):
        fail("the eager route launched a kernel")
    eb, ef = rt["eager_bf16"]["vs_cpu_bf16_ulps"], rt["eager_fp32"]["vs_cpu_bf16_ulps"]
    print(f"eager bf16 on the card vs the eager bf16 route on the CPU ({EAGER_CPU_ALNS} "
          f"alignments): {eb:.3f} bf16 ulps of max|ref| (bar {EAGER_BF16_ULPS}); eager fp32 "
          f"on the card: {ef:.3f}")
    if not (eb <= EAGER_BF16_ULPS < ef):
        fail("the eager bf16 route on the card is off its CPU run, or the bar does not tell "
             "it from fp32")
    if not all(r["finite"] for r in rt.values()) or not rt["eager_fp32"]["vs_plain"][1] <= DIST_TOL:
        fail("the eager route's distances are off the plain model")
    print(f"serving phase: {time.perf_counter() - t:.1f} s")
    numbers = {"served": {name: {k: r[k] for k in ("req_per_s", "p50_ms", "p99_ms", "replay",
                                                  "batch_mates", "health", "engine_s",
                                                  "burst_batches")}
                          for name, r in out.items()},
               "served_vs_plain": sv["vs_plain"],
               "routes": {n: {"aln_per_s": r["aln_per_s"], "vs_plain": r["vs_plain"],
                              "twin_err": r["twin_err"],
                              "vs_cpu_bf16_ulps": r.get("vs_cpu_bf16_ulps")}
                          for n, r in rt.items()}}
    return dict(runs=[ck["launches"], sv["launches"], s32["launches"], kb["launches"]],
                numbers=numbers)


# ---- the sharded phase: the ('data', 'pair') mesh on one card ----------------
# Two gloo ranks on the one card: NCCL refuses two ranks on one device, so
# every collective here is staged through the host, and the numbers measure
# correctness and overheads, not scaling.  The NCCL route runs at world 1.

# The engine at data 1 x pair 2: one 200 x 1000 related alignment (19,900
# pairs, 2.6 GB an activation on each rank), one 40 x 1100 (the L-tiled
# A1/A2/B per shard) and a ragged pair in the (10, 256) bucket (45 pairs: the
# second shard holds a padding pair).
SHARD_ENGINE_DIMS = [(200, 1000), (40, 1100), (10, 180), (9, 230)]
# Training at data 1 x pair 2, one step at each shape (E1/E2 per shard at 1536).
SHARD_TRAIN_SHAPES = [(4, 50, 256), (2, 50, 1536)]
# Two ranks against the single-process two-kernel forward, relative to
# max(1, max|ref|); the sharded step's loss (relative) against the
# single-process fused step, JAX's bar (tests/test_training.py).  The
# parameters after the step are not compared: one Adam step from zero
# moments moves each by lr.g/(|g| + 1e-8), so two runs differ by at most
# 2.lr whatever their gradients.  The gradients are held instead: each
# leaf's largest error relative to its own largest magnitude, floored at
# SHARD_GRAD_FLOOR of the largest leaf's (a few leaves, the column
# attention's q and k biases, are sums that cancel to near zero, so their
# own magnitude is no scale for their rounding).  A planted fault (A1 left
# unreduced) must break that bar.
SHARD_TOL = 1e-5
SHARD_GRAD_TOL = 1e-4
SHARD_GRAD_FLOOR = 1e-2
SHARD_HEAD = 16  # 60 x 250 alignments at data 2 x pair 1
SHARD_SERVE = 8  # requests of the sharded server's burst


def shard_of(n_seqs, pair_index, pair, device):
    """A rank's pair shard of ``n_seqs`` sequences on a pair axis of ``pair``
    (its indices only: no process group)."""
    from phyloformer_tpu_torch.ops.kernels.sharded import pair_shard
    from phyloformer_tpu_torch.parallel.mesh import Mesh

    return pair_shard(n_seqs, Mesh({"data": 1, "pair": pair}, pair_index), device)


def shard_inputs(w, rng, dims, pad_n, pad_l, pair_index, device):
    """A random padded batch as block 0 of one pair shard (of two) sees it:
    the float masks, the global pair counts and the shard's pairs."""
    import torch

    from phyloformer_tpu_torch.ops.kernels.sharded import real_pairs

    codes, site_mask, seq_mask = batch_inputs(rng, dims, pad_n, pad_l, device)
    shard = shard_of(pad_n, pair_index, 2, device)
    emb = torch.relu(w.embed_w[codes.long()] + w.embed_b)
    return (site_mask.float().contiguous(), shard.pair_mask(seq_mask).float().contiguous(),
            real_pairs(seq_mask).sum(1).float(), shard.build(emb).contiguous())


def shard_kernel_checks(params, device):
    """Every kernel of the sharded paths against its plain version at the
    shapes a pair shard gives it (local P with padding pairs, the global
    pair count): A and B on the ragged pair's second shard, A1, A2 and B on
    the 40 x 1100 one's, C, D and E at 4 x 50 x 256 and E1, E2 at 2 x 50 x
    1536 (second shards, each with a padding pair); and kernel B on the
    200 x 1000 alignment's first shard from the global stats, timed beside
    its plain version and bound: the row of ``sharded.py:_kernel_b_host``.
    Returns each kernel's largest relative error and that row."""
    import torch

    from phyloformer_tpu_torch.ops.kernels import axial_block_bwd as bw
    from phyloformer_tpu_torch.ops.kernels import fused
    from phyloformer_tpu_torch.ops.kernels import pipeline as pipe

    w = pipe.PipelineWeights.from_params(params)
    rng = np.random.default_rng(SEED + 13)
    eps, errs = 1e-5, {}

    def hold(name, got, want):
        errs[name] = max(errs.get(name, 0.0), errors(got, want)[1])

    # A and B, A1, A2 and B
    for dims, pad_n, pad_l in (([(10, 180), (9, 230)], 10, 256), ([(40, 1100)], 40, 1280)):
        smask, pmask, pcount, x = shard_inputs(w, rng, dims, pad_n, pad_l, 1, device)
        if pad_l <= 1024:
            got = fused.kernel_a(x, smask, pmask, w.row[0], w.col[0], eps)
            want = pipe.kernel_a_only_plain(x, smask, pmask, w.row[0], w.col[0], eps)
            hold("kernel_a", got[0], want[0])
            hold("kernel_a", got[1], want[1])
        else:
            rowstats = fused.kernel_a1_plain(x, smask, w.row[0], eps)
            hold("kernel_a1", fused.kernel_a1(x, smask, w.row[0], eps), rowstats)
            got = fused.kernel_a2(x, rowstats, smask, pmask, w.row[0], w.col[0], eps)
            want = fused.kernel_a2_plain(x, rowstats, smask, pmask, w.row[0], w.col[0], eps)
            hold("kernel_a2", got[0], want[0])
            hold("kernel_a2", got[1], want[1])
        x1, stats = want
        hold("kernel_b", fused.kernel_b_host(x1, stats, pcount, w_layer(w, 0), eps),
             fused.kernel_b_plain(x1, stats, pcount, w.b[0], eps))
        del x, x1, stats, got, want
    # C, D, E; C, D, E1, E2
    layer = params["layers"][0]
    wb = bw.BwdWeights.of(layer)
    for dims, pad_n, pad_l in (([(50, 256)] * 4, 50, 256), ([(50, 1536)] * 2, 50, 1536)):
        smask, pmask, pcount, x = shard_inputs(w, rng, dims, pad_n, pad_l, 1, device)
        _, x1, stats = fused.fused_axial_block_res(x, layer, smask, pmask)
        g3 = (torch.randn(x.shape, device=device,
                          generator=torch.Generator(device).manual_seed(SEED))
              * smask[:, None, :, None] * pmask[:, :, None, None]).contiguous()
        got = bw.kernel_c(x1, g3, stats, pmask, pcount, wb.c, eps)
        want = bw.kernel_c_plain(x1, g3, stats, pmask, pcount, wb.c, eps)
        for a, b in zip(got, want):
            hold("kernel_c", a, b)
        g2, a1 = want[0], want[1]
        got = bw.kernel_d(x1, g2, stats, a1, pmask, pcount, wb.d, eps)
        want = bw.kernel_d_plain(x1, g2, stats, a1, pmask, pcount, wb.d, eps)
        for a, b in zip(got, want):
            hold("kernel_d", a, b)
        g1 = want[0]
        if pad_l <= 1024:
            got, want = (bw.kernel_e(x, g1, smask, wb.e, eps),
                         bw.kernel_e_plain(x, g1, smask, wb.e, eps))
            for a, b in zip(got, want):
                hold("kernel_e", a, b)
        else:
            rows = bw.kernel_e1_plain(x, g1, smask, wb.e, eps)
            hold("kernel_e1", bw.kernel_e1(x, g1, smask, wb.e, eps), rows)
            got, want = (bw.kernel_e2(x, g1, rows, smask, wb.e, eps),
                         bw.kernel_e2_plain(x, g1, rows, smask, wb.e, eps))
            for a, b in zip(got, want):
                hold("kernel_e2", a, b)
        del x, x1, stats, g1, g2, g3, got, want
        torch.cuda.empty_cache()

    # kernel B on the 200 x 1000 alignment's first shard, from the global stats
    codes = evolved_alignment(rng, 200, 1000)
    padded = np.zeros((1, 200, 1024), np.int32)
    padded[0, :, :1000] = codes
    codes = torch.from_numpy(padded).to(device)
    smask = (torch.arange(1024, device=device) < 1000).float()[None].contiguous()
    emb = torch.relu(w.embed_w[codes.long()] + w.embed_b)
    stats, count = 0, torch.full((1,), 19900.0, device=device)
    for k in (1, 0):
        shard = shard_of(200, k, 2, device)
        pmask = shard.pair_mask(torch.ones((1, 200), dtype=torch.bool, device=device)).float()
        x1, st = fused.kernel_a(shard.build(emb).contiguous(), smask, pmask.contiguous(),
                                w.row[0], w.col[0], eps)
        stats = stats + st
    del emb
    torch.cuda.empty_cache()
    got = fused.kernel_b_host(x1, stats, count, w_layer(w, 0), eps)
    hold("kernel_b_host", got, fused.kernel_b_plain(x1, stats, count, w.b[0], eps))
    del got
    torch.cuda.empty_cache()
    sites = x1.shape[0] * x1.shape[1] * x1.shape[2]
    ms, by, _ = bound_tc(FLOPS_B * sites, 2 * 4 * D * sites + 4 * x1.shape[2] * 3 * D)
    row = dict(shape=list(x1.shape),
               ms=time_ms(lambda: fused.kernel_b_host(x1, stats, count, w_layer(w, 0), eps)),
               plain_ms=time_ms(lambda: fused.kernel_b_plain(x1, stats, count, w.b[0], eps),
                                reps=2),
               bound_ms=ms, bound_by=by, library_ms=None)
    del x1, stats
    torch.cuda.empty_cache()
    return errs, row


def w_layer(w, k):
    """Layer ``k`` of PipelineWeights as the host functions take it."""
    from phyloformer_tpu_torch.ops.kernels.fused import BlockWeights

    return BlockWeights(w.row[k], w.col[k], w.b[k])


def rendezvous():
    """The ranks' rendezvous store (``TCPStore``), hosted by this process on a
    port it binds itself (port 0) and holds while the caller keeps the store:
    the ranks join it as clients, as under torchrun's agent store, so no rank
    binds a port and none can find it taken between its choice and its bind."""
    from torch import distributed as dist

    return dist.TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False)


def rank_env(rank, world, store):
    """torchrun's env:// variables for ``rank`` of ``world`` on the one card,
    joining ``store`` (:func:`rendezvous`) as a client."""
    return {**os.environ, "RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": "0",
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(store.port),
            "TORCHELASTIC_USE_AGENT_STORE": "True", "TORCHELASTIC_RESTART_COUNT": "0"}


def wait_ranks(procs, timeout, what):
    """Wait for every process; on the first failure or at the time limit kill
    the rest and fail.  Returns their (stdout, stderr)."""
    deadline = time.monotonic() + timeout
    while any(p.poll() is None for p in procs):
        if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            break
        time.sleep(0.2)
    outs = [p.communicate() for p in procs]
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            fail(f"{what}: rank {r} exited {p.returncode}: {err[-3000:]}")
    return outs


def sharded_worker(job_dir):
    """One rank of the sharded phase (``--sharded-worker DIR``, two ranks on
    the card over gloo): ShardedInferenceEngine at data 1 x pair 2 on
    ``SHARD_ENGINE_DIMS`` and at data 2 x pair 1 on the 60 x 250 set, then
    one sharded training step at each of ``SHARD_TRAIN_SHAPES`` (data 1 x
    pair 2, ``shard_pairs``); writes its results and launches to DIR."""
    import torch

    from phyloformer_tpu_torch.data.fasta import Alignment
    from phyloformer_tpu_torch.infer.engine import InferenceConfig, ShardedInferenceEngine
    from phyloformer_tpu_torch.io.ckpt_import import load_pretrained
    from phyloformer_tpu_torch.ops.kernels import axial_block_bwd as bwd_mod
    from phyloformer_tpu_torch.ops.kernels import pipeline as pipe
    from phyloformer_tpu_torch.ops.kernels import sharded as sharded_mod
    from phyloformer_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from phyloformer_tpu_torch.parallel.mesh import shutdown_distributed
    from phyloformer_tpu_torch.train.trainer import (
        TrainConfig, create_train_state, make_train_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = init_distributed("gloo", "cuda")
    rank = torch.distributed.get_rank()
    inp = dict(np.load(os.path.join(job_dir, "inputs.npz")))
    params, cfg, _ = load_pretrained(CKPT)
    out, info = {}, {"launches": {}, "s": {}, "reduced": {}}
    # every all-reduce over a group of the sharded paths, read from the
    # tensor reduced: (what, shape, bytes)
    reduced = []

    def tallied(what, reduce):
        def counting(t, group):
            if group is not None:
                kind = what if what == "a1" else ("stats" if t.dim() == 3 else "gradients")
                reduced.append((kind, list(t.shape), t.numel() * t.element_size()))
            return reduce(t, group)
        return counting

    sharded_mod.all_reduce_sum = tallied("sharded", sharded_mod.all_reduce_sum)
    bwd_mod.all_reduce_sum = tallied("a1", bwd_mod.all_reduce_sum)

    def run(name, fn):
        torch.cuda.synchronize()
        pipe.reset_launch_counts()
        reduced.clear()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        info["s"][name] = time.perf_counter() - t0
        info["launches"][name] = dict(pipe.LAUNCHES)
        info["reduced"][name] = list(reduced)
        return res

    def alns(prefix):
        keys = sorted((k for k in inp if k.startswith(prefix)), key=lambda k: int(k[len(prefix):]))
        return [Alignment(inp[k], [str(i) for i in range(len(inp[k]))]) for k in keys]

    pair = ShardedInferenceEngine(params, cfg, make_mesh(1, 2), InferenceConfig(),
                                  device=device)
    big = alns("engine")
    for k, p in enumerate(run("engine_pair", lambda: pair.predict(big))):
        out[f"engine{k}"] = p
    run("big_timed", lambda: pair.predict(big[:1]))  # 200 x 1000 alone, warm
    data = ShardedInferenceEngine(params, cfg, make_mesh(2, 1), InferenceConfig(),
                                  device=device)
    head = alns("head")
    for k, p in enumerate(run("engine_data", lambda: data.predict(head))):
        out[f"head{k}"] = p
    run("head_timed", lambda: data.predict(head))
    del pair, data
    torch.cuda.empty_cache()

    mesh = make_mesh(1, 2)
    tcfg = TrainConfig(loss="mre", learning_rate=1e-4, warmup_steps=0, total_steps=100,
                       use_pallas=True, shard_pairs=True)
    for b, n, l in SHARD_TRAIN_SHAPES:
        tag = f"train{l}"
        state, tx = create_train_state(cfg, tcfg, params=params, device=device)
        step = make_train_step(cfg, tcfg, tx, mesh=mesh)
        grads = capture_grads(tx)
        batch = {k: inp[f"{tag}.{k}"] for k in ("codes", "dists", "site_mask", "seq_mask")}
        state, logs = run(tag, lambda: step(state, batch))
        out[f"{tag}.loss"] = np.float64(logs["train_loss"].item())
        for i, g in enumerate(grads):
            out[f"{tag}.grad{i}"] = g.cpu().numpy()
        grads.clear()
        run(tag + "_timed", lambda: step(state, batch))  # a second step, warm
        del state, tx, step, grads
        torch.cuda.empty_cache()
    # the planted fault, outside the counted runs: the first shape's step
    # with A1 left unreduced (each shard's partial alone)
    b, n, l = SHARD_TRAIN_SHAPES[0]
    bwd = sharded_mod.fused_axial_block_bwd
    sharded_mod.fused_axial_block_bwd = lambda *a, **k: bwd(*a, **{**k, "pair_group": None})
    state, tx = create_train_state(cfg, tcfg, params=params, device=device)
    grads = capture_grads(tx)
    make_train_step(cfg, tcfg, tx, mesh=mesh)(
        state, {k: inp[f"train{l}.{k}"] for k in ("codes", "dists", "site_mask", "seq_mask")})
    for i, g in enumerate(grads):
        out[f"no_a1.grad{i}"] = g.cpu().numpy()
    sharded_mod.fused_axial_block_bwd = bwd
    del state, tx, grads
    np.savez(os.path.join(job_dir, f"rank{rank}.npz"), **out)
    with open(os.path.join(job_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(info, fh)
    shutdown_distributed()
    return 0


def leaf_names(tree, prefix=""):
    """The paths of a parameter tree's leaves, in the trainer's order."""
    if isinstance(tree, dict):
        return [q for k, v in tree.items() for q in leaf_names(v, f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [q for k, v in enumerate(tree) for q in leaf_names(v, f"{prefix}/{k}")]
    return [prefix]


def capture_grads(tx):
    """Record the gradients the optimizer ``tx`` is given (the step's,
    after their all-reduce) into the returned list."""
    seen = []
    update = tx.update

    def recording(grads):
        seen.extend(g.detach().clone() for g in grads)
        return update(grads)

    tx.update = recording
    return seen


def single_train_steps(params, cfg, inp, device):
    """The single-process fused step at each of ``SHARD_TRAIN_SHAPES``: its
    loss and gradients, and a warm step's seconds."""
    import torch

    from phyloformer_tpu_torch.train.trainer import (
        TrainConfig, create_train_state, make_train_step)

    refs = {}
    for b, n, l in SHARD_TRAIN_SHAPES:
        tag = f"train{l}"
        tcfg = TrainConfig(loss="mre", learning_rate=1e-4, warmup_steps=0, total_steps=100,
                           use_pallas=True)
        state, tx = create_train_state(cfg, tcfg, params=params, device=device)
        grads = capture_grads(tx)
        batch = {k: inp[f"{tag}.{k}"] for k in ("codes", "dists", "site_mask", "seq_mask")}
        step = make_train_step(cfg, tcfg, tx)
        state, logs = step(state, batch)
        refs[tag] = dict(loss=logs["train_loss"].item(), grads=[g.cpu().numpy() for g in grads])
        grads.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, logs = step(state, batch)  # a second step, warm
        logs["train_loss"].item()
        refs[tag]["step_s"] = time.perf_counter() - t0
        del state, tx, grads, step
        torch.cuda.empty_cache()
    return refs


def sharded_inputs(rng, head_alns):
    """The workers' inputs: the engine's alignments (``SHARD_ENGINE_DIMS``,
    the first related), ``SHARD_HEAD`` of the 60 x 250 set and a ragged
    random batch at each training shape."""
    from phyloformer_tpu_torch.data.pairs import n_pairs

    inp = {}
    for k, (n, l) in enumerate(SHARD_ENGINE_DIMS):
        codes = evolved_alignment(rng, n, l) if k == 0 else random_alignment(rng, n, l)
        inp[f"engine{k}"] = codes.astype(np.int8)
    for k, a in enumerate(head_alns[:SHARD_HEAD]):
        inp[f"head{k}"] = a.codes
    for b, n, l in SHARD_TRAIN_SHAPES:
        tag = f"train{l}"
        site_mask = np.ones((b, l), bool)
        site_mask[-1, l - l // 10:] = False
        seq_mask = np.ones((b, n), bool)
        seq_mask[-1, n - 5:] = False
        inp.update({f"{tag}.codes": rng.integers(0, 20, (b, n, l)).astype(np.int32),
                    f"{tag}.dists": rng.uniform(0.05, 2.0, (b, n_pairs(n))).astype(np.float32),
                    f"{tag}.site_mask": site_mask, f"{tag}.seq_mask": seq_mask})
    return inp


def post_all(url, bodies):
    """Every body POSTed at once; (status, text, seconds) each, and the wall
    seconds of the burst."""
    import threading

    answers = [None] * len(bodies)

    def worker(k):
        answers[k] = post(url, *bodies[k])

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(len(bodies))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    return answers, time.perf_counter() - t0


def sharded_serving(bodies):
    """``pf-serve-torch --distributed-init gloo --mesh-pair 2`` as two ranks
    on the card, and the unsharded server of the same (default) flags in
    this process: the burst of ``bodies`` at each.  Returns both answer
    sets and the sharded burst's wall seconds."""
    import signal

    from phyloformer_tpu_torch.serve import cli as serve_cli

    flags = [CKPT, "--port", "0", "--host", "127.0.0.1"]
    store = rendezvous()  # held until the ranks are waited for
    procs = [subprocess.Popen([sys.executable, "-m", "phyloformer_tpu_torch.serve.cli"] + flags
                              + ["--distributed-init", "gloo", "--mesh-pair", "2"], cwd=ROOT,
                              env=rank_env(r, 2, store), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        line = ""
        deadline = time.monotonic() + 300
        while "listening on" not in line:
            line = procs[0].stderr.readline()
            if not line or time.monotonic() > deadline:
                fail("sharded serving: rank 0 stopped before listening")
        url = f"http://127.0.0.1:{int(line.strip().rsplit(':', 1)[1])}/predict"
        post(url, *bodies[0])  # warm
        sharded, wall = post_all(url, bodies)
        procs[0].send_signal(signal.SIGINT)
        wait_ranks(procs, 120, "sharded serving")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    server = serve_cli.build_server(flags)
    server.start_background()
    try:
        url = f"http://127.0.0.1:{server.port}/predict"
        post(url, *bodies[0])
        single, _ = post_all(url, bodies)
    finally:
        server.shutdown()
    return sharded, single, wall


def nccl_cli(alns_dir, out_dir, store):
    """``pf-infer-torch --distributed-init --mesh-data 1`` at world size 1:
    the process group on nccl, on the card, joining ``store`` (started, not
    waited for)."""
    return subprocess.Popen(
        [sys.executable, "-m", "phyloformer_tpu_torch.infer.cli", CKPT, alns_dir, "-o", out_dir,
         "--distributed-init", "--mesh-data", "1", "--stats"], cwd=ROOT,
        env=rank_env(0, 1, store), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def sharded_phase(device, card, head_alns):
    """The sharded phase (see the module's docstring, item 12).  Fails on
    any bar; returns the launches of every sharded run, each kernel's error
    at the shard shapes, the row of ``_kernel_b_host`` and the numbers."""
    import torch

    from phyloformer_tpu_torch.data.fasta import Alignment
    from phyloformer_tpu_torch.data.phylip import read_phylip
    from phyloformer_tpu_torch.infer.engine import InferenceConfig, InferenceEngine
    from phyloformer_tpu_torch.io.ckpt_import import load_pretrained
    from phyloformer_tpu_torch.models.params import map_params

    t = time.perf_counter()
    params, cfg, _ = load_pretrained(CKPT)
    dev_params = map_params(lambda x: x.to(device), params)
    errs, b_host = shard_kernel_checks(dev_params, device)
    bad = {k: e for k, e in errs.items() if e > (E12_TOL if k in ("kernel_e1", "kernel_e2")
                                                  else KERNEL_TOL)}
    print(f"sharded: kernels at pair-shard shapes vs their plain versions (relative): "
          + ", ".join(f"{k} {e:.3e}" for k, e in errs.items()))
    if bad:
        fail(f"sharded: kernels off their plain versions at shard shapes: {bad}")
    print(f"sharded: kernel_b_host (one process: kernel B on a pair shard {b_host['shape']}, "
          f"both shards' stats summed) "
          f"{b_host['ms']:.3f} ms vs plain {b_host['plain_ms']:.3f} ms, bound "
          f"{b_host['bound_ms']:.3f} ms ({b_host['bound_by']}) [{card}]")

    # the single-process references
    rng = np.random.default_rng(SEED + 14)
    job = os.path.join(WORK, "sharded")
    shutil.rmtree(job, ignore_errors=True)
    os.makedirs(job)
    inp = sharded_inputs(rng, head_alns)
    np.savez(os.path.join(job, "inputs.npz"), **inp)

    def as_alns(prefix, count):
        return [Alignment(inp[f"{prefix}{k}"], [str(i) for i in range(len(inp[f"{prefix}{k}"]))])
                for k in range(count)]

    big = as_alns("engine", len(SHARD_ENGINE_DIMS))
    two_kernel = InferenceEngine(params, cfg, InferenceConfig(use_pipeline=False), device=device)
    refs = two_kernel.predict(big)
    t0 = time.perf_counter()
    two_kernel.predict(big[:1])
    single_big_s = time.perf_counter() - t0
    del two_kernel
    head = as_alns("head", SHARD_HEAD)
    engine = InferenceEngine(params, cfg, InferenceConfig(), device=device)
    head_refs = engine.predict(head)
    train_refs = single_train_steps(params, cfg, inp, device)
    del engine
    torch.cuda.empty_cache()

    # the NCCL route at world 1, beside the two gloo ranks
    nccl_dir = os.path.join(job, "nccl")
    os.makedirs(os.path.join(nccl_dir, "alns"))
    for k, a in enumerate(head[:4]):
        write_fasta(os.path.join(nccl_dir, "alns", f"a{k}.fa"), a.codes, k)
    nccl_store, store = rendezvous(), rendezvous()  # held until the ranks are waited for
    nccl = nccl_cli(os.path.join(nccl_dir, "alns"), os.path.join(nccl_dir, "out"), nccl_store)
    workers = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--sharded-worker",
                                 job], cwd=ROOT, env=rank_env(r, 2, store),
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
               for r in range(2)]
    wait_ranks(workers, 600, "sharded workers")
    (nccl_out, _), = wait_ranks([nccl], 300, "pf-infer-torch over nccl")
    ranks = [dict(np.load(os.path.join(job, f"rank{r}.npz"))) for r in range(2)]
    infos = []
    for r in range(2):
        with open(os.path.join(job, f"rank{r}.json")) as fh:
            infos.append(json.load(fh))
    same_bits = all(np.array_equal(ranks[0][k], ranks[1][k]) for k in ranks[0])

    big_err = max(rel_err(ranks[0][f"engine{k}"], r) for k, r in enumerate(refs))
    head_err = max(rel_err(ranks[0][f"head{k}"], r) for k, r in enumerate(head_refs))
    finite = all(np.isfinite(v).all() for v in ranks[0].values())
    # the stats all-reduced per block, by shape, as the ranks reduced them
    stats_bytes = {}
    for kind, shape, nbytes in infos[0]["reduced"]["engine_pair"]:
        if kind == "stats":
            stats_bytes[str(tuple(shape))] = nbytes
    big_stats = [x[2] for x in infos[0]["reduced"]["big_timed"] if x[0] == "stats"]
    big_s = infos[0]["s"]["big_timed"]
    head_s = infos[0]["s"]["head_timed"]
    print(f"sharded engine, data 1 x pair 2 (two ranks on one card, gloo; three TF32 passes): "
          f"vs the single-process two-kernel forward {big_err:.3e} (tol {SHARD_TOL:.0e}), every "
          f"value finite {finite}; both ranks the same bits {same_bits}; 200 x 1000: "
          f"{1 / big_s:.3f} aln/s ({big_s:.3f} s; one process {single_big_s:.3f} s); "
          f"stats all-reduced per block, by shape (B, L, 3d): {stats_bytes} bytes; 200 x 1000 "
          f"alone: {len(big_stats)} all-reduces, {sum(big_stats)} bytes [{card}]")
    print(f"sharded engine, data 2 x pair 1 on {SHARD_HEAD} x 60 x 250: vs the single-card "
          f"engine {head_err:.3e} (tol {KERNEL_TOL:.0e}); {SHARD_HEAD / head_s:.3f} aln/s "
          f"[{card}]")
    if not (same_bits and finite and big_err <= SHARD_TOL and head_err <= KERNEL_TOL):
        fail("sharded engine: ranks differ, or off the single-process forward")
    if len(big_stats) != cfg.n_blocks:
        fail(f"sharded engine: {len(big_stats)} stats all-reduces at 200 x 1000, "
             f"not one a block")

    names = leaf_names(params)

    def leaf_errs(prefix, ref_grads):
        """Each leaf's largest error relative to its own largest magnitude,
        floored at ``SHARD_GRAD_FLOOR`` of the largest leaf's."""
        floor = SHARD_GRAD_FLOOR * max(float(np.abs(g).max()) for g in ref_grads)
        return [float(np.abs(ranks[0][f"{prefix}.grad{i}"] - g).max()
                      / max(float(np.abs(g).max()), floor)) for i, g in enumerate(ref_grads)]

    train = {}
    for b, n, l in SHARD_TRAIN_SHAPES:
        tag, ref = f"train{l}", train_refs[f"train{l}"]
        loss = float(ranks[0][f"{tag}.loss"])
        errs_l = leaf_errs(tag, ref["grads"])
        mags = [float(np.abs(g).max()) for g in ref["grads"]]
        reduced = {}
        for kind, _, nbytes in infos[0]["reduced"][tag]:
            reduced[kind] = reduced.get(kind, 0) + nbytes
        train[tag] = dict(
            loss_rel=abs(loss - ref["loss"]) / abs(ref["loss"]), grad_err=max(errs_l),
            worst_leaf=names[int(np.argmax(errs_l))], leaf_max_abs=[min(mags), max(mags)],
            allreduce_bytes=reduced, step_s=infos[0]["s"][tag + "_timed"],
            single_step_s=ref["step_s"],
            launches=[{k: v for k, v in info["launches"][tag].items() if v} for info in infos])
        r = train[tag]
        print(f"sharded training step {b} x {n} x {l} (data 1 x pair 2, two ranks on one card, "
              f"gloo): loss {r['loss_rel']:.3e} relative (tol {SHARD_TOL:.0e}), gradients: "
              f"worst leaf {r['grad_err']:.3e} of its own max|g| ({r['worst_leaf']}, floor "
              f"{SHARD_GRAD_FLOOR:.0e} of the largest, tol {SHARD_GRAD_TOL:.0e}; the {len(mags)} "
              f"leaves' max|g| from {min(mags):.3e} to {max(mags):.3e}) from the single-process "
              f"fused step; a warm step "
              f"{1e3 * r['step_s']:.1f} ms (one process {1e3 * r['single_step_s']:.1f} ms); "
              f"all-reduced bytes a step {reduced}; launches per rank {r['launches']} [{card}]")
        bwd = ("kernel_e1", "kernel_e2") if l > 1024 else ("kernel_e",)
        if not (r["loss_rel"] <= SHARD_TOL and r["grad_err"] <= SHARD_GRAD_TOL):
            fail(f"sharded training at {l} sites: off the single-process step")
        if any(lc.get(k, 0) != cfg.n_blocks for lc in r["launches"]
               for k in ("kernel_c", "kernel_d") + bwd):
            fail(f"sharded training at {l} sites: C, D, E (E1, E2) not launched once a block on "
                 "each rank")
    planted = leaf_errs("no_a1", train_refs[f"train{SHARD_TRAIN_SHAPES[0][2]}"]["grads"])
    print(f"sharded training, planted fault (A1 not all-reduced) at {SHARD_TRAIN_SHAPES[0]}: "
          f"worst leaf {max(planted):.3e} ({names[int(np.argmax(planted))]}; must exceed "
          f"{SHARD_GRAD_TOL:.0e}), "
          f"{sum(e > SHARD_GRAD_TOL for e in planted)} of {len(planted)} leaves beyond it")
    if not max(planted) > SHARD_GRAD_TOL:
        fail("sharded training: the gradient bar does not see A1 left unreduced")

    stats = json.loads(nccl_out.strip().splitlines()[-1])
    nccl_err = 0.0
    for k in range(4):
        dm, _ = read_phylip(os.path.join(nccl_dir, "out", f"a{k}.phy"))
        i, j = np.triu_indices(len(dm), 1)
        nccl_err = max(nccl_err, rel_err(dm[i, j], head_refs[k]))
    print(f"pf-infer-torch --distributed-init --mesh-data 1 (world 1): backend "
          f"{stats.get('backend')}, mesh {stats.get('mesh')}, {stats['alignments']} alignments, "
          f"vs the engine {nccl_err:.3e} (tol {KERNEL_TOL:.0e}; 10-decimal PHYLIP)")
    if stats.get("backend") != "nccl" or not nccl_err <= KERNEL_TOL:
        fail("pf-infer-torch over nccl: not nccl, or off the engine")

    srng = np.random.default_rng(SEED + 15)
    bodies = []
    for k in range(SHARD_SERVE):
        n, l = (60, 250) if k < SHARD_SERVE // 2 else (int(srng.integers(20, 51)),
                                                        int(srng.integers(100, 601)))
        codes = evolved_alignment(srng, n, l) if k < SHARD_SERVE // 2 else random_alignment(
            srng, n, l)
        bodies.append((fasta_text(codes, [f"s{k}_{i}" for i in range(n)]).encode(),))
    sharded, single, wall = sharded_serving(bodies)
    if not all(a[0] == 200 for a in sharded + single):
        fail(f"sharded serving: statuses {[a[0] for a in sharded]}, {[a[0] for a in single]}")
    serve_err = max(rel_err(np.array(json.loads(a[1])["distances"]),
                            np.array(json.loads(b[1])["distances"]))
                    for a, b in zip(sharded, single))
    print(f"pf-serve-torch --distributed-init gloo --mesh-pair 2 (two ranks on one card, gloo; "
          f"default flags, one TF32 pass): {SHARD_SERVE} concurrent requests in {wall:.3f} s "
          f"({SHARD_SERVE / wall:.3f} requests/s), answers vs the unsharded server "
          f"{serve_err:.3e} (tol {ONE_PASS_TOL:.0e}) [{card}]")
    if not serve_err <= ONE_PASS_TOL:
        fail("sharded serving: answers off the unsharded server's")
    print(f"sharded phase: {time.perf_counter() - t:.1f} s")
    runs = [info["launches"][k] for info in infos for k in
            ("engine_pair", "big_timed", "engine_data", "head_timed")
            + tuple(f"train{l}{x}" for _, _, l in SHARD_TRAIN_SHAPES for x in ("", "_timed"))]
    b_host["launches"] = sum(info["launches"][k]["kernel_b"] for info in infos
                             for k in info["launches"])
    b_host["max_abs_err"] = b_host["max_rel_err"] = errs.pop("kernel_b_host")
    numbers = {"engine_pair": {"vs_single": big_err, "aln_per_s_200x1000": 1 / big_s,
                               "single_process_s_200x1000": single_big_s,
                               "stats_allreduce_bytes_per_block": stats_bytes},
               "engine_data": {"vs_single": head_err, "aln_per_s": SHARD_HEAD / head_s},
               "training": {k: {x: v for x, v in r.items() if x != "launches"}
                            for k, r in train.items()},
               "planted_no_a1_worst_leaf": max(planted),
               "nccl_cli": {"backend": stats.get("backend"), "vs_engine": nccl_err},
               "serving": {"req_per_s": SHARD_SERVE / wall, "vs_unsharded": serve_err},
               "kernels_at_shard_shapes": errs, "note": "two ranks on one card, gloo"}
    return dict(runs=runs, errs=errs, b_host=b_host, numbers=numbers)


# -- the simulators ------------------------------------------------------------

SIM_TREES, SIM_TIPS, SIM_SITES, SIM_BATCH = 1024, 50, 500, 256
SIM_NATIVE = 32  # trees through the native engine, for its rate
SIM_MIX_TREES = 256
SIM_CAL_T, SIM_CAL_SITES, SIM_CAL_REPS = 0.3, 6000, 64
SIM_DRAWS = 10**6
SIM_COEV_TREES = 4
SIM_MAX_ATTEMPTS = 20  # pf-simulate-alignments-torch's --max-attempts default
CAL_MEAN_TOL, CAL_REP_TOL = 0.005, 0.02  # mean p-distance; each replicate
COMPOSITION_TOL = 0.03  # aggregate composition against the mixture's
SAMPLER_SE = 5.0  # standard errors a state
# a fixed, skewed 20-state vector for the sampler
SKEWED = np.array([0.3, 0.2, 0.12, 0.1, 0.08, 0.06, 0.04, 0.03, 0.02, 0.015, 0.01, 0.005,
                   0.004, 0.003, 0.002, 0.0005, 0.0003, 0.0001, 0.0001, 0.01])
# two sharply different frequency classes: A/R against Y/V
MIX_F1 = np.array([0.41, 0.41] + [0.01] * 18)
MIX_F2 = np.array([0.01] * 18 + [0.41, 0.41])
# The duplicate-rate witness: the first WITNESS_TREES trees of the phase's
# set, WITNESS_ROUNDS attempts each with duplicates allowed (numpy seed SEED,
# one batch).  WITNESS_JAX is what JAX's engine (``phyloformer_tpu.sim.device``)
# gives there: attempts with duplicate rows and trees with them in every
# attempt.  ``tests/test_torch_sim.py::test_device_engine_duplicate_rate_matches_jax``
# measures it on the CPU and holds the port's engine to it.
WITNESS_TREES, WITNESS_ROUNDS = 128, 8
WITNESS_JAX = {"dup_attempts": 328, "always_dup_trees": 8}
DUP_SHARE_SE = 4.0  # standard errors of a difference of two duplicate shares


def duplicate_surplus(sim, trees, alpha_prior):
    """Surplus rows (rows less distinct rows) of each of ``WITNESS_ROUNDS``
    attempts of the engine ``sim`` (JAX's ``DeviceSimulator`` or the port's)
    on each of ``trees``, one batch an attempt: (rounds, trees)."""
    rng = np.random.default_rng(SEED)
    out = np.zeros((WITNESS_ROUNDS, len(trees)), np.int64)
    for r in range(WITNESS_ROUNDS):
        for k, aln in enumerate(sim.simulate(trees, rng, alpha_prior)):
            out[r, k] = aln.n_seqs - len({row.tobytes() for row in aln.codes})
    return out


def dup_share_bar(share, n):
    """``DUP_SHARE_SE`` standard errors of the difference of two shares of
    ``n`` attempts each at ``share`` (an upper bound: trees that differ in
    their duplicate rates only lower the variance)."""
    return DUP_SHARE_SE * math.sqrt(2 * share * (1 - share) / n)


def failed_share_bar(always):
    """The share of trees that may fail every attempt, from ``always`` of the
    witness's trees with duplicate rows in each of its attempts: a tree fails
    all SIM_MAX_ATTEMPTS attempts less often than all WITNESS_ROUNDS, and
    the witness's count is held to DUP_SHARE_SE Poisson standard errors."""
    return (always + DUP_SHARE_SE * math.sqrt(max(always, 1))) / WITNESS_TREES


def run_cli(main, argv):
    """A CLI's ``main(argv)`` in this process: (exit code, its stderr)."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, err.getvalue()


def tree_subset(src, dst, n):
    """A directory of the first ``n`` trees of ``src`` (file order)."""
    os.makedirs(dst)
    for name in sorted(os.listdir(src))[:n]:
        shutil.copy(os.path.join(src, name), dst)


def cli_outcome(rc, err, tree_dir, out_dir, what):
    """The trees a ``pf-simulate-alignments-torch`` run wrote and those its
    failure summary names (every one after ``SIM_MAX_ATTEMPTS`` attempts held
    duplicate rows: the reference's rejection rule; how many is held to JAX's
    engine by the duplicate-rate witness); fails unless the two split the
    tree directory and the exit code says so."""
    stems = {os.path.splitext(n)[0] for n in os.listdir(tree_dir)}
    written = {os.path.splitext(n)[0] for n in os.listdir(out_dir)}
    failed = {}
    for line in err.splitlines():
        m = re.fullmatch(r"  \('(.*)', (\d+)\)", line)
        if m:
            failed[os.path.splitext(os.path.basename(m.group(1)))[0]] = int(m.group(2))
    if not (rc == (1 if failed else 0) and written.isdisjoint(failed)
            and written | set(failed) == stems
            and all(a == SIM_MAX_ATTEMPTS for a in failed.values())
            and (not failed or f"{len(failed)} simulations failed:" in err)):
        fail(f"{what}: rc {rc}, {len(written)} files and {len(failed)} failures for "
             f"{len(stems)} trees: {err[-2000:]}")
    return written, failed


def read_alignments(out_dir, n_rows, n_sites, what, distinct=True):
    """Every ``.fa`` of ``out_dir``: (name -> codes); fails unless each is
    ``n_rows`` x ``n_sites``, with distinct rows where ``distinct``."""
    from phyloformer_tpu_torch.data.fasta import read_fasta

    alns = {}
    for name in sorted(os.listdir(out_dir)):
        aln = read_fasta(os.path.join(out_dir, name))
        if aln.codes.shape != (n_rows, n_sites):
            fail(f"{what}: {name} is {aln.codes.shape}, not {n_rows} x {n_sites}")
        if distinct and len({r.tobytes() for r in aln.codes}) != n_rows:
            fail(f"{what}: {name} has duplicate rows")
        alns[name] = aln.codes
    return alns


def device_share(fn, device):
    """(result, wall s, device busy s, the five largest (name, s, count)) of ``fn()``
    under ``torch.profiler`` tracing the device alone (the host's ops
    untraced, so the wall stays near an untraced run's): the device
    activities' times (one stream), read from the raw trace (the parsed
    event list of some 5 x 10^4 launches takes seconds to build)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            ns, n = by_name.get(e.name(), (0, 0))
            by_name[e.name()] = (ns + e.duration_ns(), n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    return (out, wall, sum(ns for ns, _ in by_name.values()) / 1e9,
            [(name[:60], ns / 1e9, n) for name, (ns, n) in top])


def sim_phase(device, card):
    """The simulators: pf-simulate-trees-torch, pf-simulate-alignments-torch
    with the batched engine on ``device`` (the native engine beside it, a
    frequency mixture), the engine's duplicate rate against JAX's witness,
    its calibration and sampler, duplicate rejection and
    pf-simulate-coevolution-torch; returns the numbers."""
    import torch

    from phyloformer_tpu_torch.data.fasta import write_fasta as write_alignment
    from phyloformer_tpu_torch.data.newick import parse_newick, read_newick
    from phyloformer_tpu_torch.sim import cli_coevolution, cli_msa, cli_trees
    from phyloformer_tpu_torch.sim.device import (DeviceSimulator, gumbel_argmax,
                                                  simulate_msas_device)
    from phyloformer_tpu_torch.sim.models import get_model
    from phyloformer_tpu_torch.sim.msa import MsaSimConfig
    from phyloformer_tpu_torch.sim.priors import alpha_sampler

    root = os.path.join(WORK, "sim")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    num = {"card": card}
    split = num["split_s"] = {}
    shape = f"{SIM_TREES} x {SIM_TIPS} tips"
    mark = [time.perf_counter()]

    def lap(name):  # the phase's wall time, step by step
        now = time.perf_counter()
        split[name] = now - mark[0]
        mark[0] = now

    # 1. trees: birth-death, the shipped diameter prior
    trees_dir = os.path.join(root, "trees")
    t = time.perf_counter()
    rc, err = run_cli(cli_trees.main, ["-n", str(SIM_TREES), "-t", str(SIM_TIPS), "-o",
                                       trees_dir, "--seed", str(SEED)])
    num["trees_s"] = time.perf_counter() - t
    if rc != 0 or len(os.listdir(trees_dir)) != SIM_TREES:
        fail(f"pf-simulate-trees-torch -n {SIM_TREES} -t {SIM_TIPS}: rc {rc}: {err}")
    print(f"sim: pf-simulate-trees-torch, {shape} (birth-death): {num['trees_s']:.3f} s")
    lap("trees")

    # 2. alignments on the card (GC: alpha from the hogenom prior), twice
    warm = [parse_newick("((A:0.1,B:0.2):0.1,(C:0.3,D:0.1):0.2);")] * 2
    simulate_msas_device(warm, MsaSimConfig(length=SIM_SITES), np.random.default_rng(0),
                         device=device)  # the context, cuBLAS and the generator
    lap("device_warm_up")
    gc = ["--engine", "device", "--length", str(SIM_SITES), "--gamma", "GC",
          "--batch-size", str(SIM_BATCH), "--seed", str(SEED)]
    what = f"--engine device on {shape} x {SIM_SITES}"
    outs, walls, outcomes = [os.path.join(root, "msa_a"), os.path.join(root, "msa_b")], [], []
    for out in outs:
        t = time.perf_counter()
        rc, err = run_cli(cli_msa.main, [trees_dir, out] + gc)
        walls.append(time.perf_counter() - t)
        outcomes.append(cli_outcome(rc, err, trees_dir, out, what))
    (written, failed), again = outcomes
    if again != (written, failed):
        fail(f"{what}: two runs at --seed {SEED} wrote or failed other trees")
    num["written"], num["failed"] = len(written), len(failed)
    num["device_cli_aln_per_s"] = [len(written) / w for w in walls]
    lap("device_cli_runs")

    # the engine alone at the same seed: the CLI's alignments without the
    # tree reads and the FASTA writes, and its peak memory
    names = sorted(os.listdir(trees_dir))
    trees = [read_newick(os.path.join(trees_dir, n)) for n in names]
    cfg = MsaSimConfig(length=SIM_SITES, gamma="GC")
    lap("engine_tree_reads")
    torch.cuda.reset_peak_memory_stats(device)
    t = time.perf_counter()
    res, attempts = simulate_msas_device(trees, cfg, np.random.default_rng(SEED), alpha_sampler(),
                                         batch_size=SIM_BATCH, device=device)
    num["engine_s"] = time.perf_counter() - t
    num["peak_mb"] = torch.cuda.max_memory_allocated(device) / 2**20
    num["engine_aln_per_s"] = len(written) / num["engine_s"]
    num["attempts"] = {"total": sum(attempts), "max": max(attempts),
                       "retried": sum(a > 1 for a in attempts)}
    lap("engine_alone")

    # every alignment SIM_TIPS x SIM_SITES with distinct rows; the files of
    # both CLI runs and the engine's alignments written out: the same bytes
    mine = os.path.join(root, "msa_engine")
    os.makedirs(mine)
    for name, aln in zip(names, res):
        stem = os.path.splitext(name)[0]
        if (aln is None) != (stem in failed):
            fail(f"device engine: the engine alone and the CLI differ on {stem}")
        if aln is not None:
            if aln.codes.shape != (SIM_TIPS, SIM_SITES):
                fail(f"device engine: {stem} is {aln.codes.shape}, not {SIM_TIPS} x {SIM_SITES}")
            if len({r.tobytes() for r in aln.codes}) != SIM_TIPS:
                fail(f"device engine: {stem} has duplicate rows")
            write_alignment(os.path.join(mine, stem + ".fa"), aln)
    for name in sorted(os.listdir(mine)):
        a, b, c = (open(os.path.join(d, name), "rb").read() for d in outs + [mine])
        if a != b:
            fail(f"device engine: two runs at --seed {SEED} differ in {name}")
        if a != c:
            fail(f"device engine: the engine alone and the CLI differ in {name}")
    lap("device_checks")

    # one batch of the engine (one attempt a tree) under torch.profiler: the
    # device's share of its wall time
    sim = DeviceSimulator(cfg, device)
    _, wall, busy, top = device_share(
        lambda: sim.simulate(trees[:SIM_BATCH], np.random.default_rng(SEED), alpha_sampler()),
        device)
    num["batch_s"], num["batch_device_busy_s"], num["batch_device_share"] = wall, busy, busy / wall
    num["device_top"] = top
    lap("batch_profiled")
    print(f"sim: pf-simulate-alignments-torch --engine device --gamma GC --batch-size {SIM_BATCH} "
          f"on {shape} x {SIM_SITES} sites: {len(written)} written, {len(failed)} trees with "
          f"duplicate rows after {SIM_MAX_ATTEMPTS} attempts: "
          + ", ".join(f"{r:.1f}" for r in num["device_cli_aln_per_s"])
          + f" aln/s with the FASTA writes (two runs, the same bytes), "
          f"{num['engine_aln_per_s']:.1f} aln/s the engine alone ({num['engine_s']:.3f} s, "
          f"the CLI's alignments; {num['attempts']['total']} attempts, "
          f"{num['attempts']['retried']} trees retried, at most {num['attempts']['max']} a tree); "
          f"peak {num['peak_mb']:.0f} MiB the engine alone; one batch of {SIM_BATCH} x "
          f"{SIM_SITES} sites (one attempt a tree): device busy {busy:.4f} of {wall:.4f} s "
          f"({100 * num['batch_device_share']:.1f}%, torch.profiler, device activities) [{card}]")
    print(f"sim: device time by kernel in that batch: " + "; ".join(
        f"{name} {sec:.4f} s ({n})" for name, sec, n in top))

    # the duplicate rate against JAX's engine: the witness trees, attempts
    # with duplicate rows within DUP_SHARE_SE standard errors of JAX's share;
    # trees that fail all SIM_MAX_ATTEMPTS attempts no more common than the
    # witness's trees with duplicates in every one of its attempts allow
    by_name = dict(zip(names, trees))
    surplus = duplicate_surplus(sim, [by_name[f"{i}_{SIM_TIPS}_tips.nwk"]
                                      for i in range(WITNESS_TREES)], alpha_sampler())
    share, always = float((surplus > 0).mean()), int((surplus > 0).all(0).sum())
    jax_share = WITNESS_JAX["dup_attempts"] / surplus.size
    share_bar = dup_share_bar(jax_share, surplus.size)
    failed_bar = failed_share_bar(WITNESS_JAX["always_dup_trees"])
    num["duplicate_rate"] = {"share": share, "jax_share": jax_share, "bar": share_bar,
                             "always_dup_trees": always,
                             "failed_share": len(failed) / SIM_TREES, "failed_bar": failed_bar}
    print(f"sim: duplicate rate, {WITNESS_TREES} of the trees x {WITNESS_ROUNDS} attempts: "
          f"{share:.4f} of the attempts with duplicate rows against JAX's engine's "
          f"{jax_share:.4f} (bar {share_bar:.4f}), {always} trees in every attempt (JAX "
          f"{WITNESS_JAX['always_dup_trees']}); failed {len(failed)} of {SIM_TREES} = "
          f"{len(failed) / SIM_TREES:.4f} (bar {failed_bar:.4f})")
    if not abs(share - jax_share) <= share_bar:
        fail("duplicate rate: the engine's share of duplicate attempts is off JAX's")
    if not len(failed) / SIM_TREES <= failed_bar:
        fail("duplicate rate: more trees failed every attempt than JAX's witness allows")
    lap("duplicate_rate")

    # 3. the native engine on the first trees
    nat_trees, nat_out = os.path.join(root, "trees_native"), os.path.join(root, "msa_native")
    tree_subset(trees_dir, nat_trees, SIM_NATIVE)
    t = time.perf_counter()
    rc, err = run_cli(cli_msa.main, [nat_trees, nat_out, "--engine", "native", "--length",
                                     str(SIM_SITES), "--gamma", "GC", "--seed", str(SEED)])
    wall = time.perf_counter() - t
    nat, nat_failed = cli_outcome(rc, err, nat_trees, nat_out, "--engine native")
    read_alignments(nat_out, SIM_TIPS, SIM_SITES, "native engine")
    num["native_aln_per_s"] = len(nat) / wall
    print(f"sim: --engine native on {SIM_NATIVE} x {SIM_TIPS} tips x {SIM_SITES} sites (GC): "
          f"{num['native_aln_per_s']:.2f} aln/s ({len(nat)} written, {len(nat_failed)} "
          f"failed, {wall:.3f} s) [{card}]")

    lap("native")
    # 4. a two-class frequency mixture (--mdef): the aggregate composition
    nexus = os.path.join(root, "mix.nex")
    with open(nexus, "w") as fh:
        fh.write("#nexus\nbegin models;\n"
                 f"  frequency TST_F1 = {' '.join(f'{x:.4f}' for x in MIX_F1)};\n"
                 f"  frequency TST_F2 = {' '.join(f'{x:.4f}' for x in MIX_F2)};\n"
                 "  frequency TST_MIX = FMIX{TST_F1:1.0:0.5,TST_F2:1.0:0.5};\nend;\n")
    mix_trees, mix_out = os.path.join(root, "trees_mix"), os.path.join(root, "msa_mix")
    tree_subset(trees_dir, mix_trees, SIM_MIX_TREES)
    rc, err = run_cli(cli_msa.main, [mix_trees, mix_out, "--engine", "device", "--length",
                                     str(SIM_SITES), "--mdef", nexus, "--batch-size",
                                     str(SIM_BATCH), "--seed", str(SEED)])
    cli_outcome(rc, err, mix_trees, mix_out, "--mdef on the device engine")
    codes = np.stack(list(read_alignments(mix_out, SIM_TIPS, SIM_SITES, "mixture").values()))
    obs = np.bincount(codes.ravel(), minlength=22)[:20] / codes.size
    expect = 0.5 * MIX_F1 / MIX_F1.sum() + 0.5 * MIX_F2 / MIX_F2.sum()
    num["mixture_composition_err"] = float(np.abs(obs - expect).max())
    print(f"sim: --mdef (two classes) on {SIM_MIX_TREES} x {SIM_TIPS} tips x {SIM_SITES} sites: "
          f"composition within {num['mixture_composition_err']:.4f} of the mixture's "
          f"(bar {COMPOSITION_TOL})")
    if not num["mixture_composition_err"] < COMPOSITION_TOL:
        fail("mixture: composition off the mixture-weighted class frequencies")

    lap("mixture")
    # 5. calibration: the mean p-distance at t = 0.3 against the analytic LG
    # value, and the topology signal on four tips
    lg = get_model("LG")
    expected = 1.0 - float((lg.freqs * np.diag(lg.transition_matrix(SIM_CAL_T))).sum())
    half = SIM_CAL_T / 2
    res, _ = simulate_msas_device([parse_newick(f"(A:{half},B:{half});")] * SIM_CAL_REPS,
                                  MsaSimConfig(length=SIM_CAL_SITES), np.random.default_rng(7),
                                  batch_size=SIM_CAL_REPS, device=device)
    p = np.array([(a.codes[0] != a.codes[1]).mean() for a in res])
    num["calibration"] = {"expected": expected, "mean": float(p.mean()),
                          "mean_err": float(abs(p.mean() - expected)),
                          "worst_rep_err": float(np.abs(p - expected).max())}
    res, _ = simulate_msas_device(
        [parse_newick("((A:0.05,B:0.05):0.3,(C:0.05,D:0.05):0.3);")],
        MsaSimConfig(length=SIM_CAL_SITES), np.random.default_rng(8), device=device)
    c = dict(zip(res[0].ids, res[0].codes))
    num["topology"] = {"AB": float((c["A"] != c["B"]).mean()),
                       "AC": float((c["A"] != c["C"]).mean())}
    cal = num["calibration"]
    print(f"sim: calibration, {SIM_CAL_REPS} x 2 tips x {SIM_CAL_SITES} sites at "
          f"t = {SIM_CAL_T} (LG): "
          f"mean p-distance {cal['mean']:.5f} against {expected:.5f} (err {cal['mean_err']:.5f}, "
          f"bar {CAL_MEAN_TOL}), worst replicate {cal['worst_rep_err']:.5f} (bar {CAL_REP_TOL}); "
          f"four tips: d(A,B) {num['topology']['AB']:.4f} < d(A,C) {num['topology']['AC']:.4f}")
    if not (cal["mean_err"] <= CAL_MEAN_TOL and cal["worst_rep_err"] <= CAL_REP_TOL):
        fail("calibration: p-distance off the analytic LG value")
    if not num["topology"]["AB"] < num["topology"]["AC"]:
        fail("calibration: no topology signal on four tips")

    lap("calibration")
    # 6. the sampler on the device's generator
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    logits = torch.log(torch.as_tensor(SKEWED, dtype=torch.float32, device=device))
    counts = torch.bincount(gumbel_argmax(logits.expand(SIM_DRAWS, 20), gen), minlength=20)
    freq = counts.cpu().numpy() / SIM_DRAWS
    z = np.abs(freq - SKEWED) / np.sqrt(SKEWED * (1 - SKEWED) / SIM_DRAWS)
    num["sampler_max_z"] = float(z.max())
    print(f"sim: Gumbel-argmax, {SIM_DRAWS} draws of 20 states: worst state "
          f"{num['sampler_max_z']:.2f} standard errors off (bar {SAMPLER_SE})")
    if not num["sampler_max_z"] < SAMPLER_SE:
        fail("sampler: a state's frequency off its probability")

    lap("sampler")
    # 7. duplicate rejection: zero-length branches fail every attempt
    dup_trees, dup_out = os.path.join(root, "trees_dup"), os.path.join(root, "msa_dup")
    os.makedirs(dup_trees)
    with open(os.path.join(dup_trees, "zero.nwk"), "w") as fh:
        fh.write("((A:0,B:0):0,C:0);\n")
    res, attempts = simulate_msas_device([read_newick(os.path.join(dup_trees, "zero.nwk"))],
                                         MsaSimConfig(length=50), np.random.default_rng(6),
                                         device=device)
    rc, err = run_cli(cli_msa.main, [dup_trees, dup_out, "--engine", "device", "--length", "50",
                                     "--seed", str(SEED)])
    summary = (f"1 simulations failed:\n  ('{os.path.join(dup_trees, 'zero.nwk')}', "
               f"{SIM_MAX_ATTEMPTS})\n")
    num["duplicates"] = {"attempts": attempts[0], "cli_rc": rc}
    print(f"sim: duplicate rejection on a zero-length tree: {attempts[0]} attempts, "
          f"the CLI exits {rc}: {err.strip()!r}")
    if not (res[0] is None and attempts == [SIM_MAX_ATTEMPTS] and rc == 1 and err == summary):
        fail("duplicate rejection: expected every attempt to fail and the failure summary")

    lap("duplicates")
    # 8. coevolution (host code) on a few trees
    coev_trees, coev_out = os.path.join(root, "trees_coev"), os.path.join(root, "msa_coev")
    tree_subset(trees_dir, coev_trees, SIM_COEV_TREES)
    t = time.perf_counter()
    rc, err = run_cli(cli_coevolution.main, [coev_trees, coev_out, "--seed", str(SEED)])
    num["coevolution_s"] = time.perf_counter() - t
    if rc != 0:
        fail(f"pf-simulate-coevolution-torch: rc {rc}: {err[-2000:]}")
    read_alignments(coev_out, SIM_TIPS, 500, "coevolution", distinct=False)  # no rejection there
    print(f"sim: pf-simulate-coevolution-torch on {SIM_COEV_TREES} x {SIM_TIPS} tips x 500 "
          f"residues: {num['coevolution_s']:.3f} s")
    lap("coevolution")
    num["phase_s"] = sum(split.values())
    print(f"sim: phase {num['phase_s']:.1f} s: "
          + ", ".join(f"{k} {v:.2f}" for k, v in split.items()))
    return num


TREES_N, TREES_TIPS, TREES_SITES = 64, 50, 500  # the reference's training size
TREES_MAX_FLIPS = 2  # of TREES_N: trees of the two routes' matrices whose topology differs
TREES_ML = 2  # alignments through pf-tree-torch mlrefine and likelihood


@contextlib.contextmanager
def recording_pipeline(seen):
    """Record what ``pf-bench-torch pipeline`` computes in this process: the
    engine's distance vectors, the native trees and their comparisons, in
    call order, into ``seen["preds"]``, ``["trees"]`` and ``["cmp"]``."""
    from phyloformer_tpu_torch.infer.engine import InferenceEngine
    from phyloformer_tpu_torch.trees import native

    predict, build, compare = (InferenceEngine.predict, native.build_tree_from_phylip,
                               native.compare_newick)

    def rec_predict(self, alns):
        out = predict(self, alns)
        seen["preds"] += out
        return out

    def rec_build(phy, *args):
        seen["trees"].append(build(phy, *args))
        return seen["trees"][-1]

    def rec_compare(a, b, *args):
        seen["cmp"].append(compare(a, b, *args))
        return seen["cmp"][-1]

    InferenceEngine.predict, native.build_tree_from_phylip, native.compare_newick = (
        rec_predict, rec_build, rec_compare)
    try:
        yield seen
    finally:
        InferenceEngine.predict, native.build_tree_from_phylip, native.compare_newick = (
            predict, build, compare)


def host_cli(module, args):
    """``python -m module args`` (a host CLI of the port, which loads no
    torch) started in a process of its own; returns the Popen."""
    return subprocess.Popen([sys.executable, "-m", module] + args, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def host_cli_wait(proc, what, timeout=300):
    """(stdout, stderr) of a :func:`host_cli` process; fails unless it exits 0."""
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        fail(f"{what}: exit {proc.returncode}: {err[-2000:]}")
    return out, err


def trees_phase(device, card):
    """The tree toolkit end to end (item 14 of the module's docstring).
    Returns the phase's numbers and the kernel launches of its kernel-route
    pipeline run."""
    import torch

    from phyloformer_tpu_torch.bench import cli as bench_cli
    from phyloformer_tpu_torch.data.fasta import read_fasta
    from phyloformer_tpu_torch.data.newick import parse_newick
    from phyloformer_tpu_torch.data.phylip import vec_to_phylip
    from phyloformer_tpu_torch.infer.engine import InferenceEngine
    from phyloformer_tpu_torch.io.ckpt_import import load_pretrained
    from phyloformer_tpu_torch.ops.kernels import pipeline as pipe
    from phyloformer_tpu_torch.sim import cli_msa, cli_trees
    from phyloformer_tpu_torch.trees.baselines import hamming_fastme_tree
    from phyloformer_tpu_torch.trees.native import compare_newick

    root = os.path.join(WORK, "trees")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    num = {"card": card}
    split = num["split_s"] = {}
    mark = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        split[name] = now - mark[0]
        mark[0] = now

    # inputs: birth-death trees, LG alignments evolved on them on the card
    trees_dir, alns_dir = os.path.join(root, "true"), os.path.join(root, "alns")
    rc, err = run_cli(cli_trees.main, ["-n", str(TREES_N), "-t", str(TREES_TIPS), "-o",
                                       trees_dir, "--seed", str(SEED)])
    if rc != 0:
        fail(f"trees: pf-simulate-trees-torch: rc {rc}: {err[-2000:]}")
    rc, err = run_cli(cli_msa.main, [trees_dir, alns_dir, "--engine", "device", "--length",
                                     str(TREES_SITES), "--seed", str(SEED), "--device",
                                     device.type])
    written, failed = cli_outcome(rc, err, trees_dir, alns_dir,
                                  f"trees: --engine device on {TREES_N} trees")
    stems = sorted(written)
    n = num["alignments"] = len(stems)
    num["failed"] = len(failed)
    if n < TREES_N // 2:
        fail(f"trees: only {n} of {TREES_N} alignments passed the duplicate check")
    alns = [read_fasta(os.path.join(alns_dir, s + ".fa")) for s in stems]
    lap("inputs")

    params, cfg, _ = load_pretrained(CKPT)
    expected = expected_launches(InferenceEngine(params, cfg, device="cpu")._plan(alns),
                                 cfg.n_blocks, pipe.pipeline_supported)
    runs = {}
    for route, flags in (("kernels", []), ("eager", ["--eager"])):
        seen = {"preds": [], "trees": [], "cmp": []}
        csv_path = os.path.join(root, f"exec_{route}.csv")
        out = io.StringIO()
        with recording_pipeline(seen), contextlib.redirect_stdout(out):
            pipe.reset_launch_counts()
            rc = bench_cli.main(["pipeline", CKPT, alns_dir, "--true-trees", trees_dir, "-o",
                                 csv_path, "--device", device.type] + flags)
            if device.type == "cuda":
                torch.cuda.synchronize()
            seen["launches"] = dict(pipe.LAUNCHES)
        if rc != 0:
            fail(f"trees: pf-bench-torch pipeline ({route}) exited {rc}")
        seen["summary"] = json.loads(out.getvalue())
        with open(csv_path) as fh:
            seen["rows"] = [ln.split(",") for ln in fh.read().splitlines()[1:]]
        runs[route] = seen
        lap(f"pipeline_{route}")
    ker, eag = runs["kernels"], runs["eager"]

    # what each run wrote and computed
    for route, r in runs.items():
        rows = r["rows"]
        if ([x[0] for x in rows[:3]] != ["model_load", "data_load", "inference"]
                or [x[2] for x in rows if x[0] == "fastme"] != stems
                or [x[2] for x in rows if x[0] == "compare"] != stems or len(rows) != 3 + 2 * n):
            fail(f"trees: pipeline ({route}): the CSV's rows are not model_load, data_load, "
                 f"inference, then a fastme and a compare row per alignment")
        if not (len(r["preds"]) == len(r["trees"]) == len(r["cmp"]) == n
                and all(np.isfinite(p).all() for p in r["preds"])
                and math.isfinite(r["summary"].get("mean_kf", math.nan))):
            fail(f"trees: pipeline ({route}): missing or non-finite distances or mean_kf")
        r["stage_s"] = {t: [float(x[3]) for x in rows if x[0] == t]
                        for t in ("model_load", "inference", "fastme", "compare")}
    if ker["launches"] != expected:
        fail(f"trees: the kernel route's launches {ker['launches']} differ from the plan's "
             f"{expected}")
    if any(eag["launches"].values()):
        fail(f"trees: the eager route launched kernels: {eag['launches']}")
    dist_err = max(rel_err(a, b) for a, b in zip(ker["preds"], eag["preds"]))
    flips = sum(compare_newick(a, b).rf != 0 for a, b in zip(ker["trees"], eag["trees"]))
    num.update(dist_err=dist_err, flips=flips, launches=ker["launches"])

    # findings: the rates, and the Phyloformer trees beside the Hamming baseline's
    true = {s: open(os.path.join(trees_dir, s + ".nwk")).read() for s in stems}
    t = time.perf_counter()
    ham = [compare_newick(true[s], hamming_fastme_tree(a)) for s, a in zip(stems, alns)]
    num["hamming_ms_per_tree"] = 1e3 * (time.perf_counter() - t) / n
    for route, r in runs.items():
        st = r["stage_s"]
        num[route] = {
            "inference_aln_per_s": n / st["inference"][0], "model_load_s": st["model_load"][0],
            "fastme_ms_per_tree": 1e3 * statistics.mean(st["fastme"]),
            "compare_ms_per_tree": 1e3 * statistics.mean(st["compare"]),
            "mean_kf": r["summary"]["mean_kf"],
            "mean_norm_rf": statistics.mean(c.norm_rf for c in r["cmp"])}
    num["hamming"] = {"mean_kf": statistics.mean(c.kf for c in ham),
                      "mean_norm_rf": statistics.mean(c.norm_rf for c in ham)}
    lap("checks_and_hamming")

    # the host CLIs on the kernel route's matrices and trees
    mats, built = os.path.join(root, "mats"), os.path.join(root, "built")
    os.makedirs(mats)
    for s, a, vec in zip(stems, alns, ker["preds"]):
        with open(os.path.join(mats, s + ".phy"), "w") as fh:
            fh.write(vec_to_phylip(vec.astype(np.float64), a.ids)[1])
    for s, nwk in zip(stems, ker["trees"]):
        with open(os.path.join(root, s + ".pf.nwk"), "w") as fh:
            fh.write(nwk + "\n")
    tree_cli, msa_cli = "phyloformer_tpu_torch.trees.cli", "phyloformer_tpu_torch.data.cli_msa_tools"
    ml = [(host_cli(tree_cli, ["mlrefine", os.path.join(alns_dir, s + ".fa"),
                               os.path.join(root, s + ".pf.nwk"), "-o",
                               os.path.join(root, s + ".ml.nwk")]),
           host_cli(tree_cli, ["likelihood", os.path.join(alns_dir, s + ".fa"),
                               os.path.join(root, s + ".pf.nwk")])) for s in stems[:TREES_ML]]
    first = os.path.join(alns_dir, stems[0] + ".fa")
    host_cli_wait(host_cli(tree_cli, ["fastme-dir", mats, built, "-j", "4", "--nni", "--spr"]),
                  "pf-tree-torch fastme-dir")
    for s, nwk in zip(stems, ker["trees"]):
        if open(os.path.join(built, s + ".nwk")).read() != nwk + "\n":
            fail(f"trees: pf-tree-torch fastme-dir built another tree than the pipeline for {s}")
    host_cli_wait(host_cli(tree_cli, ["compare", trees_dir, built, "-o",
                                      os.path.join(root, "cmp.csv")]), "pf-tree-torch compare")
    with open(os.path.join(root, "cmp.csv")) as fh:
        cmp_rows = [ln.split(",") for ln in fh.read().splitlines()[1:]]
    if [(x[0], x[4]) for x in cmp_rows] != [(s, f"{c.kf:g}") for s, c in zip(stems, ker["cmp"])]:
        fail("trees: pf-tree-torch compare's KF differs from the pipeline's")
    stats, _ = host_cli_wait(host_cli(msa_cli, ["stats", first]), "pf-msa-torch stats")
    stats = json.loads(stats)
    if (stats["n_seqs"], stats["seq_len"], stats["n_duplicate_seqs"]) != (TREES_TIPS,
                                                                         TREES_SITES, 0):
        fail(f"trees: pf-msa-torch stats: {stats}")
    dedup = os.path.join(root, "dedup.fa")
    host_cli_wait(host_cli(msa_cli, ["dedup", first, "-o", dedup]), "pf-msa-torch dedup")
    if not np.array_equal(read_fasta(dedup).codes, alns[0].codes):
        fail("trees: pf-msa-torch dedup changed an alignment without duplicates")
    rep_out, _ = host_cli_wait(host_cli("phyloformer_tpu_torch.bench.cli", [
        "report", trees_dir, mats, built, "-o", os.path.join(root, "report")]),
        "pf-bench-torch report")
    rep = json.loads(rep_out)
    if rep["topo"]["n_trees"] != n or rep["topo"]["mean_kf"] != ker["summary"]["mean_kf"]:
        fail(f"trees: pf-bench-torch report's mean KF {rep['topo']} is not the pipeline's")
    num["ml"] = []
    for s, a, (mlp, llp) in zip(stems, alns, ml):
        _, err = host_cli_wait(mlp, "pf-tree-torch mlrefine")
        ll_ml = json.loads(err.strip().splitlines()[-1])["log_likelihood"]
        ll_pf = json.loads(host_cli_wait(llp, "pf-tree-torch likelihood")[0])["log_likelihood"]
        leaves = parse_newick(open(os.path.join(root, s + ".ml.nwk")).read()).leaf_names()
        if not (math.isfinite(ll_ml) and math.isfinite(ll_pf)
                and sorted(leaves) == sorted(a.ids)):
            fail(f"trees: pf-tree-torch mlrefine / likelihood on {s}: {ll_ml}, {ll_pf}")
        num["ml"].append({"id": s, "ll_pf_tree": ll_pf, "ll_refined": ll_ml})
    lap("host_clis")
    num["phase_s"] = sum(split.values())

    kr, er, hr = num["kernels"], num["eager"], num["hamming"]
    print(f"trees: {n} of {TREES_N} alignments of {TREES_TIPS} x {TREES_SITES} (LG, evolved on "
          f"the card; {len(failed)} trees with duplicate rows after {SIM_MAX_ATTEMPTS} "
          f"attempts); pf-bench-torch pipeline, kernels: inference "
          f"{kr['inference_aln_per_s']:.2f} aln/s, fastme {kr['fastme_ms_per_tree']:.2f} ms a "
          f"tree, compare {kr['compare_ms_per_tree']:.3f} ms a tree; eager fp32 (TF32 off): "
          f"inference {er['inference_aln_per_s']:.2f} aln/s [{card}]")
    print(f"trees: the two routes' distances within {dist_err:.3e} of max(1, max|eager|) (tol "
          f"{DIST_TOL:.0e}); {flips} of {n} trees of another topology (bar {TREES_MAX_FLIPS}); "
          f"launches {ker['launches']}")
    print(f"trees: mean KF {kr['mean_kf']:.5f}, mean normalised RF {kr['mean_norm_rf']:.5f} "
          f"(Phyloformer, pf_mre_r5); Hamming (Poisson) + BME: {hr['mean_kf']:.5f}, "
          f"{hr['mean_norm_rf']:.5f} ({num['hamming_ms_per_tree']:.2f} ms a tree); mlrefine on "
          f"{TREES_ML}: " + ", ".join(f"{m['ll_pf_tree']:.2f} -> {m['ll_refined']:.2f}"
                                        for m in num["ml"]))
    print(f"trees: phase {num['phase_s']:.1f} s: "
          + ", ".join(f"{k} {v:.2f}" for k, v in split.items()))
    if not dist_err <= DIST_TOL:
        fail("trees: the kernel route's distances disagree with the eager fp32 model's")
    if flips > TREES_MAX_FLIPS:
        fail(f"trees: {flips} trees of the two routes differ in topology")
    return num, ker["launches"]


SOURCE = "phyloformer_tpu_torch/ops/kernels/csrc/"
# name: (source, TPU kernel it replaces)
KERNELS = {
    "kernel_p0": ("axial_pipeline.cu", "phyloformer_tpu/ops/pallas/pipeline.py:100"),
    "kernel_a_only": ("axial_pipeline.cu", "phyloformer_tpu/ops/pallas/pipeline.py:145"),
    "kernel_m": ("axial_pipeline_m.cu", "phyloformer_tpu/ops/pallas/pipeline.py:176"),
    "kernel_z": ("axial_pipeline.cu", "phyloformer_tpu/ops/pallas/pipeline.py:214"),
    "reduce_stats": ("slot_reduce.cu", "phyloformer_tpu/ops/pallas/pipeline.py:136"),
    "kernel_a": ("axial_pipeline.cu", "phyloformer_tpu/ops/pallas/axial_block.py:252"),
    "kernel_b": ("axial_fused.cu", "phyloformer_tpu/ops/pallas/axial_block.py:294"),
    "kernel_a1": ("axial_fused.cu", "phyloformer_tpu/ops/pallas/axial_block.py:314"),
    "kernel_a2": ("axial_fused.cu", "phyloformer_tpu/ops/pallas/axial_block.py:353"),
    "kernel_c": ("axial_bwd_tc.cu", "phyloformer_tpu/ops/pallas/axial_block_bwd.py:176"),
    "kernel_d": ("axial_bwd_tc.cu", "phyloformer_tpu/ops/pallas/axial_block_bwd.py:281"),
    "kernel_e": ("axial_bwd_tc.cu", "phyloformer_tpu/ops/pallas/axial_block_bwd.py:372"),
    "kernel_e1": ("axial_bwd.cu", "phyloformer_tpu/ops/pallas/axial_block_bwd.py:492"),
    "kernel_e2": ("axial_bwd_tc.cu", "phyloformer_tpu/ops/pallas/axial_block_bwd.py:534"),
    "reduce_partials": ("slot_reduce.cu", "phyloformer_tpu/ops/pallas/axial_block_bwd.py:241"),
}
# The sharded forward's kernel B on a pair shard: not a kernel of its own, a
# composition over pf_kernel_b (fused.kernel_b_host), with its own row.
B_HOST = ("kernel_b_host", "axial_fused.cu", "phyloformer_tpu/ops/pallas/sharded.py:287")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reductions", action="store_true",
                    help="only build the kernels and check and time the two slot reductions "
                         "at every shape the paths give them, then print their rows as JSON")
    ap.add_argument("--reduced", action="store_true",
                    help="only build the kernels and run the reduced-precision phases: the "
                         "forward kernels' variants against their plain versions, the fast "
                         "path, 60 x 1500 at one pass, the accuracy grid, the backward "
                         "kernels at one pass (and three) and training at default (and fp32)")
    ap.add_argument("--sharded", action="store_true",
                    help="only build the kernels and run the sharded phase")
    ap.add_argument("--sharded-worker", metavar="DIR", help=argparse.SUPPRESS)
    ap.add_argument("--sim", action="store_true",
                    help="only run the simulator phase (no kernel is built)")
    ap.add_argument("--trees", action="store_true",
                    help="only build the kernels and run the tree-toolkit phase")
    opts = ap.parse_args(argv)
    reductions_only = opts.reductions
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    if opts.sharded_worker:  # one rank of the sharded phase, started by it
        return sharded_worker(opts.sharded_worker)
    import phyloformer_tpu_torch
    from phyloformer_tpu_torch.io.ckpt_import import load_pretrained
    from phyloformer_tpu_torch.models.params import map_params
    from phyloformer_tpu_torch.ops.kernels import _build
    from phyloformer_tpu_torch.ops.kernels import pipeline as pipe

    if not os.path.abspath(phyloformer_tpu_torch.__file__).startswith(ROOT + os.sep):
        fail(f"the port was imported from outside this checkout: {phyloformer_tpu_torch.__file__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    card = gpu_line()
    print(card)
    kind = torch.cuda.get_device_name(0)
    if opts.sim:
        print(json.dumps({"sim": sim_phase(device, card), "card": card}))
        return 0

    t0 = time.perf_counter()
    lib_path = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc {_build.build_seconds:.1f} s) "
          f"-> {os.path.relpath(lib_path, ROOT)}")
    for line in _build.ptxas_log.splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    if opts.trees:
        tp, _ = trees_phase(device, card)
        print(json.dumps({"trees": tp, "card": card}))
        return 0

    if opts.sharded:
        from phyloformer_tpu_torch.data.fasta import Alignment

        rng = np.random.default_rng(SEED + 1)
        head = [Alignment(random_alignment(rng, 60, 250).astype(np.int8),
                          [f"T{j}" for j in range(60)]) for _ in range(SHARD_HEAD)]
        sh = sharded_phase(torch.device("cuda"), card, head)
        print(json.dumps({"sharded": sh["numbers"], "kernel_b_host": sh["b_host"],
                          "card": card}))
        return 0

    if opts.reduced:
        params, cfg, _ = load_pretrained(CKPT)
        weights = pipe.PipelineWeights.from_params(map_params(lambda t: t.to(device), params))
        t = time.perf_counter()
        var = variant_checks(weights, device)
        bad = report_variants(var, card)
        print(f"variants: {time.perf_counter() - t:.1f} s")
        print(json.dumps({"variants": var, "card": card}))
        del weights
        torch.cuda.empty_cache()
        from phyloformer_tpu_torch.data.fasta import Alignment

        rng = np.random.default_rng(SEED + 1)
        alns, long_alns = ([Alignment(random_alignment(rng, 60, l).astype(np.int8),
                                      [f"T{j}" for j in range(60)]) for _ in range(k)]
                           for k, l in ((18, 250), (2, 1500)))
        fp = reduced_phases(device, card, alns, plain_refs(params, cfg, alns, device),
                            long_alns, plain_refs(params, cfg, long_alns, device))
        print(json.dumps({"reduced": fp, "card": card}))
        if bad:
            fail(f"variants off their bars: {bad}")
        bwd = backward_phases(map_params(lambda t: t.to(device), params), device, card)
        tr = training_phases(device, card)
        print(json.dumps({"one_pass": {k: r["one_pass"] for k, r in bwd.items()
                                       if "one_pass" in r},
                          "training": tr["numbers"], "card": card}))
        return 0

    # the two slot reductions at every shape the paths give them
    red, red_rows = reduction_checks(device, card)
    if reductions_only:
        print(json.dumps({"reductions": red_rows, "card": card}))
        return 0
    bad = [n for n, r in red.items() if not (r["twin_bits"] and r["same_bits"]
                                             and max(e[1] for e in r["errs"]) <= KERNEL_TOL)]
    for name, r in red.items():
        print(f"{name}: equal to its ordered twin bit for bit at every shape: {r['twin_bits']}, "
              f"same bits twice: {r['same_bits']}; worst time over torch.sum "
              f"{r['worst_vs_library']:.2f}x at {r['worst_vs_library_shape']}")
    if bad:
        fail(f"slot reductions differ from their ordered twin, between runs or from the sum: "
             f"{bad}")

    params, cfg, _ = load_pretrained(CKPT)
    dev_params = map_params(lambda t: t.to(device), params)
    weights = pipe.PipelineWeights.from_params(dev_params)

    sass = sass_counts(lib_path)
    if sass is None:
        print("sass: no cuobjdump in this toolkit")
    for fn, n in (sass or {}).items():
        print(f"sass: {fn}: {n['HMMA']} HMMA (tensor-core mma), {n['FFMA']} FFMA")
    no_tc = [f"{k}<{n}>" for k in ("kernel_c", "kernel_d", "kernel_e", "kernel_e2")
             for n in (3, 1) if not (sass or {}).get(f"{k}<Li{n}E>", {}).get("HMMA")]
    if no_tc:
        fail(f"no tensor-core (HMMA) instruction found in {no_tc}")

    results = kernel_checks(weights, device)
    results.update(fused_kernel_checks(weights, device))
    torch.cuda.empty_cache()
    for name, r in results.items():
        r["max_abs_err"] = max(e[0] for e in r["errs"])
        r["max_rel_err"] = max(e[1] for e in r["errs"])
        cases = ", ".join(f"{c} {e:.2e}" for c, e in r["cases"].items())
        print(f"{name}: max abs err {r['max_abs_err']:.3e}, relative {r['max_rel_err']:.3e} "
              f"(tol {KERNEL_TOL:.0e}; {cases}), "
              f"{r['ms']:.3f} ms vs plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
              f"({r['bound_by']}, split TF32 on the tensor cores; fp32 SIMT bound "
              f"{r['bound_fp32_simt_ms']:.3f} ms) [{card}]")
    a, b = results["kernel_a"], results["kernel_b"]
    print(f"kernel_b at the headline bucket: {b['headline_ms']:.3f} ms, bound "
          f"{b['headline_bound_ms']:.3f} ms (fp32 SIMT {b['headline_bound_fp32_simt_ms']:.3f}) "
          f"[{card}]")
    print(f"at the training shape 4 x 1225 x 256: kernel_a {a['train_ms']:.3f} ms (bound "
          f"{a['train_bound_ms']:.3f}), kernel_b {b['train_ms']:.3f} ms (bound "
          f"{b['train_bound_ms']:.3f}) [{card}]")
    print(f"kernel_a, kernel_b: two runs give the same bits at every case: "
          f"{a['same_bits']}, {b['same_bits']}")
    bad = [n for n, r in results.items() if not r["max_rel_err"] <= KERNEL_TOL]
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")
    if not (a["same_bits"] and b["same_bits"]):
        fail("kernels A or B give other bits on a second run")

    # the reduced-precision and activation variants of the forward kernels
    t = time.perf_counter()
    variants = variant_checks(weights, device)
    bad = report_variants(variants, card)
    print(f"variants: {time.perf_counter() - t:.1f} s")
    if bad:
        fail(f"variants off their bars: {bad}")
    torch.cuda.empty_cache()
    for r in red.values():
        r["max_abs_err"] = max(e[0] for e in r["errs"])
        r["max_rel_err"] = max(e[1] for e in r["errs"])
    results.update(red)

    # each path is driven with the counts set to 0 just before it
    mp = main_path(device)
    print(f"main path: launches {mp['launches']}, expected {mp['expected']}")
    print(f"main path: distances vs plain model rel max err {mp['dist_err']:.3e}, "
          f"above 1024 sites {mp['dist_err_long']:.3e} (tol {DIST_TOL:.0e})")
    print(f"main path: cli stats {json.dumps(mp['cli_stats'])}")
    if mp["launches"] != mp["expected"]:
        fail("main path: launch counts differ from 1 block-0 kernel + 5 M + 1 Z per "
             "pipelined batch and 6 A1 + 6 A2 + 6 B per L-tiled one")
    if not mp["dist_err"] <= DIST_TOL:
        fail("main path: kernel-path distances disagree with the plain model")

    launches2, expected2, dist_err2, aln_per_s2 = two_kernel_path(device, mp["head_alns"],
                                                                  mp["head_refs"])
    print(f"two-kernel path: launches {launches2}, expected {expected2}")
    print(f"two-kernel path: distances vs plain model rel max err {dist_err2:.3e} "
          f"(tol {DIST_TOL:.0e}), {aln_per_s2:.3f} aln/s on {mp['n_head']} alignments of "
          f"60 x 250 [{card}]")
    if launches2 != expected2:
        fail("two-kernel path: launch counts differ from 6 A + 6 B per batch")
    if not dist_err2 <= DIST_TOL:
        fail("two-kernel path: distances disagree with the plain model")
    print(f"throughput: {mp['aln_per_s']:.3f} aln/s on {mp['n_head']} alignments of 60 x 250, "
          f"{mp['long_aln_per_s']:.3f} aln/s on {mp['n_long']} alignments of 60 x 1500 "
          f"[{card}]")

    # the reduced-precision inference path: the bench's fast path, 60 x 1500
    # at one pass, the drift grid
    rp = reduced_phases(device, card, mp["head_alns"], mp["head_refs"], mp["long_alns"],
                        mp["long_refs"])
    del weights
    torch.cuda.empty_cache()

    bwd = backward_phases(dev_params, device, card)
    tr = training_phases(device, card)
    results.update(bwd)
    sp = serving_phase(device, card, tr["ckpt_dir"], tr["alns_dir"], mp["head_alns"],
                       mp["head_refs"], mp["aln_per_s"], mp["dist_err"])
    torch.cuda.empty_cache()
    sh = sharded_phase(device, card, mp["head_alns"])
    sm = sim_phase(device, card)
    tp, trees_launches = trees_phase(device, card)
    for name, err in sh["errs"].items():
        results[name]["sharded_max_rel_err"] = err
    train_launches = {k: sum(run[k] for run in tr["runs"] + sp["runs"] + sh["runs"])
                      for k in KERNELS}
    fast_launches = {k: sum(rp[x]["launches"][k] for x in ("float32", "bfloat16", "long"))
                     for k in KERNELS}
    variant_rows = {name: {v.split("/")[1]: {
        k: r[k] for k in ("ms", "p3_f32_ms", "bound_ms", "bound_by", "max_abs_err",
                          "max_rel_err", "far_share", "p999", "bf16", "same_bits", "shape",
                          "twin_card_vs_cpu", "stats_vs_twin") if k in r}
        for v, r in variants.items() if v.startswith(name + "/")} for name in KERNELS}
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE + KERNELS[name][0],
         "replaces": KERNELS[name][1],
         "launches": (mp["launches"][name] + launches2[name] + train_launches[name]
                      + fast_launches[name] + trees_launches[name]),
         "max_abs_err": r["max_abs_err"], "max_rel_err": r["max_rel_err"],
         "tolerance": E12_TOL if name in ("kernel_e1", "kernel_e2") else KERNEL_TOL,
         "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"],
         **({"max_rel_err_grads": r["max_rel_err_grads"], "tolerance_grads": GRAD_TOL}
            if "max_rel_err_grads" in r else {}),
         **({k: r[k] for k in ("bound_fp32_simt_ms", "bound_share", "one_launch_ms",
                               "max_rel_err_factored", "same_bits", "cases", "long_ms",
                               "long_bound_ms",
                               "long_bound_fp32_simt_ms", "l1024_ms", "l1024_bound_ms",
                               "l1024_bound_fp32_simt_ms", "one_pass", "one_pass_long",
                               "one_pass_bits") if k in r}),
         **({k: r[k] for k in ("shape", "twin_bits", "same_bits", "worst_vs_library",
                               "worst_vs_library_shape")} if name in REDUCTION_ROW else {}),
         **({"variants": variant_rows[name]} if variant_rows.get(name) else {}),
         **({"sharded_max_rel_err": r["sharded_max_rel_err"]}
            if "sharded_max_rel_err" in r else {})}
        for name, r in results.items()] + [
        {"name": B_HOST[0], "route": "cuda", "source": SOURCE + B_HOST[1],
         "replaces": B_HOST[2], "tolerance": KERNEL_TOL,
         **{k: sh["b_host"][k] for k in ("launches", "max_abs_err", "max_rel_err", "ms",
                                          "plain_ms", "bound_ms", "bound_by", "library_ms",
                                          "shape")},
         "composition_of": "kernel_b",
         "note": "one process: kernel B at a pair-shard shape with both shards' stats summed"}],
        "card": card, "aln_per_s": mp["aln_per_s"], "long_aln_per_s": mp["long_aln_per_s"],
        "two_kernel_aln_per_s": aln_per_s2,
        "fast_path_aln_per_s": rp["float32"]["aln_per_s"],
        "fast_path_bf16_aln_per_s": rp["bfloat16"]["aln_per_s"],
        "long_one_pass_aln_per_s": rp["long"]["aln_per_s"],
        "fast_path_err": {x: rp[x]["random"] + rp[x]["evolved"] for x in ("float32", "bfloat16")},
        "accuracy_grid": rp["grid"]["rows"],
        "training": tr["numbers"], "serving": sp["numbers"], "sharded": sh["numbers"],
        "sim": sm, "trees": tp}
    if any(k["launches"] <= 0 for k in line["kernels"]):
        fail("a kernel of the paths was not launched on them")
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except ImportError as e:  # run outside the repository: nothing to test
        print(f"chip_smoke: FAIL: cannot import the port ({e})", file=sys.stderr)
        sys.exit(2)
