"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the hand-written CUDA kernels from this checkout's sources;
3. holds every kernel of the inference path (P0, A-only, M, Z and the stats
   reduction) against its plain PyTorch version on the card (TF32 off), at
   the headline bucket (60 tips, 256 sites, real pf_mre_r5 weights) and on a
   ragged batch, and times both with CUDA events;
4. drives the main path through the CLI (``pf-infer`` with ``--trees
   --fastme --stats``) on synthetic FASTA files made with numpy from a seed,
   checks the launch counts, the finiteness of every distance and their
   agreement with the plain eager model run on the card;
5. prints the ``kernels`` JSON line and the throughput, then, as its last
   line, ``{"ok": true, "device": {...}}``.

Any failed phase exits non-zero before the last line.  Nothing falls back to
the CPU or to a plain version.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
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

# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# Matmul FLOPs per pair-site: kernel A = 7 d x d products, kernel B = 2 d x d
# + 2 d x 4d products, the head one d-vector.
D = 64
FLOPS_A = 7 * 2 * D * D
FLOPS_B = 2 * 2 * D * D + 2 * 2 * D * 4 * D
FLOPS_HEAD = 2 * D
# Tolerances, relative to the reference's largest magnitude (max(1, max|ref|)):
# fp32 sums taken in another order (tiles, blocks, one-pass ctx = Σk·v/Σk).
KERNEL_TOL = 2e-5
# Distances after 6 blocks against the plain eager model on the card.
DIST_TOL = 1e-4


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


def kernel_checks(weights, device):
    """Each kernel against its plain version on the card, at the headline
    bucket and on a ragged batch; times at the headline shapes."""
    import torch

    from phyloformer_tpu_torch.data.pairs import pair_indices
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
    results = {k: {"errs": []} for k in
               ("kernel_p0", "kernel_a_only", "kernel_m", "kernel_z", "reduce_stats")}
    timing_inputs = {}
    for case, (dims, pad_n, pad_l) in cases.items():
        codes, site_mask, seq_mask = batch_inputs(rng, dims, pad_n, pad_l, device)
        b = len(dims)
        i_np, j_np = pair_indices(pad_n)
        ii = torch.as_tensor(i_np, device=device)
        jj = torch.as_tensor(j_np, device=device)
        emb = torch.relu(w.embed_w[codes.long()] + w.embed_b).contiguous()
        smask = site_mask.float().contiguous()
        pmask = (seq_mask[:, ii.long()] & seq_mask[:, jj.long()]).float().contiguous()
        pcount = pmask.sum(1)
        x0 = (emb[:, ii.long()] + emb[:, jj.long()]).contiguous()

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
        partial = torch.randn((b, 23, pad_l, 3 * D), device=device,
                              generator=torch.Generator(device).manual_seed(SEED))
        results["reduce_stats"]["errs"].append(
            errors(pipe.reduce_stats(partial), pipe.reduce_stats_plain(partial)))
        torch.cuda.synchronize()
        if case in ("headline", "wide"):
            timing_inputs[case] = dict(emb=emb, ii=ii, jj=jj, smask=smask, pmask=pmask,
                                       pcount=pcount, x0=x0, x1=x1, stats=stats, xz=xz,
                                       sz=sz, b=b, n=pad_n, p=len(i_np), l=pad_l)

    # timing at the main path's shapes
    h, wd = timing_inputs["headline"], timing_inputs["wide"]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    partial = torch.randn((h["b"], math.ceil(8 * sms / h["b"]), h["l"], 3 * D),
                          device=device)

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

    def bound(flops, nbytes):
        t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
        return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")

    hs = h["b"] * h["p"] * h["l"]  # pair-sites
    ws = wd["b"] * wd["p"] * wd["l"]
    act = 4 * D  # bytes of one pair-site row
    stats_b = 4 * h["b"] * h["l"] * 3 * D
    timed = {
        "kernel_p0": (p0(False), p0(True), None,
                      bound(FLOPS_A * hs, 4 * h["b"] * h["n"] * h["l"] * D + act * hs + stats_b)),
        "kernel_a_only": (a_only(False), a_only(True), clone_of(wd["x0"]),
                          bound(FLOPS_A * ws, 2 * act * ws + 4 * wd["b"] * wd["l"] * 3 * D)),
        "kernel_m": (m(False), m(True), clone_of(h["x1"]),
                     bound((FLOPS_A + FLOPS_B) * hs, 2 * act * hs + 2 * stats_b)),
        "kernel_z": (z(False), z(True), None,
                     bound((FLOPS_B + FLOPS_HEAD) * hs, act * hs + stats_b + 4 * h["b"] * h["p"])),
        "reduce_stats": (lambda: pipe.reduce_stats(partial),
                         lambda: pipe.reduce_stats_plain(partial), None,
                         bound(partial.numel(), 4 * partial.numel() + stats_b)),
    }
    for name, (kern, plain, setup, (bound_ms, bound_by)) in timed.items():
        r = results[name]
        r["ms"] = time_ms(kern, setup)
        r["plain_ms"] = time_ms(plain, setup)
        r["bound_ms"] = bound_ms
        r["bound_by"] = bound_by
        # one PyTorch call computing the same function exists only for the sum
        r["library_ms"] = (time_ms(lambda: torch.sum(partial, dim=1))
                           if name == "reduce_stats" else None)
    return results


def write_fasta(path, codes, rng_ids):
    from phyloformer_tpu_torch.data.alphabet import ALPHABET

    with open(path, "w") as fh:
        for r, row in enumerate(codes):
            fh.write(f">{rng_ids}_{r}\n")
            fh.write(bytes(ALPHABET[c] for c in row).decode() + "\n")


def main_path(device):
    """Run the CLI on synthetic alignments; return the launch counts, the
    expected counts, the distance error vs the plain model and throughput."""
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
    dims = [(60, 250)] * 18 + [(17, 130), (33, 333), (45, 700), (25, 1000), (110, 200)]
    for k, (n, l) in enumerate(dims):
        write_fasta(os.path.join(aln_dir, f"aln{k:02d}.fa"), random_alignment(rng, n, l), k)
    gapped = random_alignment(rng, 12, 150, gap_frac=0.35)
    write_fasta(os.path.join(aln_dir, "gapped.fa"), gapped, "g")

    params, cfg, _ = load_pretrained(CKPT)
    names = sorted(os.listdir(aln_dir))
    alns = [read_fasta(os.path.join(aln_dir, f)) for f in names]
    engine = InferenceEngine(params, cfg, InferenceConfig(), device=device)
    plan = engine._plan(alns)
    n_p0 = sum(pipe.uses_gather(shape[0], shape[1], D) for shape, _ in plan)
    expected = {"kernel_p0": n_p0, "kernel_a_only": len(plan) - n_p0,
                "kernel_m": (cfg.n_blocks - 1) * len(plan), "kernel_z": len(plan),
                "reduce_stats": cfg.n_blocks * len(plan)}

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
    worst = 0.0
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
        i, j = np.triu_indices(aln.n_seqs, 1)
        worst = max(worst, float(np.abs(dm[i, j] - ref).max() / max(1.0, np.abs(ref).max())))

    # throughput on the headline set, after the first (warm) run above
    head = [a for a, (n, l) in zip(alns, dims + [(12, 150)]) if (n, l) == (60, 250)]
    engine.predict(head)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.predict(head)
    aln_per_s = len(head) / (time.perf_counter() - t0)
    return launches, expected, worst, cli_stats, aln_per_s, len(head)


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
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

    t0 = time.perf_counter()
    lib_path = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc {_build.build_seconds:.1f} s) "
          f"-> {os.path.relpath(lib_path, ROOT)}")
    for line in _build.ptxas_log.splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    params, cfg, _ = load_pretrained(CKPT)
    weights = pipe.PipelineWeights.from_params(map_params(lambda t: t.to(device), params))

    results = kernel_checks(weights, device)
    for name, r in results.items():
        r["max_abs_err"] = max(e[0] for e in r["errs"])
        r["max_rel_err"] = max(e[1] for e in r["errs"])
        print(f"{name}: max abs err {r['max_abs_err']:.3e}, relative {r['max_rel_err']:.3e} "
              f"(tol {KERNEL_TOL:.0e}), "
              f"{r['ms']:.3f} ms vs plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
              f"({r['bound_by']}) [{card}]")
    bad = [n for n, r in results.items() if not r["max_rel_err"] <= KERNEL_TOL]
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")

    launches, expected, dist_err, cli_stats, aln_per_s, n_head = main_path(device)
    print(f"main path: launches {launches}, expected {expected}")
    print(f"main path: distances vs plain model rel max err {dist_err:.3e} (tol {DIST_TOL:.0e})")
    print(f"main path: cli stats {json.dumps(cli_stats)}")
    if launches != expected:
        fail("launch counts differ from one block-0 kernel, 5 M and 1 Z per batch")
    if not dist_err <= DIST_TOL:
        fail("kernel-path distances disagree with the plain model")
    print(f"throughput: {aln_per_s:.3f} aln/s on {n_head} alignments of 60 x 250 [{card}]")

    replaces = {
        "kernel_p0": "phyloformer_tpu/ops/pallas/pipeline.py:100",
        "kernel_a_only": "phyloformer_tpu/ops/pallas/pipeline.py:145",
        "kernel_m": "phyloformer_tpu/ops/pallas/pipeline.py:176",
        "kernel_z": "phyloformer_tpu/ops/pallas/pipeline.py:214",
        "reduce_stats": "phyloformer_tpu/ops/pallas/pipeline.py:136",
    }
    line = {"kernels": [
        {"name": name, "route": "cuda",
         "source": "phyloformer_tpu_torch/ops/kernels/csrc/axial_pipeline.cu",
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": r["max_abs_err"], "max_rel_err": r["max_rel_err"],
         "tolerance": KERNEL_TOL, "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"]}
        for name, r in results.items()],
        "card": card, "aln_per_s": aln_per_s}
    if any(k["launches"] <= 0 for k in line["kernels"]):
        fail("a kernel of the path was not launched on the main path")
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
