"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the hand-written CUDA kernels from this checkout's sources (one
   nvcc per source, all in parallel);
3. holds every kernel of the inference paths against its plain PyTorch
   version on the card (TF32 off) and times both with CUDA events:
   - the pipeline's P0, A-only, M, Z and the stats reduction at the headline
     bucket (60 tips, 256 sites, real pf_mre_r5 weights) and on ragged
     batches;
   - the fused forward's A and B at the headline bucket, A1, A2 and B at a
     long bucket (60 tips x 1500 sites -> (60, 1536)) and all four on a
     ragged unbucketed pair of alignments of 1100 and 1031 sites;
4. drives the main path through the CLI (``pf-infer`` with ``--trees
   --fastme --stats``) on synthetic FASTA files made with numpy from a seed,
   up to 3000 sites, so that buckets up to 1024 sites run the pipeline and
   longer ones the L-tiled A1/A2/B; checks the launch counts, the finiteness
   of every distance and their agreement with the plain eager model run on
   the card;
5. drives the two-kernel fused forward (``InferenceConfig(use_pipeline=
   False)``, kernels A and B) through the engine on the 60 x 250 set, with
   the same checks;
6. prints the ``kernels`` JSON line and the throughputs, then, as its last
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
# Matmul FLOPs per pair-site: kernel A = 7 d x d products (A1 3 of them, A2
# the other 4 and the q projection again: 5), kernel B = 2 d x d + 2 d x 4d
# products, the head one d-vector.
D = 64
FLOPS_A = 7 * 2 * D * D
FLOPS_A1 = 3 * 2 * D * D
FLOPS_A2 = 5 * 2 * D * D
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


def bound(flops, nbytes):
    """(least ms on the card, "operations" or "bytes"): the larger of the
    matmul FLOPs over the fp32 peak and the bytes over the HBM rate."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


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
    results = {k: {"errs": []} for k in
               ("kernel_p0", "kernel_a_only", "kernel_m", "kernel_z", "reduce_stats")}
    timing_inputs = {}
    for case, (dims, pad_n, pad_l) in cases.items():
        b = len(dims)
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
        partial = torch.randn((b, 23, pad_l, 3 * D), device=device,
                              generator=torch.Generator(device).manual_seed(SEED))
        results["reduce_stats"]["errs"].append(
            errors(pipe.reduce_stats(partial), pipe.reduce_stats_plain(partial)))
        torch.cuda.synchronize()
        if case in ("headline", "wide"):
            timing_inputs[case] = dict(emb=emb, ii=ii, jj=jj, smask=smask, pmask=pmask,
                                       pcount=pcount, x0=x0, x1=x1, stats=stats, xz=xz,
                                       sz=sz, b=b, n=pad_n, p=len(ii), l=pad_l)

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


def fused_kernel_checks(weights, device):
    """The fused forward's kernels A, B, A1 and A2 against their plain
    versions: A and B at the headline bucket, A1, A2 and B at the long one,
    all four on a ragged unbucketed batch; times at the main paths' shapes
    (A at the headline, A1, A2 and B at the long bucket)."""
    import torch

    from phyloformer_tpu_torch.ops.kernels import fused
    from phyloformer_tpu_torch.ops.kernels import pipeline as pipe

    rng = np.random.default_rng(SEED + 2)
    cases = {
        # name: (real dims, pad_n, pad_l, kernels checked)
        "headline": ([(60, 250)] * 9, 60, 256, ("kernel_a", "kernel_b")),
        # one 60 x 1500 alignment in the (60, 1536) bucket: B = 1, P = 1770
        "long": ([(60, 1500)], 60, 1536, ("kernel_a1", "kernel_a2", "kernel_b")),
        # --no-bucketing: 1100 sites end in a partial tile of 12, the second
        # row has 1031 real sites and 33 of 40 sequences
        "ragged": ([(40, 1100), (33, 1031)], 40, 1100,
                   ("kernel_a", "kernel_a1", "kernel_a2", "kernel_b")),
    }
    w, eps = weights, 1e-5
    results = {k: {"errs": []} for k in ("kernel_a", "kernel_b", "kernel_a1", "kernel_a2")}
    shapes = {}
    for case, (dims, pad_n, pad_l, names) in cases.items():
        _, _, _, smask, pmask, pcount, x0 = block0_inputs(w, rng, dims, pad_n, pad_l, device)
        if "kernel_a" in names:
            got = fused.kernel_a(x0, smask, pmask, w.row[0], w.col[0], eps)
            want = pipe.kernel_a_only_plain(x0, smask, pmask, w.row[0], w.col[0], eps)
            results["kernel_a"]["errs"] += [errors(got[0], want[0]), errors(got[1], want[1])]
        rowstats = fused.kernel_a1_plain(x0, smask, w.row[0], eps)
        if "kernel_a1" in names:
            results["kernel_a1"]["errs"].append(
                errors(fused.kernel_a1(x0, smask, w.row[0], eps), rowstats))
        want = fused.kernel_a2_plain(x0, rowstats, smask, pmask, w.row[0], w.col[0], eps)
        if "kernel_a2" in names:
            got = fused.kernel_a2(x0, rowstats, smask, pmask, w.row[0], w.col[0], eps)
            results["kernel_a2"]["errs"] += [errors(got[0], want[0]), errors(got[1], want[1])]
        x1, stats = want
        results["kernel_b"]["errs"].append(
            errors(fused.kernel_b(x1, stats, pcount, w.b[0], eps),
                   fused.kernel_b_plain(x1, stats, pcount, w.b[0], eps)))
        torch.cuda.synchronize()
        shapes[case] = dict(smask=smask, pmask=pmask, pcount=pcount, x0=x0, rowstats=rowstats,
                            x1=x1, stats=stats, b=len(dims), p=x0.shape[1], l=pad_l)
        del want, x1, stats

    h, lg = shapes["headline"], shapes["long"]

    def a(plain):
        f = pipe.kernel_a_only_plain if plain else fused.kernel_a
        return lambda: f(h["x0"], h["smask"], h["pmask"], w.row[0], w.col[0], eps)

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
                     bound(FLOPS_A * sites(h), 2 * act * sites(h) + stats_bytes(h))),
        "kernel_b": (b(False, lg), b(True, lg),
                     bound(FLOPS_B * sites(lg), 2 * act * sites(lg) + stats_bytes(lg))),
        "kernel_a1": (a1(False), a1(True),
                      bound(FLOPS_A1 * sites(lg), act * sites(lg) + rowstats_b)),
        "kernel_a2": (a2(False), a2(True),
                      bound(FLOPS_A2 * sites(lg),
                            2 * act * sites(lg) + rowstats_b + stats_bytes(lg))),
    }
    for name, (kern, plain, (bound_ms, bound_by)) in timed.items():
        r = results[name]
        r["ms"] = time_ms(kern)
        r["plain_ms"] = time_ms(plain)
        r["bound_ms"], r["bound_by"] = bound_ms, bound_by
        r["library_ms"] = None  # no single PyTorch call computes these functions
    # kernel B also runs at the headline bucket on the two-kernel path
    results["kernel_b"]["headline_ms"] = time_ms(b(False, h))
    results["kernel_b"]["headline_bound_ms"] = bound(
        FLOPS_B * sites(h), 2 * act * sites(h) + stats_bytes(h))[0]
    return results


def write_fasta(path, codes, rng_ids):
    from phyloformer_tpu_torch.data.alphabet import ALPHABET

    with open(path, "w") as fh:
        for r, row in enumerate(codes):
            fh.write(f">{rng_ids}_{r}\n")
            fh.write(bytes(ALPHABET[c] for c in row).decode() + "\n")


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
                head_refs=[refs[k] for k in head],
                aln_per_s=throughput(engine, [alns[k] for k in head]),
                long_aln_per_s=throughput(engine, [alns[k] for k in long]),
                n_head=len(head), n_long=len(long))


def two_kernel_path(device, alns, refs):
    """The engine with use_pipeline=False: kernels A and B per block on the
    60 x 250 set.  Returns launches, expected launches and the distance
    error against the plain model."""
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
    return launches, expected, max(rel_err(p, r) for p, r in zip(preds, refs))


SOURCE = "phyloformer_tpu_torch/ops/kernels/csrc/"
# name: (source, TPU kernel it replaces)
KERNELS = {
    "kernel_p0": ("axial_pipeline.cu", "phyloformer_tpu/ops/pallas/pipeline.py:100"),
    "kernel_a_only": ("axial_pipeline.cu", "phyloformer_tpu/ops/pallas/pipeline.py:145"),
    "kernel_m": ("axial_pipeline.cu", "phyloformer_tpu/ops/pallas/pipeline.py:176"),
    "kernel_z": ("axial_pipeline.cu", "phyloformer_tpu/ops/pallas/pipeline.py:214"),
    "reduce_stats": ("axial_pipeline.cu", "phyloformer_tpu/ops/pallas/pipeline.py:136"),
    "kernel_a": ("axial_pipeline.cu", "phyloformer_tpu/ops/pallas/axial_block.py:252"),
    "kernel_b": ("axial_fused.cu", "phyloformer_tpu/ops/pallas/axial_block.py:294"),
    "kernel_a1": ("axial_fused.cu", "phyloformer_tpu/ops/pallas/axial_block.py:314"),
    "kernel_a2": ("axial_fused.cu", "phyloformer_tpu/ops/pallas/axial_block.py:353"),
}


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
    results.update(fused_kernel_checks(weights, device))
    torch.cuda.empty_cache()
    for name, r in results.items():
        r["max_abs_err"] = max(e[0] for e in r["errs"])
        r["max_rel_err"] = max(e[1] for e in r["errs"])
        print(f"{name}: max abs err {r['max_abs_err']:.3e}, relative {r['max_rel_err']:.3e} "
              f"(tol {KERNEL_TOL:.0e}), "
              f"{r['ms']:.3f} ms vs plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
              f"({r['bound_by']}) [{card}]")
    b = results["kernel_b"]
    print(f"kernel_b at the headline bucket: {b['headline_ms']:.3f} ms, bound "
          f"{b['headline_bound_ms']:.3f} ms [{card}]")
    bad = [n for n, r in results.items() if not r["max_rel_err"] <= KERNEL_TOL]
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")

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

    launches2, expected2, dist_err2 = two_kernel_path(device, mp["head_alns"], mp["head_refs"])
    print(f"two-kernel path: launches {launches2}, expected {expected2}")
    print(f"two-kernel path: distances vs plain model rel max err {dist_err2:.3e} "
          f"(tol {DIST_TOL:.0e})")
    if launches2 != expected2:
        fail("two-kernel path: launch counts differ from 6 A + 6 B per batch")
    if not dist_err2 <= DIST_TOL:
        fail("two-kernel path: distances disagree with the plain model")
    print(f"throughput: {mp['aln_per_s']:.3f} aln/s on {mp['n_head']} alignments of 60 x 250, "
          f"{mp['long_aln_per_s']:.3f} aln/s on {mp['n_long']} alignments of 60 x 1500 "
          f"[{card}]")

    line = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE + KERNELS[name][0],
         "replaces": KERNELS[name][1],
         "launches": mp["launches"][name] + launches2[name],
         "max_abs_err": r["max_abs_err"], "max_rel_err": r["max_rel_err"],
         "tolerance": KERNEL_TOL, "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"]}
        for name, r in results.items()],
        "card": card, "aln_per_s": mp["aln_per_s"], "long_aln_per_s": mp["long_aln_per_s"]}
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
