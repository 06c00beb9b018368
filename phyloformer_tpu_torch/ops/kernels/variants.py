"""Time the forward kernels built from variants of their CUDA sources.

    python3 -m phyloformer_tpu_torch.ops.kernels.variants \
        phyloformer_tpu_torch/ops/kernels/forward_variants.json [--out DIR]

The JSON file maps each variant's name to a list of ``[file, old, new]``
substitutions applied to a copy of ``csrc/`` (``[]``: the sources as they
are).  Every variant is built with the flags of
``_build.py`` (all variants in parallel) into ``DIR/<name>/`` (default
``runs/kernel_variants``, git-ignored); then kernels A, B and M run on the
headline bucket (9 batches of 60 tips x 256 sites, real ``pf_mre_r5``
weights, random alignments from a seed) against their plain versions, and
are timed with CUDA events, median of 5 after a warm-up, in two rounds over
all variants.  A variant that changes the numerics on purpose (a diagnostic
that drops work) shows it in its errors.  Needs one NVIDIA card and nvcc.
Prints one line per variant, the card's name and power limit, and a last
JSON line with every number.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys

import numpy as np

from . import _build

ROOT = str(_build._HERE.parents[2])
SRC = str(_build.SRC_DIR)
CKPT = os.path.join(ROOT, "artifacts", "pf_mre_r5.ckpt")
SEED = 7


def build_all(variants, out_dir):
    """Library path of each variant (all nvcc processes started together)."""
    nvcc = _build._nvcc()
    jobs = {}
    for name, subs in variants.items():
        d = os.path.join(out_dir, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(SRC, d)
        for f, old, new in subs:
            path = os.path.join(d, f)
            text = open(path).read()
            if old not in text:
                raise SystemExit(f"{name}: {f} has no {old!r}")
            open(path, "w").write(text.replace(old, new))
        objs = [os.path.join(d, s + ".o") for s in _build.SOURCES]
        procs = [subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-c", "-o", o, os.path.join(d, s)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(_build.SOURCES, objs)]
        jobs[name] = (d, objs, procs)
    libs = {}
    for name, (d, objs, procs) in jobs.items():
        logs = "".join(p.communicate()[0] for p in procs)
        if any(p.returncode for p in procs):
            raise SystemExit(f"{name}: nvcc failed\n{logs[-4000:]}")
        so = os.path.join(d, "libpf_axial.so")
        subprocess.run([nvcc, "-shared", "-o", so] + objs, check=True)
        spills = sorted({line.strip() for line in logs.splitlines() if "spill stores" in line})
        print(f"{name}: built; ptxas {spills}", flush=True)
        libs[name] = so
    return libs


def use(so):
    """Point the wrappers at the library ``so``."""
    from . import pipeline as pipe

    lib = ctypes.CDLL(so)
    for name, argtypes in _build._SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.pf_error_string.argtypes = [ctypes.c_int]
    lib.pf_error_string.restype = ctypes.c_char_p
    _build._lib = lib
    pipe._layout_checked = False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", help="JSON file: name -> [[file, old, new], ...]")
    ap.add_argument("--out", default=os.path.join(ROOT, "runs", "kernel_variants"))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("variants: needs an NVIDIA card")
    from ...data.pairs import pair_indices
    from ...io.ckpt_import import load_pretrained
    from ...models.params import map_params
    from . import fused
    from . import pipeline as pipe

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    libs = build_all(json.load(open(args.variants)), args.out)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    params, _, _ = load_pretrained(CKPT)
    w = pipe.PipelineWeights.from_params(map_params(lambda t: t.to(dev), params))
    rng = np.random.default_rng(SEED)
    b, n, l = 9, 60, 256
    codes = torch.from_numpy(rng.integers(0, 20, (b, n, l)).astype(np.int32)).to(dev)
    smask = torch.zeros((b, l), device=dev)
    smask[:, :250] = 1.0
    ii, jj = (torch.as_tensor(a, device=dev).long() for a in pair_indices(n))
    emb = torch.relu(w.embed_w[codes.long()] + w.embed_b)
    x0 = (emb[:, ii] + emb[:, jj]).contiguous()
    pmask = torch.ones((b, len(ii)), device=dev)
    pcount = pmask.sum(1)
    eps = 1e-5
    ref_a = pipe.kernel_a_only_plain(x0, smask, pmask, w.row[0], w.col[0], eps)
    x1, stats = ref_a
    ref_b = fused.kernel_b_plain(x1, stats, pcount, w.b[0], eps)
    ref_m = pipe.kernel_m_plain(x1, stats, smask, pmask, pcount, w.b[0], w.row[1], w.col[1], eps)

    def rel(got, want):
        want = want.double()
        return (got.double() - want).abs().max().item() / max(1.0, want.abs().max().item())

    def time_ms(fn, setup=lambda: (), reps=5):
        times = []
        for r in range(reps + 1):
            a = setup()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*a)
            end.record()
            torch.cuda.synchronize()
            if r:
                times.append(start.elapsed_time(end))
        return statistics.median(times)

    out = {name: {"a_ms": [], "b_ms": [], "m_ms": []} for name in libs}
    for rnd in range(2):
        for name, so in libs.items():
            use(so)
            r = out[name]
            if rnd == 0:
                got = fused.kernel_a(x0, smask, pmask, w.row[0], w.col[0], eps)
                r["err_a"] = max(rel(got[0], ref_a[0]), rel(got[1], ref_a[1]))
                r["err_b"] = rel(fused.kernel_b(x1, stats, pcount, w.b[0], eps), ref_b)
                got = pipe.kernel_m(x1.clone(), stats, smask, pmask, pcount, w.b[0], w.row[1],
                                    w.col[1], eps)
                r["err_m"] = max(rel(got[0], ref_m[0]), rel(got[1], ref_m[1]))
                del got
            r["a_ms"].append(time_ms(lambda: fused.kernel_a(x0, smask, pmask, w.row[0], w.col[0],
                                                            eps)))
            r["b_ms"].append(time_ms(lambda: fused.kernel_b(x1, stats, pcount, w.b[0], eps)))
            r["m_ms"].append(time_ms(
                lambda x: pipe.kernel_m(x, stats, smask, pmask, pcount, w.b[0], w.row[1],
                                        w.col[1], eps), setup=lambda: (x1.clone(),)))
            torch.cuda.synchronize()
    for name, r in out.items():
        print(f"{name}: A {r['a_ms']} ms (err {r['err_a']:.2e}), B {r['b_ms']} ms "
              f"(err {r['err_b']:.2e}), M {r['m_ms']} ms (err {r['err_m']:.2e}) [{card}]")
    print(card)
    print(json.dumps({"card": card, "variants": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
