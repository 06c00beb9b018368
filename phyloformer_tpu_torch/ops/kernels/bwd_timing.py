"""Time backward kernels C, D, E, E1 and E2 of a checkout of the port, or hash their outputs.

    python3 phyloformer_tpu_torch/ops/kernels/bwd_timing.py [--root DIR] [--hashes]

Imports ``phyloformer_tpu_torch`` from ``DIR`` (default: the checkout this
file is in), so that one copy of this script times another checkout's
kernels, e.g. a parent commit unpacked with ``git archive``; run it once per
checkout, in turns (parent, change, change, parent), to compare two
versions on one card.  Inputs are those of the fused backward on layer 0 of
``artifacts/pf_mre_r5.ckpt`` (the block-0 input of random alignments from a
seed, a seeded cotangent masked as a masked loss makes it):

- C and D at the training shape 4 x 50 tips x 256 sites (4 x 1225 pairs)
  and at the long training bucket 2 x 50 x 1536;
- E at 4 x 50 x 256 and at 2 x 50 x 1024 (the longest row kernel E takes);
- E1 at 2 x 50 x 1536, and E2 there on E1's row sums.

Each time is the median CUDA-event time of one launch (its reductions
included) over 7 runs after a warm-up.  Every kernel runs through its
wrapper's defaults (three TF32 passes), so checkouts whose wrappers predate
the pass count run the same calls.  ``--hashes``: instead of the times, the
first 16 hex digits of the SHA-256 of every output of C, D and E (g2, A1,
g1, gx, the weight gradients) on a batch of 2 x 30 tips x 300 sites, and of
C, D, E1 and E2 on 1 x 20 x 1100; two checkouts whose kernels compute the
same bits print the same line.  Needs one NVIDIA card and nvcc.  Prints one
line per shape (or the hashes), the card's name and power limit, and a last
JSON line with every number.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 1234
D, H = 64, 4


def median_ms(fn, reps=7):
    import torch

    times = []
    for r in range(reps + 1):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        if r:
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def inputs(params, layer, b, n, l, device, seed):
    """x, x1, stats, g3, g2, A1, g1 and the masks of one batch of b
    alignments of n tips x l sites (the fused forward's residuals, g2 and A1
    from kernel C, g1 from D)."""
    import numpy as np
    import torch

    from phyloformer_tpu_torch.data.pairs import pair_indices
    from phyloformer_tpu_torch.ops.kernels import axial_block_bwd as bw
    from phyloformer_tpu_torch.ops.kernels import fused

    rng = np.random.default_rng(seed)
    codes = torch.from_numpy(rng.integers(0, 20, (b, n, l))).to(device)
    i, j = (torch.as_tensor(a, device=device).long() for a in pair_indices(n))
    emb = torch.relu(params["embed"]["w"][codes] + params["embed"]["b"])
    x = (emb[:, i] + emb[:, j]).contiguous()
    del emb
    smask = torch.ones((b, l), device=device)
    pmask = torch.ones((b, x.shape[1]), device=device)
    pcount = pmask.sum(1)
    _, x1, stats = fused.fused_axial_block_res(x, layer, smask, pmask)
    g3 = torch.randn(x.shape, device=device,
                     generator=torch.Generator(device).manual_seed(seed)).contiguous()
    w = bw.BwdWeights.of(layer)
    g2, a1, _ = bw.kernel_c(x1, g3, stats, pmask, pcount, w.c, 1e-5)
    g1, _ = bw.kernel_d(x1, g2, stats, a1, pmask, pcount, w.d, 1e-5)
    return dict(x=x, x1=x1, stats=stats, g3=g3, g2=g2, a1=a1, g1=g1, smask=smask, pmask=pmask,
                pcount=pcount, w=w)


def hashes(params, layer, device):
    """The hashes of every output of the backward kernels (C, D and E at
    300 sites; C, D, E1 and E2 at 1100), by kernel and output."""
    from phyloformer_tpu_torch.ops.kernels import axial_block_bwd as bw

    out = {}

    def h(name, t):
        out[name] = hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]

    for case, (b, n, l) in {"a": (2, 30, 300), "b": (1, 20, 1100)}.items():
        t = inputs(params, layer, b, n, l, device, SEED + 1)
        w = t["w"]
        for name, v in zip(("g2", "a1", "dw"), bw.kernel_c(t["x1"], t["g3"], t["stats"],
                                                          t["pmask"], t["pcount"], w.c, 1e-5)):
            h(f"{case}.c.{name}", v)
        for name, v in zip(("g1", "dw"), bw.kernel_d(t["x1"], t["g2"], t["stats"], t["a1"],
                                                     t["pmask"], t["pcount"], w.d, 1e-5)):
            h(f"{case}.d.{name}", v)
        if l > 1024:
            rowsums = bw.kernel_e1(t["x"], t["g1"], t["smask"], w.e, 1e-5)
            h(f"{case}.e1.rowsums", rowsums)
            outs = bw.kernel_e2(t["x"], t["g1"], rowsums, t["smask"], w.e, 1e-5)
            kernel = "e2"
        else:
            outs = bw.kernel_e(t["x"], t["g1"], t["smask"], w.e, 1e-5)
            kernel = "e"
        for name, v in zip(("gx", "dw"), outs):
            h(f"{case}.{kernel}.{name}", v)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.abspath(os.path.join(HERE, "..", "..", "..")),
                    help="the checkout whose phyloformer_tpu_torch is timed")
    ap.add_argument("--hashes", action="store_true",
                    help="print the hashes of the outputs instead of the times")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bwd_timing: needs an NVIDIA card")
    import phyloformer_tpu_torch
    from phyloformer_tpu_torch.io.ckpt_import import load_pretrained
    from phyloformer_tpu_torch.models.params import map_params
    from phyloformer_tpu_torch.ops.kernels import axial_block_bwd as bw

    if not os.path.abspath(phyloformer_tpu_torch.__file__).startswith(root + os.sep):
        raise SystemExit(f"bwd_timing: imported {phyloformer_tpu_torch.__file__}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    params, _, _ = load_pretrained(os.path.join(root, "artifacts", "pf_mre_r5.ckpt"))
    params = map_params(lambda t: t.to(device), params)
    layer = params["layers"][0]
    if args.hashes:
        out = hashes(params, layer, device)
        print(f"hashes of {len(out)} outputs [{card}]")
        print(json.dumps(out, sort_keys=True))
        return 0
    out = {"root": root, "card": card}
    launch = {
        "kernel_c": lambda t: bw.kernel_c(t["x1"], t["g3"], t["stats"], t["pmask"], t["pcount"],
                                          t["w"].c, 1e-5),
        "kernel_d": lambda t: bw.kernel_d(t["x1"], t["g2"], t["stats"], t["a1"], t["pmask"],
                                          t["pcount"], t["w"].d, 1e-5),
        "kernel_e": lambda t: bw.kernel_e(t["x"], t["g1"], t["smask"], t["w"].e, 1e-5),
        "kernel_e1": lambda t: bw.kernel_e1(t["x"], t["g1"], t["smask"], t["w"].e, 1e-5),
        "kernel_e2": lambda t: bw.kernel_e2(t["x"], t["g1"], t["rowsums"], t["smask"], t["w"].e,
                                            1e-5)}
    for (b, n, l), kernels in (((4, 50, 256), ("kernel_c", "kernel_d", "kernel_e")),
                               ((2, 50, 1536), ("kernel_c", "kernel_d", "kernel_e1", "kernel_e2")),
                               ((2, 50, 1024), ("kernel_e",))):
        t = inputs(params, layer, b, n, l, device, SEED)
        if "kernel_e2" in kernels:
            t["rowsums"] = bw.kernel_e1(t["x"], t["g1"], t["smask"], t["w"].e, 1e-5)
        for kernel in kernels:
            key = f"{kernel} {b}x{t['x'].shape[1]}x{l}"
            out[key] = median_ms(lambda: launch[kernel](t))
            print(f"{key}: {out[key]:.3f} ms per launch [{card}]", flush=True)
        del t
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
