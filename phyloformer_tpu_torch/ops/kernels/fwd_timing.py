"""Time the forward kernels of a checkout of the port, or hash their outputs.

    python3 phyloformer_tpu_torch/ops/kernels/fwd_timing.py [--root DIR] [--hashes]

Imports ``phyloformer_tpu_torch`` from ``DIR`` (default: the checkout this
file is in), so that one copy of this script runs another checkout's
kernels, e.g. a parent commit unpacked with ``git archive``; run it once per
checkout, in turns (parent, change, change, parent), to compare two
versions on one card.  Every kernel runs through its wrapper's defaults
(three TF32 passes, fp32 storage, exact GELU), so checkouts whose wrappers
predate the reduced-precision arguments run the same calls.  Weights:
``artifacts/pf_mre_r5.ckpt``.

- Default: P0, A-only, M, Z, A and B at the headline bucket (9 random
  alignments of 60 x 256, no padding), the median CUDA-event time of one
  launch (its reductions included) over 15 runs after two warm-ups; one
  JSON line.
- ``--hashes``: the first 16 hex digits of the SHA-256 of every output of
  P0, A-only, M and Z (exact and tanh), A, B, A1, A2 and the pipelined
  forward, on a ragged batch of 300 sites and one of 30 x 1100 sites; two
  checkouts whose kernels compute the same bits print the same line.

Needs one NVIDIA card and nvcc.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def _inputs(w, rng, dims, pad_n, pad_l, device):
    """Codes, masks, the embedding, pair indices, float masks, pair counts
    and the gathered pair tensor of a random padded batch."""
    import numpy as np
    import torch

    from phyloformer_tpu_torch.data.pairs import pair_indices

    b = len(dims)
    codes = np.zeros((b, pad_n, pad_l), np.int32)
    sm = np.zeros((b, pad_l), bool)
    qm = np.zeros((b, pad_n), bool)
    for r, (n, l) in enumerate(dims):
        codes[r, :n, :l] = rng.integers(0, 20, (n, l))
        sm[r, :l] = True
        qm[r, :n] = True
    codes, sm, qm = (torch.from_numpy(t).to(device) for t in (codes, sm, qm))
    ii, jj = (torch.as_tensor(a, device=device) for a in pair_indices(pad_n))
    emb = torch.relu(w.embed_w[codes.long()] + w.embed_b).contiguous()
    smask = sm.float().contiguous()
    pmask = (qm[:, ii.long()] & qm[:, jj.long()]).float().contiguous()
    x0 = (emb[:, ii.long()] + emb[:, jj.long()]).contiguous()
    return codes, sm, qm, emb, ii, jj, smask, pmask, pmask.sum(1), x0


def median_ms(fn, setup=None, reps=15):
    import torch

    out = []
    for r in range(reps + 2):
        args = setup() if setup else ()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        torch.cuda.synchronize()
        if r >= 2:
            out.append(start.elapsed_time(end))
    return statistics.median(out)


def times(w, pipe, fused, device):
    import numpy as np
    import torch

    from phyloformer_tpu_torch.data.pairs import pair_indices

    b, n, l = 9, 60, 256
    codes = torch.from_numpy(np.random.default_rng(1).integers(0, 20, (b, n, l))
                             .astype(np.int32)).to(device)
    ii, jj = (torch.as_tensor(a, device=device) for a in pair_indices(n))
    emb = torch.relu(w.embed_w[codes.long()] + w.embed_b).contiguous()
    smask = torch.ones(b, l, device=device)
    pmask = torch.ones(b, len(ii), device=device)
    pc = pmask.sum(1)
    x0 = (emb[:, ii.long()] + emb[:, jj.long()]).contiguous()
    x1, st = pipe.kernel_p0(emb, ii, jj, smask, pmask, w.row[0], w.col[0], 1e-5)
    res = {
        "p0": median_ms(lambda: pipe.kernel_p0(emb, ii, jj, smask, pmask, w.row[0], w.col[0],
                                               1e-5)),
        "a_only": median_ms(lambda x: pipe.kernel_a_only(x, smask, pmask, w.row[0], w.col[0],
                                                         1e-5), lambda: (x0.clone(),)),
        "m": median_ms(lambda x: pipe.kernel_m(x, st, smask, pmask, pc, w.b[0], w.row[1],
                                               w.col[1], 1e-5), lambda: (x1.clone(),)),
        "z": median_ms(lambda: pipe.kernel_z(x1, st, smask, pc, w.b[-1], w.head, 1e-5)),
        "a": median_ms(lambda: fused.kernel_a(x0, smask, pmask, w.row[0], w.col[0], 1e-5)),
        "b": median_ms(lambda: fused.kernel_b(x1, st, pc, w.b[0], 1e-5)),
    }
    return {k: round(v, 4) for k, v in res.items()}


def hashes(w, pipe, fused, device):
    import numpy as np

    out = {}

    def h(name, t):
        out[name] = hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]

    rng = np.random.default_rng(5)
    for case, (dims, pad_n, pad_l) in {"a": ([(40, 300), (33, 260)], 40, 300),
                                       "b": ([(30, 1100)], 30, 1100)}.items():
        codes, sm, qm, emb, ii, jj, smask, pmask, pc, x0 = _inputs(w, rng, dims, pad_n, pad_l,
                                                                   device)
        x1, st = pipe.kernel_p0(emb, ii, jj, smask, pmask, w.row[0], w.col[0], 1e-5)
        h(case + "p0.x1", x1)
        h(case + "p0.st", st)
        y, s2 = pipe.kernel_a_only(x0.clone(), smask, pmask, w.row[0], w.col[0], 1e-5)
        h(case + "ao.x1", y)
        h(case + "ao.st", s2)
        for g in ("exact", "tanh"):
            y, s2 = pipe.kernel_m(x1.clone(), st, smask, pmask, pc, w.b[0], w.row[1], w.col[1],
                                  1e-5, g)
            h(case + "m." + g + ".x1", y)
            h(case + "m." + g + ".st", s2)
            h(case + "z." + g, pipe.kernel_z(x1, st, smask, pc, w.b[-1], w.head, 1e-5, g))
        y, s2 = fused.kernel_a(x0, smask, pmask, w.row[0], w.col[0], 1e-5)
        h(case + "a.x1", y)
        h(case + "a.st", s2)
        h(case + "b", fused.kernel_b(x1, st, pc, w.b[0], 1e-5))
        rs = fused.kernel_a1(x0, smask, w.row[0], 1e-5)
        h(case + "a1", rs)
        y, s2 = fused.kernel_a2(x0, rs, smask, pmask, w.row[0], w.col[0], 1e-5)
        h(case + "a2.x1", y)
        h(case + "a2.st", s2)
        h(case + "pipeline", pipe.forward_fused_pipeline(w, codes, sm, qm))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(HERE))),
                    help="checkout whose phyloformer_tpu_torch runs (default: this one)")
    ap.add_argument("--hashes", action="store_true",
                    help="print the hashes of the outputs instead of the times")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    from phyloformer_tpu_torch.io.ckpt_import import load_pretrained
    from phyloformer_tpu_torch.models.params import map_params
    from phyloformer_tpu_torch.ops.kernels import fused
    from phyloformer_tpu_torch.ops.kernels import pipeline as pipe

    if not os.path.abspath(pipe.__file__).startswith(root + os.sep):
        raise SystemExit(f"the port was imported from outside {root}: {pipe.__file__}")
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    params = load_pretrained(os.path.join(root, "artifacts", "pf_mre_r5.ckpt"))[0]
    w = pipe.PipelineWeights.from_params(map_params(lambda t: t.to(device), params))
    fn = hashes if args.hashes else times
    print(json.dumps({"root": root, "card": torch.cuda.get_device_name(device),
                      **fn(w, pipe, fused, device)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
