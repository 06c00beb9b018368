"""The readings that the limits of ``correct`` are set from, on the card at
a cell's own sizes: for each seed, the program's number and the control's
(the next precision down), and for the training cell the planted fault.
The benchmark's own runs do not run this.

    python3 benchmark/controls.py --workload <cell> --seeds 11,12,13

Prints one JSON line a seed.  The controls, by configuration:

- ``phyloformer-fp32`` (offline): the engine at one TF32 pass
  (``matmul_precision="tensorfloat32"``), the program's own lower path;
- ``phyloformer-tf32`` (serving): the engine as the server builds it, at
  bf16 parameters (``precision="bfloat16"``), and, as a second reading,
  with x1 stored in bf16 between the pipeline's kernels
  (``pipeline_act_dtype="bfloat16"``);
- ``phyloformer-tf32`` (training): the reference itself at bf16
  parameters and activations, put in the program's place; and the fault
  "half of each checked batch left out, the mean over the rest", planted
  in the reference; both on set-up's checked steps and on the window's
  last step, made from the program's state before it.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if p and Path(p).resolve() != HERE]
sys.path.insert(0, str(ROOT))


def engine_gap(cell, pool, refs, device, **icfg):
    from phyloformer_tpu_torch.data.fasta import Alignment
    from phyloformer_tpu_torch.infer.engine import InferenceConfig, InferenceEngine
    from phyloformer_tpu_torch.io.ckpt_import import load_pretrained

    from benchmark import compare

    params, cfg, _ = load_pretrained(cell.path(cell.workload["weights"]))
    engine = InferenceEngine(params, cfg, InferenceConfig(**icfg), device=device)
    alns = [Alignment(codes=it["codes"], ids=[f"s{i}" for i in range(it["n"])]) for it in pool]
    out = engine.predict(alns)
    del engine
    gc.collect()
    return compare.dist_gap(zip(out, refs))


def inference_readings(cell, seed, device):
    import torch

    from benchmark import traffic
    from benchmark.reference import phyloformer as reference

    pool = traffic.pool(cell.workload["pool"], seed)
    net = reference.from_checkpoint(cell.path(cell.workload["weights"]), cell.config, device)
    refs = [reference.predict(net, it["codes"], device).numpy() for it in pool]
    del net
    torch.cuda.empty_cache()
    mp = cell.config["matmul_precision"]
    if cell.workload["runner"] == "offline":
        return {"program": engine_gap(cell, pool, refs, device, matmul_precision=mp),
                "control": engine_gap(cell, pool, refs, device,
                                      matmul_precision="tensorfloat32")}
    served = dict(matmul_precision=mp, max_batch_tokens=1 << 23, pad_batch_sizes=True)
    return {"program": engine_gap(cell, pool, refs, device, **served),
            "control": engine_gap(cell, pool, refs, device, precision="bfloat16", **served),
            "control_bf16_storage": engine_gap(cell, pool, refs, device,
                                               pipeline_act_dtype="bfloat16", **served)}


def training_readings(cell, seed, device, seconds):
    """The program's readings from a run of the cell's set-up and a window
    of ``seconds``; the control's and the fault's from the reference put in
    the program's place on the same checked batches and, for the window's
    last step, from the same state of the program."""
    import torch

    from benchmark import compare
    from benchmark.harness import load_runner
    from benchmark.window import Window

    mod = load_runner(cell.bench, "train")
    runner = mod.Runner(cell, seed, device)
    try:
        runner.setup()
        with Window(False, device) as win:
            runner.window(win, seconds)
        runner.settle()
    finally:
        runner.release()
    torch.cuda.empty_cache()
    corpus, ids, late = runner.corpus, runner.checked_ids, runner.late

    def half(x):
        return x[: len(x) - len(x) // 2]

    def readings(dtype, keep=None):
        return (mod.follow(cell, corpus, ids, device, dtype, keep=keep),
                mod.follow_late(cell, corpus, late, device, dtype, keep=keep))

    ref, ref_late = readings(torch.float32)

    def gaps(got, got_late):
        return {**compare.train_gaps(got, ref), **compare.late_gaps(got_late, ref_late)}

    return {"batches": [len(x) for x in ids], "late_batch": len(late["ids"]),
            "late_step": late["step"],
            "program": gaps(runner.prog, mod.late_reading(late)),
            "control": gaps(*readings(torch.bfloat16)),
            "fault_half_batch": gaps(*readings(torch.float32, keep=half))}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=None,
                   help="training: the window before the last step (default: run_seconds)")
    args = p.parse_args(argv)

    import torch

    from benchmark import harness

    cell = harness.load_cell(args.workload, ROOT)
    harness.set_cache_dirs(ROOT)
    harness.require_cards(int(cell.entry["chips"]))
    device = torch.device("cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        if cell.workload["runner"] == "train":
            out = training_readings(cell, seed, device,
                                    args.seconds or cell.manifest["run_seconds"])
        else:
            out = inference_readings(cell, seed, device)
        print(json.dumps({"workload": args.workload, "seed": seed, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
