"""Probe: the fine-tuning recipe's train step at ``make_mesh(data=4)`` over
NCCL, one rank a card, on the training cell's corpus.  Not a cell; the
benchmark's runs do not run this.

    python3 benchmark/probe_ddp.py --ranks 4 --steps 12 --seed 9
    python3 benchmark/probe_ddp.py --ranks 4 --device cpu --tiny   # gloo, on the host

Starts the ranks (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``
localhost, ``MASTER_PORT`` a free port), each taking the whole batch of
every step and its rows of it, and prints one JSON line: whether every rank
ended, each rank's losses, whether the ranks' losses are equal, and the
median ms a step after the first.  A rank's error is printed as it came.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if p and Path(p).resolve() != HERE]
sys.path.insert(0, str(ROOT))


def rank_main(steps: int, seed: int, device_kind: str, tiny: bool) -> None:
    import dataclasses

    from benchmark import harness, traffic
    from phyloformer_tpu_torch.data.fasta import Alignment
    from phyloformer_tpu_torch.io.ckpt_import import load_pretrained
    from phyloformer_tpu_torch.parallel.mesh import (
        init_distributed, make_mesh, shutdown_distributed)
    from phyloformer_tpu_torch.train.data import LoaderConfig
    from phyloformer_tpu_torch.train.packed import PackedBucketedLoader
    from phyloformer_tpu_torch.train.trainer import TrainConfig, create_train_state, make_train_step

    cell = harness.load_cell("train.tf32.recipe", ROOT)
    mod = harness.load_runner(cell.bench, "train")
    device = init_distributed("nccl" if device_kind == "cuda" else "gloo", device_kind)
    try:
        mesh = make_mesh(int(os.environ["WORLD_SIZE"]))
        wl, tr = cell.workload, cell.workload["train"]
        mix = dict(wl["corpus"])
        if tiny:  # a rehearsal of the ranks on the CPU
            mix.pop("tips_range")
            mix.update(tips=[4, 6], sites=[16, 24], reps=8)
        corpus = traffic.pool(mix, seed)
        loader = PackedBucketedLoader(mod._Examples(corpus, Alignment),
                                      LoaderConfig(batch_size=tr["batch_size"],
                                                   max_batch_tokens=tr["max_batch_tokens"],
                                                   seed=seed))
        params, cfg, _ = load_pretrained(cell.path(wl["weights"]))
        cfg = dataclasses.replace(cfg, matmul_precision=cell.config["matmul_precision"])
        tcfg = TrainConfig(loss=tr["loss"], learning_rate=tr["learning_rate"],
                           warmup_steps=tr["warmup_steps"], total_steps=tr["total_steps"],
                           use_pallas=True)
        state, tx = create_train_state(cfg, tcfg, params=params, device=device)
        step = make_train_step(cfg, tcfg, tx, mesh=mesh)
        losses, ms = [], []
        epoch = iter(loader)
        for _ in range(steps):
            batch = next(epoch)
            t = time.perf_counter()
            state, logs = step(state, batch)
            losses.append(float(logs["train_loss"]))
            ms.append(1e3 * (time.perf_counter() - t))
        epoch.close()
        print(json.dumps({"rank": mesh.rank, "losses": losses, "ms": ms}), flush=True)
    finally:
        shutdown_distributed()


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--steps", type=int, default=12)
    p.add_argument("--seed", type=int, default=9)
    p.add_argument("--timeout", type=float, default=300.0,
                   help="seconds for every rank to end, after which all are killed")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cpu: gloo ranks on the host, for a rehearsal")
    p.add_argument("--tiny", action="store_true", help="a corpus of tiny alignments")
    p.add_argument("--rank-main", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rank_main:
        rank_main(args.steps, args.seed, args.device, args.tiny)
        return 0
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(args.ranks):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE=str(args.ranks), MASTER_ADDR="localhost", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, __file__, "--rank-main", "--steps", str(args.steps), "--seed",
             str(args.seed), "--device", args.device] + (["--tiny"] if args.tiny else []),
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs, deadline = [], time.monotonic() + args.timeout
    for proc in procs:  # one deadline for all: a rank stuck in a collective holds the others
        try:
            out, err = proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        outs.append((proc.returncode, out, err))
    lines = [json.loads(o.strip().splitlines()[-1]) for rc, o, _ in outs
             if rc == 0 and o.strip()]
    ok = len(lines) == args.ranks
    result = {"ranks_ended": sum(rc == 0 for rc, _, _ in outs), "ranks": args.ranks}
    if ok:
        result["losses_equal"] = all(x["losses"] == lines[0]["losses"] for x in lines)
        result["losses"] = lines[0]["losses"]
        result["median_ms_after_first"] = statistics.median(
            m for x in lines for m in x["ms"][1:])
    else:
        result["errors"] = [e[-1500:] for rc, _, e in outs if rc != 0]
    print(json.dumps(result), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
