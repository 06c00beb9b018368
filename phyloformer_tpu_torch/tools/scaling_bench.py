"""Weak scaling of the training step over ranks, and a communication model.

1. **Weak scaling**: a fixed batch per rank (``PER_RANK_BATCH`` alignments of
   ``N`` tips x ``L`` sites), over 1, 2, 4 and 8 ranks (``RANKS``), each a set
   of processes joined by ``torch.distributed`` over gloo on a
   ``parallel.mesh.make_mesh`` mesh: data parallel, with the pair axis split
   over 2 ranks from 4 ranks up.  Every rank of a run is on the one card (or
   on the CPU with ``--device cpu``), so the times measure that the sharded
   step runs and what its collectives cost there, not a speed-up: the report
   gives the cost per example against one rank.
2. **Communication model**: the bytes the collectives move each step (the
   gradient all-reduce of the data axis, the pair axis's all-reduced sums),
   over an NVLink and a network link, against the fused training step
   measured on one card.

    python -m phyloformer_tpu_torch.tools.scaling_bench [--device cpu]
    python -m phyloformer_tpu_torch.tools.scaling_bench worker N [--device cpu]   # one rank

Runs on the card unless ``--device cpu`` is given.  The JAX package's
``tools/scaling_bench.py``; its worker prints the same JSON keys.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

PER_RANK_BATCH = 1
N, L = 16, 64
STEPS = 2
RANKS = (1, 2, 4, 8)
TIMEOUT_S = 1200

# The fused fp32 training step at 4 x 50 x 256 on one NVIDIA H100 80GB HBM3 at a
# 700 W limit (chip_smoke.py's training phase, PERF.md); the links' rates are
# data-sheet figures: NVLink 4 one way, one 400 Gb/s InfiniBand NDR port.
STEP_MS_CARD = 132.3
NVLINK_GBPS, NETWORK_GBPS = 450.0, 50.0


def pair_axis(ranks: int) -> int:
    return 2 if ranks >= 4 else 1


def batch(global_batch: int):
    """The step's batch, drawn as the JAX tool draws it (numpy, seed 0)."""
    import numpy as np

    from ..data.pairs import n_pairs

    rng = np.random.default_rng(0)
    return {
        "codes": rng.integers(0, 22, (global_batch, N, L)).astype(np.int32),
        "dists": rng.uniform(0.01, 2.0, (global_batch, n_pairs(N))).astype(np.float32),
        "site_mask": np.ones((global_batch, L), dtype=bool),
        "seq_mask": np.ones((global_batch, N), dtype=bool),
    }


def worker(ranks: int, device: str, init=None) -> dict:
    """One rank of a run of ``ranks`` (torchrun's env:// variables give its
    rank): one untimed step, then ``STEPS`` timed ones.  ``init``: an ``.npz``
    of the initial parameters (default: ``init_params`` from the trainer's
    seed).  Returns JAX's keys; rank 0 prints them."""
    import numpy as np
    import torch

    from ..io.checkpoint import load_params_npz
    from ..models.params import PhyloformerConfig, init_params, params_from_numpy
    from ..parallel.mesh import init_distributed, make_mesh, shutdown_distributed
    from ..train.trainer import TrainConfig, create_train_state, make_train_step

    if device == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, min(torch.get_num_threads(), (os.cpu_count() or 1) // ranks)))
    dev = init_distributed("gloo", device) if ranks > 1 else None
    try:
        pair = pair_axis(ranks)
        mesh = make_mesh(data=ranks // pair, pair=pair)
        cfg = PhyloformerConfig()
        tcfg = TrainConfig(total_steps=10, warmup_steps=2, shard_pairs=pair > 1)
        params = (params_from_numpy(load_params_npz(init)) if init
                  else init_params(cfg, torch.Generator().manual_seed(tcfg.seed)))
        state, tx = create_train_state(cfg, tcfg, params, device=dev or device)
        step = make_train_step(cfg, tcfg, tx, mesh=mesh)
        bsz = PER_RANK_BATCH * mesh.data
        b = batch(bsz)
        state, logs = step(state, b)  # the first step: allocations, kernel loads
        float(logs["train_loss"])
        times = []
        for _ in range(STEPS):
            t0 = time.perf_counter()
            state, logs = step(state, b)
            float(logs["train_loss"])
            times.append(time.perf_counter() - t0)
        rec = {"devices": ranks, "mesh": dict(mesh.shape), "global_batch": bsz,
               "median_step_s": float(np.median(times)), "loss": float(logs["train_loss"])}
        if mesh.rank == 0:
            print(json.dumps(rec), flush=True)
        return rec
    finally:
        shutdown_distributed()


def run_ranks(ranks: int, device: str, init=None) -> dict:
    """A run of ``ranks`` processes of :func:`worker`, joined through a
    rendezvous store this process hosts on a port it binds itself; returns
    rank 0's record.  Fails if a rank fails or the run outlasts ``TIMEOUT_S``."""
    from torch import distributed as dist

    from . import child_env

    store = dist.TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False)
    cmd = [sys.executable, "-m", "phyloformer_tpu_torch.tools.scaling_bench", "worker",
           str(ranks), "--device", device, "--shape", str(N), str(L), str(STEPS)] + (
               ["--init", str(init)] if init else [])
    procs = []
    for rank in range(ranks):
        env = child_env(RANK=str(rank), WORLD_SIZE=str(ranks), LOCAL_RANK="0",
                        MASTER_ADDR="127.0.0.1", MASTER_PORT=str(store.port),
                        TORCHELASTIC_USE_AGENT_STORE="True", TORCHELASTIC_RESTART_COUNT="0")
        procs.append(subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    deadline = time.monotonic() + TIMEOUT_S
    while any(p.poll() is None for p in procs):
        if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            break
        time.sleep(0.2)
    outs = [p.communicate() for p in procs]
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"ranks={ranks}: rank {r} exited {p.returncode}:\n{err[-2000:]}")
    return json.loads(outs[0][0].strip().splitlines()[-1])


def comm_model(n_params: int) -> dict:
    """Bytes a step of the collectives moves and their time over each link."""
    grad_mb = 2 * n_params * 4 / 1e6  # a ring all-reduce moves ~2x the gradients a member
    b, l, d, blocks = 4, 256, 64, 6
    # the pair axis, per block: the column stats (B, L, 3d) in the forward and
    # the row sums A1 (B, L, d) in the backward, fp32
    pair_mb = blocks * (b * l * 3 * d + b * l * d) * 4 / 1e6
    t_nv, t_net = (grad_mb / 1e3 / g * 1000 for g in (NVLINK_GBPS, NETWORK_GBPS))
    return {"grad_allreduce_mb": grad_mb, "pair_allreduce_mb": pair_mb,
            "grad_ms_nvlink": t_nv, "grad_ms_network": t_net,
            "pair_ms_nvlink": pair_mb / 1e3 / NVLINK_GBPS * 1000,
            "efficiency_nvlink": STEP_MS_CARD / (STEP_MS_CARD + t_nv),
            "efficiency_network": STEP_MS_CARD / (STEP_MS_CARD + t_net)}


def orchestrate(device: str, init=None) -> list:
    """Every run of ``RANKS``, its line printed; then the per-example cost
    against one rank and the communication model."""
    from ..models.params import PhyloformerConfig, count_params, init_params

    results = []
    for d in RANKS:
        rec = run_ranks(d, device, init)
        results.append(rec)
        print(f"ranks={d} mesh={rec['mesh']} global_batch={rec['global_batch']} "
              f"step={rec['median_step_s'] * 1000:.0f} ms loss={rec['loss']:.4f}", flush=True)

    base = results[0]["median_step_s"] / results[0]["global_batch"]
    print(f"\nper-example step cost (every rank on one {device} device):")
    for rec in results:
        per_ex = rec["median_step_s"] / rec["global_batch"]
        print(f"  ranks={rec['devices']}: {per_ex * 1000:.0f} ms/example "
              f"(x{per_ex / base:.2f} vs 1 rank)")

    n_params = count_params(init_params(PhyloformerConfig()))
    m = comm_model(n_params)
    print(f"\nanalytic data-parallel model ({STEP_MS_CARD} ms fused step on one H100, "
          f"{n_params} parameters):")
    print(f"  gradient all-reduce: {m['grad_allreduce_mb']:.2f} MB/step")
    print(f"  over NVLink ({NVLINK_GBPS} GB/s): {m['grad_ms_nvlink']:.4f} ms -> "
          f"efficiency {m['efficiency_nvlink'] * 100:.2f}%")
    print(f"  over the network ({NETWORK_GBPS} GB/s): {m['grad_ms_network']:.4f} ms -> "
          f"efficiency {m['efficiency_network'] * 100:.2f}% at 2 hosts")
    print(f"  pair-axis all-reduce (B=4, L=256): {m['pair_allreduce_mb']:.2f} MB/step -> "
          f"{m['pair_ms_nvlink']:.4f} ms over NVLink")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m phyloformer_tpu_torch.tools.scaling_bench")
    ap.add_argument("mode", nargs="?", choices=["worker"])
    ap.add_argument("ranks", nargs="?", type=int)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    # a worker's initial parameters (.npz), and the orchestrator's N, L and STEPS
    ap.add_argument("--init", help=argparse.SUPPRESS)
    ap.add_argument("--shape", nargs=3, type=int, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.shape:
        global N, L, STEPS
        N, L, STEPS = args.shape

    from ..device import resolve_device

    resolve_device(args.device)
    if args.mode == "worker":
        worker(args.ranks, args.device, args.init)
    else:
        orchestrate(args.device, args.init)
    return 0


if __name__ == "__main__":
    sys.exit(main())
