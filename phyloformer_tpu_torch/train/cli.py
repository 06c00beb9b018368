"""Training CLI (PyTorch/CUDA) — the flags of the JAX package's ``pf-train``.

    pf-train-torch -t trees/ -a msas/ [-T val_trees/ -A val_msas/] \\
        [--batch-size 4] [--learning-rate 1e-4] [--warmup-steps 5000] ...
    pf-train-torch --packed-data packed/ [--packed-val-fraction 0.1] ...
    python -m phyloformer_tpu_torch.train.cli ...

Runs on the card unless ``--device cpu`` is given.  ``--use-pallas auto``
runs the fused kernels forward and backward on ``cuda`` when dropout is 0
and ``--remat`` is off, at any alignment length; ``--dropout`` > 0 trains
the eager model (``--use-pallas on`` with it raises JAX's "use_pallas
training requires dropout=0"), its masks drawn from a generator seeded
with ``--seed``.  ``--base-model`` takes a reference ``.ckpt``, an ``.npz``
parameter file or a checkpoint directory of either package's trainer;
``--load-checkpoint`` resumes from the latest checkpoint of a directory
(``<output-dir>/checkpoints_<run-name>``), the port's or the JAX trainer's
(Orbax: parameters, step, Adam moments and count, schedule position and
``--grad-accum``'s accumulator; reading it needs ``tensorstore``).
``--packed-data`` reads shards written by ``pf-preprocess-torch`` (or the
JAX package's ``pf-preprocess``);
``--profile`` traces 10 steps into ``<output-dir>/profile`` and exits;
``--find-batch-size`` prints each probe on stderr and the largest batch
size whose step fits as JSON (over a ``data`` mesh, every rank probes its
rows and the ranks agree on each probe);
``--debug-nans`` stops at the first non-finite loss or gradient.
``--matmul-precision tensorfloat32`` or ``default`` trains at reduced
precision: the kernels' products, forward and backward, in one TF32 pass
(the plain versions round their operands the same way on ``--device
cpu``), the eager route's in TF32.

Over several ranks (``torchrun``, or processes given torchrun's
``env://`` variables): ``--distributed-init`` joins the process group (nccl
on the card, gloo on the CPU, ``--distributed-init gloo`` gloo on the
card), ``--mesh-data`` / ``--mesh-pair`` shape the ranks (a world of
several ranks is data parallel by default) and ``--shard-pairs`` splits the
pair activations over the pair axis.  Every rank builds the same batches
from the seed and takes its part; rank 0 alone logs, prints and writes
checkpoints::

    torchrun --nproc-per-node 2 -m phyloformer_tpu_torch.train.cli -t T -a A \
        --distributed-init --mesh-pair 2 --shard-pairs
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

from ..infer.cli import add_distributed_flags


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="pf-train-torch",
                                description="Train Phyloformer (PyTorch/CUDA)")

    data = p.add_argument_group("data")
    data.add_argument("--train-trees", "-t", default=None)
    data.add_argument("--train-alignments", "-a", default=None)
    data.add_argument("--packed-data", default=None,
                      help="shard directory from pf-preprocess-torch (instead of -t/-a)")
    data.add_argument("--packed-val-fraction", type=float, default=0.1,
                      help="share of the packed examples held out for validation")
    data.add_argument("--val-trees", "-T", default=None)
    data.add_argument("--val-alignments", "-A", default=None)
    data.add_argument("--train-regex", "-r", default=None)
    data.add_argument("--val-regex", "-R", default=None)
    data.add_argument("--num-workers", type=int, default=None,
                      help="IO worker threads (default: from the cpu count)")

    start = p.add_argument_group("starting point")
    start.add_argument("--load-checkpoint", "-c", default=None,
                       help="checkpoint directory to resume training from (the port's, "
                            "or the JAX trainer's Orbax run directory)")
    start.add_argument("--base-model", "-m", default=None,
                       help="checkpoint to fine-tune from (.ckpt torch zip, .npz, or a "
                            "trainer directory of either package)")

    arch = p.add_argument_group("architecture")
    arch.add_argument("--dropout", "-D", type=float, default=0.0)
    arch.add_argument("--nb-blocks", "-b", type=int, default=6)
    arch.add_argument("--embed-dim", "-d", type=int, default=64)
    arch.add_argument("--nb-heads", "-H", type=int, default=4)
    arch.add_argument("--matmul-precision", default="float32",
                      choices=["float32", "tensorfloat32", "default"],
                      help="float32 = IEEE fp32 products; tensorfloat32 | default = one "
                           "TF32 pass in the kernels' products (and PyTorch's on the "
                           "eager route)")

    train = p.add_argument_group("training")
    train.add_argument("--nb-epochs", "-e", type=int, default=100)
    train.add_argument("--warmup-steps", "-w", type=int, default=5000)
    train.add_argument("--learning-rate", "-l", type=float, default=1e-4)
    train.add_argument("--check-val-every", type=int, default=10_000)
    train.add_argument("--batch-size", "-s", type=int, default=4)
    train.add_argument("--max-batch-tokens", type=int, default=None,
                       help="activation-token cap (pairs x sites x batch) per batch")
    train.add_argument("--max-steps", "-M", type=int, default=None)
    train.add_argument("--no-improvement-stop", type=int, default=5)
    train.add_argument("--hard-loss-ceiling", type=float, default=3.0)
    train.add_argument("--loss", default="mae", choices=["mae", "l1", "mre", "mse"])
    train.add_argument("--seed", type=int, default=1337)
    train.add_argument("--grad-accum", type=int, default=1,
                       help="average gradients over N micro-batches per update")
    train.add_argument("--remat", action="store_true",
                       help="recompute each block in the backward (memory saver)")
    train.add_argument("--use-pallas", choices=["auto", "on", "off"], default="auto",
                       help="fused kernels forward and backward (auto: on for cuda "
                            "when dropout is 0 and --remat is off)")

    dist = p.add_argument_group("distribution")
    add_distributed_flags(dist)
    dist.add_argument("--shard-pairs", action="store_true",
                      help="shard the pair axis of the activations over the mesh's pair axis")

    log = p.add_argument_group("logging")
    log.add_argument("--output-dir", "-o", default=".")
    log.add_argument("--log-every", type=int, default=100)
    log.add_argument("--run-name", "-n", default=None)
    log.add_argument("--project-name", "-p", default="PHYLOFORMER_EXPERIMENTS")
    log.add_argument("--wandb", action="store_true",
                     help="also log metrics to wandb in offline mode")
    log.add_argument("--tensorboard", action="store_true",
                     help="also log metrics to TensorBoard event files")

    util = p.add_argument_group("utils")
    util.add_argument("--find-batch-size", action="store_true",
                      help="search the largest fitting batch size, print, exit")
    util.add_argument("--dry-run", action="store_true",
                      help="set up everything, run one step, print summary, exit")
    util.add_argument("--profile", action="store_true",
                      help="trace 10 train steps into <output-dir>/profile, then exit")
    util.add_argument("--debug-nans", action="store_true",
                      help="raise at the first non-finite loss or gradient")
    util.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                      help="cuda = the hand-written kernels on the card (default); "
                           "cpu = their plain PyTorch versions")
    return p


def identifier_from_args(args) -> str:
    """A run identifier that encodes the hyperparameters."""
    return (f"pf_b{args.nb_blocks}_h{args.nb_heads}_d{args.embed_dim}"
            f"_lr{args.learning_rate:g}_bs{args.batch_size}_{args.loss}_seed{args.seed}")


def load_base_model(path: str):
    """``(params, config or None)`` from a reference ``.ckpt``, an ``.npz``
    or a trainer directory of either package."""
    if str(path).endswith(".npz"):
        from ..io.checkpoint import load_params_npz

        return load_params_npz(path), None
    from ..io.ckpt_import import load_pretrained

    params, cfg, _ = load_pretrained(path)
    return params, cfg


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from ..device import resolve_device
    from ..parallel.mesh import init_distributed, shutdown_distributed

    device = (init_distributed(args.distributed_init, args.device) if args.distributed_init
              else resolve_device(args.device))
    try:
        return _run(args, device)
    finally:
        shutdown_distributed()


def _run(args, device) -> int:
    from ..models.params import PhyloformerConfig
    from ..parallel.mesh import make_mesh, world
    from .data import BucketedLoader, LoaderConfig, choose_data
    from .loop import FitConfig, fit
    from .trainer import TrainConfig

    mesh = None
    if world()[1] > 1 or args.mesh_pair > 1 or args.mesh_data is not None:
        mesh = make_mesh(args.mesh_data, args.mesh_pair)
    main = mesh is None or mesh.rank == 0
    say = print if main else (lambda *a, **k: None)
    if mesh is not None:
        say(f"mesh: {dict(mesh.shape)}")
    cfg = PhyloformerConfig(n_blocks=args.nb_blocks, n_heads=args.nb_heads,
                            embed_dim=args.embed_dim, dropout=args.dropout,
                            matmul_precision=args.matmul_precision)

    if args.packed_data:
        from .packed import PackedDataset, split

        train_data, val_data = split(PackedDataset(args.packed_data),
                                     args.packed_val_fraction, args.seed)
        say(f"packed train examples: {len(train_data)}"
              + (f", val examples: {len(val_data)}" if val_data is not None else ""))
    else:
        if not (args.train_trees and args.train_alignments):
            print("need --train-trees/--train-alignments or --packed-data", file=sys.stderr)
            return 1
        train_data, val_data = choose_data(args.train_trees, args.train_alignments,
                                           args.val_trees, args.val_alignments,
                                           args.train_regex, args.val_regex, seed=args.seed)
        if not train_data:
            print("no training pairs found", file=sys.stderr)
            return 1
        say(f"train examples: {len(train_data)}, val examples: {len(val_data)}")
    if not len(train_data):
        print("no training examples found", file=sys.stderr)
        return 1

    # The decay's horizon is counted in applied updates: micro-batches
    # divided by --grad-accum, as is --warmup-steps.
    steps_per_epoch = -(-len(train_data) // args.batch_size)
    total_steps = args.max_steps or steps_per_epoch * args.nb_epochs
    accum = max(1, args.grad_accum)
    total_steps = max(1, total_steps // accum)
    warmup_steps = max(1, args.warmup_steps // accum) if args.warmup_steps else 0
    if warmup_steps >= total_steps and main:
        print(f"warning: warmup ({warmup_steps} updates) >= schedule horizon "
              f"({total_steps} updates) — the LR never reaches --learning-rate "
              f"{args.learning_rate}; lower --warmup-steps or raise "
              "--nb-epochs/--max-steps", file=sys.stderr)

    if args.use_pallas == "auto":
        use_pallas = device.type == "cuda" and args.dropout == 0.0 and not args.remat
    else:
        use_pallas = args.use_pallas == "on"

    init_params = None
    if args.base_model:
        init_params, loaded_cfg = load_base_model(args.base_model)
        if loaded_cfg is not None and (loaded_cfg.n_blocks, loaded_cfg.n_heads,
                                       loaded_cfg.embed_dim) != (
                cfg.n_blocks, cfg.n_heads, cfg.embed_dim):
            say(f"warning: base model architecture {loaded_cfg} != CLI args; "
                "using the base model's", file=sys.stderr)
            cfg = dataclasses.replace(loaded_cfg, dropout=args.dropout)

    tcfg = TrainConfig(loss=args.loss, learning_rate=args.learning_rate,
                       warmup_steps=warmup_steps, total_steps=total_steps, remat=args.remat,
                       seed=args.seed, shard_pairs=args.shard_pairs, use_pallas=use_pallas,
                       grad_accum=args.grad_accum)

    nw = args.num_workers
    if nw is None:
        slurm_cpus = os.environ.get("SLURM_CPUS_PER_TASK")
        if slurm_cpus and slurm_cpus.isdigit():
            nw = max(1, int(slurm_cpus) - 1)
        else:
            nw = max(1, min(8, (os.cpu_count() or 2) - 1))
    lcfg = LoaderConfig(batch_size=args.batch_size, num_workers=nw, seed=args.seed,
                        max_batch_tokens=args.max_batch_tokens)
    if args.packed_data:
        from .packed import PackedBucketedLoader as Loader
    else:
        Loader = BucketedLoader
    train_loader = Loader(train_data, lcfg)
    val_loader = (Loader(val_data, dataclasses.replace(lcfg, shuffle=False))
                  if val_data else None)

    if args.debug_nans:
        from .profiling import enable_nan_checks

        enable_nan_checks()

    if args.find_batch_size:
        def report(bs, fits, error):
            say(f"find-batch-size: batch {bs} "
                + ("fits" if fits else f"does not fit: {error.splitlines()[0]}"),
                file=sys.stderr, flush=True)

        bs = find_batch_size(cfg, tcfg, device, mesh=mesh, report=report)
        say(json.dumps({"max_batch_size": bs}))
        return 0

    if args.profile:
        import itertools

        from .profiling import profile_n_steps
        from .trainer import create_train_state, dropout_generator, make_train_step

        state, tx = create_train_state(cfg, tcfg, params=init_params, device=device)
        step = make_train_step(cfg, tcfg, tx, mesh=mesh)
        log_dir = os.path.join(args.output_dir, "profile")
        if not main:  # each rank its own trace
            log_dir = os.path.join(log_dir, f"rank{mesh.rank}")
        # as many epochs as 10 steps take
        batches = itertools.chain.from_iterable(iter(train_loader) for _ in itertools.count())
        _, _, done = profile_n_steps(step, state, batches, n_steps=10, log_dir=log_dir,
                                     generator=dropout_generator(cfg, tcfg, device))
        say(json.dumps({"profile_dir": log_dir, "steps": done}))
        return 0

    fcfg = FitConfig(
        nb_epochs=args.nb_epochs if not args.dry_run else 1,
        max_steps=1 if args.dry_run else args.max_steps,
        check_val_every=args.check_val_every,
        log_every=args.log_every,
        hard_loss_ceiling=args.hard_loss_ceiling,
        no_improvement_stop=args.no_improvement_stop,
        output_dir=args.output_dir,
        run_name=args.run_name or identifier_from_args(args),
        use_wandb=args.wandb,
        use_tensorboard=args.tensorboard,
        project_name=args.project_name,
    )
    summary = fit(cfg, tcfg, fcfg, train_loader, val_loader, mesh=mesh,
                  init_params=init_params, resume=args.load_checkpoint or False, device=device)
    say(json.dumps({
        "steps": summary["steps"],
        "best_val_loss": summary["best_val_loss"],
        "stop_reason": summary["stop_reason"],
        "wall_time_s": round(summary["wall_time_s"], 2),
        "checkpoint_dir": summary["checkpoint_dir"],
        "device": str(device),
        "use_pallas": use_pallas,
        "mesh": None if mesh is None else dict(mesh.shape),
    }))
    return 0


# The forms in which a failed allocation reaches the finder's probe: the
# caching allocator's ``torch.OutOfMemoryError`` ("CUDA out of memory. Tried
# to allocate ..."); a CUDA call made outside the allocator raising "CUDA
# error: out of memory"; the kernel library's launch check on
# cudaErrorMemoryAllocation (``ops/kernels/_build.check``: "CUDA error 2 (out
# of memory)"); cuBLAS unable to allocate its handle on a full card ("CUDA
# error: CUBLAS_STATUS_ALLOC_FAILED when calling `cublasCreate(handle)`", seen
# on an H100); and on the CPU the default allocator's refusal.  Nothing else
# is a capacity failure: an illegal memory access, a bad launch
# configuration or a key named "memory_layout" surface, so that a kernel
# fault never shrinks the answer.
OOM_MARKERS = (
    "CUDA out of memory",
    "CUDA error: out of memory",
    "CUDA error 2 (out of memory)",
    "CUBLAS_STATUS_ALLOC_FAILED",
    "DefaultCPUAllocator: can't allocate memory",
)


def _is_oom_error(e: BaseException) -> bool:
    """A probe failure that means the batch does not fit in device memory."""
    import torch

    if isinstance(e, torch.OutOfMemoryError):  # torch.cuda.OutOfMemoryError
        return True
    msg = f"{type(e).__name__}: {e}"
    return any(m in msg for m in OOM_MARKERS)


def probe_batch(cfg, tcfg, device, bs: int, n: int = 50, L: int = 512, mesh=None) -> None:
    """One train step of a fresh model on ``bs`` random alignments of ``n``
    x ``L``; raises what the step raises.  On a ``data`` mesh the batch is
    padded to a multiple of the data axis, as the trainer pads it, and this
    rank steps on its rows alone: the data route computes a rank's rows with
    no collective before the gradient all-reduce, so a rank out of memory
    here leaves no other rank waiting."""
    import numpy as np

    from ..data.pairs import n_pairs
    from ..parallel.mesh import shard_batch
    from .trainer import (create_train_state, dropout_generator, make_train_step,
                          pad_batch_to_multiple)

    rng = np.random.default_rng(0)
    batch = {
        "codes": rng.integers(0, 22, (bs, n, L)).astype(np.int32),
        "dists": rng.uniform(0.1, 1, (bs, n_pairs(n))).astype(np.float32),
        "site_mask": np.ones((bs, L), bool),
        "seq_mask": np.ones((bs, n), bool),
    }
    if mesh is not None:
        batch = shard_batch(mesh, pad_batch_to_multiple(batch, mesh.data))
    state, tx = create_train_state(cfg, tcfg, device=device)
    step = make_train_step(cfg, tcfg, tx)
    _, logs = step(state, batch, dropout_generator(cfg, tcfg, device))
    float(logs["train_loss"])


# a probe's outcome, all-reduced (MIN) over the ranks
_FITS, _OOM, _FAULT = 1, 0, -1


def find_batch_size(cfg, tcfg, device, n=50, L=512, start=4, limit=4096, mesh=None,
                    report=None) -> int:
    """The largest batch size (within 1/8) whose train step fits, by
    doubling then bisection; anything but an out-of-memory error raises.

    After each probe nothing of its step stays referenced and the card's
    cache is emptied, so that the next probe does not read the last one's
    fragments as capacity.  ``mesh``: every rank of a ``data`` mesh calls
    this alike; each probe ends with one all-reduce of the ranks' outcomes
    (MIN of fits, out of memory, other fault), so every rank takes the same
    path and returns the same answer (a global batch size).  The sharded
    routes (``shard_pairs`` over a pair axis) are refused: their step
    all-reduces inside every block, where a rank that fails leaves the
    others waiting.  ``report(bs, fits, error)`` sees every probe."""
    import gc

    import torch

    from .trainer import route

    if mesh is not None and route(tcfg, mesh).startswith("sharded"):
        raise ValueError("--find-batch-size does not search over a pair-sharded mesh "
                         "(--shard-pairs with --mesh-pair > 1): a rank out of memory inside "
                         "a block's all-reduce would leave the others waiting")
    multi = mesh is not None and mesh.world > 1

    def try_bs(bs: int) -> bool:
        error = fault = None
        try:
            probe_batch(cfg, tcfg, device, bs, n, L, mesh if multi else None)
            outcome = _FITS
        except Exception as e:  # noqa: BLE001 — filtered below
            error = f"{type(e).__name__}: {e}"
            if _is_oom_error(e):
                outcome = _OOM
            else:
                outcome, fault = _FAULT, e
        # the failed step's frames went with the exception: free what they held
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        if multi:
            t = torch.tensor([outcome], dtype=torch.int64, device=mesh.device)
            torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MIN,
                                         group=mesh.world_group)
            agreed = int(t.item())
            if agreed != outcome:
                error = ("another rank's probe failed with a non-memory error"
                         if agreed == _FAULT else "another rank ran out of memory")
            outcome = agreed
        if report is not None:
            report(bs, outcome == _FITS, error)
        if outcome == _FAULT:
            raise RuntimeError(f"find_batch_size probe failed at batch={bs} with a "
                               f"non-memory error: {error}") from fault
        return outcome == _FITS

    good, bs = 0, start
    while bs <= limit and try_bs(bs):
        good = bs
        bs *= 2
    lo, hi = good, min(bs, limit)
    while hi - lo > max(1, lo // 8):
        mid = (lo + hi) // 2
        if try_bs(mid):
            lo = mid
        else:
            hi = mid
    return lo


if __name__ == "__main__":
    sys.exit(main())
