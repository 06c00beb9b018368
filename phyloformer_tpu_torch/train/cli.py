"""Training CLI (PyTorch/CUDA) — the flags of the JAX package's ``pf-train``.

    pf-train-torch -t trees/ -a msas/ [-T val_trees/ -A val_msas/] \\
        [--batch-size 4] [--learning-rate 1e-4] [--warmup-steps 5000] ...
    pf-train-torch --packed-data packed/ [--packed-val-fraction 0.1] ...
    python -m phyloformer_tpu_torch.train.cli ...

Runs on the card unless ``--device cpu`` is given.  ``--use-pallas auto``
runs the fused kernels forward and backward on ``cuda`` when dropout is 0
and ``--remat`` is off, at any alignment length.  ``--base-model`` takes a
reference ``.ckpt`` or an ``.npz`` parameter file; ``--load-checkpoint``
resumes from the latest checkpoint of a directory
(``<output-dir>/checkpoints_<run-name>``).  ``--packed-data`` reads shards
written by ``pf-preprocess-torch`` (or the JAX package's ``pf-preprocess``);
``--profile`` traces 10 steps into ``<output-dir>/profile`` and exits;
``--debug-nans`` stops at the first non-finite loss or gradient.
``--matmul-precision tensorfloat32`` or ``default`` trains at reduced
precision: the kernels' products, forward and backward, in one TF32 pass
(the plain versions round their operands the same way on ``--device
cpu``), the eager route's in TF32.  Not yet ported, and refused: dropout
> 0.

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
                       help="checkpoint directory to resume training from")
    start.add_argument("--base-model", "-m", default=None,
                       help="checkpoint to fine-tune from (.ckpt torch zip or .npz)")

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


def _refuse_unported(args) -> None:
    if args.dropout != 0.0:
        raise ValueError(f"--dropout {args.dropout} is not yet ported, see ROADMAP.md")


def load_base_model(path: str):
    """``(params, config or None)`` from a reference ``.ckpt`` or an ``.npz``."""
    if str(path).endswith(".npz"):
        from ..io.checkpoint import load_params_npz

        return load_params_npz(path), None
    from ..io.ckpt_import import load_pretrained

    params, cfg, _ = load_pretrained(path)
    return params, cfg


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _refuse_unported(args)

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
        if mesh is not None:
            # a rank out of memory would leave the others in a collective
            raise ValueError("--find-batch-size searches on one card; run it without a mesh")
        print(json.dumps({"max_batch_size": find_batch_size(cfg, tcfg, device)}))
        return 0

    if args.profile:
        import itertools

        from .profiling import profile_n_steps
        from .trainer import create_train_state, make_train_step

        state, tx = create_train_state(cfg, tcfg, params=init_params, device=device)
        step = make_train_step(cfg, tcfg, tx, mesh=mesh)
        log_dir = os.path.join(args.output_dir, "profile")
        if not main:  # each rank its own trace
            log_dir = os.path.join(log_dir, f"rank{mesh.rank}")
        # as many epochs as 10 steps take
        batches = itertools.chain.from_iterable(iter(train_loader) for _ in itertools.count())
        _, _, done = profile_n_steps(step, state, batches, n_steps=10, log_dir=log_dir)
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


def _is_oom_error(e: BaseException) -> bool:
    """A probe failure that means the batch does not fit in device memory."""
    import torch

    if isinstance(e, torch.cuda.OutOfMemoryError):
        return True
    msg = f"{type(e).__name__}: {e}"
    return any(m in msg for m in ("out of memory", "Out of memory", "CUDA error: out of memory"))


def find_batch_size(cfg, tcfg, device, n=50, L=512, start=4, limit=4096) -> int:
    """The largest batch size (within 1/8) whose train step fits, by
    doubling then bisection; anything but an out-of-memory error raises."""
    import numpy as np
    import torch

    from ..data.pairs import n_pairs
    from .trainer import create_train_state, make_train_step

    def try_bs(bs: int) -> bool:
        try:
            state, tx = create_train_state(cfg, tcfg, device=device)
            step = make_train_step(cfg, tcfg, tx)
            rng = np.random.default_rng(0)
            batch = {
                "codes": rng.integers(0, 22, (bs, n, L)).astype(np.int32),
                "dists": rng.uniform(0.1, 1, (bs, n_pairs(n))).astype(np.float32),
                "site_mask": np.ones((bs, L), bool),
                "seq_mask": np.ones((bs, n), bool),
            }
            _, logs = step(state, batch)
            float(logs["train_loss"])
            return True
        except Exception as e:  # noqa: BLE001 — filtered below
            if _is_oom_error(e):
                return False
            raise RuntimeError(f"find_batch_size probe failed at batch={bs} with a "
                               f"non-memory error: {type(e).__name__}: {e}") from e
        finally:
            if device.type == "cuda":
                torch.cuda.empty_cache()

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
