"""The repository's fine-tuning recipe through ``pf-train-torch``, against
the JAX package's ``pf-train``, on the CPU.

The recipe is the command line of ``tools/r5_chain2.sh`` ``run_leg``:
``--packed-data --packed-val-fraction 0.02 --loss mre --batch-size 8
--max-batch-tokens ... --matmul-precision default --base-model ...
--check-val-every ... --no-improvement-stop ... --output-dir ... --run-name
... --seed 90``, then ``pf-ckpt export`` of the run's checkpoint directory.
Both packages train on one packed corpus that ``pf-preprocess-torch``
wrote (its shards are the JAX package's bytes), each in a fresh interpreter
of its own (``torch_side_by_side``'s prelude, every case and side at
once), the port with ``--device cpu``: its eager route, JAX's XLA route,
both fp32 on the CPU.  A recorder
over each package's loader class notes every batch the CLI draws: its
bucket, its size and its examples (a hash of each row's codes).

Cases (``CASES``):
- ``full``: the recipe at full width from ``artifacts/pf_scratch_r5.ckpt``
  (6 blocks, 4 heads, d = 64) on 13 alignments of 8-10 tips x 50-64 sites,
  a token cap of two examples a batch, 8 steps over an epoch's end,
  validation every 2, then ``export``;
- ``mixed``: a 2-block, d = 16 model from one ``.npz`` on 30 alignments in
  four (n, L) buckets whose token cap gives batches of 8, 2, 4 and 1, two
  epochs with ``--max-steps 0`` (``--nb-epochs`` decides), validation every
  5 steps;
- ``stop``: the same model on ``full``'s corpus at a learning rate where the
  validation loss stops improving, ``--no-improvement-stop 2
  --check-val-every 2``: the early stop fires;
- ``dirs``: tree and alignment directories with ``-T``/``-A`` and the
  ``-r``/``-R`` filters, one loading thread, ``--dry-run``.

Equal to JAX's in every case: the split's indices, every batch (bucket,
size, examples, in order, over every epoch, the validation passes
included), the stop reason and step, the keys of ``<run>_metrics.jsonl``.
Within ``LOSS_TOL`` (the train-step bar against JAX, ``test_torch_train``)
for each step taken: every step's loss and every validation loss.  The bar
holds one step from equal parameters; each step starts from parameters
that the earlier steps' fp32 rounding moved, which Adam's normalised
update carries on (measured at most 1.4e-6 relative a step, 9.7e-6 at step
8 of ``full``).  Within ``PARAM_TOL`` (the same test's parameter bar): the
exported ``.ckpt``'s tensors but the q and k biases (see
:func:`test_export_is_jax_and_the_latest_step`), which also equal the
port's latest checkpoint bit for bit.

The finder (``--find-batch-size``, ``train/cli.py`` ``find_batch_size``):
the mirror of ``tests/test_clis.py``'s; a non-memory failure surfaces (as
``tests/test_errors.py``'s); a planted per-batch ``OutOfMemoryError`` gives
an answer within 1/8 below the planted limit, and each probe leaves nothing
referenced; two gloo ranks of a ``data`` mesh, one with a planted cap,
agree on one answer; the classifier reads the card's allocation failures
as out of memory and the other CUDA errors as not.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_model import PORT_THREAD_ENV, REPO
from test_torch_train import _write_corpus
from torch_rendezvous import Rendezvous
from torch_side_by_side import _EPILOGUE, _PRELUDE, ENV, SIDES, _wait

SCRATCH = REPO / "artifacts" / "pf_scratch_r5.ckpt"
LOSS_TOL = 1e-5  # relative: the train step's loss bar against JAX (test_torch_train)
PARAM_TOL = 2e-4  # max-abs: the train steps' parameter bar against JAX (test_torch_train)

RECIPE = ["--packed-val-fraction", "0.02", "--loss", "mre", "--batch-size", "8",
          "--matmul-precision", "default", "--learning-rate", "1e-4", "--seed", "90",
          "--hard-loss-ceiling", "1e6", "--log-every", "1"]
NARROW = ["--nb-blocks", "2", "--embed-dim", "16", "--nb-heads", "2"]
# name: (corpus, extra flags); $C is the corpus's packed directory, $W the narrow weights
CASES = {
    "full": ("small", RECIPE + ["--packed-data", "$C", "--base-model", str(SCRATCH),
                                "--max-batch-tokens", "12000", "--warmup-steps", "2",
                                "--max-steps", "8", "--check-val-every", "2",
                                "--no-improvement-stop", "100"]),
    "mixed": ("mixed", RECIPE + NARROW + [
        "--packed-data", "$C", "--packed-val-fraction", "0.1", "--base-model", "$W",
        "--max-batch-tokens", "50000", "--warmup-steps", "4",
        "--max-steps", "0", "--nb-epochs", "2", "--check-val-every", "5",
        "--no-improvement-stop", "100"]),
    "stop": ("small", RECIPE + NARROW + [
        "--packed-data", "$C", "--packed-val-fraction", "0.1", "--base-model", "$W",
        "--max-batch-tokens", "25000", "--learning-rate", "1e-2", "--warmup-steps", "1",
        "--max-steps", "60", "--check-val-every", "2", "--no-improvement-stop", "2"]),
}
# tips x sites of the corpora: "mixed" fills the (10, 128), (20, 128), (10, 256) and
# (20, 256) buckets, whose token cap of 50,000 allows 8, 2, 4 and 1 a batch
CORPORA = {
    "small": [(8 + k % 3, 50 + (7 * k) % 15) for k in range(13)],
    "mixed": ([(6 + k % 5, 40 + 7 * k) for k in range(12)]
              + [(12 + k % 8, 60 + 11 * k) for k in range(6)]
              + [(7 + k % 4, 140 + 13 * k) for k in range(8)]
              + [(13 + k % 7, 150 + 20 * k) for k in range(4)]),
}

_SIDE = r"""
import contextlib, hashlib, importlib, io, json, os
cli = importlib.import_module("$PKG.train.cli")
packed = importlib.import_module("$PKG.train.packed")
data = importlib.import_module("$PKG.train.data")
io_cli = importlib.import_module("$PKG.io.cli")
PORT = "$PKG".endswith("_torch")
JOBS = json.loads(str(IN["jobs"]))
record = []


def rows_of(batch):
    out = []
    for r in range(len(batch["codes"])):
        n, L = int(batch["seq_mask"][r].sum()), int(batch["site_mask"][r].sum())
        codes = np.ascontiguousarray(batch["codes"][r, :n, :L]).astype(np.int8)
        out.append(hashlib.sha1(codes.tobytes()).hexdigest()[:12] if n else "pad")
    return out


def recording(base):
    class Recorder(base):
        def __init__(self, items, cfg, *a, **k):
            if hasattr(items, "indices"):
                record.append(["split", "train" if cfg.shuffle else "val",
                               [int(i) for i in items.indices]])
            super().__init__(items, cfg, *a, **k)

        def __iter__(self):
            kind = "train" if self.cfg.shuffle else "val"
            record.append(["epoch", kind])
            for b in super().__iter__():
                record.append([kind, list(b["codes"].shape), rows_of(b)])
                yield b
    return Recorder


packed.PackedBucketedLoader = recording(packed.PackedBucketedLoader)
data.BucketedLoader = recording(data.BucketedLoader)
res = {}
for name, argv, export in JOBS:
    record.clear()
    out = os.path.join(os.path.dirname(sys.argv[2]), "$PKG", name)
    argv = [a.replace("$OUT", out) for a in argv] + (["--device", "cpu"] if PORT else [])
    so, se = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se):
        rc = cli.main(argv)
    job = {"rc": rc, "stdout": so.getvalue(), "stderr": se.getvalue()[-3000:],
           "record": list(record), "out": out}
    if export:
        src = os.path.join(out, "checkpoints_" + name)
        with contextlib.redirect_stderr(io.StringIO()):
            job["export_rc"] = io_cli.main(["export", src, os.path.join(out, name + ".ckpt")])
    res[name] = job
OUT["res"] = np.asarray(json.dumps(res))
"""


def _pack(corpus_dir, out_dir):
    r = subprocess.run([sys.executable, "-m", "phyloformer_tpu_torch.train.cli_preprocess",
                        "-t", str(corpus_dir / "trees"), "-a", str(corpus_dir / "alns"),
                        "-o", str(out_dir)], cwd=str(REPO), capture_output=True, text=True,
                       timeout=300, env={**os.environ, **PORT_THREAD_ENV})
    assert r.returncode == 0, r.stderr[-3000:]


def _narrow_weights(path):
    """2-block, d = 16 JAX-initialised weights with every leaf perturbed
    and the q/k biases moved off phi's exponential branch (where their
    gradient is fp32 residue that Adam would scale to +-lr), as .npz."""
    import jax

    from phyloformer_tpu.io.checkpoint import save_params_npz
    from phyloformer_tpu.models.params import PhyloformerConfig, init_params

    cfg = PhyloformerConfig(n_blocks=2, n_heads=2, embed_dim=16)
    rng = np.random.default_rng(19)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(0.0, 0.05, a.shape)).astype(np.float32),
        init_params(jax.random.PRNGKey(19), cfg))
    for ly in params["layers"]:
        for attn in ("row_attn", "col_attn"):
            for k in ("bq", "bk"):
                ly[attn][k] = ly[attn][k] + np.float32(2.0)
    save_params_npz(path, params)


@pytest.fixture(scope="module")
def recipe(tmp_path_factory):
    root = tmp_path_factory.mktemp("recipe")
    for name, specs in CORPORA.items():
        _write_corpus(root / name, 90 + len(specs), specs)
        _pack(root / name, root / name / "packed")
    _narrow_weights(root / "narrow.npz")
    # the directory case: the train and validation pairs chosen by regex
    dirs = ["-t", str(root / "mixed" / "trees"), "-a", str(root / "mixed" / "alns"),
            "-T", str(root / "small" / "trees"), "-A", str(root / "small" / "alns"),
            "-r", r"ex(0\d|1[0-5])\.fa", "-R", r"ex0[0-5]\.fa", "--num-workers", "1",
            "--base-model", str(root / "narrow.npz"), "--dry-run", "--batch-size", "4",
            "--warmup-steps", "1", "--hard-loss-ceiling", "1e6", "--log-every", "1"] + NARROW
    jobs = []
    for name, (corpus, flags) in CASES.items():
        argv = [a.replace("$C", str(root / corpus / "packed"))
                .replace("$W", str(root / "narrow.npz")) for a in flags]
        jobs.append([name, argv + ["--output-dir", "$OUT", "--run-name", name],
                     name == "full"])
    jobs.append(["dirs", dirs + ["--output-dir", "$OUT", "--run-name", "dirs"], False])
    # every case on both sides at once, a fresh interpreter each
    procs, res = {}, {"jax": {}, "port": {}}
    for job in jobs:
        work = root / "sides" / job[0]
        work.mkdir(parents=True)
        np.savez(work / "in.npz", jobs=np.asarray(json.dumps([job])))
        for side, pkg in SIDES.items():
            prog = (_PRELUDE + _SIDE + _EPILOGUE).replace("$PKG", pkg)
            procs[(side, job[0])] = subprocess.Popen(
                [sys.executable, "-c", prog, str(work / "in.npz"), str(work / f"{side}.npz")],
                cwd=str(REPO), env=ENV, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)
    for (side, name), p in procs.items():
        _wait({side: p}, 900)
        res[side].update(json.loads(str(np.load(root / "sides" / name / f"{side}.npz")["res"])))
    return root, res


def _metrics(job, name):
    with open(f"{job['out']}/{name}_metrics.jsonl") as fh:
        return [json.loads(line) for line in fh]


def _summary(job):
    return json.loads(job["stdout"].strip().splitlines()[-1])


@pytest.mark.parametrize("case", list(CASES) + ["dirs"])
def test_batches_and_split_are_jax(case, recipe):
    """The split's indices and every batch drawn (bucket, size, examples, in
    order, each epoch and each validation pass) are JAX's; each batch's size
    is the token cap's."""
    _, res = recipe
    jax_job, port_job = res["jax"][case], res["port"][case]
    assert jax_job["rc"] == 0 and port_job["rc"] == 0, (jax_job["stderr"], port_job["stderr"])
    assert port_job["record"] == jax_job["record"]
    batches = [r for r in port_job["record"] if r[0] in ("train", "val")]
    assert batches and all("pad" not in r[2] for r in batches)
    flags = dict(zip(CASES[case][1], CASES[case][1][1:])) if case in CASES else {}
    if "--max-batch-tokens" in flags:
        cap, bs = int(flags["--max-batch-tokens"]), int(flags["--batch-size"])
        for kind, (b, n, L), rows in batches:
            size = max(1, min(bs, cap // (n * (n - 1) // 2 * L)))
            # a full bucket holds the capped size; the epoch's last of a bucket fewer
            assert b <= size, (kind, b, n, L, size)
    stdout = port_job["stdout"].splitlines()[0]
    assert stdout == jax_job["stdout"].splitlines()[0], (stdout, jax_job["stdout"])


def test_token_cap_and_epochs_shape_the_mixed_run(recipe):
    """``mixed``: the four buckets take batches of 8, 2, 4 and 1 under the
    cap of 50,000 tokens; two epochs (``--max-steps 0``) draw every training
    example twice, in another order the second time."""
    _, res = recipe
    rec = res["port"]["mixed"]["record"]
    sizes = {}
    for kind, shape, rows in (r for r in rec if r[0] == "train"):
        sizes.setdefault(tuple(shape[1:]), set()).add(shape[0])
    assert {k: max(v) for k, v in sizes.items()} == {(10, 128): 8, (20, 128): 2,
                                                     (10, 256): 4, (20, 256): 1}, sizes
    epochs, cur = [], None
    for r in rec:
        if r == ["epoch", "train"]:
            cur = []
            epochs.append(cur)
        elif r[0] == "train":
            cur.extend(r[2])
    assert len(epochs) == 2 and sorted(epochs[0]) == sorted(epochs[1]) and epochs[0] != epochs[1]
    n_train = len(CORPORA["mixed"]) - int(len(CORPORA["mixed"]) * 0.1)
    assert len(epochs[0]) == n_train == len(set(epochs[0]))
    split = [r for r in rec if r[0] == "split"]
    assert [r[1] for r in split] == ["train", "val"]
    assert sorted(split[0][2] + split[1][2]) == list(range(len(CORPORA["mixed"])))


@pytest.mark.parametrize("case", list(CASES) + ["dirs"])
def test_losses_and_stops_are_jax(case, recipe):
    """Every step's loss and every validation metric within ``LOSS_TOL`` a
    step taken (the train-step bar holds for one step from equal
    parameters; each later step starts from parameters the earlier steps'
    fp32 rounding moved, and adds its own), at the same steps; the steps,
    the stop reason and the keys of ``<run>_metrics.jsonl`` equal JAX's."""
    _, res = recipe
    jax_job, port_job = res["jax"][case], res["port"][case]
    want, got = _metrics(jax_job, case), _metrics(port_job, case)
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for w, g in zip(want, got):
        for k in ("train_loss", "val_loss", "val_mae", "val_mre", "val_rmse"):
            if k in w:
                bar = LOSS_TOL * max(1, w["step"]) * abs(w[k])
                assert np.isfinite(g[k]) and abs(g[k] - w[k]) <= bar, (w["step"], k, g[k], w[k])
    s_want, s_got = _summary(jax_job), _summary(port_job)
    assert (s_got["steps"], s_got["stop_reason"]) == (s_want["steps"], s_want["stop_reason"])
    assert abs(s_got["best_val_loss"] - s_want["best_val_loss"]) <= (
        LOSS_TOL * s_want["steps"] * abs(s_want["best_val_loss"]))
    assert s_got["checkpoint_dir"].endswith(f"checkpoints_{case}")
    expected = {"full": "max_steps 8 reached", "mixed": "completed all epochs",
                "dirs": "max_steps 1 reached"}
    if case == "stop":
        assert s_got["stop_reason"].startswith("early stop: no val improvement"), s_got
        assert s_got["steps"] < 60
    else:
        assert s_got["stop_reason"] == expected[case], s_got
    if case == "mixed":
        batches = len([r for r in port_job["record"] if r[0] == "train"])
        assert s_got["steps"] == batches


def test_export_is_jax_and_the_latest_step(recipe):
    """``pf-ckpt-torch export`` of the ``full`` run's checkpoint directory:
    the port's latest step bit for bit; JAX's export of its own run within
    ``PARAM_TOL`` except on the q and k biases.  phi is exp on its negative
    branch, so a head whose q (or k) all lie there leaves the attention
    unchanged by a shift of its bias: the gradient there is fp32 residue,
    which Adam scales to an update of up to the learning rate in either
    direction; those elements lie within twice the learning rates summed."""
    import torch

    from phyloformer_tpu_torch.io.ckpt_import import load_pretrained

    _, res = recipe
    jax_job, port_job = res["jax"]["full"], res["port"]["full"]
    assert jax_job["export_rc"] == 0 and port_job["export_rc"] == 0
    got, _, _ = load_pretrained(f"{port_job['out']}/full.ckpt")
    want, _, _ = load_pretrained(f"{jax_job['out']}/full.ckpt")
    latest, cfg, _ = load_pretrained(f"{port_job['out']}/checkpoints_full")
    assert (cfg.n_blocks, cfg.n_heads, cfg.embed_dim) == (6, 4, 64)
    lr_sum = sum(r["learning_rate"] for r in _metrics(jax_job, "full") if "learning_rate" in r)

    def walk(g, w, l, path):
        if isinstance(g, dict):
            assert sorted(g) == sorted(w), path
            for k in g:
                walk(g[k], w[k], l[k], f"{path}/{k}")
        elif isinstance(g, (list, tuple)):
            for i, trio in enumerate(zip(g, w, l)):
                walk(*trio, f"{path}/{i}")
        else:
            assert torch.equal(g, l), path
            err = float((g - torch.as_tensor(w)).abs().max())
            bar = 2 * lr_sum if path.endswith(("/bq", "/bk")) else PARAM_TOL
            assert err <= bar, (path, err, bar)

    walk(got, want, latest, "")


# --- the batch-size finder -------------------------------------------------------

def _small():
    from phyloformer_tpu_torch.models.params import PhyloformerConfig
    from phyloformer_tpu_torch.train.trainer import TrainConfig

    return PhyloformerConfig(n_blocks=1, n_heads=2, embed_dim=16), TrainConfig(
        total_steps=10, warmup_steps=1)


def test_find_batch_size_function():
    """The mirror of ``tests/test_clis.py``'s: a bounded search on a small
    config, real steps on the CPU."""
    import torch

    from phyloformer_tpu_torch.train.cli import find_batch_size

    cfg, tcfg = _small()
    assert find_batch_size(cfg, tcfg, torch.device("cpu"), n=8, L=32, start=2, limit=4) >= 2


def test_find_batch_size_surfaces_non_oom_errors():
    """As ``tests/test_errors.py``'s: a failure that is not out of memory
    (an unknown loss) raises instead of reading as "does not fit"."""
    import dataclasses

    import torch

    from phyloformer_tpu_torch.train.cli import find_batch_size

    cfg, tcfg = _small()
    bad = dataclasses.replace(tcfg, loss="definitely-not-a-loss", total_steps=2)
    with pytest.raises(RuntimeError, match="non-memory"):
        find_batch_size(cfg, bad, torch.device("cpu"), n=6, L=8, start=1, limit=1)


PLANTED = """
import torch
from phyloformer_tpu_torch.train import trainer


def plant(cap, sink=None):
    '''A stand-in for make_train_step whose steps raise the caching
    allocator's error above ``cap`` rows, after taking a tensor that
    ``sink`` sees.'''
    def factory(cfg, tcfg, tx, mesh=None):
        def step(state, batch, generator=None):
            held = torch.empty(len(batch["codes"]), 64)
            if sink is not None:
                sink(held)
            if len(batch["codes"]) > cap:
                raise torch.OutOfMemoryError(
                    f"CUDA out of memory. Tried to allocate {len(batch['codes'])}.00 MiB.")
            return state, {"train_loss": torch.zeros(())}
        return step
    return factory
"""


@pytest.mark.parametrize("cap", [5, 37, 300])
def test_planted_oom_limit_is_found(cap, monkeypatch):
    """Steps that raise ``OutOfMemoryError`` above ``cap`` rows: the answer
    lies within 1/8 below ``cap``, every probe is reported, and nothing a
    failed step held stays referenced."""
    import weakref

    import torch

    from phyloformer_tpu_torch.train import cli, trainer

    held, probes = [], []
    scope = {}
    exec(PLANTED, scope)
    monkeypatch.setattr(trainer, "make_train_step",
                        scope["plant"](cap, lambda t: held.append(weakref.ref(t))))
    cfg, tcfg = _small()
    got = cli.find_batch_size(cfg, tcfg, torch.device("cpu"), n=6, L=8, start=4,
                              report=lambda bs, fits, err: probes.append((bs, fits, err)))
    assert cap - cap // 8 <= got <= cap, (got, probes)
    assert all(fits == (bs <= cap) for bs, fits, _ in probes), probes
    assert all(err is None if fits else err.startswith("OutOfMemoryError: CUDA out of memory")
               for _, fits, err in probes), probes
    assert len(held) == len(probes) and all(r() is None for r in held)


@pytest.mark.parametrize("msg, oom", [
    # the card's forms of a failed allocation
    ("OutOfMemoryError: CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has a total "
     "capacity of 79.19 GiB of which 1.10 GiB is free.", True),
    ("CUDA error: out of memory\nCUDA kernel errors might be asynchronously reported", True),
    ("CUDA error: CUBLAS_STATUS_ALLOC_FAILED when calling `cublasCreate(handle)`", True),
    ("pf_kernel_c: CUDA error 2 (out of memory)", True),
    ("[enforce fail at alloc_cpu.cpp:127] err == 0. DefaultCPUAllocator: can't allocate "
     "memory: you tried to allocate 400000000000000 bytes.", True),
    # faults that are not capacity: they surface
    ("CUDA error: an illegal memory access was encountered", False),
    ("pf_kernel_a: CUDA error 700 (an illegal memory access was encountered)", False),
    ("pf_kernel_b: CUDA error 9 (invalid configuration argument)", False),
    ("CUDA error: invalid configuration argument", False),
    ("CUDA error: too many resources requested for launch", False),
])
def test_oom_classifier(msg, oom):
    import torch

    from phyloformer_tpu_torch.train.cli import _is_oom_error

    assert _is_oom_error(RuntimeError(msg)) is oom
    if msg.startswith("OutOfMemoryError"):
        assert _is_oom_error(torch.OutOfMemoryError("reworded"))
        assert _is_oom_error(torch.cuda.OutOfMemoryError("reworded"))


def test_oom_classifier_refuses_memory_words():
    """A loose "memory" keyword would turn a fault into a smaller batch."""
    from phyloformer_tpu_torch.train.cli import _is_oom_error

    assert not _is_oom_error(KeyError("memory_layout"))
    assert not _is_oom_error(ValueError("shared memory exceeds the block's limit"))


_RANK = PLANTED + """
import json, sys
from phyloformer_tpu_torch.models.params import PhyloformerConfig
from phyloformer_tpu_torch.parallel.mesh import init_distributed, make_mesh, shutdown_distributed
from phyloformer_tpu_torch.train.cli import find_batch_size
from phyloformer_tpu_torch.train.trainer import TrainConfig
device = init_distributed("gloo", "cpu")
mesh = make_mesh()
rank = mesh.rank
# rank 1 alone runs out of memory above 19 rows
trainer.make_train_step = plant(19 if rank == 1 else 10 ** 6)
cfg = PhyloformerConfig(n_blocks=1, n_heads=2, embed_dim=16)
probes = []
bs = find_batch_size(cfg, TrainConfig(total_steps=10, warmup_steps=1), device, n=6, L=8,
                     mesh=mesh, report=lambda b, f, e: probes.append([b, f, e]))
try:  # the pair-sharded route is refused before any probe
    find_batch_size(cfg, TrainConfig(shard_pairs=True), device, n=6, L=8,
                    mesh=make_mesh(data=1, pair=2))
    refused = None
except ValueError as e:
    refused = str(e)
shutdown_distributed()
print(json.dumps({"rank": rank, "bs": bs, "probes": probes, "refused": refused}))
"""


def test_find_batch_size_over_a_data_mesh_agrees():
    """Two gloo ranks of a ``data`` mesh, rank 1 out of memory above 19 rows
    (a global batch above 38): both print the same answer within 1/8 below
    38, after the same probes, and neither hangs; ``--shard-pairs`` over a
    pair axis of 2 is refused."""
    with Rendezvous() as rdv:
        procs = [rdv.popen([sys.executable, "-c", _RANK], r, 2, cwd=str(REPO),
                           env={**os.environ, **PORT_THREAD_ENV},
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=180)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert outs[0]["bs"] == outs[1]["bs"]
    assert [p[:2] for p in outs[0]["probes"]] == [p[:2] for p in outs[1]["probes"]]
    assert 38 - 38 // 8 <= outs[0]["bs"] <= 38, outs
    for b, fits, err in outs[0]["probes"]:  # rank 0 fits everything itself
        assert fits == (-(-b // 2) <= 19), outs
        assert err == (None if fits else "another rank ran out of memory"), outs
    for b, fits, err in outs[1]["probes"]:
        assert fits or err.startswith("OutOfMemoryError: CUDA out of memory"), outs
    assert all("pair-sharded" in o["refused"] for o in outs), outs
