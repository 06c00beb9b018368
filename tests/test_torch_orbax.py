"""The JAX trainer's Orbax directories read by the port, on the CPU.

A JAX subprocess trains a 2-block, d = 16 model for a few steps with the
JAX trainer (its XLA route) and saves the state with its
``CheckpointManager``: plain Adam, ``grad_accum = 2`` (``optax.MultiSteps``,
saved between two micro-batches so that its accumulator holds one) and
AdamW under global-norm clipping.  It exports the parameters with
``save_params_npz`` and the optimizer moments as arrays, then takes one more
step on a fixed batch.

- ``load_pretrained`` on each directory: every parameter bit-equal to JAX's
  ``.npz`` export, the config and the step JAX saved;
- the port's resume (``loop._restore`` + ``_load_into``, what
  ``pf-train-torch --load-checkpoint`` runs): Adam's moments, count and
  schedule position and MultiSteps' accumulator taken over bit-equal, then
  the same next step on the eager route: parameters within ``PARAM_TOL`` of
  max(1, max|ref|), Adam's moments within ``MOMENT_TOL`` of each leaf's
  max|ref|;
- a resume whose ``grad_accum`` differs from the JAX run's raises;
- ``pf-train-torch --load-checkpoint <JAX run dir>`` continues the run;
- without ``tensorstore`` the read raises a message that names it.
"""

import json

import numpy as np
import pytest

from test_torch_model import REPO, run_jax, run_port
from test_torch_train import _toy_batch, _write_corpus

PARAM_TOL = 1e-6  # of max(1, max|ref|)
MOMENT_TOL = 5.3e-5  # of each leaf's max|ref|, the gradient bar
# name: (grad_accum, micro-batches before the save, grad_clip, weight_decay)
CASES = {"adam": (1, 2, 0.0, 0.0), "accum2": (2, 3, 0.0, 0.0), "clip_adamw": (1, 2, 1.0, 1e-2)}
N_BLOCKS, D, H = 2, 16, 4


def _batches():
    return {"b0": _toy_batch(2, 7, 24, 1), "b1": _toy_batch(2, 7, 24, 2),
            "next": _toy_batch(2, 7, 24, 3)}


_JAX = f"""
import dataclasses, jax, jax.numpy as jnp, optax
from phyloformer_tpu.io.checkpoint import CheckpointManager, save_params_npz
from phyloformer_tpu.models.params import PhyloformerConfig, init_params
from phyloformer_tpu.train.trainer import TrainConfig, create_train_state, make_train_step
cfg = PhyloformerConfig(n_blocks={N_BLOCKS}, n_heads={H}, embed_dim={D},
                        matmul_precision="float32")
rng = np.random.default_rng(5)
base = jax.tree_util.tree_map(
    lambda a: (np.asarray(a) + rng.normal(0.0, 0.05, a.shape)).astype(np.float32),
    init_params(jax.random.PRNGKey(5), cfg))
# q/k biases off phi's exponential branch, where their gradient is fp32
# residue that Adam would scale to +-lr (as in test_torch_train's steps)
for ly in base["layers"]:
    for attn in ("row_attn", "col_attn"):
        for k in ("bq", "bk"):
            ly[attn][k] = ly[attn][k] + np.float32(2.0)
batch = lambda name: {{k: jnp.asarray(IN[name + "." + k])
                      for k in ("codes", "dists", "site_mask", "seq_mask")}}
def put(prefix, tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            put(prefix + "/" + k, v)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            put(prefix + "/" + str(i), v)
    else:
        OUT[prefix] = np.asarray(tree)
def adam_of(opt_state):
    found = []
    for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: isinstance(
            x, optax.ScaleByAdamState)):
        if isinstance(s, optax.ScaleByAdamState):
            found.append(s)
    assert len(found) == 1
    return found[0]
for case, (accum, before, clip, wd) in {CASES!r}.items():
    tcfg = TrainConfig(learning_rate=1e-4, warmup_steps=2, total_steps=50, grad_accum=accum,
                       grad_clip=clip, weight_decay=wd)
    state, tx = create_train_state(cfg, tcfg, params=jax.tree_util.tree_map(jnp.asarray, base))
    step = make_train_step(cfg, tcfg, tx)
    for i in range(before):
        state, _ = step(state, batch(("b0", "b1")[i % 2]), jax.random.PRNGKey(0))
    saved = jax.tree_util.tree_map(np.asarray, state)
    mgr = CheckpointManager(ROOT + "/" + case + "/checkpoints_run")
    mgr.save(int(saved["step"]), saved, metadata={{
        "step": int(saved["step"]), "val": {{}}, "config": dataclasses.asdict(cfg),
        "train_config": dataclasses.asdict(tcfg)}})
    mgr.close()
    save_params_npz(ROOT + "/" + case + ".npz", saved["params"])
    a = adam_of(saved["opt_state"])
    put(case + ".saved.mu", a.mu)
    put(case + ".saved.nu", a.nu)
    OUT[case + ".saved.count"] = np.asarray(a.count)
    if accum > 1:
        put(case + ".saved.acc", saved["opt_state"].acc_grads)
        OUT[case + ".saved.mini_step"] = np.asarray(saved["opt_state"].mini_step)
    state, logs = step(state, batch("next"), jax.random.PRNGKey(0))
    OUT[case + ".next.loss"] = logs["train_loss"]
    put(case + ".next.params", state["params"])
    a = adam_of(state["opt_state"])
    put(case + ".next.mu", a.mu)
    put(case + ".next.nu", a.nu)
"""

_PORT = f"""
import dataclasses, json
from phyloformer_tpu_torch.io.ckpt_import import load_pretrained
from phyloformer_tpu_torch.models.params import PhyloformerConfig
from phyloformer_tpu_torch.train.loop import _load_into, _restore
from phyloformer_tpu_torch.train.trainer import (TrainConfig, create_train_state,
                                                 make_train_step)
batch = lambda name: {{k: IN[name + "." + k] for k in ("codes", "dists", "site_mask", "seq_mask")}}
def put(prefix, tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            put(prefix + "/" + k, v)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            put(prefix + "/" + str(i), v)
    else:
        OUT[prefix] = tree.detach() if torch.is_tensor(tree) else np.asarray(tree)
for case, (accum, before, clip, wd) in {CASES!r}.items():
    run = ROOT + "/" + case + "/checkpoints_run"
    params, cfg, meta = load_pretrained(run)
    put(case + ".loaded", params)
    OUT[case + ".cfg"] = np.array(json.dumps(dataclasses.asdict(cfg), sort_keys=True))
    OUT[case + ".meta_step"] = meta["step"]
    tcfg = TrainConfig(learning_rate=1e-4, warmup_steps=2, total_steps=50, grad_accum=accum,
                       grad_clip=clip, weight_decay=wd)
    state, tx = create_train_state(cfg, tcfg, device="cpu")
    payload, step = _restore(run)
    _load_into(state, payload)
    OUT[case + ".step"] = state["step"]
    opt = tx.opt.state_dict()
    names = []
    def put_names(prefix, node):
        if isinstance(node, (dict, list)):
            for k, v in (node.items() if isinstance(node, dict) else enumerate(node)):
                put_names(prefix + "/" + str(k), v)
        else:
            names.append(prefix)
    put_names("", state["params"])
    OUT[case + ".names"] = np.array(names)
    for i, name in enumerate(names):
        # copies: the step updates the optimizer's tensors in place
        OUT[case + ".resumed.mu" + name] = opt["state"][i]["exp_avg"].clone()
        OUT[case + ".resumed.nu" + name] = opt["state"][i]["exp_avg_sq"].clone()
        if tx.acc is not None:
            OUT[case + ".resumed.acc" + name] = tx.acc[i].clone()
        OUT[case + ".resumed.count"] = float(opt["state"][i]["step"])
    OUT[case + ".resumed.mini_step"] = tx.mini_step
    OUT[case + ".resumed.epoch"] = tx.sched.last_epoch
    OUT[case + ".resumed.lr"] = tx.opt.param_groups[0]["lr"]
    state, logs = make_train_step(cfg, tcfg, tx)(state, batch("next"))
    OUT[case + ".next.loss"] = logs["train_loss"]
    put(case + ".next.params", state["params"])
    opt = tx.opt.state_dict()
    for i, name in enumerate(names):
        OUT[case + ".next.mu" + name] = opt["state"][i]["exp_avg"]
        OUT[case + ".next.nu" + name] = opt["state"][i]["exp_avg_sq"]
import sys
OUT["loaded_modules"] = np.array(sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "orbax", "optax", "flax", "phyloformer_tpu")) or [""])
# a resume with another grad_accum than the JAX run's
state, tx = create_train_state(cfg, TrainConfig(grad_accum=1), device="cpu")
try:
    _load_into(state, _restore(ROOT + "/accum2/checkpoints_run")[0])
    OUT["mismatch"] = np.array("resumed")
except ValueError as e:
    OUT["mismatch"] = np.array(str(e))
"""


@pytest.fixture(scope="module")
def orbax_case(tmp_path_factory):
    root = tmp_path_factory.mktemp("orbax")
    batches = {f"{k}.{n}": v for k, b in _batches().items() for n, v in b.items()}
    want = run_jax(f"ROOT = {str(root)!r}\n" + _JAX, batches, root / "jax")
    got = run_port(f"ROOT = {str(root)!r}\n" + _PORT, batches, root / "port")
    return root, want, got


@pytest.mark.parametrize("case", list(CASES))
def test_params_read_bit_equal_to_jax_npz(case, orbax_case):
    root, _, got = orbax_case
    npz = dict(np.load(root / f"{case}.npz"))
    assert len(npz) == 4 + N_BLOCKS * 26
    for k, v in npz.items():
        np.testing.assert_array_equal(got[f"{case}.loaded/{k}"], v, err_msg=k)
    cfg = json.loads(str(got[f"{case}.cfg"]))
    assert (cfg["n_blocks"], cfg["n_heads"], cfg["embed_dim"]) == (N_BLOCKS, H, D)
    assert int(got[f"{case}.meta_step"]) == CASES[case][1] == int(got[f"{case}.step"])


@pytest.mark.parametrize("case", list(CASES))
def test_optimizer_state_taken_over_bit_equal(case, orbax_case):
    """Adam's moments, its count (as ``step``), the schedule's position and
    the learning rate it gives, MultiSteps' accumulator and mini step."""
    _, want, got = orbax_case
    accum, before, _, _ = CASES[case]
    updates = before // accum
    names = [str(n) for n in got[f"{case}.names"]]
    assert len(names) == 4 + N_BLOCKS * 26
    for name in names:
        for m in ("mu", "nu") + (("acc",) if accum > 1 else ()):
            np.testing.assert_array_equal(got[f"{case}.resumed.{m}{name}"],
                                          want[f"{case}.saved.{m}{name}"], err_msg=m + name)
    assert float(got[f"{case}.resumed.count"]) == int(want[f"{case}.saved.count"]) == updates
    assert int(got[f"{case}.resumed.epoch"]) == updates
    lr = 1e-4 * min(1.0, updates / 2)  # the warmup of 2 updates
    assert float(got[f"{case}.resumed.lr"]) == pytest.approx(lr, rel=1e-12)
    if accum > 1:
        assert int(got[f"{case}.resumed.mini_step"]) == int(want[f"{case}.saved.mini_step"]) == 1


@pytest.mark.parametrize("case", list(CASES))
def test_resumed_step_matches_jax_next_step(case, orbax_case):
    _, want, got = orbax_case
    loss, ref = float(got[f"{case}.next.loss"]), float(want[f"{case}.next.loss"])
    assert abs(loss - ref) <= 1e-5 * abs(ref), (loss, ref)
    for name in (str(n) for n in got[f"{case}.names"]):
        r = want[f"{case}.next.params{name}"]
        err = np.abs(got[f"{case}.next.params{name}"] - r).max() / max(1.0, np.abs(r).max())
        assert err <= PARAM_TOL, (name, err)
        for m in ("mu", "nu"):
            r = want[f"{case}.next.{m}{name}"]
            err = np.abs(got[f"{case}.next.{m}{name}"] - r).max() / max(np.abs(r).max(), 1e-30)
            assert err <= MOMENT_TOL, (m, name, err)


def test_reading_loads_neither_jax_nor_orbax(orbax_case):
    _, _, got = orbax_case
    assert list(got["loaded_modules"]) == [""], got["loaded_modules"]


def test_resume_with_other_grad_accum_raises(orbax_case):
    _, _, got = orbax_case
    msg = str(got["mismatch"])
    assert "MultiSteps" in msg and "grad_accum=1" in msg, msg


def test_train_cli_resumes_a_jax_run_and_without_tensorstore_refuses(orbax_case, tmp_path):
    """``pf-train-torch --load-checkpoint <JAX run dir>`` continues from the
    JAX step to ``--max-steps``; with ``tensorstore`` hidden, the same
    command and ``load_pretrained`` raise naming it."""
    root, _, _ = orbax_case
    _write_corpus(tmp_path / "corpus", 43, [(6, 30), (5, 26), (7, 33), (6, 28)])
    run = str(root / "adam" / "checkpoints_run")
    out = run_port(f"""
import contextlib, io, sys
from phyloformer_tpu_torch.train import cli
args = ["-t", {str(tmp_path / "corpus" / "trees")!r}, "-a",
        {str(tmp_path / "corpus" / "alns")!r}, "--device", "cpu", "--batch-size", "2",
        "--nb-blocks", "{N_BLOCKS}", "--embed-dim", "{D}", "--nb-heads", "{H}",
        "--learning-rate", "1e-4", "--warmup-steps", "2", "--hard-loss-ceiling", "1e6",
        "--num-workers", "1", "--max-steps", "4", "--check-val-every", "4",
        "-o", {str(tmp_path / "out")!r}, "-n", "resumed", "--load-checkpoint", {run!r}]
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    OUT["rc"] = cli.main(args)
OUT["stdout"] = np.array(buf.getvalue())
sys.modules["tensorstore"] = None
from phyloformer_tpu_torch.io.ckpt_import import load_pretrained
msgs = []
for fn in (lambda: cli.main(args), lambda: load_pretrained({run!r})):
    try:
        fn()
        msgs.append("ran")
    except ImportError as e:
        msgs.append(str(e))
OUT["msgs"] = np.array(msgs)
""", {}, tmp_path / "port")
    assert int(out["rc"]) == 0
    stdout = str(out["stdout"])
    assert "resumed from step 2" in stdout, stdout
    assert json.loads(stdout.strip().splitlines()[-1])["steps"] == 4
    for msg in out["msgs"]:
        assert "tensorstore" in str(msg) and "pf-ckpt convert" in str(msg), msg


FIXTURE = REPO / "tests" / "fixtures" / "orbax_run"


def test_committed_fixture_reads_as_jax_restores_it(tmp_path):
    """``tests/fixtures/orbax_run`` (a 1-block, d = 8 state after one step,
    saved by the JAX trainer's ``CheckpointManager`` at step 1, with its
    ``save_params_npz`` export beside it; ``chip_smoke.py`` reads it where
    ``tensorstore`` is installed): JAX's manager restores the export's
    parameters, and the port reads them bit for bit, with the config."""
    want = run_jax(f"""
from phyloformer_tpu.io.checkpoint import CheckpointManager
state, step = CheckpointManager({str(FIXTURE)!r}).restore()
OUT["step"] = step
def put(prefix, tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            put(prefix + "/" + k, v)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            put(prefix + "/" + str(i), v)
    else:
        OUT[prefix] = np.asarray(tree)
put("params", state["params"])
""", {}, tmp_path / "jax")
    got = run_port(f"""
from phyloformer_tpu_torch.io.ckpt_import import load_pretrained
params, cfg, meta = load_pretrained({str(FIXTURE)!r})
OUT["step"], OUT["n_blocks"], OUT["embed_dim"] = meta["step"], cfg.n_blocks, cfg.embed_dim
def put(prefix, tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            put(prefix + "/" + k, v)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            put(prefix + "/" + str(i), v)
    else:
        OUT[prefix] = tree
put("params", params)
""", {}, tmp_path / "port")
    npz = dict(np.load(str(FIXTURE) + ".npz"))
    assert len(npz) == 4 + 26
    for k, v in npz.items():
        np.testing.assert_array_equal(want["params/" + k], v, err_msg=k)
        np.testing.assert_array_equal(got["params/" + k], v, err_msg=k)
    assert int(want["step"]) == int(got["step"]) == 1
    assert (int(got["n_blocks"]), int(got["embed_dim"])) == (1, 8)
