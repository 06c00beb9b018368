"""Dropout in the port's training against the JAX package's, on the CPU.

A JAX subprocess runs ``forward`` and the gradients of one masked MAE loss
with a fixed ``dropout_key`` on a 2-block, d = 16 model (ragged n and L, a
gapped MSA), and exports the keep masks that the key's splits draw at the
five sites (``jax.random.bernoulli`` on the keys ``_forward_impl`` and
``axial_block`` split).  The port, given those masks
(:class:`phyloformer_tpu_torch.models.phyloformer.Dropout`), matches the
distances within ``DIST_TOL`` on real pairs and the loss within
``LOSS_TOL`` relative, every gradient within ``GRAD_TOL`` of max(1,
max|ref|) (JAX's bars).  Then the port alone: its own draws keep a share
within 4 standard errors of ``keep``; a rate of 0 is bit-equal to no
dropout; ``remat`` gives the gradients of the plain backward bit for bit;
two gloo ranks at pair 2 take the step one process takes at the same seed
(loss ``LOSS_TOL``, gradients ``GRAD_TOL``); the fused routes raise JAX's
message; ``pf-train-torch --dropout`` trains on the eager route.
"""

import json

import numpy as np
import pytest

from test_torch_model import random_batch, real_pair_mask, run_jax, run_port
from test_torch_sharded import run_ranks
from test_torch_train import _write_corpus

DIST_TOL = 5e-5  # max-abs on real pairs, the fp32 forward bar
LOSS_TOL = 1e-5  # relative
GRAD_TOL = 5.3e-5  # of max(1, max|ref|), the gradient bar
RATE = 0.3
N_BLOCKS, D, H = 2, 16, 4
DIMS = [(10, 20), (6, 14), (8, 17)]  # real (n, L): ragged
PAD_N, PAD_L = 10, 20  # P = 45: the second of two pair shards holds a padding pair
SEED = 21


def _inputs():
    rng = np.random.default_rng(SEED)
    codes, site_mask, seq_mask = random_batch(SEED, DIMS, PAD_N, PAD_L, gap_frac=0.3)
    p = PAD_N * (PAD_N - 1) // 2
    dists = rng.uniform(0.05, 2.0, (len(DIMS), p)).astype(np.float32)
    return {"codes": codes, "site_mask": site_mask, "seq_mask": seq_mask, "dists": dists}


_JAX = f"""
import jax, jax.numpy as jnp
from phyloformer_tpu.models.params import PhyloformerConfig, init_params
from phyloformer_tpu.models.phyloformer import forward, pair_mask_from_seq_mask
from phyloformer_tpu.train.losses import get_loss
cfg = PhyloformerConfig(n_blocks={N_BLOCKS}, n_heads={H}, embed_dim={D}, dropout={RATE},
                        matmul_precision="float32")
rng = np.random.default_rng({SEED})
params = jax.tree_util.tree_map(
    lambda a: jnp.asarray((np.asarray(a) + rng.normal(0.0, 0.05, a.shape)).astype(np.float32)),
    init_params(jax.random.PRNGKey({SEED}), cfg))
codes, sm, qm = (jnp.asarray(IN[k]) for k in ("codes", "site_mask", "seq_mask"))
pm = pair_mask_from_seq_mask(qm, codes.shape[1])
key = jax.random.PRNGKey(42)
loss_fn = get_loss("mae")
with jax.default_matmul_precision("float32"):
    OUT["preds"] = forward(params, codes, cfg, sm, qm, dropout_key=key)
    OUT["preds_no_key"] = forward(params, codes, cfg, sm, qm)
    loss, grads = jax.value_and_grad(lambda p: loss_fn(
        forward(p, codes, cfg, sm, qm, dropout_key=key), jnp.asarray(IN["dists"]), pm))(params)
OUT["loss"] = loss
def put(prefix, tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            put(prefix + "/" + k, v)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            put(prefix + "/" + str(i), v)
    else:
        OUT[prefix] = np.asarray(tree)
put("params", params)
put("grads", grads)
# the masks _forward_impl's and axial_block's key splits draw
keep = 1.0 - {RATE}
b, n, l = codes.shape
p = n * (n - 1) // 2
keys = jax.random.split(key, {N_BLOCKS} + 1)
for i in range({N_BLOCKS}):
    ks = jax.random.split(keys[i], 4)
    for j, w in enumerate(({D}, {D}, 4 * {D}, {D})):
        OUT[f"mask/{{i}}/{{j}}"] = jax.random.bernoulli(ks[j], keep, (b, p, l, w))
OUT[f"mask/{N_BLOCKS}/0"] = jax.random.bernoulli(keys[-1], keep, (b, p, l, 1))
"""

_PORT_MODEL = f"""
from phyloformer_tpu_torch.models.params import PhyloformerConfig
from phyloformer_tpu_torch.models.phyloformer import (Dropout, forward,
                                                      pair_mask_from_seq_mask)
from phyloformer_tpu_torch.train.losses import get_term
from phyloformer_tpu_torch.train.trainer import param_leaves
cfg = PhyloformerConfig(n_blocks={N_BLOCKS}, n_heads={H}, embed_dim={D}, dropout={RATE})
codes, sm, qm, dists = t("codes"), t("site_mask"), t("seq_mask"), t("dists")
pm = pair_mask_from_seq_mask(qm, codes.shape[1])
"""


@pytest.fixture(scope="module")
def jax_case(tmp_path_factory):
    root = tmp_path_factory.mktemp("dropout")
    inputs = _inputs()
    want = run_jax(_JAX, inputs, root / "jax")
    masks = {k: v for k, v in want.items() if k.startswith("mask/")}
    params = {k: v for k, v in want.items() if k.startswith("params/")}
    got = run_port(_PORT_MODEL + f"""
masks = [[t(f"mask/{{i}}/{{j}}") for j in range(4 if i < {N_BLOCKS} else 1)]
         for i in range({N_BLOCKS} + 1)]
params = tree("params")
leaves = param_leaves(params)
for leaf in leaves:
    leaf.requires_grad_(True)
OUT["preds_no_key"] = forward(params, codes, cfg, sm, qm).detach()
for remat in (False, True):
    preds = forward(params, codes, cfg, sm, qm, remat=remat,
                    dropout=Dropout({RATE}, masks=masks))
    m = pm.to(preds.dtype)
    loss = (get_term("mae")(preds, dists) * m).sum() / m.sum()
    grads = torch.autograd.grad(loss, leaves)
    tag = "remat." if remat else ""
    OUT[tag + "preds"], OUT[tag + "loss"] = preds.detach(), loss.detach()
    for k, g in enumerate(grads):
        OUT[f"{{tag}}grad{{k}}"] = g
def names(prefix, node):
    if isinstance(node, dict):
        return [n for k, v in node.items() for n in names(prefix + "/" + k, v)]
    if isinstance(node, list):
        return [n for i, v in enumerate(node) for n in names(prefix + "/" + str(i), v)]
    return [prefix]
OUT["grad_names"] = np.array(names("grads", params))
""", {**inputs, **masks, **params}, root / "port")
    return inputs, want, got


def test_distances_match_jax_given_its_masks(jax_case):
    inputs, want, got = jax_case
    pm = real_pair_mask(inputs["seq_mask"])
    err = np.abs(got["preds"] - want["preds"])[pm].max()
    assert err <= DIST_TOL, err
    # the masks drop something: the distances move away from no dropout
    assert np.abs(want["preds"] - want["preds_no_key"])[pm].max() > 100 * DIST_TOL
    np.testing.assert_allclose(got["preds_no_key"][pm], want["preds_no_key"][pm], atol=DIST_TOL)


def test_loss_and_gradients_match_jax_given_its_masks(jax_case):
    _, want, got = jax_case
    loss, ref = float(got["loss"]), float(want["loss"])
    assert abs(loss - ref) <= LOSS_TOL * abs(ref), (loss, ref)
    names = [str(n) for n in got["grad_names"]]
    assert len(names) == 4 + N_BLOCKS * 26
    for k, name in enumerate(names):
        g, r = got[f"grad{k}"], want[name]
        assert g.shape == r.shape, name
        err = np.abs(g - r).max() / max(1.0, np.abs(r).max())
        assert err <= GRAD_TOL, (name, err)


def test_remat_gradients_equal_plain_under_dropout(jax_case):
    """The masks given or drawn, a block recomputed in the backward drops
    what its forward dropped: the same bits."""
    _, _, got = jax_case
    np.testing.assert_array_equal(got["remat.preds"], got["preds"])
    n = len(got["grad_names"])
    for k in range(n):
        np.testing.assert_array_equal(got[f"remat.grad{k}"], got[f"grad{k}"])


@pytest.fixture(scope="module")
def port_case(tmp_path_factory):
    """The port's own draws: keep share, rate 0, remat over drawn masks,
    the step's generator and the fused routes' refusals."""
    root = tmp_path_factory.mktemp("dropout_port")
    return run_port(_PORT_MODEL + f"""
from phyloformer_tpu_torch.models.params import init_params
from phyloformer_tpu_torch.train.trainer import (TrainConfig, create_train_state,
                                                 dropout_generator, make_eval_step,
                                                 make_train_step)
params = init_params(cfg, torch.Generator().manual_seed(3))
drawn = {{}}
seeds = Dropout.draw({RATE}, torch.Generator().manual_seed(5), {N_BLOCKS}).seeds
forward(params, codes, cfg, sm, qm, dropout=Dropout({RATE}, seeds=seeds, drawn=drawn))
kept = sum(int(m.sum()) for ms in drawn.values() for m in ms)
total = sum(m.numel() for ms in drawn.values() for m in ms)
OUT["kept"], OUT["total"] = kept, total
OUT["n_masks"] = [len(drawn[i]) for i in sorted(drawn)]
plain = forward(params, codes, cfg, sm, qm)
OUT["rate0_equal"] = torch.equal(plain, forward(params, codes, cfg, sm, qm,
                                                dropout=Dropout(0.0, seeds=[1, 2, 3])))
# train steps from one generator seed: remat or not, the same bits
batch = {{k: IN[k] for k in ("codes", "site_mask", "seq_mask", "dists")}}
for remat in (False, True):
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10, remat=remat, seed=9)
    state, tx = create_train_state(cfg, tcfg, params=params, device="cpu")
    grads = []
    update = tx.update
    tx.update = lambda g: (grads.append([x.clone() for x in g]), update(g))[1]
    step = make_train_step(cfg, tcfg, tx)
    gen = dropout_generator(cfg, tcfg, "cpu")
    for _ in range(2):
        state, logs = step(state, batch, gen)
        OUT[f"remat{{int(remat)}}.loss{{_}}"] = logs["train_loss"]
    for k, g in enumerate(grads[0] + grads[1]):
        OUT[f"remat{{int(remat)}}.g{{k}}"] = g
# a step without a generator drops nothing: the loss of the plain forward
state, tx = create_train_state(cfg, TrainConfig(), params=params, device="cpu")
OUT["no_gen_loss"] = make_train_step(cfg, TrainConfig(), tx)(state, batch)[1]["train_loss"]
m = pm.to(plain.dtype)
OUT["plain_loss"] = (get_term("mae")(plain, dists) * m).sum() / m.sum()
msgs = []
for make in (make_train_step, make_eval_step):
    try:
        make(cfg, TrainConfig(use_pallas=True), *([tx] if make is make_train_step else []))
        msgs.append("ran")
    except ValueError as e:
        msgs.append(str(e))
OUT["msgs"] = np.array(msgs)
""", _inputs(), root)


def test_keep_share_of_drawn_masks(port_case):
    got = port_case
    assert list(got["n_masks"]) == [4] * N_BLOCKS + [1]
    keep, n = 1.0 - RATE, int(got["total"])
    se = (keep * (1 - keep) / n) ** 0.5
    assert abs(int(got["kept"]) / n - keep) <= 4 * se, (int(got["kept"]) / n, keep, se)


def test_rate_zero_and_no_generator_drop_nothing(port_case):
    got = port_case
    assert bool(got["rate0_equal"])
    assert float(got["no_gen_loss"]) == pytest.approx(float(got["plain_loss"]), rel=1e-6)


def test_remat_steps_equal_plain_steps_under_dropout(port_case):
    """Two train steps from one generator seed: the losses and the
    gradients of the remat route are the plain route's bits (and the second
    step's masks are not the first's: its loss moves)."""
    got = port_case
    for k in range(2):
        assert float(got[f"remat1.loss{k}"]) == float(got[f"remat0.loss{k}"])
    keys = [k for k in got if k.startswith("remat0.g")]
    assert len(keys) == 2 * (4 + N_BLOCKS * 26)
    for k in keys:
        np.testing.assert_array_equal(got[k.replace("remat0", "remat1")], got[k])


def test_fused_routes_refuse_dropout(port_case):
    assert list(port_case["msgs"]) == ["use_pallas training requires dropout=0"] * 2


_RANK_STEP = f"""
from phyloformer_tpu_torch.models.params import PhyloformerConfig, init_params
from phyloformer_tpu_torch.train.trainer import (TrainConfig, create_train_state,
                                                 dropout_generator, make_train_step)
cfg = PhyloformerConfig(n_blocks={N_BLOCKS}, n_heads={H}, embed_dim={D}, dropout={RATE})
params = init_params(cfg, torch.Generator().manual_seed(3))
batch = {{k: IN[k] for k in ("codes", "site_mask", "seq_mask", "dists")}}
def run(tcfg, mesh):
    state, tx = create_train_state(cfg, tcfg, params=params, device="cpu")
    grads = []
    update = tx.update
    tx.update = lambda g: (grads.append([x.clone() for x in g]), update(g))[1]
    step = make_train_step(cfg, tcfg, tx, mesh=mesh)
    gen = dropout_generator(cfg, tcfg, "cpu")
    for k in range(2):
        state, logs = step(state, batch, gen)
        OUT[f"{{'one' if mesh is None else 'pair'}}.loss{{k}}"] = logs["train_loss"]
    for k, g in enumerate(grads[0] + grads[1]):
        OUT[f"{{'one' if mesh is None else 'pair'}}.g{{k}}"] = g
tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10, seed=9,
                   shard_pairs=True)
run(tcfg, make_mesh(1, 2))
run(tcfg, None)
try:
    make_train_step(cfg, TrainConfig(shard_pairs=True, use_pallas=True),
                    create_train_state(cfg, TrainConfig(), device="cpu")[1], mesh=make_mesh(1, 2))
    OUT["msg"] = np.array("ran")
except ValueError as e:
    OUT["msg"] = np.array(str(e))
"""


def test_pair_ranks_take_one_process_step(tmp_path):
    """Two gloo ranks at pair 2 (P = 45 pairs, 23 a rank) drop each its
    slice of one process's masks: two steps' losses and gradients are the
    one process's; the sharded fused route refuses dropout."""
    outs = run_ranks(_RANK_STEP, _inputs(), tmp_path, world=2)
    for o in outs:
        assert str(o["msg"]) == "use_pallas training requires dropout=0"
        for k in range(2):
            loss, ref = float(o[f"pair.loss{k}"]), float(o[f"one.loss{k}"])
            assert abs(loss - ref) <= LOSS_TOL * abs(ref), (k, loss, ref)
        keys = [k for k in o if k.startswith("one.g")]
        assert len(keys) == 2 * (4 + N_BLOCKS * 26)
        for k in keys:
            r = o[k]
            err = np.abs(o[k.replace("one", "pair")] - r).max() / max(1.0, np.abs(r).max())
            assert err <= GRAD_TOL, (k, err)
    for k in outs[0]:
        if k.startswith("pair."):
            np.testing.assert_array_equal(outs[0][k], outs[1][k])


def test_train_cli_trains_with_dropout_on_the_eager_route(tmp_path):
    """``pf-train-torch --device cpu --dropout 0.1`` runs 2 steps on the
    eager route (finite losses, a checkpoint); with ``--use-pallas on`` it
    raises JAX's message."""
    _write_corpus(tmp_path / "corpus", 41, [(6, 30), (5, 26), (7, 33), (6, 28)])
    out = run_port(f"""
import contextlib, io, json
from phyloformer_tpu_torch.train import cli
args = ["-t", {str(tmp_path / "corpus" / "trees")!r}, "-a",
        {str(tmp_path / "corpus" / "alns")!r}, "--device", "cpu", "--batch-size", "2",
        "--nb-blocks", "2", "--embed-dim", "16", "--dropout", "0.1", "--loss", "mre",
        "--hard-loss-ceiling", "1e6", "--num-workers", "1", "--max-steps", "2",
        "--check-val-every", "2", "--log-every", "1", "-o", {str(tmp_path / "out")!r},
        "-n", "drop"]
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    OUT["rc"] = cli.main(args)
OUT["summary"] = np.array(buf.getvalue().strip().splitlines()[-1])
try:
    cli.main(args + ["--use-pallas", "on"])
    OUT["pallas"] = np.array("ran")
except ValueError as e:
    OUT["pallas"] = np.array(str(e))
""", {}, tmp_path / "port")
    assert int(out["rc"]) == 0
    summary = json.loads(str(out["summary"]))
    assert summary["steps"] == 2 and summary["use_pallas"] is False, summary
    lines = (tmp_path / "out" / "drop_metrics.jsonl").read_text().splitlines()
    losses = [r["train_loss"] for r in map(json.loads, lines) if "train_loss" in r]
    assert len(losses) == 2 and all(np.isfinite(losses)), losses
    assert (tmp_path / "out" / "checkpoints_drop" / "ckpt_2.pt").is_file()
    assert str(out["pallas"]) == "use_pallas training requires dropout=0"
