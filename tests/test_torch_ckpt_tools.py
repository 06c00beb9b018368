"""The port's checkpoint lifecycle against the JAX package's, on the CPU.

- ``load_pretrained`` on an ``.npz``: the JAX package's file loads bit-equal
  in the port, and the port's (``pf-ckpt-torch convert``) in JAX.
- ``pf-ckpt-torch export`` of ``pf_mre_r5.ckpt`` (``torch.save``), with and
  without ``--no-seq2pair``, reads bit-equal in JAX's torch-free
  ``load_pretrained``; JAX's ``pf-ckpt export`` reads bit-equal in the port;
  the exported state dict has the reference's keys, layouts and buffer.
- ``pf-ckpt-torch inspect`` prints the same JSON as JAX's ``pf-ckpt
  inspect``, on a ``.ckpt`` and on an ``.npz``.
- A directory written by ``pf-train-torch --device cpu`` (2 steps) loads
  with its config and step, and ``pf-infer-torch`` runs on it, its PHYLIP
  values those of an engine on the same restored parameters; a JAX Orbax
  directory reads bit-equal to the checkpoint it was saved from, and where
  ``tensorstore`` is missing it is refused with a message that names it.

Bit-equal means ``np.testing.assert_array_equal`` on every parameter, and
fp32 throughout.  JAX and the port run in subprocesses of their own and
exchange files.
"""

import json

import numpy as np
import pytest

from test_torch_model import CKPT, run_jax, run_port
from test_torch_train import _write_corpus

_FLATTEN = """
def flat(tree, prefix):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        a = np.asarray(tree.numpy() if hasattr(tree, "numpy") else tree)
        OUT[prefix] = a
        return
    for k, v in items:
        flat(v, f"{prefix}/{k}")
"""


@pytest.fixture(scope="module")
def ckpt_case(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt_tools")
    _write_corpus(root / "corpus", 31, [(6, 30), (5, 26), (7, 33), (6, 28), (4, 20), (6, 31)])
    jax_first = run_jax(_FLATTEN + f"""
import contextlib, dataclasses, io
from phyloformer_tpu.io import cli
from phyloformer_tpu.io.checkpoint import CheckpointManager, save_params_npz
from phyloformer_tpu.io.ckpt_import import load_pretrained
root = {str(root)!r}
params, cfg, _ = load_pretrained({str(CKPT)!r})
flat(params, "ref")
save_params_npz(root + "/jax.npz", params)
for args in (["export", {str(CKPT)!r}, root + "/jax_export.ckpt"],):
    assert cli.main(args) == 0
for name, path in (("ckpt", {str(CKPT)!r}), ("npz", root + "/jax.npz")):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["inspect", path]) == 0
    OUT["inspect." + name] = np.asarray(buf.getvalue())
mgr = CheckpointManager(root + "/orbax")
mgr.save(1, {{"params": params}}, metadata={{"config": dataclasses.asdict(cfg)}})
mgr.close()
""", {}, root / "jax1")
    port = run_port(_FLATTEN + f"""
import contextlib, dataclasses, io, json, os
from phyloformer_tpu_torch.data.fasta import read_fasta
from phyloformer_tpu_torch.data.phylip import read_phylip
from phyloformer_tpu_torch.infer import cli as infer_cli
from phyloformer_tpu_torch.infer.engine import InferenceEngine
from phyloformer_tpu_torch.io import cli
from phyloformer_tpu_torch.io.ckpt_import import load_pretrained
from phyloformer_tpu_torch.train import cli as train_cli
root = {str(root)!r}
params, _, _ = load_pretrained(root + "/jax.npz")
flat(params, "from_jax_npz")
params, _, _ = load_pretrained(root + "/jax_export.ckpt")
flat(params, "from_jax_export")
for args in (["export", {str(CKPT)!r}, root + "/port_export.ckpt"],
             ["export", {str(CKPT)!r}, root + "/port_export_nos2p.ckpt", "--no-seq2pair"],
             ["convert", {str(CKPT)!r}, root + "/port.npz"]):
    assert cli.main(args) == 0
for name in ("port_export", "port_export_nos2p"):
    sd = torch.load(root + f"/{{name}}.ckpt", weights_only=True)
    OUT[name + ".keys"] = np.asarray(json.dumps(sorted(sd["state_dict"])))
    OUT[name + ".hp"] = np.asarray(json.dumps(sd["hyper_parameters"], sort_keys=True))
    for k, v in sd["state_dict"].items():
        OUT[name + ".sd/" + k] = v.numpy()
for name, path in (("ckpt", {str(CKPT)!r}), ("npz", root + "/port.npz")):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["inspect", path]) == 0
    OUT["inspect." + name] = np.asarray(buf.getvalue())
import sys
flat(load_pretrained(root + "/orbax")[0], "from_orbax")
sys.modules["tensorstore"] = None  # as on a machine without it
try:
    load_pretrained(root + "/orbax")
    OUT["orbax"] = np.asarray("loaded")
except ImportError as e:
    OUT["orbax"] = np.asarray(str(e))
del sys.modules["tensorstore"]
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    rc = train_cli.main(["-t", root + "/corpus/trees", "-a", root + "/corpus/alns",
                         "--device", "cpu", "--batch-size", "2", "--nb-blocks", "2",
                         "--loss", "mre", "--warmup-steps", "1", "--learning-rate", "1e-3",
                         "--hard-loss-ceiling", "1e6", "--num-workers", "1",
                         "--max-steps", "2", "--check-val-every", "2", "-o", root + "/train",
                         "-n", "run"])
assert rc == 0
trained, tcfg, meta = load_pretrained(root + "/train/checkpoints_run")
OUT["trained.cfg"] = np.asarray(json.dumps(dataclasses.asdict(tcfg)))
OUT["trained.meta"] = np.asarray(json.dumps({{"step": meta["step"], "keys": sorted(meta)}}))
flat(trained, "trained")
rc = infer_cli.main([root + "/train/checkpoints_run", root + "/corpus/alns", "-o",
                     root + "/infer", "--device", "cpu"])
OUT["infer.rc"] = np.asarray(rc)
stems = sorted(f[:-3] for f in os.listdir(root + "/corpus/alns"))
alns = [read_fasta(root + f"/corpus/alns/{{s}}.fa") for s in stems]
for s, a, vec in zip(stems, alns, InferenceEngine(trained, tcfg, device="cpu").predict(alns)):
    dm, ids = read_phylip(root + f"/infer/{{s}}.phy")
    i, j = np.triu_indices(len(ids), 1)
    OUT["infer.phy/" + s] = dm[i, j]
    OUT["infer.engine/" + s] = vec
    OUT["infer.ids_match/" + s] = np.asarray(ids == a.ids)
""", {}, root / "port")
    jax_second = run_jax(_FLATTEN + f"""
from phyloformer_tpu.io.ckpt_import import load_pretrained
root = {str(root)!r}
for name, path in (("port_export", "/port_export.ckpt"),
                   ("port_export_nos2p", "/port_export_nos2p.ckpt"), ("port_npz", "/port.npz")):
    params, cfg, _ = load_pretrained(root + path)
    flat(params, name)
    OUT[name + ".cfg"] = np.asarray([cfg.n_blocks, cfg.n_heads, cfg.embed_dim])
""", {}, root / "jax2")
    return root, jax_first, port, jax_second


def _tree(out, prefix):
    return {k[len(prefix) + 1:]: v for k, v in out.items() if k.startswith(prefix + "/")}


def _assert_bit_equal(got, want):
    assert sorted(got) == sorted(want) and len(want) == 160
    for k in want:
        assert got[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_jax_npz_loads_bit_equal_in_port(ckpt_case):
    _, jax1, port, _ = ckpt_case
    _assert_bit_equal(_tree(port, "from_jax_npz"), _tree(jax1, "ref"))


def test_port_npz_loads_bit_equal_in_jax(ckpt_case):
    _, jax1, _, jax2 = ckpt_case
    _assert_bit_equal(_tree(jax2, "port_npz"), _tree(jax1, "ref"))
    assert jax2["port_npz.cfg"].tolist() == [6, 4, 64]


@pytest.mark.parametrize("name", ["port_export", "port_export_nos2p"])
def test_port_export_reads_bit_equal_in_jax(name, ckpt_case):
    """``torch.save`` output through JAX's torch-free reader, and the
    reference's schema: 160 learnable keys, ``model.seq2pair`` unless
    ``--no-seq2pair``, Conv 1x1 weights ``(out, in, 1, 1)``."""
    _, jax1, port, jax2 = ckpt_case
    _assert_bit_equal(_tree(jax2, name), _tree(jax1, "ref"))
    keys = json.loads(str(port[name + ".keys"]))
    assert len(keys) == (161 if name == "port_export" else 160)
    assert ("model.seq2pair" in keys) == (name == "port_export")
    sd = _tree(port, name + ".sd")
    assert sd["model.embedding_block.0.weight"].shape == (64, 22, 1, 1)
    assert sd["model.attention_blocks.0.ffn.0.weight"].shape == (256, 64, 1, 1)
    assert sd["model.pwFNN.0.weight"].shape == (1, 64, 1, 1)
    assert sd["model.attention_blocks.5.row_attention.q_proj.weight"].shape == (4, 64)
    if name == "port_export":
        s2p = sd["model.seq2pair"]
        assert s2p.shape == (1225, 50) and (s2p.sum(axis=1) == 2).all()
    assert json.loads(str(port[name + ".hp"])) == {
        "dropout": 0.0, "embed_dim": 64, "h_dim": 64, "n_blocks": 6, "n_heads": 4,
        "nb_blocks": 6, "nb_heads": 4}


def test_jax_export_reads_bit_equal_in_port(ckpt_case):
    _, jax1, port, _ = ckpt_case
    _assert_bit_equal(_tree(port, "from_jax_export"), _tree(jax1, "ref"))


@pytest.mark.parametrize("kind", ["ckpt", "npz"])
def test_inspect_prints_same_json_as_jax(kind, ckpt_case):
    _, jax1, port, _ = ckpt_case
    got, want = str(port["inspect." + kind]), str(jax1["inspect." + kind])
    assert json.loads(got) == json.loads(want)
    assert got == want


def test_trainer_directory_loads_with_config_and_step(ckpt_case):
    _, _, port, _ = ckpt_case
    cfg = json.loads(str(port["trained.cfg"]))
    assert (cfg["n_blocks"], cfg["n_heads"], cfg["embed_dim"]) == (2, 4, 64)
    meta = json.loads(str(port["trained.meta"]))
    assert meta["step"] == 2
    assert {"config", "step", "train_config", "val"} <= set(meta["keys"])
    trained = _tree(port, "trained")
    assert len(trained) == 2 + 2 + 2 * 26 and all(np.isfinite(v).all() for v in trained.values())


def test_infer_cli_reads_trainer_directory(ckpt_case):
    """pf-infer-torch on the trainer's directory: the PHYLIP values are the
    engine's on the restored parameters (10 decimals)."""
    _, _, port, _ = ckpt_case
    assert int(port["infer.rc"]) == 0
    stems = [k.split("/", 1)[1] for k in port if k.startswith("infer.phy/")]
    assert len(stems) == 6
    for s in stems:
        assert bool(port["infer.ids_match/" + s])
        np.testing.assert_allclose(port["infer.phy/" + s], port["infer.engine/" + s],
                                   rtol=0, atol=1e-9)


def test_orbax_directory_refused(ckpt_case):
    """Without ``tensorstore`` an Orbax directory is refused, naming it and
    the conversion that reads it without; with it, the directory's
    parameters are the checkpoint's, bit for bit."""
    _, jax_first, port, _ = ckpt_case
    msg = str(port["orbax"])
    assert "Orbax" in msg and "tensorstore" in msg and "pf-ckpt convert" in msg, msg
    ref = {k[len("ref"):]: v for k, v in jax_first.items() if k.startswith("ref/")}
    assert len(ref) == 161 - 1
    for k, v in ref.items():
        np.testing.assert_array_equal(port["from_orbax" + k], v, err_msg=k)


def test_trainer_directory_without_config_refused(tmp_path):
    """A ``ckpt_<step>.pt`` without ``metadata["config"]`` is refused, not
    read off the parameters' shapes."""
    bare = str(tmp_path / "bare")
    out = run_port(f"""
from phyloformer_tpu_torch.io.checkpoint import CheckpointManager
from phyloformer_tpu_torch.io.ckpt_import import load_pretrained
CheckpointManager({bare!r}).save(3, {{"params": {{"w": torch.zeros(2)}}, "step": 3}}, metadata={{}})
try:
    load_pretrained({bare!r})
    OUT["msg"] = np.asarray("")
except ValueError as e:
    OUT["msg"] = np.asarray(str(e))
""", {}, tmp_path / "port")
    assert "step 3 has no metadata['config']" in str(out["msg"]), str(out["msg"])
