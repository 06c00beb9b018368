"""Checkpoint import: the port's ``load_pretrained`` (torch.load) gives the
same arrays and config as the JAX package's torch-free importer, for every
checkpoint in ``artifacts/``.  The port runs in a subprocess."""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
CKPTS = sorted((REPO / "artifacts").glob("*.ckpt"))


def flatten(tree, prefix=""):
    """Nested dict/list of arrays → {"a/b/0/c": array}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}{k}/"))
    return out


@pytest.fixture(scope="module")
def port_side(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("port_ckpt")
    code = f"""
import dataclasses, json, sys
import numpy as np
sys.path.insert(0, {str(REPO / "tests")!r})
from test_torch_ckpt import flatten
from phyloformer_tpu_torch.io.ckpt_import import load_pretrained
from phyloformer_tpu_torch.models.params import count_params, map_params
cfgs = {{}}
for i, path in enumerate({[str(p) for p in CKPTS]!r}):
    params, cfg, hp = load_pretrained(path)
    flat = flatten(map_params(lambda t: t.numpy(), params))
    np.savez({str(out_dir)!r} + f"/{{i}}.npz", **flat)
    cfgs[path] = {{"cfg": dataclasses.asdict(cfg), "hparams": hp,
                  "n_params": count_params(params)}}
print(json.dumps(cfgs))
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=str(REPO), timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return out_dir, json.loads(r.stdout.strip().splitlines()[-1])


def test_nine_checkpoints_present():
    assert len(CKPTS) == 9


@pytest.mark.parametrize("idx", range(len(CKPTS)), ids=[p.name for p in CKPTS])
def test_checkpoint_imports_equal(idx, port_side):
    import dataclasses

    from phyloformer_tpu.io.ckpt_import import load_pretrained

    out_dir, cfgs = port_side
    params, cfg, hp = load_pretrained(CKPTS[idx])
    want = flatten(params)
    got = dict(np.load(out_dir / f"{idx}.npz"))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    port = cfgs[str(CKPTS[idx])]
    assert port["cfg"] == dataclasses.asdict(cfg)
    assert port["hparams"] == dict(hp)
    assert port["n_params"] == sum(v.size for v in want.values())
    if CKPTS[idx].name == "pf_mre_r5.ckpt":
        assert port["n_params"] == 308_449  # the published 6-block, d=64 model
