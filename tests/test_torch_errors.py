"""Malformed-input error paths of the port beside the JAX package's, on the CPU.

The items of ``tests/test_errors.py`` on the port's own functions and CLIs,
each run on both packages with the same inputs: the same exception and
message fragment from the loaders, the same exit code and message fragment
from the CLIs (each CLI a fresh interpreter of its package, the port's with
``--device cpu`` where it runs a model).  ``artifacts/pf_mre_r5.ckpt``
stands for the reference checkpoint on both sides.

``test_find_batch_size_surfaces_non_oom_errors`` and the classifier's
items are in ``tests/test_torch_recipe.py``.  ``test_errors.py``'s
``test_pallas_bwd_tile_env_validation`` has no counterpart: the port has no
``PF_PALLAS_BWD_PT_*`` tile variables (its backward kernels take their
tiles from their plans).
"""

import importlib
import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_model import PORT_THREAD_ENV, REPO

CKPT = REPO / "artifacts" / "pf_mre_r5.ckpt"
PKGS = {"jax": "phyloformer_tpu", "port": "phyloformer_tpu_torch"}


def _raises_alike(fn_path, args, exc, match):
    """``fn_path`` (``module:function`` under each package) raises ``exc``
    matching ``match`` on both packages, with the same message."""
    msgs = {}
    for side, pkg in PKGS.items():
        module, fn = fn_path.split(":")
        f = getattr(importlib.import_module(f"{pkg}.{module}"), fn)
        with pytest.raises(exc, match=match) as info:
            f(*args)
        msgs[side] = str(info.value)
    assert msgs["port"] == msgs["jax"], msgs


def test_ragged_fasta_names_lengths(tmp_path):
    p = tmp_path / "rag.fa"
    p.write_text(">A\nARND\n>B\nARN\n")
    _raises_alike("data.fasta:read_fasta", [p], ValueError, "lengths differ")


def test_truncated_fasta_empty_record(tmp_path):
    p = tmp_path / "t.fa"
    p.write_text(">A\nARND\n>B\n")
    _raises_alike("data.fasta:read_fasta", [p], ValueError, "lengths differ")


def test_invalid_residue_named(tmp_path):
    p = tmp_path / "bad.fa"
    p.write_text(">A\nAR1D\n>B\nARND\n")
    _raises_alike("data.fasta:read_fasta", [p], ValueError, "invalid residue")


def test_unbalanced_newick_position(tmp_path):
    p = tmp_path / "bad.nwk"
    p.write_text("((A:0.1,B:0.2):0.3,C:0.4;")
    _raises_alike("data.newick:read_newick", [p], Exception, "position")


def test_mismatched_taxa_named(tmp_path):
    t = tmp_path / "t.nwk"
    t.write_text("((A:0.1,B:0.2):0.1,(C:0.1,D:0.2):0.1);\n")
    a = tmp_path / "t.fa"
    a.write_text(">A\nARND\n>B\nARND\n>C\nARND\n>E\nARND\n")
    _raises_alike("train.data:load_example", [str(t), str(a)], Exception, "'E' not found")


def _clis(module, args, tmp_path, device=False):
    """``python -m <pkg>.<module> args`` on both packages at once (``$OUT``
    in an argument: the side's own directory); ``device``: the port's
    command also gets ``--device cpu``.  Returns {side: CompletedProcess-like
    (returncode, stdout, stderr)}."""
    procs = {}
    for side, pkg in PKGS.items():
        out = tmp_path / side
        out.mkdir(parents=True, exist_ok=True)
        argv = [str(a).replace("$OUT", str(out)) for a in args]
        if device and side == "port":
            argv += ["--device", "cpu"]
        env = {**os.environ, **PORT_THREAD_ENV, "JAX_PLATFORMS": "cpu"}
        procs[side] = subprocess.Popen([sys.executable, "-m", f"{pkg}.{module}"] + argv,
                                       cwd=str(REPO), env=env, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
    res = {}
    try:
        for side, p in procs.items():
            out, err = p.communicate(timeout=420)
            res[side] = subprocess.CompletedProcess(p.args, p.returncode, out, err)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return res


def _good_fasta(path, n=8, length=40):
    rng = np.random.default_rng(7)
    amino = np.array(list("ARNDCQEGHILKMFPSTWYV"))
    path.write_text("".join(f">T{i}\n{''.join(amino[rng.integers(0, 20, length)])}\n"
                            for i in range(n)))


def test_pf_infer_skips_bad_file_and_reports(tmp_path):
    """A directory with one unreadable MSA: the good file is still
    processed, the bad one named on stderr, exit code 1, on both."""
    msas = tmp_path / "msas"
    msas.mkdir()
    (msas / "bad_4_tips.fa").write_text(">A\nARND\n>B\nARN\n")
    _good_fasta(msas / "good_8_tips.fa")
    res = _clis("infer.cli", [CKPT, msas, "-o", "$OUT/out"], tmp_path, device=True)
    for side, r in res.items():
        assert r.returncode == 1, (side, r.stderr[-2000:])
        assert "bad_4_tips.fa" in r.stderr and "lengths differ" in r.stderr, (side, r.stderr)
        assert (tmp_path / side / "out" / "good_8_tips.phy").exists(), side
        assert not (tmp_path / side / "out" / "bad_4_tips.phy").exists(), side


def test_pf_infer_all_bad_dir(tmp_path):
    msas = tmp_path / "msas"
    msas.mkdir()
    (msas / "bad_4_tips.fa").write_text(">A\nARND\n>B\nARN\n")
    res = _clis("infer.cli", [CKPT, msas, "-o", "$OUT/out"], tmp_path, device=True)
    for side, r in res.items():
        assert r.returncode == 1, (side, r.stderr[-2000:])
        assert "no readable alignments" in r.stderr, (side, r.stderr)


def test_pf_tree_truncated_phylip(tmp_path):
    p = tmp_path / "bad.phy"
    p.write_text("3\nA 0 0.5\nB 0.5 0\n")
    res = _clis("trees.cli", ["fastme", "-i", p], tmp_path)
    for side, r in res.items():
        assert r.returncode != 0, side
        assert "truncated" in (r.stderr + r.stdout), (side, r.stderr[-2000:])
    assert res["port"].returncode == res["jax"].returncode


def test_pf_train_no_pairs(tmp_path):
    trees = tmp_path / "trees"
    alns = tmp_path / "msas"
    trees.mkdir(), alns.mkdir()
    (trees / "x_4_tips.nwk").write_text("((A:1,B:1):1,(C:1,D:1):1);\n")
    (alns / "y_4_tips.fa").write_text(">A\nAR\n>B\nAR\n>C\nAR\n>D\nAR\n")
    res = _clis("train.cli", ["-t", trees, "-a", alns, "--max-steps", 1, "-o", "$OUT/out"],
                tmp_path, device=True)
    for side, r in res.items():
        assert r.returncode != 0, side
        assert "pair" in (r.stderr + r.stdout).lower(), (side, r.stderr[-2000:])
    assert res["port"].returncode == res["jax"].returncode
