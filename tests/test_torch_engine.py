"""The port's inference engine and ``pf-infer`` CLI against the JAX engine on
the fused pipeline (``InferenceConfig(use_pallas=True)``, interpret mode on
the CPU), with the real ``pf_mre_r5`` checkpoint on ragged FASTA files.

Tolerances: predictions 5e-5 max-abs (fp32 sums in another order after six
blocks); the values parsed from the 10-decimal ``.phy`` files 1e-4, since two
fp32 programs that sum in different orders cannot promise identical bytes.
The port runs with ``device="cpu"`` in a subprocess
(:func:`test_torch_model.run_port`), the JAX engine in another
(:func:`test_torch_model.run_jax`), each with its CPU thread counts pinned:
these distances (up to ~13) move by 1–2e-5 for a 1e-7 relative change of the
embedding, so a sum order that followed the machine's load could cost the
5e-5 bar.
"""

import json

import numpy as np
import pytest

from test_torch_model import CKPT, run_jax, run_port

# (n, L, gap fraction): ragged, all in the engine's (10, 128) bucket
ALIGNMENTS = {"a": (7, 30, 0.0), "b": (10, 57, 0.0), "c": (5, 20, 0.0), "gapped": (8, 41, 0.35)}
AMINO = "ARNDCQEGHILKMFPSTWYV"


def _write_fasta(path, rng, n, l, gap):
    with open(path, "w") as fh:
        for r in range(n):
            seq = np.array(list(AMINO))[rng.integers(0, 20, l)]
            seq[rng.random(l) < gap] = "-"
            fh.write(f">seq_{path.stem}_{r}\n{''.join(seq)}\n")


@pytest.fixture(scope="module")
def engine_case(tmp_path_factory):
    from phyloformer_tpu.data.fasta import read_fasta

    root = tmp_path_factory.mktemp("engine")
    aln_dir = root / "alns"
    aln_dir.mkdir()
    rng = np.random.default_rng(61)
    for stem, (n, l, gap) in ALIGNMENTS.items():
        _write_fasta(aln_dir / f"{stem}.fa", rng, n, l, gap)
    stems = sorted(ALIGNMENTS)

    alns = [read_fasta(str(aln_dir / f"{s}.fa")) for s in stems]
    # the reference in a subprocess of its own, XLA's threads pinned
    ref = run_jax(f"""
from phyloformer_tpu.data.fasta import read_fasta
from phyloformer_tpu.infer.engine import InferenceConfig, InferenceEngine
from phyloformer_tpu.io.ckpt_import import load_pretrained
params, cfg, _ = load_pretrained({str(CKPT)!r})
alns = [read_fasta({str(aln_dir)!r} + f"/{{s}}.fa") for s in {stems!r}]
for s, p in zip({stems!r}, InferenceEngine(params, cfg, InferenceConfig(use_pallas=True))
                .predict(alns)):
    OUT["pred." + s] = p
""", {}, root / "jax")
    want = [ref["pred." + s] for s in stems]

    got = run_port(f"""
import contextlib, io, json
from phyloformer_tpu_torch.data.fasta import read_fasta
from phyloformer_tpu_torch.infer import cli
from phyloformer_tpu_torch.infer.engine import InferenceConfig, InferenceEngine
from phyloformer_tpu_torch.io.ckpt_import import load_pretrained
stems = {stems!r}
alns = [read_fasta({str(aln_dir)!r} + f"/{{s}}.fa") for s in stems]
params, cfg, _ = load_pretrained({str(CKPT)!r})
engine = InferenceEngine(params, cfg, device="cpu")
for s, p in zip(stems, engine.predict(alns)):
    OUT["pred." + s] = p
OUT["predict_one"] = engine.predict_one(alns[0])
OUT["engine_stats"] = json.dumps(engine.stats)
# one alignment per batch; and three padded up to a batch of four
for name, icfg, subset in (("single", InferenceConfig(max_batch_size=1), alns),
                           ("pad4", InferenceConfig(max_batch_size=4, pad_batch_sizes=True),
                            alns[:3])):
    other = InferenceEngine(params, cfg, icfg, device="cpu")
    for s, p in zip(stems, other.predict(subset)):
        OUT[name + "." + s] = p
    OUT[name + ".plan"] = [len(idxs) for _, idxs in other._plan(subset)]
for name, extra in (("cli", []), ("cli_nobucket", ["--no-bucketing"])):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        OUT[name + ".rc"] = cli.main([{str(CKPT)!r}, {str(aln_dir)!r}, "-o",
                                      {str(root)!r} + "/" + name, "--device", "cpu",
                                      "--trees", "--stats"] + extra)
    OUT[name + ".stats"] = buf.getvalue().strip().splitlines()[-1]
""", {}, root / "port")
    return root, stems, alns, want, got


def test_engine_matches_jax(engine_case):
    _, stems, alns, want, got = engine_case
    for s, aln, ref in zip(stems, alns, want):
        pred = got["pred." + s]
        assert pred.shape == (aln.n_seqs * (aln.n_seqs - 1) // 2,)
        assert np.isfinite(pred).all()
        err = np.abs(pred - ref).max()
        assert err <= 5e-5, (s, err)
    np.testing.assert_array_equal(got["predict_one"], got["pred." + stems[0]])
    stats = json.loads(str(got["engine_stats"]))
    assert stats["batches"] == 2 and stats["alignments"] == 5  # predict + predict_one


@pytest.mark.parametrize("run, plan", [("single", [1, 1, 1, 1]), ("pad4", [3])])
def test_engine_batching_is_a_no_op(run, plan, engine_case):
    """Other batch sizes, and batch rows padded up to a power of two, give
    the same predictions."""
    _, stems, _, _, got = engine_case
    assert list(got[run + ".plan"]) == plan
    for s in stems[:sum(plan)]:
        err = np.abs(got[run + "." + s] - got["pred." + s]).max()
        assert err <= 5e-5, (s, err)


@pytest.mark.parametrize("run", ["cli", "cli_nobucket"])
def test_cli_writes_matrices_and_trees(run, engine_case):
    from phyloformer_tpu.data.phylip import read_phylip

    root, stems, alns, want, got = engine_case
    assert int(got[run + ".rc"]) == 0
    stats = json.loads(str(got[run + ".stats"]))
    assert stats["device"] == "cpu" and stats["alignments"] == len(stems)
    for s, aln, ref in zip(stems, alns, want):
        dm, ids = read_phylip(str(root / run / f"{s}.phy"))
        assert ids == aln.ids
        i, j = np.triu_indices(aln.n_seqs, 1)
        np.testing.assert_array_equal(dm, dm.T)
        err = np.abs(dm[i, j] - ref).max()
        assert err <= 1e-4, (s, err)
        nwk = (root / run / f"{s}.nj.nwk").read_text().strip()
        assert nwk.endswith(";") and all(name in nwk for name in aln.ids)


def test_trees_match_jax(tmp_path):
    """The port's NJ and its binding to the native BME+NNI+SPR builder give
    the JAX package's trees, string for string, on the same matrix."""
    from phyloformer_tpu.trees.native import build_tree
    from phyloformer_tpu.trees.nj import neighbor_joining

    rng = np.random.default_rng(71)
    pts = rng.normal(size=(11, 5))
    dm = np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1))
    ids = [f"t{k}" for k in range(len(dm))]
    got = run_port(f"""
from phyloformer_tpu_torch.trees.native import build_tree
from phyloformer_tpu_torch.trees.nj import neighbor_joining
OUT["nj"] = neighbor_joining(IN["dm"], {ids!r}).to_newick()
OUT["bme"] = build_tree(IN["dm"], {ids!r}, method="bme", nni=True, spr=True)
""", {"dm": dm}, tmp_path)
    assert str(got["nj"]) == neighbor_joining(dm, ids).to_newick()
    assert str(got["bme"]) == build_tree(dm, ids, method="bme", nni=True, spr=True)
