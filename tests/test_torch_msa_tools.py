"""``pf-msa-torch`` (``phyloformer_tpu_torch.data.cli_msa_tools``) against the
JAX package's ``pf-msa``, on the CPU.

Both CLIs run every subcommand (``stats``, ``dedup``, ``trim``, ``subset``,
``sample``, ``degap``) on the same FASTA files, each side in a fresh
interpreter (:mod:`torch_side_by_side`).  The inputs are made with numpy
from a seed: ragged sizes, a gapped alignment with all-gap columns and
unknown residues, and duplicate rows.  Bar: every output file, standard
output and standard error byte-equal to ``pf-msa``'s, and exit codes equal.
The port's host code imports no torch.
"""

import subprocess
import sys

import numpy as np
import pytest

from test_torch_model import REPO
from torch_side_by_side import ENV, files_of, run_clis_both

AMINO = "ARNDCQEGHILKMFPSTWYV"

# name: (rows, sites, gap fraction, duplicated rows)
INPUTS = {
    "ragged_small": (5, 17, 0.0, 0),
    "gapped": (9, 41, 0.3, 0),
    "duplicates": (12, 33, 0.05, 3),
}


def _fasta(rng, n, l, gap, dups):
    letters = np.array(list(AMINO + "X"))
    rows = letters[rng.integers(0, 21, (n, l))]
    rows[rng.random((n, l)) < gap] = "-"
    if gap:
        rows[:, [3, 7]] = "-"  # all-gap columns
    for k in range(dups):  # copies of earlier rows under new ids
        rows[n - 1 - k] = rows[k]
    return "".join(f">seq{r} taxon {r}\n{''.join(row)}\n" for r, row in enumerate(rows))


def _commands(path, stem):
    out = f"$OUT/{stem}"
    return [
        ("$PKG.data.cli_msa_tools", ["stats", path]),
        ("$PKG.data.cli_msa_tools", ["dedup", path, "-o", f"{out}.dedup.fa"]),
        ("$PKG.data.cli_msa_tools", ["trim", path, "-o", f"{out}.trim.fa", "--length", "10"]),
        ("$PKG.data.cli_msa_tools", ["trim", path, "-o", f"{out}.trim5.fa", "--length", "8",
                                     "--start", "5"]),
        ("$PKG.data.cli_msa_tools", ["subset", path, "-o", f"{out}.subset.fa", "--ids",
                                     "seq3 taxon 3", "seq0 taxon 0", "seq1 taxon 1"]),
        ("$PKG.data.cli_msa_tools", ["sample", path, "-o", f"{out}.sample.fa", "-n", "3",
                                     "--seed", "7"]),
        ("$PKG.data.cli_msa_tools", ["degap", path, "-o", f"{out}.degap.fa"]),
        ("$PKG.data.cli_msa_tools", ["degap", path, "-o", f"{out}.degap5.fa",
                                     "--max-gap-frac", "0.5"]),
    ]


@pytest.fixture(scope="module")
def msa_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("msa_tools")
    rng = np.random.default_rng(16)
    jobs = []
    for name, (n, l, gap, dups) in INPUTS.items():
        path = root / f"{name}.fa"
        path.write_text(_fasta(rng, n, l, gap, dups))
        jobs += _commands(str(path), name)
    return jobs, run_clis_both(jobs, root / "out"), root / "out"


def test_every_subcommand_prints_the_same(msa_runs):
    """Exit code, standard output (``stats``' JSON) and standard error
    (``dedup``'s report) of every command line, equal."""
    jobs, res, _ = msa_runs
    assert len(res["jax"]["res"]) == len(res["port"]["res"]) == len(jobs)
    for job, want, got in zip(jobs, res["jax"]["res"], res["port"]["res"]):
        assert want["rc"] == 0, (job, want)
        assert got == want, job


@pytest.mark.parametrize("subcommand", ["dedup", "trim", "trim5", "subset", "sample", "degap",
                                        "degap5"])
def test_files_byte_equal(subcommand, msa_runs):
    _, _, out = msa_runs
    want, got = files_of(out / "jax"), files_of(out / "port")
    names = sorted(k for k in want if k.endswith(f".{subcommand}.fa"))
    assert len(names) == len(INPUTS), names
    for name in names:
        assert got.get(name) == want[name], name


def test_inputs_exercise_dedup_and_degap(msa_runs):
    """The duplicates are dropped and the all-gap columns go."""
    jobs, res, out = msa_runs
    by_job = {(argv[0], argv[1].rsplit("/", 1)[-1]): r
              for (_, argv), r in zip(jobs, res["port"]["res"])}
    assert '"n_duplicate_seqs": 3' in by_job["stats", "duplicates.fa"]["out"]
    assert "dropped 3 duplicates" in by_job["dedup", "duplicates.fa"]["err"]
    degapped = (out / "port" / "gapped.degap.fa").read_text().splitlines()[1]
    assert "-" not in degapped and len(degapped) < INPUTS["gapped"][1]


def test_pf_msa_torch_entry_point_imports_no_torch(msa_runs, tmp_path):
    """``python -m phyloformer_tpu_torch.data.cli_msa_tools stats`` as a
    process: the JSON of ``pf-msa``, and no torch loaded."""
    jobs, res, _ = msa_runs
    path = jobs[0][1][1]
    r = subprocess.run([sys.executable, "-c",
                        "import runpy, sys\n"
                        "sys.argv = ['pf-msa-torch', 'stats', sys.argv[1]]\n"
                        "try:\n"
                        "    runpy.run_module('phyloformer_tpu_torch.data.cli_msa_tools',"
                        " run_name='__main__')\n"
                        "except SystemExit as e:\n"
                        "    assert e.code == 0, e.code\n"
                        "assert 'torch' not in sys.modules\n", path],
                       cwd=str(REPO), env=ENV, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout == res["jax"]["res"][0]["out"]
