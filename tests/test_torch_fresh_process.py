"""Fresh CPU processes of a port entry point give the same bits.

torch's float32 exp, erf, tanh, log and sqrt on the CPU run MKL's vector math
on each thread's share of a tensor.  In a fresh process the first such call,
started on several threads at once, has come out up to 2.4e-4 relative off on
one thread's share; the port's CPU entry points warm that math first
(``device.warm_cpu_math``, called by ``resolve_device``).  Here
``eval_testdata_kf --device cpu`` runs in ``N_PROCESSES`` fresh processes,
``AT_ONCE`` at a time, on four simulated 20 x 120 alignments (the inputs of
``test_torch_tools.py``), and every process must print the same JSON: the
mean, the median and each alignment's KF, to the last bit.
"""

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest

from test_torch_model import CKPT, PORT_THREAD_ENV, REPO, run_port

N_PROCESSES = 16
AT_ONCE = 4


@pytest.fixture(scope="module")
def test_set(tmp_path_factory):
    root = tmp_path_factory.mktemp("fresh")
    msas, trees = root / "alns", root / "trees"
    run_port(f"""
from phyloformer_tpu_torch.sim import cli_msa, cli_trees
assert cli_trees.main(["-n", "4", "-t", "20", "-o", {str(trees)!r}, "--seed", "7"]) == 0
assert cli_msa.main([{str(trees)!r}, {str(msas)!r}, "-l", "120", "--seed", "7"]) == 0
""", {}, root / "sim")
    return msas, trees


def _one(args):
    r = subprocess.run([sys.executable, "-m", "phyloformer_tpu_torch.tools.eval_testdata_kf",
                        str(CKPT), "--device", "cpu"] + args, capture_output=True, text=True,
                       cwd=str(REPO), timeout=300, env={**os.environ, **PORT_THREAD_ENV})
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout.strip().splitlines()[-1]


def test_fresh_cpu_processes_print_the_same_bits(test_set):
    msas, trees = test_set
    args = ["--msas", str(msas), "--trees", str(trees)]
    with ThreadPoolExecutor(AT_ONCE) as pool:
        lines = list(pool.map(_one, [args] * N_PROCESSES))
    counts = {line: lines.count(line) for line in set(lines)}
    assert len(counts) == 1, f"{len(counts)} distinct outputs of {N_PROCESSES}: {counts}"
    out = json.loads(lines[0])
    assert out["n"] == 4 and len(out["kf"]) == 4


def test_warm_up_runs_once_and_on_the_cpu_only(tmp_path):
    """``resolve_device("cpu")`` warms the vector math once; the card's
    branch (or its refusal) does not touch it."""
    out = run_port("""
from phyloformer_tpu_torch import device
device._cpu_math_warm = False
calls = []
real = device._VML_FUNCTIONS
device._VML_FUNCTIONS = tuple((lambda f: lambda x: calls.append(x.numel()) or f(x))(f)
                              for f in real)
try:
    device.resolve_device("cuda")
except RuntimeError:
    pass
OUT["after_cuda"] = len(calls)
assert device.resolve_device("cpu").type == "cpu"
OUT["after_cpu"] = len(calls)
device.resolve_device("cpu")
OUT["after_second"] = len(calls)
OUT["sizes"] = sorted(set(calls))
""", {}, tmp_path)
    n = 6  # exp, erf, tanh, log, sqrt, log1p
    assert int(out["after_cuda"]) == 0
    assert int(out["after_cpu"]) == 2 * n  # once on one thread, once on the pool
    assert int(out["after_second"]) == 2 * n
    assert list(out["sizes"]) == [8, 1 << 21]
