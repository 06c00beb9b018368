"""The port's fp32 oracle and accuracy grid against the JAX package's, on
the CPU.

- ``predict_fp32_chunked``: the port's against JAX's on the same parameters
  (random 2- and 3-block trees, and ``pf_mre_r5.ckpt``), ragged shapes and a
  gapped alignment, at 1 and 7 pair chunks, within 1e-5 of max(1, max|ref|)
  (the bar of ``tests/test_oracle_chunked.py``, there max-abs on distances
  below 1; pf_mre_r5 gives distances near 12 on random sequences, where
  fp32 sums taken in another order differ by a few ulps); and against the
  port's own eager ``forward``, within the same bar.
- ``bench.accuracy``: the oracle and storage chosen at each default corner,
  the constants, ``check_rows`` on the same rows and the CLIs on the CPU.

JAX runs in this process; the port in a subprocess (``run_port``).
"""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from test_torch_model import CKPT, flatten, random_params, run_port

REPO = pathlib.Path(__file__).resolve().parent.parent
TOL = 1e-5

# name: (params: seed and blocks, or "ckpt"; n, L; gap fraction; chunk counts)
ORACLE_CASES = {
    "two_blocks_ragged": ((31, 2), 9, 23, 0.0, (1, 7)),
    "three_blocks_gapped": ((32, 3), 7, 17, 0.35, (1, 7)),
    "ckpt": ("ckpt", 8, 29, 0.1, (7,)),
}


def _codes(seed, n, l, gap):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 20, (n, l))
    c[rng.random((n, l)) < gap] = 21  # '-'
    return c.astype(np.int32)


def _params(spec):
    if spec == "ckpt":
        from phyloformer_tpu.io import load_pretrained

        params, cfg, _ = load_pretrained(str(CKPT))
        return jax.tree_util.tree_map(np.asarray, params), cfg
    return random_params(*spec)


@pytest.fixture(scope="module")
def oracle_case(tmp_path_factory):
    from phyloformer_tpu.infer.oracle import predict_fp32_chunked

    inputs, want = {}, {}
    for k, (name, (spec, n, l, gap, chunks)) in enumerate(ORACLE_CASES.items()):
        params, cfg = _params(spec)
        codes = _codes(40 + k, n, l, gap)
        if spec != "ckpt":
            inputs.update(flatten(params, f"{name}/params"))
        inputs[f"{name}.codes"] = codes
        for c in chunks:
            want[(name, c)] = predict_fp32_chunked(params, codes, n_heads=cfg.n_heads,
                                                   eps=cfg.ln_eps, n_chunks=c)
    got = run_port(f"""
from phyloformer_tpu_torch.infer.oracle import predict_fp32_chunked
from phyloformer_tpu_torch.io.ckpt_import import load_pretrained
from phyloformer_tpu_torch.models.params import PhyloformerConfig
from phyloformer_tpu_torch.models.phyloformer import forward
for name, (spec, chunks) in {
    {k: (v[0], v[4]) for k, v in ORACLE_CASES.items()}!r}.items():
    if spec == "ckpt":
        params, cfg, _ = load_pretrained({str(CKPT)!r})
    else:
        params, cfg = tree(name + "/params"), PhyloformerConfig(n_blocks=spec[1])
    codes = IN[name + ".codes"]
    for c in chunks:
        OUT[f"{{name}}.{{c}}"] = predict_fp32_chunked(params, codes, cfg.n_heads, cfg.ln_eps,
                                                    n_chunks=c, device="cpu")
    OUT[name + ".eager"] = forward(params, torch.from_numpy(codes)[None], cfg)[0]
""", inputs, tmp_path_factory.mktemp("port_oracle"))
    return got, want


@pytest.mark.parametrize("case", [(name, c) for name, v in ORACLE_CASES.items() for c in v[4]],
                         ids=lambda c: f"{c[0]}-{c[1]}chunks")
def test_chunked_oracle_matches_jax(case, oracle_case):
    got, want = oracle_case
    name, c = case
    g, w = got[f"{name}.{c}"], want[case]
    assert g.dtype == np.float32 and g.shape == w.shape
    assert np.isfinite(g).all()
    err = np.abs(g - w).max() / max(1.0, np.abs(w).max())
    assert err <= TOL, err


@pytest.mark.parametrize("name", list(ORACLE_CASES))
def test_chunked_oracle_matches_port_eager_forward(name, oracle_case):
    got, _ = oracle_case
    c = ORACLE_CASES[name][4][-1]
    w = got[name + ".eager"]
    err = np.abs(got[f"{name}.{c}"] - w).max() / max(1.0, np.abs(w).max())
    assert err <= TOL, err


# ---- the accuracy grid ------------------------------------------------------

ROWS = [
    [{"n": 50, "L": 250, "oracle": "xla_fp32", "max_abs_err": 1e-3, "rel": 2e-4},
     {"n": 200, "L": 1000, "oracle": "fp32_chunked", "max_abs_err": 4e-2, "rel": 4e-3}],
    [{"n": 50, "L": 250, "oracle": "xla_fp32", "max_abs_err": 1e-3, "rel": 2e-2},
     {"n": 100, "L": 250, "oracle": "xla_fp32", "max_abs_err": 1e-3, "rel": 1e-4}],
    [{"n": 50, "L": 250, "oracle": "xla_fp32", "max_abs_err": 1e-3, "rel": 1e-4},
     {"n": 200, "L": 1000, "oracle": "fp32_chunked", "error": "OutOfMemoryError: boom"}],
    [],
]
ROW_IDS = ["within", "over_gate", "error_row", "empty"]
BUCKET_CORNERS = [(50, 250), (100, 250), (100, 1000), (200, 250), (200, 1000), (6, 30),
                  (8, 60), (9, 31), (8, 16)]


@pytest.fixture(scope="module")
def grid_port(tmp_path_factory):
    """The port's grid constants, buckets and check_rows verdicts on ROWS."""
    got = run_port(f"""
import json
from phyloformer_tpu_torch.bench import accuracy as acc
res = {{"grid": acc.DEFAULT_GRID, "xla": acc.XLA_FP32_MAX_TOKENS,
        "fp32": acc.FP32_STORAGE_MAX_TOKENS,
        "buckets": [acc._bucket(n, l) for n, l in {BUCKET_CORNERS!r}],
        "checks": [[acc.check_rows(rows, m) for m in (1e-2, 1e-3)] for rows in {ROWS!r}]}}
OUT["res"] = np.array(json.dumps(res))
""", {}, tmp_path_factory.mktemp("port_grid"))
    return json.loads(str(got["res"]))


def test_grid_constants_match_jax(grid_port):
    import phyloformer_tpu.bench.accuracy as jacc

    assert [tuple(c) for c in grid_port["grid"]] == list(jacc.DEFAULT_GRID)
    assert grid_port["xla"] == jacc.XLA_FP32_MAX_TOKENS
    assert grid_port["fp32"] == jacc.FP32_STORAGE_MAX_TOKENS
    want = [jacc._bucket(n, l) for n, l in BUCKET_CORNERS]
    assert [{k: tuple(v) for k, v in b.items()} for b in grid_port["buckets"]] == want


def test_make_engines_picks_jax_oracles_at_default_corners(tmp_path):
    """The oracle and the fast side's storage at the five default corners,
    and at two small ones: JAX's make_engines (cheap: it compiles nothing)
    against the port's plan and its make_engines on the CPU (no forward
    runs)."""
    from phyloformer_tpu.bench.accuracy import DEFAULT_GRID, make_engines
    from phyloformer_tpu.models.params import PhyloformerConfig, init_params

    cfg = PhyloformerConfig()
    params = init_params(jax.random.PRNGKey(0), cfg)
    corners = list(DEFAULT_GRID) + [(6, 30), (8, 60)]
    want = {}
    for n, l in corners:
        fast, _oracle, name = make_engines(params, cfg, n, l)
        want[f"{n}x{l}"] = [name, fast.icfg.pipeline_act_dtype,
                            fast.icfg.matmul_precision]
    assert want["200x1000"][:2] == ["fp32_chunked", "bfloat16"]
    assert want["200x250"][:2] == ["fused_highest", "float32"]
    got = run_port(f"""
from phyloformer_tpu_torch.bench.accuracy import corner_plan, make_engines
from phyloformer_tpu_torch.models.params import PhyloformerConfig, init_params
cfg = PhyloformerConfig()
params = init_params(cfg)
import json
res = {{}}
for n, l in {corners!r}:
    fast, oracle, name = make_engines(params, cfg, n, l, device="cpu")
    act, plan_name = corner_plan(n, l)
    assert plan_name == name and act == fast.icfg.pipeline_act_dtype
    res[f"{{n}}x{{l}}"] = [name, fast.icfg.pipeline_act_dtype, fast.icfg.matmul_precision]
OUT["res"] = np.array(json.dumps(res))
""", {}, tmp_path)
    assert json.loads(str(got["res"])) == want


@pytest.mark.parametrize("k", range(len(ROWS)), ids=ROW_IDS)
def test_check_rows_matches_jax(k, grid_port):
    """An error row, the worst corner's selection and the gate: the same
    verdict and message as JAX's."""
    from phyloformer_tpu.bench.accuracy import check_rows as jax_check

    want = [list(jax_check(ROWS[k], m)) for m in (1e-2, 1e-3)]
    assert grid_port["checks"][k] == want


def _cli(args, tmp_path):
    r = subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True,
                       cwd=str(REPO), timeout=300,
                       env={**__import__("os").environ, "OMP_NUM_THREADS": "2"})
    return r


def test_bench_cli_accuracy_grid_on_cpu(tmp_path):
    r = _cli(["phyloformer_tpu_torch.bench.cli", "accuracy-grid", "--device", "cpu",
              "--grid", "6x30,8x60", "--reps", "1"], tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    rows = [json.loads(x) for x in lines[:-1]]
    assert [(x["n"], x["L"]) for x in rows] == [(6, 30), (8, 60)]
    assert all(x["oracle"] == "xla_fp32" and 0 < x["rel"] < 1e-2 for x in rows), rows
    assert lines[-1].startswith("worst rel drift")


def test_bench_cli_throughput_on_cpu(tmp_path):
    r = _cli(["phyloformer_tpu_torch.bench.cli", "throughput", str(CKPT), "--device", "cpu",
              "--count", "4", "--tips", "6", "--length", "30"], tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["alignments"] == 4 and out["precision"] == "tensorfloat32"
    assert out["alignments_per_s"] > 0


@pytest.mark.parametrize("cmd", ["manifest"])
def test_bench_cli_unported_subcommands_refuse(cmd, tmp_path):
    """What a subcommand still refuses names what it misses: ``manifest``
    without matplotlib (as on the card's machine) raises naming it; with
    matplotlib it runs (on an empty data directory, every figure skipped)."""
    args = [cmd, str(tmp_path), "-o", str(tmp_path / "out")]
    r = subprocess.run([sys.executable, "-c", "import sys; sys.modules['matplotlib'] = None; "
                        "from phyloformer_tpu_torch.bench import cli; "
                        f"sys.exit(cli.main({args!r}))"], capture_output=True, text=True,
                       cwd=str(REPO), timeout=300)
    last = r.stderr.strip().splitlines()[-1]
    assert r.returncode != 0 and last.startswith("ImportError") and "matplotlib" in last, last
    r = _cli(["phyloformer_tpu_torch.bench.cli"] + args, tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout)
    assert out["rendered"] == [] and len(out["skipped_missing_inputs"]) == 43
