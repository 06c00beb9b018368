"""The reduced-precision inference path of the port against the JAX
package's, on the CPU.

- The pipeline: the port's ``forward_fused_pipeline`` (plain versions on the
  CPU) against JAX ``forward_fused_pipeline(interpret=True)``, block 0 as
  P0 and as A-only, random 2- and 3-block parameters and ``pf_mre_r5``:
  - the sigmoid and relu activations at fp32 storage, within 5e-5 max-abs
    on real pairs (the JAX package's bar for its pipeline);
  - bf16 storage of x1 (``act_dtype_name="bfloat16"``), with the exact,
    tanh, sigmoid and relu activations, within ``BF16_TOL`` of
    max(1, max|ref|).  Both sides round the same fp32 x1 to
    nearest even, but their fp32 values differ by ~1e-7 relative (sums in
    another order), so a few elements in each block round to the
    neighbouring bf16 value (2^-8 relative apart); the flips propagate to
    the distances.  Measured: at most 3.5e-4 here (pf_mre_r5), so the bar
    is 1e-3, under the 6e-3 gate;
  - one TF32 pass (``mxu_precision="default"``): the port's twin rounds the
    operands of every product to TF32 as the kernels do, while JAX on the
    CPU computes ``"default"`` in fp32, so the two differ by the rounding
    the one-pass products bring: within the 6e-3 gate of the JAX package's
    fast path (``bench.py``), here of max(1, max|ref|): the gate is max-abs
    on real MSAs, whose distances lie near 0.4, while pf_mre_r5 puts random
    sequences near 12, where the same relative rounding is 30 times larger
    in absolute terms.  Measured: at most 2.7e-3 (one pass with bf16
    storage on pf_mre_r5), 7.6e-4 on random 3-block parameters.
- One pass, product level: the twin's product ``tf32_rna(a) @ tf32_rna(w)``
  against a float64 transcription with an independent numpy rounding,
  within 2e-6 (fp32's own error), and at least 1e-5 from the unrounded
  product (it is one pass, not three).
- Routing: ``pipeline_supported`` equals JAX's at 1024, 1025, 2048 and
  2049 sites for every precision name.
- The engine at ``matmul_precision="tensorfloat32"`` with bf16 storage
  against JAX's engine with the same configuration (``use_pallas=True``),
  within the gate of max(1, max|ref|) (measured at most 1.6e-3);
  ``pf-infer-torch --matmul-precision tensorfloat32`` on the CPU; unknown
  knob values, which raise, and sigmoid and relu at bf16 storage, which run.
- The variant codes of ``axial_pipeline.cuh`` against the wrapper's.

JAX runs in this process (the engine in a subprocess of its own); the port
in a subprocess (``run_port``).
"""

import json
import pathlib
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from test_torch_model import (
    CKPT,
    flatten,
    random_batch,
    random_params,
    real_pair_mask,
    run_jax,
    run_port,
)

REPO = pathlib.Path(__file__).resolve().parent.parent
CSRC = REPO / "phyloformer_tpu_torch" / "ops" / "kernels" / "csrc"
EPS = 1e-5
FP32_TOL = 5e-5  # max-abs, the JAX pipeline's bar
BF16_TOL = 1e-3  # of max(1, max|ref|): bf16 rounding flips (measured 3.5e-4)
GATE = 6e-3  # the JAX package's fast-path gate (bench.py), of max(1, max|ref|)

# name: (params: (seed, blocks) or "ckpt"; real dims, pad_n, pad_l, gap
#        fraction; block 0; gelu; mxu precision; storage)
CASES = {
    "p0_sigmoid_2blocks": ((71, 2), [(9, 16), (6, 11)], 9, 16, 0.0, "p0", "sigmoid",
                           "highest", "float32"),
    "a_only_relu_2blocks_gapped": ((72, 2), [(8, 14), (9, 16)], 9, 16, 0.3, "a_only", "relu",
                                   "highest", "float32"),
    "p0_bf16_3blocks_ragged": ((73, 3), [(9, 16), (6, 11)], 9, 16, 0.0, "p0", "exact",
                               "highest", "bfloat16"),
    "a_only_bf16_tanh_2blocks": ((74, 2), [(7, 14), (9, 16)], 9, 16, 0.2, "a_only", "tanh",
                                 "highest", "bfloat16"),
    "p0_bf16_ckpt": ("ckpt", [(8, 20), (6, 17)], 8, 20, 0.1, "p0", "exact", "highest",
                     "bfloat16"),
    "p0_one_pass_3blocks": ((75, 3), [(9, 16), (6, 11)], 9, 16, 0.0, "p0", "exact", "default",
                            "float32"),
    "a_only_one_pass_bf16_ckpt": ("ckpt", [(7, 18), (9, 20)], 9, 20, 0.2, "a_only", "tanh",
                                  "default", "bfloat16"),
    "p0_sigmoid_bf16_2blocks": ((76, 2), [(9, 16), (6, 11)], 9, 16, 0.0, "p0", "sigmoid",
                                "highest", "bfloat16"),
    "a_only_relu_bf16_2blocks_gapped": ((77, 2), [(8, 14), (9, 16)], 9, 16, 0.3, "a_only",
                                        "relu", "highest", "bfloat16"),
}


def _tol(case):
    _, _, _, _, _, _, gelu, mxu, act = CASES[case]
    if mxu == "default":
        return GATE, "rel"
    if act == "bfloat16":
        return BF16_TOL, "rel"
    return FP32_TOL, "abs"


def _params(spec):
    if spec == "ckpt":
        from phyloformer_tpu.io import load_pretrained

        params, cfg, _ = load_pretrained(str(CKPT))
        return jax.tree_util.tree_map(np.asarray, params)
    return random_params(*spec)[0]


def _jax_pipeline(params, codes, site_mask, seq_mask, block0, gelu, mxu, act):
    import phyloformer_tpu.ops.pallas.pipeline as jpipe

    budget = jpipe._P0_EMB_BUDGET_BYTES
    if block0 == "a_only":
        # the budget is read at trace time and is not part of the jit key
        jpipe._P0_EMB_BUDGET_BYTES = 0
        jpipe._forward_pipeline_jit._clear_cache()
    try:
        out = jpipe.forward_fused_pipeline(
            params, jnp.asarray(codes), codes.shape[1], jnp.asarray(site_mask),
            jnp.asarray(seq_mask), n_heads=4, eps=EPS, interpret=True, mxu_precision=mxu,
            act_dtype_name=act, gelu_mode=gelu)
        return np.asarray(out)
    finally:
        if block0 == "a_only":
            jpipe._P0_EMB_BUDGET_BYTES = budget
            jpipe._forward_pipeline_jit._clear_cache()


@pytest.fixture(scope="module")
def pipeline_case(tmp_path_factory):
    inputs, want = {}, {}
    for k, (name, (spec, dims, pad_n, pad_l, gap, block0, gelu, mxu, act)) in enumerate(
            CASES.items()):
        params = _params(spec)
        codes, site_mask, seq_mask = random_batch(80 + k, dims, pad_n, pad_l, gap)
        if spec != "ckpt":
            inputs.update(flatten(params, f"{name}/params"))
        inputs.update({f"{name}.codes": codes, f"{name}.site_mask": site_mask,
                       f"{name}.seq_mask": seq_mask})
        want[name] = (_jax_pipeline(params, codes, site_mask, seq_mask, block0, gelu, mxu, act),
                      real_pair_mask(seq_mask))

    got = run_port(f"""
from phyloformer_tpu_torch.io.ckpt_import import load_pretrained
from phyloformer_tpu_torch.ops.kernels import pipeline as pipe
ckpt_params = load_pretrained({str(CKPT)!r})[0]
for name, (spec, block0, gelu, mxu, act) in {
    {k: (v[0], v[5], v[6], v[7], v[8]) for k, v in CASES.items()}!r}.items():
    # an embedding budget of 0 sends block 0 down the A-only route
    pipe.P0_EMB_BUDGET_BYTES = 4 * 1024 * 1024 if block0 == "p0" else 0
    codes = t(name + ".codes")
    b, n, l = codes.shape
    OUT[name + ".gather"] = pipe.uses_gather(n, l, 64)
    params = ckpt_params if spec == "ckpt" else tree(name + "/params")
    weights = pipe.PipelineWeights.from_params(params)
    OUT[name] = pipe.forward_fused_pipeline(weights, codes, t(name + ".site_mask"),
                                            t(name + ".seq_mask"), eps=1e-5, gelu_mode=gelu,
                                            mxu_precision=mxu, act_dtype_name=act)
""", inputs, tmp_path_factory.mktemp("port_precision"))
    return got, want


@pytest.mark.parametrize("case", list(CASES))
def test_pipeline_variant_matches_jax(case, pipeline_case):
    got, want = pipeline_case
    ref, pm = want[case]
    assert bool(got[case + ".gather"]) == (CASES[case][5] == "p0")
    assert got[case].shape == ref.shape
    assert np.isfinite(got[case][pm]).all()
    err = np.abs(got[case] - ref)[pm].max()
    tol, kind = _tol(case)
    if kind == "rel":
        err /= max(1.0, np.abs(ref[pm]).max())
    assert err <= tol, err


# ---- one TF32 pass, product level -------------------------------------------

def _tf32_rna_np(x):
    """numpy transcription of cvt.rna.tf32.f32: the nearer of the two
    neighbouring TF32 values (10 mantissa bits), ties away from zero."""
    x = np.asarray(x, np.float32)
    mag = np.abs(x).astype(np.float64)
    e = np.floor(np.log2(np.where(mag > 0, mag, 1.0)))
    q = np.ldexp(1.0, (e - 10).astype(int))  # TF32 spacing at |x|
    r = np.floor(mag / q + 0.5) * q  # nearest, ties up in magnitude
    return (np.sign(x) * r).astype(np.float32)


@pytest.fixture(scope="module")
def product_case(tmp_path_factory):
    rng = np.random.default_rng(91)
    a = rng.normal(0.0, 1.0, (64, 64)).astype(np.float32)
    got = run_port(f"""
from phyloformer_tpu_torch.io.ckpt_import import load_pretrained
from phyloformer_tpu_torch.ops.kernels.axial_block import mm
params = load_pretrained({str(CKPT)!r})[0]
a = t("a")
for name, w in (("wv", params["layers"][2]["row_attn"]["wv"]),
                ("w1", params["layers"][4]["ffn"]["w1"])):
    OUT[name + ".w"] = w
    OUT[name + ".one"] = mm(a, w, 1)
    OUT[name + ".three"] = mm(a, w, 3)
""", {"a": a}, tmp_path_factory.mktemp("product"))
    return a, got


@pytest.mark.parametrize("name", ["wv", "w1"])
def test_one_pass_product_is_the_rounded_operands_product(name, product_case):
    a, got = product_case
    w = got[name + ".w"]
    ref = _tf32_rna_np(a).astype(np.float64) @ _tf32_rna_np(w).astype(np.float64)
    exact = a.astype(np.float64) @ w.astype(np.float64)
    scale = max(1.0, np.abs(ref).max())
    assert np.abs(got[name + ".one"] - ref).max() / scale <= 2e-6
    # one pass is TF32's rounding away from the fp32 product; three are not
    assert np.abs(got[name + ".one"] - exact).max() / scale >= 1e-5
    assert np.abs(got[name + ".three"] - exact).max() / scale <= 2e-6


# ---- routing, engine, CLI, codes ---------------------------------------------

SITES = (1024, 1025, 2048, 2049)
PRECISIONS = ("highest", "float32", "default", "tensorfloat32")


def test_pipeline_routing_matches_jax(tmp_path_factory):
    from phyloformer_tpu.ops.pallas.pipeline import pipeline_supported

    got = run_port(f"""
import json
from phyloformer_tpu_torch.ops.kernels.pipeline import pipeline_supported
OUT["r"] = np.array(json.dumps([[pipeline_supported(60, l, m) for l in {SITES!r}]
                                for m in {PRECISIONS!r}]))
""", {}, tmp_path_factory.mktemp("routing"))
    want = [[pipeline_supported(60, l, m) for l in SITES] for m in PRECISIONS]
    assert json.loads(str(got["r"])) == want
    assert want[0] == [True, False, False, False] and want[2] == [True, True, True, False]


AMINO = "ARNDCQEGHILKMFPSTWYV"
ENGINE_ALNS = {"a": (7, 30, 0.0), "b": (10, 57, 0.2), "c": (5, 20, 0.0)}


@pytest.fixture(scope="module")
def engine_case(tmp_path_factory):
    root = tmp_path_factory.mktemp("engine_precision")
    aln_dir = root / "alns"
    aln_dir.mkdir()
    rng = np.random.default_rng(93)
    for stem, (n, l, gap) in ENGINE_ALNS.items():
        with open(aln_dir / f"{stem}.fa", "w") as fh:
            for r in range(n):
                seq = np.array(list(AMINO))[rng.integers(0, 20, l)]
                seq[rng.random(l) < gap] = "-"
                fh.write(f">s{stem}{r}\n{''.join(seq)}\n")
    stems = sorted(ENGINE_ALNS)
    cfg = dict(matmul_precision="tensorfloat32", pipeline_act_dtype="bfloat16")
    ref = run_jax(f"""
from phyloformer_tpu.data.fasta import read_fasta
from phyloformer_tpu.infer.engine import InferenceConfig, InferenceEngine
from phyloformer_tpu.io.ckpt_import import load_pretrained
params, cfg, _ = load_pretrained({str(CKPT)!r})
alns = [read_fasta({str(aln_dir)!r} + f"/{{s}}.fa") for s in {stems!r}]
eng = InferenceEngine(params, cfg, InferenceConfig(use_pallas=True, **{cfg!r}))
for s, p in zip({stems!r}, eng.predict(alns)):
    OUT["pred." + s] = p
""", {}, root / "jax")
    got = run_port(f"""
import contextlib, io, json
from phyloformer_tpu_torch.data.fasta import read_fasta
from phyloformer_tpu_torch.infer import cli
from phyloformer_tpu_torch.infer.engine import InferenceConfig, InferenceEngine
from phyloformer_tpu_torch.io.ckpt_import import load_pretrained
params, cfg, _ = load_pretrained({str(CKPT)!r})
alns = [read_fasta({str(aln_dir)!r} + f"/{{s}}.fa") for s in {stems!r}]
eng = InferenceEngine(params, cfg, InferenceConfig(**{cfg!r}), device="cpu")
OUT["mxu"] = eng.mxu_precision
for s, p in zip({stems!r}, eng.predict(alns)):
    OUT["pred." + s] = p
tf32 = InferenceEngine(params, cfg, InferenceConfig(matmul_precision="tensorfloat32"),
                       device="cpu")
for s, p in zip({stems!r}, tf32.predict(alns)):
    OUT["tf32." + s] = p
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    OUT["cli.rc"] = cli.main([{str(CKPT)!r}, {str(aln_dir)!r}, "-o", {str(root / "cli")!r},
                              "--device", "cpu", "--matmul-precision", "tensorfloat32"])
msgs = []
for kw in ({{"precision": "float16"}}, {{"matmul_precision": "bfloat16"}},
           {{"pipeline_act_dtype": "float16"}},
           {{"pipeline_gelu": "sigmoid", "pipeline_act_dtype": "bfloat16"}}):
    try:
        InferenceEngine(params, cfg, InferenceConfig(**kw), device="cpu")
        msgs.append("ran")
    except ValueError as e:
        msgs.append(str(e))
from phyloformer_tpu_torch.ops.kernels import pipeline as pipe
w = eng.weights
x1 = torch.zeros((1, 3, 8, 64), dtype=torch.bfloat16)
try:
    pipe.kernel_z(x1, torch.zeros(1, 8, 192), torch.ones(1, 8), torch.ones(1), w.b[-1],
                  w.head, 1e-5, "relu")
    msgs.append("ran")
except ValueError as e:
    msgs.append(str(e))
OUT["msgs"] = np.array(json.dumps(msgs))
""", {}, root / "port")
    return root, stems, ref, got


def test_engine_reduced_precision_matches_jax(engine_case):
    _, stems, ref, got = engine_case
    assert str(got["mxu"]) == "default"
    for s in stems:
        want = ref["pred." + s]
        assert got["pred." + s].shape == want.shape and np.isfinite(got["pred." + s]).all()
        err = np.abs(got["pred." + s] - want).max() / max(1.0, np.abs(want).max())
        assert err <= GATE, (s, err)


def test_cli_matmul_precision_writes_phylip(engine_case):
    from phyloformer_tpu.data.phylip import read_phylip

    root, stems, _, got = engine_case
    assert int(got["cli.rc"]) == 0
    for s in stems:
        dm, ids = read_phylip(str(root / "cli" / f"{s}.phy"))
        i, j = np.triu_indices(len(ids), 1)
        assert np.abs(dm[i, j] - got["tf32." + s]).max() <= 1e-4, s


def test_refused_knobs_raise(engine_case):
    """Unknown names raise (bf16 parameters are ported, test_torch_serve.py);
    sigmoid at bf16 storage constructs an engine, and kernel Z runs relu on
    a bf16 x1."""
    msgs = json.loads(str(engine_case[3]["msgs"]))
    assert "precision='float16'" in msgs[0]
    assert "matmul_precision='bfloat16'" in msgs[1]
    assert "pipeline_act_dtype='float16'" in msgs[2]
    assert msgs[3] == "ran"
    assert msgs[4] == "ran"


def test_variant_codes_match_wrapper(tmp_path_factory):
    """GELU_*, STORE_* and PASSES_* of axial_pipeline.cuh against the
    wrapper's GELU_MODES order, STORAGE_CODES and PASSES."""
    text = (CSRC / "axial_pipeline.cuh").read_text()
    codes = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", text)}
    got = run_port("""
import json
from phyloformer_tpu_torch.ops.kernels import axial_block, pipeline as pipe
OUT["c"] = np.array(json.dumps({"gelu": list(axial_block.GELU_MODES),
                                "storage": {str(k): v for k, v in pipe.STORAGE_CODES.items()},
                                "passes": list(axial_block.PASSES),
                                "acts": {k: str(v) for k, v in pipe.ACT_DTYPES.items()}}))
""", {}, tmp_path_factory.mktemp("codes"))
    c = json.loads(str(got["c"]))
    assert [codes["GELU_" + m.upper()] for m in c["gelu"]] == list(range(4))
    assert c["storage"] == {"torch.float32": codes["STORE_F32"],
                            "torch.bfloat16": codes["STORE_BF16"]}
    assert c["acts"] == {"float32": "torch.float32", "bfloat16": "torch.bfloat16"}
    assert c["passes"] == [codes["PASSES_SPLIT"], codes["PASSES_ONE"]] == [3, 1]
