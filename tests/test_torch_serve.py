"""Serving and the engine's remaining knobs: the port against the JAX
package, on the CPU.

The engine (``pf_mre_r5`` on a ragged pair of random alignments, 12 x 100
and 9 x 77, and 2 blocks of random weights read from an ``.npz``):

- ``precision="bfloat16"`` on the kernel route (the port's plain versions)
  against JAX's ``use_pallas=True`` (interpret mode) with its pipeline's
  in-kernel gather off (``_P0_EMB_BUDGET_BYTES = 0``), as JAX runs it on
  hardware: the bf16 embedding widened to fp32 and block 0 as A-only.  The
  port takes that route on both sides of ``uses_gather`` (P0 gathering the
  widened embedding, or A-only), within ``BF16_KERNEL_TOL`` = 5e-5 of
  max(1, max|ref|).  Rounding the weights alone (the fp32 kernels on
  bf16-rounded weights, the embedding unrounded) misses by more than
  ``ROUNDED_WEIGHTS_MISS`` bars, which ``test_bf16_stages_are_needed``
  keeps in view.
- ``precision="bfloat16"`` on the eager route (``use_kernels=False``)
  against JAX's XLA route, in bf16 ulps of max|ref| (the ulp of the largest
  distance, 0.0625 near 12).  The port rounds where XLA does
  (``models.phyloformer``); what is left is the fp32 order of sums, which
  now and then puts a value on the neighbouring bf16 number.  The bar:
  ``EAGER_BF16_ULPS`` = 2, well under the bf16 route's own drift from fp32
  (5 to 8 ulps here), which the eager fp32 route is shown to exceed; and
  the port's bf16 error against JAX's fp32 within 0.5 to 1.5 times JAX's.
- ``use_kernels=False`` at fp32 against JAX's ``use_pallas=False``: 5e-5
  max-abs, the engine's bar (measured 1.9e-5).
- ``pf-infer-torch --precision bfloat16`` and ``--eager`` write what the
  engine predicts.

The server (``InferenceServer`` on ``device="cpu"``, port 0): ``/healthz``;
FASTA and JSON bodies bit-equal to ``engine.predict``; ``format=phylip``
against JAX's server on the same weights and FASTA (same ids, values within
5e-5; JAX serves its XLA route); ``tree=nj`` and ``tree=bme`` leaf sets;
400 on a bad body, 404 on an unknown path, 500 when the engine raises; 8
concurrent requests coalesce into fewer batches, each answer within
``KERNEL_TOL`` (2e-5 of max(1, max|ref|)) of the request predicted alone
(bit-equal here: the plain versions sum whole axes; on the card the batch
size sets the column stats' slot count, which ``chip_smoke.py`` holds).  ``pf-serve-torch`` as a subprocess
answers one request and stops on SIGINT; the mesh flags without a process
group raise the mesh's size error.
Every request has its own timeout.
"""

import json
import os
import signal
import subprocess
import sys
import urllib.request

import numpy as np
import pytest

from test_torch_model import CKPT, PORT_THREAD_ENV, REPO, random_params, run_jax, run_port

BF16_KERNEL_TOL = 5e-5  # of max(1, max|ref|)
ROUNDED_WEIGHTS_MISS = 20  # in BF16_KERNEL_TOL
EAGER_BF16_ULPS = 2  # bf16 ulps of max|ref|
EAGER_BF16_ERR_RATIO = (0.5, 1.5)  # the port's bf16 error against fp32, over JAX's
FP32_TOL = 5e-5  # max-abs
KERNEL_TOL = 2e-5  # of max(1, max|ref|)
AMINO = np.array(list("ARNDCQEGHILKMFPSTWYV-"))

# name: (n, L) of the engine's random alignments
ENGINE_ALNS = {"a": (12, 100), "b": (9, 77)}
# route: (precision, kernels)
ROUTES = {"kernel_bf16": ("bfloat16", True), "eager_bf16": ("bfloat16", False),
          "eager_f32": ("float32", False), "kernel_f32": ("float32", True)}
WEIGHTS = ("ckpt", "random2")
# the port's block 0 on the kernel route: P0 (the in-kernel gather) at these
# sizes, or A-only with the gather's budget at 0
HEADS = ("p0", "a_only")


def _fasta(rng, n, l, gap=0.0):
    seqs = AMINO[rng.integers(0, 20, (n, l))]
    seqs[rng.random((n, l)) < gap] = "-"
    return "".join(f">t{i}\n{''.join(s)}\n" for i, s in enumerate(seqs))


@pytest.fixture(scope="module")
def engine_case(tmp_path_factory):
    from phyloformer_tpu.io.checkpoint import save_params_npz

    root = tmp_path_factory.mktemp("serve_engine")
    rng = np.random.default_rng(0)
    inputs = {f"codes.{k}": rng.integers(0, 20, dims).astype(np.int8)
              for k, dims in ENGINE_ALNS.items()}
    params, _ = random_params(41, 2)
    save_params_npz(root / "random2.npz", params)
    paths = {"ckpt": str(CKPT), "random2": str(root / "random2.npz")}
    (root / "alns").mkdir()
    for k, (n, l) in ENGINE_ALNS.items():
        (root / "alns" / f"{k}.fa").write_text(_fasta(np.random.default_rng(ord(k)), n, l))
    body = """
params_of = {paths!r}
alns = [Alignment(IN["codes." + k], [str(i) for i in range(IN["codes." + k].shape[0])])
        for k in {alns!r}]
for w, path in params_of.items():
    params, cfg, _ = load_pretrained(path)
    for name, (prec, kernels) in {routes!r}.items():
        if w == "random2" and name != "kernel_bf16":
            continue
        eng = InferenceEngine(params, cfg, InferenceConfig(precision=prec, {flag}=kernels){dev})
        for k, p in zip({alns!r}, eng.predict(alns)):
            OUT[w + "." + name + "." + k] = p
"""
    fmt = dict(paths=paths, alns=sorted(ENGINE_ALNS), routes=ROUTES)
    ref = run_jax("""
from phyloformer_tpu.ops.pallas import pipeline
pipeline._P0_EMB_BUDGET_BYTES = 0  # the XLA-gather head, as on hardware
from phyloformer_tpu.data.fasta import Alignment
from phyloformer_tpu.infer.engine import InferenceConfig, InferenceEngine
from phyloformer_tpu.io.ckpt_import import load_pretrained
""" + body.format(flag="use_pallas", dev="", **fmt), inputs, root / "jax")
    got = run_port("""
import contextlib, io
from phyloformer_tpu_torch.data.fasta import Alignment, read_fasta
from phyloformer_tpu_torch.infer import cli
from phyloformer_tpu_torch.infer.engine import InferenceConfig, InferenceEngine
from phyloformer_tpu_torch.io.ckpt_import import load_pretrained
from phyloformer_tpu_torch.models.params import map_params
""" + body.format(flag="use_kernels", dev=', device="cpu"', **fmt) + f"""
# block 0 as A-only
from phyloformer_tpu_torch.ops.kernels import pipeline
pipeline.P0_EMB_BUDGET_BYTES = 0
for w, path in params_of.items():
    params, cfg, _ = load_pretrained(path)
    eng = InferenceEngine(params, cfg, InferenceConfig(precision="bfloat16"), device="cpu")
    for k, p in zip({sorted(ENGINE_ALNS)!r}, eng.predict(alns)):
        OUT[w + ".kernel_bf16_a_only." + k] = p
# the fp32 kernels on bf16-rounded weights: the weights' rounding alone
params, cfg, _ = load_pretrained({str(CKPT)!r})
rounded = map_params(lambda t: t.to(torch.bfloat16).float(), params)
for k, p in zip({sorted(ENGINE_ALNS)!r}, InferenceEngine(rounded, cfg, device="cpu").predict(alns)):
    OUT["rounded." + k] = p
root = {str(root)!r}
stems = {sorted(ENGINE_ALNS)!r}
fa = [read_fasta(root + f"/alns/{{s}}.fa") for s in stems]
for name, flags, icfg in (("cli_bf16", ["--precision", "bfloat16"], dict(precision="bfloat16")),
                          ("cli_eager", ["--eager"], dict(use_kernels=False))):
    with contextlib.redirect_stdout(io.StringIO()):
        OUT[name + ".rc"] = np.asarray(cli.main([{str(CKPT)!r}, root + "/alns", "-o",
                                                 root + "/" + name, "--device", "cpu"] + flags))
    eng = InferenceEngine(params, cfg, InferenceConfig(**icfg), device="cpu")
    for s, p in zip(stems, eng.predict(fa)):
        OUT[name + ".engine." + s] = p
""", inputs, root / "port")
    return root, ref, got


def _rel(got, want):
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


@pytest.mark.parametrize("head", HEADS)
@pytest.mark.parametrize("weights", WEIGHTS)
def test_bf16_kernel_route_matches_jax(weights, head, engine_case):
    _, ref, got = engine_case
    for k in ENGINE_ALNS:
        want = ref[f"{weights}.kernel_bf16.{k}"]
        have = got[f"{weights}.kernel_bf16{'' if head == 'p0' else '_a_only'}.{k}"]
        assert have.shape == want.shape and np.isfinite(have).all()
        assert _rel(have, want) <= BF16_KERNEL_TOL, (weights, head, k, _rel(have, want))


def test_bf16_stages_are_needed(engine_case):
    """The bf16 route differs from fp32 by far more than the bar, and so do
    the fp32 kernels on bf16-rounded weights: the bar sees the embedding's
    rounding."""
    _, ref, got = engine_case
    for k in ENGINE_ALNS:
        want = ref[f"ckpt.kernel_bf16.{k}"]
        assert _rel(ref[f"ckpt.kernel_f32.{k}"], want) > 40 * BF16_KERNEL_TOL
        assert _rel(got[f"rounded.{k}"], want) > ROUNDED_WEIGHTS_MISS * BF16_KERNEL_TOL


def test_eager_bf16_matches_jax_in_ulps(engine_case):
    """Within the bar of JAX's XLA route at bf16, and not within it at fp32:
    the bar tells the two precisions apart."""
    _, ref, got = engine_case
    lo, hi = EAGER_BF16_ERR_RATIO
    for k in ENGINE_ALNS:
        want, have = ref[f"ckpt.eager_bf16.{k}"], got[f"ckpt.eager_bf16.{k}"]
        fp32 = ref[f"ckpt.eager_f32.{k}"]
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        assert np.abs(have - want).max() <= EAGER_BF16_ULPS * ulp, (k, np.abs(have - want).max())
        assert np.abs(got[f"ckpt.eager_f32.{k}"] - want).max() > EAGER_BF16_ULPS * ulp, k
        assert lo * _rel(want, fp32) <= _rel(have, fp32) <= hi * _rel(want, fp32), k


def test_eager_fp32_matches_jax(engine_case):
    _, ref, got = engine_case
    for k in ENGINE_ALNS:
        key = f"ckpt.eager_f32.{k}"
        assert np.abs(got[key] - ref[key]).max() <= FP32_TOL, key
        assert np.abs(got[f"ckpt.kernel_f32.{k}"] - ref[f"ckpt.kernel_f32.{k}"]).max() <= FP32_TOL


@pytest.mark.parametrize("name", ["cli_bf16", "cli_eager"])
def test_infer_cli_precision_and_eager(name, engine_case):
    from phyloformer_tpu.data.phylip import read_phylip

    root, _, got = engine_case
    assert int(got[name + ".rc"]) == 0
    for s in ENGINE_ALNS:
        dm, ids = read_phylip(str(root / name / f"{s}.phy"))
        i, j = np.triu_indices(len(ids), 1)
        np.testing.assert_allclose(dm[i, j], got[f"{name}.engine.{s}"], rtol=0, atol=1e-9)


# ---- the server ----------------------------------------------------------

_CLIENT = """
import json, threading, urllib.error, urllib.request

def call(url, body=None, ctype="text/plain", timeout=120):
    req = urllib.request.Request(url, data=body, headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()
"""

# name: (n, L, gap) of the concurrent requests; mixed buckets
CONCURRENT = {f"c{k}": (5 + k, 20 + 10 * k, 0.1 * (k % 2)) for k in range(8)}


@pytest.fixture(scope="module")
def server_case(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    rng = np.random.default_rng(5)
    fa = {"a": _fasta(rng, 7, 30), "b": _fasta(rng, 10, 57, 0.2)}
    fa.update({k: _fasta(rng, *v) for k, v in CONCURRENT.items()})
    inputs = {"fa." + k: np.asarray(v) for k, v in fa.items()}
    got = run_port(_CLIENT + f"""
from phyloformer_tpu_torch.data.fasta import read_fasta
from phyloformer_tpu_torch.infer.engine import InferenceConfig, InferenceEngine
from phyloformer_tpu_torch.io.ckpt_import import load_pretrained
from phyloformer_tpu_torch.serve import InferenceServer
from phyloformer_tpu_torch.serve.cli import build_server
fa = {{k[3:]: str(v) for k, v in IN.items() if k.startswith("fa.")}}
params, cfg, _ = load_pretrained({str(CKPT)!r})
icfg = InferenceConfig(pad_batch_sizes=True)
eng = InferenceEngine(params, cfg, icfg, device="cpu")
srv = InferenceServer(eng, {{"model": "pf_mre_r5"}}, port=0, batch_window_ms=300)
srv.start_background()
url = f"http://127.0.0.1:{{srv.port}}"
res = {{}}
res["healthz"] = call(url + "/healthz")
res["fasta"] = call(url + "/predict", fa["a"].encode())
res["json"] = call(url + "/predict", json.dumps({{"fasta": fa["b"]}}).encode(),
                   "application/json")
res["phylip"] = call(url + "/predict?format=phylip", fa["a"].encode())
res["nj"] = call(url + "/predict?tree=nj", fa["a"].encode())
res["bme"] = call(url + "/predict?tree=bme", fa["b"].encode())
res["bad_text"] = call(url + "/predict", b"no header line")
res["bad_json"] = call(url + "/predict", b'{{"msa": ""}}', "application/json")
res["get_404"] = call(url + "/nowhere")
res["post_404"] = call(url + "/nowhere", fa["a"].encode())
before = json.loads(call(url + "/healthz")[1])
conc = {{}}
def worker(k):
    conc[k] = call(url + "/predict", fa[k].encode())
threads = [threading.Thread(target=worker, args=(k,)) for k in {sorted(CONCURRENT)!r}]
for t in threads:
    t.start()
for t in threads:
    t.join(timeout=180)
after = json.loads(call(url + "/healthz")[1])
res["concurrent"] = conc
res["counts"] = [before, after]
srv.shutdown()
alone = InferenceEngine(params, cfg, icfg, device="cpu")
for k, text in fa.items():
    OUT["alone." + k] = alone.predict([read_fasta(text.encode(), strict=False)])[0]

class Failing:
    def predict(self, alns):
        raise RuntimeError("engine failed")
bad = InferenceServer(Failing(), {{}}, port=0)
bad.start_background()
res["500"] = call(f"http://127.0.0.1:{{bad.port}}/predict", fa["a"].encode())
bad.shutdown()
try:
    build_server([{str(CKPT)!r}, "--device", "cpu", "--port", "0", "--mesh-data", "2"])
    res["mesh"] = "ran"
except ValueError as e:
    res["mesh"] = str(e)
OUT["res"] = np.asarray(json.dumps(res))
""", inputs, root / "port")
    jax = run_jax(_CLIENT + """
from phyloformer_tpu.infer.engine import InferenceConfig, InferenceEngine
from phyloformer_tpu.io.ckpt_import import load_pretrained
from phyloformer_tpu.serve import InferenceServer
params, cfg, _ = load_pretrained(%r)
srv = InferenceServer(InferenceEngine(params, cfg, InferenceConfig(pad_batch_sizes=True)),
                      {}, port=0)
srv.start_background()
OUT["phylip"] = np.asarray(call(f"http://127.0.0.1:{srv.port}/predict?format=phylip",
                                str(IN["fa.a"]).encode())[1])
srv.shutdown()
""" % str(CKPT), inputs, root / "jax")
    return fa, json.loads(str(got["res"])), got, jax


def _dm(vec, n):
    m = np.zeros((n, n))
    i, j = np.triu_indices(n, 1)
    m[i, j] = m[j, i] = vec.astype(np.float64)
    return np.round(m, 10)


def test_healthz(server_case):
    _, res, _, _ = server_case
    code, body = res["healthz"]
    assert code == 200
    assert json.loads(body) == {"status": "ok", "model": "pf_mre_r5", "requests": 0,
                                "batches": 0}


@pytest.mark.parametrize("kind", ["fasta", "json"])
def test_predict_bodies_bit_equal_to_engine(kind, server_case):
    fa, res, got, _ = server_case
    key = "a" if kind == "fasta" else "b"
    code, body = res[kind]
    assert code == 200
    out = json.loads(body)
    n = fa[key].count(">")
    assert out["ids"] == [f"t{i}" for i in range(n)]
    np.testing.assert_array_equal(np.array(out["distances"]), _dm(got["alone." + key], n))


def test_phylip_matches_jax_server(server_case):
    from phyloformer_tpu.data.phylip import read_phylip

    _, res, _, jax = server_case
    code, text = res["phylip"]
    assert code == 200
    dm, ids = read_phylip(text)
    jdm, jids = read_phylip(str(jax["phylip"]))
    assert text.splitlines()[0] == str(jax["phylip"]).splitlines()[0] == "7"
    assert ids == jids
    assert np.abs(dm - jdm).max() <= FP32_TOL


@pytest.mark.parametrize("tree", ["nj", "bme"])
def test_tree_leaf_sets(tree, server_case):
    fa, res, _, _ = server_case
    code, body = res[tree]
    assert code == 200
    out = json.loads(body)
    leaves = sorted(t.split(":")[0].strip("(),;") for t in out["newick"].split(",")
                    if t.split(":")[0].strip("(),;"))
    assert leaves == sorted(out["ids"])
    assert len(leaves) == fa["a" if tree == "nj" else "b"].count(">")


@pytest.mark.parametrize("case,code", [("bad_text", 400), ("bad_json", 400), ("get_404", 404),
                                       ("post_404", 404), ("500", 500)])
def test_error_statuses(case, code, server_case):
    _, res, _, _ = server_case
    got_code, body = res[case]
    assert got_code == code, (case, body)
    err = json.loads(body)["error"]
    if case == "500":
        assert err == "RuntimeError: engine failed"
    elif code == 400:
        assert err.startswith("bad request: ")


def test_concurrent_requests_coalesce(server_case):
    fa, res, got, _ = server_case
    before, after = res["counts"]
    n_req = after["requests"] - before["requests"]
    n_batches = after["batches"] - before["batches"]
    assert n_req == len(CONCURRENT) and n_batches < n_req, (before, after)
    for k in CONCURRENT:
        code, body = res["concurrent"][k]
        assert code == 200, (k, body)
        n = fa[k].count(">")
        want = _dm(got["alone." + k], n)
        dist = np.array(json.loads(body)["distances"])
        assert np.abs(dist - want).max() <= KERNEL_TOL * max(1.0, np.abs(want).max()), k


def test_mesh_flags_refused(server_case):
    """``--mesh-data 2`` in one process: a mesh of two ranks in a world of
    one raises ``make_mesh``'s size error, which says how to start ranks."""
    _, res, _, _ = server_case
    assert res["mesh"].startswith("mesh 2x1 != 1 devices"), res["mesh"]
    assert "--distributed-init" in res["mesh"], res["mesh"]


def test_serve_cli_answers_and_stops(tmp_path):
    """``python -m phyloformer_tpu_torch.serve.cli W --device cpu --port 0``:
    it prints where it listens, answers one request and exits 0 on SIGINT."""
    env = {**os.environ, **PORT_THREAD_ENV}
    proc = subprocess.Popen(
        [sys.executable, "-m", "phyloformer_tpu_torch.serve.cli", str(CKPT), "--device", "cpu",
         "--port", "0", "--host", "127.0.0.1"], cwd=str(REPO), env=env,
        stderr=subprocess.PIPE, text=True)
    try:
        line = ""
        while "listening on" not in line:
            line = proc.stderr.readline()
            assert line, "the server exited before listening"
        port = int(line.strip().rsplit(":", 1)[1])
        fa = _fasta(np.random.default_rng(9), 6, 40)
        req = urllib.request.Request(f"http://127.0.0.1:{port}/predict?format=phylip",
                                     data=fa.encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            text = r.read().decode()
        assert r.status == 200 and text.splitlines()[0] == "6"
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
