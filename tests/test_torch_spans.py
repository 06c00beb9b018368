"""The port's span recorder (``phyloformer_tpu_torch/spans.py``) and the
spans at its layers' boundaries, on the CPU.

Spans are recorded only while a ``torch.profiler`` records, from every
thread, on the clock of the profiler's events; set-up spans always.  Each
case runs in a fresh interpreter (the port's tests keep torch and JAX in
separate processes).
"""

import json
import os
import subprocess
import sys

import pytest

from test_torch_model import CKPT, PORT_THREAD_ENV, REPO

_PRELUDE = """
import json, sys, threading, time
import numpy as np
import torch
torch.set_num_threads(2)
from torch.profiler import ProfilerActivity, profile
from phyloformer_tpu_torch import spans

def profiled():
    return profile(activities=[ProfilerActivity.CPU])

def rows(rec, name):
    return [s for s in rec.spans if s.name == name]
"""


def port(code: str, prelude: str = _PRELUDE) -> dict:
    """Run ``code`` in a fresh interpreter; it prints one JSON line last."""
    r = subprocess.run([sys.executable, "-c", prelude + code], capture_output=True, text=True,
                       cwd=str(REPO), timeout=300, env={**os.environ, **PORT_THREAD_ENV})
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_off_records_nothing_and_loads_no_torch():
    """Without a profiler a span site yields None from one shared context and
    no recording starts; set-up spans are kept; torch is never loaded."""
    out = port("""
import json, sys
from phyloformer_tpu_torch import spans
ctx = [spans.span("a", k=1), spans.span("b")]
with ctx[0] as got:
    spans.mark("m", 1, 2)
with spans.setup_span("setup.x"):
    pass
print(json.dumps({"same": ctx[0] is ctx[1], "got": got, "rec": spans.recorded() is None,
                  "id": spans.new_id(), "setup": [s.name for s in spans.setup_spans()],
                  "torch": "torch" in sys.modules}))
""", prelude="")
    assert out == {"same": True, "got": None, "rec": True, "id": None, "setup": ["setup.x"],
                   "torch": False}


def test_span_from_thread_started_before_profiler():
    """The micro-batcher's thread exists before the profiler starts; its
    spans are recorded, with its thread id and name, and its nesting."""
    out = port("""
go, done = threading.Event(), threading.Event()
def worker():
    go.wait()
    with spans.span("outer", k=2) as o:
        with spans.span("inner"):
            pass
    done.set()
t = threading.Thread(target=worker, name="batcher-like")
t.start()
with profiled():
    go.set()
    done.wait()
rec = spans.recorded()
outer, inner = rows(rec, "outer")[0], rows(rec, "inner")[0]
print(json.dumps({"tid": outer.tid == t.native_id, "name": rec.threads[outer.tid],
                  "parent": inner.parent == outer.id, "attrs": outer.attrs,
                  "top": outer.parent, "order": outer.start_ns <= inner.start_ns
                  <= inner.end_ns <= outer.end_ns}))
""")
    assert out == {"tid": True, "name": "batcher-like", "parent": True, "attrs": {"k": 2},
                   "top": None, "order": True}


def test_main_thread_span_is_a_profiler_host_op():
    """A main-thread span appears among the profiler's events under its name,
    as a host operation (not a user annotation, which idle-gap labels skip),
    within 1 ms of the span's recorded start and end."""
    out = port("""
with profiled() as prof:
    with spans.span("train.step") as s:
        time.sleep(0.02)
ev = [e for e in prof.profiler.kineto_results.events() if e.name() == "train.step"]
e = ev[0]
print(json.dumps({"n": len(ev), "annotation": e.is_user_annotation(),
                  "start_ms": abs(e.start_ns() - s.start_ns) / 1e6,
                  "end_ms": abs(e.start_ns() + e.duration_ns() - s.end_ns) / 1e6}))
""")
    assert out["n"] == 1 and out["annotation"] is False, out
    assert out["start_ms"] < 1.0 and out["end_ms"] < 1.0, out


def test_many_threads_lose_no_span():
    """More recording threads than cores, switching as often as the
    interpreter allows: every span is kept once, in the one recording, under
    its own thread and parent."""
    out = port("""
import os
n_threads, per = 4 * (os.cpu_count() or 2), 200
go = threading.Barrier(n_threads + 1, timeout=60)
def worker():
    go.wait()
    for _ in range(per):
        with spans.span("outer") as o:
            with spans.span("inner") as i:
                assert i.parent == o.id
old = sys.getswitchinterval()
sys.setswitchinterval(1e-6)
try:
    threads = [threading.Thread(target=worker) for _ in range(n_threads)]
    for t in threads:
        t.start()
    with profiled():
        go.wait()
        for t in threads:
            t.join(timeout=120)
finally:
    sys.setswitchinterval(old)
rec = spans.recorded()
by_id = {s.id: s for s in rec.spans}
inner = rows(rec, "inner")
print(json.dumps({
    "alive": any(t.is_alive() for t in threads), "n": len(rec.spans),
    "want": 2 * n_threads * per, "unique": len(by_id),
    "threads": len({s.tid for s in rec.spans}), "n_threads": n_threads,
    "parents": all(by_id[s.parent].tid == s.tid and by_id[s.parent].name == "outer"
                   for s in inner)}))
""")
    assert not out["alive"] and out["n"] == out["want"] == out["unique"], out
    assert out["threads"] == out["n_threads"] and out["parents"], out


def test_recordings_restart_and_cap():
    """A new profiler session starts a fresh recording; past ``MAX_SPANS``
    spans are counted as dropped, not kept."""
    out = port("""
spans.MAX_SPANS = 3
with profiled():
    for _ in range(5):
        with spans.span("first"):
            pass
one = spans.recorded()
with profiled():
    with spans.span("second"):
        pass
two = spans.recorded()
print(json.dumps({"one": [len(one.spans), one.dropped], "two": [s.name for s in two.spans],
                  "later": two.start_ns >= one.start_ns}))
""")
    assert out == {"one": [3, 2], "two": ["second"], "later": True}


@pytest.mark.parametrize("data", [1, 2])
def test_engine_batches_count_real_and_padded_pair_sites(data):
    """``engine.predict`` on the CPU route: one ``engine.batch`` a planned
    batch, whose pair-site counts are ``_plan``'s arithmetic and sum to the
    new ``engine.stats`` keys; plan and readback inside the predict.  Over a
    data axis of 2 (the sharded engine's plan, its forward on one rank) the
    index repeated to fill the ranks is padding, not a real alignment."""
    out = port(f"""
from phyloformer_tpu_torch.data.fasta import Alignment
from phyloformer_tpu_torch.infer.engine import (InferenceConfig, InferenceEngine,
                                                ShardedInferenceEngine)
from phyloformer_tpu_torch.io.ckpt_import import load_pretrained
from phyloformer_tpu_torch.parallel.mesh import Mesh
params, cfg, _ = load_pretrained({str(CKPT)!r})
icfg = InferenceConfig(max_batch_tokens=6000)
class OneRank(ShardedInferenceEngine):
    _forward = InferenceEngine._forward
eng = (InferenceEngine(params, cfg, icfg, device="cpu") if {data} == 1 else
       OneRank(params, cfg, Mesh({{"data": {data}, "pair": 1}}, 0), icfg, device="cpu"))
rng = np.random.default_rng(0)
dims = [(5, 20), (7, 30), (5, 17), (12, 40), (6, 24)]
alns = [Alignment(rng.integers(0, 20, (n, l)).astype(np.int8), [f"s{{k}}" for k in range(n)])
        for n, l in dims]
plan = eng._plan(alns)
C = lambda n: n * (n - 1) // 2
want_real = [sum(C(alns[i].n_seqs) * alns[i].seq_len for i in set(idxs)) for _, idxs in plan]
want_pad = [len(idxs) * C(pn) * pl for (pn, pl), idxs in plan]
repeats = sum(len(idxs) - len(set(idxs)) for _, idxs in plan)
with profiled():
    eng.predict(alns)
rec = spans.recorded()
b = rows(rec, "engine.batch")
top = rows(rec, "engine.predict")[0]
print(json.dumps({{
    "real": [s.attrs["real_pair_sites"] for s in b],
    "pad": [s.attrs["padded_pair_sites"] for s in b],
    "want_real": want_real, "want_pad": want_pad,
    "stats": [eng.stats["pair_sites_real"], eng.stats["pair_sites_padded"]],
    "alns": sum(s.attrs["alignments"] for s in b), "repeats": repeats,
    "inside": sorted({{s.name for s in rec.spans if s.parent == top.id}}),
    "keys": sorted(eng.stats)}}))
""")
    assert out["real"] == out["want_real"] and out["pad"] == out["want_pad"], out
    assert out["stats"] == [sum(out["want_real"]), sum(out["want_pad"])], out
    assert out["alns"] == 5 + out["repeats"] and len(out["real"]) > 1, out
    assert (out["repeats"] > 0) == (data > 1), out
    assert out["inside"] == ["engine.batch", "engine.plan", "engine.readback"], out
    assert out["keys"] == ["alignments", "batches", "compile_s", "pair_sites_padded",
                           "pair_sites_real", "predict_s"], out


def test_one_request_shares_its_rid():
    """One request to a CPU server: its handler's spans, its wait in the
    queue and its micro-batch's predict all carry the request's ``rid``."""
    out = port(f"""
import urllib.request
from phyloformer_tpu_torch.serve.cli import build_server
srv = build_server([{str(CKPT)!r}, "--port", "0", "--host", "127.0.0.1", "--device", "cpu"])
srv.start_background()
rng = np.random.default_rng(1)
body = "".join(f">s{{k}}\\n" + "".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), 30)) + "\\n"
               for k in range(6)).encode()
url = f"http://127.0.0.1:{{srv.port}}/predict"
with profiled():
    with urllib.request.urlopen(urllib.request.Request(url, data=body), timeout=120) as r:
        answer = json.loads(r.read())
srv.shutdown()
rec = spans.recorded()
req = rows(rec, "http.request")[0]
rid = req.attrs["rid"]
named = {{s.name: s for s in rec.spans}}
print(json.dumps({{
    "n_dist": len(answer["distances"]), "rid": rid is not None,
    "same": sorted(n for n, s in named.items() if s.attrs.get("rid") == rid),
    "in_batch": rid in named["batcher.predict"].attrs["rids"],
    "children": sorted(s.name for s in rec.spans if s.parent == req.id),
    "queue_ends": named["batcher.queue"].end_ns == named["batcher.predict"].start_ns,
    "setup": sorted({{s.name for s in spans.setup_spans()}}),
    "outer": [s.name for s in spans.setup_spans() if s.parent is None]}}))
""")
    assert out["n_dist"] == 6 and out["rid"] and out["in_batch"] and out["queue_ends"], out
    assert out["same"] == ["batcher.queue", "http.parse", "http.request", "http.respond",
                           "http.wait"], out
    assert out["children"] == ["http.parse", "http.respond", "http.wait"], out
    assert out["setup"] == ["setup.engine", "setup.server", "setup.weights"], out
    assert out["outer"] == ["setup.server"], out


def test_train_step_and_loader_spans():
    """Two fused train steps on the CPU from the packed loader: ``train.step``
    holds the device waits (the batch's copies and the pair indices'), the
    forward and backward (which holds the backward and the gradients'
    all-reduce) and the optimizer (which holds Adam's step); the
    loader's producer thread records ``loader.load``, the consumer
    ``loader.assemble``; the train state and loader are set-up spans."""
    out = port("""
from phyloformer_tpu_torch.data.fasta import Alignment
from phyloformer_tpu_torch.models.params import PhyloformerConfig
from phyloformer_tpu_torch.train.data import LoaderConfig
from phyloformer_tpu_torch.train.packed import PackedBucketedLoader
from phyloformer_tpu_torch.train.trainer import TrainConfig, create_train_state, make_train_step
rng = np.random.default_rng(2)
class Items:
    def __len__(self):
        return 4
    def __getitem__(self, i):
        n = 5 + i % 2
        return (Alignment(rng.integers(0, 20, (n, 16)).astype(np.int8),
                          [f"s{k}" for k in range(n)]),
                rng.uniform(0.1, 1.0, n * (n - 1) // 2).astype(np.float32))
loader = PackedBucketedLoader(Items(), LoaderConfig(batch_size=2))
cfg = PhyloformerConfig(n_blocks=1)
tcfg = TrainConfig(loss="mre", warmup_steps=1, total_steps=10, use_pallas=True)
state, tx = create_train_state(cfg, tcfg, device="cpu")
step = make_train_step(cfg, tcfg, tx)
with profiled():
    for batch in loader:
        state, logs = step(state, batch)
rec = spans.recorded()
steps = rows(rec, "train.step")
main = threading.main_thread().native_id
print(json.dumps({
    "steps": len(steps),
    "children": sorted({s.name for s in rec.spans if s.parent == steps[0].id}),
    "waits": sorted({s.attrs["on"] for s in rows(rec, "train.wait")}),
    "parents": {name: sorted({by.name for by in rec.spans for a in rows(rec, name)
                              if by.id == a.parent})
                for name in ("train.apply", "train.backward", "train.reduce")},
    "inside": all(any(t.start_ns <= w.start_ns <= w.end_ns <= t.end_ns for t in steps)
                  for w in rows(rec, "train.wait")),
    "loads": len(rows(rec, "loader.load")),
    "load_thread": {s.tid != main for s in rows(rec, "loader.load")} == {True},
    "assembles": len(rows(rec, "loader.assemble")),
    "setup": sorted({s.name for s in spans.setup_spans()})}))
""")
    assert out["steps"] == 2 and out["loads"] == 4 and out["assembles"] == 2, out
    assert out["children"] == ["train.forward_backward", "train.optimizer", "train.wait"], out
    assert out["waits"] == ["batch_to_device", "pair build", "pair mask", "real pairs"], out
    assert out["inside"], out
    assert out["parents"] == {"train.apply": ["train.optimizer"],
                              "train.backward": ["train.forward_backward"],
                              "train.reduce": ["train.forward_backward"]}, out
    assert out["load_thread"], out
    assert out["setup"] == ["setup.loader", "setup.train_state"], out


def test_trace_exports_spans_of_two_threads(tmp_path):
    """``profiling.trace`` appends the recording's spans to its Chrome trace:
    complete events on rows of their own, one a thread, on the trace's
    time base (a main-thread span lands on its profiler event's time)."""
    out = port(f"""
from phyloformer_tpu_torch.train import profiling
def worker():
    with spans.span("loader.load"):
        time.sleep(0.01)
with profiling.trace({str(tmp_path)!r}):
    with spans.span("train.step"):
        t = threading.Thread(target=worker)
        t.start()
        t.join()
import pathlib
doc = json.loads(next(pathlib.Path({str(tmp_path)!r}).glob("*.pt.trace.json")).read_text())
ev = doc["traceEvents"]
mine = [e for e in ev if e.get("cat") == "program_span"]
prof = [e for e in ev if e.get("name") == "train.step" and e.get("cat") != "program_span"]
step = [e for e in mine if e["name"] == "train.step"][0]
print(json.dumps({{
    "names": sorted(e["name"] for e in mine), "rows": len({{e["tid"] for e in mine}}),
    "complete": {{e["ph"] for e in mine}} == {{"X"}},
    "labelled": sorted(e["args"]["name"] for e in ev if e.get("ph") == "M"
                       and e.get("tid") in {{x["tid"] for x in mine}}),
    "offset_us": abs(step["ts"] - prof[0]["ts"])}}))
""")
    assert out["names"] == ["loader.load", "train.step"] and out["rows"] == 2, out
    assert out["complete"] and len(out["labelled"]) == 2, out
    assert out["offset_us"] < 1000, out


def test_profiler_switch_pin():
    """The recorder's two private torch names: the switch
    ``torch.autograd.profiler._is_profiler_enabled`` (False off, True under
    ``torch.profiler.profile`` and on every thread) and the mirror
    ``torch._C._profiler._RecordFunctionFast``.  This test fails where torch
    drops either; the program itself then records nothing and runs on."""
    out = port("""
import torch.autograd.profiler as tp
seen = {}
def look():
    seen["thread"] = getattr(tp, '_is_profiler_enabled')
before = getattr(tp, '_is_profiler_enabled')
with profiled():
    inside = getattr(tp, '_is_profiler_enabled')
    t = threading.Thread(target=look)
    t.start()
    t.join()
fast = hasattr(torch._C._profiler, '_RecordFunctionFast')
with profiled():  # the profiler sets the switch as it starts: drop it after
    delattr(tp, '_is_profiler_enabled')
    with spans.span("x") as s:
        pass
print(json.dumps({"before": before, "inside": inside, "thread": seen["thread"],
                  "fast": fast, "without": s is None and spans.recorded() is None}))
""")
    assert out == {"before": False, "inside": True, "thread": True, "fast": True,
                   "without": True}
