"""The readers of the program's spans (``metrics/`` files that read
``benchmark/program_spans.py``): each on a synthetic recording gives the
value computed by hand, and None where it finds nothing to read."""

from types import SimpleNamespace

import pytest

from benchmark import harness, program_spans
from conftest import REPO

MS = 1_000_000  # ns


def sp(id, name, start_ms, end_ms, parent=None, **attrs):
    return SimpleNamespace(id=id, name=name, start_ns=int(start_ms * MS),
                           end_ns=int(end_ms * MS), parent=parent, attrs=attrs)


def recording(spans, start_ms=0.0):
    return SimpleNamespace(spans=spans, start_ns=int(start_ms * MS))


def read(metric, rec, setup=(), window_s=10.0, monkeypatch=None):
    monkeypatch.setattr(program_spans, "recording", lambda: rec)
    monkeypatch.setattr(program_spans, "setup_spans", lambda: list(setup))
    return harness.load_reader(REPO / "benchmark", metric)(SimpleNamespace(window_s=window_s))


def engine_batches():
    # 270 real pair-sites of 300 launched: 10% padding
    return [sp(1, "engine.batch", 0, 1, real_pair_sites=90, padded_pair_sites=100),
            sp(2, "engine.batch", 1, 2, real_pair_sites=180, padded_pair_sites=200),
            sp(3, "engine.predict", 0, 3)]


def queue_marks():
    # waits of 1..20 ms: the exclusive 95th percentile lies at rank 19.95
    return [sp(k, "batcher.queue", 0, k, rid=k) for k in range(1, 21)]


def predicts():
    # 19 requests in a 10 ms predict, one in a 30 ms predict beside a
    # request queued before the window (no rid): 10 + 0.95 x (30 - 10)
    return [sp(100, "batcher.predict", 0, 10, rids=list(range(1, 20))),
            sp(101, "batcher.predict", 20, 50, rids=[20, None])]


def requests():
    # request k lasts k + 10 ms of which 10 ms wait for its answer: its own
    # time is k ms; a wait span of another parent does not count
    out = []
    for k in range(1, 21):
        out += [sp(k, "http.request", 0, k + 10, rid=k),
                sp(100 + k, "http.wait", 1, 11, parent=k, rid=k)]
    return out + [sp(999, "http.wait", 0, 500, parent=None)]


def handler_parts():
    # parse k ms and respond 2k ms for request k: 19.95 and 39.9 ms
    out = []
    for k in range(1, 21):
        out += [sp(k, "http.request", 0, 3 * k + 10, rid=k),
                sp(100 + k, "http.parse", 0, k, parent=k, rid=k),
                sp(200 + k, "http.respond", k + 10, 3 * k + 10, parent=k, rid=k)]
    return out


def loads():
    # 1.5 s of loading over a 10 s window
    return [sp(1, "loader.load", 0, 500), sp(2, "loader.load", 600, 1600),
            sp(3, "loader.assemble", 0, 9000)]


def steps():
    # steps of 1 s (0.25 s waiting on the device) and 0.5 s (0.1 s waiting
    # inside its forward and backward): 1.15 s of 5 s; a wait outside any
    # step does not count
    return [sp(1, "train.step", 0, 1000), sp(2, "train.wait", 0, 250, parent=1),
            sp(3, "train.step", 1000, 1500),
            sp(4, "train.forward_backward", 1100, 1400, parent=3),
            sp(5, "train.wait", 1200, 1300, parent=4), sp(6, "train.wait", 2000, 3000)]


def setup():
    # outermost spans ended before the recording (10 s): 2 s + 1 s; the
    # nested one and the one after the recording began do not count
    return [sp(2, "setup.weights", 500, 1500, parent=1), sp(1, "setup.server", 0, 2000),
            sp(3, "setup.library", 3000, 4000, parent=77), sp(4, "setup.loader", 20000, 21000)]


CASES = [
    ("engine.pad_share.infer", engine_batches, {}, 10.0),
    ("engine.pad_share.serve", engine_batches, {}, 10.0),
    ("batcher.queue_wait_p95_ms.serve", queue_marks, {}, 19.95),
    ("batcher.predict_p95_ms.serve", predicts, {}, 29.0),
    ("http.self_p95_ms.serve", requests, {}, 19.95),
    ("http.parse_p95_ms.serve", handler_parts, {}, 19.95),
    ("http.respond_p95_ms.serve", handler_parts, {}, 39.9),
    ("loader.produce_share.train", loads, {}, 15.0),
    ("step.host_share.train", steps, {"window_s": 5.0}, 23.0),
]


@pytest.mark.parametrize("metric,spans,kw,want", CASES, ids=[c[0] for c in CASES])
def test_reader_on_a_synthetic_recording(metric, spans, kw, want, monkeypatch):
    assert read(metric, recording(spans()), monkeypatch=monkeypatch, **kw) == \
        pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("suffix", ["infer", "train", "serve"])
def test_setup_reader_sums_outermost_spans_before_the_recording(suffix, monkeypatch):
    got = read(f"setup.program_s.{suffix}", recording([], start_ms=10000), setup=setup(),
               monkeypatch=monkeypatch)
    assert got == pytest.approx(3.0, rel=1e-9)


@pytest.mark.parametrize("metric", [c[0] for c in CASES] + ["setup.program_s.infer"])
def test_reader_finds_nothing(metric, monkeypatch):
    assert read(metric, recording([]), monkeypatch=monkeypatch) is None
    assert read(metric, None, monkeypatch=monkeypatch) is None


def test_too_few_requests_for_a_percentile(monkeypatch):
    assert read("batcher.queue_wait_p95_ms.serve", recording(queue_marks()[:19]),
                monkeypatch=monkeypatch) is None


def test_a_program_without_the_recorder_gives_nothing(monkeypatch):
    """The parent of the recorder's change: importing it fails, and every
    reader of it reads None."""
    import builtins

    real = builtins.__import__

    def no_spans(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "phyloformer_tpu_torch" and fromlist and "spans" in fromlist:
            raise ImportError("no span recorder")
        return real(name, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", no_spans)
    assert program_spans.recording() is None and program_spans.setup_spans() == []
