"""Served requests: ``pf-serve-torch`` as its command line builds it
(``serve.cli.build_server``: the configuration's precision, every other
flag at its default), listening on a free port of this process, and the
load generator (``benchmark/loadgen.py``) in a process of its own sending
``POST /predict`` FASTA bodies, one alignment a request, on an open-loop
schedule of :func:`benchmark.traffic.poisson_schedule` drawn from the
cell's ``pattern_seed``; the run's seed draws the alignments.

A request is timed from when it was due to when its answer had been read;
one that fails counts as never answered.  The window is the schedule's
seconds and the wait for its last answers.

Workload keys: ``weights``, ``pool`` (the requests' alignments),
``arrivals`` (``rate`` a second, ``pattern_seed``), ``limits``.
"""

from __future__ import annotations

import gc
import json
import shutil
import subprocess
import sys
import tempfile
import urllib.request
from pathlib import Path

import numpy as np
import torch

from benchmark import compare, traffic
from benchmark.reference import phyloformer as reference
from benchmark.rooflines import model


def in_flight_seconds(start: np.ndarray, end: np.ndarray) -> float:
    """The length of the union of the intervals ``[start, end)``: the
    seconds in which at least one request was in flight."""
    total, reach = 0.0, -np.inf
    for s, e in sorted(zip(start.tolist(), end.tolist())):
        if e > reach:
            total += e - max(s, reach)
            reach = e
    return total


class Runner:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, seed, device
        self.rate = float(cell.workload["arrivals"]["rate"])
        # the arrival pattern is the cell's, the same in every run: the
        # tail's requests are then the same, and only their contents change
        self.pattern = int(cell.workload["arrivals"]["pattern_seed"])

    def setup(self) -> None:
        from phyloformer_tpu_torch.serve.cli import build_server

        wl = self.cell.workload
        self.pool = traffic.pool(wl["pool"], self.seed)
        self.tmp = Path(tempfile.mkdtemp(prefix="pf_bench_serve_"))
        np.savez(self.tmp / "bodies.npz", **{f"b{i}": np.frombuffer(traffic.fasta(it["codes"]),
                                                                     dtype=np.uint8)
                                             for i, it in enumerate(self.pool)})
        argv = [str(self.cell.path(wl["weights"])), "--host", "127.0.0.1", "--port", "0",
                "--precision", self.cell.config["matmul_precision"]]
        if self.device.type == "cpu":
            argv += ["--device", "cpu"]
        self.server = build_server(argv)
        self.server.start_background()
        self.gen = subprocess.Popen(
            [sys.executable, str(self.cell.bench / "loadgen.py"), "--port", str(self.server.port),
             "--bodies", str(self.tmp / "bodies.npz")],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        line = self.gen.stdout.readline().strip()
        if line != "ready":
            self._stop_gen()
            raise RuntimeError(f"the load generator did not warm the server up: {line!r}")
        self.results = None

    def counters(self):
        with urllib.request.urlopen(f"http://127.0.0.1:{self.server.port}/healthz",
                                    timeout=30) as resp:
            health = json.loads(resp.read())
        return {"batcher.requests": health["requests"], "batcher.batches": health["batches"]}

    def _expect(self, word: str) -> None:
        line = self.gen.stdout.readline().strip()
        if line != word:
            raise RuntimeError(f"the load generator stopped: {line!r}")

    def offer(self, seconds: float, tag: str = "window") -> None:
        """Offer the schedule of ``seconds`` at ``self.rate``; returns once
        every answer has been read."""
        due, idx = traffic.poisson_schedule(self.rate, seconds, len(self.pool), self.pattern)
        schedule, out = self.tmp / f"{tag}_schedule.npz", self.tmp / f"{tag}_out.npz"
        np.savez(schedule, due=due, idx=idx)
        self.gen.stdin.write(f"go {schedule} {out}\n")
        self.gen.stdin.flush()
        self._expect("answered")

    def records(self, tag: str = "window"):
        """The offered schedule's records (``loadgen.py``'s ``out.npz``)."""
        self._expect("done")
        with np.load(self.tmp / f"{tag}_out.npz") as f:
            return {k: f[k] for k in f.files}

    def window(self, win, seconds: float):
        self.offer(seconds)
        return {}

    def settle(self):
        r = self.results = self.records()
        ok = r["status"] == 200
        latency = np.where(ok, r["done"] - r["due"], np.inf)
        items = [self.pool[int(i)] for i in r["idx"][ok]]
        return {
            "end_to_end": {"request_p95_ms": 1e3 * float(np.percentile(latency, 95))},
            "attempted": int(len(latency)), "failed": int((~ok).sum()),
            "model_flop": sum(model.forward_flop(it["n"], it["l"], self.cell.config)
                              for it in items),
            "pair_sites": traffic.real_pair_sites(items),
            "units": 0,  # no reader of this cell counts per batch
            "late_ms": list(1e3 * (r["sent"] - r["due"])),
            "active_s": in_flight_seconds(r["sent"], r["done"]),
        }

    def _stop_gen(self):
        if getattr(self, "gen", None) is not None and self.gen.poll() is None:
            try:
                self.gen.stdin.close()
                self.gen.wait(timeout=30)
            except (OSError, subprocess.TimeoutExpired):
                self.gen.kill()
                self.gen.wait()

    def release(self) -> None:
        self._stop_gen()
        if getattr(self, "server", None) is not None:
            self.server.shutdown()
            self.server = None
        gc.collect()

    def check(self):
        ref_model = reference.from_checkpoint(self.cell.path(self.cell.workload["weights"]),
                                              self.cell.config, self.device)
        r = self.results
        wanted = sorted({int(i) for i in r["idx"]})
        refs = {i: reference.predict(ref_model, self.pool[i]["codes"], self.device).numpy()
                for i in wanted}
        del ref_model
        off = r["offsets"]
        pairs = [(r["dists"][off[k]:off[k + 1]] if r["status"][k] == 200 else np.zeros(0),
                  refs[int(r["idx"][k])]) for k in range(len(r["idx"]))]
        shutil.rmtree(self.tmp, ignore_errors=True)
        return {"dist_gap": compare.dist_gap(pairs)}
