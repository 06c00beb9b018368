"""Inference serving: an HTTP server with request micro-batching.

- ``POST /predict``: body = FASTA text (or JSON ``{"fasta": "..."}``).
  Returns JSON ``{"ids": [...], "distances": [[...]]}``; with
  ``?format=phylip`` the 10-decimal PHYLIP text; with ``?tree=nj`` (or
  ``?tree=bme`` / ``?tree=fastme`` for the native BME+NNI+SPR search) a
  ``"newick"`` field is added.
- ``GET /healthz``: model, config and the batcher's counts.

Concurrent requests are coalesced by a micro-batcher (it waits up to
``batch_window_ms`` to fill a batch), so serving runs the engine's batched
forward rather than one alignment at a time.  Only the batcher's thread
calls the engine.  On the card the engine's kernels are built and loaded
before the server listens, so a kernel that does not build stops the start
instead of the first request.  Standard library only (``http.server`` and
threads); the same endpoints, parameters, status codes and fields as the
JAX package's ``pf-serve``.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from ..data.fasta import read_fasta
from ..data.phylip import vec_to_phylip


@dataclass
class _Request:
    aln: object
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[np.ndarray] = None
    error: Optional[str] = None


class MicroBatcher:
    """Coalesces concurrent predict requests into engine batches."""

    def __init__(self, engine, batch_window_ms: float = 20.0, max_batch: int = 64):
        self.engine = engine
        self.window = batch_window_ms / 1000.0
        self.max_batch = max_batch
        self.q: "queue.Queue[_Request]" = queue.Queue()
        self.stats = {"requests": 0, "batches": 0}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, aln) -> _Request:
        req = _Request(aln)
        self.q.put(req)
        return req

    def _loop(self):
        while not self._stop.is_set():
            try:
                first = self.q.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.perf_counter() + self.window
            while len(batch) < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    batch.append(self.q.get(timeout=remaining))
                except queue.Empty:
                    break
            try:
                preds = self.engine.predict([r.aln for r in batch])
                for req, vec in zip(batch, preds):
                    req.result = vec
            except Exception as err:  # every waiter of the batch gets the error
                for req in batch:
                    req.error = f"{type(err).__name__}: {err}"
            self.stats["requests"] += len(batch)
            self.stats["batches"] += 1
            for req in batch:
                req.done.set()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)


def make_handler(batcher: MicroBatcher, model_info: dict, timeout_s: float = 300.0):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _send(self, code: int, body: bytes, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, obj):
            self._send(code, json.dumps(obj).encode())

        def do_GET(self):
            if self.path.startswith("/healthz"):
                self._send_json(200, {"status": "ok", **model_info, **batcher.stats})
            else:
                self._send_json(404, {"error": "unknown path"})

        def do_POST(self):
            if not self.path.startswith("/predict"):
                self._send_json(404, {"error": "unknown path"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(length)
                if self.headers.get("Content-Type", "").startswith("application/json"):
                    fasta = json.loads(raw)["fasta"].encode()
                else:
                    fasta = raw
                aln = read_fasta(fasta, strict=False)
            except Exception as err:
                self._send_json(400, {"error": f"bad request: {err}"})
                return

            req = batcher.submit(aln)
            if not req.done.wait(timeout=timeout_s):
                self._send_json(504, {"error": "prediction timed out"})
                return
            if req.error:
                self._send_json(500, {"error": req.error})
                return

            params = parse_qs(urlparse(self.path).query)
            dm, phylip = vec_to_phylip(req.result.astype(np.float64), aln.ids)
            if params.get("format", [""])[0] == "phylip":
                self._send(200, phylip.encode(), ctype="text/plain")
                return
            out = {"ids": aln.ids, "distances": np.round(dm, 10).tolist()}
            tree_kind = params.get("tree", [""])[0]
            if tree_kind == "nj":
                from ..trees.nj import neighbor_joining

                out["newick"] = neighbor_joining(dm.astype(np.float64), aln.ids).to_newick()
            elif tree_kind in ("bme", "fastme"):
                from ..trees.native import build_tree

                out["newick"] = build_tree(dm.astype(np.float64), aln.ids,
                                           method="bme", nni=True, spr=True)
            self._send_json(200, out)

    return Handler


class InferenceServer:
    """``engine``: an :class:`..infer.engine.InferenceEngine` (or anything
    with its ``predict``).  ``port=0`` picks a free port (``self.port``)."""

    def __init__(self, engine, model_info: dict, host="127.0.0.1", port=8000,
                 batch_window_ms: float = 20.0):
        load_kernels = getattr(engine, "load_kernels", None)
        if load_kernels is not None:
            load_kernels()  # on the card: raises if a kernel does not build
        self.batcher = MicroBatcher(engine, batch_window_ms)
        handler = make_handler(self.batcher, model_info)
        # a deep listen backlog: bursts beyond the OS default (5) queue
        # rather than get their connections reset
        server_cls = type("PFHTTPServer", (ThreadingHTTPServer,), {"request_queue_size": 256})
        self.httpd = server_cls((host, port), handler)
        self.port = self.httpd.server_address[1]

    def serve_forever(self):
        self.httpd.serve_forever()

    def start_background(self):
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.batcher.close()
