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
instead of the first request.  HTTP through the standard library
(``http.server`` and threads); the same endpoints, parameters, status
codes and fields as the JAX package's ``pf-serve``.

On a mesh of ranks (:class:`..infer.engine.ShardedInferenceEngine`), rank 0
listens and micro-batches through a :class:`MeshLeader`, which broadcasts
each micro-batch (its shapes, then its codes) to the other ranks before all
of them predict it; the other ranks :func:`follow` until a broadcast stop.
After each micro-batch the ranks agree on whether it failed
(:func:`predict_together`): where every rank failed it, rank 0 answers the
error and the mesh serves on; where only some did, every rank stops with
:class:`MeshOutOfStep` and exits non-zero.
"""

from __future__ import annotations

import json
import queue
import threading
import time
import traceback
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

import torch
import torch.distributed as dist

from ..data.fasta import Alignment, read_fasta
from ..data.phylip import vec_to_phylip
from ..parallel.mesh import all_reduce_sum
from ..spans import mark, new_id, recording, span


class MeshOutOfStep(RuntimeError):
    """Some ranks of a mesh failed a micro-batch and the others did not:
    their collectives no longer pair up, so every rank stops."""


@dataclass
class _Request:
    aln: object
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[np.ndarray] = None
    error: Optional[str] = None
    rid: Optional[int] = None  # the HTTP request's spans' id, while spans record
    submit_ns: int = 0  # when it was queued, while spans record


class MicroBatcher:
    """Coalesces concurrent predict requests into engine batches."""

    def __init__(self, engine, batch_window_ms: float = 20.0, max_batch: int = 64):
        self.engine = engine
        self.window = batch_window_ms / 1000.0
        self.max_batch = max_batch
        self.q: "queue.Queue[_Request]" = queue.Queue()
        self.stats = {"requests": 0, "batches": 0}
        self.failure: Optional[MeshOutOfStep] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, aln, rid: Optional[int] = None) -> _Request:
        req = _Request(aln, rid=rid)
        if recording():
            req.submit_ns = time.time_ns()
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
                with span("batcher.predict") as s:
                    if s is not None:  # each request's wait in the queue, until now
                        s.attrs["rids"] = [r.rid for r in batch]
                        for r in batch:
                            if r.submit_ns:
                                mark("batcher.queue", r.submit_ns, s.start_ns, rid=r.rid)
                    preds = self.engine.predict([r.aln for r in batch])
                for req, vec in zip(batch, preds):
                    req.result = vec
            except Exception as err:  # every waiter of the batch gets the error
                for req in batch:
                    req.error = f"{type(err).__name__}: {err}"
                if isinstance(err, MeshOutOfStep):  # no further batch can run
                    self.failure = err
                    self._stop.set()
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
            rid = new_id()
            with span("http.request", rid=rid):
                self._predict(rid)

        def _predict(self, rid):
            with span("http.parse", rid=rid):
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

            req = batcher.submit(aln, rid)
            with span("http.wait", rid=rid):
                done = req.done.wait(timeout=timeout_s)
            with span("http.respond", rid=rid):
                self._respond(req, done, aln)

        def _respond(self, req, done, aln):
            if not done:
                self._send_json(504, {"error": "prediction timed out"})
                return
            if req.error:
                self._send_json(500, {"error": req.error})
                if batcher.failure is not None:  # after the answer: stop serving
                    self.server.shutdown()
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


def broadcast_batch(mesh, alns) -> None:
    """Rank 0: send a micro-batch (``None``: stop) to the other ranks."""
    n = -1 if alns is None else len(alns)
    dist.broadcast(torch.tensor([n], dtype=torch.int64, device=mesh.device), 0,
                   group=mesh.world_group)
    if n <= 0:
        return
    shapes = torch.tensor([d for a in alns for d in a.codes.shape], dtype=torch.int64)
    dist.broadcast(shapes.to(mesh.device), 0, group=mesh.world_group)
    codes = torch.from_numpy(np.concatenate([a.codes.astype(np.int8).ravel() for a in alns]))
    dist.broadcast(codes.to(mesh.device), 0, group=mesh.world_group)


def receive_batch(mesh) -> Optional[List[Alignment]]:
    """The other ranks: the next micro-batch of rank 0, or None to stop."""
    n = torch.zeros(1, dtype=torch.int64, device=mesh.device)
    dist.broadcast(n, 0, group=mesh.world_group)
    n = int(n.item())
    if n < 0:
        return None
    if n == 0:
        return []
    shapes = torch.zeros(2 * n, dtype=torch.int64, device=mesh.device)
    dist.broadcast(shapes, 0, group=mesh.world_group)
    shapes = shapes.view(n, 2).tolist()
    codes = torch.zeros(sum(a * b for a, b in shapes), dtype=torch.int8, device=mesh.device)
    dist.broadcast(codes, 0, group=mesh.world_group)
    flat, out, at = codes.cpu().numpy(), [], 0
    for rows, cols in shapes:
        out.append(Alignment(flat[at:at + rows * cols].reshape(rows, cols),
                             [str(k) for k in range(rows)]))
        at += rows * cols
    return out


def predict_together(engine, mesh, alns):
    """Every rank's predict of one micro-batch, then one all-reduce of how
    many ranks failed it.  None: the predictions.  Every rank (the same
    inputs fail alike, before any collective): this rank's error, and the
    mesh stays in step.  Some: :class:`MeshOutOfStep` on every rank.  A rank
    that fails between two collectives of the batch leaves the others
    waiting in one; they raise when the process group's timeout expires."""
    try:
        preds, err = engine.predict(alns), None
    except Exception as e:  # noqa: BLE001 — the ranks agree on it below
        preds, err = None, e
    flag = torch.tensor([0.0 if err is None else 1.0], device=mesh.device)
    failed = int(all_reduce_sum(flag, mesh.world_group).item())
    if failed == 0:
        return preds
    if failed == mesh.world:
        raise err
    raise MeshOutOfStep(f"{failed} of {mesh.world} ranks failed a micro-batch: stopping "
                        "every rank") from err


class MeshLeader:
    """Rank 0's engine on a mesh: each :meth:`predict` first broadcasts its
    alignments, so that every rank runs the same sharded batch."""

    def __init__(self, engine, mesh):
        self.engine, self.mesh = engine, mesh
        self._lock = threading.Lock()  # one micro-batch, or the stop, at a time

    def load_kernels(self) -> None:
        """Load the kernels here, then wait until every rank has."""
        self.engine.load_kernels()
        self.mesh.barrier()

    def predict(self, alns):
        with self._lock:
            broadcast_batch(self.mesh, alns)
            return predict_together(self.engine, self.mesh, alns)

    def stop(self) -> None:
        """Release the other ranks from :func:`follow`."""
        with self._lock:
            broadcast_batch(self.mesh, None)


def follow(engine, mesh) -> None:
    """The other ranks' serving loop: load the kernels, then predict each
    micro-batch rank 0 broadcasts, until it broadcasts the stop.  A batch
    that every rank failed is rank 0's to answer, and the loop goes on;
    :class:`MeshOutOfStep` ends it."""
    engine.load_kernels()
    mesh.barrier()
    while (alns := receive_batch(mesh)) is not None:
        try:
            predict_together(engine, mesh, alns)
        except MeshOutOfStep:
            raise
        except Exception:  # noqa: BLE001 — failed alike on every rank; rank 0 answers it
            traceback.print_exc()


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
        """Serve until :meth:`shutdown`; raises :class:`MeshOutOfStep` once
        the batcher's mesh fell out of step (its answer sent)."""
        self.httpd.serve_forever()
        if self.batcher.failure is not None:
            self.httpd.server_close()
            raise self.batcher.failure

    def start_background(self):
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.batcher.close()
        stop = getattr(self.batcher.engine, "stop", None)
        if stop is not None:
            stop()
