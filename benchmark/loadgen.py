"""The serving cell's load generator, a process of its own so that its host
work does not share the server's interpreter lock.  Standard library and
numpy only.

    python3 benchmark/loadgen.py --port P --bodies bodies.npz

It warms the server up (the pool's requests all at once, twice), prints
``ready``, then reads lines ``go <schedule.npz> <out.npz>`` from standard
input until it closes.  For each it sends every request of the schedule at
its due time (open loop: a pool of sender threads, each request on a new
connection), prints ``answered`` once every answer has been read, then
writes ``out.npz`` and prints ``done``.  Times are
seconds from the schedule's start: ``due``, ``sent`` (when a sender took
the request up) and ``done`` (when the answer had been read).
"""

from __future__ import annotations

import argparse
import http.client
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

TIMEOUT_S = 120.0
WORKERS = 256  # sender threads: more than the requests ever in flight at once


def send(port: int, body: bytes):
    sent = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT_S)
    try:
        conn.request("POST", "/predict", body=body, headers={"Content-Type": "text/plain"})
        resp = conn.getresponse()
        data, status = resp.read(), resp.status
    except (OSError, http.client.HTTPException):
        data, status = b"", 0
    finally:
        conn.close()
    return sent, time.perf_counter(), status, data


def upper(data: bytes) -> np.ndarray:
    """The answer's square distance matrix → its upper triangle, in pair order."""
    dm = np.asarray(json.loads(data)["distances"], dtype=np.float64)
    return dm[np.triu_indices(dm.shape[0], k=1)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--bodies", required=True)
    args = p.parse_args(argv)
    with np.load(args.bodies) as f:
        bodies = [f[f"b{i}"].tobytes() for i in range(len(f.files))]

    with ThreadPoolExecutor(max_workers=WORKERS) as ex:
        for _ in range(2):
            warm = list(ex.map(lambda b: send(args.port, b), bodies))
            if any(r[2] != 200 for r in warm):
                print(f"warm-up failed: statuses {sorted({r[2] for r in warm})}", file=sys.stderr)
                return 1
        print("ready", flush=True)
        while True:
            cmd = sys.stdin.readline().split()
            if not cmd or cmd[0] != "go":
                return 0
            with np.load(cmd[1]) as f:
                due, idx = f["due"], f["idx"]
            t0 = time.perf_counter()
            futures = []
            for k in range(len(due)):
                delay = t0 + due[k] - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                futures.append(ex.submit(send, args.port, bodies[int(idx[k])]))
            results = [f.result() for f in futures]
            print("answered", flush=True)
            vecs = [upper(r[3]) if r[2] == 200 else np.zeros(0) for r in results]
            np.savez(cmd[2], due=due, idx=idx,
                     sent=np.array([r[0] - t0 for r in results]),
                     done=np.array([r[1] - t0 for r in results]),
                     status=np.array([r[2] for r in results]),
                     offsets=np.cumsum([0] + [len(v) for v in vecs]),
                     dists=np.concatenate(vecs) if vecs else np.zeros(0))
            print("done", flush=True)


if __name__ == "__main__":
    sys.exit(main())
