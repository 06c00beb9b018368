"""The rendezvous of the ``torch.distributed`` ranks that the port's tests start.

A store (``TCPStore``) is hosted by a small process of its own on a port that
it binds itself (port 0) and holds for as long as any rank runs; the ranks
join it as clients, as they join a torchrun agent's store
(``TORCHELASTIC_USE_AGENT_STORE``).  No rank binds a port, so no other
process can take the port between its choice and its bind: the race of a
harness that picks a free port, closes it and hands the number on.

The store's standard input is a pipe whose write end only the ranks hold
(``pass_fds``): it reads to the end of the pipe, which comes when the last
rank has exited, and then stops.  The test process itself imports no torch.

    with Rendezvous() as rdv:
        procs = [rdv.popen(cmd, rank, world, cwd=..., stdout=...) for rank in range(world)]
"""

import os
import subprocess
import sys

_STORE = """
import sys
from torch import distributed as dist
store = dist.TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False)
print(store.port, flush=True)
sys.stdin.buffer.read()
"""


class Rendezvous:
    def __init__(self, timeout: float = 120.0):
        read_end, self._write_end = os.pipe()
        try:
            self._store = subprocess.Popen([sys.executable, "-c", _STORE], stdin=read_end,
                                           stdout=subprocess.PIPE, text=True)
        finally:
            os.close(read_end)
        line = self._store.stdout.readline()
        self._store.stdout.close()
        if not line.strip().isdigit():
            self.close()
            self._store.wait(timeout=timeout)
            raise RuntimeError(f"the rendezvous store did not start (exit {self._store.poll()})")
        self.port = int(line)

    def env(self, rank: int, world: int) -> dict:
        """torchrun's ``env://`` variables of ``rank`` of ``world``, joining
        this store as a client (``LOCAL_RANK``, the card, is the caller's)."""
        return {"RANK": str(rank), "WORLD_SIZE": str(world),
                "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(self.port),
                "TORCHELASTIC_USE_AGENT_STORE": "True", "TORCHELASTIC_RESTART_COUNT": "0"}

    def popen(self, args, rank: int, world: int, env=None, **kw) -> subprocess.Popen:
        """Start one rank: ``env`` (default ``os.environ``) with
        :meth:`env`'s variables over it; the rank holds the store open."""
        return subprocess.Popen(args, env={**(os.environ if env is None else env),
                                           **self.env(rank, world)},
                                pass_fds=(self._write_end,), **kw)

    def close(self) -> None:
        """Drop this process's hold on the store: it stops once every rank
        started by :meth:`popen` has exited."""
        if self._write_end is not None:
            os.close(self._write_end)
            self._write_end = None

    def __enter__(self) -> "Rendezvous":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
