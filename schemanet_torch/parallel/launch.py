"""One process a rank on this host: the launcher of the command line's grid
(``--mesh-data``, ``--mesh-model``), as the reference's ``dist_engine.py``
spawns one process per GPU.

``spawn_ranks(cmd, nprocs)`` starts ``cmd`` ``nprocs`` times with the
rendezvous ``torchrun`` would set (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR=localhost``, a free ``MASTER_PORT``), so
each rank joins with ``parallel.mesh.init_from_env``. It waits for all of
them; a rank that fails, or a run past ``timeout`` seconds, stops the others
and raises, so no rank is left waiting in a collective.
"""

from __future__ import annotations

import os
import subprocess
import time
from typing import Dict, Optional, Sequence

from .mesh import _free_port

GRID_CHILD = "SCHEMANET_GRID_RANK"  # set in a spawned rank's environment


def rank_env(rank: int, nprocs: int, port: int, base: Optional[Dict[str, str]] = None
             ) -> Dict[str, str]:
    env = dict(os.environ if base is None else base)
    env.update(RANK=str(rank), WORLD_SIZE=str(nprocs), LOCAL_RANK=str(rank),
               LOCAL_WORLD_SIZE=str(nprocs), MASTER_ADDR="localhost", MASTER_PORT=str(port))
    env[GRID_CHILD] = str(rank)
    return env


def _tail(path: Optional[str], n: int = 4000) -> str:
    if path is None or not os.path.exists(path):
        return ""
    with open(path, errors="replace") as f:
        return f.read()[-n:]


def spawn_ranks(cmd: Sequence[str], nprocs: int, timeout: Optional[float] = None,
                log_dir: Optional[str] = None, env: Optional[Dict[str, str]] = None,
                cwd: Optional[str] = None) -> None:
    """Run ``cmd`` as ranks 0..nprocs-1 and wait. With ``log_dir`` each
    rank's output goes to ``<log_dir>/rank<r>.log`` (the tail of a failed
    rank's is in the error), else to this process's."""
    port = _free_port()
    procs, logs, files = [], [], []
    try:
        for r in range(nprocs):
            out = None
            if log_dir is not None:
                os.makedirs(log_dir, exist_ok=True)
                logs.append(os.path.join(log_dir, f"rank{r}.log"))
                out = open(logs[-1], "w")
                files.append(out)
            procs.append(subprocess.Popen(list(cmd), env=rank_env(r, nprocs, port, env), cwd=cwd,
                                          stdout=out, stderr=subprocess.STDOUT if out else None))
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            failed = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                r, c = failed[0]
                raise RuntimeError(f"rank {r} of {nprocs} exited with code {c}"
                                   + (f"; its log ends:\n{_tail(logs[r])}" if logs else ""))
            if all(c == 0 for c in codes):
                return
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{nprocs} ranks ran past {timeout} s"
                                   + (f"; rank 0's log ends:\n{_tail(logs[0])}" if logs else ""))
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for f in files:
            f.close()
