"""N local ranks of one process group (the torch form of the JAX
package's ``--xla_force_host_platform_device_count``: JAX runs N virtual
devices in one process, torch needs N processes).

``spawn_local`` starts ``python -c program arg`` N times with the MACROC_*
environment that ``parallel/distributed.py::maybe_initialize`` reads and a
free localhost port for the rendezvous; each rank reaches its device by the
backend rule (ranks on one card share it under gloo).  A rank reports by
printing lines that start with ``RANK `` followed by one JSON object."""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

#: the directory that holds the macroc_tpu_torch package
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
POLL_S = 0.05


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_local(program: str, arg: str, n: int, env: Optional[dict] = None,
                timeout: float = 600) -> List[dict]:
    """``python -c program arg`` as ranks 0..n-1 of one process group on
    this machine (for n=1 one process, with no MACROC_* process-group
    variables and no port); ``env`` adds to this process's environment.
    Returns the JSON of each rank's last ``RANK`` line, in rank order.

    When a rank exits non-zero, or any is still running at ``timeout``
    seconds, every rank still running is killed and RuntimeError is raised
    with the failing rank's last output; no process outlives the call."""
    port = free_port()
    base = dict(os.environ, **(env or {}))
    base["PYTHONPATH"] = ROOT + os.pathsep + base.get("PYTHONPATH", "")
    for k in ("MACROC_COORDINATOR", "MACROC_NUM_PROCESSES", "MACROC_PROCESS_ID"):
        base.pop(k, None)
    procs, logs = [], []
    failed, timed_out = None, False
    try:
        for rank in range(n):
            e = dict(base)
            if n > 1:
                e.update(MACROC_COORDINATOR=f"localhost:{port}", MACROC_NUM_PROCESSES=str(n),
                         MACROC_PROCESS_ID=str(rank))
            # output to files, not pipes: a rank that prints more than a pipe
            # holds would block while the others are polled
            logs.append(tempfile.TemporaryFile(mode="w+"))
            procs.append(subprocess.Popen([sys.executable, "-c", program, arg], env=e,
                                          stdout=logs[-1], stderr=subprocess.STDOUT, text=True))
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            failed = next((r for r, c in enumerate(codes) if c not in (None, 0)), None)
            if failed is not None or None not in codes:
                break
            if time.monotonic() > deadline:
                failed, timed_out = codes.index(None), True
                break
            time.sleep(POLL_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    if failed is not None:
        how = f"timed out after {timeout} s" if timed_out else f"exited {procs[failed].returncode}"
        raise RuntimeError(f"rank {failed} of {n} {how}:\n{outs[failed][-3000:]}")
    records = []
    for rank, out in enumerate(outs):
        lines = [l for l in out.splitlines() if l.startswith("RANK ")]
        if not lines:
            raise RuntimeError(f"rank {rank} of {n} printed no RANK line:\n{out[-3000:]}")
        records.append(json.loads(lines[-1][5:]))
    return records
