"""Fleet launcher: a worker count -> per-worker subprocess jobs (port of
the reference's ``multihost/launch.py``; no torch).

Launch a job, wait for it to report ready, run, collect its logs, delete:
spawn ``python -m repro_torch.multihost.worker --lo L --hi H`` per
contiguous partition (with this checkout's ``src`` on ``PYTHONPATH``),
read the ``PORT <p>`` line it prints after binding, health-check it over
RPC, and tear the fleet down (graceful ``shutdown`` RPC first,
SIGTERM/SIGKILL after) when the session closes.  ``Fleet.manifest`` is
the materialized run description: the spec dict plus the concrete
partition and port table.
"""

from __future__ import annotations

import dataclasses
import os
import select
import subprocess
import sys
import tempfile
import time

from repro_torch.multihost.rpc import RpcClient, RpcError, WorkerDied

_SRC_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def partition_users(num_users: int, workers: int) -> list[tuple[int, int]]:
    """Contiguous ``[lo, hi)`` ranges covering ``[0, num_users)``; sizes
    differ by at most one (the first ``num_users % workers`` ranges take
    the extra row)."""
    if not isinstance(workers, int) or workers < 1:
        raise ValueError(f"workers must be an int >= 1, got {workers!r}")
    if num_users < workers:
        raise ValueError(f"cannot partition {num_users} users over "
                         f"{workers} workers (empty shard)")
    base, rem = divmod(num_users, workers)
    parts, lo = [], 0
    for w in range(workers):
        hi = lo + base + (1 if w < rem else 0)
        parts.append((lo, hi))
        lo = hi
    assert lo == num_users
    return parts


@dataclasses.dataclass
class WorkerHandle:
    rank: int
    lo: int
    hi: int
    proc: subprocess.Popen
    client: RpcClient
    log_path: str


class Fleet:
    """The launched worker set + its materialized manifest."""

    def __init__(self, workers: list[WorkerHandle], manifest: dict):
        self.workers = workers
        self.manifest = manifest
        self._down = False

    def shutdown(self, timeout_s: float = 5.0) -> dict:
        """Teardown: graceful shutdown RPC, then SIGTERM, then SIGKILL.
        Returns ``{rank: log tail}`` from the workers' stderr files."""
        if self._down:
            return {}
        self._down = True
        logs = {}
        for h in self.workers:
            try:
                h.client.call("shutdown")
            except RpcError:
                pass
            h.client.close()
            try:
                h.proc.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                h.proc.terminate()
                try:
                    h.proc.wait(timeout=timeout_s)
                except subprocess.TimeoutExpired:
                    h.proc.kill()
                    h.proc.wait()
            try:
                with open(h.log_path, "rb") as f:
                    logs[h.rank] = f.read()[-4096:].decode(
                        "utf-8", "replace")
            except OSError:
                logs[h.rank] = ""
        return logs

    def __del__(self):
        try:
            if not self._down:
                for h in self.workers:
                    h.proc.kill()
        except Exception:   # interpreter teardown: nothing left to report
            pass


def _read_port(proc: subprocess.Popen, deadline: float, rank: int) -> int:
    """The worker prints ``PORT <p>`` right after binding; anything else
    (or exit, or silence past the deadline) is a launch failure.  Reads
    are select-gated so a wedged worker can never hang the launcher."""
    fd = proc.stdout.fileno()
    buf = b""
    while b"\n" not in buf:
        if proc.poll() is not None:
            raise WorkerDied(f"worker {rank} exited with code "
                             f"{proc.returncode} before binding")
        if time.monotonic() > deadline:
            proc.kill()
            raise WorkerDied(f"worker {rank} printed no PORT line within "
                             f"the launch deadline")
        ready, _, _ = select.select([fd], [], [], 0.05)
        if ready:
            chunk = os.read(fd, 4096)
            if chunk:
                buf += chunk
    line = buf.split(b"\n", 1)[0]
    if not line.startswith(b"PORT "):
        raise WorkerDied(f"worker {rank} printed {line!r} instead of a "
                         f"PORT line")
    return int(line.split()[1])


def launch_local_workers(num_users: int, workers: int, *,
                         timeout_s: float = 10.0, retries: int = 2,
                         log_dir: str | None = None,
                         manifest_extra: dict | None = None) -> Fleet:
    """Spawn and health-check a local worker fleet; returns a
    :class:`Fleet` whose clients are connected and pinged.  All workers
    start together; each then has ``timeout_s`` to print its port."""
    parts = partition_users(num_users, workers)
    if log_dir is None:
        log_dir = tempfile.mkdtemp(prefix="repro-torch-multihost-")
    os.makedirs(log_dir, exist_ok=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = _SRC_ROOT + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    procs: list = []
    handles: list[WorkerHandle] = []
    try:
        for rank, (lo, hi) in enumerate(parts):
            log_path = os.path.join(log_dir, f"worker{rank}.log")
            with open(log_path, "wb") as logf:
                procs.append((subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.multihost.worker",
                     "--lo", str(lo), "--hi", str(hi)],
                    stdout=subprocess.PIPE, stderr=logf, env=env), log_path))
        for rank, ((lo, hi), (proc, log_path)) in enumerate(zip(parts,
                                                                procs)):
            port = _read_port(proc, time.monotonic() + timeout_s, rank)
            client = RpcClient("127.0.0.1", port, timeout_s=timeout_s,
                               retries=retries, name=f"worker{rank}",
                               proc=proc)
            info = client.call("ping")       # health check
            if (info["lo"], info["hi"]) != (lo, hi):
                raise WorkerDied(f"worker {rank} holds [{info['lo']}, "
                                 f"{info['hi']}), launched for [{lo}, {hi})")
            handles.append(WorkerHandle(rank, lo, hi, proc, client,
                                        log_path))
    except BaseException:
        for proc, _ in procs:
            proc.kill()
            proc.wait()
        raise
    manifest = {"num_users": num_users, "workers": workers,
                "partitions": [list(p) for p in parts],
                "ports": [h.client.addr[1] for h in handles],
                **(manifest_extra or {})}
    return Fleet(handles, manifest)
