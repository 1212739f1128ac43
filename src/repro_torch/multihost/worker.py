"""Shard-holder worker process (port of the reference's
``multihost/worker.py``)::

    python -m repro_torch.multihost.worker --lo LO --hi HI

numpy and the port's MessagePack codec only (no torch, no jax), so a
fleet of workers is serving RPCs within a fraction of a second: the
coordinator owns all device compute, and a worker is a passive, mutable
row store for its contiguous user range ``[lo, hi)`` of the federation's
(U, N) host store.

Lifecycle: bind port 0, print ``PORT <p>`` on stdout (the launcher reads
it), serve until the ``shutdown`` RPC.  Rows arrive by ``config``
(allocate) and chunked ``push_rows`` (exact f32); the round's traffic is
``gather`` / ``gather_residual`` / ``scatter`` / ``gather_meta``, and
checkpointing ``save_shard`` / ``restore_shard``: each worker writes its
own shard file (the reference's bytes for the same rows) and restore
reads every OVERLAPPING shard file, so a checkpoint saved at one worker
count restores at any other (the coordinator's manifest lists the files;
re-partitioning is row-range slicing).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from repro_torch.checkpoint.msgpack_codec import pack, unpackb
from repro_torch.multihost import wire
from repro_torch.multihost.rpc import RpcServer, _Shutdown

SHARD_RE = r"shard_(\d+)_(\d+)\.msgpack$"


def shard_filename(lo: int, hi: int) -> str:
    return f"shard_{lo:08d}_{hi:08d}.msgpack"


class ShardStore:
    """The worker-side state + RPC handler table."""

    def __init__(self, lo: int, hi: int):
        assert 0 <= lo < hi, (lo, hi)
        self.lo, self.hi = lo, hi
        self.nd = self.no = None
        self.stage_codec = "none"
        self.d = self.opt = self.last = self.res = None

    # -- handlers ----------------------------------------------------------

    def ping(self):
        return {"lo": self.lo, "hi": self.hi,
                "rows": self.hi - self.lo,
                "ready": self.d is not None}

    def config(self, nd: int, no: int, has_residual: bool,
               stage_codec: str = "none"):
        if stage_codec not in wire.WIRE_CODECS:
            raise ValueError(f"unknown stage codec {stage_codec!r}")
        rows = self.hi - self.lo
        self.nd, self.no = int(nd), int(no)
        self.stage_codec = stage_codec
        self.d = np.zeros((rows, self.nd), np.float32)
        self.opt = np.zeros((rows, self.no), np.float32)
        self.last = np.zeros((rows,), np.int32)
        self.res = (np.zeros((rows, self.nd), np.float32)
                    if has_residual else None)
        return None

    def _idx(self, idx: bytes) -> np.ndarray:
        i = np.frombuffer(idx, np.int32)
        if len(i) and (i.min() < 0 or i.max() >= self.hi - self.lo):
            raise IndexError(f"shard-local idx out of range "
                             f"[0, {self.hi - self.lo})")
        return i

    def push_rows(self, off: int, d: dict, opt: dict, last: bytes,
                  res: dict | None = None):
        """Chunked init: exact f32 rows written at ``off`` (shard-local)."""
        dr = wire.unpack_rows(d)
        sl = slice(off, off + len(dr))
        self.d[sl] = dr
        self.opt[sl] = wire.unpack_rows(opt)
        self.last[sl] = np.frombuffer(last, np.int32)
        if (res is None) != (self.res is None):
            raise ValueError("residual rows must be pushed iff the shard "
                             "keeps them")
        if res is not None:
            self.res[sl] = wire.unpack_rows(res)
        return None

    def gather(self, idx: bytes, codec: str | None = None):
        i = self._idx(idx)
        codec = self.stage_codec if codec is None else codec
        return {"d": wire.pack_rows(self.d[i], codec),
                "opt": wire.pack_rows(self.opt[i], "none"),
                "last": self.last[i].tobytes()}

    def gather_residual(self, idx: bytes):
        i = self._idx(idx)
        return {"res": wire.pack_rows(self.res[i], "none")}

    def scatter(self, idx: bytes, d: dict, opt: dict, round_idx: int,
                res: dict | None = None):
        i = self._idx(idx)
        self.d[i] = wire.unpack_rows(d)
        self.opt[i] = wire.unpack_rows(opt)
        self.last[i] = np.int32(round_idx)
        if (res is None) != (self.res is None):
            raise ValueError("residual rows must be scattered iff the shard "
                             "keeps them")
        if res is not None:
            self.res[i] = wire.unpack_rows(res)
        return None

    def gather_meta(self):
        return {"last": self.last.tobytes()}

    # -- checkpointing -----------------------------------------------------

    def save_shard(self, dir: str):
        payload = {"lo": self.lo, "hi": self.hi,
                   "nd": self.nd, "no": self.no,
                   "d": self.d.tobytes(), "opt": self.opt.tobytes(),
                   "last": self.last.tobytes(),
                   "res": None if self.res is None else self.res.tobytes()}
        name = shard_filename(self.lo, self.hi)
        path = os.path.join(dir, name)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pack(payload, f.write)
        os.replace(tmp, path)
        return name

    def restore_shard(self, dir: str, files: list):
        """Load this shard's rows from every overlapping shard file:
        re-partitioning across a worker-count change is row slicing."""
        covered = np.zeros((self.hi - self.lo,), bool)
        for name in files:
            with open(os.path.join(dir, name), "rb") as f:
                p = unpackb(f.read())
            lo2, hi2 = p["lo"], p["hi"]
            a, b = max(self.lo, lo2), min(self.hi, hi2)
            if a >= b:
                continue
            if (p["nd"], p["no"]) != (self.nd, self.no):
                raise ValueError(f"shard {name} has row widths "
                                 f"({p['nd']}, {p['no']}), configured "
                                 f"({self.nd}, {self.no})")
            rows2 = hi2 - lo2
            src = slice(a - lo2, b - lo2)
            dst = slice(a - self.lo, b - self.lo)
            self.d[dst] = np.frombuffer(p["d"], np.float32) \
                .reshape(rows2, self.nd)[src]
            self.opt[dst] = np.frombuffer(p["opt"], np.float32) \
                .reshape(rows2, self.no)[src]
            self.last[dst] = np.frombuffer(p["last"], np.int32)[src]
            if (p["res"] is None) != (self.res is None):
                raise ValueError(f"shard {name} residual presence "
                                 f"mismatches the configured store")
            if self.res is not None:
                self.res[dst] = np.frombuffer(p["res"], np.float32) \
                    .reshape(rows2, self.nd)[src]
            covered[dst] = True
        if not covered.all():
            missing = int((~covered).sum())
            raise ValueError(f"{missing} row(s) of [{self.lo}, {self.hi}) "
                             f"not covered by the given shard files")
        return None

    def shutdown(self):
        raise _Shutdown

    def handlers(self) -> dict:
        return {n: getattr(self, n) for n in
                ("ping", "config", "push_rows", "gather", "gather_residual",
                 "scatter", "gather_meta", "save_shard", "restore_shard",
                 "shutdown")}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--lo", type=int, required=True)
    p.add_argument("--hi", type=int, required=True)
    args = p.parse_args(argv)
    store = ShardStore(args.lo, args.hi)
    srv = RpcServer(store.handlers())
    print(f"PORT {srv.port}", flush=True)
    srv.serve_forever()


if __name__ == "__main__":
    main()
