"""The registered ``multihost`` backend (port of the reference's
``multihost/backend.py``): an RPC-sharded host store behind the host
stream.

``MultihostStateBackend`` keeps the ``UserStateBackend`` contract over a
fleet of shard-holder workers (``repro_torch.multihost.worker``): a
cohort's row indices are routed to their owning workers (``searchsorted``
on the contiguous partition bounds), one gather / scatter RPC goes to each
involved worker, and the reassembled rows are handed to
``stream_cohort_rounds`` as the in-process ``HostStateBackend`` hands them
(into the pinned ``out=`` slots on the card).  The coordinator runs the
same cohort rows engine on its device, so:

* ``stage_rows`` off: every leg crosses the wire as exact f32 bytes, and a
  run equals the ``host`` backend's bitwise;
* ``stage_rows`` on: the D-row legs cross as int8 + per-row f32 scale in
  the numpy codec (``wire.np_quantize_rows``).  The backend dequantizes
  for the driver, whose ``stage_rows`` path quantizes again with the same
  codec: the same payload, so the device gets the same rows.  The way
  back is not a fixed point: B2 quantized the updated rows with the
  product scale of the reference's jitted codec, the host dequantized
  them, and the wire's quotient scale of such a row is another float on
  some rows.  Those rows land a code step apart from the ``host``
  backend's, as in the reference's multihost run.

Every call asserts measured payload bytes == the ``upload_bytes_flat``
composed pricing (``wire.priced_*``).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from repro_torch.core.approaches import d_flat_layout, d_opt_flat_layout
from repro_torch.core.engine import _wants_residual
from repro_torch.core.federated import CohortStore, UserStateBackend
from repro_torch.core.session import HostStreamDriver
from repro_torch.core.spec import register_backend
from repro_torch.multihost import wire
from repro_torch.multihost.launch import Fleet, launch_local_workers

_SHARDS_MANIFEST = "shards.json"
_PUSH_CHUNK = 1024


def _np(t) -> np.ndarray:
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


class MultihostStateBackend(UserStateBackend):
    """Per-user rows partitioned across worker processes, reached over
    RPC.  Gathers and scatters keep cohort order; duplicate indices keep
    the host backend's last-writer-wins semantics (each worker applies
    the same numpy assignment).  Rows come back as CPU tensors, written
    into ``out=`` buffers where the caller gives them.

    Counters: ``round_payload_bytes`` (gather, residual and scatter legs),
    ``aux_payload_bytes`` (snapshot, meta and init traffic),
    ``rpc_calls``, ``round_rpc_s`` (wall seconds inside the round legs'
    calls) and ``socket_bytes`` (whole frames, both directions)."""

    device_resident = False

    def __init__(self, fleet: Fleet, num_users: int, nd: int, no: int, *,
                 has_residual: bool, stage_codec: str = "none"):
        self.fleet = fleet
        self._num_users = num_users
        self.nd, self.no = nd, no
        self._has_res = has_residual
        self.stage_codec = stage_codec
        self._los = np.asarray([h.lo for h in fleet.workers], np.int64)
        self.round_payload_bytes = 0
        self.aux_payload_bytes = 0
        self.rpc_calls = 0
        self.round_rpc_s = 0.0

    @property
    def num_users(self) -> int:
        return self._num_users

    @property
    def has_residual(self) -> bool:
        return self._has_res

    @property
    def socket_bytes(self) -> int:
        """Whole-frame bytes both directions (payload + envelope)."""
        return sum(h.client.socket_bytes for h in self.fleet.workers)

    def _call(self, h, method: str, **params):
        self.rpc_calls += 1
        return h.client.call(method, **params)

    def _round_call(self, h, method: str, **params):
        t0 = time.perf_counter()
        try:
            return self._call(h, method, **params)
        finally:
            self.round_rpc_s += time.perf_counter() - t0

    # -- routing -----------------------------------------------------------

    def _route(self, idx: np.ndarray):
        """Yield ``(handle, positions, shard_local_idx)`` per involved
        worker, positions indexing into the original cohort order."""
        idx = np.asarray(idx, np.int64)
        owners = np.searchsorted(self._los, idx, side="right") - 1
        for w in np.unique(owners):
            pos = np.nonzero(owners == w)[0]
            h = self.fleet.workers[int(w)]
            yield h, pos, (idx[pos] - h.lo).astype(np.int32)

    # -- UserStateBackend --------------------------------------------------

    def gather_rows(self, idx, out=None):
        """Rows ``idx``: ``(d, opt, last_round)`` CPU tensors, ``d`` and
        ``opt`` written into ``out = (d, opt)`` where given (either may be
        None)."""
        idx = np.asarray(idx)
        c = len(idx)
        od, oo = out if out is not None else (None, None)
        d = torch.empty((c, self.nd)) if od is None else od
        o = torch.empty((c, self.no)) if oo is None else oo
        dn, on = d.numpy(), o.numpy()
        last = np.empty((c,), np.int32)
        measured = 0
        for h, pos, lidx in self._route(idx):
            ret = self._round_call(h, "gather", idx=lidx.tobytes())
            dn[pos] = wire.unpack_rows(ret["d"])
            on[pos] = wire.unpack_rows(ret["opt"])
            last[pos] = np.frombuffer(ret["last"], np.int32)
            measured += (lidx.nbytes + wire.payload_nbytes(ret["d"])
                         + wire.payload_nbytes(ret["opt"])
                         + len(ret["last"]))
        priced = wire.priced_gather_nbytes(c, self.nd, self.no,
                                           stage_codec=self.stage_codec)
        assert measured == priced, (measured, priced)
        self.round_payload_bytes += measured
        return d, o, torch.from_numpy(last)

    def gather_residual(self, idx, out=None):
        idx = np.asarray(idx)
        res = torch.empty((len(idx), self.nd)) if out is None else out
        rn = res.numpy()
        measured = 0
        for h, pos, lidx in self._route(idx):
            ret = self._round_call(h, "gather_residual", idx=lidx.tobytes())
            rn[pos] = wire.unpack_rows(ret["res"])
            measured += lidx.nbytes + wire.payload_nbytes(ret["res"])
        priced = wire.priced_residual_nbytes(len(idx), self.nd)
        assert measured == priced, (measured, priced)
        self.round_payload_bytes += measured
        return res

    def scatter_rows(self, idx, d_rows, opt_rows, round_idx, *,
                     residual=None) -> None:
        idx = np.asarray(idx)
        assert (residual is None) == (not self._has_res)
        d_rows, opt_rows = _np(d_rows), _np(opt_rows)
        res_rows = None if residual is None else _np(residual)
        measured = 0
        for h, pos, lidx in self._route(idx):
            d_pay = wire.pack_rows(d_rows[pos], self.stage_codec)
            o_pay = wire.pack_rows(opt_rows[pos], "none")
            kw = {}
            if res_rows is not None:
                kw["res"] = wire.pack_rows(res_rows[pos], "none")
                measured += wire.payload_nbytes(kw["res"])
            self._round_call(h, "scatter", idx=lidx.tobytes(), d=d_pay,
                             opt=o_pay, round_idx=int(round_idx), **kw)
            measured += (lidx.nbytes + wire.payload_nbytes(d_pay)
                         + wire.payload_nbytes(o_pay))
        priced = wire.priced_scatter_nbytes(
            len(idx), self.nd, self.no, stage_codec=self.stage_codec,
            has_residual=self._has_res)
        assert measured == priced, (measured, priced)
        self.round_payload_bytes += measured

    @property
    def last_round(self) -> torch.Tensor:
        """The whole (U,) last-trained-round vector (one gather_meta RPC a
        worker); the driver reads it once a run, for staleness."""
        out = np.empty((self._num_users,), np.int32)
        for h in self.fleet.workers:
            ret = self._call(h, "gather_meta")
            out[h.lo:h.hi] = np.frombuffer(ret["last"], np.int32)
            self.aux_payload_bytes += len(ret["last"])
        return torch.from_numpy(out)

    def snapshot(self) -> CohortStore:
        """The whole store at EXACT f32 (the codec is overridden: a
        snapshot reproduces the stored rows bit for bit whatever the
        round's stage codec), gathered in chunks per worker."""
        u = self._num_users
        d = np.empty((u, self.nd), np.float32)
        o = np.empty((u, self.no), np.float32)
        last = np.empty((u,), np.int32)
        res = np.empty((u, self.nd), np.float32) if self._has_res else None
        for h in self.fleet.workers:
            for a in range(0, h.hi - h.lo, _PUSH_CHUNK):
                b = min(a + _PUSH_CHUNK, h.hi - h.lo)
                lidx = np.arange(a, b, dtype=np.int32)
                ret = self._call(h, "gather", idx=lidx.tobytes(),
                                 codec="none")
                rows = slice(h.lo + a, h.lo + b)
                d[rows] = wire.unpack_rows(ret["d"])
                o[rows] = wire.unpack_rows(ret["opt"])
                last[rows] = np.frombuffer(ret["last"], np.int32)
                self.aux_payload_bytes += (
                    lidx.nbytes + wire.payload_nbytes(ret["d"])
                    + wire.payload_nbytes(ret["opt"]) + len(ret["last"]))
                if res is not None:
                    rr = self._call(h, "gather_residual", idx=lidx.tobytes())
                    res[rows] = wire.unpack_rows(rr["res"])
                    self.aux_payload_bytes += (
                        lidx.nbytes + wire.payload_nbytes(rr["res"]))
        return CohortStore(*(None if t is None else torch.from_numpy(t)
                             for t in (d, o, last, res)))

    # -- init --------------------------------------------------------------

    def push_store(self, host_backend) -> None:
        """Seed the fleet from an in-process ``HostStateBackend`` (the
        ``init_host_backend`` values, bitwise), chunked, exact f32."""
        for h in self.fleet.workers:
            for a in range(h.lo, h.hi, _PUSH_CHUNK):
                b = min(a + _PUSH_CHUNK, h.hi)
                kw = {}
                if self._has_res:
                    kw["res"] = wire.pack_rows(
                        host_backend.residual[a:b].numpy(), "none")
                pay = dict(
                    d=wire.pack_rows(host_backend.d_flat[a:b].numpy(),
                                     "none"),
                    opt=wire.pack_rows(host_backend.opt_flat[a:b].numpy(),
                                       "none"),
                    last=host_backend.last_round[a:b].numpy().tobytes(), **kw)
                self._call(h, "push_rows", off=a - h.lo, **pay)
                self.aux_payload_bytes += sum(
                    len(v) if isinstance(v, bytes) else wire.payload_nbytes(v)
                    for v in pay.values())


class MultihostStreamDriver(HostStreamDriver):
    """The ``multihost`` registered backend: the ``HostStreamDriver`` round
    loop (gather -> rows engine on the coordinator's device -> scatter)
    with the store behind :class:`MultihostStateBackend` RPCs.  Init runs
    ``init_host_backend`` in this process (bitwise the host backend's) and
    pushes each worker its shard; the checkpoint holds the shared carry
    only, and each worker writes and reads its own shard file
    (``save_aux`` / ``load_aux``), so another worker count re-partitions
    on restore.  Store-resident window fusion stays host-only (the store
    is remote): ``extra["fused_store"]`` is False.

    ``start_s`` (the fleet's launch and health check) and ``push_s`` (the
    initial push; 0 on a restore) are wall seconds."""

    backend_name = "multihost"

    def __init__(self, sess, defer_state: bool = False):
        sp, fcfg = sess.spec, sess.fcfg
        nd = d_flat_layout(sess.pair).n
        no = d_opt_flat_layout(sess.pair, fcfg).n
        has_res = _wants_residual(fcfg)
        stage_codec = ("int8" if sp.combine.compression.stage_rows
                       else "none")
        t0 = time.perf_counter()
        self._fleet = launch_local_workers(
            fcfg.num_users, sp.backend.workers,
            timeout_s=sp.backend.rpc_timeout_s,
            retries=sp.backend.rpc_retries,
            manifest_extra={"spec": sp.to_dict()})
        self.start_s = time.perf_counter() - t0
        self.push_s = 0.0
        try:
            for h in self._fleet.workers:
                h.client.call("config", nd=nd, no=no,
                              has_residual=has_res,
                              stage_codec=stage_codec)
            super().__init__(sess, defer_state=defer_state)
            mh = MultihostStateBackend(
                self._fleet, fcfg.num_users, nd, no,
                has_residual=has_res, stage_codec=stage_codec)
            if not defer_state:
                t0 = time.perf_counter()
                mh.push_store(self.backend)   # the local init store ...
                self.push_s = time.perf_counter() - t0
            self.backend = mh                 # ... is dropped here
        except BaseException:
            self._fleet.shutdown()
            raise

    # -- checkpoint state: shared carry only; rows live on the workers -----

    def arrays(self) -> dict:
        return {"shared": self._shared_leaves()}

    def load_arrays(self, tree: dict, generator: torch.Generator) -> None:
        self._load_shared(tree, generator)

    def save_aux(self, path: str, step: int) -> None:
        d = os.path.join(path, f"shards_{step:08d}")
        os.makedirs(d, exist_ok=True)
        files = [h.client.call("save_shard", dir=d)
                 for h in self._fleet.workers]
        manifest = {"format": 1, "step": step,
                    "num_users": self.sess.fcfg.num_users,
                    "workers": len(self._fleet.workers),
                    "partitions": self._fleet.manifest["partitions"],
                    "files": files}
        tmp = os.path.join(d, _SHARDS_MANIFEST + ".tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1, sort_keys=True)
        os.replace(tmp, os.path.join(d, _SHARDS_MANIFEST))

    def load_aux(self, path: str, step: int) -> None:
        d = os.path.join(path, f"shards_{step:08d}")
        with open(os.path.join(d, _SHARDS_MANIFEST)) as f:
            manifest = json.load(f)
        if manifest["num_users"] != self.sess.fcfg.num_users:
            raise ValueError(
                f"sharded checkpoint covers {manifest['num_users']} "
                f"users, session has {self.sess.fcfg.num_users}")
        for h in self._fleet.workers:
            h.client.call("restore_shard", dir=d, files=manifest["files"])

    def close(self) -> None:
        self._fleet.shutdown()


register_backend("multihost", MultihostStreamDriver, streams=True)


# ---------------------------------------------------------------------------
# Contract-checker introspection (read by repro_torch.analysis.tracecheck)
# ---------------------------------------------------------------------------

def multihost_trace_specimens(pair, fcfg, *, cohort: int = 2, device=None):
    """Specimens of the multihost backend's device programs (the
    reference's ``multihost/backend.py:310``):

    * ``approach1/multihost_rows[_ef]`` — the round engine the registered
      backend builds (``make_cohort_rows_engine``) over the RPC-staged row
      buffers: the shared state and the rows are updated in place;
    * ``multihost/stage_pack`` / ``multihost/stage_unpack`` — B2's
      quantize and dequantize, the ``stage_rows`` legs of the int8 wire.
      They change the rows' dtype, so nothing can be updated in place: the
      contract is that their inputs come back unchanged."""
    from repro_torch.core.engine import (TraceSpecimen,
                                         make_cohort_rows_engine,
                                         round_launches, sample_shape,
                                         shared_of)
    from repro_torch.core.approaches import init_state
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops as kops

    dev = resolve_device(device)
    C = cohort
    nd, no = d_flat_layout(pair).n, d_opt_flat_layout(pair, fcfg).n
    ef = _wants_residual(fcfg)

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    shared = shared_of(init_state(pair, fcfg, 0, dev))
    rows = (zeros(C, nd), zeros(C, no)) + ((zeros(C, nd),) if ef else ())
    reals = zeros(C, 4, *sample_shape(pair))
    yield TraceSpecimen(
        f"approach1/multihost_rows{'_ef' if ef else ''}",
        make_cohort_rows_engine(pair, fcfg, "approach1"),
        (shared, *rows, zeros(C, dtype=torch.int32), None, reals),
        donate=tuple(range(len(rows) + 1)),
        launches=round_launches(fcfg, "approach1"))
    if not ef:
        yield TraceSpecimen(
            "multihost/stage_pack", lambda x: kops.quantize_rows(x),
            (zeros(C, nd),), donate=(), expect_graph=False,
            launches={"quantize_rows": 1})
        yield TraceSpecimen(
            "multihost/stage_unpack",
            lambda q, s: kops.dequantize_rows(q, s),
            (zeros(C, nd, dtype=torch.int8), zeros(C)), donate=(),
            expect_graph=False, launches={"dequantize_rows": 1})
