"""FederationSession: the executor behind FederationSpec (port of the
reference's ``core/session.py:75-233, 533-802, 1123-1430``).

A session binds a :class:`repro_torch.core.spec.FederationSpec` to the
runtime objects a spec cannot serialize (the G/D ``pair``, the
``DistGANConfig``, the ``FederatedDataset``) and owns the mutable run
state: the training state, the data RNG stream and the round counter.
``run(rounds)`` advances the federation by a window of rounds and returns
that window's :class:`RunResult`; windowing does not change the
trajectory (``run(5); run(6)`` equals ``run(11)`` bitwise).

The port has the ``device`` backend in its ``fused`` and ``per_step``
modes under full participation and, for a cohort-virtualized spec, its
``cohort`` mode: U logical users' rows live in a resident store on the
device and each round a scheduled cohort of C users trains.  The ``host``
backend (``HostStreamDriver``) keeps the (U, N) store in host memory and
streams the cohort's rows each round (``stream_cohort_rounds``: data
prefetch, bounded staleness, int8 row staging) or each window
(``superbatch_cohort_rounds``).  On a CUDA device every mode replays CUDA
graphs (``core/engine.py``): ``fused`` and ``cohort`` one per chunk,
``per_step`` and the host stream one per round, the superbatch one per
window.  The ``spmd`` backend (``core/spmd.py::SpmdStreamDriver``) is the
host stream with the cohort mapped onto a users mesh, one member per rank
(``FederationSession(..., mesh=)`` on every rank; eager rounds).

``save(path)`` / ``restore(path, ...)`` checkpoint the whole session in
the reference's layout: ``step_<round>.msgpack`` holds the training
state's arrays in the reference's leaf order, ``session.json`` the spec,
the round, the numpy data and scheduler streams and the participation
counts; ``run(rounds, autosave_every=, autosave_path=)`` saves at
internal round boundaries.  The reference's PRNG key slot holds the
port's round-noise generator state (a uint8 tensor) instead.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import time
import typing

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.msgpack_ckpt import _path as checkpoint_path
from repro_torch.checkpoint.msgpack_ckpt import (check_leaves, latest_step,
                                                 read_leaves, save_checkpoint,
                                                 tree_flatten, tree_unflatten)
from repro_torch.core.approaches import (DistGANConfig, DistGANState,
                                         d_flat_layout, d_opt_flat_layout,
                                         init_state, state_template)
from repro_torch.core.engine import (CohortShared, CohortState,
                                     _wants_residual, cohort_state_template,
                                     cohort_state_to_full, init_cohort_state,
                                     init_host_backend,
                                     make_cohort_engine,
                                     make_cohort_rows_engine, make_engine,
                                     make_fused_store_engine,
                                     make_superbatch_engine, shared_template)
from repro_torch.core.federated import (CohortStore, HostStateBackend,
                                        make_schedule_source,
                                        participation_weights,
                                        upload_bytes_flat, window_forwarding)
from repro_torch.core.spec import (FederationSpec, register_backend,
                                   resolve_approach, resolve_backend)
from repro_torch.device import deterministic_convolutions, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models.common import tree_map

# pre-stage a whole window's batches on the device when below this (else
# the fused engine stages chunk by chunk)
_STAGE_CAP_BYTES = 256 * 1024 * 1024

_SESSION_META = "session.json"


@dataclasses.dataclass
class RunResult:
    """One window's results.  ``state`` is the live training state, not a
    snapshot: under full participation it IS the engine's carry, and in a
    cohort run its G, optimizer, server D and step are (its ``ds`` and
    ``d_opts`` are fresh).  The session's next ``run`` updates those in
    place (on the card, by replaying the graphs captured over them), so
    clone what must outlive it."""

    g_losses: np.ndarray           # (steps,)
    d_losses: np.ndarray           # (steps, U)
    wall_time_s: float
    step_time_s: float             # steady-state per-round (after chunk 0)
    samples: np.ndarray | None
    state: typing.Any              # DistGANState
    extra: dict


def _merge_results(parts: list) -> RunResult:
    """Consecutive sub-window results (the autosave path) as one window's:
    time series concatenate, counts sum, and the point-in-time fields
    (state, samples, staleness) come from the last sub-window."""
    if len(parts) == 1:
        return parts[0]
    extra = dict(parts[-1].extra)
    for key in ("mean_age", "schedule", "participation_weights"):
        if all(key in p.extra for p in parts):
            extra[key] = np.concatenate([p.extra[key] for p in parts])
    if all("participation_counts" in p.extra for p in parts):
        extra["participation_counts"] = np.sum(
            [p.extra["participation_counts"] for p in parts], axis=0)
    if all("compile_s" in p.extra for p in parts):
        extra["compile_s"] = float(sum(p.extra["compile_s"]
                                       for p in parts))
    if all("min_step_time_s" in p.extra for p in parts):
        extra["min_step_time_s"] = min(p.extra["min_step_time_s"]
                                       for p in parts)
    return RunResult(
        g_losses=np.concatenate([p.g_losses for p in parts]),
        d_losses=np.concatenate([p.d_losses for p in parts]),
        wall_time_s=sum(p.wall_time_s for p in parts),
        step_time_s=parts[-1].step_time_s,
        samples=parts[-1].samples,
        state=parts[-1].state,
        extra=extra)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _drive_chunks(run_chunk, carry, steps: int, rpj: int, device):
    """Warmup + timed chunk loop.  The first chunk (``min(rpj, steps)``
    rounds) pays the kernels' first-use build and the allocator's
    warm-up and is timed apart as ``compile_s``.  Returns ``(carry,
    chunks, compile_s, steady_s, window_rates)``; ``window_rates`` holds
    per-round seconds of each full post-warmup chunk."""
    k0 = min(rpj, steps)
    t0 = time.perf_counter()
    carry, m0 = run_chunk(0, k0, carry)
    compile_s = time.perf_counter() - t0
    chunks = [m0]

    t1 = time.perf_counter()
    i = k0
    window_rates = []
    while i < steps:
        k = min(rpj, steps - i)
        tc = time.perf_counter()
        carry, m = run_chunk(i, k, carry)
        if k == rpj:
            window_rates.append((time.perf_counter() - tc) / k)
        chunks.append(m)
        i += k
    _sync(device)
    steady = time.perf_counter() - t1
    return carry, chunks, compile_s, steady, window_rates


@dataclasses.dataclass
class _Slot:
    host: torch.Tensor              # pinned (rpj, ...) buffer
    dev: torch.Tensor               # its device twin
    copied: typing.Any = None       # event: host -> dev copy done
    freed: typing.Any = None        # event: dev read by its chunk


class _Stager:
    """``get(start, k)``: rounds ``[start, start + k)`` of a window as one
    (k, ...) device tensor; ``batch_round(r)`` draws round r and is called
    in order.  A window under ``_STAGE_CAP_BYTES`` is staged in one copy
    (from pinned memory on a CUDA device).  A larger one goes chunk by
    chunk; on a CUDA device through two pinned host buffers used in turn:
    ``after(start, k)``, called once chunk ``start`` is enqueued, draws the
    next chunk into the other buffer and copies it on a side stream, which
    waits for that buffer's last reader, so the copy overlaps the replay;
    ``get`` makes the current stream wait for the copy."""

    def __init__(self, batch_round, rounds: int, round_nbytes: int,
                 rpj: int, device: torch.device):
        self.batch_round, self.rounds, self.rpj = batch_round, rounds, rpj
        self.device, self.cuda = device, device.type == "cuda"
        self.window = None
        if rounds * round_nbytes <= _STAGE_CAP_BYTES:
            self.window = self._draw(0, rounds).to(device, non_blocking=True)
        elif self.cuda:
            self.stream = torch.cuda.Stream(device)
            self.slots: list[_Slot] = []
            self.staged: dict[int, _Slot] = {}

    def _draw(self, start: int, k: int, out=None,
              rows: int | None = None) -> torch.Tensor:
        """Rounds ``[start, start + k)`` on the host, into the first k rows
        of ``out``, or of a new buffer of ``rows`` (default k) rounds,
        pinned on a CUDA device."""
        first = np.asarray(self.batch_round(start), np.float32)
        if out is None:
            out = torch.empty((rows or k,) + first.shape,
                              dtype=torch.float32, pin_memory=self.cuda)
        host = out.numpy()
        host[0] = first
        for j in range(1, k):
            host[j] = self.batch_round(start + j)
        return out

    def _prefetch(self, start: int, k: int) -> None:
        if len(self.slots) < 2:
            slot = self._new_slot(start, k)
        else:
            slot = self.slots[len(self.staged) % 2]
            slot.copied.synchronize()     # its host buffer is free again
            self._draw(start, k, out=slot.host)
        with torch.cuda.stream(self.stream):
            if slot.freed is not None:
                self.stream.wait_event(slot.freed)
            slot.dev[:k].copy_(slot.host[:k], non_blocking=True)
            slot.copied = torch.cuda.Event()
            slot.copied.record(self.stream)
        self.staged[start] = slot

    def _new_slot(self, start: int, k: int) -> _Slot:
        host = self._draw(start, k, rows=self.rpj)
        dev = torch.empty(host.shape, dtype=host.dtype, device=self.device)
        dev.record_stream(self.stream)
        self.slots.append(_Slot(host, dev))
        return self.slots[-1]

    def get(self, start: int, k: int) -> torch.Tensor:
        if self.window is not None:
            return self.window[start:start + k]
        if not self.cuda:
            return self._draw(start, k)
        if start not in self.staged:
            self._prefetch(start, k)
        slot = self.staged[start]
        torch.cuda.current_stream(self.device).wait_event(slot.copied)
        return slot.dev[:k]

    def after(self, start: int, k: int) -> None:
        if self.window is not None or not self.cuda:
            return
        slot = self.staged[start]
        slot.freed = torch.cuda.Event()
        slot.freed.record(torch.cuda.current_stream(self.device))
        nxt = start + k
        if nxt < self.rounds:
            self._prefetch(nxt, min(self.rpj, self.rounds - nxt))


def _upload_accounting(pair, fcfg: DistGANConfig, approach, C: int,
                       kept_frac: float, *, stage_rows: bool = False) -> dict:
    """Per-round upload bytes for delta-uploading approaches: C members
    upload per round; the codec reprices the payload
    (``upload_bytes_flat``)."""
    if not resolve_approach(approach).uploads:
        return {}
    n = d_flat_layout(pair).n
    kf = kept_frac if fcfg.selection == "threshold" else None
    per_user = upload_bytes_flat(n, fcfg.selection, fcfg.upload_frac,
                                 kept_frac=kf, codec=fcfg.codec)
    lossy = fcfg.codec != "none"
    return {"upload_bytes_per_user": per_user,
            "upload_bytes_per_round": C * per_user,
            "compression": {
                "codec": fcfg.codec,
                "error_feedback": bool(lossy and fcfg.error_feedback),
                "stochastic": bool(lossy and fcfg.codec_stochastic),
                "stage_rows": bool(stage_rows)}}


def _fetch(metrics: dict) -> dict:
    """Device metrics -> numpy (one host sync for the whole dict)."""
    return {k: v.cpu().numpy() for k, v in metrics.items()}


def _tree_to(tree, device):
    """A checkpoint tree (dicts, lists, None) with every tensor moved to
    ``device``."""
    return tree_unflatten(tree, [t.to(device) for t in tree_flatten(tree)])


# ---------------------------------------------------------------------------
# Streaming drivers (rows engines over a UserStateBackend)
# ---------------------------------------------------------------------------

def _np_quantize_rows(x: np.ndarray):
    """Host-side per-row absmax int8, the numpy mirror of the plain codec's
    deterministic path, used by the ``stage_rows`` transport to ship 1 byte
    an element host -> device.  It is numpy and does not flush subnormals,
    bit for bit the reference's (``session.py:239-248``); the device codec
    flushes them, as the reference's f32 does."""
    x = np.asarray(x, np.float32)
    scale = (np.abs(x).max(axis=1) / np.float32(127.0)).astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):   # where() drops
        inv = np.where(scale > 0, np.float32(1.0) / scale,   # 1 / 0
                       np.float32(0.0)).astype(np.float32)
        q = np.clip(np.rint(x * inv[:, None]), -127, 127).astype(np.int8)
    return q, scale


def _np_dequantize_rows(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    return q.astype(np.float32) * scale[:, None].astype(np.float32)


class StreamStats(typing.NamedTuple):
    retire_t: list    # perf_counter stamp when round r's scatter landed
    stall_s: list     # host seconds blocked on the device for round r


class _Leg:
    """One leg of the stream's staging on a CUDA device: ``n`` slots used
    in turn (round r takes slot r % n), each a set of named pairs of a
    pinned host buffer and a device buffer (allocated at first use), copied
    on the leg's own stream.

    * ``host(r, name, shape, dtype)``: slot r's host buffer, once the
      slot's last copy has run (the host may then overwrite it);
    * ``up(r)``: copies slot r's host buffers to its device buffers, after
      the main stream's last read of them (``read(r)``);
    * ``down(r, tensors)``: snapshots device tensors into slot r's device
      buffers on the main stream (a graph's outputs are overwritten by its
      next replay), then copies them to its host buffers.
    ``up`` and ``down`` return the event after their copies."""

    def __init__(self, n: int, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.bufs: list[dict] = [{} for _ in range(n)]
        self.copied: list = [None] * n
        self.reads: list = [None] * n

    def _pair(self, r: int, name: str, shape, dtype):
        slot = self.bufs[r % len(self.bufs)]
        pair = slot.get(name)
        if pair is None or tuple(pair[0].shape) != tuple(shape) \
                or pair[0].dtype != dtype:
            pair = slot[name] = (
                torch.empty(shape, dtype=dtype, pin_memory=True),
                torch.empty(shape, dtype=dtype, device=self.device))
        return pair

    def _free(self, r: int) -> None:
        ev = self.copied[r % len(self.copied)]
        if ev is not None:
            ev.synchronize()

    def host(self, r: int, name: str, shape, dtype) -> torch.Tensor:
        self._free(r)
        return self._pair(r, name, shape, dtype)[0]

    def _record(self, r: int):
        ev = torch.cuda.Event()
        ev.record(self.stream)
        self.copied[r % len(self.copied)] = ev
        return ev

    def up(self, r: int) -> tuple[dict, typing.Any]:
        i = r % len(self.bufs)
        with torch.cuda.stream(self.stream):
            if self.reads[i] is not None:
                self.stream.wait_event(self.reads[i])
            for host, dev in self.bufs[i].values():
                dev.copy_(host, non_blocking=True)
            ev = self._record(r)
        return {k: dev for k, (_, dev) in self.bufs[i].items()}, ev

    def read(self, r: int) -> None:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        self.reads[r % len(self.reads)] = ev

    def down(self, r: int, tensors: dict) -> tuple[dict, typing.Any]:
        self._free(r)
        pairs = {k: self._pair(r, k, t.shape, t.dtype)
                 for k, t in tensors.items()}
        for k, t in tensors.items():
            pairs[k][1].copy_(t)
        made = torch.cuda.Event()
        made.record(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            self.stream.wait_event(made)
            for host, dev in pairs.values():
                host.copy_(dev, non_blocking=True)
            ev = self._record(r)
        return {k: host for k, (host, _) in pairs.items()}, ev


_ROWS = ("d", "o", "res", "q", "s")     # the row entries of a round's I/O


def stream_cohort_rounds(eng, shared, backend, schedule: np.ndarray,
                         batch_fn, *, async_rounds: int = 0,
                         prefetch: bool = True, wts: np.ndarray | None = None,
                         round_base: int = 0, stage_codec: str = "none"):
    """Double-buffered streaming driver over a rows engine
    (``make_cohort_rows_engine``), one dispatch per round; the per-user
    rows live in ``backend`` and only the scheduled cohort's C rows cross
    the host <-> device boundary.

    ``round_base`` is the GLOBAL index of ``schedule[0]``'s round: ages are
    computed, and ``last_round`` stamped, against global rounds (a member
    that trained through round r has ``last_round == r + 1``, 0 = never).

    * ``prefetch``: round k+1's data is sampled and sent while round k
      computes; else after round k retires.
    * ``async_rounds == 0``: round k's rows are fetched and scattered back
      before round k+1's are gathered, so every gather sees the whole
      store.  ``async_rounds == S > 0`` (bounded staleness): up to S rounds
      stay in flight, round k+1's rows are gathered from the store as it
      is, scatter is last-writer-wins, and ``last_round`` stamps landed
      rounds only, so the ages include the pipeline lag.
    * ``stage_codec="int8"`` (``stage_rows``): the D rows cross quantized,
      int8 plus a per-row scale each way: host numpy quantizer, device
      dequantize (B2) on the way in; device quantize (B2), host numpy
      dequantizer on the way out.  Optimizer and residual rows stay f32.

    On a CUDA device with a host store, the rows and the batch go up, and
    the updated rows and metrics come down, through pinned slots on copy
    streams of their own (``_Leg``, ``async_rounds + 2`` slots each), so no
    slot is rewritten while a copy or a round that reads it is in flight;
    the host waits only on events.  A device store's rows stay on the
    device.

    Returns ``(shared, metrics, stats)``: per-round numpy metric dicts and
    a ``StreamStats``: ``retire_t[r]`` when round r's scatter landed,
    ``stall_s[r]`` the host seconds spent waiting for round r's outputs."""
    steps = len(schedule)
    metrics_out: list = [None] * steps
    stats = StreamStats([0.0] * steps, [0.0] * steps)
    inflight: collections.deque = collections.deque()
    dev = shared.step.device
    cuda = dev.type == "cuda"
    has_res = backend.has_residual
    resident = backend.device_resident
    if stage_codec != "none":
        assert stage_codec == "int8", stage_codec
    # a device store's rows never cross the boundary: nothing to shrink
    stage_q = stage_codec != "none" and not resident
    legs = None
    if cuda and not resident:
        n = async_rounds + 2
        legs = {"rows": _Leg(n, dev), "data": _Leg(n, dev), "down": _Leg(
            n, dev)}

    def stage_rows(r):
        """Round r's rows, ages and weights on the device, and the event
        after their copy (None where nothing is copied)."""
        idx = schedule[r]
        if legs is None:
            d, o, last = backend.gather_rows(idx)
            out = {"d": d, "o": o,
                   "ages": (round_base + r - last).to(torch.int32)}
            if has_res:
                out["res"] = backend.gather_residual(idx)
            if stage_q:
                q, s = _np_quantize_rows(out.pop("d").numpy())
                out["q"], out["s"] = torch.from_numpy(q), torch.from_numpy(s)
            if wts is not None:
                out["w"] = torch.from_numpy(np.asarray(wts[r], np.float32))
            return {k: v.to(dev) for k, v in out.items()}, None
        leg = legs["rows"]
        c, (nd, no) = len(idx), (backend.d_flat.shape[1],
                                 backend.opt_flat.shape[1])
        host = lambda name, shape, dt=torch.float32: leg.host(r, name, shape,
                                                              dt)
        ho = host("o", (c, no))
        if stage_q:
            d, _, last = backend.gather_rows(idx, out=(None, ho))
            q, s = _np_quantize_rows(d.numpy())
            host("q", (c, nd), torch.int8).copy_(torch.from_numpy(q))
            host("s", (c,)).copy_(torch.from_numpy(s))
        else:
            _, _, last = backend.gather_rows(idx,
                                             out=(host("d", (c, nd)), ho))
        if has_res:
            backend.gather_residual(idx, out=host("res", (c, nd)))
        host("ages", (c,), torch.int32).copy_(round_base + r - last)
        if wts is not None:
            host("w", (c,)).copy_(torch.from_numpy(
                np.asarray(wts[r], np.float32)))
        return leg.up(r)

    def stage_data(r):
        batch = np.asarray(batch_fn(r), np.float32)
        if legs is None:
            return torch.from_numpy(batch).to(dev), None
        legs["data"].host(r, "x", batch.shape, torch.float32).numpy()[...] \
            = batch
        out, ev = legs["data"].up(r)
        return out["x"], ev

    def retire(keep: int):
        while len(inflight) > keep:
            rr, idx, (out, ev) = inflight.popleft()
            t0 = time.perf_counter()
            if ev is not None:
                ev.synchronize()
            mets = {k: v.cpu().numpy().copy() for k, v in out.items()
                    if k not in _ROWS}
            stats.stall_s[rr] = time.perf_counter() - t0
            d = out.get("d")
            if stage_q:
                d = torch.from_numpy(_np_dequantize_rows(out["q"].numpy(),
                                                         out["s"].numpy()))
            backend.scatter_rows(idx, d, out["o"], round_base + rr + 1,
                                 residual=out.get("res"))
            metrics_out[rr] = mets
            stats.retire_t[rr] = time.perf_counter()

    rows, rows_ev = stage_rows(0)
    data, data_ev = stage_data(0)
    for r in range(steps):
        if cuda:
            for ev in (rows_ev, data_ev):
                if ev is not None:
                    torch.cuda.current_stream(dev).wait_event(ev)
        d_in = (kops.dequantize_rows(rows["q"], rows["s"]) if stage_q
                else rows["d"])
        extra = (rows["res"],) if has_res else ()
        shared, nd, no, *rest = eng(shared, d_in, rows["o"], *extra,
                                    rows["ages"], rows.get("w"), data)
        if legs is not None:
            legs["rows"].read(r)
            legs["data"].read(r)
        out = dict(rest[-1], o=no)
        if stage_q:
            out["q"], out["s"] = kops.quantize_rows(nd)
        else:
            out["d"] = nd
        if has_res:
            out["res"] = rest[0]
        if legs is not None:
            pending = legs["down"].down(r, out)
        elif cuda:       # a device store on the card: the graph's outputs
            pending = ({k: v.clone() for k, v in out.items()}, None)
        else:            # are overwritten by its next replay
            pending = (out, None)
        inflight.append((r, np.asarray(schedule[r]), pending))
        last = r + 1 == steps
        if prefetch and not last:
            data, data_ev = stage_data(r + 1)   # overlaps round r's compute
        # sync: waits for round r itself, so the gather below sees the
        # whole store; async (S > 0): waits only for rounds <= r - S
        retire(async_rounds)
        if not last:
            rows, rows_ev = stage_rows(r + 1)
        if not prefetch and not last:
            data, data_ev = stage_data(r + 1)   # serialized staging
    retire(0)
    return shared, metrics_out, stats


class SuperbatchStats(typing.NamedTuple):
    win_retire_t: list   # perf_counter stamp when window w's scatter landed
    win_stall_s: list    # host seconds blocked on the device for window w
    win_rounds: list     # rounds in window w


def superbatch_cohort_rounds(eng, shared, backend, schedule: np.ndarray,
                             batch_fn, *, rounds_per_jit: int,
                             wts: np.ndarray | None = None,
                             round_base: int = 0, prefetch: bool = True):
    """Windowed driver over ``make_superbatch_engine``: per window of up to
    ``rounds_per_jit`` rounds, gather the scheduled rows as one ``(K, C,
    N)`` block, plan the in-window repeats (``window_forwarding``, from the
    current ``last_round``: every earlier window's scatter has landed),
    dispatch the window once, wait once for its blocks and scatter them
    back in round order (last writer wins, ``last_round`` stamped per
    round).  With ``prefetch`` the next window's batches are sampled while
    this one runs.  The last window may be shorter (on the card a graph of
    its own length); a repeat across windows reads from the host the bytes
    the in-window forward would have read, so windowing does not change
    the trajectory.

    On a CUDA device the blocks are gathered into pinned buffers (one set
    per window length), copied up as the graph's inputs and copied back
    into the same buffers after the replay on the same stream.  Returns
    ``(shared, metrics, stats)`` with per-window ``SuperbatchStats`` (the
    stall is the one wait for a window's blocks)."""
    steps = len(schedule)
    metrics_out: list = [None] * steps
    stats = SuperbatchStats([], [], [])
    dev = shared.step.device
    cuda = dev.type == "cuda"
    has_res = backend.has_residual
    widths = [backend.d_flat.shape[1], backend.opt_flat.shape[1]]
    if has_res:
        widths.append(backend.d_flat.shape[1])
    blocks_of: dict = {}
    data_bufs: dict = {}

    def blocks(k, c):
        if k not in blocks_of:
            blocks_of[k] = [torch.empty((k, c, w), dtype=torch.float32,
                                        pin_memory=cuda) for w in widths]
        return blocks_of[k]

    def stage_data(start, k, turn):
        first = np.asarray(batch_fn(start), np.float32)
        key = (k, turn % 2)
        if key not in data_bufs:
            data_bufs[key] = torch.empty((k,) + first.shape,
                                         dtype=torch.float32, pin_memory=cuda)
        buf = data_bufs[key]
        host = buf.numpy()
        host[0] = first
        for j in range(1, k):
            host[j] = batch_fn(start + j)
        return buf

    data, i, turn = None, 0, 0
    while i < steps:
        k = min(rounds_per_jit, steps - i)
        sched = np.asarray(schedule[i:i + k])
        fwd, ages = window_forwarding(sched, backend.last_round.numpy(),
                                      round_base + i)
        blks = blocks(k, sched.shape[1])
        for r in range(k):
            backend.gather_rows(sched[r], out=(blks[0][r], blks[1][r]))
            if has_res:
                backend.gather_residual(sched[r], out=blks[2][r])
        if data is None:
            data = stage_data(i, k, turn)
        w = None if wts is None else torch.from_numpy(
            np.asarray(wts[i:i + k], np.float32))
        shared, *outs, m = eng(shared, *blks, torch.from_numpy(fwd),
                               torch.from_numpy(ages), data, wts=w)
        if cuda:
            for host, out in zip(blks, outs):
                host.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(dev))
        turn += 1
        data = None
        if prefetch and i + k < steps:
            data = stage_data(i + k, min(rounds_per_jit, steps - i - k), turn)
        t0 = time.perf_counter()
        if cuda:
            done.synchronize()             # THE stall
        mets = _fetch(m)
        stats.win_stall_s.append(time.perf_counter() - t0)
        for r in range(k):
            backend.scatter_rows(sched[r], blks[0][r], blks[1][r],
                                 round_base + i + r + 1,
                                 residual=blks[2][r] if has_res else None)
            metrics_out[i + r] = {key: v[r] for key, v in mets.items()}
        stats.win_retire_t.append(time.perf_counter())
        stats.win_rounds.append(k)
        i += k
    return shared, metrics_out, stats



# ---------------------------------------------------------------------------
# Backend drivers
# ---------------------------------------------------------------------------

class DeviceBackendDriver:
    """Device-resident state: under full participation the chunked
    ``fused`` engine, or the ``per_step`` loop that stages data, runs and
    fetches metrics one round at a time (the comparison target); for a
    cohort-virtualized spec the cohort engine over a resident store
    (``fuse_store_rounds`` picks the engine that writes the store in
    place).  A backend driver is built as ``driver_cls(session,
    defer_state=False)`` and offers ``run``, ``arrays``, ``load_arrays``,
    ``generator_params`` and ``user_d_flat``.

    ``arrays()`` is the checkpointable state: the reference's
    ``DistGANState`` (or ``CohortState``) fields in order as a list, the
    PRNG key slot holding the round-noise generator's state.
    ``defer_state=True`` (the restore path) builds no initial state:
    ``arrays()`` then returns meta tensors of the state's shapes and
    types, and ``load_arrays`` builds the state from the restored arrays,
    so no CUDA graph has bound to a carry yet."""

    def __init__(self, sess: "FederationSession", defer_state: bool = False):
        self.sess = sess
        pair, fcfg, sp = sess.pair, sess.fcfg, sess.spec
        sync = sess.approach.sync_ds
        if sess.cohort_virtual:
            self.mode = "cohort"
            self.fused_store = sp.engine.fuse_store_rounds
            mk = (make_fused_store_engine if self.fused_store
                  else make_cohort_engine)
            self.eng = mk(pair, fcfg, sp.approach,
                          adaptive=sp.combine.adaptive_server_scale)
            init = init_cohort_state
        else:
            self.mode = sp.engine.kind
            # per_step runs the same engine one round at a time: on the
            # card a one-round graph, fetched after every round
            self.eng = make_engine(pair, fcfg, sp.approach)
            init = init_state
        self.state = None if defer_state else init(
            pair, fcfg, sp.seed, sess.device, sync_ds=sync)

    # -- checkpoint state --------------------------------------------------

    def arrays(self) -> list:
        st = self.state
        if st is None:
            mk = (cohort_state_template if self.mode == "cohort"
                  else state_template)
            st = mk(self.sess.pair, self.sess.fcfg)
        if self.mode == "cohort":
            s = st.store
            mid = [[s.d_flat, s.opt_flat, s.last_round, s.residual]]
        else:
            mid = [st.ds, st.d_opts]
        return [st.g, st.g_opt, *mid, st.server_d, st.step,
                st.generator.get_state()]

    def load_arrays(self, tree: list, generator: torch.Generator) -> None:
        """Build the deferred state from restored arrays (``arrays()``'s
        structure, CPU tensors; the key slot is not read) and the
        round-noise generator."""
        assert self.state is None, "load_arrays builds a deferred state"
        tree = _tree_to(tree[:-1], self.sess.device)
        if self.mode == "cohort":
            g, g_opt, store, server_d, step = tree
            self.state = CohortState(g, g_opt, CohortStore(*store), server_d,
                                     step, generator)
        else:
            self.state = DistGANState(*tree, generator)

    def generator_params(self):
        return self.state.g

    def user_d_flat(self, user_id: int) -> np.ndarray:
        if self.mode == "cohort":
            return self.state.store.d_flat[user_id].cpu().numpy()
        row = tree_map(lambda x: x[user_id], self.state.ds)
        return d_flat_layout(self.sess.pair).flatten(row).cpu().numpy()

    def run(self, rounds: int) -> RunResult:
        if self.mode == "cohort":
            return self._run_cohort(rounds)
        if self.mode == "fused":
            return self._run_fused(rounds)
        return self._run_per_step(rounds)

    def _result(self, g_losses, d_losses, kept, compile_s, steady,
                step_denom, min_step_s, engine) -> RunResult:
        sess = self.sess
        state = (cohort_state_to_full(sess.pair, sess.fcfg, self.state)
                 if self.mode == "cohort" else self.state)
        return RunResult(
            g_losses=g_losses, d_losses=d_losses,
            wall_time_s=compile_s + steady,
            step_time_s=steady / step_denom,
            samples=sess._eval_samples(self.state.g),
            state=state,
            extra={"compile_s": compile_s, "kept_frac": float(kept[-1]),
                   "engine": engine, "min_step_time_s": min_step_s,
                   "device": str(sess.device),
                   **_upload_accounting(sess.pair, sess.fcfg,
                                        sess.spec.approach,
                                        sess.cohort_size,
                                        float(np.mean(kept)))})

    def _stager(self, batch_round, rounds: int, round_nbytes: int):
        return _Stager(batch_round, rounds, round_nbytes,
                       self.sess.spec.engine.rounds_per_jit,
                       self.sess.device)

    def _run_fused(self, rounds: int) -> RunResult:
        sess = self.sess
        reals = self._stager(lambda r: sess._batch_full(), rounds,
                             sess._probe_nbytes_full())

        def run_chunk(start: int, k: int, state):
            state, m = self.eng(state, reals.get(start, k))
            reals.after(start, k)
            return state, _fetch(m)        # one host sync per chunk

        return self._run_chunks(run_chunk, rounds)[0]

    def _run_chunks(self, run_chunk, rounds: int):
        """Drive a window chunk by chunk; returns its ``RunResult`` and the
        concatenation of one metric over the window."""
        rpj = self.sess.spec.engine.rounds_per_jit
        self.state, chunks, compile_s, steady, rates = _drive_chunks(
            run_chunk, self.state, rounds, rpj, self.sess.device)
        cat = lambda key: np.concatenate([c[key] for c in chunks])
        step_denom = max(rounds - rpj, 1)
        res = self._result(cat("g_loss"), cat("d_loss"), cat("kept_frac"),
                           compile_s, steady, step_denom,
                           min(rates) if rates else steady / step_denom,
                           "fused")
        return res, cat

    def _run_per_step(self, rounds: int) -> RunResult:
        sess = self.sess
        state = self.state
        g_list, d_list, kept = [], [], []

        def one(state):
            real = torch.from_numpy(sess._batch_full()).to(sess.device)
            state, m = self.eng(state, real[None])
            m = _fetch(m)
            g_list.append(float(m["g_loss"][0]))
            d_list.append(m["d_loss"][0])
            kept.append(float(m["kept_frac"][0]))
            return state

        t0 = time.perf_counter()
        state = one(state)
        compile_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        round_times = []
        for _ in range(1, rounds):
            tr = time.perf_counter()
            state = one(state)
            round_times.append(time.perf_counter() - tr)
        _sync(sess.device)
        steady = time.perf_counter() - t1
        self.state = state
        step_denom = max(rounds - 1, 1)
        return self._result(np.asarray(g_list), np.stack(d_list),
                            np.asarray(kept), compile_s, steady, step_denom,
                            min(round_times) if round_times else steady,
                            "per_step")

    def _run_cohort(self, rounds: int) -> RunResult:
        """A cohort-virtualized window: U logical users, C-wide rounds.
        The schedule comes from the session's scheduler stream; each
        round's batches are drawn for the cohort's users only, in schedule
        order, from ``data_rng``."""
        sess = self.sess
        U, C = sess.fcfg.num_users, sess.cohort_size
        schedule = sess._next_schedule(rounds)
        wts = sess._next_weights(schedule)
        reals = self._stager(lambda r: sess._batch_cohort(schedule[r]),
                             rounds, sess._probe_nbytes_cohort(schedule))
        sched_dev = torch.from_numpy(schedule.astype(np.int64)).to(
            sess.device)
        wts_dev = None if wts is None else torch.from_numpy(wts).to(
            sess.device)

        def run_chunk(start: int, k: int, cstate):
            w = None if wts_dev is None else wts_dev[start:start + k]
            cstate, m = self.eng(cstate, reals.get(start, k),
                                 sched_dev[start:start + k], wts=w)
            reals.after(start, k)
            return cstate, _fetch(m)       # one host sync per chunk

        res, cat = self._run_chunks(run_chunk, rounds)
        staleness = (sess.round + rounds
                     - self.state.store.last_round.cpu().numpy())
        res.extra.update({
            "participation": sess.spec.participation.scheduler,
            "cohort_size": C, "schedule": schedule,
            "participation_counts": np.bincount(schedule.ravel(),
                                                minlength=U),
            "staleness": staleness, "mean_age": cat("mean_age"),
            "state_backend": "device", "fused_store": self.fused_store,
            "adaptive_server_scale":
                sess.spec.combine.adaptive_server_scale,
            **({"participation_weights": wts} if wts is not None else {})})
        return res


register_backend("device", DeviceBackendDriver, streams=False)


class HostStreamDriver:
    """Host-resident streamed state: the (U, N) store lives in host memory
    (``HostStateBackend``, pinned on the card) and every round moves
    exactly C rows each way, so a round's cost does not depend on U, which
    host RAM bounds instead of device memory.

    ``fuse_store_rounds`` runs the superbatch engine (one dispatch per
    window of ``rounds_per_jit`` rounds) where the stream is synchronous;
    under ``async_rounds > 0`` or ``stage_rows`` the request falls back to
    the per-round stream and ``extra["fused_store"]`` is False, as in the
    reference.  ``arrays()`` is the reference's checkpoint layout: a dict
    of ``shared`` (the ``CohortShared`` fields, the PRNG slot last holding
    the round-noise generator's state), ``d_flat``, ``opt_flat``,
    ``last_round`` and, with error feedback, ``residual``."""

    backend_name = "host"

    def __init__(self, sess, defer_state: bool = False):
        self.sess = sess
        pair, fcfg, sp = sess.pair, sess.fcfg, sess.spec
        self.shared, self.backend = (None, None) if defer_state else \
            init_host_backend(pair, fcfg, sp.seed, sess.device,
                              sync_ds=sess.approach.sync_ds)
        self.eng = self._make_engine()
        # store-row staging and superbatch windows belong to the host
        # backend; the spmd driver maps each round's rows onto the mesh, so
        # a request for either falls back to the plain per-round stream
        # (as in the reference)
        self.stage_rows = (sp.combine.compression.stage_rows
                           and self.backend_name == "host")
        self.fused_store = (sp.engine.fuse_store_rounds
                            and self.backend_name == "host"
                            and sp.backend.async_rounds == 0
                            and not self.stage_rows)
        self.win_eng = None
        if self.fused_store:
            self.win_eng = make_superbatch_engine(
                pair, fcfg, sp.approach,
                adaptive=sp.combine.adaptive_server_scale)

    def _make_engine(self):
        return make_cohort_rows_engine(self.sess.pair, self.sess.fcfg,
                                       self.sess.spec.approach)

    # -- checkpoint state --------------------------------------------------

    def arrays(self) -> dict:
        pair, fcfg = self.sess.pair, self.sess.fcfg
        if self.backend is None:
            sh = shared_template(pair, fcfg)
            u = fcfg.num_users
            nd, no = d_flat_layout(pair).n, d_opt_flat_layout(pair, fcfg).n
            meta = lambda *shape, dt=torch.float32: torch.empty(
                shape, dtype=dt, device="meta")
            store = [meta(u, nd), meta(u, no), meta(u, dt=torch.int32),
                     meta(u, nd) if _wants_residual(fcfg) else None]
        else:
            sh, b = self.shared, self.backend
            store = [b.d_flat, b.opt_flat, b.last_round, b.residual]
        out = {"shared": [sh.g, sh.g_opt, sh.server_d, sh.step,
                          sh.generator.get_state()],
               "d_flat": store[0], "opt_flat": store[1],
               "last_round": store[2]}
        if store[3] is not None:
            out["residual"] = store[3]
        return out

    def load_arrays(self, tree: dict, generator: torch.Generator) -> None:
        assert self.backend is None, "load_arrays builds a deferred state"
        g, g_opt, server_d, step = _tree_to(tree["shared"][:-1],
                                            self.sess.device)
        self.shared = CohortShared(g, g_opt, server_d, step, generator)
        self.backend = HostStateBackend(
            tree["d_flat"], tree["opt_flat"], tree["last_round"],
            tree.get("residual"), pin=self.sess.device.type == "cuda")

    def generator_params(self):
        return self.shared.g

    def user_d_flat(self, user_id: int) -> np.ndarray:
        return self.backend.gather_rows([user_id])[0][0].numpy()

    # -- execution ---------------------------------------------------------

    def run(self, rounds: int) -> RunResult:
        sess = self.sess
        sp = sess.spec
        U, C = sess.fcfg.num_users, sess.cohort_size
        schedule = sess._next_schedule(rounds)
        wts = sess._next_weights(schedule)
        batch_round = lambda r: sess._batch_cohort(schedule[r])
        t0 = time.perf_counter()
        if self.fused_store:
            rpj = sp.engine.rounds_per_jit
            self.shared, mets, ws = superbatch_cohort_rounds(
                self.win_eng, self.shared, self.backend, schedule,
                batch_round, rounds_per_jit=rpj, wts=wts,
                round_base=sess.round, prefetch=sp.backend.prefetch)
            # the first window carries the graphs' capture; full windows
            # after it give the steady rate; a round's stall is its
            # window's one wait over the window's rounds
            wr = ws.win_retire_t
            compile_s = wr[0] - t0
            steady = wr[-1] - wr[0] if len(wr) > 1 else 0.0
            step_denom = max(rounds - ws.win_rounds[0], 1)
            rates = [(wr[j] - wr[j - 1]) / ws.win_rounds[j]
                     for j in range(1, len(wr)) if ws.win_rounds[j] == rpj]
            min_step_s = min(rates) if rates else steady / step_denom
            post = [s / k for s, k in zip(ws.win_stall_s[1:],
                                          ws.win_rounds[1:])]
            host_stall = (float(np.mean(post)) if post
                          else ws.win_stall_s[0] / ws.win_rounds[0])
        else:
            self.shared, mets, st = stream_cohort_rounds(
                self.eng, self.shared, self.backend, schedule, batch_round,
                async_rounds=sp.backend.async_rounds,
                prefetch=sp.backend.prefetch, wts=wts,
                round_base=sess.round,
                stage_codec="int8" if self.stage_rows else "none")
            rt = st.retire_t
            compile_s = rt[0] - t0
            steady = rt[-1] - rt[0] if rounds > 1 else 0.0
            step_denom = max(rounds - 1, 1)
            # steady per-round: the least mean over sliding windows of
            # retire stamps (robust to the first round and to load spikes)
            W = max(1, min(8, (rounds - 1) // 2))
            rates = [(rt[i + W] - rt[i]) / W for i in range(1, rounds - W)]
            min_step_s = min(rates) if rates else steady / step_denom
            # host seconds blocked on the device per steady round: the
            # first round and the end-of-run drain (the last async_rounds
            # retires wait by construction) left out
            host_stall = (float(np.mean(
                st.stall_s[1:max(rounds - sp.backend.async_rounds, 2)]))
                if rounds > 1 else 0.0)

        kept = np.asarray([float(m["kept_frac"]) for m in mets])
        state = None
        if sp.backend.materialize_state:
            # the (U, N) store unpacked into the stacked layout on the
            # session's device: opt out where U exceeds device memory
            store = CohortStore(*(None if t is None else t.to(sess.device)
                                  for t in dataclasses.astuple(
                                      self.backend.snapshot())))
            state = cohort_state_to_full(sess.pair, sess.fcfg, CohortState(
                self.shared.g, self.shared.g_opt, store,
                self.shared.server_d, self.shared.step,
                self.shared.generator))
        res = RunResult(
            g_losses=np.asarray([float(m["g_loss"]) for m in mets]),
            d_losses=np.stack([np.asarray(m["d_loss"]) for m in mets]),
            wall_time_s=compile_s + steady,
            step_time_s=steady / step_denom,
            samples=sess._eval_samples(self.shared.g),
            state=state,
            extra={"compile_s": compile_s, "kept_frac": float(kept[-1]),
                   "engine": "fused", "min_step_time_s": min_step_s,
                   "device": str(sess.device),
                   "participation": sp.participation.scheduler,
                   "cohort_size": C, "schedule": schedule,
                   "participation_counts": np.bincount(schedule.ravel(),
                                                       minlength=U),
                   "staleness": (sess.round + rounds
                                 - self.backend.last_round.numpy()),
                   "mean_age": np.asarray([float(m["mean_age"])
                                           for m in mets]),
                   "state_backend": self.backend_name,
                   "host_backend": self.backend,
                   "async_rounds": sp.backend.async_rounds,
                   "prefetch": sp.backend.prefetch,
                   "fused_store": self.fused_store,
                   "host_stall_s_per_round": host_stall,
                   "adaptive_server_scale":
                       sp.combine.adaptive_server_scale,
                   **({"participation_weights": wts}
                      if wts is not None else {}),
                   **_upload_accounting(sess.pair, sess.fcfg, sp.approach,
                                        C, float(np.mean(kept)),
                                        stage_rows=self.stage_rows)})
        return res


register_backend("host", HostStreamDriver, streams=True)


# ---------------------------------------------------------------------------
# The session
# ---------------------------------------------------------------------------

class FederationSession:
    """Incrementally driven federation run described by a
    :class:`FederationSpec`.  ``fcfg.combiner`` / ``staleness_decay`` and
    the codec fields are overridden by the spec's :class:`CombineSpec`.
    ``device`` is CUDA unless the caller passes ``"cpu"``.

    ``mesh`` (a ``launch.mesh.UsersMesh``) is required by the mesh-mapped
    ``spmd`` backend and ignored otherwise; every rank of the mesh builds
    the same session and runs it in step, on the mesh's device (``device``
    may be left out), and rank 0 writes the checkpoints."""

    def __init__(self, pair, fcfg: DistGANConfig, dataset,
                 spec: FederationSpec, *, device=None, mesh=None,
                 _defer_state=False):
        spec.validate_against(fcfg.num_users)
        if mesh is not None:
            if device is not None and resolve_device(device) != mesh.device:
                raise ValueError(f"device {device!r} differs from the "
                                 f"mesh's {mesh.device}")
            device = mesh.device
        self.device = resolve_device(device)
        self.mesh = mesh
        self.pair = pair
        self.dataset = dataset
        self.spec = spec
        comp = spec.combine.compression
        if comp.codec == "topk_int8" and fcfg.selection not in (
                "topk", "threshold"):
            raise ValueError(
                f"codec='topk_int8' composes int8 transport with a sparse "
                f"selection, but fcfg.selection={fcfg.selection!r} keeps a "
                f"dense/random payload — use codec='int8' instead")
        self.fcfg = dataclasses.replace(
            fcfg, combiner=spec.combine.combiner,
            staleness_decay=spec.combine.staleness_decay,
            codec=comp.codec, error_feedback=comp.error_feedback,
            codec_stochastic=comp.stochastic, stage_rows=comp.stage_rows)
        self.approach = resolve_approach(spec.approach)
        self.round = 0
        self.data_rng = np.random.default_rng(spec.seed)
        # a SEPARATE stream for the scheduler, so data sampling consumes
        # data_rng exactly as the full-participation path does (C == U
        # under "full" is then bitwise the plain fused engine)
        self.sched_rng = np.random.default_rng([spec.seed, 0x5EED])
        shard_sizes = None
        if dataset is not None and isinstance(dataset.meta, dict):
            shard_sizes = dataset.meta.get("shard_sizes")
        self._schedule_window = make_schedule_source(
            spec.participation.scheduler, fcfg.num_users,
            spec.cohort_size_for(fcfg.num_users), shard_sizes)
        self._part_counts = (np.zeros(fcfg.num_users, np.float64)
                             if spec.combine.adaptive_server_scale else None)
        self._probe_nbytes: int | None = None
        self._eval_override: int | None = None
        self._mid_window = False
        self._driver = resolve_backend(spec.backend.kind).driver_cls(
            self, defer_state=_defer_state)

    @property
    def cohort_virtual(self) -> bool:
        return self.spec.cohort_virtual

    @property
    def cohort_size(self) -> int:
        return self.spec.cohort_size_for(self.fcfg.num_users)

    # -- host-side sampling ------------------------------------------------

    def _batch_full(self) -> np.ndarray:
        """One full-participation round of data: (U, B, ...) per-user
        batches drawn from ``data_rng`` user by user, or a (B, ...) union
        batch for an approach without a user axis; f32 (the reference's
        arrays are f32)."""
        B = self.spec.batch_size
        if not self.approach.user_axis:
            batch = self.dataset.union_sampler(self.data_rng, B)
        else:
            batch = np.stack([np.asarray(self.dataset.user_batch(
                u, self.data_rng, B)) for u in range(self.fcfg.num_users)])
        return np.asarray(batch).astype(np.float32, copy=False)

    def _probe(self, sample) -> int:
        """nbytes of one round's batch, sampled from a throwaway rng so the
        real data stream is untouched (cached — shapes are fixed)."""
        if self._probe_nbytes is None:
            saved = self.data_rng
            self.data_rng = np.random.default_rng(self.spec.seed)
            try:
                self._probe_nbytes = int(sample().nbytes)
            finally:
                self.data_rng = saved
        return self._probe_nbytes

    def _probe_nbytes_full(self) -> int:
        return self._probe(self._batch_full)

    def _batch_cohort(self, users) -> np.ndarray:
        """One cohort round of data: (C, B, ...) batches of ``users`` in
        schedule order, drawn from ``data_rng``, as f32."""
        B = self.spec.batch_size
        return np.stack([np.asarray(self.dataset.user_batch(
            int(u), self.data_rng, B)) for u in users]).astype(
                np.float32, copy=False)

    def _probe_nbytes_cohort(self, schedule) -> int:
        return self._probe(lambda: self._batch_cohort(schedule[0]))

    # -- schedule / weights windows ----------------------------------------

    def _next_schedule(self, rounds: int) -> np.ndarray:
        """The next ``rounds`` rows of the cohort schedule, drawn from the
        scheduler stream at the session's global round: windows
        concatenate to the single-shot schedule."""
        return self._schedule_window(self.sched_rng, self.round, rounds)

    def _next_weights(self, schedule) -> np.ndarray | None:
        if self._part_counts is None:
            return None
        return participation_weights(schedule, self.fcfg.num_users,
                                     counts=self._part_counts,
                                     start_round=self.round)

    def _eval_samples(self, g_params) -> np.ndarray | None:
        n = (self.spec.eval_samples if self._eval_override is None
             else self._eval_override)
        if not n:
            return None
        gen = torch.Generator().manual_seed(self.spec.seed + 1)
        with torch.no_grad(), deterministic_convolutions():
            z = self.pair.sample_z(gen, n, self.device)
            return self.pair.g_apply(g_params, z).cpu().numpy()

    # -- serve handles -----------------------------------------------------

    def generator_params(self):
        """The live generator parameter dict."""
        return self._driver.generator_params()

    def user_d_flat(self, user_id: int) -> np.ndarray:
        """User ``user_id``'s flat (Nd,) discriminator row (FlatLayout
        order)."""
        if not 0 <= int(user_id) < self.fcfg.num_users:
            raise ValueError(f"user_id {user_id} out of range "
                             f"[0, {self.fcfg.num_users})")
        return self._driver.user_d_flat(int(user_id))

    # -- execution ---------------------------------------------------------

    def run(self, rounds: int, *, eval_samples: int | None = None,
            autosave_every: int | None = None,
            autosave_path: str | None = None) -> RunResult:
        """Advance the federation by ``rounds`` rounds and return the
        window's RunResult.  ``eval_samples`` overrides the spec's value
        for this window only.

        ``autosave_every=N`` (with ``autosave_path``) saves the session
        (:meth:`save`) every N rounds at internal window boundaries and at
        the end: windowing does not change the trajectory, so a run killed
        mid-way restores from its last autosave onto the uninterrupted
        trajectory.  Samples are drawn on the final sub-window only; the
        result is the merged window."""
        assert isinstance(rounds, int) and rounds >= 1, rounds
        if autosave_every is None:
            return self._run_window(rounds, eval_samples)
        if not isinstance(autosave_every, int) or autosave_every < 1:
            raise ValueError(f"autosave_every must be a positive int, got "
                             f"{autosave_every!r}")
        if not autosave_path:
            raise ValueError("autosave_every needs an autosave_path to "
                             "save into")
        parts, done = [], 0
        while done < rounds:
            k = min(autosave_every, rounds - done)
            last = done + k == rounds
            parts.append(self._run_window(k, eval_samples if last else 0))
            done += k
            self.save(autosave_path)
        return _merge_results(parts)

    def _run_window(self, rounds: int,
                    eval_samples: int | None) -> RunResult:
        self._eval_override = eval_samples
        self._mid_window = True
        try:
            result = self._driver.run(rounds)
        finally:
            self._eval_override = None
        # only on success: a failure leaves the rng streams, counts and
        # carry partly advanced, and save() must refuse
        self._mid_window = False
        self.round += rounds
        return result

    # -- checkpoint / restore ----------------------------------------------

    def save(self, path: str) -> str:
        """Checkpoint the session under directory ``path``: the state's
        arrays as ``step_<round>.msgpack`` and ``session.json`` with the
        spec, the round, the numpy streams and the participation counts
        (the reference's keys).  Reading the carry waits for the device.

        Refuses after a ``run()`` that raised mid-window: its streams,
        counts and carry are then partly advanced past the round counter,
        and a checkpoint of them would restore a silently wrong
        trajectory."""
        if self._mid_window:
            raise RuntimeError(
                "session state is inconsistent: the last run() raised "
                "mid-window (rng streams/carry advanced past the round "
                "counter).  Saving would checkpoint a silently wrong "
                "trajectory; restore from the last good checkpoint.")
        writer = self.mesh is None or self.mesh.rank == 0
        ckpt = checkpoint_path(path, self.round)
        if writer:
            os.makedirs(path, exist_ok=True)
            ckpt = save_checkpoint(path, self.round, self._driver.arrays())
        meta = {
            "format": 1,
            "spec": self.spec.to_dict(),
            "round": self.round,
            "num_users": self.fcfg.num_users,
            "data_rng": self.data_rng.bit_generator.state,
            "sched_rng": self.sched_rng.bit_generator.state,
            "part_counts": (None if self._part_counts is None
                            else self._part_counts.tolist()),
        }
        if writer:
            tmp = os.path.join(path, _SESSION_META + ".tmp")
            with open(tmp, "w") as f:
                json.dump(meta, f, indent=1, sort_keys=True)
            os.replace(tmp, os.path.join(path, _SESSION_META))
        if self.mesh is not None:
            # the replicas are equal: no rank returns before rank 0 wrote
            dist.barrier(group=self.mesh.group)
        return ckpt

    @classmethod
    def restore(cls, path: str, pair, fcfg: DistGANConfig, dataset, *,
                device=None, mesh=None) -> "FederationSession":
        """Rebuild a session from ``save(path)``, in this process or a
        fresh one, on ``device`` (CUDA unless ``"cpu"``).  ``pair`` /
        ``fcfg`` / ``dataset`` must match the saving run; the spec comes
        from the checkpoint.  The state is built once, from the restored
        arrays (no fresh initial state is drawn first).  An ``spmd``
        session resumes with ``mesh=``: every rank reads the checkpoint.

        A checkpoint the JAX reference wrote restores too: every array but
        the PRNG key, the numpy streams, the counts and the round carry
        over.  jax's threefry key has no counterpart in torch, so the
        port's round-noise generator is then seeded from ``spec.seed`` and
        the round (:func:`resume_generator_seed`), and the rounds after the
        restore draw other noise than the reference's would."""
        with open(os.path.join(path, _SESSION_META)) as f:
            meta = json.load(f)
        if meta["num_users"] != fcfg.num_users:
            raise ValueError(
                f"checkpoint was saved with num_users={meta['num_users']}, "
                f"got fcfg.num_users={fcfg.num_users}")
        spec = FederationSpec.from_dict(meta["spec"])
        sess = cls(pair, fcfg, dataset, spec, device=device, mesh=mesh,
                   _defer_state=True)
        step = meta["round"]
        assert latest_step(path) == step, (latest_step(path), step)
        template = sess._driver.arrays()
        targets = tree_flatten(template)
        stored = read_leaves(path, step)
        key = len(targets) - 1                     # the PRNG slot is last
        check_leaves(stored, targets, skip=(key,))
        gen = torch.Generator()
        if stored[key].dtype == torch.uint8 and \
                stored[key].shape == targets[key].shape:
            gen.set_state(stored[key])
        else:                                      # a jax key
            gen.manual_seed(resume_generator_seed(spec.seed, step))
        # on the CPU: each driver moves what lives on the device
        arrays = [s.to(dtype=t.dtype) for s, t in zip(stored[:key],
                                                      targets[:key])]
        sess._driver.load_arrays(
            tree_unflatten(template, arrays + [stored[key]]), gen)
        sess.round = step
        sess.data_rng.bit_generator.state = meta["data_rng"]
        sess.sched_rng.bit_generator.state = meta["sched_rng"]
        if meta["part_counts"] is not None:
            sess._part_counts = np.asarray(meta["part_counts"], np.float64)
        return sess


def resume_generator_seed(seed: int, round_: int) -> int:
    """The round-noise generator's seed after restoring a checkpoint that
    carries no generator state (one the JAX reference wrote): a function
    of the spec's seed and the round only."""
    return int(np.random.SeedSequence([seed, round_, 0x7E57]).generate_state(
        1, np.uint64)[0] >> 1)
