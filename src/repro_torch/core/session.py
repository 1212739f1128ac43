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
device and each round a scheduled cohort of C users trains.  On a CUDA
device every mode replays CUDA graphs (``core/engine.py``): ``fused`` and
``cohort`` one per chunk, ``per_step`` one per round.

``save(path)`` / ``restore(path, ...)`` checkpoint the whole session in
the reference's layout: ``step_<round>.msgpack`` holds the training
state's arrays in the reference's leaf order, ``session.json`` the spec,
the round, the numpy data and scheduler streams and the participation
counts; ``run(rounds, autosave_every=, autosave_path=)`` saves at
internal round boundaries.  The reference's PRNG key slot holds the
port's round-noise generator state (a uint8 tensor) instead.  The host
and streaming drivers come in a later slice (ROADMAP queue A item 8).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
import typing

import numpy as np
import torch

from repro_torch.checkpoint.msgpack_ckpt import (check_leaves, latest_step,
                                                 read_leaves, save_checkpoint,
                                                 tree_flatten, tree_unflatten)
from repro_torch.core.approaches import (DistGANConfig, DistGANState,
                                         d_flat_layout, init_state,
                                         state_template)
from repro_torch.core.engine import (CohortState, cohort_state_template,
                                     cohort_state_to_full, init_cohort_state,
                                     make_cohort_engine, make_engine,
                                     make_fused_store_engine)
from repro_torch.core.federated import (CohortStore, make_schedule_source,
                                        participation_weights,
                                        upload_bytes_flat)
from repro_torch.core.spec import (FederationSpec, register_backend,
                                   resolve_approach, resolve_backend)
from repro_torch.device import deterministic_convolutions, resolve_device
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
                       kept_frac: float) -> dict:
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
                "stage_rows": False}}


def _fetch(metrics: dict) -> dict:
    """Device metrics -> numpy (one host sync for the whole dict)."""
    return {k: v.cpu().numpy() for k, v in metrics.items()}


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
        structure on the session's device, the key slot left out) and the
        round-noise generator."""
        assert self.state is None, "load_arrays builds a deferred state"
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


# ---------------------------------------------------------------------------
# The session
# ---------------------------------------------------------------------------

class FederationSession:
    """Incrementally driven federation run described by a
    :class:`FederationSpec`.  ``fcfg.combiner`` / ``staleness_decay`` and
    the codec fields are overridden by the spec's :class:`CombineSpec`.
    ``device`` is CUDA unless the caller passes ``"cpu"``."""

    def __init__(self, pair, fcfg: DistGANConfig, dataset,
                 spec: FederationSpec, *, device=None, _defer_state=False):
        spec.validate_against(fcfg.num_users)
        self.device = resolve_device(device)
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
        tmp = os.path.join(path, _SESSION_META + ".tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=1, sort_keys=True)
        os.replace(tmp, os.path.join(path, _SESSION_META))
        return ckpt

    @classmethod
    def restore(cls, path: str, pair, fcfg: DistGANConfig, dataset, *,
                device=None) -> "FederationSession":
        """Rebuild a session from ``save(path)``, in this process or a
        fresh one, on ``device`` (CUDA unless ``"cpu"``).  ``pair`` /
        ``fcfg`` / ``dataset`` must match the saving run; the spec comes
        from the checkpoint.  The state is built once, from the restored
        arrays (no fresh initial state is drawn first).

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
        sess = cls(pair, fcfg, dataset, spec, device=device,
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
        arrays = [s.to(device=sess.device, dtype=t.dtype)
                  for s, t in zip(stored[:key], targets[:key])]
        sess._driver.load_arrays(tree_unflatten(template[:-1], arrays), gen)
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
