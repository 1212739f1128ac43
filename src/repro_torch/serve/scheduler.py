"""Micro-batching request scheduler (port of the reference's
``serve/scheduler.py``, numpy and threading only): coalesce sample
requests into padded bucket dispatches.

``SampleRequest(user_id, n, seed, cond)`` goes in, a
``concurrent.futures.Future`` resolving to the ``(n, *sample_shape)``
array comes out.  The batcher keeps a FIFO of un-dispatched **slots**
(request r's slot j carries the ``(seed, request_id, j)`` triple the
sampler engine keys on) and, on each flush, packs up to ``max_bucket``
slots — across requests, splitting requests larger than a bucket over
several dispatches — into the largest fitting bucket.

Flush policy (size-or-deadline): a flush is *due* when a full
``max_bucket`` of slots is pending (size), or when the oldest pending
request has waited ``flush_deadline_s`` (deadline — latency bound for
sparse traffic).  The batcher itself never blocks: drive it

* synchronously — ``drain()`` flushes until empty (benches, tests, and
  any caller that batches its own submission bursts), or
* with the background pump — ``start()`` runs a daemon thread that
  wakes on submissions and flushes as dispatches come due (the live
  multi-tenant mode; ``stop()`` drains and joins).

Because every slot's sample is a pure function of ``(generator, seed,
request_id, slot index)`` (see repro_torch.serve.sampler), the batching
decisions here — who shares a bucket, where a request is split — are
**observable only as latency**, never as different bytes; request_id is
assigned at submit time (or passed explicitly for replay).
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable

import numpy as np


def flush_due(pending: int, capacity: int, oldest_t: float, now: float,
              deadline_s: float) -> bool:
    """The size-or-deadline flush policy, shared by :class:`MicroBatcher`
    (sample slots vs the largest bucket) and the decode engine's
    admission queue (queued prompts vs free slots,
    ``repro_torch.serve.decode``): dispatch when a full ``capacity`` of work is
    pending (size), or when the oldest pending submission has waited
    ``deadline_s`` (deadline — the latency bound for sparse traffic)."""
    if pending <= 0:
        return False
    return pending >= capacity or now - oldest_t >= deadline_s


@dataclasses.dataclass(frozen=True)
class SampleRequest:
    """One tenant's ask: ``n`` samples under its own ``seed``.  ``cond``
    is an opaque conditioning slot (reserved — carried through untouched
    so conditional pairs can key on it; the current pairs are
    unconditional)."""

    user_id: int
    n: int
    seed: int = 0
    # repro: allow(RPR005): cond is an opaque reserved slot — no invariant
    cond: Any = None

    def __post_init__(self):
        if not isinstance(self.n, int) or self.n < 1:
            raise ValueError(f"n must be a positive int, got {self.n!r}")
        if not isinstance(self.user_id, int) or self.user_id < 0:
            raise ValueError(f"user_id must be a non-negative int, got "
                             f"{self.user_id!r}")
        if not isinstance(self.seed, int):
            raise ValueError(f"seed must be an int, got {self.seed!r}")


class _Pending:
    """A submitted request with its dispatch bookkeeping."""

    __slots__ = ("req", "rid", "future", "next_off", "parts", "submit_t")

    def __init__(self, req: SampleRequest, rid: int, submit_t: float):
        self.req = req
        self.rid = rid
        self.future: Future = Future()
        self.next_off = 0        # first un-dispatched slot
        self.parts: list = []    # (start_off, rows) result chunks
        self.submit_t = submit_t

    def deliver(self, start: int, rows: np.ndarray) -> None:
        if self.future.done():      # failed by an earlier dispatch error
            return
        self.parts.append((start, rows))
        done = sum(len(r) for _, r in self.parts)
        if done == self.req.n:
            self.parts.sort(key=lambda p: p[0])
            self.future.set_result(
                np.concatenate([r for _, r in self.parts]))


class MicroBatcher:
    """FIFO slot coalescer over a bucket dispatch function.

    ``dispatch(bucket, seeds, rids, offs) -> (bucket, ...) np.ndarray``
    runs one padded bucket (the service binds this to the sampler
    engine and the currently-published generator).  Thread-safe; the
    lock covers queue surgery and result delivery — only dispatch runs
    outside it, so submissions land while the device computes."""

    def __init__(self, dispatch: Callable, bucket_sizes,
                 flush_deadline_s: float = 0.002, *,
                 clock: Callable = time.monotonic):
        self.buckets = tuple(sorted(set(int(b) for b in bucket_sizes)))
        self.max_bucket = self.buckets[-1]
        self.dispatch = dispatch
        self.flush_deadline_s = float(flush_deadline_s)
        self.clock = clock
        self._lock = threading.Condition()
        self._queue: collections.deque = collections.deque()
        self._next_rid = 0
        self._thread: threading.Thread | None = None
        self._stopping = False
        self.stats = {"flushes": 0, "dispatched_slots": 0,
                      "padded_slots": 0, "max_requests_per_flush": 0}

    # -- submission --------------------------------------------------------

    def submit(self, req: SampleRequest, *,
               request_id: int | None = None) -> Future:
        """Enqueue; returns the future of the (n, ...) sample array.
        ``request_id`` pins the RNG identity for replay (defaults to the
        monotonic submission counter)."""
        with self._lock:
            if request_id is None:
                request_id = self._next_rid
            self._next_rid = max(self._next_rid, request_id) + 1
            p = _Pending(req, request_id, self.clock())
            self._queue.append(p)
            self._lock.notify_all()
        return p.future

    def reserve_request_id(self) -> int:
        """Claim the next RNG identity without enqueuing (side paths —
        e.g. the rejection filter — draw ids from the same counter so
        identities never collide with queued requests)."""
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            return rid

    def pending_slots(self) -> int:
        with self._lock:
            return sum(p.req.n - p.next_off for p in self._queue)

    # -- flush policy ------------------------------------------------------

    def _due(self, now: float) -> bool:
        # caller holds the lock
        if not self._queue:
            return False
        slots = sum(p.req.n - p.next_off for p in self._queue)
        return flush_due(slots, self.max_bucket, self._queue[0].submit_t,
                         now, self.flush_deadline_s)

    def due(self) -> bool:
        with self._lock:
            return self._due(self.clock())

    def flush(self) -> int:
        """Dispatch ONE bucket of pending slots (the largest fitting
        one); returns the number of real (unpadded) slots served, 0 if
        nothing was pending."""
        with self._lock:
            take = []           # (pending, start_off, count)
            k = 0
            while self._queue and k < self.max_bucket:
                p = self._queue[0]
                if p.future.done():   # failed by an earlier dispatch error
                    self._queue.popleft()
                    continue
                c = min(p.req.n - p.next_off, self.max_bucket - k)
                take.append((p, p.next_off, c))
                p.next_off += c
                k += c
                if p.next_off == p.req.n:
                    self._queue.popleft()
            if not take:
                return 0
            bucket = next(b for b in self.buckets if b >= k)
            self.stats["flushes"] += 1
            self.stats["dispatched_slots"] += k
            self.stats["padded_slots"] += bucket - k
            self.stats["max_requests_per_flush"] = max(
                self.stats["max_requests_per_flush"], len(take))
        seeds = np.concatenate([np.full(c, p.req.seed, np.int64)
                                for p, _, c in take])
        rids = np.concatenate([np.full(c, p.rid, np.int64)
                               for p, _, c in take])
        offs = np.concatenate([np.arange(s, s + c, dtype=np.int64)
                               for _, s, c in take])
        try:
            rows = self.dispatch(bucket, seeds, rids, offs)
        except BaseException as e:          # noqa: BLE001 — fail the futures
            with self._lock:
                for p, _, _ in take:
                    if not p.future.done():
                        p.future.set_exception(e)
            raise
        # delivery re-takes the lock: concurrent flushes (pump thread +
        # a drain()ing caller) may each hold chunks of one SPLIT request,
        # and _Pending.parts/future resolution must not race
        with self._lock:
            at = 0
            for p, start, c in take:
                p.deliver(start, np.asarray(rows)[at:at + c])
                at += c
        return k

    def drain(self) -> None:
        """Flush until the queue is empty (ignores the deadline — the
        caller has decided now is dispatch time)."""
        while self.flush():
            pass

    # -- background pump ---------------------------------------------------

    def start(self) -> None:
        """Run the size-or-deadline pump in a daemon thread."""
        if self._thread is not None:
            return
        self._stopping = False
        self._thread = threading.Thread(target=self._pump, daemon=True,
                                        name="microbatcher")
        self._thread.start()

    def stop(self) -> None:
        """Drain outstanding requests and join the pump."""
        if self._thread is None:
            return
        with self._lock:
            self._stopping = True
            self._lock.notify_all()
        self._thread.join()
        self._thread = None
        self.drain()

    def _pump(self) -> None:
        while True:
            with self._lock:
                while not self._stopping:
                    now = self.clock()
                    if self._due(now):
                        break
                    if self._queue:
                        # sleep exactly until the oldest request's
                        # deadline (a size-due burst notifies sooner)
                        wait = (self._queue[0].submit_t
                                + self.flush_deadline_s - now)
                        self._lock.wait(timeout=max(wait, 0.0))
                    else:
                        self._lock.wait()
                if self._stopping:
                    return
            try:
                self.flush()
            except Exception:       # noqa: BLE001
                # the owning futures already carry the exception; the
                # pump must survive a transient dispatch failure or all
                # LATER requests would hang forever in the queue
                pass
