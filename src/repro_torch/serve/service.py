"""GenerationService (port of the reference's ``serve/service.py``): the
multi-tenant serving facade over a trained (or still-training)
Distributed-GAN federation.

The paper's closing argument is that the platform ultimately *serves*
the trained generator to "users who lack computing power" (§7); MD-GAN
frames the server-held G as the shared artifact users consume.  This
module turns a :class:`repro_torch.core.session.FederationSession` — live, or
restored from a msgpack checkpoint — into that artifact's service:

* requests go through the micro-batching scheduler
  (``serve/scheduler.py``) into the shape-bucketed sampler engine
  (``serve/sampler.py``): any request mix runs through O(log max_batch)
  programs, one CUDA graph each on the card;
* **hot-swap**: ``refresh()`` atomically publishes the session's
  current generator between batches — a training loop can interleave
  ``session.run(k); service.refresh()`` and in-flight dispatches never
  see a half-written tree.  The session updates its G in place, so the
  service serves a copy: ``refresh`` takes the engine's snapshot of the
  live tree on the device (outside any lock), then swaps the reference
  under the publish lock; a dispatch copies the tree it read into the
  engine's graph buffers under the engine's lock, unless they already hold
  it (``serve/sampler.py``);
* **determinism**: request ``r``'s samples are a pure function of
  ``(published generator, seed, r)`` — replayable via
  :meth:`replay`, independent of batch-mates (pinned across processes
  in tests/test_torch_serve.py);
* **accounting**: per-user requests / samples / bytes served, in the
  same spirit as the training side's upload-byte accounting;
* **admission control**: ``ServeSpec.rate_limit`` caps any tenant's
  request rate (sample and decode traffic share one sliding window);
  over-limit submissions raise :class:`RateLimitExceeded` and land in
  the tenant's ``rejected`` accounting row — a noisy neighbour is
  throttled at the door, before it costs a dispatch;
* **mixed traffic**: :meth:`attach_lm` binds a continuous-batching
  decode engine (``serve/decode.py``) so the same facade routes GAN
  ``SampleRequest``s and LM decode requests — :meth:`drain` drives
  both, and decode token counts join the per-user accounting;
* **approach-aware filtering**: for approaches that keep per-user
  discriminator rows in the store (``ApproachDef.user_axis``),
  :meth:`sample_filtered` draws ``oversample * n`` candidates and keeps
  the ``n`` the *user's own* D scores highest — personalized rejection
  sampling against the tenant's local data manifold.
"""

from __future__ import annotations

import collections
import threading
import time

import numpy as np
import torch

from repro_torch.core.approaches import d_flat_layout
from repro_torch.core.session import FederationSession
from repro_torch.core.spec import DecodeSpec, ServeSpec, resolve_approach
from repro_torch.device import resolve_device
from repro_torch.serve.decode import DecodeEngine, DecodeRequest
from repro_torch.serve.sampler import SamplerEngine
from repro_torch.serve.scheduler import MicroBatcher, SampleRequest


class RateLimitExceeded(Exception):
    """A tenant submitted more requests than ``ServeSpec.rate_limit``
    allows inside one ``rate_window_s`` window.  Carries ``user_id`` so
    callers can back off per tenant; the rejection is also counted in
    that tenant's ``rejected`` accounting row."""

    def __init__(self, user_id: int, limit: int, window_s: float):
        super().__init__(
            f"user {user_id} exceeded {limit} requests per "
            f"{window_s:g}s window")
        self.user_id = user_id
        self.limit = limit
        self.window_s = window_s


class GenerationService:
    """Bucketed, micro-batched, hot-swappable sample service.

    Build one with :meth:`from_session` (live training state) or
    :meth:`from_checkpoint` (a ``FederationSession.save`` directory in a
    fresh process).  ``serve`` defaults to the session spec's ``serve``
    block, then to ``ServeSpec()``.  Runs on ``device`` (the session's,
    else CUDA unless ``"cpu"``)."""

    def __init__(self, pair, g_params, *, serve: ServeSpec | None = None,
                 session: FederationSession | None = None, device=None):
        self.pair = pair
        self.serve = serve or ServeSpec()
        self.session = session
        if device is None and session is not None:
            device = session.device
        self.device = resolve_device(device)
        self.engine = SamplerEngine(pair, self.serve.buckets(),
                                    device=self.device)
        self.batcher = MicroBatcher(self._dispatch, self.serve.buckets(),
                                    self.serve.flush_ms / 1e3)
        self._g = self.engine.snapshot(g_params)
        self._publish_lock = threading.Lock()
        self._accounting_lock = threading.Lock()
        self.generation = 0        # bumped by every refresh()
        self._per_user: dict = collections.defaultdict(
            lambda: {"requests": 0, "samples": 0, "bytes": 0})
        self._rate_times: dict = collections.defaultdict(collections.deque)
        self._d_layout = d_flat_layout(pair)
        self.decoder: DecodeEngine | None = None

    # -- constructors ------------------------------------------------------

    @classmethod
    def from_session(cls, session: FederationSession, *,
                     serve: ServeSpec | None = None) -> "GenerationService":
        """Serve a live session's current generator (call
        :meth:`refresh` after later ``session.run`` windows)."""
        return cls(session.pair, session.generator_params(),
                   serve=serve or session.spec.serve, session=session)

    @classmethod
    def from_checkpoint(cls, path: str, pair, fcfg, *, mesh=None,
                        serve: ServeSpec | None = None, device=None
                        ) -> "GenerationService":
        """Restore a ``FederationSession.save(path)`` checkpoint (either
        package's) and serve it on ``device``.  No dataset is bound — the
        restored session backs serving (generator + per-user D rows) only;
        rebuild it through ``FederationSession.restore`` with a dataset to
        keep training."""
        session = FederationSession.restore(path, pair, fcfg, None,
                                            device=device, mesh=mesh)
        return cls.from_session(session, serve=serve)

    # -- hot swap ----------------------------------------------------------

    def refresh(self, session: FederationSession | None = None) -> int:
        """Atomically publish the (possibly newer) generator from
        ``session`` (default: the bound one).  Dispatches already in
        flight finish on the old tree; every later batch sees the new
        one.  Returns the new generation counter."""
        sess = session or self.session
        if sess is None:
            raise ValueError("no session bound and none passed")
        g = self.engine.snapshot(sess.generator_params())
        with self._publish_lock:
            self._g = g
            self.generation += 1
            return self.generation

    # -- per-tenant admission control --------------------------------------

    def _admit(self, user_id: int) -> None:
        """Charge one request against the tenant's sliding rate window;
        raises :class:`RateLimitExceeded` (and bumps the ``rejected``
        accounting row) when over ``ServeSpec.rate_limit``.  Sample and
        decode traffic share the window — the cap is on the tenant, not
        the traffic class."""
        limit = self.serve.rate_limit
        if limit is None:
            return
        now = time.monotonic()
        window = self.serve.rate_window_s
        with self._accounting_lock:
            times = self._rate_times[int(user_id)]
            while times and now - times[0] >= window:
                times.popleft()
            if len(times) >= limit:
                acc = self._per_user[int(user_id)]
                acc["rejected"] = acc.get("rejected", 0) + 1
                raise RateLimitExceeded(int(user_id), limit, window)
            times.append(now)

    # -- request path ------------------------------------------------------

    def _dispatch(self, bucket: int, seeds, rids, offs) -> np.ndarray:
        with self._publish_lock:
            g = self._g            # the atomic publish point
        return self.engine.sample_bucket(g, bucket, seeds, rids,
                                         offs).cpu().numpy()

    def submit(self, user_id: int, n: int, seed: int = 0, cond=None, *,
               request_id: int | None = None):
        """Enqueue a request; returns its future.  Drive the batcher
        with :meth:`drain` (sync) or ``service.batcher.start()``
        (background pump)."""
        self._admit(user_id)
        req = SampleRequest(user_id=int(user_id), n=int(n), seed=int(seed),
                            cond=cond)
        fut = self.batcher.submit(req, request_id=request_id)
        with self._accounting_lock:
            self._per_user[req.user_id]["requests"] += 1

        def account(f):
            if f.cancelled() or f.exception() is not None:
                return
            arr = f.result()
            with self._accounting_lock:
                acc = self._per_user[req.user_id]
                acc["samples"] += len(arr)
                acc["bytes"] += arr.nbytes

        fut.add_done_callback(account)
        return fut

    # -- LM decode traffic (continuous batching) ---------------------------

    def attach_lm(self, cfg, params, decode: DecodeSpec | None = None
                  ) -> DecodeEngine:
        """Bind a continuous-batching decode engine so this facade
        serves LM decode alongside GAN sampling.  ``cfg``/``params`` are
        a ``ModelConfig`` + parameter tree of any family but audio, such
        as a federation-trained critic exported by
        ``core/distgan_lm.critic_lm_params`` under ``critic_lm_config``.
        ``decode`` defaults to the session spec's ``decode`` block, then
        to ``DecodeSpec()``.  The engine runs on the service's device."""
        if decode is None and self.session is not None:
            decode = self.session.spec.decode
        self.decoder = DecodeEngine(cfg, params, decode or DecodeSpec(),
                                    device=self.device)
        return self.decoder

    def submit_decode(self, user_id: int, prompt, max_new: int,
                      seed: int = 0, *, request_id: int | None = None):
        """Enqueue an LM decode request; returns the future of the
        generated (n,) int32 token array.  Counts against the same
        per-tenant rate window as sampling; generated tokens and bytes
        join the tenant's accounting."""
        if self.decoder is None:
            raise ValueError("no decode engine attached (call attach_lm "
                             "with the LM config and params first)")
        self._admit(user_id)
        req = DecodeRequest(user_id=int(user_id), prompt=prompt,
                            max_new=int(max_new), seed=int(seed))
        fut = self.decoder.submit(req, request_id=request_id)
        with self._accounting_lock:
            self._per_user[req.user_id]["requests"] += 1

        def account(f):
            if f.cancelled() or f.exception() is not None:
                return
            arr = f.result()
            with self._accounting_lock:
                acc = self._per_user[req.user_id]
                acc["tokens"] = acc.get("tokens", 0) + len(arr)
                acc["bytes"] += arr.nbytes

        fut.add_done_callback(account)
        return fut

    def generate(self, user_id: int, prompt, max_new: int, seed: int = 0,
                 *, request_id: int | None = None) -> np.ndarray:
        """Synchronous decode convenience: submit + drain + result."""
        fut = self.submit_decode(user_id, prompt, max_new, seed,
                                 request_id=request_id)
        if not fut.done():
            self.drain()
        return fut.result()

    def drain(self) -> None:
        """Drive both traffic classes to empty: flush the sample batcher
        and run the decode engine until its queue and slots clear."""
        self.batcher.drain()
        if self.decoder is not None:
            self.decoder.drain()

    def sample(self, user_id: int, n: int, seed: int = 0, *,
               request_id: int | None = None) -> np.ndarray:
        """Synchronous convenience: submit + drain + result."""
        fut = self.submit(user_id, n, seed, request_id=request_id)
        if not fut.done():
            self.drain()
        return fut.result()

    def replay(self, seed: int, request_id: int, n: int) -> np.ndarray:
        """Re-materialize request ``request_id``'s samples from its RNG
        identity alone — byte-identical to what was served (for the
        same published generator), no queue involved."""
        with self._publish_lock:
            g = self._g
        return self.engine.sample_request(g, seed, request_id, n)

    # -- per-user discriminator rejection filter ---------------------------

    def user_d_params(self, user_id: int):
        """The tenant's own discriminator tree, gathered from the bound
        session's store (host / device / spmd backends all answer)."""
        if self.session is None:
            raise ValueError("rejection filtering needs a bound session "
                             "(the per-user D rows live in its store)")
        # np.array (a forced copy): user_d_flat may return a view of the
        # session's live store, which from_numpy would share — later
        # scatters would silently rewrite the "snapshot"
        row = torch.from_numpy(np.array(self.session.user_d_flat(user_id)))
        return self._d_layout.unflatten(row.to(self.device))

    def sample_filtered(self, user_id: int, n: int, seed: int = 0, *,
                        request_id: int | None = None,
                        oversample: int | None = None) -> np.ndarray:
        """``n`` samples rejection-filtered by the USER'S discriminator:
        draw ``oversample * n`` candidates under the request's RNG
        identity, score them with the tenant's own D row, keep the
        top-``n`` (stable order, so the result is as deterministic as
        the plain path).  Only approaches that keep per-user D rows
        support this (``ApproachDef.user_axis``); the session accessor
        raises otherwise."""
        self._admit(user_id)
        if self.session is not None and \
                not resolve_approach(self.session.spec.approach).user_axis:
            raise ValueError(
                f"approach {self.session.spec.approach!r} keeps no "
                f"per-user discriminator rows to filter with")
        d_params = self.user_d_params(user_id)
        k = oversample or self.serve.oversample
        if request_id is None:
            # shared counter: filtered and plain requests never collide
            # on an RNG identity
            request_id = self.batcher.reserve_request_id()
        m = k * n
        with self._publish_lock:
            g = self._g
        cands = self.engine.sample_request(g, seed, request_id, m)
        scores = self.engine.score_bucket(d_params, cands)
        keep = np.argsort(-scores, kind="stable")[:n]
        out = cands[np.sort(keep)]
        with self._accounting_lock:
            acc = self._per_user[int(user_id)]
            acc["requests"] += 1
            acc["samples"] += n
            acc["bytes"] += out.nbytes
        return out

    # -- accounting --------------------------------------------------------

    def stats(self) -> dict:
        """Service-wide counters: per-user accounting, program-cache
        sizes, and the batcher's coalescing stats."""
        with self._accounting_lock:
            per_user = {u: dict(v) for u, v in self._per_user.items()}
        out = {
            "per_user": per_user,
            "total_samples": sum(v["samples"] for v in per_user.values()),
            "total_bytes": sum(v["bytes"] for v in per_user.values()),
            "total_rejected": sum(v.get("rejected", 0)
                                  for v in per_user.values()),
            "generation": self.generation,
            "programs": self.engine.program_counts,
            "batcher": dict(self.batcher.stats),
        }
        if self.decoder is not None:
            out["decode"] = self.decoder.engine_stats()
        return out
