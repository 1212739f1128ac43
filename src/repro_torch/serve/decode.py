"""Slot-based continuous-batching LM decode engine (port of the reference's
``serve/decode.py``) for every decoder-only family: dense, vlm, ssm,
hybrid (RG-LRU), MoE with or without MLA.  The audio encoder-decoder
needs per-request source embeddings and is served by
``launch.serve.greedy_decode``, as in the reference.

A fixed pool of ``slots`` decode slots shares ONE pre-allocated KV/state
cache block, shaped ``(slots, max_seq)`` per the layouts of
``models/cache.py`` and priced by ``cache_nbytes``, and runs continuous
batching over it:

* **one decode-step program**: each step advances ALL slots one token at
  pool width under a ``valid`` mask (vacant slots compute garbage that a
  ``where`` discards bit for bit).  On the card it is one CUDA graph, whose
  buffers are the pool itself (updated in place, as the reference donates
  it) and the step's inputs;
* **bucketed prefill**: queued prompts are admitted in batches through a
  prompt-length bucket ladder (``DecodeSpec.buckets()``) under the same
  size-or-deadline policy as the sample micro-batcher
  (``scheduler.flush_due``): a prefill pads its prompts to one bucket,
  runs the decode step over it at pool width with per-row length masks,
  and merges the finished rows into their slots (``cache.merge_slots``, a
  where-select).  One prefill-step program (one CUDA graph, whose buffers
  are a fresh cache and the step's position) serves every bucket: a
  prefill replays it ``bucket`` times, so capture costs one step, not a
  bucket of them, and the engine builds two programs — within the
  reference's bound of ``len(buckets) + 1``;
* **per-step admission**: a slot freed by EOS or the length limit admits a
  queued request at the next step boundary.

Byte-determinism contract: a request's tokens are a pure function of
``(params, prompt, seed, request_id)``.  Every program runs at the fixed
width ``slots``, so every matmul has one shape (one algorithm); a row's
math touches only its own cache row, token and position (``attn_decode``
takes one position per row; MoE routing runs each slot as its own group,
as the reference's per-row ``vmap`` routes one token at a time, so a slot
never shares an expert's capacity with its batch-mates); sampling keys
are ``fold_in(fold_in(
key(seed), request_id), position)`` (``repro_torch.prng``); a larger
prefill bucket only adds masked steps that are exact identities.  So slot
assignment, batch-mates, admission order and the prefill bucket show only
as latency.  :meth:`replay` re-derives a request's tokens through the same
programs (slot 0, the live pool saved and put back) and equals what was
served.

Driving: ``step()`` advances one boundary, ``drain()`` runs to empty; one
thread drives steps, ``submit`` is thread-safe.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Callable

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.spec import DecodeSpec
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.cache import cache_nbytes, merge_slots
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.serve.program import Program
from repro_torch.serve.scheduler import flush_due

_OCC_TRACE_CAP = 4096     # bounded slot-occupancy trace


@dataclasses.dataclass(frozen=True)
class DecodeRequest:
    """One tenant's ask: continue ``prompt`` for up to ``max_new`` tokens
    under its own ``seed`` (ignored at temperature 0)."""

    user_id: int
    prompt: tuple
    max_new: int
    seed: int = 0

    def __post_init__(self):
        toks = tuple(int(t) for t in np.asarray(self.prompt).reshape(-1))
        object.__setattr__(self, "prompt", toks)
        if not toks or any(t < 0 for t in toks):
            raise ValueError(f"prompt must be a non-empty sequence of "
                             f"token ids >= 0, got {self.prompt!r}")
        if not isinstance(self.max_new, int) or self.max_new < 1:
            raise ValueError(f"max_new must be a positive int, got "
                             f"{self.max_new!r}")
        # -1 is the replay sentinel ("no tenant") — see DecodeEngine.replay
        if not isinstance(self.user_id, int) or self.user_id < -1:
            raise ValueError(f"user_id must be an int >= -1, got "
                             f"{self.user_id!r}")
        if not isinstance(self.seed, int):
            raise ValueError(f"seed must be an int, got {self.seed!r}")


class _Pending:
    """A submitted request with its slot bookkeeping."""

    __slots__ = ("req", "rid", "future", "out", "submit_t")

    def __init__(self, req: DecodeRequest, rid: int, submit_t: float):
        self.req = req
        self.rid = rid
        self.future: Future = Future()
        self.out: list = []          # generated token ids, in order
        self.submit_t = submit_t


def _u32(x) -> int:
    # negative seeds wrap, as the reference's uint32 casts do
    return int(x) & 0xFFFFFFFF


def _copy_into(dst_tree, src_tree) -> None:
    for dst, src in zip(tree_leaves(dst_tree), tree_leaves(src_tree)):
        dst.copy_(src)


class DecodeEngine:
    """Continuous-batching decode over one LM's params on ``device`` (CUDA
    unless ``"cpu"``).

    ``cfg`` is a ``ModelConfig`` of any family but audio, ``params`` its
    parameter tree (the engine keeps its own copy, which
    :meth:`publish` overwrites).  Futures resolve to the
    ``(n_generated,)`` int32 token array (n <= max_new; an emitted
    ``eos_id`` is included and ends the request)."""

    def __init__(self, cfg, params, spec: DecodeSpec | None = None, *,
                 device=None, clock: Callable = time.monotonic):
        if cfg.arch_type == "audio":
            raise NotImplementedError(
                "encoder-decoder decode needs per-request source embeds; "
                "use launch.serve.greedy_decode for the audio family")
        self.cfg = cfg
        self.spec = spec or DecodeSpec()
        # one routing group per slot (C = max(ceil(k / E * cf), 1)), as the
        # reference routes each row alone under vmap
        self._step_cfg = (dataclasses.replace(cfg, moe_groups=self.spec.slots)
                          if cfg.arch_type == "moe" else cfg)
        self.clock = clock
        self.device = resolve_device(device)
        S, T = self.spec.slots, self.spec.max_seq
        self._params = tree_map(
            lambda t: t.detach().to(self.device, copy=True), params)
        # THE cache block, reused forever
        self.pool = M.init_cache(cfg, S, T, device=self.device)
        self._slot_req: list = [None] * S     # _Pending per occupied slot
        self._toks = np.zeros(S, np.int64)    # next token to feed, per slot
        self._pos = np.zeros(S, np.int64)     # its feed position
        self._seeds = np.zeros(S, np.int64)
        self._rids = np.zeros(S, np.int64)
        self._queue: collections.deque = collections.deque()
        self._next_rid = 0
        self._lock = threading.Lock()         # queue + rid counter
        self._decode_prog: Program | None = None
        self._prefill_prog: Program | None = None
        self._graph_pool = (torch.cuda.graph_pool_handle()
                            if self.device.type == "cuda" else None)
        self.stats = {"steps": 0, "step_slots": 0, "step_idle_slots": 0,
                      "prefills": 0, "prefill_slots": 0,
                      "prefill_padded_tokens": 0, "completed": 0,
                      "generated_tokens": 0}
        self.occupancy_trace: list = []       # occupied-slot count per step
        self.prefill_buckets: collections.Counter = collections.Counter()

    # -- sizing / program accounting ---------------------------------------

    @property
    def pool_nbytes(self) -> int:
        """Bytes of the shared cache block, from ``cache_nbytes`` (the one
        pricing function; held to the live allocation in the tests)."""
        return cache_nbytes(self.cfg, self.spec.slots, self.spec.max_seq)

    @property
    def program_counts(self) -> dict:
        """Programs built (CUDA graphs on the card): one prefill step and
        one decode step, within the reference's bound of len(buckets) +
        1."""
        return {"prefill": int(self._prefill_prog is not None),
                "decode": int(self._decode_prog is not None)}

    def bucket_for(self, prompt_len: int) -> int:
        for b in self.spec.buckets():
            if b >= prompt_len:
                return b
        raise ValueError(f"prompt length {prompt_len} exceeds the largest "
                         f"prefill bucket {self.spec.buckets()[-1]}")

    # -- programs ----------------------------------------------------------

    def _select(self, logits, seeds, rids, keypos):
        """The token at absolute position ``keypos`` for each row of
        ``logits`` (S, V) — the ONLY place randomness enters, keyed by
        (seed, request_id, position)."""
        if float(self.spec.temperature) == 0.0:
            return torch.argmax(logits, dim=-1)
        keys = prng.fold_in(prng.fold_in(prng.key(seeds), rids), keypos)
        return prng.categorical(
            keys, logits.to(torch.float32) / self.spec.temperature)

    def _step_rows(self, params, cache, toks, pos):
        """Every row one token: ((S, V) logits, the new cache)."""
        logits, nc = M.decode_step(params, cache, toks[:, None], pos,
                                   self._step_cfg)
        return logits[:, 0], nc

    def _decode_rows(self, st):
        logits, nc = self._step_rows(st["params"], st["pool"], st["toks"],
                                     st["pos"])
        nxt = self._select(logits, st["seeds"], st["rids"], st["pos"] + 1)
        _copy_into(st["pool"], merge_slots(st["pool"], nc, st["valid"]))
        return torch.where(st["valid"], nxt, torch.zeros_like(nxt))

    def _prefill_step(self, st):
        """One prompt position ``st["i"]`` for every row, on the fresh
        cache: rows past their own length take exact identity steps, so the
        bucket (how many steps run) never shows in the bytes."""
        lens = st["lens"]
        pos = st["i"].expand_as(lens)
        tok = st["toks"].index_select(1, st["i"])[:, 0]
        logits, nc = self._step_rows(st["params"], st["fresh"], tok, pos)
        _copy_into(st["fresh"], merge_slots(st["fresh"], nc, pos < lens))
        sel = self._select(logits, st["seeds"], st["rids"], pos + 1)
        st["first"].copy_(torch.where(lens - 1 == pos, sel, st["first"]))
        st["i"].add_(1)

    def _ints(self, *shape):
        return torch.zeros(shape, dtype=torch.int64, device=self.device)

    def _decode(self) -> Program:
        if self._decode_prog is None:
            S = self.spec.slots
            static = {"params": self._params, "pool": self.pool,
                      "toks": self._ints(S), "pos": self._ints(S),
                      "seeds": self._ints(S), "rids": self._ints(S),
                      "valid": torch.zeros(S, dtype=torch.bool,
                                           device=self.device)}
            self._decode_prog = Program(self._decode_rows, static,
                                        self.device, mutable=("pool",),
                                        pool=self._graph_pool)
        return self._decode_prog

    def _prefill(self) -> Program:
        if self._prefill_prog is None:
            S, T = self.spec.slots, self.spec.max_seq
            static = {"params": self._params,
                      "fresh": M.init_cache(self.cfg, S, T,
                                            device=self.device),
                      "first": self._ints(S), "i": self._ints(1),
                      "toks": self._ints(S, self.spec.buckets()[-1]),
                      "lens": self._ints(S), "seeds": self._ints(S),
                      "rids": self._ints(S)}
            self._prefill_prog = Program(
                self._prefill_step, static, self.device,
                mutable=("fresh", "first", "i"), pool=self._graph_pool)
        return self._prefill_prog

    def _run_prefill(self, toks, lens, seeds, rids) -> np.ndarray:
        """Prefill rows ``lens > 0`` with their (S, bucket) prompts: the
        step program replayed ``bucket`` times over a zeroed fresh cache,
        then each admitted row REPLACES its slot wholesale (fresh rows start
        from zeros, so admission doubles as the slot's reset).  Returns the
        (S,) first generated tokens."""
        prog = self._prefill()
        st = prog.static
        with self._on_device():
            st["toks"][:, :toks.shape[1]].copy_(torch.from_numpy(toks))
            for name, a in (("lens", lens), ("seeds", seeds),
                            ("rids", rids)):
                st[name].copy_(torch.from_numpy(np.asarray(a)))
            for t in tree_leaves(st["fresh"]) + [st["first"], st["i"]]:
                t.zero_()
            for _ in range(toks.shape[1]):
                prog()
            valid = st["lens"] > 0
            _copy_into(self.pool, merge_slots(self.pool, st["fresh"], valid))
            first = torch.where(valid, st["first"],
                                torch.zeros_like(st["first"]))
            return first.cpu().numpy()

    def _on_device(self):
        return (torch.cuda.device(self.device) if self.device.type == "cuda"
                else contextlib.nullcontext())

    def _run(self, prog: Program, **inputs) -> np.ndarray:
        """Load host arrays into ``prog``'s buffers, run it, read its
        (S,) tokens back."""
        for name, a in inputs.items():
            prog.static[name].copy_(torch.from_numpy(np.asarray(a)))
        with self._on_device():
            return prog().cpu().numpy()

    # -- submission --------------------------------------------------------

    def publish(self, params) -> None:
        """Hot-swap the served params (the service's refresh hook): copied
        into the engine's buffers, which the next dispatch reads; slots
        mid-request continue on them too."""
        _copy_into(self._params, params)

    def submit(self, req: DecodeRequest, *,
               request_id: int | None = None) -> Future:
        """Enqueue; returns the future of the (n_generated,) int32 token
        array.  ``request_id`` pins the RNG identity for replay (defaults
        to the monotonic submission counter)."""
        plen = len(req.prompt)
        if plen + req.max_new > self.spec.max_seq:
            raise ValueError(
                f"prompt ({plen}) + max_new ({req.max_new}) exceeds "
                f"max_seq {self.spec.max_seq}")
        self.bucket_for(plen)   # raises if no bucket holds the prompt
        with self._lock:
            if request_id is None:
                request_id = self._next_rid
            self._next_rid = max(self._next_rid, request_id) + 1
            p = _Pending(req, request_id, self.clock())
            self._queue.append(p)
        return p.future

    def reserve_request_id(self) -> int:
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            return rid

    def pending(self) -> int:
        with self._lock:
            return len(self._queue)

    def occupied(self) -> int:
        return sum(r is not None for r in self._slot_req)

    # -- the continuous-batching loop --------------------------------------

    def _done(self, p: _Pending, tok: int) -> bool:
        eos = self.spec.eos_id
        return len(p.out) >= p.req.max_new or (eos is not None
                                               and tok == eos)

    def _finish(self, slot: int, p: _Pending) -> None:
        self._slot_req[slot] = None
        self.stats["completed"] += 1
        if not p.future.done():
            p.future.set_result(np.asarray(p.out, np.int32))

    def _maybe_admit(self, force: bool) -> int:
        """Admit due queued requests into free slots through ONE bucketed
        prefill; returns the requests admitted.  While the pool is busy the
        queue waits until ``admit_min`` slots are free (or the whole queue
        fits): a prefill runs a whole bucket at pool width however many
        rows it fills."""
        with self._lock:
            free = [s for s in range(self.spec.slots)
                    if self._slot_req[s] is None]
            if not free or not self._queue:
                return 0
            busy = len(free) < self.spec.slots
            admit_min = self.spec.admit_min or max(1, self.spec.slots // 4)
            if busy and len(free) < min(admit_min, len(self._queue)):
                return 0
            if not force and not flush_due(
                    len(self._queue), len(free), self._queue[0].submit_t,
                    self.clock(), self.spec.flush_ms / 1e3):
                return 0
            take = [self._queue.popleft()
                    for _ in range(min(len(free), len(self._queue)))]
        bucket = self.bucket_for(max(len(p.req.prompt) for p in take))
        S = self.spec.slots
        toks = np.zeros((S, bucket), np.int64)
        lens = np.zeros(S, np.int64)
        slots = free[:len(take)]
        for s, p in zip(slots, take):
            pl = len(p.req.prompt)
            toks[s, :pl] = p.req.prompt
            lens[s] = pl
            self._seeds[s] = _u32(p.req.seed)
            self._rids[s] = _u32(p.rid)
            self._slot_req[s] = p
        first = self._run_prefill(toks, lens, self._seeds, self._rids)
        self.stats["prefills"] += 1
        self.prefill_buckets[bucket] += 1
        self.stats["prefill_slots"] += len(take)
        self.stats["prefill_padded_tokens"] += sum(
            bucket - len(p.req.prompt) for p in take)
        for s, p in zip(slots, take):
            t = int(first[s])
            p.out.append(t)
            self.stats["generated_tokens"] += 1
            self._pos[s] = len(p.req.prompt)
            self._toks[s] = t
            if self._done(p, t):      # max_new == 1, or the prompt's
                self._finish(s, p)    # continuation opens with EOS
        return len(take)

    def step(self, *, force_admit: bool = False) -> int:
        """One engine boundary: admit due queued requests into free slots,
        then advance every occupied slot one token.  Returns the number of
        slots advanced (0 = the engine is idle)."""
        self._maybe_admit(force_admit)
        S = self.spec.slots
        occ = [s for s in range(S) if self._slot_req[s] is not None]
        if not occ:
            return 0
        valid = np.zeros(S, bool)
        valid[occ] = True
        nxt = self._run(self._decode(), toks=self._toks, pos=self._pos,
                        valid=valid, seeds=self._seeds, rids=self._rids)
        self.stats["steps"] += 1
        self.stats["step_slots"] += len(occ)
        self.stats["step_idle_slots"] += S - len(occ)
        if len(self.occupancy_trace) < _OCC_TRACE_CAP:
            self.occupancy_trace.append(len(occ))
        for s in occ:
            p = self._slot_req[s]
            t = int(nxt[s])
            p.out.append(t)
            self.stats["generated_tokens"] += 1
            self._pos[s] += 1
            self._toks[s] = t
            if self._done(p, t):
                self._finish(s, p)
        return len(occ)

    def drain(self) -> None:
        """Step until the queue is empty and every slot is free (ignores
        the admission deadline)."""
        while True:
            with self._lock:
                idle = not self._queue
            if idle and not any(r is not None for r in self._slot_req):
                return
            self.step(force_admit=True)

    # -- replay / verification ---------------------------------------------

    def generate(self, user_id: int, prompt, max_new: int, seed: int = 0,
                 *, request_id: int | None = None) -> np.ndarray:
        """Synchronous convenience: submit + drain + result."""
        fut = self.submit(DecodeRequest(user_id=int(user_id), prompt=prompt,
                                        max_new=int(max_new),
                                        seed=int(seed)),
                          request_id=request_id)
        if not fut.done():
            self.drain()
        return fut.result()

    def replay(self, prompt, max_new: int, seed: int = 0, *,
               request_id: int) -> np.ndarray:
        """Re-derive a request's tokens from ``(params, prompt, seed,
        request_id)`` alone — byte for byte what the pooled path served
        (for the same published params), whatever slot it ran in, its
        batch-mates or how admissions were batched.  Runs in slot 0
        through the SAME two programs; the live pool is saved first and
        put back after (if any slot is occupied)."""
        req = DecodeRequest(user_id=-1, prompt=prompt, max_new=int(max_new),
                            seed=int(seed))
        S = self.spec.slots
        plen = len(req.prompt)
        if plen + req.max_new > self.spec.max_seq:
            raise ValueError(
                f"prompt ({plen}) + max_new ({req.max_new}) exceeds "
                f"max_seq {self.spec.max_seq}")
        bucket = self.bucket_for(plen)
        saved = (tree_map(lambda t: t.clone(), self.pool)
                 if self.occupied() else None)
        try:
            toks = np.zeros((S, bucket), np.int64)
            toks[0, :plen] = req.prompt
            lens = np.zeros(S, np.int64)
            lens[0] = plen
            seeds = np.zeros(S, np.int64)
            seeds[0] = _u32(req.seed)
            rids = np.zeros(S, np.int64)
            rids[0] = _u32(request_id)
            first = self._run_prefill(toks, lens, seeds, rids)
            out = [int(first[0])]
            feed = np.zeros(S, np.int64)
            pos = np.zeros(S, np.int64)
            pos[0] = plen
            valid = np.zeros(S, bool)
            valid[0] = True
            eos = self.spec.eos_id
            while len(out) < req.max_new and (eos is None
                                              or out[-1] != eos):
                feed[0] = out[-1]
                nxt = self._run(self._decode(), toks=feed, pos=pos,
                                valid=valid, seeds=seeds, rids=rids)
                out.append(int(nxt[0]))
                pos[0] += 1
        finally:
            if saved is not None:
                _copy_into(self.pool, saved)
        return np.asarray(out, np.int32)

    # -- accounting --------------------------------------------------------

    def engine_stats(self) -> dict:
        s = dict(self.stats)
        s["programs"] = self.program_counts
        s["pool_nbytes"] = self.pool_nbytes
        s["pending"] = self.pending()
        s["occupied"] = self.occupied()
        s["prefill_buckets"] = dict(sorted(self.prefill_buckets.items()))
        if self.occupancy_trace:
            s["mean_occupancy"] = (sum(self.occupancy_trace)
                                   / len(self.occupancy_trace))
        return s
