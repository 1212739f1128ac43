"""Shape-bucketed batched sampler engine over a trained generator (port of
the reference's ``serve/sampler.py``).

Requests of any size run through a small ladder of padded batch
**buckets** (``ServeSpec.buckets()``): a batch of k slots is padded to the
smallest bucket >= k with a ``valid`` mask, so the engine builds at most
``len(buckets)`` programs per family, whatever the request mix.  On the
card each (family, bucket) program is one CUDA graph, captured at first
use (``serve/program.py``); on the CPU it runs eagerly.

Two sampling modes:

* **request-keyed** (``sample_bucket``) — every slot carries its own
  ``(seed, request_id, sample_index)`` triple, its key is
  ``fold_in(fold_in(key(seed), request_id), sample_index)`` and its latent
  ``normal(key, (z_dim,))`` (``repro_torch.prng``: the reference's keys and
  draws).  G is applied **row-wise**, each row a batch of its own
  (``GanPair.g_rows``: the conv pair's batch norm then couples no
  batch-mates), in chunks of ``row_chunk`` rows (``ROW_CHUNK``): every
  chunk is one call of one shape whatever the bucket.  A matmul's or a
  convolution's library picks its algorithm, and so the order of its sums,
  by shape, on the card and on the CPU alike; one G call over the whole
  bucket moves a slot by an ULP from one bucket to another.  A slot's
  bytes are a pure function of ``(G, seed, request_id, sample_index)`` —
  independent of its batch-mates, its bucket and how a request was
  chunked.
* **bulk stream** (``sample_stream``) — one carried key, ``split`` every
  dispatch and updated in place (the reference donates it), full-batch
  ``g_apply``.

Scoring (``score_bucket``) shares the ladder: the per-user rejection
filter (``serve/service.py``) scores candidates with a user's D row-wise,
padding scored ``-inf``.

Parameters: the graphs read one engine-owned copy of G (and of the D being
scored).  A dispatch copies the tree it is given into those buffers first,
on its stream, under the engine's lock, so it sees one whole tree (the
service's hot-swap publishes a new tree between dispatches); a tree made by
:meth:`SamplerEngine.snapshot` that the buffers already hold is not copied
again.  Dispatches are serialized by that lock (the graphs share their
buffers).
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from repro_torch import prng
from repro_torch.device import resolve_device
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.serve.program import Program

# rows a G / D call takes at once; one chunk of it (zero-padded) serves the
# buckets below it.  32, not 16: the DCGAN's bucket-128 dispatch 4.6 ms
# against 6.6 on an H100 (one call over the bucket: 4.0, not bitwise;
# PERF.md)
ROW_CHUNK = 32


def _pad_u32(a, k: int) -> torch.Tensor:
    out = np.zeros(k, np.int64)
    # int64 first so negative seeds wrap instead of raising
    out[:len(a)] = np.asarray(a, np.int64) & 0xFFFFFFFF
    return torch.from_numpy(out)


def _chunked(fn, width: int | None):
    """``fn(params, x)`` over ``x`` in chunks of ``width`` rows (the last one
    zero-padded), concatenated and cut back; ``fn`` itself for ``None``."""
    if width is None:
        return fn

    def rows(params, x):
        n = x.shape[0]
        pad = -n % width
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        return torch.cat([fn(params, x[i:i + width])
                          for i in range(0, x.shape[0], width)])[:n]
    return rows


def _row_mask(valid: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return valid.reshape((-1,) + (1,) * (like.ndim - 1))


class SamplerEngine:
    """Program cache over one ``GanPair`` generator, on ``device`` (CUDA
    unless ``"cpu"``).  ``compile_count`` / ``program_counts`` count the
    programs (CUDA graphs on the card), bounded by the bucket ladder.
    ``row_chunk=None`` applies G and D to a whole bucket in one call (no
    bucket invariance; ``profile_serve`` times both)."""

    def __init__(self, pair, bucket_sizes, *, device=None,
                 row_chunk: int | None = ROW_CHUNK):
        buckets = tuple(sorted(set(int(b) for b in bucket_sizes)))
        assert buckets and all(b >= 1 for b in buckets), bucket_sizes
        self.pair = pair
        self.buckets = buckets
        self.max_bucket = buckets[-1]
        self.device = resolve_device(device)
        self._g_rows = _chunked(pair.g_rows or pair.g_apply, row_chunk)
        self._d_rows = _chunked(pair.d_rows or pair.d_apply, row_chunk)
        self._request_progs: dict = {}
        self._score_progs: dict = {}
        self._stream_progs: dict = {}
        self._stream_key = None
        self._params: dict = {}      # "g" / "d" -> the graphs' copy
        self._held: dict = {}        # "g" / "d" -> the tree last copied in
        self._snapshot = None        # the latest tree from snapshot()
        self._lock = threading.RLock()

    # -- bucket policy -----------------------------------------------------

    def bucket_for(self, k: int) -> int:
        """Smallest bucket holding ``k`` slots (callers chunk loads larger
        than ``max_bucket`` before asking)."""
        assert 1 <= k <= self.max_bucket, (k, self.buckets)
        for b in self.buckets:
            if b >= k:
                return b
        raise AssertionError  # unreachable

    @property
    def compile_count(self) -> int:
        """Request-keyed programs built (the gated count)."""
        return len(self._request_progs)

    @property
    def program_counts(self) -> dict:
        return {"request": len(self._request_progs),
                "score": len(self._score_progs),
                "stream": len(self._stream_progs)}

    # -- shared plumbing ---------------------------------------------------

    @contextlib.contextmanager
    def _dispatch(self):
        """The engine's lock, on its device (the pump thread's too)."""
        with self._lock:
            if self.device.type == "cuda":
                with torch.cuda.device(self.device):
                    yield
            else:
                yield

    def snapshot(self, params):
        """A copy of ``params`` on the engine's device that nothing updates
        in place (the service's published G): dispatches given the latest
        snapshot skip the copy into the graphs' buffers while they hold
        it."""
        snap = tree_map(lambda t: t.detach().to(self.device, copy=True),
                        params)
        with self._lock:
            self._snapshot = snap
        return snap

    def _bind(self, role: str, params):
        """Copy ``params`` into the graphs' buffers for ``role`` (made at
        first use).  Any tree but the latest snapshot is copied on every
        dispatch: it may have been updated in place since the last one (a
        live session's G)."""
        if params is self._snapshot and self._held.get(role) is params:
            return
        if role not in self._params:
            self._params[role] = tree_map(
                lambda t: t.detach().to(self.device, copy=True), params)
        else:
            for dst, src in zip(tree_leaves(self._params[role]),
                                tree_leaves(params)):
                dst.copy_(src)
        self._held[role] = params

    # -- request-keyed sampling (the scheduler's path) ---------------------

    def _request_rows(self, st):
        keys = prng.fold_in(prng.fold_in(prng.key(st["seeds"]), st["rids"]),
                            st["offs"])
        z = prng.normal(keys, (self.pair.z_dim,))
        s = self._g_rows(st["g"], z)
        return torch.where(_row_mask(st["valid"], s), s, torch.zeros_like(s))

    def _request_prog(self, bucket: int) -> Program:
        if bucket not in self._request_progs:
            ints = lambda: torch.zeros(bucket, dtype=torch.int64,
                                       device=self.device)
            static = {"g": self._params["g"], "seeds": ints(),
                      "rids": ints(), "offs": ints(),
                      "valid": torch.zeros(bucket, dtype=torch.bool,
                                           device=self.device)}
            self._request_progs[bucket] = Program(self._request_rows, static,
                                                  self.device)
        return self._request_progs[bucket]

    def sample_bucket(self, g_params, bucket: int, seeds, rids, offs,
                      valid=None) -> torch.Tensor:
        """One padded-bucket dispatch: ``seeds``/``rids``/``offs`` are <=
        bucket slot triples (ints or arrays); returns the ``(bucket,
        *sample_shape)`` tensor on the engine's device with padded rows
        zeroed.  Callers slice off the padding."""
        k = len(seeds)
        if valid is None:
            valid = np.arange(bucket) < k
        with self._dispatch():
            self._bind("g", g_params)
            prog = self._request_prog(bucket)
            st = prog.static
            for name, a in (("seeds", seeds), ("rids", rids), ("offs", offs)):
                st[name].copy_(_pad_u32(a, bucket))
            st["valid"].copy_(torch.as_tensor(np.asarray(valid, bool)))
            return prog().clone()

    def sample_request(self, g_params, seed: int, request_id: int,
                       n: int) -> np.ndarray:
        """All ``n`` samples of one request, bucket-chunked — the replay
        path (no scheduler): byte for byte what the micro-batched service
        returns for the same ``(G, seed, request_id)``."""
        out = []
        off = 0
        while off < n:
            k = min(n - off, self.max_bucket)
            b = self.bucket_for(k)
            rows = self.sample_bucket(g_params, b, [seed] * k,
                                      [request_id] * k,
                                      np.arange(off, off + k))
            out.append(rows[:k].cpu().numpy())
            off += k
        return np.concatenate(out)

    # -- discriminator scoring (rejection filter) --------------------------

    def _score_rows(self, st):
        s = self._d_rows(st["d"], st["x"])
        return torch.where(st["valid"], s, torch.full_like(s, -torch.inf))

    def _score_prog(self, bucket: int, row_shape, dtype) -> Program:
        if bucket not in self._score_progs:
            static = {"d": self._params["d"],
                      "x": torch.zeros((bucket,) + tuple(row_shape),
                                       dtype=dtype, device=self.device),
                      "valid": torch.zeros(bucket, dtype=torch.bool,
                                           device=self.device)}
            self._score_progs[bucket] = Program(self._score_rows, static,
                                                self.device)
        return self._score_progs[bucket]

    def score_bucket(self, d_params, x) -> np.ndarray:
        """D logits for ``x`` (n, ...) through the padded bucket ladder
        (chunked over ``max_bucket``); returns (n,) host scores (padding
        scored -inf and cut off)."""
        x = torch.as_tensor(np.asarray(x))
        out = []
        with self._dispatch():
            self._bind("d", d_params)
            for i in range(0, x.shape[0], self.max_bucket):
                xc = x[i:i + self.max_bucket]
                k = xc.shape[0]
                b = self.bucket_for(k)
                prog = self._score_prog(b, xc.shape[1:], xc.dtype)
                prog.static["x"].zero_()
                prog.static["x"][:k].copy_(xc)
                prog.static["valid"].copy_(torch.arange(b) < k)
                out.append(prog()[:k].cpu().numpy())
        return np.concatenate(out)

    # -- bulk stream (carried key, updated in place) -----------------------

    def _stream_rows(self, st, bucket: int):
        keys = prng.split(st["key"], 2)
        z = prng.normal(keys[0], (bucket, self.pair.z_dim))
        st["key"].copy_(keys[1])
        return self.pair.g_apply(st["g"], z)

    def _stream_prog(self, bucket: int) -> Program:
        if bucket not in self._stream_progs:
            static = {"g": self._params["g"], "key": self._stream_key}
            self._stream_progs[bucket] = Program(
                lambda st: self._stream_rows(st, bucket), static,
                self.device, mutable=("key",))
        return self._stream_progs[bucket]

    def seed_stream(self, seed: int) -> None:
        """(Re)start the stream at ``key(seed)``."""
        with self._dispatch():
            k = prng.key(seed, self.device)
            if self._stream_key is None:
                self._stream_key = k
            else:
                self._stream_key.copy_(k)     # the graphs read this buffer

    def sample_stream(self, g_params, n: int) -> np.ndarray:
        """``n`` bulk samples from the carried stream key (seed it once
        with :meth:`seed_stream`).  No per-sample contract: consecutive
        calls continue one stream, full-batch ``g_apply``."""
        if self._stream_key is None:
            self.seed_stream(0)
        out = []
        left = n
        with self._dispatch():
            self._bind("g", g_params)
            while left > 0:
                b = self.bucket_for(min(left, self.max_bucket))
                rows = self._stream_prog(b)()
                out.append(rows[:min(left, b)].cpu().numpy())
                left -= min(left, b)
        return np.concatenate(out)
