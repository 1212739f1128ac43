"""Selective parameter sharing on flat delta rows (port of the reference's
``core/federated.py``: ``FlatLayout``, the selection masks, the transport
codecs, the server combiners and the upload pricing table).

Users compute local weight deltas; only a selected subset crosses the user
boundary (``topk`` — the largest-|delta| fraction, ``threshold``,
``random``).  The server folds the uploads with the paper's elementwise
argmax-|.| rule or a mean.  Every function here works on stacked
``(C, N)`` rows, one row per user: the reference's per-row Python list of
top-k calls becomes one row-batched kernel launch.

Cohort virtualization keeps U logical users' rows in a resident
``CohortStore`` of flat ``(U, N)`` buffers; each round the scheduled cohort
of C rows is gathered, trained and scattered back.  The participation
schedulers are numpy, so a seed gives the reference's schedule bitwise.

The streaming drivers (``core/session.py``) keep the rows behind a
``UserStateBackend`` instead: ``HostStateBackend`` holds the (U, N)
buffers in host memory (pinned for a CUDA run), so U is bounded by host
RAM; ``DeviceStateBackend`` wraps a device ``CohortStore``.
``window_forwarding`` plans a superbatch window's in-window repeats.

The ``*_spmd`` combiners fold one user's delta per rank of a users mesh
(``launch/mesh.py``) with the collectives of ``core/collectives.py``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Literal

import numpy as np
import torch

from repro_torch.core.collectives import pmax, pmean, psum
from repro_torch.core.spec import (register_combiner, register_scheduler,
                                   resolve_scheduler)
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models.common import tree_leaves, tree_map

Selection = Literal["topk", "threshold", "random", "shared_random", "none"]


# ---------------------------------------------------------------------------
# Flat-buffer discriminator layout
# ---------------------------------------------------------------------------

def _paths(tree, prefix=()) -> list[tuple]:
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], prefix + (k,))]
    return [prefix]


@dataclasses.dataclass(frozen=True)
class FlatLayout:
    """Static flatten/unflatten spec for one parameter tree.

    Leaf order is jax's tree order — dict keys sorted, so for the MLP D
    ``l1.b, l1.w, l2.b, l2.w, l3.b, l3.w`` — which makes flat indices
    interchangeable with the reference (the stochastic-rounding hash keys
    on the column index).  ``_stacked`` variants handle trees with a
    leading user axis and ``(U, N)`` rows.  Rows are f32; an int leaf (an
    optimizer's step) is stored as f32 and cast back on unflatten, exact
    below 2**24 as in the reference."""

    paths: tuple
    shapes: tuple
    sizes: tuple
    n: int
    dtypes: tuple = ()

    def flatten(self, tree) -> torch.Tensor:
        return torch.cat([leaf.reshape(-1).to(torch.float32)
                          for leaf in tree_leaves(tree)])

    def flatten_stacked(self, tree) -> torch.Tensor:
        leaves = tree_leaves(tree)
        u = leaves[0].shape[0]
        return torch.cat([leaf.reshape(u, -1).to(torch.float32)
                          for leaf in leaves], dim=1)

    def _cast(self, parts):
        if not self.dtypes:
            return parts
        return [p.to(dt) for p, dt in zip(parts, self.dtypes)]

    def _build(self, parts):
        out: dict = {}
        for path, part in zip(self.paths, parts):
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = part
        return out

    def unflatten(self, flat: torch.Tensor):
        """(N,) -> tree of views into ``flat``."""
        parts = torch.split(flat, self.sizes)
        return self._build(self._cast([p.view(s) for p, s in
                                       zip(parts, self.shapes)]))

    def unflatten_stacked(self, flat: torch.Tensor):
        """(U, N) -> tree with a leading user axis; every leaf is a fresh
        contiguous tensor (not a view into ``flat``)."""
        u = flat.shape[0]
        parts = torch.split(flat, self.sizes, dim=1)
        return self._build(self._cast(
            [p.reshape((u,) + s).clone(memory_format=torch.contiguous_format)
             for p, s in zip(parts, self.shapes)]))


def make_flat_layout(example_tree) -> FlatLayout:
    """Build the static layout from a tree of tensors (shapes and types
    only)."""
    leaves = tree_leaves(example_tree)
    shapes = tuple(tuple(leaf.shape) for leaf in leaves)
    sizes = tuple(math.prod(s) for s in shapes)
    dtypes = tuple(leaf.dtype for leaf in leaves)
    if all(dt == torch.float32 for dt in dtypes):
        dtypes = ()
    return FlatLayout(tuple(_paths(example_tree)), shapes, sizes, sum(sizes),
                      dtypes)


# ---------------------------------------------------------------------------
# Cohort-virtualized per-user state
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CohortStore:
    """Resident per-user state as flat buffers (one row per logical user).

    ``d_flat``     (U, Nd)  discriminator params, FlatLayout row layout
    ``opt_flat``   (U, No)  optimizer state (the int step stored as f32)
    ``last_round`` (U,) i32 the round a user last trained through, plus
                            one (0 = never trained)
    ``residual``   (U, Nd) f32 error-feedback residual (what upload
                            compression dropped from the user's last
                            delta), or None without a lossy codec with
                            error feedback.

    The port scatters into these buffers IN PLACE, where the reference
    returns a new store from its jitted scatter."""

    d_flat: torch.Tensor
    opt_flat: torch.Tensor
    last_round: torch.Tensor
    residual: torch.Tensor | None = None

    @property
    def num_users(self) -> int:
        return self.d_flat.shape[0]

    def clone(self) -> "CohortStore":
        return CohortStore(*(None if t is None else t.clone() for t in (
            self.d_flat, self.opt_flat, self.last_round, self.residual)))


def make_cohort_store(ds, d_opts, d_layout: FlatLayout,
                      opt_layout: FlatLayout, *,
                      error_feedback: bool = False) -> CohortStore:
    """Pack (U, ...)-stacked D/optimizer trees into resident flat buffers;
    ``error_feedback`` allocates the zero-initialized (U, Nd) residual."""
    d_flat = d_layout.flatten_stacked(ds)
    return CohortStore(
        d_flat=d_flat, opt_flat=opt_layout.flatten_stacked(d_opts),
        last_round=torch.zeros((d_flat.shape[0],), dtype=torch.int32,
                               device=d_flat.device),
        residual=torch.zeros_like(d_flat) if error_feedback else None)


def cohort_gather(store: CohortStore, idx: torch.Tensor,
                  d_layout: FlatLayout, opt_layout: FlatLayout):
    """Cohort rows ``idx`` (C,) of the store as stacked (C, ...) D and
    optimizer trees, the layout the round bodies take (fresh tensors)."""
    ds = d_layout.unflatten_stacked(store.d_flat.index_select(0, idx))
    opts = opt_layout.unflatten_stacked(store.opt_flat.index_select(0, idx))
    return ds, opts


def cohort_scatter(store: CohortStore, idx: torch.Tensor, ds, d_opts,
                   round_idx: torch.Tensor, d_layout: FlatLayout,
                   opt_layout: FlatLayout, residual=None) -> CohortStore:
    """Write the cohort's updated rows back (row replacement: values land
    bit-exactly; a schedule row never repeats a user, so rows never
    collide) and stamp the members' ``last_round`` with ``round_idx``.
    ``residual`` rows are scattered iff the store carries them."""
    assert (residual is None) == (store.residual is None), \
        "residual rows must be scattered iff the store carries them"
    store.d_flat.index_copy_(0, idx, d_layout.flatten_stacked(ds))
    store.opt_flat.index_copy_(0, idx, opt_layout.flatten_stacked(d_opts))
    # index_copy_ of the broadcast stamp, not index_fill_ with a tensor
    # value, which reads the value on the host (no CUDA graph could hold it)
    store.last_round.index_copy_(
        0, idx, round_idx.to(torch.int32).expand(idx.shape[0]))
    if residual is not None:
        store.residual.index_copy_(0, idx, residual)
    return store


# ---------------------------------------------------------------------------
# Residency backends for the streaming drivers
# ---------------------------------------------------------------------------
#
# ``gather_rows`` returns copies of the cohort's rows; ``scatter_rows``
# writes updated rows back (row replacement, last writer wins) and stamps
# ``last_round``.  A host backend hands back CPU tensors (the drivers
# compute ages on the host); a ``device_resident`` backend hands back
# device tensors for all three, and the driver keeps the round path on the
# device.  Under the async bounded-staleness driver a round's scatter may
# land after later rounds launched (async parameter-server semantics,
# staleness bounded by ``async_rounds`` and surfaced through the ages).

class UserStateBackend:
    """Residency contract for per-user D/optimizer rows.  ``gather_rows``
    is a 3-tuple whatever the compression; a backend that holds an
    error-feedback residual exposes it through ``gather_residual`` and
    takes updated rows back through ``scatter_rows(..., residual=)``
    (drivers probe ``has_residual``)."""

    num_users: int
    # gather/scatter exchange device tensors: the driver keeps ages and
    # rows on the device and blocks the host only on the metrics fetch
    device_resident: bool = False

    def gather_rows(self, idx):
        raise NotImplementedError

    def scatter_rows(self, idx, d_rows, opt_rows, round_idx, *,
                     residual=None) -> None:
        raise NotImplementedError

    @property
    def has_residual(self) -> bool:
        return False

    def gather_residual(self, idx):
        raise NotImplementedError

    def snapshot(self) -> CohortStore:
        raise NotImplementedError


class DeviceStateBackend(UserStateBackend):
    """Device-resident rows: a ``CohortStore`` behind the backend API.  The
    store is OWNED by the backend and scattered in place (the reference
    replaces its functional store); ``snapshot`` returns a copy."""

    device_resident = True

    def __init__(self, store: CohortStore):
        self.store = store

    @property
    def num_users(self) -> int:
        return self.store.num_users

    def _idx(self, idx) -> torch.Tensor:
        return torch.as_tensor(np.asarray(idx, np.int64)).to(
            self.store.d_flat.device)

    def gather_rows(self, idx):
        i = self._idx(idx)
        s = self.store
        return (s.d_flat.index_select(0, i), s.opt_flat.index_select(0, i),
                s.last_round.index_select(0, i))

    def scatter_rows(self, idx, d_rows, opt_rows, round_idx, *,
                     residual=None) -> None:
        i = self._idx(idx)
        s = self.store
        assert (residual is None) == (s.residual is None)
        s.d_flat.index_copy_(0, i, d_rows)
        s.opt_flat.index_copy_(0, i, opt_rows)
        stamp = torch.as_tensor(round_idx, dtype=torch.int32,
                                device=s.last_round.device)
        s.last_round.index_copy_(0, i, stamp.expand(i.shape[0]))
        if residual is not None:
            s.residual.index_copy_(0, i, residual)

    @property
    def has_residual(self) -> bool:
        return self.store.residual is not None

    def gather_residual(self, idx):
        return self.store.residual.index_select(0, self._idx(idx))

    def snapshot(self) -> CohortStore:
        return self.store.clone()


def _own(a, dtype, pin: bool) -> torch.Tensor:
    """``a`` (numpy or a tensor) as a fresh contiguous CPU tensor of
    ``dtype``, in pinned memory when ``pin``: the store owns its memory,
    since scatters write it in place (``torch.from_numpy`` would alias the
    caller's array)."""
    t = torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor)
                        else a).to(dtype)
    out = torch.empty(tuple(t.shape), dtype=dtype, pin_memory=pin)
    return out.copy_(t)


class HostStateBackend(UserStateBackend):
    """Host-resident rows: (U, N) CPU tensors, pinned when ``pin`` (a run
    on the card), so the C rows of a round are gathered into pinned staging
    and copied to the device asynchronously.  U sizes nothing on the
    accelerator."""

    def __init__(self, d_flat, opt_flat, last_round, residual=None, *,
                 pin: bool = False):
        u = d_flat.shape[0]
        assert opt_flat.shape[0] == u and tuple(last_round.shape) == (u,)
        self.pinned = pin
        self.d_flat = _own(d_flat, torch.float32, pin)
        self.opt_flat = _own(opt_flat, torch.float32, pin)
        self.last_round = _own(last_round, torch.int32, pin)
        self.residual = (None if residual is None
                         else _own(residual, torch.float32, pin))

    @classmethod
    def adopt(cls, d_flat, opt_flat, last_round,
              residual=None) -> "HostStateBackend":
        """A backend that takes ownership of these CPU tensors as they are
        (no copy: the caller must not keep using them)."""
        self = cls.__new__(cls)
        self.pinned = d_flat.is_pinned()
        self.d_flat, self.opt_flat = d_flat, opt_flat
        self.last_round, self.residual = last_round, residual
        return self

    @property
    def num_users(self) -> int:
        return self.d_flat.shape[0]

    @property
    def nbytes(self) -> int:
        """Bytes of the store's buffers."""
        return sum(t.numel() * t.element_size() for t in (
            self.d_flat, self.opt_flat, self.last_round, self.residual)
            if t is not None)

    @classmethod
    def from_store(cls, store: CohortStore, *,
                   pin: bool = False) -> "HostStateBackend":
        return cls(*(None if t is None else t.cpu() for t in (
            store.d_flat, store.opt_flat, store.last_round,
            store.residual)), pin=pin)

    @staticmethod
    def _idx(idx) -> torch.Tensor:
        return torch.as_tensor(np.asarray(idx, np.int64))

    def gather_rows(self, idx, out=None):
        """Copies of rows ``idx`` (into ``out = (d, opt)`` when given)."""
        i = self._idx(idx)
        od, oo = out if out is not None else (None, None)
        return (torch.index_select(self.d_flat, 0, i, out=od),
                torch.index_select(self.opt_flat, 0, i, out=oo),
                self.last_round.index_select(0, i))

    def scatter_rows(self, idx, d_rows, opt_rows, round_idx, *,
                     residual=None) -> None:
        i = self._idx(idx)
        self.d_flat.index_copy_(0, i, torch.as_tensor(d_rows))
        self.opt_flat.index_copy_(0, i, torch.as_tensor(opt_rows))
        self.last_round.index_fill_(0, i, int(round_idx))
        assert (residual is None) == (self.residual is None)
        if residual is not None:
            self.residual.index_copy_(0, i, torch.as_tensor(residual))

    @property
    def has_residual(self) -> bool:
        return self.residual is not None

    def gather_residual(self, idx, out=None):
        return torch.index_select(self.residual, 0, self._idx(idx), out=out)

    def snapshot(self) -> CohortStore:
        """A copy of the store (never a view: later scatters write the
        live buffers in place, which a view would follow)."""
        return CohortStore(*(None if t is None else t.clone() for t in (
            self.d_flat, self.opt_flat, self.last_round, self.residual)))


# ---------------------------------------------------------------------------
# Participation schedulers (host-side numpy: they decide whose data is
# sampled, so they run before anything reaches the device)
# ---------------------------------------------------------------------------

def _sched_full(rng, num_users, cohort, rounds, shard_sizes=None, start=0):
    assert cohort == num_users, (
        f"'full' participation needs cohort == num_users "
        f"(got C={cohort}, U={num_users})")
    return np.tile(np.arange(num_users, dtype=np.int32), (rounds, 1))


def _sched_uniform(rng, num_users, cohort, rounds, shard_sizes=None,
                   start=0):
    return np.stack([rng.choice(num_users, size=cohort, replace=False)
                     for _ in range(rounds)]).astype(np.int32)


def _sched_round_robin(rng, num_users, cohort, rounds, shard_sizes=None,
                       start=0):
    # keyed off the GLOBAL round index so a window generated at start=k
    # continues the rotation where round k-1 left it
    first = np.arange(start, start + rounds, dtype=np.int64)[:, None] * cohort
    return ((first + np.arange(cohort)) % num_users).astype(np.int32)


def _sched_weighted(rng, num_users, cohort, rounds, shard_sizes=None,
                    start=0):
    assert shard_sizes is not None and len(shard_sizes) == num_users, (
        "'weighted' participation needs per-user shard sizes "
        "(dataset.meta['shard_sizes'])")
    p = np.asarray(shard_sizes, np.float64)
    p = p / p.sum()
    return np.stack([rng.choice(num_users, size=cohort, replace=False, p=p)
                     for _ in range(rounds)]).astype(np.int32)


register_scheduler("full", _sched_full)
register_scheduler("uniform", _sched_uniform)
register_scheduler("round_robin", _sched_round_robin)
register_scheduler("weighted", _sched_weighted)


def make_schedule(participation: str, num_users: int, cohort: int,
                  rounds: int, rng: np.random.Generator,
                  shard_sizes=None, start: int = 0) -> np.ndarray:
    """(rounds, C) int32 cohort membership, replacement-free per row.
    ``start`` is the global index of the first generated round:
    rng-driven schedulers consume their stream sequentially, so windows
    generated one after another continue the single-shot schedule."""
    assert 1 <= cohort <= num_users, (cohort, num_users)
    sched = resolve_scheduler(participation)(
        rng, num_users, cohort, rounds, shard_sizes, start=start)
    assert sched.shape == (rounds, cohort)
    return sched


def make_schedule_source(participation: str, num_users: int, cohort: int,
                         shard_sizes=None) -> Callable:
    """Bind a scheduler's static parameters once; returns
    ``schedule_window(rng, start, K) -> (K, C) int32``.  Windows generated
    at ``start=0, K`` then ``start=K, K'`` concatenate to the single-shot
    ``start=0, K+K'`` schedule exactly."""

    def schedule_window(rng: np.random.Generator, start: int,
                        rounds: int) -> np.ndarray:
        return make_schedule(participation, num_users, cohort, rounds, rng,
                             shard_sizes, start=start)

    return schedule_window


def window_forwarding(schedule: np.ndarray, last_round: np.ndarray,
                      round_base: int):
    """Host-side plan for one ``(K, C)`` superbatch window: write-after-read
    forwarding indices and exact participation ages.

    The window's ``(K, C, N)`` row block is gathered before the window
    runs, so a user drawn twice inside it would read a stale staged row in
    its later round.  ``fwd[r, c]`` is the flat position ``r' * C + c'`` of
    user ``schedule[r, c]``'s most recent EARLIER occurrence in the window
    (the row the engine reads from its output block instead), or -1 when
    the staged row is current; a schedule row never repeats a user, so a
    forward source is always from a strictly earlier round.  ``ages[r, c]``
    is the age the per-round path computes, in-window repeats included: a
    member drawn again sees ``last_round == round_base + r' + 1`` (the
    re-zeroed age convention), so its age is ``r - r' - 1``.
    ``last_round`` is not changed.  Returns ``(fwd (K, C) int32, ages (K,
    C) int32)``."""
    K, C = schedule.shape
    fwd = np.full((K, C), -1, np.int32)
    ages = np.empty((K, C), np.int32)
    seen: dict = {}          # user -> (flat position, stamped last_round)
    for r in range(K):
        for c in range(C):
            u = int(schedule[r, c])
            if u in seen:
                pos, stamp = seen[u]
                fwd[r, c] = pos
                ages[r, c] = round_base + r - stamp
            else:
                ages[r, c] = round_base + r - int(last_round[u])
        for c in range(C):
            u = int(schedule[r, c])
            seen[u] = (r * C + c, round_base + r + 1)
    return fwd, ages


def participation_weights(schedule: np.ndarray, num_users: int, *,
                          counts: np.ndarray | None = None,
                          start_round: int = 0) -> np.ndarray:
    """(rounds, C) f32 participation-adaptive combine weights: member u's
    raw weight is ``(expected + 1) / (count_u + 1)`` with ``count_u`` its
    prior participation count and ``expected = r*C/U`` at global round r,
    normalized to mean 1 over the cohort.  ``counts`` (U,) f64 over rounds
    [0, start_round) is UPDATED IN PLACE, so weights generated window by
    window equal the single-shot weights."""
    rounds, cohort = schedule.shape
    if counts is None:
        counts = np.zeros(num_users, np.float64)
    out = np.empty((rounds, cohort), np.float32)
    for r in range(rounds):
        idx = schedule[r]
        expected = (start_round + r) * cohort / num_users
        w = (expected + 1.0) / (counts[idx] + 1.0)
        out[r] = (w / w.mean()).astype(np.float32)
        counts[idx] += 1.0
    return out


# ---------------------------------------------------------------------------
# Selection masks (row-batched)
# ---------------------------------------------------------------------------

def topk_mask(rows: torch.Tensor, frac: float) -> torch.Tensor:
    """The reference's non-kernel ``topk_mask``, row-wise: ``|x| >=`` the
    k-th largest ``|x|`` of the row by value (ties kept).  A NaN compares
    false, so it is never kept, unlike the kernels' bit-pattern order
    (``kernels/ref.py::topk_mask_global_ref``).  Subnormal magnitudes
    count as 0, as in the reference's f32 compare: a subnormal k-th
    magnitude keeps every entry but NaN."""
    mag = kref.flush_subnormals(torch.abs(rows))
    kth = torch.topk(mag, kref.topk_k(rows.shape[-1], frac), dim=-1
                     ).values[..., -1:]
    return mag >= kth


def threshold_mask(rows: torch.Tensor, tau: float) -> torch.Tensor:
    """``|x| > tau`` with subnormal magnitudes as 0, as the reference's f32
    compare takes them (at ``tau = 0`` a subnormal entry is dropped)."""
    return kref.flush_subnormals(torch.abs(rows)) > tau


def random_uniforms(shape, generator: torch.Generator) -> torch.Tensor:
    """The ``random`` selection's uniforms, drawn on the host ``generator``
    (jax's per-user keys cannot be reproduced)."""
    return torch.rand(shape, generator=generator, dtype=torch.float32)


def random_mask(rows: torch.Tensor, frac: float,
                generator: torch.Generator | None = None,
                uniforms: torch.Tensor | None = None) -> torch.Tensor:
    """``uniforms < frac``: the given ``uniforms`` (rows' shape), else a
    draw from ``generator``, moved to the rows' device."""
    if uniforms is None:
        uniforms = random_uniforms(rows.shape, generator)
    return uniforms.to(rows.device) < frac


def select_delta_flat(rows: torch.Tensor, policy: Selection, *, frac=0.1,
                      tau=0.0, generator=None, uniforms=None,
                      use_kernel: bool = False):
    """Apply a selection policy to stacked ``(C, N)`` delta rows
    (``random`` takes its ``uniforms`` or draws them from ``generator``).

    Returns ``(masked (C, N), kept_fraction (C,))``.  ``use_kernel``
    routes top-k through ``kernels.ops.topk_mask`` — the Hopper kernel on
    a CUDA tensor, its plain version on a CPU tensor — one launch for all
    C rows; without it, top-k is :func:`topk_mask` on any device."""
    if policy == "none":
        return rows, torch.ones(rows.shape[0], device=rows.device)
    if policy == "topk":
        mask = (kops.topk_mask(rows, frac) if use_kernel
                else topk_mask(rows, frac))
    elif policy == "threshold":
        mask = threshold_mask(rows, tau)
    elif policy == "random":
        assert generator is not None or uniforms is not None
        mask = random_mask(rows, frac, generator, uniforms)
    else:
        raise ValueError(policy)
    kept = mask.to(torch.float32).mean(dim=1)
    # the reference's ``flat * mask`` is a select under XLA: a dropped
    # entry is +0 even where it is NaN, inf or negative
    return torch.where(mask, rows, 0.0), kept


# ---------------------------------------------------------------------------
# Transport codecs
# ---------------------------------------------------------------------------

def codec_transport(rows: torch.Tensor, codec: str, *,
                    stochastic: bool = False, seed=None,
                    use_kernel: bool = False) -> torch.Tensor:
    """Stacked (R, N) rows -> what the receiver reconstructs after the
    lossy wire round-trip: identity for ``none``, a double cast for
    ``bf16``, per-row absmax int8 for the int8 codecs — through
    ``kernels.ops`` when ``use_kernel`` (the flag that also routes
    top-k), else the plain version.  ``seed`` (an int or a one-element
    int32 tensor on the rows' device) drives stochastic rounding."""
    if codec == "none":
        return rows
    if codec == "bf16":
        return rows.to(torch.bfloat16).to(torch.float32)
    if codec in ("int8", "topk_int8"):
        if use_kernel:
            q, scale = kops.quantize_rows(rows, stochastic=stochastic,
                                          seed=seed)
            return kops.dequantize_rows(q, scale)
        q, scale = kref.quantize_rows_ref(rows, stochastic=stochastic,
                                          seed=seed)
        return kref.dequantize_rows_ref(q, scale)
    raise ValueError(f"unknown codec {codec!r}")


def packed_payload_nbytes(row, policy: Selection | str,
                          codec: str = "none") -> int:
    """Materialize ONE transported (already-masked) row's wire payload as
    packed buffers (int32 indices, codec-encoded values, per-row scale)
    and return their total nbytes: the ground truth ``upload_bytes_flat``
    is held to."""
    row = np.asarray(row, np.float32)
    assert row.ndim == 1, f"one row at a time, got {row.shape}"
    nbytes = 0
    if policy == "none":
        vals = row
    elif policy == "shared_random":
        vals = row[np.nonzero(row)[0]]       # indices derive from the
    else:                                    # shared key: values only
        idx = np.nonzero(row)[0].astype(np.int32)
        vals = row[idx]
        nbytes += idx.nbytes
    if codec == "none":
        nbytes += vals.nbytes
    elif codec == "bf16":
        enc = torch.from_numpy(vals).to(torch.bfloat16)
        nbytes += enc.numel() * enc.element_size()
    elif codec in ("int8", "topk_int8"):
        q, scale = kref.quantize_rows_ref(torch.from_numpy(vals)[None])
        nbytes += q.numpy().nbytes + scale.numpy().nbytes
    else:
        raise ValueError(f"unknown codec {codec!r}")
    return nbytes


# ---------------------------------------------------------------------------
# Server combination rules, on stacked (C, ...) rows
# ---------------------------------------------------------------------------

def combine_max_abs(rows: torch.Tensor) -> torch.Tensor:
    """Paper's rule: per coordinate, the single user's delta with the
    largest magnitude (first user on ties, like ``jnp.argmax``)."""
    idx = torch.argmax(torch.abs(rows), dim=0, keepdim=True)
    return torch.take_along_dim(rows, idx, dim=0)[0]


def combine_mean(rows: torch.Tensor) -> torch.Tensor:
    """FedAvg baseline: mean over users."""
    return torch.mean(rows, dim=0)


def combine_masked_mean(rows: torch.Tensor) -> torch.Tensor:
    """Mean over the users that uploaded each coordinate."""
    nz = (rows != 0).to(rows.dtype)
    cnt = torch.clamp(torch.sum(nz, dim=0), min=1)
    return torch.sum(rows, dim=0) / cnt


def _age_weights(ages: torch.Tensor, decay: float, ndim: int):
    """(C,) ages -> ``decay**age`` weights broadcastable over (C, ...)."""
    w = torch.pow(torch.full(ages.shape, decay, dtype=torch.float32,
                             device=ages.device), ages.to(torch.float32))
    return w.reshape(w.shape + (1,) * (ndim - 1))


def combine_staleness_mean(rows, ages=None, decay: float = 0.5):
    """Staleness-weighted mean, weights relative to the youngest member;
    ``ages=None`` is ``combine_mean``."""
    if ages is None:
        return torch.mean(rows, dim=0)
    ages = ages - torch.min(ages)
    w = _age_weights(ages, decay, rows.ndim)
    return torch.sum(w * rows, dim=0) / torch.sum(w, dim=0)


def combine_staleness_max_abs(rows, ages=None, decay: float = 0.5):
    """Argmax-|.| fold with deltas scaled by ``decay**age`` first."""
    scaled = rows if ages is None else _age_weights(ages, decay,
                                                    rows.ndim) * rows
    idx = torch.argmax(torch.abs(scaled), dim=0, keepdim=True)
    return torch.take_along_dim(scaled, idx, dim=0)[0]


combine_staleness_mean.needs_ages = True
combine_staleness_max_abs.needs_ages = True

register_combiner("max_abs", combine_max_abs)
register_combiner("mean", combine_mean)
register_combiner("masked_mean", combine_masked_mean)
register_combiner("staleness_mean", combine_staleness_mean)
register_combiner("staleness_max_abs", combine_staleness_max_abs)


# ---------------------------------------------------------------------------
# SPMD combination (one user per rank of a users mesh, core/spmd.py)
# ---------------------------------------------------------------------------

def combine_max_abs_spmd(delta_tree, mesh):
    """The paper's max-|.| rule as collectives over ``mesh``: pmax of
    |delta|, then each user contributes its delta only where it attains
    the max, divided by the number of users that tie there.  Only masked
    deltas cross the users axis.  A NaN delta never attains the max and
    contributes nothing (a select, not ``d * mine``: the reference's XLA
    rewrites its product so, and its pmax drops NaN on the CPU)."""

    def one(d):
        mag = torch.abs(d)
        mine = mag == pmax(mag, mesh)
        ties = psum(mine.to(d.dtype), mesh)
        return psum(torch.where(mine, d, 0.0) / torch.clamp(ties, min=1),
                    mesh)

    return tree_map(one, delta_tree)


def combine_mean_spmd(delta_tree, mesh):
    return tree_map(lambda d: pmean(d, mesh), delta_tree)


def shared_random_idx(n: int, frac: float,
                      generator: torch.Generator) -> torch.Tensor:
    """The ``shared_random`` upload's coordinates: the first ``max(int(n *
    frac), 1)`` of a permutation of ``n`` drawn on the host ``generator``.
    The SPMD body draws it from the round's replicated generator, so every
    rank draws the same (jax's permutation cannot be reproduced, so tests
    inject the reference's)."""
    return torch.randperm(n, generator=generator)[:max(int(n * frac), 1)]


def combine_shared_random_flat_spmd(flat: torch.Tensor, idx: torch.Tensor,
                                    mesh):
    """Shokri's random-subset upload as a bandwidth-true collective: every
    user takes the same ``idx`` coordinates of its flat (N,) delta (the
    same on every rank: ``shared_random_idx`` on the replicated
    generator), only those k values are averaged across the users axis,
    and they are scattered back into zeros.  Returns ``(combined (N,),
    uploaded fraction k / N)``."""
    n = flat.shape[0]
    idx = idx.to(device=flat.device, dtype=torch.int64)
    summed = pmean(flat.index_select(0, idx), mesh)
    out = torch.zeros_like(flat).index_copy_(0, idx, summed)
    return out, torch.tensor(idx.shape[0] / n, dtype=torch.float32,
                             device=flat.device)


def combine_shared_random_spmd(delta_tree, idx: torch.Tensor, mesh):
    """Tree form of :func:`combine_shared_random_flat_spmd` (``idx`` indexes
    the tree flattened in FlatLayout order, the reference's
    ``ravel_pytree`` order).  Returns ``(combined tree, uploaded
    fraction)``."""
    layout = make_flat_layout(delta_tree)
    out, kept = combine_shared_random_flat_spmd(layout.flatten(delta_tree),
                                                idx, mesh)
    return layout.unflatten(out), kept


# ---------------------------------------------------------------------------
# Communication accounting
# ---------------------------------------------------------------------------

# bytes per transported value on the wire, by codec
_CODEC_VALUE_BYTES = {"none": 4, "bf16": 2, "int8": 1, "topk_int8": 1}


def upload_bytes_flat(n: int, policy: Selection | str, frac: float = 0.1, *,
                      kept_frac: float | None = None,
                      codec: str = "none") -> int:
    """Per-user upload bytes from the flat buffer size: dense ``none``
    ships one value per entry; sparse policies ship (4 B index, value)
    pairs per kept entry (``threshold`` needs the measured
    ``kept_frac``); ``shared_random`` ships values only; int8 codecs add
    one 4 B f32 scale per row."""
    vb = _CODEC_VALUE_BYTES[codec]
    sb = 4 if codec in ("int8", "topk_int8") else 0   # per-row f32 scale
    if policy == "none":
        return n * vb + sb
    if policy == "threshold":
        assert kept_frac is not None, \
            "threshold accounting needs the measured kept_frac"
        kept = int(round(n * float(kept_frac)))
    elif policy == "shared_random":
        return max(int(n * frac), 1) * vb + sb
    else:
        kept = int(n * frac)
    return kept * (4 + vb) + sb
