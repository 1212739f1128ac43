"""Chunked round engines (port of the reference's ``core/engine.py:70-101,
143-308, 412-741``).

``make_engine`` returns ``chunk(state, reals, noise=None) -> (state,
metrics)``: it runs one round per leading slice of a pre-staged ``(K, U,
B, ...)`` data stack and returns every metric stacked on a leading K axis,
still on the device, so the driver fetches them with one host sync per
chunk.

The reference compiles K rounds into one XLA scan, one dispatch per chunk.
The port's counterpart is a CUDA graph: on a CUDA carry the engine captures
the eager chunk once per chunk length and replays it, so a chunk of K rounds
costs one graph launch.  On a CPU carry it runs the eager chunk.  Either way
the rounds are the same operations on the same data, so ``run(a); run(b)``
equals ``run(a + b)`` bitwise.  ``make_eager_engine`` and
``make_eager_cohort_engine`` are the eager chunks themselves, which the card
checks hold the graphs to.

A graph engine (``_ChunkGraphs``):

* draws a chunk's noise (the approach's registered noise function, the same
  one the body calls inline) on the host before the replay, packs it into one
  pinned buffer and copies it to the graph's device buffers in one H2D copy;
  the chunk's reals, schedule and weights are copied into the graph's static
  input buffers;
* captures lazily, per distinct chunk length, after a one-round warm-up on a
  side stream against a scratch copy of the carry (kernel builds, cuBLAS and
  autograd set-up): the warm-up neither advances the carry nor draws from its
  generator.  The reference pads a remainder chunk with masked rounds; masking
  every leaf would copy the (U, N) store each round, so the port captures the
  shorter chunk as a graph of its own;
* raises if capture or replay fails: there is no eager fallback on the card;
  the garbage collector is off while it captures (collecting an old engine
  would destroy its graphs mid-capture);
* captures, as the eager chunks run, under ``deterministic_convolutions``
  (``device.py``): cuDNN may pick only deterministic algorithms, so a conv
  pair's backward sums in one fixed order and a replay equals the eager
  chunk bitwise; the caller's cuDNN settings are put back after;
* keeps ``kernels.ops``'s launch counts as launches run: the warm-up's and the
  capture's counts are taken back out, and each replay adds the launches its
  graph holds;
* marks its host work as the spans ``engine.noise``, ``engine.load``,
  ``engine.capture`` and ``engine.replay`` (``repro_torch.spans``).

The carry's tensors are the graph's static carry, updated in place (the
reference donates its carry).  A graph engine binds to a carry at its first
call: ``make_engine`` and ``make_fused_store_engine`` to the carry they are
given, ``make_cohort_engine`` to a copy of it.  The returned carry is that
bound carry; the returned metrics are the graph's static outputs.  The next
call overwrites both, so fetch the metrics before it and clone the carry to
keep it.  A call with another carry copies it into the bound one (and leaves
it as it was).

Cohort virtualization (``make_cohort_engine``, ``make_fused_store_engine``):
U LOGICAL users keep their D, optimizer and error-feedback rows in a
resident ``CohortStore``; each round gathers the scheduled cohort's C rows,
runs the width-C body and scatters the rows back, stamping ``last_round``.
The two engines run the same rounds: the plain one leaves the carry it was
given readable (on the CPU it runs each chunk on a clone; on the card on its
own carry, into which a carry it did not return is copied: one copy of the
(U, N) store), the fused-store one consumes it and writes the store in
place.  Both give the same values bitwise, and with C == U under the
``full`` scheduler both equal ``make_engine`` bitwise (the gather is an
exact permutation).

The SPMD engines (one user, or one cohort member, per rank of a users
mesh: ``make_spmd_engine``, ``make_spmd_cohort_engine``,
``make_spmd_fused_store_engine``, ``make_spmd_cohort_rows_engine``) live in
``core/spmd.py`` beside their round body; they run eagerly.

Streamed engines (``make_cohort_rows_engine``, ``make_superbatch_engine``):
the rows live in a ``UserStateBackend`` outside the carry, which is only
the shared state (``CohortShared``); a round (or a K-round window) takes
the gathered rows as inputs and returns the updated ones, one CUDA graph
replay per round (per window length) on the card.  They run the cohort
round's operations, so a streamed run equals the cohort engines' bitwise.
"""

from __future__ import annotations

import dataclasses
import gc
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core.approaches import (DistGANConfig, DistGANState, _opts,
                                         d_flat_layout, d_opt_flat_layout,
                                         init_state, state_template)
from repro_torch.core.federated import (CohortStore, HostStateBackend,
                                        as_batch,
                                        cohort_gather, cohort_scatter,
                                        make_cohort_store)
from repro_torch.core.spec import DEFAULT_ROUNDS_PER_JIT, resolve_approach
from repro_torch.device import deterministic_convolutions, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.spans import span


def _stack_metrics(metrics: list) -> dict:
    return {key: torch.stack([m[key] for m in metrics]) for key in metrics[0]}


def _round_noise(noise, k: int) -> dict:
    return {} if noise is None else noise[k]


def make_eager_engine(pair, fcfg: DistGANConfig, approach: str) -> Callable:
    """The eager chunk: ``chunk(state, reals, noise=None)``, one body call
    per round, the state updated in place.  ``noise`` is an optional list
    of K keyword dicts of the rounds' draws (what a dict lacks is drawn
    inline)."""
    body = resolve_approach(approach).body_factory(pair, fcfg)

    def chunk(state, reals, noise=None):
        metrics = []
        with deterministic_convolutions():
            for k in range(reals.shape[0]):
                state, m = body(state, reals[k], **_round_noise(noise, k))
                metrics.append(m)
        return state, _stack_metrics(metrics)

    return chunk


def make_engine(pair, fcfg: DistGANConfig, approach: str) -> Callable:
    """``chunk(state, reals, noise=None) -> (state, metrics)``: a CUDA graph
    per chunk length on a CUDA carry, the eager chunk on a CPU carry."""
    eager = make_eager_engine(pair, fcfg, approach)
    graphs = _ChunkGraphs(
        lambda st, inp, noise: eager(st, inp["reals"], noise)[1],
        resolve_approach(approach).noise_factory(pair, fcfg),
        lambda st, inp: (st.clone(), {"reals": inp["reals"][:1]}))

    def chunk(state, reals, noise=None):
        if state.step.device.type != "cuda":
            return eager(state, reals, noise)
        return graphs(state, {"reals": reals}, noise)

    chunk.graphs = graphs
    return chunk


# ---------------------------------------------------------------------------
# CUDA graphs over a chunk
# ---------------------------------------------------------------------------

def carry_tensors(carry) -> list:
    """Every tensor of a ``DistGANState`` or ``CohortState``, in field
    order (the generator is not a tensor)."""
    out = []
    for f in dataclasses.fields(carry):
        v = getattr(carry, f.name)
        if isinstance(v, CohortStore):
            out += [t for t in (v.d_flat, v.opt_flat, v.last_round,
                                v.residual) if t is not None]
        elif isinstance(v, (dict, torch.Tensor)):
            out += tree_leaves(v)
    return out


def _as_tensor(value) -> torch.Tensor:
    """A drawn value as a tensor (an int seed as a (1,) int32 tensor)."""
    if isinstance(value, torch.Tensor):
        return value
    return torch.tensor([value], dtype=torch.int32)


class NoiseBuffers:
    """A chunk's round noise in one host buffer (pinned for a CUDA device)
    and one device buffer of the same bytes, each key a ``(K, ...)`` view
    of both (16-byte aligned), so a chunk's draws reach the device in one
    copy.  The keys, shapes and types come from one round's draws."""

    def __init__(self, example: dict, rounds: int, device):
        self.rounds, self.device = rounds, torch.device(device)
        self.layout, off = [], 0
        for key, value in example.items():
            t = _as_tensor(value)
            nbytes = rounds * t.numel() * t.element_size()
            self.layout.append((key, off, nbytes, t.dtype, tuple(t.shape)))
            off += -(-nbytes // 16) * 16
        cuda = self.device.type == "cuda"
        self.host = torch.empty(off, dtype=torch.uint8, pin_memory=cuda)
        self.dev = torch.empty(off, dtype=torch.uint8, device=self.device)
        self.host_views, self.dev_views = self._views(self.host), \
            self._views(self.dev)
        self._copied = None       # event after the last host -> device copy

    def _views(self, buf) -> dict:
        return {key: buf[off:off + n].view(dt).view((self.rounds,) + shape)
                for key, off, n, dt, shape in self.layout}

    def load(self, draws: list) -> None:
        """Write K rounds' draws into the host buffer (once its last copy
        has run) and copy it to the device buffer on the current stream."""
        if self._copied is not None:
            self._copied.synchronize()
        for r, d in enumerate(draws):
            for key, view in self.host_views.items():
                view[r].copy_(_as_tensor(d[key]).reshape(view.shape[1:]))
        self.dev.copy_(self.host, non_blocking=True)
        if self.device.type == "cuda":
            self._copied = torch.cuda.Event()
            self._copied.record()

    def round_views(self) -> list:
        """K keyword dicts of device views, one per round."""
        return [{key: v[r] for key, v in self.dev_views.items()}
                for r in range(self.rounds)]


@dataclasses.dataclass
class _Graph:
    """One captured chunk length: its static inputs, noise buffers, graph,
    static metrics and the kernel launches one replay runs."""

    inputs: dict
    noise: NoiseBuffers
    graph: Any = None
    metrics: dict | None = None
    launches: dict | None = None

    def load(self, inputs: dict, draws: list) -> None:
        for name, buf in self.inputs.items():
            buf.copy_(inputs[name], non_blocking=True)
        self.noise.load(draws)


class _ChunkGraphs:
    """The CUDA graphs of one eager chunk over one bound carry, one per
    chunk length (see the module docstring).

    ``rounds_fn(carry, inputs, noise) -> metrics`` runs the K rounds of
    ``inputs`` (name -> (K, ...) tensor) in place on ``carry``; ``draw`` is
    the approach's noise function; ``scratch_fn(carry, inputs) ->
    (scratch carry, one-round inputs)`` builds the warm-up's throwaway
    copy; ``copy_carry`` binds to a copy of the first carry."""

    def __init__(self, rounds_fn, draw, scratch_fn, copy_carry=False):
        self.rounds_fn, self.draw = rounds_fn, draw
        self.scratch_fn, self.copy_carry = scratch_fn, copy_carry
        self.carry = None
        self.graphs: dict[int, _Graph] = {}
        self.stream = None
        self.replays = 0          # replay() calls (the contract checker's)

    def _bind(self, carry):
        if self.carry is None:
            self.carry = carry.clone() if self.copy_carry else carry
        elif carry is not self.carry:
            for dst, src in zip(carry_tensors(self.carry),
                                carry_tensors(carry)):
                dst.copy_(src)
            self.carry.generator.set_state(carry.generator.get_state())
        return self.carry

    def __call__(self, carry, inputs: dict, noise=None):
        carry = self._bind(carry)
        inputs = {k: v for k, v in inputs.items() if v is not None}
        k = inputs["reals"].shape[0]
        shape = tuple(inputs["reals"].shape[1:])
        with span("engine.noise"):
            draws = [self.draw(carry.generator, shape,
                               **_round_noise(noise, r)) for r in range(k)]
        g = self.graphs.get(k)
        with span("engine.load"):
            if g is None:
                dev = carry.step.device
                g = _Graph({name: torch.empty_like(t, device=dev)
                            for name, t in inputs.items()},
                           NoiseBuffers(draws[0], k, dev))
            g.load(inputs, draws)
        if g.graph is None:
            with span("engine.capture"), deterministic_convolutions():
                self.graphs[k] = self._capture(carry, g)
        with span("engine.replay"):
            g.graph.replay()
        self.replays += 1
        kops.add_launch_counts(g.launches)
        return carry, g.metrics

    def _capture(self, carry, g: _Graph) -> _Graph:
        """Warm up and capture ``g``, whose buffers hold a chunk's inputs."""
        dev = carry.step.device
        noise = g.noise.round_views()
        if self.stream is None:
            self.stream = torch.cuda.Stream(dev)
        before = kops.launch_counts()
        self.stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(self.stream):
            # built on the side stream, so its memory is freed there
            scratch, warm = self.scratch_fn(carry, g.inputs)
            self.rounds_fn(scratch, warm, noise[:1])
            del scratch, warm
        warm_counts = kops.launch_counts()
        g.graph = torch.cuda.CUDAGraph()
        # No garbage collection while capturing: collecting an unreachable
        # object that owns a CUDA graph (an old session's engine, which its
        # driver references back) destroys the graph, which a capture does
        # not permit.  thread_local: another thread's CUDA calls (a
        # profiler's buffer thread) do not invalidate this capture either.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(g.graph, stream=self.stream,
                                  capture_error_mode="thread_local"):
                g.metrics = self.rounds_fn(carry, g.inputs, noise)
        finally:
            if collecting:
                gc.enable()
        after = kops.launch_counts()
        g.launches = {key: after[key] - warm_counts[key] for key in after}
        kops.add_launch_counts({key: before[key] - after[key]
                                for key in after})
        return g


# ---------------------------------------------------------------------------
# Cohort-virtualized engines: U logical users, C-wide rounds
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CohortState:
    """Carry of the cohort engines: the shared training state plus the
    resident per-user ``CohortStore``.  On a rank of the SPMD cohort
    engines (``core/spmd.py``) the shared part is replicated and the store
    is either the whole (U, N) store, on every rank, or the rank's block of
    U / C rows (the sharded store)."""

    g: Any
    g_opt: Any
    store: CohortStore
    server_d: Any
    step: torch.Tensor
    generator: torch.Generator

    def clone(self) -> "CohortState":
        """A deep copy (tensors and the host generator's position)."""
        gen = torch.Generator()
        gen.set_state(self.generator.get_state())
        copy = lambda t: t.clone()
        return CohortState(tree_map(copy, self.g), tree_map(copy, self.g_opt),
                           self.store.clone(), tree_map(copy, self.server_d),
                           self.step.clone(), gen)


def _wants_residual(fcfg: DistGANConfig) -> bool:
    """Whether the run keeps per-user error-feedback rows: a lossy codec
    with error feedback on.  The one gate every engine and driver reads."""
    return fcfg.codec != "none" and fcfg.error_feedback


def init_cohort_state(pair, fcfg: DistGANConfig, seed: int, device, *,
                      sync_ds: bool = False) -> CohortState:
    """The cohort carry built from ``init_state`` (its (U, ...)-stacked
    trees packed into flat rows bit-exactly, so a C == U cohort run starts
    from the same point as the plain engine)."""
    st = init_state(pair, fcfg, seed, device, sync_ds=sync_ds)
    store = make_cohort_store(st.ds, st.d_opts, d_flat_layout(pair),
                              d_opt_flat_layout(pair, fcfg),
                              error_feedback=_wants_residual(fcfg))
    return CohortState(st.g, st.g_opt, store, st.server_d, st.step,
                       st.generator)


def cohort_state_template(pair, fcfg: DistGANConfig) -> CohortState:
    """``init_cohort_state``'s shapes and types as meta tensors (nothing
    drawn, no (U, N) store materialized)."""
    st = state_template(pair, fcfg)
    store = make_cohort_store(st.ds, st.d_opts, d_flat_layout(pair),
                              d_opt_flat_layout(pair, fcfg),
                              error_feedback=_wants_residual(fcfg))
    return CohortState(st.g, st.g_opt, store, st.server_d, st.step,
                       st.generator)


def cohort_state_to_full(pair, fcfg: DistGANConfig,
                         cstate: CohortState) -> DistGANState:
    """The store unpacked into the stacked-tree ``DistGANState`` layout
    (fresh tensors; the carry's shared leaves are shared)."""
    idx = torch.arange(cstate.store.num_users, device=cstate.step.device)
    ds, d_opts = cohort_gather(cstate.store, idx, d_flat_layout(pair),
                               d_opt_flat_layout(pair, fcfg))
    return DistGANState(cstate.g, cstate.g_opt, ds, d_opts, cstate.server_d,
                        cstate.step, cstate.generator)


def _cohort_round_fn(pair, fcfg: DistGANConfig, approach: str) -> Callable:
    """One store-resident cohort round: gather the scheduled rows, run the
    width-C body (with each member's age ``step - last_round``, the
    optional combine weights and error-feedback rows), scatter the rows
    back stamped ``last_round = step + 1``.  Updates the carry in place;
    returns the round's metrics plus ``mean_age``, on the device."""
    appr = resolve_approach(approach)
    assert appr.user_axis, f"{approach} has no user axis to virtualize"
    body = appr.body_factory(pair, fcfg)
    d_layout = d_flat_layout(pair)
    o_layout = d_opt_flat_layout(pair, fcfg)
    ef = _wants_residual(fcfg)

    def round_fn(carry: CohortState, real, idx, w=None, noise=None):
        store = carry.store
        ds, opts = cohort_gather(store, idx, d_layout, o_layout)
        ages = carry.step - store.last_round.index_select(0, idx)  # (C,)
        # last_round records the round a member trained THROUGH, as
        # round + 1 (0 = never): a member drawn again next round has age 0
        stamp = carry.step + 1
        state = DistGANState(carry.g, carry.g_opt, ds, opts, carry.server_d,
                             carry.step, carry.generator)
        noise = noise or {}
        if ef:
            new_state, metrics, new_res = body(
                state, real, ages, w, store.residual.index_select(0, idx),
                **noise)
        else:
            new_state, metrics = body(state, real, ages, w, **noise)
            new_res = None
        cohort_scatter(store, idx, new_state.ds, new_state.d_opts, stamp,
                       d_layout, o_layout, residual=new_res)
        return dict(metrics, mean_age=torch.mean(ages.to(torch.float32)))

    return round_fn


def make_eager_cohort_engine(pair, fcfg: DistGANConfig, approach: str,
                             adaptive: bool = False,
                             copy_carry: bool = True) -> Callable:
    """The eager cohort chunk (``copy_carry``: on a clone of the carry it
    is given, which it returns; else in place)."""
    round_fn = _cohort_round_fn(pair, fcfg, approach)

    def chunk(cstate: CohortState, reals, idx, wts=None, noise=None):
        """``reals (K, C, B, ...)`` the cohorts' private batches, ``idx
        (K, C)`` int64 cohort membership, ``wts (K, C)`` f32 combine
        weights (iff built ``adaptive``), ``noise`` an optional list of K
        keyword dicts (``z1``, ``z2``, ``seed``) replacing the bodies'
        draws.  Returns ``(carry, metrics)``, each metric stacked on a
        leading K axis on the device: no host sync inside a chunk."""
        assert (wts is not None) == adaptive, \
            "wts must be supplied iff the engine was built adaptive=True"
        if copy_carry:
            cstate = cstate.clone()
        with deterministic_convolutions():
            metrics = [round_fn(cstate, reals[k], idx[k],
                                None if wts is None else wts[k],
                                _round_noise(noise, k))
                       for k in range(reals.shape[0])]
        return cstate, _stack_metrics(metrics)

    return chunk


def _cohort_scratch(carry: CohortState, inputs: dict):
    """The warm-up's carry: the shared leaves cloned and a store of just
    the first round's C rows, with that round's inputs re-indexed to it."""
    idx = inputs["idx"][0]
    s = carry.store
    rows = CohortStore(*(None if t is None else t.index_select(0, idx)
                         for t in (s.d_flat, s.opt_flat, s.last_round,
                                   s.residual)))
    copy = lambda t: t.clone()
    scratch = CohortState(tree_map(copy, carry.g), tree_map(copy, carry.g_opt),
                          rows, tree_map(copy, carry.server_d),
                          carry.step.clone(), torch.Generator())
    warm = {name: t[:1] for name, t in inputs.items()}
    warm["idx"] = torch.arange(idx.shape[0], device=idx.device)[None]
    return scratch, warm


def _cohort_engine(pair, fcfg, approach, adaptive, copy_carry) -> Callable:
    eager = make_eager_cohort_engine(pair, fcfg, approach, adaptive,
                                     copy_carry)
    in_place = make_eager_cohort_engine(pair, fcfg, approach, adaptive,
                                        copy_carry=False)
    graphs = _ChunkGraphs(
        lambda st, inp, noise: in_place(st, inp["reals"], inp["idx"],
                                        inp.get("wts"), noise)[1],
        resolve_approach(approach).noise_factory(pair, fcfg),
        _cohort_scratch, copy_carry=copy_carry)

    def chunk(cstate: CohortState, reals, idx, wts=None, noise=None):
        if cstate.step.device.type != "cuda":
            return eager(cstate, reals, idx, wts, noise)
        assert (wts is not None) == adaptive, \
            "wts must be supplied iff the engine was built adaptive=True"
        return graphs(cstate, {"reals": reals, "idx": idx, "wts": wts},
                      noise)

    chunk.graphs = graphs
    return chunk


def make_cohort_engine(pair, fcfg: DistGANConfig, approach: str,
                       adaptive: bool = False) -> Callable:
    """Cohort engine that leaves the carry it was given readable: on the
    CPU it runs each chunk on a copy (one copy of the (U, N) store per
    chunk) and returns the copy; on the card it returns its own carry,
    which its next call overwrites, and copies into it any carry it did
    not return."""
    return _cohort_engine(pair, fcfg, approach, adaptive, copy_carry=True)


def make_fused_store_engine(pair, fcfg: DistGANConfig, approach: str,
                            adaptive: bool = False) -> Callable:
    """Store-resident cohort engine: the same rounds as
    ``make_cohort_engine`` with the carry CONSUMED, so the cohort rows are
    scattered into the (U, N) store in place and no per-chunk copy is
    made.  The caller rebinds to the returned carry."""
    return _cohort_engine(pair, fcfg, approach, adaptive, copy_carry=False)


# ---------------------------------------------------------------------------
# Streamed cohort engines: the rows live in a UserStateBackend, not the carry
# ---------------------------------------------------------------------------
#
# The cohort engines above keep the whole (U, N) store in the device carry.
# The rows engines invert that: the store lives in a host (or device)
# ``UserStateBackend`` and a dispatch consumes only gathered cohort rows,
# (C, Nd) / (C, No) tensors that crossed the host -> device boundary.  Only
# the shared training state (``CohortShared``) chains on the device, so the
# driver (``core/session.py::stream_cohort_rounds``) can stage round k + 1
# while round k runs, and under bounded staleness defer round k's scatter.

@dataclasses.dataclass
class CohortShared:
    """Shared training state of a streamed run; the per-user rows are not
    here, they enter each round as gathered-row arguments.  Under the
    ``spmd`` backend every rank holds the same one (G, its optimizer, the
    server D, the step and the round-noise generator, replicated), and
    rank r trains member r of the rows it is given."""

    g: Any
    g_opt: Any
    server_d: Any
    step: torch.Tensor
    generator: torch.Generator

    def clone(self) -> "CohortShared":
        """A deep copy (tensors and the host generator's position)."""
        gen = torch.Generator()
        gen.set_state(self.generator.get_state())
        copy = lambda t: t.clone()
        return CohortShared(tree_map(copy, self.g), tree_map(copy, self.g_opt),
                            tree_map(copy, self.server_d), self.step.clone(),
                            gen)


def _rows_round_fn(pair, fcfg: DistGANConfig, approach: str) -> Callable:
    """One round over gathered rows: ``round_fn(shared, d_rows, opt_rows,
    res_rows, ages, w, real, noise) -> (nd, no, new_res, metrics)``, the
    same unflatten -> body -> flatten as the store-resident cohort round,
    so a streamed run gives the cohort engine's values (``shared`` updated
    in place; ``new_res`` is None without error feedback)."""
    appr = resolve_approach(approach)
    assert appr.user_axis, f"{approach} has no user axis to virtualize"
    body = appr.body_factory(pair, fcfg)
    d_layout = d_flat_layout(pair)
    o_layout = d_opt_flat_layout(pair, fcfg)
    ef = _wants_residual(fcfg)

    def round_fn(shared: CohortShared, d_rows, opt_rows, res_rows, ages, w,
                 real, noise):
        state = DistGANState(shared.g, shared.g_opt,
                             d_layout.unflatten_stacked(d_rows),
                             o_layout.unflatten_stacked(opt_rows),
                             shared.server_d, shared.step, shared.generator)
        if ef:
            new_state, metrics, new_res = body(state, real, ages, w,
                                               res_rows, **noise)
        else:
            new_state, metrics = body(state, real, ages, w, **noise)
            new_res = None
        return (d_layout.flatten_stacked(new_state.ds),
                o_layout.flatten_stacked(new_state.d_opts), new_res,
                dict(metrics, mean_age=torch.mean(ages.to(torch.float32))))

    return round_fn


def _rows_scratch(carry: CohortShared, inputs: dict):
    return carry.clone(), {name: t[:1].clone() for name, t in inputs.items()}


def make_cohort_rows_engine(pair, fcfg: DistGANConfig,
                            approach: str) -> Callable:
    """One-round engine over gathered cohort rows.

    ``round(shared, d_rows, opt_rows, ages, wts, real, noise=None) ->
    (shared, new_d_rows, new_opt_rows, metrics)``, with ``d_rows (C, Nd)`` /
    ``opt_rows (C, No)`` the cohort's rows, ``ages (C,)`` int32, ``wts
    (C,)`` f32 or None and ``real (C, B, ...)``; with error feedback the
    residual rows come right after the optimizer rows and go back right
    after them: ``round(shared, d_rows, opt_rows, res_rows, ages, wts,
    real) -> (shared, nd, no, new_res, metrics)``.  ``noise`` is an
    optional keyword dict of the round's draws.

    On a CUDA carry a round is one CUDA graph replay over static input
    buffers (``_ChunkGraphs`` with one-round chunks): the rows, ages,
    weights and batch are copied into them, and the returned rows and
    metrics are the graph's static outputs, which the next call
    overwrites.  On a CPU carry it runs eagerly."""
    round_fn = _rows_round_fn(pair, fcfg, approach)
    ef = _wants_residual(fcfg)

    def rounds(shared, inp: dict, noise=None) -> dict:
        nd, no, nres, m = round_fn(
            shared, inp["d_rows"][0], inp["opt_rows"][0],
            inp["res_rows"][0] if ef else None, inp["ages"][0],
            inp["wts"][0] if "wts" in inp else None, inp["reals"][0],
            _round_noise(noise, 0))
        out = dict(m, d_rows=nd, opt_rows=no)
        if ef:
            out["res_rows"] = nres
        return out

    graphs = _ChunkGraphs(rounds,
                          resolve_approach(approach).noise_factory(pair,
                                                                   fcfg),
                          _rows_scratch)

    def engine(shared: CohortShared, d_rows, opt_rows, *rest, noise=None):
        if ef:
            res_rows, ages, wts, real = rest
        else:
            (ages, wts, real), res_rows = rest, None
        inp = {"reals": real[None], "d_rows": d_rows[None],
               "opt_rows": opt_rows[None], "ages": ages[None]}
        if ef:
            inp["res_rows"] = res_rows[None]
        if wts is not None:
            inp["wts"] = wts[None]
        if shared.step.device.type == "cuda":
            shared, out = graphs(shared, inp, None if noise is None
                                 else [noise])
        else:
            with deterministic_convolutions():
                out = rounds(shared, inp, None if noise is None else [noise])
        out = dict(out)
        rows = (out.pop("d_rows"), out.pop("opt_rows"))
        if ef:
            rows += (out.pop("res_rows"),)
        return (shared, *rows, out)

    engine.graphs = graphs
    return engine


def make_superbatch_engine(pair, fcfg: DistGANConfig, approach: str,
                           adaptive: bool = False) -> Callable:
    """Windowed engine for host-resident stores: a whole K-round window over
    ONE staged row block, one dispatch.

    ``window(shared, blk_d, blk_o, fwd, ages, real, wts=None, noise=None)
    -> (shared, blk_d, blk_o, metrics)`` (with error feedback ``window(
    shared, blk_d, blk_o, blk_r, fwd, ages, real, ...) -> (shared, blk_d,
    blk_o, blk_r, metrics)``):

    * ``blk_d (K, C, Nd)`` / ``blk_o (K, C, No)`` (/ ``blk_r``) — the
      scheduled rows, gathered before the window ran; row block r is
      overwritten with round r's updated rows, so the returned blocks are
      what the host scatters back, in round order.
    * ``fwd (K, C)`` — ``core.federated.window_forwarding``'s plan: -1
      reads the staged row, else the flat ``r' * C + c'`` position of the
      same user's latest in-window write, whose updated bytes (and
      residual) round r reads instead, exactly the row the per-round path
      would have scattered and gathered again.
    * ``ages (K, C)`` int32, exact under forwarding; ``wts (K, C)`` iff
      built ``adaptive``.

    On a CUDA carry a window is one CUDA graph replay, one graph per window
    length K (the blocks are its static inputs, updated in place and
    returned); on a CPU carry the blocks are updated in place eagerly.
    Each round runs the rows engine's round verbatim."""
    round_fn = _rows_round_fn(pair, fcfg, approach)
    ef = _wants_residual(fcfg)
    names = ("blk_d", "blk_o") + (("blk_r",) if ef else ())

    def rounds(shared, inp: dict, noise=None) -> dict:
        fwd = inp["fwd"].to(torch.int64)
        k, c = fwd.shape
        flat = {n: inp[n].view(k * c, -1) for n in names}
        own = torch.arange(c, device=fwd.device)
        metrics = []
        for r in range(k):
            # one gather serves both sources: a member not forwarded reads
            # its own staged row r*C + c (earlier rounds wrote only their
            # own rows), a forwarded one its latest in-window write
            src = torch.where(fwd[r] >= 0, fwd[r], r * c + own)
            rows = [flat[n].index_select(0, src) for n in names]
            nd, no, nres, m = round_fn(
                shared, rows[0], rows[1], rows[2] if ef else None,
                inp["ages"][r], inp["wts"][r] if "wts" in inp else None,
                inp["reals"][r], _round_noise(noise, r))
            for n, new in zip(names, (nd, no, nres)):
                inp[n][r].copy_(new)
            metrics.append(m)
        return dict(_stack_metrics(metrics), **{n: inp[n] for n in names})

    graphs = _ChunkGraphs(rounds,
                          resolve_approach(approach).noise_factory(pair,
                                                                   fcfg),
                          _rows_scratch)

    def window(shared: CohortShared, *args, wts=None, noise=None):
        assert (wts is not None) == adaptive, \
            "wts must be supplied iff the engine was built adaptive=True"
        blocks, (fwd, ages, real) = args[:len(names)], args[len(names):]
        inp = dict(zip(names, blocks), reals=real, fwd=fwd, ages=ages)
        if wts is not None:
            inp["wts"] = wts
        if shared.step.device.type == "cuda":
            shared, out = graphs(shared, inp, noise)
        else:
            with deterministic_convolutions():
                out = rounds(shared, inp, noise)
        out = dict(out)
        blocks = tuple(out.pop(n) for n in names)
        return (shared, *blocks, out)

    window.graphs = graphs
    return window


def init_host_backend(pair, fcfg: DistGANConfig, seed: int, device, *,
                      sync_ds: bool = False):
    """Host-resident analogue of ``init_cohort_state``: ``(CohortShared on
    device, HostStateBackend)`` with the SAME values (bitwise), drawn from
    the same host generator in the same order as ``init_state``, each
    user's D straight into its host row, so no (U, N) buffer is ever on
    the device.  The store is pinned for a CUDA ``device``.  Optimizer
    rows are the zero init, built once and broadcast."""
    device = torch.device(device)
    pin = device.type == "cuda"
    gen = torch.Generator().manual_seed(seed)
    g_opt_def, d_opt_def = _opts(fcfg)
    g, d0 = pair.init(gen, device)
    dl = d_flat_layout(pair)
    ol = d_opt_flat_layout(pair, fcfg)
    u = fcfg.num_users
    d_flat = torch.empty((u, dl.n), dtype=torch.float32, pin_memory=pin)
    if sync_ds:
        d_flat.copy_(dl.flatten(d0).cpu().expand(u, dl.n))
    else:
        for i in range(u):
            d_flat[i] = dl.flatten(pair.init(gen, "cpu")[1])
    d0_cpu = tree_map(lambda t: t.cpu(), d0)
    o_row = ol.flatten(d_opt_def.init(d0_cpu))
    opt_flat = torch.empty((u, ol.n), dtype=torch.float32, pin_memory=pin)
    opt_flat.copy_(o_row.expand(u, ol.n))
    residual = None
    if _wants_residual(fcfg):
        residual = torch.zeros((u, dl.n), dtype=torch.float32,
                               pin_memory=pin)
    backend = HostStateBackend.adopt(
        d_flat, opt_flat,
        torch.zeros((u,), dtype=torch.int32, pin_memory=pin), residual)
    shared = CohortShared(g, g_opt_def.init(g), d0,
                          torch.zeros((), dtype=torch.int32, device=device),
                          gen)
    return shared, backend


def shared_template(pair, fcfg: DistGANConfig) -> CohortShared:
    """``init_host_backend``'s shared state as meta tensors (nothing
    drawn)."""
    st = state_template(pair, fcfg)
    return CohortShared(st.g, st.g_opt, st.server_d, st.step, st.generator)


# ---------------------------------------------------------------------------
# Chunked drivers
# ---------------------------------------------------------------------------

def _pad_to(arr: np.ndarray, k: int):
    """Pad ``arr`` on the leading axis to length ``k`` by repeating its last
    entry (the reference pads a remainder chunk with masked rounds; the
    port's engines take a short chunk as it is, so no driver of the port
    pads: this is the reference's helper for code that mirrors it)."""
    short = k - arr.shape[0]
    if short <= 0:
        return arr
    fill = np.broadcast_to(arr[-1:], (short,) + arr.shape[1:])
    return np.concatenate([arr, fill], axis=0)


def run_scanned(engine: Callable, state, reals,
                rounds_per_jit: int = DEFAULT_ROUNDS_PER_JIT):
    """Drive a ``make_engine`` chunk over ``reals`` (leading axis = rounds)
    in chunks of ``rounds_per_jit``, the last one shorter (on the card a
    graph of its own length, where the reference pads it with masked
    rounds).  Returns ``(state, metrics)``, metrics numpy-concatenated over
    the rounds."""
    reals = torch.as_tensor(as_batch(reals)).to(state.step.device)
    total = reals.shape[0]
    rpj = min(rounds_per_jit, total)
    chunks, i = [], 0
    while i < total:
        k = min(rpj, total - i)
        state, m = engine(state, reals[i:i + k])
        chunks.append({key: v.cpu().numpy() for key, v in m.items()})
        i += k
    return state, {key: np.concatenate([c[key] for c in chunks])
                   for key in chunks[0]}


# ---------------------------------------------------------------------------
# Contract-checker introspection (read by repro_torch.analysis.tracecheck)
# ---------------------------------------------------------------------------

class TraceSpecimen(NamedTuple):
    """One engine call with tiny concrete inputs plus the contract it must
    keep (the reference's ``core/engine.py:742``).

    ``donate`` is the argument positions the factory updates IN PLACE: the
    checker asserts their tensors keep their storage through a call and a
    donated carry comes back as the one the engine bound; with ``donate``
    empty the arguments must come back bitwise unchanged (the engine works
    on a copy).  ``expect_graph``: on a CUDA carry one call is one replay
    of one CUDA graph per chunk length, running ``rounds`` rounds.
    ``launches`` is one round's kernel launches (``kernels.ops`` keys);
    a call runs ``rounds`` times that.  ``kwargs`` are keyword arguments of
    the call (an eager step's round noise, drawn before the round as the
    graph engines draw it).  The reference's ``min_barriers`` has no
    counterpart: eager torch fuses nothing, so there is no barrier pin to
    prove."""

    name: str
    fn: Callable
    args: tuple
    donate: tuple
    expect_graph: bool = True
    rounds: int = 1
    launches: dict | None = None
    kwargs: dict | None = None


def round_launches(fcfg: DistGANConfig, approach: str) -> dict:
    """One round's kernel launches (``kernels.ops`` keys): an uploading
    approach under ``use_topk_kernel`` selects with one B1 launch over all
    its rows (top-k) and round-trips them through one quantize and one
    dequantize launch (an int8 codec)."""
    out = {}
    if resolve_approach(approach).uploads and fcfg.use_topk_kernel:
        if fcfg.selection == "topk":
            out["topk_mask_rows"] = 1
        if fcfg.codec in ("int8", "topk_int8"):
            out["quantize_rows"] = out["dequantize_rows"] = 1
    return out


def sample_shape(pair) -> tuple:
    """One data sample's shape, from the generator itself (so a specimen
    tracks any pair architecture)."""
    gen = torch.Generator().manual_seed(0)
    g, _ = pair.init(gen, "cpu")
    return tuple(pair.g_apply(g, pair.sample_z(gen, 1, "cpu")).shape[1:])


def shared_of(state: DistGANState) -> CohortShared:
    return CohortShared(state.g, state.g_opt, state.server_d, state.step,
                        state.generator)


def trace_specimens(pair, fcfg: DistGANConfig, *, approaches=None,
                    rounds: int = 2, batch: int = 4, device=None):
    """Yield every engine family for every registered approach (or the
    given subset) with tiny concrete inputs on ``device`` (CUDA unless
    ``"cpu"``), under the reference's names: ``fused`` and ``per_step``
    (not under error feedback, which only the cohort families thread), and
    for an approach with a user axis ``cohort``, ``fused_store``,
    ``rows`` / ``rows_ef`` and ``superbatch`` / ``superbatch_ef``.  Each
    specimen owns its state.  Donation restates each factory's contract:
    ``make_engine`` and ``make_fused_store_engine`` bind the carry they are
    given, the streamed engines the shared state they are given and the
    rows in their positions, ``make_cohort_engine`` works on a copy."""
    from repro_torch.core.approaches import _finalize_step
    from repro_torch.core.spec import APPROACH_REGISTRY, _load_builtins
    _load_builtins()
    dev = resolve_device(device)
    names = (tuple(approaches) if approaches
             else tuple(sorted(APPROACH_REGISTRY.entries)))
    K, B, C = rounds, batch, fcfg.num_users
    shape = sample_shape(pair)
    ef = _wants_residual(fcfg)
    nd, no = d_flat_layout(pair).n, d_opt_flat_layout(pair, fcfg).n

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    for name in names:
        appr = resolve_approach(name)
        per_round = round_launches(fcfg, name)
        fresh = lambda: init_state(pair, fcfg, 0, dev, sync_ds=appr.sync_ds)
        reals = zeros(K, *((C,) if appr.user_axis else ()), B, *shape)
        if not ef:
            yield TraceSpecimen(
                f"{name}/fused", make_engine(pair, fcfg, name),
                (fresh(), reals), donate=(0,), rounds=K, launches=per_round)
            noise = appr.noise_factory(pair, fcfg)(
                torch.Generator().manual_seed(1), tuple(reals.shape[1:]))
            yield TraceSpecimen(
                f"{name}/per_step",
                _finalize_step(appr.body_factory(pair, fcfg)),
                (fresh(), reals[0]), donate=(0,), expect_graph=False,
                launches=per_round,
                kwargs={k: _as_tensor(v).to(dev) for k, v in noise.items()})
        if not appr.user_axis:
            continue

        cohort = lambda: init_cohort_state(pair, fcfg, 0, dev,
                                           sync_ds=appr.sync_ds)
        idx = torch.arange(C, device=dev).repeat(K, 1)
        yield TraceSpecimen(
            f"{name}/cohort", make_cohort_engine(pair, fcfg, name),
            (cohort(), reals, idx), donate=(), rounds=K, launches=per_round)
        yield TraceSpecimen(
            f"{name}/fused_store", make_fused_store_engine(pair, fcfg, name),
            (cohort(), reals, idx), donate=(0,), rounds=K,
            launches=per_round)

        ages = zeros(C, dtype=torch.int32)
        rows = (zeros(C, nd), zeros(C, no)) + ((zeros(C, nd),) if ef else ())
        suffix = "_ef" if ef else ""
        yield TraceSpecimen(
            f"{name}/rows{suffix}", make_cohort_rows_engine(pair, fcfg, name),
            (shared_of(fresh()), *rows, ages, None, reals[0]),
            donate=tuple(range(len(rows) + 1)), launches=per_round)
        blocks = (zeros(K, C, nd), zeros(K, C, no)) + (
            (zeros(K, C, nd),) if ef else ())
        fwd = torch.full((K, C), -1, dtype=torch.int32, device=dev)
        yield TraceSpecimen(
            f"{name}/superbatch{suffix}",
            make_superbatch_engine(pair, fcfg, name),
            (shared_of(fresh()), *blocks, fwd, zeros(K, C, dtype=torch.int32),
             reals), donate=tuple(range(len(blocks) + 1)), rounds=K,
            launches=per_round)
