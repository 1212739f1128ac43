"""Chunked round engines (port of the reference's ``core/engine.py:70-101,
143-308``).

``make_engine`` returns ``chunk(state, reals) -> (state, metrics)``: it
runs one round per leading slice of a pre-staged ``(K, U, B, ...)`` data
stack and returns every metric stacked on a leading K axis, still on the
device, so the driver fetches them with one host sync per chunk.

The reference compiles K rounds into one XLA scan and pads a remainder
chunk with masked rounds so every chunk shares one program.  Eager
PyTorch has no program to share: a remainder chunk runs just its ``k``
valid rounds, and since every round issues the same operations on the
same data, ``run(a); run(b)`` equals ``run(a + b)`` bitwise.  The state
updates in place across the chunk (the reference donates its carry).

Cohort virtualization (``make_cohort_engine``, ``make_fused_store_engine``):
U LOGICAL users keep their D, optimizer and error-feedback rows in a
resident ``CohortStore``; each round gathers the scheduled cohort's C rows,
runs the width-C body and scatters the rows back, stamping ``last_round``.
The two engines run the same rounds: the plain one works on a copy of the
carry it is given (which stays readable), the fused-store one consumes it
and writes the store in place.  In eager PyTorch both give the same
values bitwise, and with C == U under the ``full`` scheduler both equal
``make_engine`` bitwise (the gather is an exact permutation).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core.approaches import (DistGANConfig, DistGANState,
                                         d_flat_layout, d_opt_flat_layout,
                                         init_state)
from repro_torch.core.federated import (CohortStore, cohort_gather,
                                        cohort_scatter, make_cohort_store)
from repro_torch.core.spec import resolve_approach
from repro_torch.models.common import tree_map


def make_engine(pair, fcfg: DistGANConfig, approach: str) -> Callable:
    body = resolve_approach(approach).body_factory(pair, fcfg)

    def chunk(state, reals):
        metrics = []
        for k in range(reals.shape[0]):
            state, m = body(state, reals[k])
            metrics.append(m)
        return state, _stack_metrics(metrics)

    return chunk


def _stack_metrics(metrics: list) -> dict:
    return {key: torch.stack([m[key] for m in metrics]) for key in metrics[0]}


# ---------------------------------------------------------------------------
# Cohort-virtualized engines: U logical users, C-wide rounds
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CohortState:
    """Carry of the cohort engines: the shared training state plus the
    resident per-user ``CohortStore``."""

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


def _cohort_chunk(pair, fcfg, approach, adaptive, copy_carry):
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
        metrics = [round_fn(cstate, reals[k], idx[k],
                            None if wts is None else wts[k],
                            None if noise is None else noise[k])
                   for k in range(reals.shape[0])]
        return cstate, _stack_metrics(metrics)

    return chunk


def make_cohort_engine(pair, fcfg: DistGANConfig, approach: str,
                       adaptive: bool = False) -> Callable:
    """Cohort engine that leaves the carry it was given readable: it runs
    the chunk on a copy (one copy of the (U, N) store per chunk) and
    returns the copy."""
    return _cohort_chunk(pair, fcfg, approach, adaptive, copy_carry=True)


def make_fused_store_engine(pair, fcfg: DistGANConfig, approach: str,
                            adaptive: bool = False) -> Callable:
    """Store-resident cohort engine: the same rounds as
    ``make_cohort_engine`` with the carry CONSUMED, so the cohort rows are
    scattered into the (U, N) store in place and no per-chunk copy is
    made.  The caller rebinds to the returned carry."""
    return _cohort_chunk(pair, fcfg, approach, adaptive, copy_carry=False)
