"""SPMD Distributed-GAN on ``torch.distributed`` (port of the reference's
``core/spmd.py``): the paper's federation mapped onto the ``users`` axis of
a :class:`repro_torch.launch.mesh.UsersMesh`, one process (rank) per user.

The reference runs its round inside ``shard_map``, one user per device
slice; here each rank runs the round on its own slice and the collectives
of ``shard_map`` become ``torch.distributed`` calls on the rank's device
(``core/collectives.py``).

* raw data stays on its rank: the only cross-user collectives are on
  selected deltas (approach 1), D probabilities and G gradients
  (approaches 2 and 3), and the cohort engines' row exchange;
* approach 1's server-D fold is ``combine_max_abs_spmd`` (pmax + masked
  psum), so the server D is replicated state, as are G and its optimizer;
* a rank holds its user's D and D-optimizer rows (``ds`` / ``d_opts``
  stacked with a leading axis of 1, the reference's ``_specs_for``) and
  reads its own slice of the global ``real (U, B, ...)``.

The round noise is one draw for all ranks: every rank's state carries the
same host generator (seeded alike), and the body draws ``z1``, ``z2``, the
stochastic-rounding ``seed``, the ``random`` selection's uniforms and the
``shared_random`` coordinates through the approach's registered noise
function, in the same order on every rank, as the reference's shards split
one replicated key.  Tests inject the reference's own draws.

The engines run eagerly, round by round (NCCL collectives can be captured
in a CUDA graph, gloo's cannot; ROADMAP queues graph capture).  Engines and
bodies take the reference's GLOBAL arrays (``reals (K, U, B, ...)``, the
schedule ``idx (K, C)``) and each rank reads its own slice.

Cohort engines (one cohort member per rank, C = the mesh size):
``make_spmd_cohort_engine`` keeps the whole (U, N) store replicated on
every rank and exchanges the cohort's updated rows with a one-hot psum;
``make_spmd_fused_store_engine`` shards the store (U / C rows a rank) and
moves rows as int32 bit patterns, so values land bit-exactly;
``make_spmd_cohort_rows_engine`` takes the gathered rows from a
``UserStateBackend`` (the ``spmd`` streaming backend, ``SpmdStreamDriver``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import losses
from repro_torch.core.approaches import (DistGANConfig, DistGANState, _copy_into,
                                         _d_update_fn, _g_step, _grad, _on,
                                         _opts, d_flat_layout,
                                         d_opt_flat_layout, init_state)
from repro_torch.core.collectives import (all_gather, all_gather_bits, pmean,
                                          pmin, psum)
from repro_torch.core.engine import (CohortShared, CohortState,
                                     _round_noise, _wants_residual,
                                     init_cohort_state)
from repro_torch.core.federated import (CohortStore, as_batch,
                                        codec_transport,
                                        combine_max_abs_spmd,
                                        combine_mean_spmd,
                                        combine_shared_random_flat_spmd,
                                        select_delta_flat)
from repro_torch.core.session import HostStreamDriver
from repro_torch.core.spec import register_backend, resolve_approach
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import AXIS, UsersMesh
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim import apply_updates

_SPMD_APPROACHES = ("approach1", "approach2", "approach3")
_INT8_CODECS = ("int8", "topk_int8")


# ---------------------------------------------------------------------------
# Rank-local state: the rank's slice of the stacked user trees
# ---------------------------------------------------------------------------

def _rows(x, start: int, stop: int, dim: int, device) -> torch.Tensor:
    """``x[..., start:stop, ...]`` on ``dim`` as a contiguous tensor on
    ``device`` (numpy or torch input; only the slice is copied)."""
    if isinstance(x, torch.Tensor):
        return x.narrow(dim, start, stop - start).to(device).contiguous()
    sl = (slice(None),) * dim + (slice(start, stop),)
    return torch.from_numpy(np.ascontiguousarray(as_batch(x)[sl])).to(device)


def shard_state(state: DistGANState, mesh: UsersMesh) -> DistGANState:
    """A full-layout state -> this rank's (the reference's ``_specs_for``):
    ``ds`` / ``d_opts`` keep the rank's row (a leading axis of 1), G, its
    optimizer, the server D, the step and the generator are replicated."""
    r = mesh.rank
    take = lambda t: t[r:r + 1].clone()
    return DistGANState(state.g, state.g_opt, tree_map(take, state.ds),
                        tree_map(take, state.d_opts), state.server_d,
                        state.step, state.generator)


def _store_block(num_users: int, mesh: UsersMesh) -> tuple[int, int]:
    if num_users % mesh.size:
        raise ValueError(
            f"the sharded store needs U % C == 0 (U={num_users}, "
            f"C={mesh.size}); use make_spmd_cohort_engine (replicated "
            f"store) otherwise")
    rows = num_users // mesh.size
    return mesh.rank * rows, rows


def shard_cohort_state(cstate: CohortState, mesh: UsersMesh) -> CohortState:
    """A replicated cohort carry -> this rank's for the sharded store: the
    contiguous block of U / C store rows it owns (U % C == 0)."""
    start, rows = _store_block(cstate.store.num_users, mesh)
    s = cstate.store
    store = CohortStore(*(None if t is None else t[start:start + rows].clone()
                          for t in (s.d_flat, s.opt_flat, s.last_round,
                                    s.residual)))
    return CohortState(cstate.g, cstate.g_opt, store, cstate.server_d,
                       cstate.step, cstate.generator)


def init_spmd_state(pair, fcfg: DistGANConfig, seed: int, mesh: UsersMesh, *,
                    sync_ds: bool = False) -> DistGANState:
    """``init_state`` of all U users, drawn alike on every rank, reduced to
    this rank's slice: the rank's D is user ``rank``'s of the full init."""
    return shard_state(init_state(pair, fcfg, seed, mesh.device,
                                  sync_ds=sync_ds), mesh)


def init_spmd_cohort_state(pair, fcfg: DistGANConfig, seed: int,
                           mesh: UsersMesh, *, sync_ds: bool = False,
                           sharded: bool = False) -> CohortState:
    """``init_cohort_state`` on every rank (replicated store), or this
    rank's block of it (``sharded``, for ``make_spmd_fused_store_engine``)."""
    cs = init_cohort_state(pair, fcfg, seed, mesh.device, sync_ds=sync_ds)
    return shard_cohort_state(cs, mesh) if sharded else cs


# ---------------------------------------------------------------------------
# The round body
# ---------------------------------------------------------------------------

def make_spmd_body(pair, fcfg: DistGANConfig, approach: str, mesh: UsersMesh,
                   width: int | None = None):
    """The per-round SPMD function as one rank runs it: ``body(state, real,
    age=None, weight=None, residual=None, **noise) -> (state, metrics)``
    (``(state, metrics, new_residual)`` with error feedback), the state
    updated in place.  ``real (1, B, ...)`` is this rank's private batch;
    ``width`` is the users-axis size (``num_users``, or the cohort C under
    virtualization).  ``age`` (int32 scalar) feeds the staleness-aware
    folds, ``weight`` (f32 scalar) is the participation-adaptive combine
    weight, ``residual`` (N,) the error-feedback row, required iff a lossy
    codec runs with error feedback (the same EF-SGD order as the host
    body: compensate -> select -> codec -> residual, weight after).
    Keyword noise (``z1``, ``z2``, ``seed``, ``uniforms``, ``idx``;
    approach 3's ``z1`` / ``z2`` stacked (width, B, z_dim)) replaces the
    generator's draws.  Metrics: ``d_loss (1,)``, ``g_loss`` and
    ``kept_frac`` scalars, on the device."""
    if approach not in _SPMD_APPROACHES:
        raise ValueError(f"the SPMD body families cover approach1/2/3; got "
                         f"{approach!r}")
    if fcfg.loss_type != "bce":
        raise ValueError("the SPMD bodies train the paper's BCE objective, "
                         "as the reference's do")
    g_opt_def, d_opt_def = _opts(fcfg)
    d_update = _d_update_fn(pair, d_opt_def)
    layout = d_flat_layout(pair)
    width = fcfg.num_users if width is None else width
    lossy = fcfg.codec != "none"
    ef = lossy and fcfg.error_feedback
    if lossy:
        assert approach == "approach1", \
            "transport codecs compress approach 1's delta uploads"
        assert fcfg.selection != "shared_random", \
            "shared_random psums the fold before any per-member " \
            "encoding — there is no per-user payload to compress"
    draw = resolve_approach(approach).noise_factory(pair, fcfg)
    # approach 3 draws one (z1, z2) pair per member of the axis
    noise_rows = width if approach == "approach3" else 1

    def fold(masked, age, dev):
        if fcfg.combiner.startswith("staleness"):
            # age-discount the rank's delta BEFORE the fold (the SPMD
            # analogue of the host staleness combiners)
            decay = torch.tensor(fcfg.staleness_decay, dtype=torch.float32,
                                 device=dev)
            if fcfg.combiner == "staleness_mean":
                # ages relative to the youngest member: decay**age would
                # underflow to 0 / 0 for uniformly old cohorts
                if age is None:
                    w = torch.ones((), dtype=torch.float32, device=dev)
                else:
                    a = age.to(torch.float32)
                    w = torch.pow(decay, a - pmin(a, mesh))
                return psum(w * masked, mesh) / psum(w, mesh)
            w = (1.0 if age is None
                 else torch.pow(decay, age.to(torch.float32)))
            return combine_max_abs_spmd(w * masked, mesh)
        if fcfg.combiner == "max_abs":
            return combine_max_abs_spmd(masked, mesh)
        return combine_mean_spmd(masked, mesh)

    def approach1(state, real, age, weight, residual, noise):
        dev = real.device
        with torch.no_grad():
            fake = pair.g_apply(state.g, noise["z1"])
            old_flat = layout.flatten_stacked(state.ds)
        d_losses = d_update(state.ds, state.d_opts, real, fake)
        new_residual = None
        with torch.no_grad():
            delta = (layout.flatten_stacked(state.ds) - old_flat)[0]   # (N,)
            if ef:
                # EF-SGD: compensate BEFORE selection
                delta = delta + residual
            if fcfg.selection == "shared_random":
                assert weight is None, \
                    "adaptive weights need per-user uploads (the shared_" \
                    "random fold sums before any per-member scaling)"
                # bandwidth-true: only frac * N values cross the axis
                comb, kept = combine_shared_random_flat_spmd(
                    delta, noise["idx"], mesh)
            else:
                masked, kept = select_delta_flat(
                    delta[None], fcfg.selection, frac=fcfg.upload_frac,
                    uniforms=noise.get("uniforms"),
                    use_kernel=fcfg.use_topk_kernel)
                kept = kept[0]
                if lossy:
                    masked = codec_transport(
                        masked, fcfg.codec, stochastic=fcfg.codec_stochastic,
                        seed=noise.get("seed"),
                        use_kernel=fcfg.use_topk_kernel)
                masked = masked[0]
                if ef:
                    # user-local ledger: what the wire dropped, before any
                    # server-side weighting
                    new_residual = delta - masked
                if weight is not None:
                    masked = masked * weight
                comb = fold(masked, age, dev)
            server_flat = (layout.flatten(state.server_d)
                           + fcfg.server_scale * comb)
            _copy_into(state.server_d, layout.unflatten(server_flat))
            # download phase: the local D re-syncs to the server
            for d, s in zip(tree_leaves(state.ds),
                            tree_leaves(state.server_d)):
                d.copy_(s.unsqueeze(0).expand_as(d))
        # server_d is replicated, so G's gradient is too: no psum
        gl = _g_step(pair, fcfg, g_opt_def, state, state.server_d,
                     noise["z2"])
        return d_losses, gl, kept, new_residual

    def approach2(state, real, noise):
        with torch.no_grad():
            fake = pair.g_apply(state.g, noise["z1"])
        d_losses = d_update(state.ds, state.d_opts, real, fake)
        ds, z2 = state.ds, noise["z2"]

        def g_loss(gp):
            p_local = torch.sigmoid(pair.d_apply(ds, pair.g_apply(gp, z2)))
            p_avg = pmean(p_local, mesh)                  # alg. 2 line 4
            return -torch.mean(torch.log(p_avg + 1e-7))

        gl, grads = _grad(g_loss, state.g)
        # the pmean inside g_loss transposes to a psum of the cotangents,
        # so each rank's gradient already carries every user's path; the
        # pmean makes the replicas agree bitwise
        with torch.no_grad():
            grads = tree_map(lambda x: pmean(x, mesh), grads)
            apply_g(state, grads)
        return d_losses, gl.reshape(())

    def approach3(state, real, noise):
        # round-robin: in sub-round j only member j's D trains and only it
        # drives G, whose gradient is broadcast by a masked psum
        dev = real.device
        gl = torch.zeros((), dtype=torch.float32, device=dev)
        dl = torch.zeros((), dtype=torch.float32, device=dev)
        for j in range(width):
            active = mesh.rank == j
            with torch.no_grad():
                fake = pair.g_apply(state.g, noise["z1"][j])
            if active:       # the reference trains every D and keeps j's
                dl = dl + d_update(state.ds, state.d_opts, real, fake)[0]
            z2 = noise["z2"][j]

            def g_loss(gp, z2=z2):
                return losses.g_loss_nonsat(
                    pair.d_apply(state.ds, pair.g_apply(gp, z2)))

            glj, grads = _grad(g_loss, state.g)
            # a masked psum (the reference's ``x * mask`` compiles to a
            # select): only member j's gradient and loss
            mine = lambda x: x if active else torch.zeros_like(x)
            with torch.no_grad():
                grads = tree_map(lambda x: psum(mine(x), mesh), grads)
                apply_g(state, grads)
                gl = gl + psum(mine(glj.reshape(())), mesh) / width
        return dl[None], gl

    def apply_g(state, grads):
        apply_updates(state.g, g_opt_def.update(grads, state.g_opt, state.g))

    def body(state: DistGANState, real, age=None, weight=None, residual=None,
             **given):
        assert (residual is not None) == ef, \
            "pass residual iff the config wants error feedback"
        dev = real.device
        shape = (noise_rows,) + tuple(real.shape[1:])
        noise = {k: _on(dev, v) for k, v in
                 draw(state.generator, shape, **given).items()}
        new_residual, kept = None, None
        if approach == "approach1":
            d_losses, gl, kept, new_residual = approach1(
                state, real, age, weight, residual, noise)
        elif approach == "approach2":
            d_losses, gl = approach2(state, real, noise)
        else:
            d_losses, gl = approach3(state, real, noise)
        if kept is None:
            kept = torch.ones((), dtype=torch.float32, device=dev)
        with torch.no_grad():
            state.step += 1
        metrics = {"d_loss": d_losses, "g_loss": gl, "kept_frac": kept}
        if ef:
            return state, metrics, new_residual
        return state, metrics

    return body


# ---------------------------------------------------------------------------
# Metrics across the axis
# ---------------------------------------------------------------------------

def _local_row(m: dict, age) -> torch.Tensor:
    """One round's per-rank metrics as an f32 row: d_loss, kept_frac and
    (for the cohort engines) the member's age."""
    vals = [m["d_loss"].reshape(()), m["kept_frac"].reshape(())]
    if age is not None:
        vals.append(age.to(torch.float32).reshape(()))
    return torch.stack(vals).to(torch.float32)


def _axis_metrics(rows: torch.Tensor, g_loss: torch.Tensor,
                  mesh: UsersMesh, ages: bool) -> dict:
    """``rows (size, ..., 2 or 3)`` all-gathered per-rank rows -> the
    reference's global metrics: ``d_loss`` per user on the last axis,
    ``kept_frac`` of rank 0 (the reference's replicated out-spec reads
    shard 0), ``mean_age`` the psum of the ages over C."""
    d = rows[..., 0].movedim(0, -1).contiguous()
    out = {"d_loss": d, "g_loss": g_loss, "kept_frac": rows[0, ..., 1]}
    if ages:
        out["mean_age"] = rows[..., 2].sum(0) / mesh.size
    return out


def _chunk_metrics(local: list, mesh: UsersMesh, ages: bool) -> dict:
    """K rounds' rank-local metrics (None for a round masked out by
    ``valid``: NaN there, as the reference's masked rounds are garbage)
    -> K-stacked global metrics, with ONE all-gather for the chunk."""
    ref = next(m for m in local if m is not None)
    width = 3 if ages else 2
    nan_row = torch.full((width,), math.nan, device=ref["g_loss"].device)
    nan = nan_row[0]
    rows = torch.stack([nan_row if m is None else m["row"] for m in local])
    g = torch.stack([nan if m is None else m["g_loss"].reshape(())
                     for m in local])
    return _axis_metrics(all_gather(rows, mesh), g, mesh, ages)


def _valid_mask(valid, k: int) -> np.ndarray:
    if valid is None:
        return np.ones(k, bool)
    if isinstance(valid, torch.Tensor):
        valid = valid.cpu().numpy()
    return np.asarray(valid, bool).reshape(k)


def _host_idx(idx) -> np.ndarray:
    if isinstance(idx, torch.Tensor):
        idx = idx.cpu().numpy()
    return np.asarray(idx, np.int64)


# ---------------------------------------------------------------------------
# Full participation: one user per rank
# ---------------------------------------------------------------------------

def make_spmd_step(pair, fcfg: DistGANConfig, mesh: UsersMesh, approach: str):
    """``step(state, real, noise=None) -> (state, metrics)``: one round on
    this rank's slice of the global ``real (U, B, ...)``, the rank's state
    (``shard_state``'s layout) updated in place.  Metrics as the
    reference's: ``d_loss (U,)``, ``g_loss``, ``kept_frac``."""
    _check_axis(mesh, fcfg.num_users, "num_users")
    body = make_spmd_body(pair, fcfg, approach, mesh)

    def step(state, real, noise=None):
        local = _rows(real, mesh.rank, mesh.rank + 1, 0, state.step.device)
        state, m = body(state, local, **(noise or {}))
        rows = all_gather(_local_row(m, None), mesh)
        return state, _axis_metrics(rows, m["g_loss"], mesh, False)

    return step


def make_spmd_engine(pair, fcfg: DistGANConfig, mesh: UsersMesh,
                     approach: str):
    """``chunk(state, reals, valid=None, noise=None) -> (state, metrics)``:
    K rounds of ``make_spmd_step`` over the global ``reals (K, U, B,
    ...)``, each rank reading its slice; ``valid (K,)`` bool skips masked
    rounds (the carry untouched, NaN metrics: the reference's padded
    remainder chunk); ``noise`` a list of K keyword dicts.  Metrics are
    K-stacked (``d_loss (K, U)``), one all-gather per chunk."""
    _check_axis(mesh, fcfg.num_users, "num_users")
    body = make_spmd_body(pair, fcfg, approach, mesh)

    def chunk(state, reals, valid=None, noise=None):
        k = reals.shape[0]
        mask = _valid_mask(valid, k)
        local = _rows(reals, mesh.rank, mesh.rank + 1, 1, state.step.device)
        out = []
        for r in range(k):
            if not mask[r]:
                out.append(None)
                continue
            state, m = body(state, local[r], **_round_noise(noise, r))
            out.append({"row": _local_row(m, None), "g_loss": m["g_loss"]})
        return state, _chunk_metrics(out, mesh, False)

    return chunk


def _check_axis(mesh: UsersMesh, n: int, what: str) -> None:
    if mesh.shape[AXIS] != n:
        raise ValueError(f"{what} must equal the '{AXIS}' mesh axis "
                         f"({what}={n}, axis={mesh.shape[AXIS]})")


# ---------------------------------------------------------------------------
# Cohort engines: one cohort member per rank
# ---------------------------------------------------------------------------

def _cohort_rank_state(carry: CohortState, d_row, o_row, d_layout,
                       o_layout) -> DistGANState:
    return DistGANState(carry.g, carry.g_opt,
                        d_layout.unflatten_stacked(d_row[None]),
                        o_layout.unflatten_stacked(o_row[None]),
                        carry.server_d, carry.step, carry.generator)


def make_spmd_cohort_round(pair, fcfg: DistGANConfig, approach: str,
                           cohort_size: int, mesh: UsersMesh):
    """One cohort round as rank r runs it, the (U, N) store REPLICATED on
    every rank: ``round_fn(carry, real (1, B, ...), idx (C,), idx_host,
    noise) -> local metrics``.  Rank r gathers row ``idx[r]``, runs the
    body (its age ``step - last_round``), and the cohort's updated rows
    are exchanged by a one-hot psum over C slots and written by row
    replacement on every rank, stamped ``last_round = step + 1``.  The
    psum is the reference's f32 one (an owned -0.0 lands as +0.0, a NaN
    row poisons the slot's column, as there); under ``stage_rows`` the D
    rows cross as int8 codes plus an f32 scale each (the int8 psum is a
    lossless select of the quantized row)."""
    inner = make_spmd_body(pair, fcfg, approach, mesh, width=cohort_size)
    d_layout = d_flat_layout(pair)
    o_layout = d_opt_flat_layout(pair, fcfg)
    ef = _wants_residual(fcfg)
    stage_q = fcfg.stage_rows and fcfg.codec in _INT8_CODECS
    quantize, dequantize = kops.quantize_rows, kops.dequantize_rows
    me = mesh.rank

    def round_fn(carry: CohortState, real, idx, idx_host, noise):
        store = carry.store
        u = idx[me:me + 1]
        age = (carry.step - store.last_round.index_select(0, u))[0]
        stamp = carry.step + 1                 # before the body steps it
        state = _cohort_rank_state(carry, store.d_flat.index_select(0, u)[0],
                                   store.opt_flat.index_select(0, u)[0],
                                   d_layout, o_layout)
        if ef:
            _, m, new_res = inner(
                state, real, age,
                residual=store.residual.index_select(0, u)[0], **noise)
        else:
            _, m = inner(state, real, age, **noise)
        new_d = d_layout.flatten_stacked(state.ds)[0]
        new_o = o_layout.flatten_stacked(state.d_opts)[0]
        onehot = torch.zeros((cohort_size, 1), dtype=torch.float32,
                             device=new_d.device)
        onehot[me] = 1.0
        if stage_q:
            q, scale = quantize(new_d[None])
            hot = onehot > 0
            rows_d = dequantize(psum(torch.where(hot, q, 0), mesh),
                                psum(torch.where(hot[:, 0], scale, 0.0), mesh))
        else:
            rows_d = psum(onehot * new_d[None], mesh)
        store.d_flat.index_copy_(0, idx, rows_d)
        store.opt_flat.index_copy_(0, idx, psum(onehot * new_o[None], mesh))
        store.last_round.index_copy_(
            0, idx, stamp.to(torch.int32).expand(cohort_size))
        if ef:
            store.residual.index_copy_(0, idx,
                                       psum(onehot * new_res[None], mesh))
        return {"row": _local_row(m, age), "g_loss": m["g_loss"]}

    return round_fn


def gather_owned_rows(local: torch.Tensor, own: torch.Tensor,
                      loc: torch.Tensor, mesh: UsersMesh) -> torch.Tensor:
    """The sharded store's gather: ``local[loc[c]]`` from the rank that
    ``own``s slot c, on every rank, by a one-hot SUM over the users axis.
    An f32 block rides it as int32 bit patterns, so the sum of one owner's
    bits and zeros is a bit-exact select (an owned -0.0 lands as -0.0,
    where an f32 psum gives +0.0)."""
    f32 = local.dtype == torch.float32
    buf = local.view(torch.int32) if f32 else local
    rows = buf.index_select(0, loc)
    mask = own.view((-1,) + (1,) * (rows.ndim - 1))
    rows = psum(torch.where(mask, rows, 0), mesh)
    return rows.view(torch.float32) if f32 else rows


def make_spmd_fused_store_round(pair, fcfg: DistGANConfig, approach: str,
                                cohort_size: int, mesh: UsersMesh):
    """One cohort round over a SHARDED store: rank r holds the contiguous
    block of U / C rows ``[r U/C, (r+1) U/C)``, and a round moves exactly
    the C scheduled rows across the axis.

    * gather: every rank contributes the scheduled rows IT owns to a
      one-hot psum; f32 rows ride it as int32 bit patterns, so the fold is
      a bit-exact select (an owned -0.0 lands as -0.0); under
      ``stage_rows`` the owner quantizes its rows first (int8 + f32 scale
      on the wire);
    * scatter: every rank's updated row reaches every rank by an
      all-gather of its bits (the reference's one-hot int32 psum computes
      the same bytes), or int8 + scale under ``stage_rows``; each rank
      writes the rows it owns and drops the others."""
    inner = make_spmd_body(pair, fcfg, approach, mesh, width=cohort_size)
    d_layout = d_flat_layout(pair)
    o_layout = d_opt_flat_layout(pair, fcfg)
    ef = _wants_residual(fcfg)
    stage_q = fcfg.stage_rows and fcfg.codec in _INT8_CODECS
    quantize, dequantize = kops.quantize_rows, kops.dequantize_rows
    me = mesh.rank

    def round_fn(carry: CohortState, real, idx, idx_host, noise):
        store = carry.store
        ul = store.num_users
        dev = carry.step.device
        own_h = idx_host // ul == me
        own = torch.from_numpy(own_h).to(dev)
        loc = torch.from_numpy(np.where(own_h, idx_host % ul, 0)).to(dev)
        mine_c = torch.from_numpy(np.flatnonzero(own_h)).to(dev)
        mine_loc = torch.from_numpy(idx_host[own_h] % ul).to(dev)

        def gather(local):
            return gather_owned_rows(local, own, loc, mesh)

        def gather_q(local):
            q, scale = quantize(local.index_select(0, loc))
            return dequantize(psum(torch.where(own[:, None], q, 0), mesh),
                              psum(torch.where(own, scale, 0.0), mesh))

        def bcast_q(row):
            q, scale = quantize(row[None])
            return dequantize(all_gather(q[0], mesh),
                              all_gather(scale, mesh).reshape(-1))

        def write(local, rows):
            local.index_copy_(0, mine_loc, rows.index_select(0, mine_c))

        rows_d = gather_q(store.d_flat) if stage_q else gather(store.d_flat)
        rows_o = gather(store.opt_flat)
        last = gather(store.last_round)
        age = carry.step - last[me]
        stamp = carry.step + 1
        state = _cohort_rank_state(carry, rows_d[me], rows_o[me], d_layout,
                                   o_layout)
        if ef:
            # the residual shards with the store and always crosses as
            # exact f32 (it is the ledger that corrects the lossy legs)
            rows_r = gather(store.residual)
            _, m, new_res = inner(state, real, age, residual=rows_r[me],
                                  **noise)
        else:
            _, m = inner(state, real, age, **noise)
        new_d = d_layout.flatten_stacked(state.ds)[0]
        new_o = o_layout.flatten_stacked(state.d_opts)[0]
        write(store.d_flat, bcast_q(new_d) if stage_q
              else all_gather_bits(new_d, mesh))
        write(store.opt_flat, all_gather_bits(new_o, mesh))
        store.last_round.index_copy_(
            0, mine_loc, stamp.to(torch.int32).expand(mine_loc.shape[0]))
        if ef:
            write(store.residual, all_gather_bits(new_res, mesh))
        return {"row": _local_row(m, age), "g_loss": m["g_loss"]}

    return round_fn


def _cohort_engine(round_fn, mesh: UsersMesh):
    def chunk(cstate: CohortState, reals, idx, valid=None, noise=None):
        """``reals (K, C, B, ...)`` and ``idx (K, C)`` the global arrays
        (rank r reads member r), ``valid (K,)`` skips masked rounds,
        ``noise`` a list of K keyword dicts.  Runs on a copy of the carry
        (the reference does not donate it) and returns it, with K-stacked
        metrics (``d_loss (K, C)``, ``mean_age``)."""
        k = reals.shape[0]
        mask = _valid_mask(valid, k)
        cstate = cstate.clone()
        dev = cstate.step.device
        local = _rows(reals, mesh.rank, mesh.rank + 1, 1, dev)
        idx_h = _host_idx(idx)
        idx_d = torch.from_numpy(idx_h).to(dev)
        out = [round_fn(cstate, local[r], idx_d[r], idx_h[r],
                        _round_noise(noise, r)) if mask[r] else None
               for r in range(k)]
        return cstate, _chunk_metrics(out, mesh, True)

    return chunk


def make_spmd_cohort_engine(pair, fcfg: DistGANConfig, mesh: UsersMesh,
                            approach: str, cohort_size: int):
    """Cohort engine with the cohort mapped onto the users axis and the
    (U, N) store replicated on every rank (``make_spmd_cohort_round``):
    ``chunk(cstate, reals, idx, valid=None, noise=None)``; the mesh size
    bounds C, U only sizes the store."""
    _check_axis(mesh, cohort_size, "cohort")
    return _cohort_engine(make_spmd_cohort_round(
        pair, fcfg, approach, cohort_size, mesh), mesh)


def make_spmd_fused_store_engine(pair, fcfg: DistGANConfig, mesh: UsersMesh,
                                 approach: str, cohort_size: int):
    """Cohort engine over the SHARDED store (``make_spmd_fused_store_round``;
    the carry from ``shard_cohort_state`` / ``init_spmd_cohort_state(...,
    sharded=True)``): the same signature as ``make_spmd_cohort_engine``,
    at 1 / C the store memory per rank.  Requires U % C == 0."""
    _check_axis(mesh, cohort_size, "cohort")
    _store_block(fcfg.num_users, mesh)
    return _cohort_engine(make_spmd_fused_store_round(
        pair, fcfg, approach, cohort_size, mesh), mesh)


def make_spmd_cohort_rows_engine(pair, fcfg: DistGANConfig, mesh: UsersMesh,
                                 approach: str, cohort_size: int):
    """The host-backend feed of the mesh-mapped cohort: the same call as
    ``make_cohort_rows_engine`` — ``eng(shared, d_rows, opt_rows, ages,
    wts, real, noise=None) -> (shared, new_d_rows, new_opt_rows,
    metrics)``, with error feedback ``eng(shared, d_rows, opt_rows,
    res_rows, ages, wts, real) -> (shared, nd, no, new_res, metrics)`` —
    so ``stream_cohort_rounds`` drives both unchanged.  The inputs are the
    cohort's (C, ...) rows; rank r trains member r and one all-gather per
    round returns every member's updated rows (and the round's metrics)
    to every rank.  ``shared`` is updated in place."""
    _check_axis(mesh, cohort_size, "cohort")
    inner = make_spmd_body(pair, fcfg, approach, mesh, width=cohort_size)
    d_layout = d_flat_layout(pair)
    o_layout = d_opt_flat_layout(pair, fcfg)
    ef = _wants_residual(fcfg)
    me = mesh.rank
    widths = [d_layout.n, o_layout.n] + ([d_layout.n] if ef else [])

    def engine(shared: CohortShared, d_rows, opt_rows, *rest, noise=None):
        if ef:
            res_rows, ages, wts, real = rest
        else:
            (ages, wts, real), res_rows = rest, None
        dev = shared.step.device
        pick = lambda t: t[me].to(dev)
        state = DistGANState(shared.g, shared.g_opt,
                             d_layout.unflatten_stacked(pick(d_rows)[None]),
                             o_layout.unflatten_stacked(pick(opt_rows)[None]),
                             shared.server_d, shared.step, shared.generator)
        age = pick(ages)
        w = None if wts is None else pick(wts)
        local = _rows(real, me, me + 1, 0, dev)
        if ef:
            _, m, new_res = inner(state, local, age, w,
                                  residual=pick(res_rows), **(noise or {}))
        else:
            _, m = inner(state, local, age, w, **(noise or {}))
        parts = [d_layout.flatten_stacked(state.ds)[0],
                 o_layout.flatten_stacked(state.d_opts)[0]]
        if ef:
            parts.append(new_res)
        parts.append(_local_row(m, age))
        # one all-gather: the members' updated rows and the round's metrics
        allb = all_gather(torch.cat(parts), mesh)
        outs = torch.split(allb, widths + [3], dim=1)
        metrics = _axis_metrics(outs[-1], m["g_loss"], mesh, True)
        return (shared, *outs[:-1], metrics)

    return engine


# ---------------------------------------------------------------------------
# Spec-layer registration: the "spmd" streaming backend
# ---------------------------------------------------------------------------

class SpmdStreamDriver(HostStreamDriver):
    """Streaming backend with the cohort mapped onto the users axis, one
    member per rank (``FederationSession(..., mesh=)`` with a users axis
    equal to the cohort size).  Every rank runs the same session control:
    the schedule and the data come from the same seeded numpy streams, so
    no raw data crosses ranks, and rank r trains member r through
    ``make_spmd_cohort_rows_engine``.  Each rank keeps a replica of the
    host store (the reference's single host keeps one), into which every
    rank scatters the same all-gathered rows, so the replicas stay bitwise
    equal.  The host backend's store-row staging and superbatch windows do
    not apply (as in the reference: ``stage_rows`` and
    ``fuse_store_rounds`` fall back to the plain per-round stream).
    Checkpoints keep the host backend's layout; rank 0 writes them."""

    backend_name = "spmd"

    def _make_engine(self):
        sess = self.sess
        if sess.mesh is None:
            raise ValueError(
                "BackendSpec(kind='spmd') needs FederationSession(mesh=...) "
                "with a 'users' axis equal to the cohort size")
        if sess.spec.approach not in _SPMD_APPROACHES:
            raise ValueError(
                f"the SPMD body families cover approach1/2/3; got "
                f"{sess.spec.approach!r}")
        return make_spmd_cohort_rows_engine(sess.pair, sess.fcfg, sess.mesh,
                                            sess.spec.approach,
                                            sess.cohort_size)


register_backend("spmd", SpmdStreamDriver, streams=True)


# ---------------------------------------------------------------------------
# Contract-checker introspection (read by repro_torch.analysis.tracecheck)
# ---------------------------------------------------------------------------

def spmd_trace_specimens(pair, fcfg: DistGANConfig, mesh: UsersMesh, *,
                         approaches=None, rounds: int = 2, batch: int = 4):
    """Every SPMD engine family as a ``TraceSpecimen`` (``core/engine.py``)
    for the approaches the mesh bodies cover, on this rank's device, under
    the reference's names (``core/spmd.py:666``).  The engines run eagerly
    (``expect_graph`` False).  Donation restates each factory's contract:
    the step, the engine and the rows engine update the rank's state in
    place, the two cohort store engines work on a copy of the carry (the
    reference's bitwise-pin copies).  The schedule is a host array, as
    the sessions pass it."""
    from repro_torch.core.engine import (TraceSpecimen, round_launches,
                                         sample_shape, shared_of)
    names = tuple(approaches) if approaches else _SPMD_APPROACHES
    K, B = rounds, batch
    U = C = mesh.shape[AXIS]
    fcfg = dataclasses.replace(fcfg, num_users=U)
    shape = sample_shape(pair)
    nd, no = d_flat_layout(pair).n, d_opt_flat_layout(pair, fcfg).n
    ef = _wants_residual(fcfg)
    dev = mesh.device

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    for name in names:
        if name not in _SPMD_APPROACHES:
            continue
        sync = resolve_approach(name).sync_ds
        per_round = round_launches(fcfg, name)
        reals = zeros(K, U, B, *shape)
        if not ef:
            yield TraceSpecimen(
                f"{name}/spmd", make_spmd_engine(pair, fcfg, mesh, name),
                (init_spmd_state(pair, fcfg, 0, mesh, sync_ds=sync), reals),
                donate=(0,), expect_graph=False, rounds=K,
                launches=per_round)
            yield TraceSpecimen(
                f"{name}/spmd_step", make_spmd_step(pair, fcfg, mesh, name),
                (init_spmd_state(pair, fcfg, 0, mesh, sync_ds=sync),
                 reals[0]), donate=(0,), expect_graph=False,
                launches=per_round)

        idx = np.tile(np.arange(C, dtype=np.int64), (K, 1))
        cohort = lambda sharded: init_spmd_cohort_state(
            pair, fcfg, 0, mesh, sync_ds=sync, sharded=sharded)
        yield TraceSpecimen(
            f"{name}/spmd_cohort",
            make_spmd_cohort_engine(pair, fcfg, mesh, name, C),
            (cohort(False), reals, idx), donate=(), expect_graph=False,
            rounds=K, launches=per_round)
        yield TraceSpecimen(
            f"{name}/spmd_fused_store",
            make_spmd_fused_store_engine(pair, fcfg, mesh, name, C),
            (cohort(True), reals, idx), donate=(), expect_graph=False,
            rounds=K, launches=per_round)

        rows = (zeros(C, nd), zeros(C, no)) + ((zeros(C, nd),) if ef else ())
        shared = shared_of(init_state(pair, fcfg, 0, dev, sync_ds=sync))
        yield TraceSpecimen(
            f"{name}/spmd_rows{'_ef' if ef else ''}",
            make_spmd_cohort_rows_engine(pair, fcfg, mesh, name, C),
            (shared, *rows, zeros(C, dtype=torch.int32), None, reals[0]),
            donate=tuple(range(len(rows) + 1)), expect_graph=False,
            launches=per_round)
