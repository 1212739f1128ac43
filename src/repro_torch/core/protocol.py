"""Legacy round-orchestration entry point and the paper's evaluation
criteria (port of the reference's ``core/protocol.py``):
:func:`run_distgan` builds the equivalent :class:`FederationSpec` and
drives a fresh session; :func:`loss_trend` is the paper's §5.6 criterion;
:func:`measure_component_times` and :func:`effective_epoch_time` its §5.5
wall-clock model."""

from __future__ import annotations

import time
import warnings
from typing import Callable

import numpy as np
import torch

from repro_torch.core.approaches import DistGANConfig, _d_update_fn, _opts
# the streaming driver re-exported from here, as the reference's protocol
# module does
from repro_torch.core.session import (FederationSession, RunResult,
                                      StreamStats, stream_cohort_rounds)
from repro_torch.core.spec import (DEFAULT_ROUNDS_PER_JIT, BackendSpec,
                                   CombineSpec, CompressionSpec, EngineSpec,
                                   FederationSpec, ParticipationSpec)
from repro_torch.data.federated import FederatedDataset
from repro_torch.device import deterministic_convolutions, resolve_device
from repro_torch.models.common import tree_map


def run_distgan(
    pair,
    fcfg: DistGANConfig,
    dataset: FederatedDataset,
    approach: str,
    steps: int,
    batch_size: int = 64,
    seed: int = 0,
    eval_samples: int = 2048,
    sample_fn: Callable | None = None,
    engine: str = "fused",
    rounds_per_jit: int = DEFAULT_ROUNDS_PER_JIT,
    fuse_store_rounds: bool = False,
    participation: str = "full",
    cohort_size: int | None = None,
    state_backend: str = "device",
    async_rounds: int = 0,
    prefetch: bool = True,
    adaptive_server_scale: bool = False,
    materialize_state: bool = True,
    codec: str = "none",
    error_feedback: bool = True,
    codec_stochastic: bool = False,
    stage_rows: bool = False,
    device=None,
) -> RunResult:
    """Train with a registered approach (approach1/2/3, baseline,
    download_first) for ``steps`` rounds (legacy keyword shim over
    :class:`FederationSpec` + :class:`FederationSession`; the kwargs keep
    the reference's names and meanings).  ``participation`` /
    ``cohort_size`` run a cohort-virtualized federation of
    ``fcfg.num_users`` logical users; ``state_backend`` is ``"device"`` or
    ``"host"`` with its streaming knobs ``async_rounds``, ``prefetch``,
    ``materialize_state`` and ``stage_rows``.  ``"spmd"`` needs a users
    mesh, which this shim cannot pass: it raises as the reference's does
    (build ``FederationSession(..., mesh=)`` on every rank instead), and
    so does ``"multihost"``, whose worker count this shim cannot pass
    (build a ``BackendSpec(kind="multihost", workers=...)``).  ``device``
    is CUDA unless ``"cpu"`` is passed.  ``sample_fn`` is accepted for the
    reference's signature and never consumed, as there."""
    del sample_fn
    if (cohort_size is not None and participation == "full"
            and cohort_size != fcfg.num_users):
        warnings.warn(
            f"run_distgan: cohort_size={cohort_size} conflicts with "
            f"participation='full' (U={fcfg.num_users}); falling back to "
            f"the 'uniform' scheduler.  Build a FederationSpec with an "
            f"explicit ParticipationSpec instead.",
            DeprecationWarning, stacklevel=2)
        participation = "uniform"
    if not prefetch and state_backend == "device":
        warnings.warn(
            "run_distgan: prefetch=False has no effect on the device "
            "backend (it pre-stages whole chunks); ignoring.  Build a "
            "FederationSpec with an explicit BackendSpec instead.",
            DeprecationWarning, stacklevel=2)
        prefetch = True
    if engine == "per_step" and rounds_per_jit != DEFAULT_ROUNDS_PER_JIT:
        warnings.warn(
            "run_distgan: rounds_per_jit is ignored by the per_step "
            "engine; ignoring.  Build a FederationSpec with an explicit "
            "EngineSpec instead.",
            DeprecationWarning, stacklevel=2)
        rounds_per_jit = DEFAULT_ROUNDS_PER_JIT
    if engine == "fused":
        # the reference's one-shot clamp: a run of `steps` rounds shrinks
        # the chunk so at least one post-warmup timing window exists
        if steps > 1:
            rounds_per_jit = max(1, min(rounds_per_jit, steps // 2))
        rounds_per_jit = min(rounds_per_jit, max(steps, 1))

    spec = FederationSpec(
        approach=approach, batch_size=batch_size, seed=seed,
        eval_samples=eval_samples,
        engine=EngineSpec(kind=engine, rounds_per_jit=rounds_per_jit,
                          fuse_store_rounds=fuse_store_rounds),
        participation=ParticipationSpec(scheduler=participation,
                                        cohort_size=cohort_size),
        backend=BackendSpec(kind=state_backend, async_rounds=async_rounds,
                            prefetch=prefetch,
                            materialize_state=materialize_state),
        combine=CombineSpec(combiner=fcfg.combiner,
                            staleness_decay=fcfg.staleness_decay,
                            adaptive_server_scale=adaptive_server_scale,
                            compression=CompressionSpec(
                                codec=codec, error_feedback=error_feedback,
                                stochastic=codec_stochastic,
                                stage_rows=stage_rows)))
    return FederationSession(pair, fcfg, dataset, spec,
                             device=device).run(steps)


def loss_trend(losses: np.ndarray, tail_frac: float = 0.25) -> float:
    """Paper §5.6 criterion: mean(tail) - mean(head); negative =
    downtrend."""
    n = len(losses)
    head = losses[: max(int(n * tail_frac), 1)]
    tail = losses[-max(int(n * tail_frac), 1):]
    return float(np.mean(tail) - np.mean(head))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure_component_times(pair, fcfg, dataset, batch_size: int,
                            seed: int = 0, iters: int = 30, device=None):
    """The building blocks of the §5.5 wall-clock model, on ``device``
    (CUDA unless ``"cpu"``): ``t_base``, one baseline round (one D and
    one G update at batch B) on the ``per_step`` engine, and ``t_d``, one
    D update alone (batch B), each in seconds.  The clock is read after a
    device sync."""
    dev = resolve_device(device)
    _, d_opt_def = _opts(fcfg)
    g, d = pair.init(torch.Generator().manual_seed(seed), dev)
    d = tree_map(lambda t: t.unsqueeze(0), d)          # one user
    opt = d_opt_def.init(d, (1,))
    rng = np.random.default_rng(seed)
    real = torch.from_numpy(np.asarray(dataset.union_sampler(rng, batch_size),
                                       np.float32)).to(dev)[None]
    with torch.no_grad():
        fake = pair.g_apply(g, pair.sample_z(torch.Generator().manual_seed(1),
                                             batch_size, dev))
    d_up = _d_update_fn(pair, d_opt_def)
    with deterministic_convolutions():
        d_up(d, opt, real, fake)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(iters):
            d_up(d, opt, real, fake)
        _sync(dev)
        t_d = (time.perf_counter() - t0) / iters
    # per_step on purpose: the model decomposes one round, and a chunk of
    # K rounds would amortize the launch over K
    base = run_distgan(pair, fcfg, dataset, "baseline", steps=iters,
                       batch_size=batch_size, seed=seed, eval_samples=0,
                       engine="per_step", device=dev)
    return base.step_time_s, t_d


def effective_epoch_time(result: RunResult, num_users: int, approach: str,
                         *, t_base: float, t_d: float,
                         per_samples: int, batch_size: int) -> float:
    """Paper §5.5 wall-clock model, per ``per_samples`` training samples.

    The baseline consumes B samples per step: per_samples / B steps of
    t_base.  A deployed distributed round consumes U * B samples: the U
    local D updates run in parallel on the users' own hardware (t_d), then
    the server's G phase runs (t_g = t_base - t_d; approach 3 runs it once
    per user).  What the measured round time does not attribute to the U
    serialized D updates and the G phase is server overhead."""
    B, U = batch_size, num_users
    t_g = max(t_base - t_d, 0.0)
    if approach == "baseline":
        return per_samples / B * t_base
    k_g = U if approach == "approach3" else 1
    host_accounted = U * t_d + k_g * t_g
    overhead = max(result.step_time_s - host_accounted, 0.0)
    deployed_round = t_d + k_g * t_g + overhead
    rounds = per_samples / (U * B)
    return rounds * deployed_round
