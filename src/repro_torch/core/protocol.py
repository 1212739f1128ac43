"""Legacy round-orchestration entry point (port of the reference's
``core/protocol.py:37-177``): :func:`run_distgan` builds the equivalent
:class:`FederationSpec` and drives a fresh session; :func:`loss_trend` is
the paper's §5.6 criterion."""

from __future__ import annotations

import warnings

import numpy as np

from repro_torch.core.approaches import DistGANConfig
from repro_torch.core.session import FederationSession, RunResult
from repro_torch.core.spec import (DEFAULT_ROUNDS_PER_JIT, CombineSpec,
                                   CompressionSpec, EngineSpec,
                                   FederationSpec, ParticipationSpec)
from repro_torch.data.federated import FederatedDataset


def run_distgan(
    pair,
    fcfg: DistGANConfig,
    dataset: FederatedDataset,
    approach: str,
    steps: int,
    batch_size: int = 64,
    seed: int = 0,
    eval_samples: int = 2048,
    engine: str = "fused",
    rounds_per_jit: int = DEFAULT_ROUNDS_PER_JIT,
    fuse_store_rounds: bool = False,
    participation: str = "full",
    cohort_size: int | None = None,
    state_backend: str = "device",
    adaptive_server_scale: bool = False,
    codec: str = "none",
    error_feedback: bool = True,
    codec_stochastic: bool = False,
    device=None,
) -> RunResult:
    """Train with a registered approach (approach1/2/3, baseline,
    download_first) for ``steps`` rounds (legacy keyword shim over
    :class:`FederationSpec` + :class:`FederationSession`; the kwargs keep
    the reference's names and meanings).  ``participation`` /
    ``cohort_size`` run a cohort-virtualized federation of
    ``fcfg.num_users`` logical users; ``state_backend`` is ``"device"``
    (the host, SPMD and multihost backends are not ported).  ``device`` is
    CUDA unless ``"cpu"`` is passed."""
    if state_backend != "device":
        raise NotImplementedError(
            f"state_backend={state_backend!r} is not ported to repro_torch "
            f"yet (ROADMAP queue A item 8: the host streaming backend; "
            f"items 9 and 10: SPMD and multihost)")
    if (cohort_size is not None and participation == "full"
            and cohort_size != fcfg.num_users):
        warnings.warn(
            f"run_distgan: cohort_size={cohort_size} conflicts with "
            f"participation='full' (U={fcfg.num_users}); falling back to "
            f"the 'uniform' scheduler.  Build a FederationSpec with an "
            f"explicit ParticipationSpec instead.",
            DeprecationWarning, stacklevel=2)
        participation = "uniform"
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
        combine=CombineSpec(combiner=fcfg.combiner,
                            staleness_decay=fcfg.staleness_decay,
                            adaptive_server_scale=adaptive_server_scale,
                            compression=CompressionSpec(
                                codec=codec, error_feedback=error_feedback,
                                stochastic=codec_stochastic)))
    return FederationSession(pair, fcfg, dataset, spec,
                             device=device).run(steps)


def loss_trend(losses: np.ndarray, tail_frac: float = 0.25) -> float:
    """Paper §5.6 criterion: mean(tail) - mean(head); negative =
    downtrend."""
    n = len(losses)
    head = losses[: max(int(n * tail_frac), 1)]
    tail = losses[-max(int(n * tail_frac), 1):]
    return float(np.mean(tail) - np.mean(head))
