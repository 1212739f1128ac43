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
                                   FederationSpec)
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
    codec: str = "none",
    error_feedback: bool = True,
    codec_stochastic: bool = False,
    device=None,
) -> RunResult:
    """Train with a registered approach for ``steps`` rounds (legacy
    keyword shim over :class:`FederationSpec` + :class:`FederationSession`;
    the kwargs keep the reference's names and meanings; the participation
    and backend kwargs arrive with the cohort and host slices).
    ``device`` is CUDA unless ``"cpu"`` is passed."""
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
        engine=EngineSpec(kind=engine, rounds_per_jit=rounds_per_jit),
        combine=CombineSpec(combiner=fcfg.combiner,
                            staleness_decay=fcfg.staleness_decay,
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
