"""Chunked round engine (port of the reference's ``core/engine.py:70-101``).

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
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.approaches import DistGANConfig
from repro_torch.core.spec import resolve_approach


def make_engine(pair, fcfg: DistGANConfig, approach: str) -> Callable:
    body = resolve_approach(approach).body_factory(pair, fcfg)

    def chunk(state, reals):
        metrics = []
        for k in range(reals.shape[0]):
            state, m = body(state, reals[k])
            metrics.append(m)
        return state, {key: torch.stack([m[key] for m in metrics])
                       for key in metrics[0]}

    return chunk
