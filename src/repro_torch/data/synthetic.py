"""Synthetic data pipelines (port of the reference's ``data/synthetic.py``).

``TokenStream`` is the reference's seeded Zipfian token stream with a
planted bigram (numpy, bit for bit).  ``synthetic_lm_batch`` and
``synthetic_batch_for`` draw through ``repro_torch.prng``: the same keys
give the reference's tokens bit for bit (and, for the audio family's
frame embeddings, its normals within the ULPs ``prng.normal`` states).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import prng


@dataclasses.dataclass
class TokenStream:
    """Seeded synthetic LM stream: Zipf unigram + deterministic bigram mix."""

    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    bigram_strength: float = 0.5

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        V = self.vocab_size
        ranks = np.arange(1, V + 1, dtype=np.float64)
        self._unigram = (1.0 / ranks) / np.sum(1.0 / ranks)
        # planted bigram: token t prefers (a*t + c) mod V
        self._a = int(rng.integers(2, 7)) * 2 + 1
        self._c = int(rng.integers(1, V))

    def batch(self, step: int) -> dict:
        """``{"tokens", "targets"}``: (B, S) int32 CPU tensors."""
        rng = np.random.default_rng((self.seed, step))
        B, S, V = self.batch_size, self.seq_len, self.vocab_size
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.choice(V, size=B, p=self._unigram)
        follow = rng.random((B, S)) < self.bigram_strength
        rand = rng.choice(V, size=(B, S), p=self._unigram)
        for t in range(S):
            nxt = (self._a * toks[:, t] + self._c) % V
            toks[:, t + 1] = np.where(follow[:, t], nxt, rand[:, t])
        return {"tokens": torch.from_numpy(toks[:, :-1].copy()),
                "targets": torch.from_numpy(toks[:, 1:].copy())}


def synthetic_lm_batch(key: torch.Tensor, batch: int, seq: int,
                       vocab: int) -> dict:
    """Uniform tokens in [0, vocab) from ``key`` (a ``prng`` key): (B, S)
    int32 ``tokens`` and the next-token ``targets``, on the key's
    device."""
    toks = prng.randint(key, (batch, seq + 1), 0, vocab).to(torch.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def synthetic_batch_for(cfg, batch: int, seq: int, key=None, *,
                        device=None) -> dict:
    """A correctly shaped batch for any config (smoke runs); ``key``
    defaults to ``prng.key(0)`` on ``device`` (the CPU unless given)."""
    key = key if key is not None else prng.key(0, device)
    k = prng.split(key, 2)
    out = synthetic_lm_batch(k[0], batch, seq, cfg.vocab_size)
    if cfg.arch_type == "audio":
        s_src = max(seq // cfg.encoder_downsample, 1)
        out["src_embeds"] = prng.normal(k[1], (batch, s_src, cfg.d_model))
    return out
