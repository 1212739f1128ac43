"""Federated dataset plumbing: split a dataset across users such that raw
samples never cross the user boundary (the paper's privacy constraint is
*structural* — user u's sampler only ever sees shard u).

Splits: ``federated_split`` (the paper's by-class assignment),
``dirichlet_partition`` (label-skew non-IID, the standard federated
benchmark recipe), ``quantity_skew_partition`` (non-IID in shard SIZE).
All record ``shard_sizes`` metadata, which the ``weighted`` participation
scheduler consumes.

A numpy-only copy of the reference's ``data/federated.py``: the same seed
gives bitwise-same shards and batches."""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np


@dataclasses.dataclass
class FederatedDataset:
    """Per-user samplers + the union distribution (for evaluation only).

    ``samplers[u](rng, n)`` yields n samples from user u's private data.
    The evaluation-side ``union_sampler`` exists only to measure coverage;
    the training path never touches it.
    """

    samplers: Sequence[Callable]
    union_sampler: Callable
    meta: dict

    @property
    def num_users(self) -> int:
        return len(self.samplers)

    def user_batch(self, user: int, rng: np.random.Generator, n: int):
        return self.samplers[user](rng, n)


def _make_shard_dataset(shards: Sequence[np.ndarray],
                        meta: dict) -> FederatedDataset:
    """Wrap per-user sample shards into a FederatedDataset (samplers draw
    i.i.d. from the user's own shard; the union sampler exists only for
    evaluation)."""
    for u, shard in enumerate(shards):
        if len(shard) == 0:
            raise ValueError(f"empty shard for user {u}")

    def make_sampler(shard):
        def sample(rng: np.random.Generator, n: int):
            idx = rng.integers(0, len(shard), size=n)
            return shard[idx]
        return sample

    alldata = np.concatenate(shards, 0)

    def union(rng: np.random.Generator, n: int):
        idx = rng.integers(0, len(alldata), size=n)
        return alldata[idx]

    meta = dict(meta, shard_sizes=[len(s) for s in shards])
    return FederatedDataset(
        samplers=[make_sampler(s) for s in shards],
        union_sampler=union, meta=meta)


def dirichlet_partition(data: np.ndarray, labels: np.ndarray,
                        num_users: int, alpha: float,
                        seed: int = 0) -> FederatedDataset:
    """Label-skew non-IID split (Hsu et al. 2019, the standard federated
    benchmark recipe): for each class, user proportions are drawn from
    Dirichlet(alpha).  alpha -> inf approaches IID; alpha -> 0 gives each
    class to essentially one user.  Deterministic for a fixed seed.

    Users left with an empty shard (possible at tiny alpha) are topped up
    with one sample stolen from the currently largest shard, so every
    sampler is well-defined.
    """
    assert num_users >= 1 and alpha > 0
    assert len(data) >= num_users, "fewer samples than users"
    rng = np.random.default_rng(seed)
    classes = np.unique(labels)
    per_user: list[list[np.ndarray]] = [[] for _ in range(num_users)]
    label_hist = np.zeros((num_users, len(classes)), np.int64)
    for ci, c in enumerate(classes):
        cls_idx = np.flatnonzero(labels == c)
        rng.shuffle(cls_idx)
        props = rng.dirichlet(np.full(num_users, alpha))
        # cumulative split: every class sample lands with exactly one user
        cuts = (np.cumsum(props)[:-1] * len(cls_idx)).astype(np.int64)
        for u, part in enumerate(np.split(cls_idx, cuts)):
            per_user[u].append(part)
            label_hist[u, ci] = len(part)
    owned = [np.concatenate(p) if p else np.empty((0,), np.int64)
             for p in per_user]
    class_col = {c: ci for ci, c in enumerate(classes)}
    for u in range(num_users):           # repair empty shards
        while len(owned[u]) == 0:
            donor = int(np.argmax([len(o) for o in owned]))
            owned[u], owned[donor] = owned[donor][-1:], owned[donor][:-1]
            # keep the recorded histogram describing the ACTUAL shards
            ci = class_col[labels[owned[u][0]]]
            label_hist[u, ci] += 1
            label_hist[donor, ci] -= 1
    shards = [data[np.sort(o)] for o in owned]
    return _make_shard_dataset(
        shards, {"partition": "dirichlet", "alpha": float(alpha),
                 "seed": int(seed),
                 "label_hist": label_hist.tolist()})


def quantity_skew_partition(data: np.ndarray, num_users: int,
                            alpha: float = 1.0,
                            seed: int = 0) -> FederatedDataset:
    """Quantity-skew non-IID split: users hold label-unbiased slices whose
    SIZES follow Dirichlet(alpha) (small alpha -> a few data-rich users
    and many data-poor ones).  Every user keeps at least one sample.
    Deterministic for a fixed seed."""
    assert num_users >= 1 and alpha > 0
    assert len(data) >= num_users, "fewer samples than users"
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(data))
    props = rng.dirichlet(np.full(num_users, alpha))
    # floor of 1 sample per user, remainder split by the drawn proportions
    sizes = 1 + np.floor(props * (len(data) - num_users)).astype(np.int64)
    sizes[-1] += len(data) - sizes.sum()
    cuts = np.cumsum(sizes)[:-1]
    shards = [data[np.sort(p)] for p in np.split(perm, cuts)]
    return _make_shard_dataset(
        shards, {"partition": "quantity_skew", "alpha": float(alpha),
                 "seed": int(seed)})


def federated_split(data: np.ndarray, labels: np.ndarray,
                    user_classes: Sequence[Sequence[int]]) -> FederatedDataset:
    """Split (data, labels) by class, paper-style: ``user_classes[u]`` is
    the label set user u privately holds (e.g. [[0,1,2,3,4],[5,6,7,8,9]])."""
    shards = []
    for classes in user_classes:
        mask = np.isin(labels, np.asarray(classes))
        shard = data[mask]
        if len(shard) == 0:
            raise ValueError(f"empty shard for classes {classes}")
        shards.append(shard)

    def make_sampler(shard):
        def sample(rng: np.random.Generator, n: int):
            idx = rng.integers(0, len(shard), size=n)
            return shard[idx]
        return sample

    def union(rng: np.random.Generator, n: int):
        alldata = np.concatenate(shards, 0)
        idx = rng.integers(0, len(alldata), size=n)
        return alldata[idx]

    return FederatedDataset(
        samplers=[make_sampler(s) for s in shards],
        union_sampler=union,
        meta={"user_classes": [list(c) for c in user_classes],
              "shard_sizes": [len(s) for s in shards]},
    )
