"""The benchmark's inputs, made from ``--seed``: digit-like images, their
Dirichlet split over the users, the users' batches and the uniform cohort
schedule.

Frozen copies of the program's ``data/mixtures.py`` (``_grating``, the
sampler of ``digits_like_mixture``), ``data/federated.py``
(``dirichlet_partition`` and its shard sampler) and the ``uniform``
scheduler of ``core/federated.py``: the images are handed to the program,
which splits and samples them itself; the plain reference splits and
samples them again with these copies.
"""

from __future__ import annotations

import numpy as np

CLASSES = 10
NOISE_STD = 0.15


def _grating(cls: int, size: int) -> np.ndarray:
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64) / size - 0.5
    theta = np.pi * cls / 10.0
    freq = 3.0 + (cls % 5)
    wave = np.sin(2 * np.pi * freq * (xx * np.cos(theta) + yy * np.sin(theta)))
    env = np.exp(-((xx ** 2 + yy ** 2) / 0.18))
    img = wave * env
    return (img / np.abs(img).max()).astype(np.float32)


def images(seed: int, count: int, size: int, channels: int):
    """``count`` digit-like images, ``count // 10`` of each class: a class
    template plus N(0, 0.15) noise, clipped to [-1, 1].  One channel gives
    flat ``(count, size * size)`` rows; three give NHWC ``(count, size,
    size, 3)``, the gray image tiled.  Returns ``(data, labels)``."""
    if count % CLASSES or channels not in (1, 3):
        raise ValueError(f"count {count} must split over {CLASSES} classes "
                         f"and channels {channels} be 1 or 3")
    rng = np.random.default_rng([seed, 1])
    per = count // CLASSES
    data = np.empty((count, size, size), np.float32)
    for c in range(CLASSES):
        noise = rng.normal(0, NOISE_STD, (per, size, size)).astype(np.float32)
        np.clip(_grating(c, size)[None] + noise, -1, 1,
                out=data[c * per:(c + 1) * per])
    labels = np.repeat(np.arange(CLASSES), per)
    if channels == 1:
        return data.reshape(count, -1), labels
    return np.repeat(data[..., None], 3, axis=-1), labels


def partition_seed(seed: int) -> int:
    """The Dirichlet split's seed for run seed ``seed``."""
    return seed + 1


def dirichlet_shards(data: np.ndarray, labels: np.ndarray, num_users: int,
                     alpha: float, seed: int) -> list[np.ndarray]:
    """Label-skew split (Hsu et al., arXiv:1909.06335): per class, the
    users' shares drawn from Dirichlet(alpha); an empty shard takes the
    last sample of the largest one.  Each shard keeps its samples in
    their order in ``data``."""
    rng = np.random.default_rng(seed)
    per_user: list[list[np.ndarray]] = [[] for _ in range(num_users)]
    for c in np.unique(labels):
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        props = rng.dirichlet(np.full(num_users, alpha))
        cuts = (np.cumsum(props)[:-1] * len(idx)).astype(np.int64)
        for u, part in enumerate(np.split(idx, cuts)):
            per_user[u].append(part)
    owned = [np.concatenate(p) for p in per_user]
    for u in range(num_users):
        while len(owned[u]) == 0:
            donor = int(np.argmax([len(o) for o in owned]))
            owned[u], owned[donor] = owned[donor][-1:], owned[donor][:-1]
    return [np.sort(o) for o in owned]


def user_batch(data: np.ndarray, shard: np.ndarray,
               rng: np.random.Generator, n: int) -> np.ndarray:
    """``n`` samples of one user's shard, drawn with replacement."""
    return data[shard[rng.integers(0, len(shard), size=n)]]


def data_rng(seed: int) -> np.random.Generator:
    """The stream the users' batches are drawn from, user by user in
    cohort order, round by round."""
    return np.random.default_rng(seed)


def schedule_rng(seed: int) -> np.random.Generator:
    """The stream the cohort schedule is drawn from."""
    return np.random.default_rng([seed, 0x5EED])


def cohort(rng: np.random.Generator, num_users: int, size: int,
           scheduler: str) -> np.ndarray:
    """One round's members: every user in order (``full``) or ``size`` of
    them drawn without replacement (``uniform``)."""
    if scheduler == "full":
        return np.arange(num_users)
    if scheduler == "uniform":
        return rng.choice(num_users, size=size, replace=False)
    raise ValueError(f"no plain schedule for {scheduler!r}")
