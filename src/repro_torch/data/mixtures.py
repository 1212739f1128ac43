"""Two-domain synthetic distributions for the Distributed-GAN experiments.

The paper's MNIST splits ("user 1 holds digits 0-4, user 2 holds 5-9";
"6 vs 8 similar, 4 vs 7 dissimilar") are reproduced with measurable
analogues:

* ``GaussianMixture`` — modes on a ring; mode coverage of generated
  samples is the paper's "generates all users' digits" criterion.
* ``digits_like_mixture`` — 28x28 grayscale "digit-like" images: each
  class is a distinct oriented grating + envelope, so class templates
  play the role of digits and template-correlation measures coverage.
* ``make_user_domains(separation)`` — controls the paper's
  domain-similarity axis (§5.3.2): separation 0 => identical domains,
  1 => disjoint far-apart modes.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class GaussianMixture:
    """Mixture of 2-D Gaussians on a ring."""

    modes: np.ndarray          # (M, 2) centers
    std: float = 0.05

    @staticmethod
    def ring(num_modes: int, radius: float = 1.0, phase: float = 0.0,
             std: float = 0.05) -> "GaussianMixture":
        ang = 2 * np.pi * (np.arange(num_modes) / num_modes) + phase
        centers = radius * np.stack([np.cos(ang), np.sin(ang)], -1)
        return GaussianMixture(centers.astype(np.float32), std)

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        idx = rng.integers(0, len(self.modes), size=n)
        return (self.modes[idx] +
                rng.normal(0, self.std, (n, 2))).astype(np.float32)

    def mode_coverage(self, samples: np.ndarray, thresh: float = 3.0):
        """Fraction of modes that own >=1 sample within thresh*std."""
        d = np.linalg.norm(samples[:, None, :] - self.modes[None], axis=-1)
        near = d.min(axis=0) < thresh * self.std
        assign = d.argmin(axis=1)
        hist = np.bincount(assign, minlength=len(self.modes))
        return float(near.mean()), hist


def make_user_domains(num_users: int, modes_per_user: int,
                      separation: float, std: float = 0.05):
    """Per-user mixtures whose domain distance is controlled by
    ``separation`` in [0, 1].  separation=0: all users share the same
    modes (paper's "6 and 8"); separation=1: users own disjoint arcs of
    the ring (paper's "4 and 7" / "0-4 vs 5-9")."""
    total = num_users * modes_per_user
    full = GaussianMixture.ring(total, std=std)
    users = []
    for u in range(num_users):
        shared = full.modes[:modes_per_user]
        own_idx = (np.arange(modes_per_user) * num_users + u) % total
        arc_idx = np.arange(u * modes_per_user, (u + 1) * modes_per_user)
        own = full.modes[arc_idx]
        centers = (1 - separation) * shared + separation * own
        users.append(GaussianMixture(centers.astype(np.float32), std))
    union = GaussianMixture(
        np.concatenate([u.modes for u in users], 0), std)
    return users, union


# ---------------------------------------------------------------------------
# Image-shaped analogue (28x28, for the DCGAN configuration)
# ---------------------------------------------------------------------------

def _grating(cls: int, size: int = 28) -> np.ndarray:
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64) / size - 0.5
    theta = np.pi * cls / 10.0
    freq = 3.0 + (cls % 5)
    wave = np.sin(2 * np.pi * freq * (xx * np.cos(theta) + yy * np.sin(theta)))
    env = np.exp(-((xx ** 2 + yy ** 2) / 0.18))
    img = wave * env
    return (img / np.abs(img).max()).astype(np.float32)


def digits_like_mixture(classes, size: int = 28):
    """Returns (templates (C,size,size), sampler(rng, n) -> (n,size,size))."""
    templates = np.stack([_grating(c, size) for c in classes])

    def sample(rng: np.random.Generator, n: int) -> np.ndarray:
        idx = rng.integers(0, len(classes), size=n)
        noise = rng.normal(0, 0.15, (n, size, size)).astype(np.float32)
        return np.clip(templates[idx] + noise, -1, 1)

    return templates, sample


def template_coverage(samples: np.ndarray, templates: np.ndarray,
                      thresh: float = 0.5):
    """Fraction of templates matched by >=1 sample (normalized corr)."""
    s = samples.reshape(len(samples), -1)
    t = templates.reshape(len(templates), -1)
    s = s / (np.linalg.norm(s, axis=1, keepdims=True) + 1e-9)
    t = t / (np.linalg.norm(t, axis=1, keepdims=True) + 1e-9)
    corr = s @ t.T                      # (n, C)
    best = corr.max(axis=0)             # per-template best match
    return float((best > thresh).mean()), best
