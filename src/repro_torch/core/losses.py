"""GAN losses (port of the reference's ``core/losses.py``).

D emits logits; BCE-with-logits is written in the reference's form
``max(l, 0) - l*t + log1p(exp(-|l|))``.  Approach 2 averages the users'
D probabilities before its criterion (``g_loss_avg_probs``).  The W-GAN
critic and generator losses (``wgan_d_loss``, ``wgan_g_loss``,
``wgan_g_loss_avg``; the critic's weights clipped by ``clip_params``) serve
``loss_type="wgan"``.  Losses reduce over the LAST axis, so a ``(U, B)``
stack of per-user logits gives ``(U,)`` per-user losses.
"""

from __future__ import annotations

import torch

from repro_torch.models.common import tree_leaves


def bce_with_logits(logits, targets):
    """Elementwise binary cross-entropy on logits."""
    return (torch.clamp(logits, min=0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))


def d_loss(real_logits, fake_logits):
    """Discriminator loss: real->1, fake->0 (mean over the last axis)."""
    lr = bce_with_logits(real_logits, torch.ones_like(real_logits))
    lf = bce_with_logits(fake_logits, torch.zeros_like(fake_logits))
    return lr.mean(-1) + lf.mean(-1)


def g_loss_nonsat(fake_logits):
    """Non-saturating generator loss: fake->1."""
    return bce_with_logits(fake_logits, torch.ones_like(fake_logits)).mean(-1)


def g_loss_avg_probs(fake_logits_per_user):
    """Approach 2 (alg. 2 line 4): average the users' D probabilities over
    the user axis of ``(U, B)`` logits, then BCE against 1."""
    avg = torch.mean(torch.sigmoid(fake_logits_per_user), dim=0)
    return -torch.mean(torch.log(avg + 1e-7))


# ---------------------------------------------------------------------------
# W-GAN (Arjovsky et al., the paper's ref [1]), weight-clipped
# ---------------------------------------------------------------------------

def wgan_d_loss(real_scores, fake_scores):
    """Critic loss: maximize E[D(real)] - E[D(fake)]."""
    return fake_scores.mean(-1) - real_scores.mean(-1)


def wgan_g_loss(fake_scores):
    return -fake_scores.mean(-1)


def wgan_g_loss_avg(fake_scores_per_user):
    """Approach 2's analogue: average the critics' ``(U, B)`` scores over
    the users, then over the batch."""
    return -torch.mean(torch.mean(fake_scores_per_user, dim=0))


def clip_params(params, c: float) -> None:
    """W-GAN Lipschitz enforcement: clip every leaf to [-c, c] IN PLACE
    (the reference returns the clipped tree)."""
    for p in tree_leaves(params):
        p.clamp_(-c, c)


def d_accuracy(real_logits, fake_logits):
    """Share of real logits > 0 and fake logits <= 0, averaged (over the
    last axis)."""
    return 0.5 * ((real_logits > 0).to(torch.float32).mean(-1)
                  + (fake_logits <= 0).to(torch.float32).mean(-1))
