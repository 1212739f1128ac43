"""Cheap versions of the reference's end-to-end scenarios
(``tests/test_distgan.py``) on the port, on the CPU.

Mode coverage: the generator must put over 10 of 1024 samples near at
least 6 of the 8 modes, with modes of both users' arcs among them, after
300 rounds (measured: 8 of 8 for approaches 2, 3, the baseline and W-GAN
approach 3, seeds 0 and 1).  The reference's own 500-round baseline
test fails on jax 0.9.0 at 5 of 8 modes, so this margin is the port's.
"""

import numpy as np
import pytest
import torch

from repro.core import protocol as jprotocol
from repro.core.gan import ConvGanConfig as JaxConvCfg
from repro.core.gan import make_conv_pair as jax_make_conv_pair
from repro_torch.core import approaches as tapp
from repro_torch.core.approaches import DistGANConfig
from repro_torch.core.gan import (ConvGanConfig, MLPGanConfig,
                                  make_conv_pair, make_mlp_pair)
from repro_torch.core.protocol import (effective_epoch_time,
                                       measure_component_times, run_distgan)
from repro_torch.core.session import RunResult
from repro_torch.data import (FederatedDataset, digits_like_mixture,
                              federated_split, make_user_domains,
                              template_coverage)
from repro_torch.models.common import tree_leaves, tree_map

PAIR = make_mlp_pair(MLPGanConfig(data_dim=2, z_dim=16, g_hidden=128,
                                  d_hidden=128))


def _ring_dataset(num_users=2, modes_per_user=4, separation=1.0):
    users, union = make_user_domains(num_users, modes_per_user, separation)
    return FederatedDataset([u.sample for u in users], union.sample,
                            {"users": users, "union": union}), union


@pytest.mark.parametrize("approach,fcfg", [
    ("approach2", DistGANConfig()),
    ("baseline", DistGANConfig()),
    ("approach3", DistGANConfig(loss_type="wgan", d_lr=5e-4, g_lr=1e-4,
                                b1=0.0)),
], ids=["approach2", "baseline", "approach3-wgan"])
def test_approach_covers_both_users_modes(approach, fcfg):
    ds, union = _ring_dataset()
    r = run_distgan(PAIR, fcfg, ds, approach, steps=300, batch_size=128,
                    seed=0, eval_samples=1024, device="cpu")
    _, hist = union.mode_coverage(r.samples)
    hit = hist > 10
    assert hit.sum() >= 6, hist
    if approach != "baseline":
        assert hit[:4].any() and hit[4:].any(), hist
    assert np.all(np.isfinite(r.g_losses)) and np.all(np.isfinite(r.d_losses))


def test_wgan_trains_finite_with_the_clip_held():
    """W-GAN approach 3 (the reference's §10 setting): finite losses, and
    every critic weight within ±wgan_clip after every window."""
    ds, _ = _ring_dataset()
    fcfg = DistGANConfig(loss_type="wgan", d_lr=5e-4, g_lr=1e-4, b1=0.0,
                         wgan_clip=0.03)
    from repro_torch.core.session import FederationSession
    from repro_torch.core.spec import EngineSpec, FederationSpec
    sess = FederationSession(PAIR, fcfg, ds, FederationSpec(
        "approach3", batch_size=64, eval_samples=0,
        engine=EngineSpec(rounds_per_jit=8)), device="cpu")
    for _ in range(3):
        r = sess.run(16)
        assert np.all(np.isfinite(r.g_losses))
        assert all(float(t.abs().max()) <= np.float32(0.03)
                   for t in tree_leaves(r.state.ds))


def test_approach1_sparse_upload_fraction():
    ds, _ = _ring_dataset()
    fcfg = DistGANConfig(selection="topk", upload_frac=0.1)
    r = run_distgan(PAIR, fcfg, ds, "approach1", steps=5, batch_size=32,
                    eval_samples=0, device="cpu")
    assert 0.05 < r.extra["kept_frac"] < 0.2


def test_conv_pair_shapes():
    """The paper's DCGAN (Tables 3-4) pair round-trips, with the
    reference's shapes."""
    cfg = dict(image_size=32, channels=1, z_dim=32, base_filters=16)
    pair = make_conv_pair(ConvGanConfig(**cfg))
    g, d = pair.init(torch.Generator().manual_seed(0))
    img = pair.g_apply(g, pair.sample_z(torch.Generator().manual_seed(1), 4))
    assert img.shape == (4, 32, 32, 1)
    assert float(img.abs().max()) <= 1.0
    assert pair.d_apply(d, img).shape == (4,)
    import jax
    jg, jd = jax.eval_shape(jax_make_conv_pair(JaxConvCfg(**cfg)).init,
                            jax.random.key(0))
    for tree, jtree in ((g, jg), (d, jd)):
        assert [tuple(t.shape) for t in tree_leaves(tree)] == \
            [tuple(t.shape) for t in jax.tree.leaves(jtree)]


@pytest.mark.parametrize("conv", [False, True], ids=["mlp", "conv"])
def test_privacy_each_user_trains_on_its_own_data_only(conv):
    """The privacy boundary, structurally: changing user 1's private batch
    leaves user 0's D step bitwise unchanged (each user's gradient comes
    from its own slice; the conv D folds users into grouped-convolution
    channels and per-user batch norms), and what crosses the boundary
    has D's parameter shapes, none of them the batch's."""
    if conv:
        pair = make_conv_pair(ConvGanConfig(image_size=8, channels=1,
                                            z_dim=4, base_filters=2))
        shape = (3, 6, 8, 8, 1)
    else:
        pair = make_mlp_pair(MLPGanConfig(data_dim=2, z_dim=4, g_hidden=8,
                                          d_hidden=8))
        shape = (3, 6, 2)
    fcfg = DistGANConfig(num_users=3)
    _, d_opt_def = tapp._opts(fcfg)
    update = tapp._d_update_fn(pair, d_opt_def, fcfg)
    rng = np.random.default_rng(0)
    real = torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32))
    fake = torch.from_numpy(rng.uniform(-1, 1, shape[1:]).astype(np.float32))
    outs = []
    for r in (real, torch.cat([real[:1], -real[1:2], real[2:]])):
        st = tapp.init_state(pair, fcfg, 0, "cpu")
        update(st.ds, st.d_opts, r, fake)
        outs.append(tree_map(lambda t: t.clone(), st.ds))
    for a, b in zip(tree_leaves(outs[0]), tree_leaves(outs[1])):
        assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
    assert any(not torch.equal(a[1], b[1]) for a, b in
               zip(tree_leaves(outs[0]), tree_leaves(outs[1])))
    d_shapes = [tuple(t.shape) for t in tree_leaves(outs[0])]
    assert shape[1:] not in [s[1:] for s in d_shapes]


def test_component_times_and_effective_epoch_time():
    """``measure_component_times`` returns positive per-round seconds
    from the per-step engine; ``effective_epoch_time`` is the reference's
    arithmetic, case for case."""
    ds, _ = _ring_dataset()
    t_base, t_d = measure_component_times(PAIR, DistGANConfig(), ds, 32,
                                          iters=3, device="cpu")
    assert t_base > 0 and t_d > 0
    res = RunResult(np.zeros(3), np.zeros((3, 2)), 0.0, 0.0123, None, None,
                    {})
    for approach in ("baseline", "approach1", "approach2", "approach3"):
        for tb, td in ((t_base, t_d), (0.01, 0.004), (0.002, 0.005)):
            kw = dict(t_base=tb, t_d=td, per_samples=10_000, batch_size=64)
            assert effective_epoch_time(res, 2, approach, **kw) == \
                jprotocol.effective_epoch_time(res, 2, approach, **kw)


def test_run_distgan_takes_and_ignores_sample_fn():
    ds, _ = _ring_dataset()
    calls = []
    r = run_distgan(PAIR, DistGANConfig(), ds, "approach2", 2, 16, 0, 0,
                    lambda *a: calls.append(a), device="cpu")
    assert r.g_losses.shape == (2,) and calls == []


def test_federated_split_is_private():
    rng = np.random.default_rng(0)
    data = np.repeat(np.arange(10)[:, None], 3, axis=1).astype(np.float32)
    ds = federated_split(data, np.arange(10), [[0, 1, 2, 3, 4],
                                               [5, 6, 7, 8, 9]])
    for _ in range(5):
        assert ds.user_batch(0, rng, 32).max() <= 4
        assert ds.user_batch(1, rng, 32).min() >= 5


def test_digits_like_images_and_coverage_metric():
    templates, sample = digits_like_mixture(list(range(10)))
    rng = np.random.default_rng(0)
    imgs = sample(rng, 64)
    assert imgs.shape == (64, 28, 28)
    cov, _ = template_coverage(imgs, templates)
    assert cov == 1.0
    noise = rng.normal(size=(64, 28, 28)).astype(np.float32)
    assert template_coverage(noise, templates)[0] < cov
