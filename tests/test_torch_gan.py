"""The port's MLP G/D pair, losses, gradients and AdamW held to the JAX
reference from the same converted parameters and inputs.  Tolerance atol
1e-6 / rtol 1e-5: torch's CPU matmul sums in another order than XLA's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import losses as jlosses
from repro.core.gan import MLPGanConfig as JaxMLPCfg
from repro.core.gan import make_mlp_pair as jax_make_mlp_pair
from repro.optim import adamw as jadamw
from repro.optim import apply_updates as japply
from repro_torch.core import losses as tlosses
from repro_torch.core.approaches import _grad
from repro_torch.core.gan import MLPGanConfig, make_mlp_pair
from repro_torch.models.common import tree_map
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import apply_updates as tapply

SMALL = dict(data_dim=64, z_dim=16, g_hidden=32, d_hidden=32)
TOL = dict(atol=1e-6, rtol=1e-5)


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got, want):
    jax.tree.map(lambda g, w: np.testing.assert_allclose(
        g.detach().numpy(), np.asarray(w), **TOL), got, want)


@pytest.fixture(scope="module")
def setup():
    jpair = jax_make_mlp_pair(JaxMLPCfg(**SMALL))
    g, d = jpair.init(jax.random.key(3))
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (8, SMALL["data_dim"])).astype(np.float32)
    z = rng.normal(size=(8, SMALL["z_dim"])).astype(np.float32)
    return jpair, make_mlp_pair(MLPGanConfig(**SMALL)), g, d, x, z


def test_init_draws_have_reference_shapes_and_scales():
    pair = make_mlp_pair(MLPGanConfig(**SMALL))
    g, d = pair.init(torch.Generator().manual_seed(0))
    jg, jd = jax_make_mlp_pair(JaxMLPCfg(**SMALL)).init(jax.random.key(0))
    for got, want in ((g, jg), (d, jd)):
        jax.tree.map(lambda a, b: a.shape == b.shape or pytest.fail(
            f"{a.shape} != {b.shape}"), _t(want), got)
    assert torch.all(d["l1"]["b"] == 0)
    assert abs(float(d["l1"]["w"].std()) - 1 / np.sqrt(64)) < 0.02


def test_forward_and_losses_match_reference(setup):
    jpair, pair, g, d, x, z = setup
    jfake = jpair.g_apply(g, jnp.asarray(z))
    fake = pair.g_apply(_t(g), torch.from_numpy(z))
    _close(fake, jfake)
    jr, jf = jpair.d_apply(d, jnp.asarray(x)), jpair.d_apply(d, jfake)
    r, f = pair.d_apply(_t(d), torch.from_numpy(x)), pair.d_apply(_t(d), fake)
    _close(r, jr)
    _close(f, jf)
    _close(tlosses.d_loss(r, f), jlosses.d_loss(jr, jf))
    _close(tlosses.g_loss_nonsat(f), jlosses.g_loss_nonsat(jf))


def test_stacked_users_equal_single_user_applies(setup):
    """The leading user axis (the reference's vmap) gives each user's own
    logits."""
    _, pair, _, d, x, _ = setup
    td = _t(d)
    stacked = tree_map(lambda a: torch.stack([a, 2 * a, -a]), td)
    xs = torch.from_numpy(np.stack([x, x[::-1], x * 0.5]).copy())
    got = pair.d_apply(stacked, xs)
    for u, scale in enumerate((1.0, 2.0, -1.0)):
        one = tree_map(lambda a: a * scale, td)
        torch.testing.assert_close(got[u], pair.d_apply(one, xs[u]),
                                   **TOL)


def test_gradients_match_reference(setup):
    jpair, pair, g, d, x, z = setup
    jfake = jpair.g_apply(g, jnp.asarray(z))

    def jd_loss(dp):
        return jlosses.d_loss(jpair.d_apply(dp, jnp.asarray(x)),
                              jpair.d_apply(dp, jfake))
    jl, jgrad = jax.value_and_grad(jd_loss)(d)
    fake = torch.from_numpy(np.array(jfake))
    tl, tgrad = _grad(lambda dp: tlosses.d_loss(
        pair.d_apply(dp, torch.from_numpy(x)), pair.d_apply(dp, fake)), _t(d))
    _close(tl, jl)
    _close(tgrad, jgrad)

    def jg_loss(gp):
        return jlosses.g_loss_nonsat(
            jpair.d_apply(d, jpair.g_apply(gp, jnp.asarray(z))))
    jl, jgrad = jax.value_and_grad(jg_loss)(g)
    td = _t(d)
    tl, tgrad = _grad(lambda gp: tlosses.g_loss_nonsat(
        pair.d_apply(td, pair.g_apply(gp, torch.from_numpy(z)))), _t(g))
    _close(tl, jl)
    _close(tgrad, jgrad)


def test_adamw_steps_match_reference(setup):
    """Three steps from the same params and gradients: moments, step and
    params (updated in place in the port)."""
    _, _, _, d, _, _ = setup
    jopt = jadamw(2e-4, b1=0.5, b2=0.999)
    topt = tadamw(2e-4, b1=0.5, b2=0.999)
    jp, js = d, jopt.init(d)
    tp = _t(d)
    ts = topt.init(tp)
    rng = np.random.default_rng(1)
    for _ in range(3):
        grads = jax.tree.map(
            lambda a: rng.normal(scale=1e-2, size=a.shape).astype(np.float32),
            d)
        upd, js = jopt.update(grads, js, jp)
        jp = japply(jp, upd)
        tapply(tp, topt.update(_t(grads), ts, tp))
    _close(tp, jp)
    _close(ts["mu"], js["mu"])
    _close(ts["nu"], js["nu"])
    assert int(ts["step"]) == int(js["step"]) == 3
