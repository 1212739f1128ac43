"""The port's DCGAN conv pair and W-GAN objective held to the JAX
reference from the same converted parameters and inputs.

* G and D outputs and gradients at a small width (image 16, 3 channels,
  8 base filters, z 16), one D and U = 3 stacked Ds against the
  reference's ``vmap`` (per-user batches and one shared batch): within
  ``FWD`` (atol 1e-6, rtol 1e-5; measured worst |diff| ~2e-7).  Gradients
  are held at ``GRAD`` = rtol 1e-4 with an atol of 1e-6 of the largest
  gradient of the leaf: a conv weight's gradient sums fan-in x batch x
  positions products, and batch norm divides by the batch's deviation,
  so its rounding scales with the leaf's largest entry, not with 1.
* One round each of approaches 1, 2, 3 and the baseline with the conv
  pair (approach 1 under ``none`` and ``topk_int8`` with stochastic
  rounding), and of every approach with ``loss_type="wgan"`` on the MLP
  pair, against the reference's JITTED body with the reference's own
  draws (z1, z2, the codec seed).  Every state leaf and metric within
  ROUND_ATOL = 1e-5, the tolerance of the MLP's round tests (Adam's first
  moments make one round's update about lr in size, so atol holds here).
  ``test_conv_approach1_select_fold_on_reference_delta`` feeds the
  reference's own (U, N) conv delta to the port's top-k -> codec -> fold
  and holds that chain BITWISE, since a top-k threshold tie between
  deltas an ULP apart could flip one element in a whole round.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import approaches as japp
from repro.core import federated as jfed
from repro.core import losses as jlosses
from repro.core.gan import ConvGanConfig as JaxConvCfg
from repro.core.gan import MLPGanConfig as JaxMLPCfg
from repro.core.gan import make_conv_pair as jax_make_conv_pair
from repro.core.gan import make_mlp_pair as jax_make_mlp_pair
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import approaches as tapp
from repro_torch.core import federated as tfed
from repro_torch.core import losses as tlosses
from repro_torch.core.approaches import _grad
from repro_torch.core.gan import (ConvGanConfig, MLPGanConfig,
                                  make_conv_pair, make_mlp_pair)
from repro_torch.core.spec import resolve_approach

CONV = dict(image_size=16, channels=3, z_dim=16, base_filters=8)
SMALL = dict(data_dim=64, z_dim=16, g_hidden=32, d_hidden=32)
FWD = dict(atol=1e-6, rtol=1e-5)
ROUND_ATOL = 1e-5
U, B = 3, 8


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _np(tree):
    return jax.tree.map(lambda a: a.numpy() if isinstance(a, torch.Tensor)
                        else np.asarray(a), tree)


def _close_grad(got, want):
    def one(g, w):
        w = np.asarray(w)
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=1e-4,
                                   atol=1e-6 * max(np.abs(w).max(), 1e-30))
    jax.tree.map(one, got, want)


def _port_init(pair, seed, users=None):
    """Weights drawn by the port as numpy (the reference's eager init costs
    seconds per tree on the CPU; the values need only be shared)."""
    gen = torch.Generator().manual_seed(seed)
    g, d = pair.init(gen)
    if users is None:
        return _np(g), _np(d)
    ds = [pair.init(gen)[1] for _ in range(users)]
    return jax.tree.map(lambda *a: np.stack([np.asarray(x) for x in a]),
                        *[_np(x) for x in ds])


@pytest.fixture(scope="module")
def conv():
    jpair = jax_make_conv_pair(JaxConvCfg(**CONV))
    pair = make_conv_pair(ConvGanConfig(**CONV))
    g, d = _port_init(pair, 3)
    ds = _port_init(pair, 4, users=U)
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (U, B, 16, 16, 3)).astype(np.float32)
    z = rng.normal(size=(B, CONV["z_dim"])).astype(np.float32)
    return jpair, pair, g, d, ds, x, z


def test_decls_match_reference_shapes_and_flat_layout(conv):
    """HWIO kernels and batch norms under the reference's names: the flat
    D row is the reference's, leaf for leaf."""
    jpair, pair, _, d, _, _, _ = conv
    tg, td = pair.init(torch.Generator().manual_seed(0))
    jg, jd = jax.eval_shape(jpair.init, jax.random.key(0))
    for got, want in ((tg, jg), (td, jd)):
        jax.tree.map(lambda a, b: a.shape == tuple(b.shape) or pytest.fail(
            f"{a.shape} != {b.shape}"), got, want)
    jl, tl = japp.d_flat_layout(jpair), tapp.d_flat_layout(pair)
    assert (jl.n, tuple(map(tuple, jl.shapes))) == (tl.n, tl.shapes)
    flat = tl.flatten(_t(d)).numpy()
    np.testing.assert_array_equal(flat, np.asarray(jl.flatten(d)))
    assert torch.all(td["bn2"]["scale"] == 1) and \
        torch.all(td["bn3"]["bias"] == 0)
    assert abs(float(td["c2"]["w"].std()) - 0.02) < 2e-3


def test_g_and_d_forward_match_reference(conv):
    jpair, pair, g, d, _, x, z = conv
    jimg = jpair.g_apply(g, jnp.asarray(z))
    img = pair.g_apply(_t(g), torch.from_numpy(z))
    assert img.shape == (B, 16, 16, 3)
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), **FWD)
    np.testing.assert_allclose(pair.d_apply(_t(d), img).numpy(),
                               np.asarray(jpair.d_apply(d, jimg)), **FWD)
    np.testing.assert_allclose(
        pair.d_apply(_t(d), torch.from_numpy(x[0])).numpy(),
        np.asarray(jpair.d_apply(d, jnp.asarray(x[0]))), **FWD)


@pytest.mark.parametrize("shared", [False, True])
def test_stacked_ds_match_vmapped_reference(conv, shared):
    """U stacked Ds as one grouped convolution per layer: per-user batches
    (U, B, H, W, C) or one shared batch, each user's logits as the
    reference's vmap gives them."""
    jpair, pair, _, _, ds, x, _ = conv
    xin = x[0] if shared else x
    want = jax.vmap(jpair.d_apply, in_axes=(0, None if shared else 0))(
        ds, jnp.asarray(xin))
    got = pair.d_apply(_t(ds), torch.from_numpy(xin))
    assert got.shape == (U, B)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


def test_stacked_d_gradients_match_vmapped_reference(conv):
    """The sum of the U per-user D losses gives each user exactly its own
    gradient, batch-norm scales and biases included."""
    jpair, pair, g, _, ds, x, z = conv
    jfake = jpair.g_apply(g, jnp.asarray(z))

    def jone(dp, real):
        return jlosses.d_loss(jpair.d_apply(dp, real),
                              jpair.d_apply(dp, jfake))
    jl, jgrad = jax.jit(jax.vmap(jax.value_and_grad(jone)))(
        ds, jnp.asarray(x))
    fake = torch.from_numpy(np.array(jfake))
    real = torch.from_numpy(x)
    tl, tgrad = _grad(lambda dp: tlosses.d_loss(pair.d_apply(dp, real),
                                                pair.d_apply(dp, fake)),
                      _t(ds))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **FWD)
    _close_grad(tgrad, jgrad)


def test_g_gradients_match_reference(conv):
    jpair, pair, g, d, _, _, z = conv

    def jg_loss(gp):
        return jlosses.g_loss_nonsat(jpair.d_apply(d,
                                                   jpair.g_apply(gp, z)))
    jl, jgrad = jax.jit(jax.value_and_grad(jg_loss))(g)
    td, tz = _t(d), torch.from_numpy(z)
    tl, tgrad = _grad(lambda gp: tlosses.g_loss_nonsat(
        pair.d_apply(td, pair.g_apply(gp, tz))), _t(g))
    np.testing.assert_allclose(float(tl), float(jl), **FWD)
    _close_grad(tgrad, jgrad)


def test_wgan_losses_and_clip_match_reference():
    rng = np.random.default_rng(2)
    r, f = (rng.normal(size=(U, B)).astype(np.float32) for _ in range(2))
    tr, tf = torch.from_numpy(r), torch.from_numpy(f)
    for u in range(U):
        np.testing.assert_allclose(
            tlosses.wgan_d_loss(tr, tf)[u].numpy(),
            np.asarray(jlosses.wgan_d_loss(r[u], f[u])), **FWD)
        np.testing.assert_allclose(
            tlosses.wgan_g_loss(tf)[u].numpy(),
            np.asarray(jlosses.wgan_g_loss(f[u])), **FWD)
        np.testing.assert_array_equal(
            tlosses.d_accuracy(tr, tf)[u].numpy(),
            np.asarray(jlosses.d_accuracy(r[u], f[u])))
    np.testing.assert_allclose(tlosses.wgan_g_loss_avg(tf).numpy(),
                               np.asarray(jlosses.wgan_g_loss_avg(f)), **FWD)
    tree = {"a": {"w": rng.normal(size=(4, 5)).astype(np.float32) * 0.1},
            "b": rng.normal(size=(3,)).astype(np.float32)}
    port = _t(tree)
    tlosses.clip_params(port, 0.05)           # in place
    jax.tree.map(lambda p, w: np.testing.assert_array_equal(
        p.numpy(), np.asarray(w)), port, jlosses.clip_params(tree, 0.05))


# ---------------------------------------------------------------------------
# One round of each approach against the jitted reference
# ---------------------------------------------------------------------------

def _port_fcfg(fcfg):
    return tapp.DistGANConfig(**{f.name: getattr(fcfg, f.name)
                                 for f in dataclasses.fields(fcfg)})


def _draws(jpair, approach, fcfg, key, C):
    """The reference body's z (and codec seed) draws from its key."""
    if approach == "approach3":
        z1, z2 = [], []
        for _ in range(C):
            key, kz1, kz2 = jax.random.split(key, 3)
            z1.append(np.array(jpair.sample_z(kz1, B)))
            z2.append(np.array(jpair.sample_z(kz2, B)))
        return {"z1": torch.from_numpy(np.stack(z1)),
                "z2": torch.from_numpy(np.stack(z2))}
    lossy = approach == "approach1" and fcfg.codec != "none"
    keys = jax.random.split(key, 5 if lossy else
                            (4 if approach == "approach1" else 3))
    out = {"z1": torch.from_numpy(np.array(jpair.sample_z(keys[1], B))),
           "z2": torch.from_numpy(np.array(jpair.sample_z(keys[2], B)))}
    if lossy and fcfg.codec_stochastic:
        out["seed"] = int(jax.random.randint(keys[4], (), 0,
                                             jnp.int32(2**31 - 1)))
    return out


def _state(state):
    return {f: _np(getattr(state, f))
            for f in ("g", "g_opt", "ds", "d_opts", "server_d", "step")}


def _reference_round(pair, jpair, approach, fcfg, shape):
    """Two warm-up rounds of the jitted reference body from the port's
    initial state, then the compared one: the state before it, its draws
    and inputs, its outputs."""
    body = jax.jit(japp.BODY_FACTORIES[approach](jpair, fcfg))
    sync = approach == "approach1"
    init = state_to_numpy(tapp.init_state(pair, _port_fcfg(fcfg), 0, "cpu",
                                          sync_ds=sync))
    state = japp.DistGANState(**jax.tree.map(jnp.asarray, init),
                              key=jax.random.key(0))
    rng = np.random.default_rng(9)
    for _ in range(2):
        state, _ = body(state, jnp.asarray(rng.uniform(-1, 1, shape),
                                           jnp.float32))
    before = _state(state)
    draws = _draws(jpair, approach, fcfg, state.key, U)
    real = rng.uniform(-1, 1, shape).astype(np.float32)
    want, metrics = body(state, jnp.asarray(real))
    return before, draws, real, _state(want), _np(metrics)


def _check_round(pair, approach, fcfg, before, draws, real, want, metrics):
    body = resolve_approach(approach).body_factory(pair, _port_fcfg(fcfg))
    st, m = body(state_from_numpy(before, "cpu"), torch.from_numpy(real),
                 **draws)
    got = state_to_numpy(st)
    jax.tree.map(lambda g, w: np.testing.assert_allclose(
        g, w, atol=ROUND_ATOL, rtol=0), got, {f: want[f] for f in got})
    for key in ("d_loss", "g_loss", "kept_frac"):
        assert m[key].shape == np.shape(metrics[key])
        np.testing.assert_allclose(m[key].numpy(), metrics[key],
                                   atol=ROUND_ATOL, rtol=0)
    return st


CONV_ROUNDS = {
    "approach1-none": ("approach1", {}),
    "approach1-topk_int8-sr": ("approach1", dict(codec="topk_int8",
                                                 error_feedback=False,
                                                 codec_stochastic=True)),
    "approach2": ("approach2", {}),
    "approach3": ("approach3", {}),
    "baseline": ("baseline", {}),
}


@pytest.mark.parametrize("case", list(CONV_ROUNDS))
def test_conv_round_matches_jitted_reference(case):
    approach, kw = CONV_ROUNDS[case]
    jpair = jax_make_conv_pair(JaxConvCfg(**CONV))
    fcfg = japp.DistGANConfig(num_users=U, upload_frac=0.1, **kw)
    shape = (B, 16, 16, 3) if approach == "baseline" else (U, B, 16, 16, 3)
    pair = make_conv_pair(ConvGanConfig(**CONV))
    _check_round(pair, approach, fcfg,
                 *_reference_round(pair, jpair, approach, fcfg, shape))


@pytest.mark.parametrize("approach", ["approach1", "approach2", "approach3",
                                      "baseline"])
def test_wgan_round_matches_jitted_reference(approach):
    """W-GAN on the MLP pair (the reference's §10 setting: d_lr 5e-4, g_lr
    1e-4, b1 0): the critic loss, the clip after the D step, approach 2's
    averaged critic; every local critic within the clip after the round
    where it is a trained critic (approach 1's local Ds re-sync to the
    server D, which the reference does not clip)."""
    jpair = jax_make_mlp_pair(JaxMLPCfg(**SMALL))
    fcfg = japp.DistGANConfig(num_users=U, loss_type="wgan", d_lr=5e-4,
                              g_lr=1e-4, b1=0.0, wgan_clip=0.05)
    shape = ((B, SMALL["data_dim"]) if approach == "baseline"
             else (U, B, SMALL["data_dim"]))
    pair = make_mlp_pair(MLPGanConfig(**SMALL))
    st = _check_round(pair, approach, fcfg,
                      *_reference_round(pair, jpair, approach, fcfg, shape))
    if approach == "approach1":
        return
    rows = slice(0, 1) if approach == "baseline" else slice(None)
    for leaf in jax.tree.leaves(_t(state_to_numpy(st)["ds"])):
        assert float(leaf[rows].abs().max()) <= np.float32(0.05)


def test_conv_approach1_select_fold_on_reference_delta():
    """The reference's own (U, N) conv-D delta through the port's top-k ->
    stochastic int8 -> max-abs fold equals the reference's chain bitwise
    (675,584-wide rows take the same code at the paper's width)."""
    jpair = jax_make_conv_pair(JaxConvCfg(**CONV))
    fcfg = japp.DistGANConfig(num_users=U, codec="topk_int8",
                              codec_stochastic=True)
    pair = make_conv_pair(ConvGanConfig(**CONV))
    state = japp.DistGANState(**jax.tree.map(jnp.asarray, state_to_numpy(
        tapp.init_state(pair, _port_fcfg(fcfg), 1, "cpu", sync_ds=True))),
        key=jax.random.key(1))
    _, d_opt_def = japp._opts(fcfg)
    d_update = japp._d_update_fn(jpair, d_opt_def, fcfg)
    rng = np.random.default_rng(4)
    real = jnp.asarray(rng.uniform(-1, 1, (U, B, 16, 16, 3)), jnp.float32)
    fake = jax.jit(jpair.g_apply)(state.g, jnp.asarray(
        rng.normal(size=(B, CONV["z_dim"])), jnp.float32))
    new_ds, _, _ = jax.jit(jax.vmap(d_update, in_axes=(0, 0, 0, None)))(
        state.ds, state.d_opts, real, fake)
    layout = japp.d_flat_layout(jpair)
    delta = layout.flatten_stacked(new_ds) - layout.flatten_stacked(state.ds)
    rows = [jfed.select_delta_flat(delta[u], "topk", frac=0.1,
                                   use_kernel=True) for u in range(U)]
    jmasked = jfed.codec_transport(jnp.stack([r[0] for r in rows]),
                                   "topk_int8", stochastic=True,
                                   seed=jnp.int32(77))
    tmasked, _ = tfed.select_delta_flat(torch.from_numpy(np.array(delta)),
                                        "topk", frac=0.1, use_kernel=True)
    tmasked = tfed.codec_transport(tmasked, "topk_int8", stochastic=True,
                                   seed=77, use_kernel=True)
    np.testing.assert_array_equal(tmasked.numpy(), np.asarray(jmasked))
    np.testing.assert_array_equal(
        tfed.combine_max_abs(tmasked).numpy(),
        np.asarray(jfed.combine_max_abs(jmasked)))
