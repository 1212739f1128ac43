"""Gradients the LM train step relies on, held to the JAX reference on the
CPU.

* The CPU forms of the elementwise functions (``models/common.py``: XLA's
  formulas through ``prng``'s exp / log1p / tanh, position-free) are
  autograd Functions whose backward is jax's derivative rule for the
  primitive.  Differentiating the forward formulas themselves gave wrong
  gradients: ``prng.log`` builds its result from integer views, so
  ``log1p``'s ``log(x + 1)`` branch (|x| >= sqrt(2) - 1, i.e. |x| < 0.88
  for softplus) carried none, and softplus / log_sigmoid were off by up
  to 0.5.  Each gradient matches ``jax.grad`` of the reference's
  ``jax.nn`` function within 1e-6 on points across both branches, at 0
  and at +-30; the forwards keep their bits.
* Through the models: mamba2's ``dt_bias`` (softplus of ``dt_raw +
  dt_bias``) and the hybrid's ``lam`` (``log_sigmoid(lam)``) gradients of
  one block (reduced configs, seeded inputs) match the reference's
  ``jax.grad``.
* ``optim.apply_updates`` on a bf16 leaf rounds the f64 sum to f32 and
  then to bf16, as the reference's jitted ``(p.astype(f32) + u).astype(
  p.dtype)``: bitwise, on random values and on sums that fall next to a
  bf16 tie.  (torch's own f64 -> bf16 cast goes through f32 as well,
  so the one-kernel ``torch.add(p, u, out=p)`` gave these bits too;
  the f32 step is now explicit.)
* The hybrid's drawn ``lam`` keeps ``log_sigmoid``'s argument above 4, on
  log1p's rational branch, whose gradient was right; the case with ``lam``
  moved into (-1, 1) is the one that failed before the repair.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import model as JM
from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro.optim import apply_updates as japply_updates
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import common as C
from repro_torch.models import rglru, ssm
from repro_torch.optim import apply_updates

# both branches of XLA's log1p (|x| < 0.88 takes the log(x + 1) one in
# softplus), 0, +-30 and the clamps of XLA's exp
_X = np.concatenate([np.linspace(-3.0, 3.0, 121),
                     [0.0, -0.0, 30.0, -30.0, 0.87, -0.87, 0.89, -0.89,
                      1e-3, -1e-3, 1e-7, 20.0, -20.0, 80.0, -80.0]]
                    ).astype(np.float32)

_FNS = {
    "softplus": (C.softplus, jax.nn.softplus),
    "log_sigmoid": (C.log_sigmoid, jax.nn.log_sigmoid),
    "sigmoid": (C.sigmoid, jax.nn.sigmoid),
    "silu": (C.silu, jax.nn.silu),
    "exp": (C.exp, jnp.exp),
    "tanh": (C.tanh, jnp.tanh),
    "gelu_tanh": (C._gelu_tanh, lambda x: jax.nn.gelu(x, approximate=True)),
}


@pytest.mark.parametrize("name", sorted(_FNS))
def test_cpu_activation_gradient_matches_jax(name):
    tfn, jfn = _FNS[name]
    x = torch.tensor(_X, requires_grad=True)
    y = tfn(x)
    g, = torch.autograd.grad(y, x, torch.ones_like(y))
    jg = np.asarray(jax.jit(jax.grad(lambda v: jnp.sum(jfn(v))))(
        jnp.asarray(_X)))
    np.testing.assert_allclose(g.numpy(), jg, rtol=0, atol=1e-6)
    # the forward keeps its bits (the serving and decode contracts)
    with torch.no_grad():
        again = tfn(torch.tensor(_X))
    assert torch.equal(y.detach(), again)


def test_cpu_softmax_gradient_matches_jax():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(4, 33)) * 4).astype(np.float32)
    w = rng.normal(size=(4, 33)).astype(np.float32)
    t = torch.tensor(x, requires_grad=True)
    y = C.softmax(t, dim=-1)
    g, = torch.autograd.grad((y * torch.from_numpy(w)).sum(), t)
    jf = jax.jit(jax.value_and_grad(
        lambda v: jnp.sum(jax.nn.softmax(v, axis=-1) * w)))
    _, jg = jf(jnp.asarray(x))
    np.testing.assert_allclose(y.detach().numpy(),
                               np.asarray(jax.nn.softmax(x, axis=-1)),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0, atol=1e-6)


def _block_grads(arch, leaf, jfwd, tfwd, x_scale, set_leaf=None):
    """Gradient of sum(block(x) * w) with respect to layer 0's ``leaf``
    in both packages (reduced config, seeded weights and inputs;
    ``set_leaf(rng, shape)`` replaces the leaf's drawn values)."""
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    jp = JM.init_params(jcfg, jax.random.key(3))
    sub = ("layers", "ssm") if arch == "mamba2-780m" else ("groups", "sub0",
                                                           "rec")
    jblk = jp
    for k in sub:
        jblk = jblk[k]
    jblk = jax.tree.map(lambda a: a[0], jblk)
    rng = np.random.default_rng(4)
    if set_leaf is not None:
        jblk = dict(jblk, **{leaf: jnp.asarray(set_leaf(
            rng, jblk[leaf].shape))})
    x = (rng.normal(size=(2, 24, jcfg.d_model)) * x_scale).astype(np.float32)
    w = rng.normal(size=(2, 24, jcfg.d_model)).astype(np.float32)
    jg = jax.jit(jax.grad(lambda p: jnp.sum(jfwd(p, x, jcfg) * w)))(jblk)
    tblk = params_from_numpy(jax.tree.map(np.asarray, jblk), "cpu")
    target = tblk[leaf].requires_grad_()
    out = tfwd(tblk, torch.from_numpy(x), cfg)
    tg, = torch.autograd.grad((out * torch.from_numpy(w)).sum(), target)
    return np.asarray(jg[leaf]), tg.numpy()


def test_mamba2_dt_bias_gradient_matches_reference():
    jg, tg = _block_grads("mamba2-780m", "dt_bias", jssm.ssm_forward,
                          ssm.ssm_forward, 0.5)
    np.testing.assert_allclose(tg, jg, rtol=0,
                               atol=1e-4 * np.abs(jg).max())


# lam as drawn (a = sigmoid(lam)^8 in (0.9, 0.999): lam in about (4.3,
# 9.2), XLA log1p's rational branch) and moved into (-1, 1), where
# log_sigmoid takes its log(x + 1) branch
_LAM = {"init": None,
        "small": lambda rng, shape: rng.uniform(-1, 1, shape).astype(
            np.float32)}


@pytest.mark.parametrize("lam", sorted(_LAM))
def test_hybrid_lam_gradient_matches_reference(lam):
    jg, tg = _block_grads("recurrentgemma-9b", "lam",
                          jrglru.rglru_block_forward,
                          rglru.rglru_block_forward, 1.0, _LAM[lam])
    np.testing.assert_allclose(tg, jg, rtol=0,
                               atol=1e-4 * np.abs(jg).max())


def test_bf16_apply_updates_matches_jitted_reference_bitwise():
    rng = np.random.default_rng(5)
    p = rng.normal(size=4096).astype(np.float32)
    u = (rng.normal(size=4096) * 1e-2).astype(np.float32)
    # sums that land next to a bf16 tie once rounded to f32: 1 + 2^-8 is
    # the midpoint of 1 and the next bf16; 2^-30 above it is lost in f32
    # (ties to even -> 1) but not in f64 (straight to bf16 -> up)
    tie = np.array([2.0 ** -8 + 2.0 ** -30, 2.0 ** -8 - 2.0 ** -30,
                    3 * 2.0 ** -8 + 2.0 ** -30, -(2.0 ** -9) - 2.0 ** -31],
                   np.float32)
    p = np.concatenate([p, np.ones(4, np.float32)]).astype(
        ml_dtypes.bfloat16)
    u = np.concatenate([u, tie])
    want = np.asarray(jax.jit(japply_updates)(
        {"w": jnp.asarray(p)}, {"w": jnp.asarray(u)})["w"])
    got = {"w": torch.from_numpy(p.astype(np.float32)).to(torch.bfloat16)}
    apply_updates(got, {"w": torch.from_numpy(u.astype(np.float64))})
    got = got["w"].view(torch.int16).numpy()
    np.testing.assert_array_equal(got, want.view(np.int16))
