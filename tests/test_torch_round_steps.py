"""The reference's small public helpers on the port, held to the reference
on the CPU:

* ``core/approaches.py::make_{approach1,approach2,approach3,baseline,
  download_first}_step``: a one-round step over each body (the
  reference's ``_finalize_step``, a jit with the state donated; here the
  state updated in place).  Each step equals one round of its body from
  the same state and draws, bitwise;
* ``core/federated.py::select_delta`` / ``upload_bytes``: the tree forms of
  ``select_delta_flat`` / ``upload_bytes_flat``, against the reference's on
  the cases of ``tests/test_federated.py`` (the ``random`` policy with the
  reference's own uniforms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import federated as jfed
from repro_torch.core import approaches as tapp
from repro_torch.core import federated as tfed
from repro_torch.core.gan import MLPGanConfig, make_mlp_pair
from repro_torch.models.common import tree_leaves

SMALL = MLPGanConfig(data_dim=6, z_dim=4, g_hidden=8, d_hidden=8)
U, B = 3, 5
_APPROACHES = ("approach1", "approach2", "approach3", "baseline",
               "download_first")


def _state_tensors(state):
    return [t for f in ("g", "g_opt", "ds", "d_opts", "server_d")
            for t in tree_leaves(getattr(state, f))] + [state.step]


@pytest.mark.parametrize("approach", _APPROACHES)
def test_step_equals_one_round_of_its_body(approach):
    pair = make_mlp_pair(SMALL)
    codec = "topk_int8" if approach == "approach1" else "none"
    fcfg = tapp.DistGANConfig(num_users=U, codec=codec,
                              codec_stochastic=codec != "none")
    sync = approach in ("approach1", "download_first")
    state = tapp.init_state(pair, fcfg, 0, "cpu", sync_ds=sync)
    rng = np.random.default_rng(1)
    shape = (B, 6) if approach == "baseline" else (U, B, 6)
    real = torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32))
    extra = {}
    if codec != "none":
        extra["residual"] = torch.from_numpy(
            rng.normal(scale=1e-3, size=(U, tapp.d_flat_layout(pair).n))
            .astype(np.float32))
    body = getattr(tapp, f"make_{approach}_body")(pair, fcfg)
    step = getattr(tapp, f"make_{approach}_step")(pair, fcfg)
    a, b = state.clone(), state.clone()
    out_body = body(a, real, **extra)
    out_step = step(b, real, **extra)
    assert out_step[0] is b
    assert all(torch.equal(x, y) for x, y in
               zip(_state_tensors(a), _state_tensors(b)))
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    for k in out_body[1]:
        assert torch.equal(out_body[1][k], out_step[1][k])
    if codec != "none":
        assert torch.equal(out_body[2], out_step[2])
    assert int(b.step) == 1


def _tree():
    return ({"a": np.arange(10, dtype=np.float32) - 5,
             "b": {"c": np.ones((4, 4), np.float32) * 0.01}})


def _torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _flat(tree):
    return np.concatenate([np.ravel(np.asarray(l))
                           for l in jax.tree.leaves(tree)])


@pytest.mark.parametrize("use_kernel", [False, True])
def test_select_delta_topk_and_none_equal_the_references(use_kernel):
    tree = _tree()
    jm, jk = jfed.select_delta(jax.tree.map(jnp.asarray, tree), "topk",
                               frac=0.25)
    tm, tk = tfed.select_delta(_torch(tree), "topk", frac=0.25,
                               use_kernel=use_kernel)
    np.testing.assert_array_equal(
        _flat(jax.tree.map(lambda t: t.numpy(), tm)), _flat(jm))
    assert float(tk) == float(jk)
    assert set(tm) == {"a", "b"} and tm["b"]["c"].shape == (4, 4)
    five = _torch({"a": np.arange(5, dtype=np.float32)})
    out, kept = tfed.select_delta(five, "none")
    assert torch.equal(out["a"], torch.arange(5, dtype=torch.float32))
    assert float(kept) == 1.0 and kept.shape == ()


@pytest.mark.parametrize("policy", ["threshold", "random"])
def test_select_delta_threshold_and_random_equal_the_references(policy):
    rng = np.random.default_rng(2)
    tree = {"a": rng.normal(size=100).astype(np.float32),
            "b": rng.normal(size=(3, 7)).astype(np.float32)}
    kw, tkw = {}, {}
    if policy == "threshold":
        kw = tkw = {"tau": 0.5}
    else:
        key = jax.random.key(0)
        n = 100 + 21
        kw = {"key": key, "frac": 0.3}
        tkw = {"frac": 0.3, "uniforms": torch.from_numpy(np.array(
            jax.random.uniform(key, (n,))))[None]}
    jm, jk = jfed.select_delta(jax.tree.map(jnp.asarray, tree), policy, **kw)
    tm, tk = tfed.select_delta(_torch(tree), policy, **tkw)
    np.testing.assert_array_equal(
        _flat(jax.tree.map(lambda t: t.numpy(), tm)), _flat(jm))
    # the kept fraction's mean: XLA multiplies the count by the f32
    # reciprocal of n, torch divides, so the two may sit one ULP apart
    assert abs(float(tk) - float(jk)) <= np.spacing(np.float32(jk))


@pytest.mark.parametrize("frac", [0.01, 0.1, 0.37, 1.0])
@pytest.mark.parametrize("codec", ["none", "bf16", "int8", "topk_int8"])
def test_upload_bytes_equals_the_references(frac, codec):
    tree = {"a": np.zeros((1000,), np.float32),
            "b": np.zeros((24, 24), np.float32)}
    tt, jt = _torch(tree), jax.tree.map(jnp.asarray, tree)
    for policy in ("none", "topk", "random", "shared_random"):
        assert tfed.upload_bytes(tt, policy, frac, codec=codec) == \
            jfed.upload_bytes(jt, policy, frac, codec=codec)
    n = 1000 + 24 * 24
    if codec == "none":
        assert tfed.upload_bytes(tt, "none", frac) == 4 * n
        assert tfed.upload_bytes(tt, "topk", frac) == int(n * frac) * 8
    rng = np.random.default_rng(3)
    noisy = {"a": rng.normal(size=1000).astype(np.float32),
             "b": rng.normal(size=(24, 24)).astype(np.float32)}
    for kept_frac in (None, 0.25):
        assert tfed.upload_bytes(_torch(noisy), "threshold", tau=1.0,
                                 kept_frac=kept_frac, codec=codec) == \
            jfed.upload_bytes(jax.tree.map(jnp.asarray, noisy), "threshold",
                              tau=1.0, kept_frac=kept_frac, codec=codec)
