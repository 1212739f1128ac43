"""The port's MoE layer (``repro_torch.models.moe``) held to the reference's
``models/moe.py`` on the CPU, on the same seeded inputs and weights.

Tolerances: expert ids and dispatch positions bitwise; router weights and
the auxiliary loss within 1e-6; the layer's output within 1e-5 of its scale
(f32 expert products summed in another order).  The reference's dispatch
is reproduced where experts overflow too: XLA applies the duplicate
indices of its ``.at[e, p].set`` in order, so a dropped (token, slot)
zeroes row 0 of its expert and the first token routed there loses that
expert's output.  The reference's own hypothesis cases
(``tests/test_moe.py``, skipped where hypothesis is missing) run here on
the port over fixed seeds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import moe as jmoe
from repro.models.common import build as jbuild
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import moe as tmoe
from repro_torch.models.common import activation
from repro_torch.models.mlp import mlp_forward


def _cfgs(**kw):
    j = dataclasses.replace(jget_config("deepseek-moe-16b").reduced(), **kw)
    t = dataclasses.replace(get_config("deepseek-moe-16b").reduced(), **kw)
    return j, t


def _params(jcfg, seed=0, skew=0.0):
    """The reference's MoE weights, and the same in the port.  ``skew`` adds
    to the router's columns of experts 0 and 1 so that they overflow."""
    jp = jax.tree.map(np.asarray, jbuild(jmoe.moe_decls(jcfg),
                                         jax.random.key(seed), jnp.float32))
    if skew:
        jp["router"] = jp["router"].copy()
        jp["router"][:, :2] += skew
    return jax.tree.map(jnp.asarray, jp), params_from_numpy(jp, "cpu")


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


@pytest.mark.parametrize("E,k", [(4, 2), (8, 3), (64, 6)])
def test_route_matches_reference(E, k):
    jcfg, tcfg = _cfgs(num_experts=E, experts_per_token=k)
    x, w = _x((48, jcfg.d_model), 1), _x((jcfg.d_model, E), 2, 0.1)
    jw, ji, jaux = jmoe.route(jnp.asarray(w), jnp.asarray(x), jcfg)
    tw, ti, taux = tmoe.route(torch.from_numpy(w), torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=0, atol=1e-6)


@pytest.mark.parametrize("T,E,k,C", [(40, 8, 2, 4), (33, 4, 3, 30),
                                     (64, 4, 2, 32), (7, 64, 6, 1)])
def test_dispatch_indices_bitwise(T, E, k, C):
    rng = np.random.default_rng(T + E)
    top_i = np.stack([rng.permutation(E)[:k] for _ in range(T)]
                     ).astype(np.int32)
    top_i[: T // 3] = top_i[0]            # a crowd on a few experts
    jpos, jkeep = jmoe._dispatch_indices(jnp.asarray(top_i), E, C)
    tpos, tkeep = tmoe._dispatch_indices(torch.from_numpy(top_i).long(), E,
                                         C)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))


def test_dispatch_reproduces_the_zeroed_position_0_row():
    """8 tokens all routed to experts 0 and 1 at C = 2: the reference's
    scatter leaves each overflowing expert's row 0 zero, so token 0 (rank
    0 at both experts) gets no output and token 1 does; the port gives the
    same rows."""
    jcfg, tcfg = _cfgs(num_experts=4, experts_per_token=2)
    jp, tp = _params(jcfg)
    x = _x((8, jcfg.d_model), 3)
    top_i = np.tile(np.array([[0, 1]], np.int32), (8, 1))
    top_w = np.full((8, 2), 0.5, np.float32)
    want = np.asarray(jmoe._dispatch_one_group(
        jnp.asarray(x), jnp.asarray(top_w), jnp.asarray(top_i),
        jp["experts"], jcfg, 2))
    got = tmoe._dispatch_one_group(
        torch.from_numpy(x), torch.from_numpy(top_w),
        torch.from_numpy(top_i).long(), tp["experts"], tcfg, 2).numpy()
    assert np.all(want[0] == 0) and np.any(want[1] != 0)
    assert np.all(want[2:] == 0)
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("groups", [0, 4], ids=["ungrouped", "grouped"])
@pytest.mark.parametrize("skew", [0.0, 0.3], ids=["balanced", "skewed"])
def test_moe_forward_matches_reference(groups, skew):
    """The whole layer (router, dispatch, experts, shared experts, combine)
    at the published capacity factor 1.25; the skewed router makes experts
    0 and 1 overflow (asserted), so the zeroed rows are held too."""
    jcfg, tcfg = _cfgs(num_experts=8, experts_per_token=2, moe_groups=groups)
    jp, tp = _params(jcfg, seed=1, skew=skew)
    x = _x((4, 16, jcfg.d_model), 4)
    jy, jaux = jmoe.moe_forward(jp, jnp.asarray(x), jcfg)
    ty, taux = tmoe.moe_forward(tp, torch.from_numpy(x), tcfg)
    want = np.asarray(jy)
    np.testing.assert_allclose(ty.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(float(taux), float(jaux), rtol=0, atol=1e-6)
    if skew:
        _, top_i, _ = jmoe.route(jp["router"], jnp.asarray(x).reshape(
            -1, jcfg.d_model), jcfg)
        G = groups or 1
        counts = np.stack([np.bincount(g.ravel(), minlength=8) for g in
                           np.asarray(top_i).reshape(G, -1)])
        C = int(np.ceil(64 // G * 2 / 8 * 1.25))
        assert (counts > C).any()


# ---------------------------------------------------------------------------
# the reference's tests/test_moe.py cases, on the port, over fixed seeds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,T,E", [(1, 4, 2), (2, 17, 5), (6, 40, 8),
                                   (3, 25, 3), (4, 9, 8)])
def test_dispatch_positions_are_unique_per_expert(k, T, E):
    logits = torch.from_numpy(_x((T, E), T * 131 + E))
    top_i = torch.topk(logits, k, dim=-1).indices
    C = 4
    pos, keep = tmoe._dispatch_indices(top_i, E, C)
    seen = set()
    for t in range(T):
        for j in range(k):
            if keep[t, j]:
                assert pos[t, j] < C
                key = (int(top_i[t, j]), int(pos[t, j]))
                assert key not in seen
                seen.add(key)


@pytest.mark.parametrize("T", [2, 7, 30])
def test_router_weights_normalized(T):
    _, cfg = _cfgs()
    x = torch.from_numpy(_x((T, cfg.d_model), T))
    w = torch.from_numpy(_x((cfg.d_model, cfg.num_experts), 1))
    top_w, top_i, aux = tmoe.route(w, x, cfg)
    np.testing.assert_allclose(top_w.sum(-1).numpy(), 1.0, rtol=1e-5)
    assert 0.5 < float(aux) < float(cfg.num_experts)
    assert int(top_i.min()) >= 0 and int(top_i.max()) < cfg.num_experts
    for row in top_i.tolist():
        assert len(set(row)) == len(row)


def test_moe_forward_dropless_at_high_capacity_matches_dense_mixture():
    """At capacity_factor 8 nothing drops: the capacity formulation equals
    the naive compute-every-expert mixture."""
    jcfg, cfg = _cfgs(capacity_factor=8.0)
    _, params = _params(jcfg)
    x = torch.from_numpy(_x((2, 8, cfg.d_model), 1, 0.3))
    y, _ = tmoe.moe_forward(params, x, cfg)
    xt = x.reshape(-1, cfg.d_model)
    top_w, top_i, _ = tmoe.route(params["router"], xt, cfg)
    w = params["experts"]
    act = activation(cfg.act)
    h = act(torch.einsum("td,edf->tef", xt, w["w_gate"])) * \
        torch.einsum("td,edf->tef", xt, w["w_up"])
    per_e = torch.einsum("tef,efd->ted", h, w["w_down"])
    hot = (top_i[..., None] == torch.arange(cfg.num_experts)).float()
    mix = torch.einsum("tk,tke,ted->td", top_w, hot, per_e)
    if cfg.num_shared_experts:
        mix = mix + mlp_forward(params["shared"], xt[None], cfg)[0]
    np.testing.assert_allclose(y.reshape(-1, cfg.d_model).numpy(),
                               mix.numpy(), atol=1e-4, rtol=1e-3)


def test_capacity_drops_are_bounded():
    """At capacity_factor 1.0 an all-same-expert routing keeps exactly C
    assignments."""
    T, E, k, C = 64, 4, 2, 32
    pos, keep = tmoe._dispatch_indices(torch.zeros((T, k), dtype=torch.long),
                                       E, C)
    assert int(keep.sum()) == C
