"""One approach-1 round of the port held to the JAX reference, and the
port's session-level contracts.

The round starts from the same converted state (after two reference
rounds, so Adam moments are non-trivial) and receives the reference's own
draws — z1, z2 and the stochastic-rounding seed, replicated from the
body's key split (``approaches.py:200-203``) — and is compared with the
reference's JITTED body for codec ``none``, ``topk_int8`` deterministic,
and ``topk_int8`` stochastic with an error-feedback residual passed in.
Every D/G/server parameter, Adam moment, the EF residual and the metrics
agree within ATOL = 1e-5 (measured worst absolute deviation on a CPU:
1.2e-7 for ``none``, 1.9e-8 for ``topk_int8``, 2.4e-7 with SR + EF —
torch's CPU matmul sums in another order than XLA's, and the jitted
reference's codec divides by 127 through XLA's rewrite).

A top-k boundary can flip when two deltas differ by an ULP, so the
selection -> codec -> fold chain is also fed the reference's own (C, N)
delta and held BITWISE to the reference's eager chain.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import approaches as japp
from repro.core import federated as jfed
from repro.core.gan import MLPGanConfig as JaxMLPCfg
from repro.core.gan import make_mlp_pair as jax_make_mlp_pair
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import approaches as tapp
from repro_torch.core import federated as tfed
from repro_torch.core.gan import MLPGanConfig, make_mlp_pair
from repro_torch.core.session import FederationSession
from repro_torch.core.spec import (BackendSpec, CombineSpec, CompressionSpec,
                                   EngineSpec, FederationSpec,
                                   ParticipationSpec)
from repro_torch.data import digits_like_mixture, dirichlet_partition

SMALL = dict(data_dim=64, z_dim=16, g_hidden=32, d_hidden=32)
U, B = 3, 8
ATOL = 1e-5

CASES = {
    "none": dict(codec="none"),
    "topk_int8": dict(codec="topk_int8", error_feedback=False),
    "topk_int8_sr_ef": dict(codec="topk_int8", error_feedback=True,
                            codec_stochastic=True),
}


def _real(seed):
    return np.random.default_rng(seed).uniform(
        -1, 1, (U, B, SMALL["data_dim"])).astype(np.float32)


def _np_state(state):
    return {f: jax.tree.map(np.asarray, getattr(state, f))
            for f in ("g", "g_opt", "ds", "d_opts", "server_d", "step")}


def _reference_round(case):
    """Two warm-up reference rounds, then the compared one: returns the
    state before it, its draws, its inputs and its outputs."""
    jpair = jax_make_mlp_pair(JaxMLPCfg(**SMALL))
    fcfg = japp.DistGANConfig(num_users=U, upload_frac=0.1, **CASES[case])
    lossy = fcfg.codec != "none"
    ef = lossy and fcfg.error_feedback
    body = jax.jit(japp.make_approach1_body(jpair, fcfg))
    state = japp.init_state(jpair, fcfg, jax.random.key(0), sync_ds=True)
    n = japp.d_flat_layout(jpair).n
    residual = (jnp.asarray(np.random.default_rng(5).normal(
        scale=1e-4, size=(U, n)).astype(np.float32)) if ef else None)
    for r in range(2):
        out = body(state, jnp.asarray(_real(r)), residual=residual)
        state = out[0]
        if ef:
            residual = out[2]
    keys = jax.random.split(state.key, 5 if lossy else 4)
    draws = {"z1": np.array(jpair.sample_z(keys[1], B)),
             "z2": np.array(jpair.sample_z(keys[2], B)),
             "seed": (int(jax.random.randint(keys[4], (), 0,
                                             jnp.int32(2**31 - 1)))
                      if fcfg.codec_stochastic else None)}
    before = _np_state(state)
    res_before = None if residual is None else np.array(residual)
    real = _real(7)
    out = body(state, jnp.asarray(real), residual=residual)
    return (fcfg, before, res_before, draws, real, _np_state(out[0]),
            jax.tree.map(np.asarray, out[1]),
            None if not ef else np.asarray(out[2]))


def _port_fcfg(fcfg):
    return tapp.DistGANConfig(**{f.name: getattr(fcfg, f.name)
                                 for f in dataclasses.fields(fcfg)})


@pytest.mark.parametrize("case", list(CASES))
def test_one_round_matches_jitted_reference(case):
    fcfg, before, res, draws, real, want, jmetrics, jres = \
        _reference_round(case)
    pair = make_mlp_pair(MLPGanConfig(**SMALL))
    body = tapp.make_approach1_body(pair, _port_fcfg(fcfg))
    state = state_from_numpy(before, "cpu")
    out = body(state, torch.from_numpy(real),
               residual=None if res is None else torch.from_numpy(res),
               z1=torch.from_numpy(draws["z1"]),
               z2=torch.from_numpy(draws["z2"]), seed=draws["seed"])
    got = state_to_numpy(out[0])
    worst = []

    def close(g, w):
        worst.append(float(np.max(np.abs(np.asarray(g, np.float64)
                                          - np.asarray(w, np.float64)))))
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)

    jax.tree.map(close, got, want)
    for k in ("d_loss", "g_loss", "kept_frac"):
        close(out[1][k].numpy(), jmetrics[k])
    if jres is not None:
        close(out[2].numpy(), jres)
    assert max(worst) <= ATOL


@pytest.mark.parametrize("case", list(CASES))
def test_select_codec_fold_bitwise_on_reference_delta(case):
    """The reference's own (C, N) delta through the port's row-batched
    select -> codec -> fold equals the reference's eager chain bitwise."""
    fcfg, before, res, draws, real, _, _, _ = _reference_round(case)
    jpair = jax_make_mlp_pair(JaxMLPCfg(**SMALL))
    layout = japp.d_flat_layout(jpair)
    _, d_opt_def = japp._opts(fcfg)
    d_update = japp._d_update_fn(jpair, d_opt_def, fcfg)
    ds = jax.tree.map(jnp.asarray, before["ds"])
    opts = jax.tree.map(jnp.asarray, before["d_opts"])
    fake = jpair.g_apply(jax.tree.map(jnp.asarray, before["g"]),
                         jnp.asarray(draws["z1"]))
    new_ds, _, _ = jax.vmap(d_update, in_axes=(0, 0, 0, None))(
        ds, opts, jnp.asarray(real), fake)
    delta = layout.flatten_stacked(new_ds) - layout.flatten_stacked(ds)
    if res is not None:
        delta = delta + jnp.asarray(res)
    seed = None if draws["seed"] is None else jnp.int32(draws["seed"])
    rows = [jfed.select_delta_flat(delta[u], "topk", frac=0.1,
                                   use_kernel=True) for u in range(U)]
    jmasked = jnp.stack([r[0] for r in rows])
    jmasked = jfed.codec_transport(jmasked, fcfg.codec,
                                   stochastic=fcfg.codec_stochastic,
                                   seed=seed)
    want = np.asarray(jfed.combine_max_abs(jmasked))

    tdelta = torch.from_numpy(np.array(delta))
    masked, _ = tfed.select_delta_flat(tdelta, "topk", frac=0.1,
                                       use_kernel=True)
    masked = tfed.codec_transport(masked, fcfg.codec,
                                  stochastic=fcfg.codec_stochastic,
                                  seed=draws["seed"], use_kernel=True)
    np.testing.assert_array_equal(masked.numpy(), np.asarray(jmasked))
    np.testing.assert_array_equal(tfed.combine_max_abs(masked).numpy(), want)


# ---------------------------------------------------------------------------
# Session-level contracts inside the port
# ---------------------------------------------------------------------------

def _dataset():
    rng = np.random.default_rng(0)
    _, sample = digits_like_mixture(list(range(10)), size=8)
    data = sample(rng, 400).reshape(400, -1)
    return dirichlet_partition(data, rng.integers(0, 10, 400), U, 0.5)


def _session(engine="fused", rpj=4, codec="none", stochastic=False):
    spec = FederationSpec(
        "approach1", batch_size=B, eval_samples=16,
        engine=EngineSpec(kind=engine, rounds_per_jit=rpj),
        combine=CombineSpec(compression=CompressionSpec(
            codec=codec, error_feedback=False, stochastic=stochastic)))
    return FederationSession(make_mlp_pair(MLPGanConfig(**SMALL)),
                             tapp.DistGANConfig(num_users=U), _dataset(),
                             spec, device="cpu")


def _assert_same(a, b):
    jax.tree.map(np.testing.assert_array_equal, state_to_numpy(a.state),
                 state_to_numpy(b.state))


@pytest.mark.parametrize("codec,stochastic", [("none", False),
                                              ("topk_int8", True)])
def test_fused_equals_per_step_and_windowing_is_neutral(codec, stochastic):
    fused = _session(codec=codec, stochastic=stochastic).run(11)
    per_step = _session("per_step", codec=codec,
                        stochastic=stochastic).run(11)
    _assert_same(fused, per_step)
    np.testing.assert_array_equal(fused.g_losses, per_step.g_losses)
    np.testing.assert_array_equal(fused.d_losses, per_step.d_losses)
    sess = _session(codec=codec, stochastic=stochastic)
    first, second = sess.run(5), sess.run(6)
    _assert_same(second, fused)
    np.testing.assert_array_equal(
        np.concatenate([first.g_losses, second.g_losses]), fused.g_losses)
    np.testing.assert_array_equal(second.samples, fused.samples)
    assert np.all(np.isfinite(fused.g_losses))
    assert fused.extra["upload_bytes_per_round"] == U * tfed.upload_bytes_flat(
        tapp.d_flat_layout(make_mlp_pair(MLPGanConfig(**SMALL))).n, "topk",
        0.1, codec=codec)


@pytest.mark.parametrize("section", [
    {"backend": {"kind": "multihost", "async_rounds": 1}},
    {"backend": {"kind": "multihost", "workers": 2}},
    {"participation": {"scheduler": "uniform", "cohort_size": 2},
     "backend": {"kind": "multihost"}},
    {"serve": {"max_batch": 8}},
    {"decode": {"slots": 4}},
])
def test_unported_parts_of_a_spec_raise(section):
    """The sections once refused as not yet ported are read as the
    reference reads them: a multihost backend section (its ValueError where
    the reference raises one, the same manifest where it does not) and,
    since the serve slice, the serve and decode sections (the same
    manifest); the cohort schedulers and the spmd backend are ported."""
    from repro.core.spec import FederationSpec as JaxSpec
    manifest = {"approach": "approach1", **section}
    try:
        want = JaxSpec.from_dict(manifest).to_json()
    except ValueError as e:
        with pytest.raises(ValueError, match="workers"):
            FederationSpec.from_dict(manifest)
        assert "workers" in str(e)
    else:
        assert FederationSpec.from_dict(manifest).to_json() == want
    with pytest.raises(ValueError, match="workers"):
        BackendSpec("multihost")
    assert BackendSpec("spmd", async_rounds=1).kind == "spmd"
    assert ParticipationSpec("round_robin", cohort_size=2).scheduler == \
        "round_robin"


def test_manifest_round_trips_and_reads_reference_manifests():
    from repro.core.spec import FederationSpec as JaxSpec
    from repro.core.spec import CombineSpec as JaxCombine
    from repro.core.spec import CompressionSpec as JaxComp
    jspec = JaxSpec("approach1", batch_size=B, combine=JaxCombine(
        compression=JaxComp(codec="topk_int8", error_feedback=False)))
    tspec = FederationSpec.from_json(jspec.to_json())
    assert tspec.to_json() == jspec.to_json()
    assert FederationSpec.from_dict(tspec.to_dict()) == tspec


def test_run_distgan_shim_equals_the_explicit_spec_and_loss_trend():
    from repro.core.protocol import loss_trend as jax_loss_trend
    from repro_torch.core.protocol import loss_trend, run_distgan
    shim = run_distgan(make_mlp_pair(MLPGanConfig(**SMALL)),
                       tapp.DistGANConfig(num_users=U), _dataset(),
                       "approach1", steps=8, batch_size=B, eval_samples=16,
                       rounds_per_jit=4, device="cpu")
    _assert_same(shim, _session(rpj=4).run(8))
    assert loss_trend(shim.g_losses) == jax_loss_trend(shim.g_losses)
