"""Cohort-virtualized federation in the port held to the JAX reference, and
approaches 2, 3 and the baseline.

* The schedulers, ``participation_weights`` and ``packed_payload_nbytes``
  are numpy and are held BITWISE to the reference.
* One K = 4 round chunk of approach 1 (U = 6, C = 3, ``topk_int8`` with
  stochastic rounding and error feedback, ``staleness_max_abs``) starts
  from the reference's own cohort carry (after a warm-up chunk, so ages,
  residuals and Adam moments are non-trivial) and receives the
  reference's z draws and codec seeds, replicated from the body's key
  splits (``approaches.py:200-203``).  Store rows, residuals, the server
  D and G agree with the reference's JITTED ``make_cohort_engine`` within
  ATOL = 1e-5 (the tolerance of ``tests/test_torch_round.py``: torch's
  CPU matmul sums in another order than XLA's); ``last_round``, the
  per-round kept fraction of the top-k masks and the ages are bitwise.
* One round each of approaches 2, 3 and the baseline agrees with the
  reference's jitted body within ATOL.
* Inside the port: C == U under the ``full`` scheduler equals the plain
  fused engine bitwise, the fused-store engine equals the plain cohort
  engine bitwise, and windowing is neutral.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import approaches as japp
from repro.core import engine as jeng
from repro.core import federated as jfed
from repro.core.gan import MLPGanConfig as JaxMLPCfg
from repro.core.gan import make_mlp_pair as jax_make_mlp_pair
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import approaches as tapp
from repro_torch.core import engine as teng
from repro_torch.core import federated as tfed
from repro_torch.core.gan import MLPGanConfig, make_mlp_pair
from repro_torch.core.protocol import run_distgan
from repro_torch.core.session import FederationSession
from repro_torch.core.spec import (CombineSpec, CompressionSpec, EngineSpec,
                                   FederationSpec, ParticipationSpec)
from repro_torch.data import digits_like_mixture, dirichlet_partition

SMALL = dict(data_dim=64, z_dim=16, g_hidden=32, d_hidden=32)
B = 8
ATOL = 1e-5


def _port_fcfg(fcfg):
    return tapp.DistGANConfig(**{f.name: getattr(fcfg, f.name)
                                 for f in dataclasses.fields(fcfg)})


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               rtol=0)


# ---------------------------------------------------------------------------
# Schedulers, weights and payload accounting: numpy, bitwise
# ---------------------------------------------------------------------------

SHARDS = [5, 40, 12, 7, 30, 1, 22, 9]


@pytest.mark.parametrize("sched", ["full", "uniform", "round_robin",
                                   "weighted"])
def test_schedules_match_reference_and_windows_concatenate(sched):
    U = len(SHARDS)
    C = U if sched == "full" else 3
    want = jfed.make_schedule(sched, U, C, 11, np.random.default_rng(4),
                              SHARDS)
    got = tfed.make_schedule(sched, U, C, 11, np.random.default_rng(4),
                             SHARDS)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    window = tfed.make_schedule_source(sched, U, C, SHARDS)
    rng = np.random.default_rng(4)
    parts = [window(rng, 0, 5), window(rng, 5, 6)]
    np.testing.assert_array_equal(np.concatenate(parts), want)
    assert all(len(set(row)) == C for row in got)


def test_participation_weights_match_reference_windowed():
    U, C = 8, 3
    sched = jfed.make_schedule("uniform", U, C, 12, np.random.default_rng(1))
    want = jfed.participation_weights(sched, U)
    np.testing.assert_array_equal(tfed.participation_weights(sched, U), want)
    counts = np.zeros(U, np.float64)
    parts = [tfed.participation_weights(sched[:5], U, counts=counts),
             tfed.participation_weights(sched[5:], U, counts=counts,
                                        start_round=5)]
    np.testing.assert_array_equal(np.concatenate(parts), want)
    np.testing.assert_array_equal(counts, np.bincount(sched.ravel(),
                                                      minlength=U))


@pytest.mark.parametrize("policy", ["none", "topk", "shared_random"])
@pytest.mark.parametrize("codec", ["none", "bf16", "int8", "topk_int8"])
def test_packed_payload_nbytes_matches_reference(policy, codec):
    row = np.random.default_rng(2).normal(size=1000).astype(np.float32)
    if policy != "none":
        row[np.argsort(np.abs(row))[:-100]] = 0.0
    want = jfed.packed_payload_nbytes(row, policy, codec)
    assert tfed.packed_payload_nbytes(row, policy, codec) == want
    if policy == "topk":
        assert want == tfed.upload_bytes_flat(1000, "topk", 0.1, codec=codec)


# ---------------------------------------------------------------------------
# The store
# ---------------------------------------------------------------------------

def test_store_layouts_gather_scatter_and_last_round():
    jpair = jax_make_mlp_pair(JaxMLPCfg(**SMALL))
    jfcfg = japp.DistGANConfig(num_users=5, codec="int8")
    pair = make_mlp_pair(MLPGanConfig(**SMALL))
    fcfg = _port_fcfg(jfcfg)
    jo = japp.d_opt_flat_layout(jpair, jfcfg)
    to = tapp.d_opt_flat_layout(pair, fcfg)
    assert (to.shapes, to.sizes, to.n) == (jo.shapes, jo.sizes, jo.n)
    assert to.paths[-1] == ("step",) and to.dtypes[-1] == torch.int32

    jst = jeng.init_cohort_state(jpair, jfcfg, jax.random.key(0))
    full = jeng.cohort_state_to_full(jpair, jfcfg, jst)
    st = state_from_numpy(_np(full._replace(key=None)._asdict()), "cpu")
    store = tfed.make_cohort_store(st.ds, st.d_opts, tapp.d_flat_layout(pair),
                                   to, error_feedback=True)
    np.testing.assert_array_equal(store.d_flat.numpy(), jst.store.d_flat)
    np.testing.assert_array_equal(store.opt_flat.numpy(), jst.store.opt_flat)

    idx = torch.tensor([3, 0, 4])
    dl = tapp.d_flat_layout(pair)
    ds, opts = tfed.cohort_gather(store, idx, dl, to)
    assert opts["step"].dtype == torch.int32
    ds["l1"]["w"] += 1.0
    opts["step"] += 7
    res = torch.full((3, dl.n), 0.5)
    tfed.cohort_scatter(store, idx, ds, opts, torch.tensor(9), dl, to,
                        residual=res)
    jds, jopts = jfed.cohort_gather(jst.store, jnp.asarray([3, 0, 4]),
                                    japp.d_flat_layout(jpair), jo)
    jds = jax.tree.map(np.array, jds)
    jds["l1"]["w"] += 1.0
    jopts = dict(jopts, step=jopts["step"] + 7)
    jstore = jfed.cohort_scatter(
        jst.store, jnp.asarray([3, 0, 4]), jds, jopts, 9,
        japp.d_flat_layout(jpair), jo, residual=jnp.full((3, dl.n), 0.5))
    for name in ("d_flat", "opt_flat", "last_round", "residual"):
        np.testing.assert_array_equal(getattr(store, name).numpy(),
                                      np.asarray(getattr(jstore, name)))
    assert store.last_round.tolist() == [9, 0, 0, 9, 9]
    back, _ = tfed.cohort_gather(store, idx, dl, to)
    torch.testing.assert_close(back["l1"]["w"], ds["l1"]["w"], rtol=0,
                               atol=0)


# ---------------------------------------------------------------------------
# One cohort chunk against the reference's jitted make_cohort_engine
# ---------------------------------------------------------------------------

def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_cohort_state(jst, pair) -> teng.CohortState:
    full = state_from_numpy({"g": _np(jst.g), "g_opt": _np(jst.g_opt),
                             "ds": {}, "d_opts": {},
                             "server_d": _np(jst.server_d),
                             "step": np.asarray(jst.step)}, "cpu")
    s = jst.store
    store = tfed.CohortStore(
        torch.from_numpy(np.array(s.d_flat)),
        torch.from_numpy(np.array(s.opt_flat)),
        torch.from_numpy(np.array(s.last_round)),
        None if s.residual is None else torch.from_numpy(
            np.array(s.residual)))
    return teng.CohortState(full.g, full.g_opt, store, full.server_d,
                            full.step, full.generator)


def _draws(jpair, key, K, lossy_stochastic):
    """The z pairs and codec seeds the reference's approach-1 body draws
    over K rounds from carry key ``key``."""
    out = []
    for _ in range(K):
        keys = jax.random.split(key, 5)
        out.append({"z1": torch.from_numpy(np.array(jpair.sample_z(keys[1],
                                                                   B))),
                    "z2": torch.from_numpy(np.array(jpair.sample_z(keys[2],
                                                                   B))),
                    "seed": (int(jax.random.randint(keys[4], (), 0,
                                                    jnp.int32(2**31 - 1)))
                             if lossy_stochastic else None)})
        key = keys[0]
    return out


def test_cohort_chunk_matches_jitted_reference_engine():
    U, C, K = 6, 3, 4
    jpair = jax_make_mlp_pair(JaxMLPCfg(**SMALL))
    jfcfg = japp.DistGANConfig(num_users=U, upload_frac=0.1,
                               combiner="staleness_max_abs",
                               codec="topk_int8", error_feedback=True,
                               codec_stochastic=True)
    jchunk = jeng.make_cohort_engine(jpair, jfcfg, "approach1")
    jst = jeng.init_cohort_state(jpair, jfcfg, jax.random.key(0),
                                 sync_ds=True)
    rng = np.random.default_rng(3)
    sched = jfed.make_schedule("uniform", U, C, 2 * K, rng)
    reals = rng.uniform(-1, 1, (2 * K, C, B, SMALL["data_dim"])
                        ).astype(np.float32)
    jst, _ = jchunk(jst, jnp.asarray(reals[:K]), jnp.asarray(sched[:K]))
    before = jst
    noise = _draws(jpair, before.key, K, True)
    want, wm = jchunk(before, jnp.asarray(reals[K:]),
                      jnp.asarray(sched[K:]))

    pair = make_mlp_pair(MLPGanConfig(**SMALL))
    chunk = teng.make_cohort_engine(pair, _port_fcfg(jfcfg), "approach1")
    cst = _port_cohort_state(before, pair)
    got, m = chunk(cst, torch.from_numpy(reals[K:]),
                   torch.from_numpy(sched[K:].astype(np.int64)), noise=noise)
    for name in ("d_flat", "opt_flat", "residual"):
        _close(getattr(got.store, name).numpy(), getattr(want.store, name))
    np.testing.assert_array_equal(got.store.last_round.numpy(),
                                  want.store.last_round)
    for a, b in zip(jax.tree.leaves(_np(want.server_d)),
                    jax.tree.leaves(state_to_numpy(
                        teng.cohort_state_to_full(
                            pair, _port_fcfg(jfcfg), got))["server_d"])):
        _close(b, a)
    for a, b in zip(jax.tree.leaves(_np(want.g)),
                    jax.tree.leaves(jax.tree.map(
                        lambda t: t.numpy(), got.g))):
        _close(b, a)
    assert int(got.step) == int(want.step)
    for key in ("kept_frac", "mean_age"):
        np.testing.assert_array_equal(m[key].numpy(), np.asarray(wm[key]))
    _close(m["d_loss"].numpy(), wm["d_loss"])
    _close(m["g_loss"].numpy(), wm["g_loss"])
    # the plain cohort engine leaves the carry it was given as it was
    np.testing.assert_array_equal(cst.store.d_flat.numpy(),
                                  before.store.d_flat)


# ---------------------------------------------------------------------------
# Approaches 2, 3 and the baseline: one round against the reference
# ---------------------------------------------------------------------------

def _draws23(jpair, approach, key, C):
    if approach == "approach3":
        z1, z2 = [], []
        for _ in range(C):
            key, kz1, kz2 = jax.random.split(key, 3)
            z1.append(np.array(jpair.sample_z(kz1, B)))
            z2.append(np.array(jpair.sample_z(kz2, B)))
        return {"z1": torch.from_numpy(np.stack(z1)),
                "z2": torch.from_numpy(np.stack(z2))}
    _, kz1, kz2 = jax.random.split(key, 3)
    return {"z1": torch.from_numpy(np.array(jpair.sample_z(kz1, B))),
            "z2": torch.from_numpy(np.array(jpair.sample_z(kz2, B)))}


@pytest.mark.parametrize("approach", ["approach2", "approach3", "baseline"])
def test_one_round_matches_jitted_reference(approach):
    U = 3
    jpair = jax_make_mlp_pair(JaxMLPCfg(**SMALL))
    jfcfg = japp.DistGANConfig(num_users=U)
    body = jax.jit(japp.BODY_FACTORIES[approach](jpair, jfcfg))
    state = japp.init_state(jpair, jfcfg, jax.random.key(0))
    rng = np.random.default_rng(9)
    shape = ((B, SMALL["data_dim"]) if approach == "baseline"
             else (U, B, SMALL["data_dim"]))
    for _ in range(2):
        state, _ = body(state, jnp.asarray(rng.uniform(-1, 1, shape),
                                           jnp.float32))
    before = {f: _np(getattr(state, f)) for f in
              ("g", "g_opt", "ds", "d_opts", "server_d", "step")}
    noise = _draws23(jpair, approach, state.key, U)
    real = rng.uniform(-1, 1, shape).astype(np.float32)
    want, wm = body(state, jnp.asarray(real))

    pair = make_mlp_pair(MLPGanConfig(**SMALL))
    tbody = tapp.make_approach2_body if approach == "approach2" else (
        tapp.make_approach3_body if approach == "approach3"
        else tapp.make_baseline_body)
    st, m = tbody(pair, _port_fcfg(jfcfg))(
        state_from_numpy(before, "cpu"), torch.from_numpy(real), **noise)
    got = state_to_numpy(st)
    jax.tree.map(_close, got, {f: _np(getattr(want, f)) for f in got})
    for key in ("d_loss", "g_loss", "kept_frac"):
        assert m[key].shape == np.shape(wm[key])
        _close(m[key].numpy(), wm[key])


# ---------------------------------------------------------------------------
# Session-level contracts inside the port
# ---------------------------------------------------------------------------

def _dataset(U):
    rng = np.random.default_rng(0)
    _, sample = digits_like_mixture(list(range(10)), size=8)
    data = sample(rng, 400).reshape(400, -1)
    return dirichlet_partition(data, rng.integers(0, 10, 400), U, 0.5)


def _session(approach, U, sched="full", C=None, codec="none", fuse=False,
             adaptive=False, combiner="max_abs"):
    spec = FederationSpec(
        approach, batch_size=B, eval_samples=16,
        engine=EngineSpec(rounds_per_jit=4, fuse_store_rounds=fuse),
        participation=ParticipationSpec(sched, cohort_size=C),
        combine=CombineSpec(combiner=combiner, adaptive_server_scale=adaptive,
                            compression=CompressionSpec(
                                codec=codec, stochastic=codec != "none")))
    return FederationSession(make_mlp_pair(MLPGanConfig(**SMALL)),
                             tapp.DistGANConfig(num_users=U), _dataset(U),
                             spec, device="cpu")


def _assert_same(a, b):
    jax.tree.map(np.testing.assert_array_equal, state_to_numpy(a.state),
                 state_to_numpy(b.state))
    np.testing.assert_array_equal(a.g_losses, b.g_losses)
    np.testing.assert_array_equal(a.d_losses, b.d_losses)


@pytest.mark.parametrize("approach", ["approach1", "approach2",
                                      "approach3"])
def test_full_cohort_equals_plain_fused_engine_bitwise(approach):
    U = 3
    plain = _session(approach, U).run(6)
    cohort = _session(approach, U, C=U)
    res = cohort.run(6)
    assert cohort._driver.mode == "cohort"
    _assert_same(res, plain)
    # every member trained last round: ages are the rounds since start
    # only before its first round
    np.testing.assert_array_equal(res.extra["mean_age"], np.zeros(6))
    np.testing.assert_array_equal(res.extra["participation_counts"],
                                  [6] * U)


def test_fused_store_equals_cohort_engine_and_windowing_is_neutral():
    kw = dict(sched="uniform", C=3, codec="topk_int8", adaptive=True,
              combiner="staleness_max_abs")
    whole = _session("approach1", 6, fuse=True, **kw).run(11)
    plain = _session("approach1", 6, fuse=False, **kw).run(11)
    _assert_same(whole, plain)
    assert whole.extra["fused_store"] and not plain.extra["fused_store"]
    sess = _session("approach1", 6, fuse=True, **kw)
    first, second = sess.run(5), sess.run(6)
    jax.tree.map(np.testing.assert_array_equal, state_to_numpy(second.state),
                 state_to_numpy(whole.state))
    for key in ("g_losses", "d_losses"):
        np.testing.assert_array_equal(
            np.concatenate([getattr(first, key), getattr(second, key)]),
            getattr(whole, key))
    np.testing.assert_array_equal(
        np.concatenate([first.extra["schedule"], second.extra["schedule"]]),
        whole.extra["schedule"])
    np.testing.assert_array_equal(
        np.concatenate([first.extra["participation_weights"],
                        second.extra["participation_weights"]]),
        whole.extra["participation_weights"])
    # last_round, from the schedule on the host
    last = np.zeros(6, np.int64)
    for r, row in enumerate(whole.extra["schedule"]):
        last[row] = r + 1
    np.testing.assert_array_equal(11 - whole.extra["staleness"], last)
    assert whole.extra["participation_counts"].sum() == 11 * 3
    assert whole.extra["upload_bytes_per_round"] == 3 * \
        whole.extra["upload_bytes_per_user"]
    flat = sess.user_d_flat(2)
    np.testing.assert_array_equal(
        flat, tapp.d_flat_layout(sess.pair).flatten(
            jax.tree.map(lambda x: x[2], second.state.ds)).numpy())
    assert sess.generator_params() is sess._driver.state.g


def test_run_distgan_cohort_kwargs_and_refusals():
    pair = make_mlp_pair(MLPGanConfig(**SMALL))
    kw = dict(steps=8, batch_size=B, eval_samples=0, rounds_per_jit=4,
              device="cpu")
    shim = run_distgan(pair, tapp.DistGANConfig(num_users=6), _dataset(6),
                       "approach1", participation="round_robin",
                       cohort_size=2, codec="topk_int8",
                       codec_stochastic=True, **kw)
    _assert_same(shim, _session("approach1", 6, "round_robin", 2,
                                "topk_int8").run(8))
    np.testing.assert_array_equal(shim.extra["schedule"][:3],
                                  [[0, 1], [2, 3], [4, 5]])
    with pytest.raises(ValueError, match="workers"):   # as the reference
        run_distgan(pair, tapp.DistGANConfig(num_users=6), _dataset(6),
                    "approach1", state_backend="multihost", **kw)
    with pytest.raises(ValueError, match="mesh"):
        run_distgan(pair, tapp.DistGANConfig(num_users=6), _dataset(6),
                    "approach1", state_backend="spmd", **kw)
    with pytest.raises(ValueError, match="no user axis"):
        FederationSpec("baseline", participation=ParticipationSpec(
            "uniform", cohort_size=2))
    with pytest.raises(ValueError, match="cohort"):
        FederationSpec("approach1", combine=CombineSpec(
            compression=CompressionSpec(codec="int8")))
    with pytest.raises(ValueError, match="adaptive"):
        FederationSpec("approach2", combine=CombineSpec(
            adaptive_server_scale=True),
            participation=ParticipationSpec("uniform", cohort_size=2))
    with pytest.raises(ValueError, match="fused"):
        FederationSpec("approach1", engine=EngineSpec(kind="per_step"),
                       participation=ParticipationSpec("uniform",
                                                       cohort_size=2))
    with pytest.raises(ValueError, match="full"):
        FederationSpec("approach1", participation=ParticipationSpec(
            cohort_size=2)).validate_against(6)
    # the W-GAN objective is ported: a W-GAN cohort run goes through the
    # shim, every trained critic within its clip
    wgan = run_distgan(pair, tapp.DistGANConfig(num_users=6, loss_type="wgan",
                                                wgan_clip=0.05),
                       _dataset(6), "approach2", participation="uniform",
                       cohort_size=2, **kw)
    assert np.all(np.isfinite(wgan.g_losses))
    trained = torch.from_numpy(wgan.extra["participation_counts"] > 0)
    assert trained.any()
    assert float(wgan.state.ds["l1"]["w"][trained].abs().max()) <= \
        np.float32(0.05)


def test_cohort_manifest_reads_the_reference_manifest():
    from repro.core.spec import CombineSpec as JaxCombine
    from repro.core.spec import CompressionSpec as JaxComp
    from repro.core.spec import EngineSpec as JaxEngine
    from repro.core.spec import FederationSpec as JaxSpec
    from repro.core.spec import ParticipationSpec as JaxPart
    jspec = JaxSpec("approach1", engine=JaxEngine(fuse_store_rounds=True),
                    participation=JaxPart("weighted", cohort_size=8),
                    combine=JaxCombine("staleness_max_abs",
                                       adaptive_server_scale=True,
                                       compression=JaxComp("topk_int8")))
    tspec = FederationSpec.from_json(jspec.to_json())
    assert tspec.to_json() == jspec.to_json() and tspec.cohort_virtual
