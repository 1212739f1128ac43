"""The host streaming backend of the port held to the JAX reference:
the residency backends, the host-store init, the per-round streaming
driver (data prefetch, bounded staleness, int8 row staging) and the
``host`` backend of the session, with its checkpoints.

* Against the reference, on the same inputs: the backends' gather /
  scatter / snapshot bitwise on the reference's own store; the streaming
  driver over the rows engine from the reference's initial host store and
  shared state, fed the reference's z draws and codec seeds (replicated
  from the bodies' key splits), in sync, async and ``stage_rows`` modes:
  ``last_round`` bitwise, the top-k kept fractions to 1e-6 (one entry is
  2e-4), the losses, the ages' mean, the store rows and the shared state
  within ATOL = 1e-5 of the reference's JITTED engine (torch's CPU matmul
  sums in another order than XLA's; the tolerance of
  ``tests/test_torch_cohort.py``); the checkpoint layout leaf for leaf,
  and a checkpoint the reference wrote restores.
* Inside the port: the host stream equals the device cohort engine
  BITWISE (the same gather -> body -> scatter operations on the same
  rows), which is stronger than the reference's 1e-6 pin; prefetch is
  neutral, disjoint async cohorts equal sync, overlapping ones age by
  the pipeline lag.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import approaches as japp
from repro.core import engine as jeng
from repro.core import federated as jfed
from repro.core import session as jsess
from repro.core.gan import MLPGanConfig as JaxMLPCfg
from repro.core.gan import make_mlp_pair as jax_make_mlp_pair
from repro_torch.convert import shared_from_numpy
from repro_torch.core import approaches as tapp
from repro_torch.core import engine as teng
from repro_torch.core import federated as tfed
from repro_torch.core import session as tsess
from repro_torch.core.gan import MLPGanConfig, make_mlp_pair
from repro_torch.core.protocol import run_distgan
from repro_torch.core.session import FederationSession
from repro_torch.core.spec import (BackendSpec, CombineSpec, CompressionSpec,
                                   EngineSpec, FederationSpec,
                                   ParticipationSpec)
from repro_torch.data import (FederatedDataset, digits_like_mixture,
                              dirichlet_partition)
from repro_torch.models.common import tree_leaves

SMALL = dict(data_dim=16, z_dim=8, g_hidden=16, d_hidden=16)
B = 8
ATOL = 1e-5
PAIR = make_mlp_pair(MLPGanConfig(**SMALL))
JPAIR = jax_make_mlp_pair(JaxMLPCfg(**SMALL))


def _port_fcfg(fcfg):
    return tapp.DistGANConfig(**{f.name: getattr(fcfg, f.name)
                                 for f in dataclasses.fields(fcfg)})


def _ds(U):
    rng = np.random.default_rng(0)
    _, sample = digits_like_mixture(list(range(10)), size=4)
    data = sample(rng, 300).reshape(300, -1)
    return dirichlet_partition(data, rng.integers(0, 10, 300), U, 0.5)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               rtol=0)


def _run(approach, U, **kw):
    kw = dict(dict(steps=8, batch_size=B, seed=0, eval_samples=0,
                   device="cpu"), **kw)
    fcfg = tapp.DistGANConfig(num_users=U, upload_frac=0.3,
                              combiner=kw.pop("combiner", "max_abs"))
    return run_distgan(PAIR, fcfg, _ds(U), approach, **kw)


def _same_run(a, b):
    np.testing.assert_array_equal(a.g_losses, b.g_losses)
    np.testing.assert_array_equal(a.d_losses, b.d_losses)
    for key in ("schedule", "staleness", "mean_age"):
        np.testing.assert_array_equal(a.extra[key], b.extra[key])


# ---------------------------------------------------------------------------
# the residency backends
# ---------------------------------------------------------------------------

def _ref_store(U=5, ef=True):
    jfcfg = japp.DistGANConfig(num_users=U, codec="int8", error_feedback=ef)
    st = jeng.init_cohort_state(JPAIR, jfcfg, jax.random.key(0))
    return st.store


@pytest.mark.parametrize("kind", ["device", "host"])
def test_backend_gather_scatter_roundtrip(kind):
    """Both backends keep the reference's contract on its own store,
    bitwise: gather returns the cohort rows, scatter writes them back and
    stamps ``last_round``, the residual rides along, and the snapshot is
    the reference's store after the same operations."""
    js = _ref_store()
    jbe = jfed.HostStateBackend.from_store(js)
    store = tfed.CohortStore(*(torch.from_numpy(np.array(t)) for t in (
        js.d_flat, js.opt_flat, js.last_round, js.residual)))
    be = (tfed.DeviceStateBackend(store) if kind == "device"
          else tfed.HostStateBackend.from_store(store))
    assert be.num_users == 5 and be.has_residual
    assert be.device_resident == (kind == "device")
    idx = np.asarray([3, 0, 4], np.int32)
    d, o, last = be.gather_rows(idx)
    jd, jo, jlast = jbe.gather_rows(idx)
    for got, want in ((d, jd), (o, jo), (last, jlast),
                      (be.gather_residual(idx), jbe.gather_residual(idx))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    res = np.full((3, d.shape[1]), 0.25, np.float32)
    be.scatter_rows(idx, d + 1.0, o, 7, residual=torch.from_numpy(res))
    jbe.scatter_rows(idx, np.asarray(jd) + 1.0, jo, 7, residual=res)
    snap, jsnap = be.snapshot(), jbe.snapshot()
    for name in ("d_flat", "opt_flat", "last_round", "residual"):
        np.testing.assert_array_equal(getattr(snap, name).numpy(),
                                      np.asarray(getattr(jsnap, name)))
    assert snap.last_round.tolist() == [7, 0, 0, 7, 7]


def test_host_backend_gather_returns_copies_and_snapshot_does_not_alias():
    """Gathered rows are copies (a scatter while a gathered buffer is in
    flight must not change it), the store owns its memory (not the
    caller's array) and a snapshot is a copy (the reference fixed a real
    aliasing bug there: a view would follow later scatters)."""
    d0 = np.arange(12, dtype=np.float32).reshape(4, 3)
    be = tfed.HostStateBackend(d0, np.zeros((4, 2), np.float32),
                               np.zeros(4, np.int32))
    d, _, _ = be.gather_rows([1, 2])
    before = d.clone()
    snap = be.snapshot()
    be.scatter_rows([1, 2], d + 99.0, torch.zeros(2, 2), 3)
    torch.testing.assert_close(d, before, rtol=0, atol=0)
    np.testing.assert_array_equal(d0, np.arange(12).reshape(4, 3))
    np.testing.assert_array_equal(snap.d_flat.numpy(), d0)
    assert be.last_round.tolist() == [0, 3, 3, 0]
    out = (torch.empty(2, 3), torch.empty(2, 2))
    got = be.gather_rows([2, 0], out=out)
    assert got[0] is out[0] and got[0][0, 0] == 105.0


@pytest.mark.parametrize("sync_ds", [True, False])
def test_init_host_backend_matches_device_init(sync_ds):
    """The host store holds ``init_cohort_state``'s values bitwise, drawn
    row by row on the host from the same generator, which ends at the same
    position (the next draw agrees)."""
    fcfg = tapp.DistGANConfig(num_users=7, codec="int8")
    cs = teng.init_cohort_state(PAIR, fcfg, 3, "cpu", sync_ds=sync_ds)
    sh, be = teng.init_host_backend(PAIR, fcfg, 3, "cpu", sync_ds=sync_ds)
    for name in ("d_flat", "opt_flat", "last_round", "residual"):
        np.testing.assert_array_equal(getattr(be, name).numpy(),
                                      getattr(cs.store, name).numpy())
    for a, b in zip(tree_leaves(cs.g) + tree_leaves(cs.g_opt)
                    + tree_leaves(cs.server_d),
                    tree_leaves(sh.g) + tree_leaves(sh.g_opt)
                    + tree_leaves(sh.server_d)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert torch.equal(torch.rand(4, generator=cs.generator),
                       torch.rand(4, generator=sh.generator))
    assert not be.pinned


# ---------------------------------------------------------------------------
# the streaming driver against the reference's, with the reference's draws
# ---------------------------------------------------------------------------

def _draws(approach, key, steps, C, lossy, stochastic):
    """The z draws and codec seeds the reference's bodies take from carry
    key ``key`` over ``steps`` rounds (``approaches.py:200-203, 340,
    388``), as the port's bodies take them."""
    out = []
    for _ in range(steps):
        if approach == "approach3":
            z1, z2 = [], []
            for _ in range(C):
                key, k1, k2 = jax.random.split(key, 3)
                z1.append(np.array(JPAIR.sample_z(k1, B)))
                z2.append(np.array(JPAIR.sample_z(k2, B)))
            out.append({"z1": torch.from_numpy(np.stack(z1)),
                        "z2": torch.from_numpy(np.stack(z2))})
            continue
        n = 3 if approach == "approach2" else (5 if lossy else 4)
        keys = jax.random.split(key, n)
        d = {"z1": torch.from_numpy(np.array(JPAIR.sample_z(keys[1], B))),
             "z2": torch.from_numpy(np.array(JPAIR.sample_z(keys[2], B)))}
        if approach == "approach1":
            d["seed"] = (int(jax.random.randint(
                keys[4], (), 0, jnp.int32(2**31 - 1))) if stochastic
                else None)
        out.append(d)
        key = keys[0]
    return out


def _injecting(eng, draws):
    it = iter(draws)
    return lambda *args: eng(*args, noise=next(it))


def _shared_np(sh):
    return {"g": jax.tree.map(np.asarray, sh.g),
            "g_opt": jax.tree.map(np.asarray, sh.g_opt),
            "server_d": jax.tree.map(np.asarray, sh.server_d),
            "step": np.asarray(sh.step)}


# (approach, lossy codec with SR, EF and the staleness fold, driver knobs)
_STREAM_CASES = {
    "approach1-sync": ("approach1", False, {}),
    "approach1-no-prefetch": ("approach1", False, dict(prefetch=False)),
    "approach1-int8-sr-ef": ("approach1", True, {}),
    "approach1-int8-async": ("approach1", True, dict(async_rounds=1)),
    "approach1-int8-stage-rows": ("approach1", True,
                                  dict(stage_codec="int8")),
    "approach2": ("approach2", False, {}),
    "approach3": ("approach3", False, {}),
}


@functools.lru_cache(maxsize=None)
def _ref_rows_engine(approach, lossy):
    """The reference's jitted rows engine, one per configuration (its
    compile dominates these tests)."""
    jfcfg = japp.DistGANConfig(
        num_users=6, upload_frac=0.3,
        codec="topk_int8" if lossy else "none",
        combiner="staleness_max_abs" if lossy else "max_abs",
        codec_stochastic=lossy)
    return jfcfg, jeng.make_cohort_rows_engine(JPAIR, jfcfg, approach)


@pytest.mark.parametrize("case", sorted(_STREAM_CASES))
def test_stream_matches_reference_stream(case):
    """Six rounds of the port's ``stream_cohort_rounds`` over its rows
    engine against the reference's over its jitted rows engine, from the
    reference's initial host store and shared state, with its draws; U =
    6, a uniform cohort of 3; the lossy cases with ``topk_int8``,
    stochastic rounding, error feedback and the staleness-aware fold."""
    approach, lossy, kw = _STREAM_CASES[case]
    U, C, steps = 6, 3, 6
    jfcfg, jeng_rows = _ref_rows_engine(approach, lossy)
    sync = approach == "approach1"
    jsh, jbe = jeng.init_host_backend(JPAIR, jfcfg, jax.random.key(0),
                                      sync_ds=sync)
    store = (jbe.d_flat.copy(), jbe.opt_flat.copy(), jbe.last_round.copy(),
             None if jbe.residual is None else jbe.residual.copy())
    draws = _draws(approach, jsh.key, steps, C, lossy, lossy)
    shared = shared_from_numpy(_shared_np(jsh), "cpu")
    rng = np.random.default_rng(4)
    sched = jfed.make_schedule("uniform", U, C, steps, rng)
    reals = rng.uniform(-1, 1, (steps, C, B, SMALL["data_dim"])
                        ).astype(np.float32)
    jsh, jm, _ = jsess.stream_cohort_rounds(
        jeng_rows, jsh, jbe, sched, lambda r: reals[r], **kw)

    be = tfed.HostStateBackend(*store)
    eng = teng.make_cohort_rows_engine(PAIR, _port_fcfg(jfcfg), approach)
    shared, m, stats = tsess.stream_cohort_rounds(
        _injecting(eng, draws), shared, be, sched, lambda r: reals[r], **kw)
    assert len(stats.stall_s) == len(stats.retire_t) == steps
    np.testing.assert_array_equal(be.last_round.numpy(), jbe.last_round)
    # the masks: one entry more or less moves a kept fraction by 1 / (C N)
    # (2e-4 here); the means of the masks and of the ages round in another
    # order than XLA's
    np.testing.assert_allclose([x["kept_frac"] for x in m],
                               [np.asarray(x["kept_frac"]) for x in jm],
                               atol=1e-6, rtol=0)
    for key in ("mean_age", "g_loss", "d_loss"):
        _close([x[key] for x in m], [np.asarray(x[key]) for x in jm])
    for name in ("d_flat", "opt_flat", "residual"):
        if getattr(jbe, name) is not None:
            _close(getattr(be, name).numpy(), getattr(jbe, name))
    for a, b in zip(jax.tree.leaves(_shared_np(jsh)),
                    tree_leaves(shared.g) + tree_leaves(shared.g_opt)
                    + tree_leaves(shared.server_d) + [shared.step]):
        _close(b.numpy(), a)


# ---------------------------------------------------------------------------
# host backend == device backend (inside the port: bitwise)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("approach", ["approach1", "approach2", "approach3",
                                      "download_first"])
def test_host_sync_matches_device_trajectory(approach):
    """Synchronous streamed rounds over the host store reproduce the
    store-resident cohort engine's trajectory bitwise (the reference pins
    it at 1e-6 because its programs tile differently), final states
    included; the remainder chunk (11 = 4 + 4 + 3) changes nothing."""
    kw = dict(steps=11, participation="uniform", cohort_size=3)
    dev = _run(approach, 8, rounds_per_jit=4, **kw)
    host = _run(approach, 8, state_backend="host", **kw)
    _same_run(dev, host)
    assert host.extra["state_backend"] == "host"
    for a, b in zip(tree_leaves(dev.state.ds) + tree_leaves(dev.state.g),
                    tree_leaves(host.state.ds) + tree_leaves(host.state.g)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_host_prefetch_knob_is_neutral():
    kw = dict(participation="round_robin", cohort_size=2,
              state_backend="host")
    _same_run(_run("approach1", 6, prefetch=True, **kw),
              _run("approach1", 6, prefetch=False, **kw))


def test_async_disjoint_cohorts_equals_sync():
    """round_robin with C dividing U leaves U / C rounds between a user's
    draws: with async_rounds < U / C no member is gathered while its
    update is in flight, so the async trajectory is the synchronous one."""
    kw = dict(steps=10, participation="round_robin", cohort_size=2,
              state_backend="host")
    r_sync = _run("approach1", 8, **kw)
    r_async = _run("approach1", 8, async_rounds=2, **kw)
    _same_run(r_sync, r_async)
    assert r_async.extra["async_rounds"] == 2


def test_async_overlap_bounded_staleness_ages():
    """U == C == 2: every member is in flight when drawn again, so the
    steady age is the pipeline depth S; finite, a different trajectory,
    and the drain at the end leaves every stamp landed."""
    kw = dict(steps=10, state_backend="host", combiner="staleness_mean")
    r_sync = _run("approach1", 2, **kw)
    r_async = _run("approach1", 2, async_rounds=1, **kw)
    assert np.all(r_sync.extra["mean_age"] == 0.0)
    np.testing.assert_array_equal(r_async.extra["mean_age"],
                                  [0.0] + [1.0] * 9)
    assert np.all(np.isfinite(r_async.g_losses))
    assert not np.array_equal(r_sync.g_losses, r_async.g_losses)
    assert np.all(r_async.extra["staleness"] == 0)


def test_device_stream_matches_host_stream_bitwise():
    """The device-resident backend through the streaming driver (ages and
    rows on the device) is bitwise the host backend's stream, sync and
    async over disjoint round_robin cohorts."""
    U, C, steps = 6, 2, 9
    fcfg = tapp.DistGANConfig(num_users=U, upload_frac=0.3)
    reals = np.random.default_rng(0).uniform(
        -1, 1, (steps, C, B, SMALL["data_dim"])).astype(np.float32)
    sched = tfed.make_schedule("round_robin", U, C, steps,
                               np.random.default_rng(1))
    eng = teng.make_cohort_rows_engine(PAIR, fcfg, "approach1")
    sh0, be_h = teng.init_host_backend(PAIR, fcfg, 0, "cpu", sync_ds=True)
    store0 = be_h.snapshot()
    runs = {}
    for name, be, kw in [
            ("host", be_h, {}),
            ("device", tfed.DeviceStateBackend(store0.clone()), {}),
            ("device_async", tfed.DeviceStateBackend(store0.clone()),
             dict(async_rounds=2))]:
        _, ms, stats = tsess.stream_cohort_rounds(
            eng, sh0.clone(), be, sched, lambda r: reals[r], **kw)
        snap = be.snapshot()
        runs[name] = ([m["g_loss"] for m in ms], [m["d_loss"] for m in ms],
                      snap.d_flat.numpy(), snap.last_round.numpy())
        assert all(np.isfinite(s) for s in stats.stall_s)
    for other in ("device", "device_async"):
        for a, b in zip(runs["host"], runs[other]):
            np.testing.assert_array_equal(a, b)


def test_host_knobs_need_a_streaming_backend_and_baseline_has_no_rows():
    ds = _ds(2)
    for bad in (dict(async_rounds=1), dict(materialize_state=False)):
        with pytest.raises(ValueError):
            run_distgan(PAIR, tapp.DistGANConfig(), ds, "approach1",
                        steps=2, batch_size=B, eval_samples=0, device="cpu",
                        **bad)
    with pytest.raises(ValueError, match="user axis"):
        FederationSpec("baseline", backend=BackendSpec("host"))
    with pytest.raises(ValueError, match="async_rounds"):
        BackendSpec("host", async_rounds=-1)


def test_large_u_host_backend_smoke():
    """U = 1024 logical users on the host store, C = 4 a round, async: no
    (U, N) tensor on the device."""
    U, C = 1024, 4
    base = np.random.default_rng(0).normal(size=(512, SMALL["data_dim"])
                                           ).astype(np.float32)

    def sampler(rng, n):
        return base[rng.integers(0, len(base), size=n)]

    ds = FederatedDataset([sampler] * U, sampler, {"shard_sizes": [512] * U})
    r = run_distgan(PAIR, tapp.DistGANConfig(num_users=U, upload_frac=0.3),
                    ds, "approach1", steps=6, batch_size=B, eval_samples=0,
                    participation="uniform", cohort_size=C,
                    state_backend="host", async_rounds=1,
                    materialize_state=False, device="cpu")
    assert r.g_losses.shape == (6,) and np.all(np.isfinite(r.g_losses))
    assert r.d_losses.shape == (6, C)
    assert r.extra["participation_counts"].sum() == 6 * C
    assert r.extra["upload_bytes_per_round"] == \
        C * r.extra["upload_bytes_per_user"]


def test_materialize_state_opt_out_keeps_store_on_host():
    kw = dict(steps=4, participation="uniform", cohort_size=2,
              state_backend="host")
    r = _run("approach1", 6, materialize_state=False, **kw)
    assert r.state is None
    be = r.extra["host_backend"]
    assert be.num_users == 6 and be.snapshot().d_flat.shape[0] == 6
    assert be.gather_rows([0, 5])[0].shape[0] == 2
    r2 = _run("approach1", 6, **kw)
    assert all(t.shape[0] == 6 for t in tree_leaves(r2.state.ds))
    np.testing.assert_array_equal(
        r2.extra["host_backend"].d_flat.numpy(),
        tapp.d_flat_layout(PAIR).flatten_stacked(r2.state.ds).numpy())


def test_adaptive_server_scale_end_to_end():
    """Adaptive combine weights: host and device backends agree bitwise,
    the weights are reported and change the trajectory."""
    kw = dict(participation="weighted", cohort_size=2)
    r_dev = _run("approach1", 6, adaptive_server_scale=True,
                 rounds_per_jit=4, **kw)
    r_host = _run("approach1", 6, adaptive_server_scale=True,
                  state_backend="host", **kw)
    _same_run(r_dev, r_host)
    np.testing.assert_array_equal(r_dev.extra["participation_weights"],
                                  r_host.extra["participation_weights"])
    assert r_host.extra["participation_weights"].shape == (8, 2)
    assert not np.array_equal(r_host.g_losses,
                              _run("approach1", 6, state_backend="host",
                                   **kw).g_losses)


# ---------------------------------------------------------------------------
# error feedback and row staging on the host store
# ---------------------------------------------------------------------------

def _spec(backend, comp, fuse=False, rpj=4, sched="uniform", C=2,
          adaptive=False, combiner="max_abs"):
    return FederationSpec(
        approach="approach1", batch_size=B, seed=0, eval_samples=0,
        engine=EngineSpec(rounds_per_jit=rpj, fuse_store_rounds=fuse),
        participation=ParticipationSpec(sched, cohort_size=C),
        backend=BackendSpec(backend),
        combine=CombineSpec(combiner, adaptive_server_scale=adaptive,
                            compression=comp))


def _sess(spec, U=4):
    return FederationSession(PAIR, tapp.DistGANConfig(num_users=U,
                                                      upload_frac=0.3),
                             _ds(U), spec, device="cpu")


def test_ef_accumulation_invariant_to_windowing():
    """run(5); run(6) == run(11) with codec int8 on the host store: the EF
    residual is carried state, neither dropped nor counted twice."""
    comp = CompressionSpec(codec="int8")
    sa = _sess(_spec("host", comp))
    ra = np.concatenate([sa.run(5).g_losses, sa.run(6).g_losses])
    sb = _sess(_spec("host", comp))
    np.testing.assert_array_equal(ra, sb.run(11).g_losses)
    res = sa._driver.backend.residual.numpy()
    np.testing.assert_array_equal(res, sb._driver.backend.residual.numpy())
    assert np.abs(res).sum() > 0


def test_codec_none_is_structurally_pre_compression():
    sa = _sess(_spec("host", CompressionSpec(codec="none")))
    sb = _sess(_spec("host", CompressionSpec()))
    np.testing.assert_array_equal(sa.run(8).g_losses, sb.run(8).g_losses)
    assert not sa._driver.backend.has_residual


def test_stage_rows_runs_reports_and_prices_the_upload():
    comp = CompressionSpec(codec="int8", stage_rows=True)
    r = _sess(_spec("host", comp, fuse=True)).run(6)
    assert np.all(np.isfinite(r.g_losses))
    assert r.extra["compression"]["stage_rows"]
    assert not r.extra["fused_store"]   # stage_rows: the per-round stream
    plain = _sess(_spec("host", CompressionSpec(codec="int8"))).run(6)
    assert r.extra["upload_bytes_per_round"] == \
        plain.extra["upload_bytes_per_round"]
    assert not np.array_equal(r.g_losses, plain.g_losses)   # lossy store
    with pytest.raises(ValueError, match="stage_rows"):
        FederationSpec("approach1", participation=ParticipationSpec(
            "uniform", cohort_size=2), combine=CombineSpec(
            compression=CompressionSpec("int8", stage_rows=True)))


# ---------------------------------------------------------------------------
# checkpoints of a host session
# ---------------------------------------------------------------------------

def _host_spec(adaptive=True):
    return _spec("host", CompressionSpec(codec="int8"), sched="weighted",
                 adaptive=adaptive, combiner="staleness_mean")


def test_session_resume_matches_uninterrupted(tmp_path, monkeypatch):
    """run(5); save; restore; run(5) == run(10) bitwise: the shared state,
    the host store with its residual, the scheduler and data streams, the
    participation counts and the noise generator all round-trip.  The
    restore builds the store once, from the file (no fresh host init)."""
    full = _sess(_host_spec(), U=6).run(10)
    s1 = _sess(_host_spec(), U=6)
    w1 = s1.run(5)
    s1.save(str(tmp_path / "ckpt"))

    def forbidden(*a, **k):
        raise AssertionError("restore materialized a fresh host store")

    monkeypatch.setattr(tsess, "init_host_backend", forbidden)
    s2 = FederationSession.restore(str(tmp_path / "ckpt"), PAIR,
                                   tapp.DistGANConfig(num_users=6,
                                                      upload_frac=0.3),
                                   _ds(6), device="cpu")
    assert s2.round == 5 and s2._driver.backend is not None
    w2 = s2.run(5)
    np.testing.assert_array_equal(np.concatenate([w1.g_losses, w2.g_losses]),
                                  full.g_losses)
    np.testing.assert_array_equal(np.concatenate([w1.d_losses, w2.d_losses]),
                                  full.d_losses)
    np.testing.assert_array_equal(w2.extra["staleness"],
                                  full.extra["staleness"])
    np.testing.assert_array_equal(s2._driver.backend.residual.numpy(),
                                  full.extra["host_backend"].residual.numpy())


def test_checkpoint_layout_is_the_references(tmp_path):
    """A host session's checkpoint has the reference's leaves in its order
    (``shared`` then the store keys, residual included), every shape and
    type equal but the PRNG slot; a checkpoint the reference wrote
    restores into the port with its store and shared state bitwise."""
    from repro.core.session import FederationSession as JSession
    from repro.core.spec import BackendSpec as JBackend
    from repro.core.spec import CompressionSpec as JComp
    from repro.core.spec import FederationSpec as JSpec
    from repro.core.spec import CombineSpec as JCombine
    from repro.core.spec import ParticipationSpec as JPart
    from repro.data.federated import FederatedDataset as JDataset
    from repro_torch.checkpoint.msgpack_ckpt import read_leaves

    ds = _ds(4)
    jds = JDataset(ds.samplers, ds.union_sampler, ds.meta)
    jspec = JSpec("approach1", batch_size=B, eval_samples=0,
                  participation=JPart("uniform", cohort_size=2),
                  backend=JBackend("host"),
                  combine=JCombine(compression=JComp("int8")))
    jfcfg = japp.DistGANConfig(num_users=4, upload_frac=0.3)
    js = JSession(JPAIR, jfcfg, jds, jspec)
    js.run(3)
    js.save(str(tmp_path / "jax"))
    s = _sess(FederationSpec.from_json(jspec.to_json()))
    s.run(3)
    s.save(str(tmp_path / "port"))
    want, got = read_leaves(str(tmp_path / "jax"), 3), read_leaves(
        str(tmp_path / "port"), 3)
    assert len(want) == len(got)
    for i, (a, b) in enumerate(zip(want[:-1], got[:-1])):
        assert (tuple(a.shape), a.dtype) == (tuple(b.shape), b.dtype), i

    back = FederationSession.restore(str(tmp_path / "jax"), PAIR,
                                     _port_fcfg(jfcfg), ds, device="cpu")
    jb = js._driver.backend
    for name in ("d_flat", "opt_flat", "last_round", "residual"):
        np.testing.assert_array_equal(
            getattr(back._driver.backend, name).numpy(), getattr(jb, name))
    for a, b in zip(jax.tree.leaves(_shared_np(js._driver.shared)),
                    tree_leaves(back._driver.shared.g)
                    + tree_leaves(back._driver.shared.g_opt)
                    + tree_leaves(back._driver.shared.server_d)
                    + [back._driver.shared.step]):
        np.testing.assert_array_equal(b.numpy(), a)
    assert back.round == 3
    assert np.all(np.isfinite(back.run(2).g_losses))
