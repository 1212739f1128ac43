"""The host backend's superbatch path (``fuse_store_rounds`` on the host
store) held to the JAX reference: ``window_forwarding`` bitwise, the
superbatch driver over ``make_superbatch_engine`` against the reference's
with the reference's store, shared state and draws (``last_round``
bitwise, values within ATOL = 1e-5 of its jitted window), and inside the
port the superbatch window against the per-round stream BITWISE (each
round runs the rows engine's round verbatim, and a forwarded row is the
bytes the per-round path would have scattered and gathered again), in and
across windows, with error feedback, through a checkpoint.  Also the
chunk helpers ``_pad_to`` and ``run_scanned``."""

import dataclasses

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
from repro_torch.data import digits_like_mixture, dirichlet_partition

SMALL = dict(data_dim=16, z_dim=8, g_hidden=16, d_hidden=16)
B = 8
ATOL = 1e-5
PAIR = make_mlp_pair(MLPGanConfig(**SMALL))
JPAIR = jax_make_mlp_pair(JaxMLPCfg(**SMALL))


def _ds(U):
    rng = np.random.default_rng(0)
    _, sample = digits_like_mixture(list(range(10)), size=4)
    data = sample(rng, 300).reshape(300, -1)
    return dirichlet_partition(data, rng.integers(0, 10, 300), U, 0.5)


# ---------------------------------------------------------------------------
# window_forwarding: numpy, bitwise
# ---------------------------------------------------------------------------

def test_window_forwarding_plan():
    """Repeats forward to the LATEST in-window write; ages are exact from
    the pre-window ``last_round`` and the in-window stamps."""
    schedule = np.asarray([[0, 1], [2, 0], [1, 0]], np.int32)
    last_round = np.asarray([3, 0, 0], np.int32)
    fwd, ages = tfed.window_forwarding(schedule, last_round, 5)
    np.testing.assert_array_equal(fwd, [[-1, -1], [-1, 0], [1, 3]])
    np.testing.assert_array_equal(ages, [[2, 5], [6, 0], [1, 0]])
    fwd, ages = tfed.window_forwarding(np.asarray([[0, 1], [2, 3]], np.int32),
                                       np.zeros(4, np.int32), 0)
    assert np.all(fwd == -1)
    np.testing.assert_array_equal(ages, [[0, 0], [1, 1]])


@pytest.mark.parametrize("sched", ["uniform", "round_robin", "weighted"])
def test_window_forwarding_matches_reference(sched):
    U, C, K = 5, 3, 9
    rng = np.random.default_rng(2)
    schedule = jfed.make_schedule(sched, U, C, K, rng, [3, 1, 4, 1, 5])
    last = rng.integers(0, 7, U).astype(np.int32)
    got = tfed.window_forwarding(schedule, last, 7)
    want = jfed.window_forwarding(schedule, last, 7)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.int32


def test_pad_to_and_run_scanned_match_reference():
    """``_pad_to`` is the reference's helper bitwise; ``run_scanned`` drives
    a chunk engine over 7 rounds in chunks of 3 + 3 + 1 (the reference pads
    the last; the port runs it short), the same as one chunk of 7."""
    a = np.arange(6, dtype=np.float32).reshape(3, 2)
    np.testing.assert_array_equal(teng._pad_to(a, 5), jeng._pad_to(a, 5))
    assert teng._pad_to(a, 2) is a
    fcfg = tapp.DistGANConfig(num_users=2)
    reals = np.random.default_rng(0).uniform(
        -1, 1, (7, 2, B, SMALL["data_dim"])).astype(np.float32)
    eng = teng.make_engine(PAIR, fcfg, "approach1")
    st, m = teng.run_scanned(eng, tapp.init_state(PAIR, fcfg, 0, "cpu"),
                             reals, rounds_per_jit=3)
    st1, m1 = eng(tapp.init_state(PAIR, fcfg, 0, "cpu"),
                  torch.from_numpy(reals))
    np.testing.assert_array_equal(m["g_loss"], m1["g_loss"].numpy())
    assert m["d_loss"].shape == (7, 2)
    torch.testing.assert_close(st.g["l1"]["w"], st1.g["l1"]["w"], rtol=0,
                               atol=0)


# ---------------------------------------------------------------------------
# the superbatch driver against the reference's
# ---------------------------------------------------------------------------

def _draws(key, steps, lossy, stochastic):
    """Approach 1's z draws and codec seeds from carry key ``key``."""
    out = []
    for _ in range(steps):
        keys = jax.random.split(key, 5 if lossy else 4)
        out.append({
            "z1": torch.from_numpy(np.array(JPAIR.sample_z(keys[1], B))),
            "z2": torch.from_numpy(np.array(JPAIR.sample_z(keys[2], B))),
            "seed": (int(jax.random.randint(keys[4], (), 0,
                                            jnp.int32(2**31 - 1)))
                     if stochastic else None)})
        key = keys[0]
    return out


def _injecting(win, draws):
    """The window engine fed ``draws`` a window at a time."""
    state = {"i": 0}

    def call(*args, **kw):
        k = args[-1].shape[0]
        noise = draws[state["i"]:state["i"] + k]
        state["i"] += k
        return win(*args, noise=noise, **kw)

    return call


@pytest.mark.parametrize("codec", ["none", "topk_int8"])
def test_superbatch_matches_reference_superbatch(codec):
    """Windows of 4 over 10 rounds of round_robin at U = 4, C = 2 (users
    repeat inside every window): the port's superbatch driver against the
    reference's, from the reference's store and shared state with its
    draws (error feedback and stochastic rounding with the int8 codec)."""
    U, C, steps, rpj = 4, 2, 10, 4
    lossy = codec != "none"
    jfcfg = japp.DistGANConfig(num_users=U, upload_frac=0.3, codec=codec,
                               codec_stochastic=lossy)
    fcfg = tapp.DistGANConfig(**{f.name: getattr(jfcfg, f.name)
                                 for f in dataclasses.fields(jfcfg)})
    jsh, jbe = jeng.init_host_backend(JPAIR, jfcfg, jax.random.key(0),
                                      sync_ds=True)
    be = tfed.HostStateBackend(jbe.d_flat, jbe.opt_flat, jbe.last_round,
                               jbe.residual)
    draws = _draws(jsh.key, steps, lossy, lossy)
    shared = shared_from_numpy({
        "g": jax.tree.map(np.asarray, jsh.g),
        "g_opt": jax.tree.map(np.asarray, jsh.g_opt),
        "server_d": jax.tree.map(np.asarray, jsh.server_d),
        "step": np.asarray(jsh.step)}, "cpu")
    rng = np.random.default_rng(5)
    sched = jfed.make_schedule("round_robin", U, C, steps, rng)
    reals = rng.uniform(-1, 1, (steps, C, B, SMALL["data_dim"])
                        ).astype(np.float32)
    fwd, _ = tfed.window_forwarding(sched[:rpj], np.zeros(U, np.int32), 0)
    assert np.any(fwd >= 0)
    jsh, jm, _ = jsess.superbatch_cohort_rounds(
        jeng.make_superbatch_engine(JPAIR, jfcfg, "approach1"), jsh, jbe,
        sched, lambda r: reals[r], rounds_per_jit=rpj)
    shared, m, stats = tsess.superbatch_cohort_rounds(
        _injecting(teng.make_superbatch_engine(PAIR, fcfg, "approach1"),
                   draws), shared, be, sched, lambda r: reals[r],
        rounds_per_jit=rpj)
    assert stats.win_rounds == [4, 4, 2] and len(stats.win_stall_s) == 3
    np.testing.assert_array_equal(be.last_round.numpy(), jbe.last_round)
    for key in ("g_loss", "d_loss", "mean_age"):
        np.testing.assert_allclose([x[key] for x in m],
                                   [np.asarray(x[key]) for x in jm],
                                   atol=ATOL, rtol=0)
    np.testing.assert_allclose([x["kept_frac"] for x in m],
                               [np.asarray(x["kept_frac"]) for x in jm],
                               atol=1e-6, rtol=0)
    for name in ("d_flat", "opt_flat", "residual"):
        if getattr(jbe, name) is not None:
            np.testing.assert_allclose(getattr(be, name).numpy(),
                                       getattr(jbe, name), atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# superbatch window == per-round stream (inside the port: bitwise)
# ---------------------------------------------------------------------------

def _drive(approach, part, U, C, steps, rpj, codec="none", seed=0):
    fcfg = tapp.DistGANConfig(num_users=U, upload_frac=0.3, codec=codec)
    rng = np.random.default_rng(seed)
    reals = rng.uniform(-1, 1, (steps, C, B, SMALL["data_dim"])
                        ).astype(np.float32)
    sched = tfed.make_schedule(part, U, C, steps,
                               np.random.default_rng(seed + 1))
    sync = approach in ("approach1", "download_first")
    out = []
    for fused in (False, True):
        sh, be = teng.init_host_backend(PAIR, fcfg, 0, "cpu", sync_ds=sync)
        if fused:
            sh, ms, _ = tsess.superbatch_cohort_rounds(
                teng.make_superbatch_engine(PAIR, fcfg, approach), sh, be,
                sched, lambda r: reals[r], rounds_per_jit=rpj)
        else:
            sh, ms, _ = tsess.stream_cohort_rounds(
                teng.make_cohort_rows_engine(PAIR, fcfg, approach), sh, be,
                sched, lambda r: reals[r])
        out.append(([m["g_loss"] for m in ms], [m["d_loss"] for m in ms],
                    [m["mean_age"] for m in ms], be.snapshot()))
    return sched, out


def _same(a, b):
    for x, y in zip(a[:3], b[:3]):
        np.testing.assert_array_equal(x, y)
    for name in ("d_flat", "opt_flat", "last_round", "residual"):
        x, y = getattr(a[3], name), getattr(b[3], name)
        assert (x is None) == (y is None)
        if x is not None:
            torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.parametrize("approach", ["approach1", "approach2", "approach3",
                                      "download_first"])
def test_superbatch_round_robin_repeats(approach):
    """round_robin at C close to U: users repeat inside every window, the
    forwarded rounds see their own earlier update, and the window ends on
    the per-round path's bytes and ages."""
    sched, (per_round, fused) = _drive(approach, "round_robin", U=4, C=2,
                                       steps=10, rpj=4)
    fwd, _ = tfed.window_forwarding(sched[:4], np.zeros(4, np.int32), 0)
    assert np.any(fwd >= 0)
    _same(per_round, fused)


def test_superbatch_uniform_collisions_with_error_feedback():
    """uniform draws with in-window collisions, int8 with error feedback:
    the residual block forwards through the same plan as the rows."""
    sched, (per_round, fused) = _drive("approach1", "uniform", U=6, C=3,
                                       steps=11, rpj=4, codec="int8")
    assert any(np.any(tfed.window_forwarding(
        sched[i:i + 4], np.zeros(6, np.int32), i)[0] >= 0)
        for i in range(0, 11, 4))
    assert fused[3].residual is not None
    _same(per_round, fused)


# ---------------------------------------------------------------------------
# the session's fused host path
# ---------------------------------------------------------------------------

def _spec(fuse=True, rpj=4, comp=None, async_rounds=0, sched="round_robin",
          C=2):
    return FederationSpec(
        approach="approach1", batch_size=B, seed=0, eval_samples=0,
        engine=EngineSpec(rounds_per_jit=rpj, fuse_store_rounds=fuse),
        participation=ParticipationSpec(sched, cohort_size=C),
        backend=BackendSpec("host", async_rounds=async_rounds),
        combine=CombineSpec(compression=comp or CompressionSpec()))


def _sess(spec, U=4):
    return FederationSession(PAIR, tapp.DistGANConfig(num_users=U,
                                                      upload_frac=0.3),
                             _ds(U), spec, device="cpu")


def test_session_host_superbatch_flag_and_pin():
    kw = dict(steps=11, batch_size=B, seed=0, eval_samples=0,
              participation="round_robin", cohort_size=3,
              state_backend="host", device="cpu")
    fcfg = tapp.DistGANConfig(num_users=8, upload_frac=0.3)
    r0 = run_distgan(PAIR, fcfg, _ds(8), "approach1", **kw)
    r1 = run_distgan(PAIR, fcfg, _ds(8), "approach1", rounds_per_jit=4,
                     fuse_store_rounds=True, **kw)
    assert r0.extra["fused_store"] is False
    assert r1.extra["fused_store"] is True
    for key in ("staleness", "mean_age"):
        np.testing.assert_array_equal(r0.extra[key], r1.extra[key])
    np.testing.assert_array_equal(r0.g_losses, r1.g_losses)
    assert r1.extra["host_stall_s_per_round"] >= 0.0
    assert r1.extra["min_step_time_s"] > 0.0


def test_session_async_falls_back_to_per_round():
    r = _sess(_spec(async_rounds=2)).run(6)
    assert r.extra["fused_store"] is False
    assert r.extra["async_rounds"] == 2
    assert np.all(np.isfinite(r.g_losses))


def test_session_superbatch_windowing_invariance():
    """run(5); run(6) == run(11): a repeat across the window boundary reads
    from the host the bytes the in-window forward would have read."""
    s1, s2 = _sess(_spec()), _sess(_spec())
    r_a, r_b = s1.run(5), s1.run(6)
    r_all = s2.run(11)
    np.testing.assert_array_equal(
        np.concatenate([r_a.g_losses, r_b.g_losses]), r_all.g_losses)
    b1, b2 = s1._driver.backend, s2._driver.backend
    torch.testing.assert_close(b1.d_flat, b2.d_flat, rtol=0, atol=0)
    torch.testing.assert_close(b1.last_round, b2.last_round, rtol=0, atol=0)


def test_session_superbatch_save_restore(tmp_path):
    """Checkpoint and resume through the fused host path reproduce the
    uninterrupted trajectory bitwise, with error feedback."""
    comp = CompressionSpec(codec="int8")
    s1 = _sess(_spec(comp=comp))
    s1.run(5)
    s1.save(str(tmp_path / "ckpt"))
    r_tail = s1.run(6)
    s2 = FederationSession.restore(str(tmp_path / "ckpt"), PAIR,
                                   tapp.DistGANConfig(num_users=4,
                                                      upload_frac=0.3),
                                   _ds(4), device="cpu")
    assert s2.spec.engine.fuse_store_rounds and s2._driver.fused_store
    np.testing.assert_array_equal(s2.run(6).g_losses, r_tail.g_losses)
    for name in ("d_flat", "residual"):
        torch.testing.assert_close(getattr(s1._driver.backend, name),
                                   getattr(s2._driver.backend, name),
                                   rtol=0, atol=0)


def test_host_fused_store_ef_matches_per_round_stream():
    comp = CompressionSpec(codec="int8")
    sa = _sess(_spec(comp=comp, sched="uniform"))
    sb = _sess(_spec(fuse=False, comp=comp, sched="uniform"))
    ra, rb = sa.run(10), sb.run(10)
    assert ra.extra["fused_store"] and not rb.extra["fused_store"]
    np.testing.assert_array_equal(ra.g_losses, rb.g_losses)
    torch.testing.assert_close(sa._driver.backend.residual,
                               sb._driver.backend.residual, rtol=0, atol=0)
