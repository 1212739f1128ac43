"""The serving slice (``repro_torch.serve``) on the CPU: the reference's
``tests/test_serve.py`` cases against the port's classes, and the port held
to the reference's own results.

* the sampler: ``sample_request`` / ``score_bucket`` / the stream equal the
  reference's on the same weights and ``(seed, request_id, index)`` within
  ``MLP_TOL`` (the MLP pair) and ``CONV_TOL`` (the conv pair): the latents
  are the reference's draws (``prng``, within 1e-6 of them), G is the same
  function summed in another order;
* the port's own contract BITWISE: a slot's bytes are the same alone, among
  any batch-mates, in every bucket of the ladder and however a request is
  chunked; served == ``replay``; a conv D's score ignores the padding;
* a checkpoint the REFERENCE saved serves through the port's
  ``GenerationService.from_checkpoint`` and matches the reference's service
  on the same requests (plain and rejection-filtered);
* the scheduler, hot-swap, accounting, rate-limit and fresh-process cases.
"""

import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro_torch.convert import params_from_numpy
from repro_torch.core.approaches import DistGANConfig
from repro_torch.core.gan import (ConvGanConfig, MLPGanConfig, make_conv_pair,
                                  make_mlp_pair)
from repro_torch.core.session import FederationSession
from repro_torch.core.spec import (BackendSpec, FederationSpec,
                                   ParticipationSpec, ServeSpec)
from repro_torch.data.federated import FederatedDataset
from repro_torch.data.mixtures import make_user_domains
from repro_torch.models.common import tree_leaves
from repro_torch.serve import (GenerationService, MicroBatcher,
                               RateLimitExceeded, SampleRequest)
from repro_torch.serve.sampler import SamplerEngine

MLP = dict(data_dim=2, z_dim=8, g_hidden=32, d_hidden=32)
CONV = dict(image_size=16, channels=1, z_dim=8, base_filters=4)
PAIR = make_mlp_pair(MLPGanConfig(**MLP))
# Against the reference: the latents differ by at most 1e-6 (prng.normal)
# and G / D sum in another order; measured 1.2e-7 (MLP) and 7.5e-8 (conv).
MLP_TOL, CONV_TOL = 1e-6, 1e-6
ROOT = os.path.join(os.path.dirname(__file__), "..")


def _engine(pair, buckets, **kw):
    return SamplerEngine(pair, buckets, device="cpu", **kw)


def _init(pair, seed=0):
    return pair.init(torch.Generator().manual_seed(seed), "cpu")


def _ds(num_users):
    users, union = make_user_domains(num_users, 2, 1.0)
    return FederatedDataset([u.sample for u in users], union.sample,
                            {"shard_sizes": [100] * num_users})


def _spec(backend="host", C=2, approach="approach1", serve=None):
    part = (ParticipationSpec("uniform", cohort_size=C) if C is not None
            else ParticipationSpec())    # full participation (baseline)
    return dict(approach=approach, batch_size=8, eval_samples=0,
                participation=part, backend=BackendSpec(backend),
                serve=serve or ServeSpec(max_batch=16, flush_ms=1.0))


def _session(backend="host", U=4, C=2, rounds=3, approach="approach1",
             serve=None):
    fcfg = DistGANConfig(num_users=U, selection="topk", upload_frac=0.3)
    sess = FederationSession(PAIR, fcfg, _ds(U), FederationSpec(
        **_spec(backend, C, approach, serve)), device="cpu")
    sess.run(rounds)
    return sess


def _jax_pair(kind):
    from repro.core import gan as jgan
    if kind == "mlp":
        return jgan.make_mlp_pair(jgan.MLPGanConfig(**MLP))
    return jgan.make_conv_pair(jgan.ConvGanConfig(**CONV))


def _ref_weights(kind, seed):
    """The reference pair's (g, d) and the same weights in the port."""
    jg, jd = _jax_pair(kind).init(jax.random.key(seed))
    conv = lambda t: params_from_numpy(jax.tree.map(np.asarray, t), "cpu")
    return (jg, jd), (conv(jg), conv(jd))


# ---------------------------------------------------------------------------
# sampler engine: the reference's results, bucket ladder, isolation
# ---------------------------------------------------------------------------

def test_bucket_ladder_policy():
    eng = _engine(PAIR, ServeSpec(max_batch=16).buckets())
    assert eng.buckets == (1, 2, 4, 8, 16)
    assert [eng.bucket_for(k) for k in (1, 2, 3, 5, 9, 16)] == \
        [1, 2, 4, 8, 16, 16]
    with pytest.raises(AssertionError):
        eng.bucket_for(17)   # callers chunk loads beyond max_bucket


@pytest.mark.parametrize("kind,tol,buckets,n", [
    ("mlp", MLP_TOL, (4, 8), 11),
    # one bucket: the reference compiles each conv program (~5 s apiece)
    ("conv", CONV_TOL, (8,), 8)])
def test_sampler_matches_the_reference(kind, tol, buckets, n):
    """sample_request and score_bucket (and the MLP's stream) against the
    reference's engine on the same weights, seeds and request ids."""
    from repro.serve.sampler import SamplerEngine as JaxEngine
    (jg, jd), (g, d) = _ref_weights(kind, 3)
    pair = make_mlp_pair(MLPGanConfig(**MLP)) if kind == "mlp" else \
        make_conv_pair(ConvGanConfig(**CONV))
    jeng, eng = JaxEngine(_jax_pair(kind), buckets), _engine(pair, buckets)
    want = jeng.sample_request(jg, -7, 2**32 + 3, n)
    got = eng.sample_request(g, -7, 2**32 + 3, n)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    np.testing.assert_allclose(eng.score_bucket(d, got),
                               jeng.score_bucket(jd, want), rtol=0,
                               atol=tol)
    if kind == "mlp":      # the stream's G is the same full-batch G
        jeng.seed_stream(5)
        eng.seed_stream(5)
        np.testing.assert_allclose(eng.sample_stream(g, n),
                                   jeng.sample_stream(jg, n), rtol=0,
                                   atol=tol)


@pytest.mark.parametrize("kind", ["mlp", "conv"])
def test_samples_bitwise_invariant_to_batch_mates_bucket_and_chunking(kind):
    """The serving contract: slot (seed, rid, off) produces the same bytes
    alone, in every bucket of the ladder, packed with unrelated batch-mates
    and chunked across dispatches (the conv pair's batch norm included)."""
    pair = PAIR if kind == "mlp" else make_conv_pair(ConvGanConfig(**CONV))
    g, _ = _init(pair, 1)
    eng = _engine(pair, (1, 2, 4, 8, 16, 40))     # 40: three row chunks
    alone = eng.sample_request(g, seed=7, request_id=3, n=5)
    seeds = [7] * 5 + [99] * 7
    rids = [3] * 5 + [42] * 7
    offs = list(range(5)) + list(range(7))
    mixed = eng.sample_bucket(g, 40, seeds, rids, offs)[:5].numpy()
    np.testing.assert_array_equal(alone, mixed)
    for b in eng.buckets:
        row = eng.sample_bucket(g, b, [7], [3], [4])[0].numpy()
        np.testing.assert_array_equal(row, alone[4])
    # chunked across buckets (n > max_bucket): the same leading bytes
    big = eng.sample_request(g, seed=7, request_id=3, n=45)
    np.testing.assert_array_equal(big[:5], alone)
    # the padding rows are zeros
    assert not eng.sample_bucket(g, 8, [7], [3], [0])[1:].any()


def test_compile_count_bounded_by_buckets_not_request_mix():
    g, _ = _init(PAIR)
    buckets = ServeSpec(max_batch=16).buckets()
    eng = _engine(PAIR, buckets)
    for n in range(1, 17):            # 16 distinct request sizes
        eng.sample_request(g, seed=0, request_id=n, n=n)
    assert eng.compile_count == len(buckets) == 5
    assert eng.program_counts == {"request": 5, "score": 0, "stream": 0}


def test_stream_path_reproducible_from_seed():
    g, _ = _init(PAIR)
    eng = _engine(PAIR, (4, 8))
    eng.seed_stream(3)
    a = eng.sample_stream(g, 10)
    b = eng.sample_stream(g, 10)     # the stream goes on
    eng.seed_stream(3)
    np.testing.assert_array_equal(eng.sample_stream(g, 10), a)
    assert a.shape == (10, 2) and not np.array_equal(a, b)


def test_conv_d_scores_invariant_to_bucket_padding():
    """A batch-norm D scores each row as a batch of its own: the bucket's
    zero padding and the rung (or chunk) a row lands in never show."""
    pair = make_conv_pair(ConvGanConfig(**CONV))
    g, d = _init(pair, 2)
    x = _engine(pair, (8,)).sample_request(g, 0, 0, 5)
    wide = _engine(pair, (1, 2, 4, 8, 16)).score_bucket(d, x)  # pad 11
    snug = _engine(pair, (5,)).score_bucket(d, x)              # pad 0
    chunked = _engine(pair, (3,)).score_bucket(d, x)           # 3 + 2
    np.testing.assert_array_equal(wide, snug)
    np.testing.assert_array_equal(wide, chunked)


# ---------------------------------------------------------------------------
# micro-batcher: coalescing, splitting, size-or-deadline flush
# ---------------------------------------------------------------------------

def _recording_dispatch(log):
    def dispatch(bucket, seeds, rids, offs):
        log.append((bucket, len(seeds)))
        return np.stack([np.asarray([s, r, o], np.float32)
                         for s, r, o in zip(seeds, rids, offs)])
    return dispatch


def test_batcher_coalesces_requests_into_one_bucket():
    log = []
    b = MicroBatcher(_recording_dispatch(log), (1, 2, 4, 8, 16), 1.0)
    futs = [b.submit(SampleRequest(user_id=u, n=n, seed=u))
            for u, n in [(0, 3), (1, 5), (2, 2)]]
    assert b.pending_slots() == 10
    b.drain()
    assert log == [(16, 10)]          # ONE dispatch, largest fitting bucket
    for (u, n), f in zip([(0, 3), (1, 5), (2, 2)], futs):
        out = f.result(timeout=1)
        assert out.shape[0] == n
        np.testing.assert_array_equal(out[:, 2], np.arange(n))
        assert set(out[:, 0]) == {u}
    assert b.stats["flushes"] == 1 and b.stats["padded_slots"] == 6


def test_batcher_splits_oversized_request_across_dispatches():
    log = []
    b = MicroBatcher(_recording_dispatch(log), (4, 8), 1.0)
    f = b.submit(SampleRequest(user_id=0, n=19, seed=5))
    b.drain()
    assert log == [(8, 8), (8, 8), (4, 3)]
    np.testing.assert_array_equal(f.result(timeout=1)[:, 2], np.arange(19))


def test_batcher_size_or_deadline_due():
    now = [0.0]
    log = []
    b = MicroBatcher(_recording_dispatch(log), (1, 2, 4), 0.010,
                     clock=lambda: now[0])
    assert not b.due()                # empty
    b.submit(SampleRequest(user_id=0, n=2))
    assert not b.due()                # under size, under deadline
    b.submit(SampleRequest(user_id=1, n=2))
    assert b.due()                    # 4 slots = a full max bucket
    b.flush()
    b.submit(SampleRequest(user_id=2, n=1))
    assert not b.due()
    now[0] += 0.011
    assert b.due()                    # deadline expired
    b.drain()
    assert log == [(4, 4), (1, 1)]


def test_batcher_dispatch_failures_fail_their_futures_only():
    """A dispatch error fails the futures it carried (once, a split
    request's too); the dead slots are swept and later traffic is served,
    synchronously and by the background pump."""
    calls = {"n": 0}

    def flaky(bucket, seeds, rids, offs):
        calls["n"] += 1
        if calls["n"] in (1, 3):
            raise RuntimeError("transient")
        return np.stack([np.asarray([s, r, o], np.float32)
                         for s, r, o in zip(seeds, rids, offs)])

    b = MicroBatcher(flaky, (4,), 0.001)
    f_split = b.submit(SampleRequest(user_id=0, n=6))   # spans 2 buckets
    with pytest.raises(RuntimeError, match="transient"):
        b.drain()
    with pytest.raises(RuntimeError, match="transient"):
        f_split.result(timeout=1)
    f_next = b.submit(SampleRequest(user_id=1, n=3))
    b.drain()
    assert f_next.result(timeout=1).shape[0] == 3
    b.start()
    try:
        f1 = b.submit(SampleRequest(user_id=0, n=2))
        with pytest.raises(RuntimeError, match="transient"):
            f1.result(timeout=5)
        f2 = b.submit(SampleRequest(user_id=1, n=3))
        assert f2.result(timeout=5).shape[0] == 3
    finally:
        b.stop()


def test_batcher_background_pump_serves_the_engines_bytes():
    g, _ = _init(PAIR)
    eng = _engine(PAIR, (1, 2, 4, 8))

    def dispatch(bucket, seeds, rids, offs):
        return eng.sample_bucket(g, bucket, seeds, rids, offs).numpy()

    b = MicroBatcher(dispatch, (1, 2, 4, 8), 0.001)
    b.start()
    try:
        futs = [b.submit(SampleRequest(user_id=0, n=n, seed=9))
                for n in (3, 5, 2)]
        outs = [f.result(timeout=5) for f in futs]
    finally:
        b.stop()
    assert [o.shape[0] for o in outs] == [3, 5, 2]
    np.testing.assert_array_equal(outs[1], eng.sample_request(g, 9, 1, 5))


# ---------------------------------------------------------------------------
# GenerationService: determinism, hot-swap, accounting, filtering
# ---------------------------------------------------------------------------

def test_service_served_bytes_equal_replay_under_the_pump():
    sess = _session()
    svc = GenerationService.from_session(sess)
    assert svc.device == torch.device("cpu")
    mix = [(0, 3), (1, 6), (2, 2), (3, 9), (1, 17), (2, 1)]
    svc.batcher.start()
    try:
        futs = [svc.submit(u, n, seed=u * 11 - 5) for u, n in mix]
        outs = [f.result(timeout=30) for f in futs]
    finally:
        svc.batcher.stop()
    for rid, ((u, n), out) in enumerate(zip(mix, outs)):
        np.testing.assert_array_equal(out, svc.replay(u * 11 - 5, rid, n))
    assert svc.stats()["programs"]["request"] <= len(svc.serve.buckets())


def test_service_hot_swap_publishes_between_batches():
    sess = _session()
    svc = GenerationService.from_session(sess)
    before = svc.sample(0, 4, seed=1, request_id=100)
    sess.run(2)                       # updates the session's G in place
    assert svc.generation == 0
    # an un-refreshed service still serves the OLD generator
    np.testing.assert_array_equal(svc.replay(1, 100, 4), before)
    np.testing.assert_array_equal(svc.sample(0, 4, seed=1, request_id=100),
                                  before)
    # a direct engine call with the live tree fills the graphs' buffers;
    # the service's next dispatch copies its published snapshot back in
    svc.engine.sample_request(sess.generator_params(), 1, 100, 4)
    np.testing.assert_array_equal(svc.sample(0, 4, seed=1, request_id=100),
                                  before)
    assert svc.refresh() == 1
    after = svc.replay(1, 100, 4)
    assert not np.array_equal(before, after)
    direct = _engine(PAIR, svc.serve.buckets()).sample_request(
        sess.generator_params(), 1, 100, 4)
    np.testing.assert_array_equal(after, direct)


def test_service_per_user_accounting():
    sess = _session()
    svc = GenerationService.from_session(sess)
    svc.sample(0, 5, seed=1)
    svc.sample(0, 3, seed=2)
    svc.sample(2, 4, seed=3)
    st = svc.stats()
    assert st["per_user"][0] == {"requests": 2, "samples": 8,
                                 "bytes": 8 * 2 * 4}
    assert st["per_user"][2]["samples"] == 4
    assert st["total_samples"] == 12 and st["generation"] == 0
    assert st["batcher"]["flushes"] == 3


@pytest.mark.parametrize("backend", ["device", "host"])
def test_rejection_filter_prefers_own_d_scores(backend):
    """sample_filtered keeps the oversampled candidates the USER'S OWN D
    row scores highest, on both store residencies; deterministic; the
    user's D is a snapshot later training cannot rewrite."""
    sess = _session(backend=backend, rounds=4)
    svc = GenerationService.from_session(sess)
    plain = svc.sample(1, 16, seed=5, request_id=500)
    filt = svc.sample_filtered(1, 16, seed=5, request_id=501)
    d1 = svc.user_d_params(1)
    assert svc.engine.score_bucket(d1, filt).mean() >= \
        svc.engine.score_bucket(d1, plain).mean()
    np.testing.assert_array_equal(
        filt, svc.sample_filtered(1, 16, seed=5, request_id=501))
    snap = [t.clone() for t in tree_leaves(d1)]
    np.testing.assert_array_equal(sess.user_d_flat(1),
                                  torch.cat([t.reshape(-1) for t in snap]))
    sess.run(2)
    assert all(torch.equal(a, b) for a, b in zip(snap, tree_leaves(d1)))
    assert not np.array_equal(sess.user_d_flat(1),
                              torch.cat([t.reshape(-1) for t in snap]))


def test_rejection_filter_rejected_without_user_rows():
    sess = _session(approach="baseline", U=2, C=None, backend="device")
    svc = GenerationService.from_session(sess)
    with pytest.raises(ValueError, match="no per-user"):
        svc.sample_filtered(0, 4)


def test_reference_checkpoint_serves_as_the_reference_serves(tmp_path):
    """A checkpoint the JAX reference saved (host backend, approach 1)
    restores through the port's from_checkpoint, carries its serve block,
    and serves the reference service's samples on the same requests,
    plain and filtered by a user's own D row."""
    from repro.core import spec as jspec
    from repro.core.approaches import DistGANConfig as JaxFcfg
    from repro.core.session import FederationSession as JaxSession
    from repro.data.federated import FederatedDataset as JaxDataset
    from repro.data.mixtures import make_user_domains as jax_domains
    from repro.serve import GenerationService as JaxService

    users, union = jax_domains(4, 2, 1.0)
    spec = jspec.FederationSpec(
        "approach1", batch_size=8, eval_samples=0,
        participation=jspec.ParticipationSpec("uniform", cohort_size=2),
        backend=jspec.BackendSpec("host"),
        serve=jspec.ServeSpec(max_batch=8, flush_ms=1.0, oversample=3))
    fcfg = dict(num_users=4, selection="topk", upload_frac=0.3)
    jsess = JaxSession(_jax_pair("mlp"), JaxFcfg(**fcfg), JaxDataset(
        [u.sample for u in users], union.sample,
        {"shard_sizes": [100] * 4}), spec)
    jsess.run(3)
    jsess.save(str(tmp_path / "ckpt"))
    jsvc = JaxService.from_session(jsess)
    svc = GenerationService.from_checkpoint(
        str(tmp_path / "ckpt"), PAIR, DistGANConfig(**fcfg), device="cpu")
    assert svc.serve == ServeSpec(max_batch=8, flush_ms=1.0, oversample=3)
    mix = [(0, 3, 4), (1, 6, -2), (2, 11, 9), (3, 1, 0)]
    want = [jsvc.submit(u, n, seed=s) for u, n, s in mix]
    got = [svc.submit(u, n, seed=s) for u, n, s in mix]
    jsvc.drain()
    svc.drain()
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.result(), w.result(), rtol=0,
                                   atol=MLP_TOL)
    np.testing.assert_array_equal(svc.user_d_params(2)["l1"]["w"].numpy(),
                                  np.asarray(jsvc.user_d_params(2)["l1"]["w"]))
    np.testing.assert_allclose(
        svc.sample_filtered(2, 5, seed=3, request_id=40),
        jsvc.sample_filtered(2, 5, seed=3, request_id=40), rtol=0,
        atol=MLP_TOL)


def test_checkpoint_serve_fresh_process_determinism(tmp_path):
    """Served bytes saved here, the session checkpointed, a fresh process
    (the port alone, no JAX) restores and serves them again: solo replay
    and under another batch-mate mix, bitwise."""
    sess = _session(rounds=4)
    svc = GenerationService.from_session(sess)
    futs = [svc.submit(u, n, seed=s, request_id=r)
            for u, n, s, r in [(0, 4, 3, 5), (1, 6, 11, 7), (2, 5, 9, 8)]]
    svc.drain()
    np.save(tmp_path / "want.npy", futs[1].result(timeout=1))
    sess.save(str(tmp_path / "ckpt"))
    code = textwrap.dedent(f"""
        import sys
        import numpy as np
        from repro_torch.core.approaches import DistGANConfig
        from repro_torch.core.gan import MLPGanConfig, make_mlp_pair
        from repro_torch.serve import GenerationService

        pair = make_mlp_pair(MLPGanConfig(**{MLP!r}))
        fcfg = DistGANConfig(num_users=4, selection="topk", upload_frac=0.3)
        svc = GenerationService.from_checkpoint(
            r"{tmp_path}/ckpt", pair, fcfg, device="cpu")
        assert svc.serve.max_batch == 16, svc.serve
        want = np.load(r"{tmp_path}/want.npy")
        np.testing.assert_array_equal(svc.replay(11, 7, 6), want)
        futs = [svc.submit(u, n, seed=s, request_id=r)
                for u, n, s, r in [(3, 2, 8, 60), (1, 6, 11, 7),
                                   (0, 9, 1, 61), (2, 1, 4, 62)]]
        svc.drain()
        np.testing.assert_array_equal(futs[1].result(timeout=1), want)
        assert not [m for m in sys.modules if m.split(".")[0] == "jax"]
        print("SERVE DETERMINISM OK")
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "SERVE DETERMINISM OK" in r.stdout


def test_rate_limit_named_error_rejected_row_and_window_expiry():
    """Over-limit submissions raise RateLimitExceeded (carrying the
    tenant), land in its ``rejected`` row, and the window slides; other
    tenants are never affected."""
    import time

    sess = _session(serve=ServeSpec(max_batch=16, flush_ms=0.5,
                                    rate_limit=2, rate_window_s=0.2))
    svc = GenerationService.from_session(sess)
    svc.submit(0, 2, seed=1)
    svc.submit(0, 2, seed=2)
    with pytest.raises(RateLimitExceeded) as ei:
        svc.submit(0, 2, seed=3)
    assert ei.value.user_id == 0 and ei.value.limit == 2
    assert "exceeded 2 requests" in str(ei.value)
    svc.submit(1, 2, seed=4)          # tenant 1 has its own window
    svc.drain()
    st = svc.stats()
    assert st["per_user"][0]["rejected"] == 1
    assert st["per_user"][0]["requests"] == 2
    assert "rejected" not in st["per_user"][1]
    assert st["total_rejected"] == 1
    time.sleep(0.25)                  # the window expires
    svc.submit(0, 2, seed=5)
    svc.drain()
    assert svc.stats()["per_user"][0]["rejected"] == 1
