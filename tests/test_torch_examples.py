"""The example twins (``repro_torch.examples``) held to the JAX reference's
examples (``examples/*.py``) on the CPU, at small sizes.

The reference draws its weights and noise from ``jax.random``, the port
from a torch ``Generator``, so a twin started from the same seed does not
reproduce the reference's losses, coverage or tokens.  Two kinds of
quantity are compared instead:

* what numpy or ``prng`` fixes — data, partitions, schedules, ages,
  priced bytes, the worker partition, serving accounting and prompts —
  bitwise, against the reference's own functions and sessions on the same
  arguments;
* what depends on the weights, from the reference's weights carried over
  by ``repro_torch.convert`` where a twin takes weights (quickstart,
  serve_batched): the losses at the train tolerances of
  ``tests/test_torch_train.py`` (rtol 1e-5 at the first step, the curve
  within ``ULP_FACTOR`` x the reference's own one-ULP floor), greedy and
  pooled tokens equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.core import approaches as japp
from repro.core import federated as jfed
from repro.core.gan import MLPGanConfig as JMLPConfig
from repro.core.gan import make_mlp_pair as jmake_mlp_pair
from repro.core.protocol import run_distgan as jrun_distgan
from repro.core.session import FederationSession as JSession
from repro.core.spec import FederationSpec as JSpec
from repro.data.federated import FederatedDataset as JDataset
from repro.data.federated import dirichlet_partition as jdirichlet
from repro.data.mixtures import GaussianMixture as JMixture
from repro.data.synthetic import TokenStream as JTokenStream
from repro.launch.serve import greedy_decode as jgreedy_decode
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.approaches import (DistGANConfig, d_flat_layout,
                                         d_opt_flat_layout)
from repro_torch.core.gan import MLPGanConfig, make_mlp_pair
from repro_torch.data.synthetic import TokenStream
from repro_torch.examples import (distgan_cohort, distgan_compress,
                                  distgan_fused_store, distgan_multihost,
                                  distgan_serve, distgan_stream, quickstart,
                                  serve_batched)

ULP_FACTOR = 3
QS_STEPS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small models on a CPU shared by several test workers: torch's
    intra-op threads only contend, so this module runs on one."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _one_ulp(tree, seed: int):
    """Every leaf moved one ULP up or down (seeded signs)."""
    rng = np.random.default_rng(seed)

    def bump(a):
        a = np.asarray(a)
        to = np.where(rng.random(a.shape) < 0.5, np.inf, -np.inf)
        return jnp.asarray(np.nextafter(a, to.astype(a.dtype)))

    return jax.tree.map(bump, tree)


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------

def test_quickstart_train_and_serve_track_the_reference(capsys):
    """The reference's quickstart at ``--steps 4`` from its weights:
    ``TokenStream`` batches bitwise (the prompt's batch 999 too); the
    twin's ``train`` from the carried weights gives the first loss at rtol
    1e-5 and a curve within ULP_FACTOR x the reference's one-ULP floor;
    ``serve`` on the reference's trained weights gives its greedy tokens
    exactly.  ``main`` prints the reference's lines."""
    jcfg = jget_config("tinyllama-1.1b").reduced()
    cfg = get_config("tinyllama-1.1b").reduced()
    jstream = JTokenStream(jcfg.vocab_size, seq_len=64, batch_size=8, seed=0)
    stream = TokenStream(cfg.vocab_size, seq_len=64, batch_size=8, seed=0)
    for i in list(range(QS_STEPS)) + [999]:
        jb, tb = jstream.batch(i), stream.batch(i)
        assert all(np.array_equal(np.asarray(jb[k]), tb[k].numpy())
                   for k in jb)

    jp0 = JM.init_params(jcfg, jax.random.key(0))
    jstep, jopt = jmake_train_step(jcfg, jadamw(1e-3))
    jstep = jax.jit(jstep)

    def ref_run(jp):
        jst, out = jopt.init(jp), []
        for i in range(QS_STEPS):
            jp, jst, jm = jstep(jp, jst, jstream.batch(i))
            out.append(float(jm["loss"]))
        return np.array(out), jp

    jl, jtrained = ref_run(jp0)
    floor = max(np.abs(ref_run(_one_ulp(jp0, s))[0] - jl).max()
                for s in (0, 1))
    _, tl = quickstart.train(cfg, params_from_numpy(_np(jp0), "cpu"),
                             stream, QS_STEPS)
    tl = np.array(tl)
    np.testing.assert_allclose(tl[0], jl[0], rtol=1e-5)
    assert np.abs(tl - jl).max() <= ULP_FACTOR * floor, (tl, jl, floor)

    jprompt = jstream.batch(999)["tokens"][:2, :8]
    want = np.asarray(jgreedy_decode(jcfg, jtrained, jprompt, gen_len=12))
    got = quickstart.serve(cfg, params_from_numpy(_np(jtrained), "cpu"),
                           stream.batch(999)["tokens"][:2, :8], 12)
    np.testing.assert_array_equal(got.numpy(), want)

    capsys.readouterr()
    rows = quickstart.main(["--steps", "2", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == (f"== {cfg.name} (reduced: {cfg.num_layers}L "
                      f"d={cfg.d_model}) ==")
    assert [ln.split("  loss")[0] for ln in out[1:3]] == ["step   0",
                                                          "step   1"]
    assert out[3] == f"prompt : {np.asarray(jprompt)[0].tolist()}"
    assert out[4].startswith("greedy : ") and len(rows[-1]["greedy"]) == 12
    assert all(np.isfinite(r["loss"]) for r in rows[1:3])


# ---------------------------------------------------------------------------
# serve_batched
# ---------------------------------------------------------------------------

def _reference_serve(jcfg, jparams, jprompt, gen):
    """The reference example's ``serve``: greedy per request, then the
    reference engine; its tokens, sizes and programs."""
    from repro.core.spec import DecodeSpec as JDecodeSpec
    from repro.launch.serve import cache_nbytes as jcache_nbytes
    from repro.serve.decode import DecodeEngine as JEngineD
    from repro.serve.decode import DecodeRequest as JRequest
    batch, plen = jprompt.shape
    greedy = np.concatenate([np.asarray(jgreedy_decode(
        jcfg, jparams, row[None, :], gen)) for row in jprompt])
    eng = JEngineD(jcfg, jparams, JDecodeSpec(slots=batch,
                                              max_seq=plen + gen))
    futs = [eng.submit(JRequest(user_id=i, prompt=p, max_new=gen))
            for i, p in enumerate(np.asarray(jprompt))]
    eng.drain()
    return {"greedy": greedy,
            "pooled": np.stack([f.result() for f in futs]),
            "cache_nbytes": jcache_nbytes(jcfg, batch, plen + gen),
            "pool_nbytes": eng.pool_nbytes,
            "programs": eng.engine_stats()["programs"]}


@pytest.mark.parametrize("arch", serve_batched.ARCHS)
def test_serve_batched_matches_the_reference(arch):
    """At the reference's sizes (batch 4, prompt 16, 16 new): the prompts
    bitwise (``prng.randint`` vs ``jax.random.randint``); from the
    reference's ``init_params(key(0))`` carried over, the per-request
    greedy tokens and the pooled engine's equal the reference's, and
    ``cache_nbytes``, ``pool_nbytes`` and the programs are its own."""
    jcfg = jget_config(arch).reduced()
    cfg = get_config(arch).reduced()
    jprompt = jax.random.randint(jax.random.key(1), (4, 16), 0,
                                 jcfg.vocab_size)
    np.testing.assert_array_equal(
        serve_batched.prompts_for(cfg, 4, 16).numpy(), np.asarray(jprompt))
    jp = JM.init_params(jcfg, jax.random.key(0))
    want = _reference_serve(jcfg, jp, jprompt, 16)
    got = serve_batched.serve(arch, params=params_from_numpy(_np(jp), "cpu"),
                              device="cpu")
    np.testing.assert_array_equal(np.array(got["greedy"]), want["greedy"])
    np.testing.assert_array_equal(np.array(got["pooled"]), want["pooled"])
    assert got["bytes_match_greedy"]
    for k in ("cache_nbytes", "pool_nbytes", "programs"):
        assert got[k] == want[k], (k, got[k], want[k])
    assert got["programs"] == {"prefill": 1, "decode": 1}


# ---------------------------------------------------------------------------
# the federation twins
# ---------------------------------------------------------------------------

def _jpair(hidden: int, z: int = 16):
    return jmake_mlp_pair(JMLPConfig(data_dim=2, z_dim=z, g_hidden=hidden,
                                     d_hidden=hidden))


def _jpooled(U: int):
    """The reference examples' pooled ring dataset."""
    mix = JMixture.ring(8)
    pool = mix.sample(np.random.default_rng(0), 20_000)

    def sampler(rng_, n):
        return pool[rng_.integers(0, len(pool), size=n)]

    return JDataset([sampler] * U, sampler, {"shard_sizes": [len(pool)] * U})


def _jspec(spec, **changes):
    """The reference's spec of the same fields as the port's ``spec``."""
    jspec = JSpec.from_json(spec.to_json())
    return dataclasses.replace(jspec, **changes) if changes else jspec


def test_ring_pool_is_the_references():
    mix, pool, _ = distgan_stream.ring_pool()
    jmix = JMixture.ring(8)
    np.testing.assert_array_equal(pool, jmix.sample(
        np.random.default_rng(0), 20_000))
    np.testing.assert_array_equal(mix.modes, jmix.modes)


def test_cohort_schedule_and_split_match_reference_run_distgan(capsys):
    """[U 16, C 4, 32 rounds, K 8]: the ring data and the Dirichlet(0.3)
    shard sizes bitwise the reference's, and ``participation_counts`` and
    ``staleness`` bitwise the reference ``run_distgan``'s on the same
    arguments; finite losses; the twin's lines printed."""
    U, C, steps, K = 16, 4, 32, 8
    rows = distgan_cohort.main(["--users", str(U), "--cohort", str(C),
                                "--steps", str(steps), "--rounds-per-jit",
                                str(K), "--device", "cpu"])
    out = capsys.readouterr().out
    _, data, labels = distgan_cohort.ring_data()
    jmix = JMixture.ring(8)
    rng = np.random.default_rng(0)
    jlabels = rng.integers(0, 8, size=20_000)
    jdata = (jmix.modes[jlabels] + rng.normal(0, jmix.std, (20_000, 2))
             ).astype(np.float32)
    np.testing.assert_array_equal(data, jdata)
    np.testing.assert_array_equal(labels, jlabels)
    jds = jdirichlet(jdata, jlabels, num_users=U, alpha=0.3, seed=0)
    assert rows[0]["shard_sizes"] == list(jds.meta["shard_sizes"])
    jfcfg = japp.DistGANConfig(num_users=U, selection="topk",
                               upload_frac=0.5, combiner="staleness_max_abs",
                               staleness_decay=0.7)
    jr = jrun_distgan(_jpair(128), jfcfg, jds, "approach1", steps=steps,
                      batch_size=64, seed=0, participation="weighted",
                      cohort_size=C, rounds_per_jit=K, eval_samples=16)
    run = rows[1]
    np.testing.assert_array_equal(np.array(run["participation_counts"]),
                                  jr.extra["participation_counts"])
    np.testing.assert_array_equal(np.array(run["staleness"]),
                                  jr.extra["staleness"])
    assert np.all(np.isfinite(run["g_losses"]))
    assert len(run["g_losses"]) == steps
    assert f"dirichlet(0.3) split over {U} users" in out
    assert f"approach1 U={U} C={C} weighted: g_loss=" in out
    assert "participation: users_touched=" in out


def test_stream_ages_and_host_footprint_match_reference_sessions():
    """[U in {16, 64}, C 4, 16 rounds]: per (U, approach) the run's
    ``mean_age`` bitwise the reference session's on the same spec; the
    host MB from the same layout sizes as the reference's."""
    Us, C, steps = (16, 64), 4, 16
    rows = distgan_stream.main(["--users", *map(str, Us), "--cohort",
                                str(C), "--steps", str(steps), "--device",
                                "cpu"])
    assert [(r["users"], r["approach"]) for r in rows] == [
        (U, a) for U in Us for a in distgan_stream.APPROACHES]
    jpair = _jpair(128)
    pair = make_mlp_pair(MLPGanConfig(data_dim=2, z_dim=16, g_hidden=128,
                                      d_hidden=128))
    for r in rows:
        U = r["users"]
        jfcfg = japp.DistGANConfig(num_users=U, selection="topk",
                                   upload_frac=0.5)
        fcfg = DistGANConfig(num_users=U, selection="topk", upload_frac=0.5)
        jn = (japp.d_flat_layout(jpair).n,
              japp.d_opt_flat_layout(jpair, jfcfg).n)
        assert (d_flat_layout(pair).n,
                d_opt_flat_layout(pair, fcfg).n) == jn
        assert r["host_mb"] == 4e-6 * U * (jn[0] + jn[1])
        jspec = _jspec(distgan_stream.stream_spec(r["approach"], C),
                       eval_samples=16)
        jr = JSession(jpair, jfcfg, _jpooled(U), jspec).run(steps)
        np.testing.assert_array_equal(np.array(r["mean_age"]),
                                      jr.extra["mean_age"])
        assert np.all(np.isfinite(r["g_losses"]))


def test_fused_store_runs_and_keeps_the_references_staleness(capsys):
    """[U 64, C 8, K 4, 16 rounds]: the twin runs to its end (its own
    checks: staleness equal across the three modes, the first 8 losses
    within 1e-6 of ``per_round``), and the ``per_round`` staleness is
    bitwise the reference's session's on the same spec."""
    U, C, K, steps = 64, 8, 4, 16
    rows = distgan_fused_store.main(["--users", str(U), "--cohort", str(C),
                                     "--rounds-per-jit", str(K), "--steps",
                                     str(steps), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "bookkeeping exact across all three modes" in out
    modes = {r["mode"]: r for r in rows if "staleness" in r}
    assert list(modes) == ["per_round", "superbatch", "device_fused"]
    assert [modes[m]["fused_store"] for m in modes] == [False, True, True]
    jfcfg = japp.DistGANConfig(num_users=U, selection="topk",
                               upload_frac=0.5)
    jspec = _jspec(distgan_fused_store.fused_spec("host", False, C, K))
    jr = JSession(_jpair(64), jfcfg, _jpooled(U), jspec).run(steps)
    np.testing.assert_array_equal(np.array(modes["per_round"]["staleness"]),
                                  jr.extra["staleness"])


def test_compress_prices_every_variant_as_the_reference(capsys):
    """[U in {16, 32}, C 4, 8 rounds, the --quick path]: every (U, codec,
    ef) row's ``upload_bytes_per_round`` is what the reference's session
    prices for that spec (``upload_bytes_flat`` on the reference's layout,
    called as its session calls it); finite losses; the byte ratios
    printed and computed from the priced bytes."""
    Us, C, steps = (16, 32), 4, 8
    rows = distgan_compress.main(["--quick", "--users", *map(str, Us),
                                  "--cohort", str(C), "--steps", str(steps),
                                  "--device", "cpu"])
    out = capsys.readouterr().out
    runs = [r for r in rows if "codec" in r]
    assert [(r["users"], r["codec"], r["ef"]) for r in runs] == [
        (U, c, ef) for U in Us for c, ef in distgan_compress.VARIANTS]
    n = japp.d_flat_layout(_jpair(128)).n
    for r in runs:
        want = C * jfed.upload_bytes_flat(n, "topk", 0.1, kept_frac=None,
                                          codec=r["codec"])
        assert r["upload_bytes_per_round"] == want, r
        assert np.all(np.isfinite(r["g_losses"])) and r["rounds"] == steps
    for U in Us:
        ratio = next(r for r in rows if r.get("users") == U
                     and "vs_dense_f32_row" in r)
        none, last = (next(r["upload_bytes_per_round"] for r in runs
                           if r["users"] == U and r["codec"] == c)
                      for c in ("none", "topk_int8"))
        assert ratio["vs_f32_values"] == none / last
        assert ratio["vs_dense_f32_row"] == C * n * 4 / last
        assert (f"topk_int8 ships x{none / last:.1f} fewer upload bytes "
                f"than f32 values at the same kept fraction (U={U})") in out


def test_multihost_fleet_and_wire_match_the_reference(capsys):
    """[U 32, W 2, C 4, 4 rounds]: the fleet partition ``(rank, lo, hi)``,
    the run's ``round_payload_bytes`` and ``rpc_calls`` bitwise the
    reference multihost session's on the same spec (its workers are
    jax-free, so it runs in this process); the twin's restore at W + 1
    prints ``BITWISE MATCH`` and returns (no ``SystemExit``)."""
    U, W, C, steps = 32, 2, 4, 4
    rows = distgan_multihost.main(["--users", str(U), "--workers", str(W),
                                   "--cohort", str(C), "--steps", str(steps),
                                   "--device", "cpu"])
    out = capsys.readouterr().out
    assert ("continued trajectory vs single-process host backend: "
            "BITWISE MATCH") in out
    assert rows[-1]["bitwise_match"] and rows[-1]["restored_workers"] == W + 1
    jfcfg = japp.DistGANConfig(num_users=U, selection="topk",
                               upload_frac=0.5)
    js = JSession(_jpair(32, z=8), jfcfg, _jpooled(U), _jspec(
        distgan_multihost.multihost_spec("multihost", C, W)))
    try:
        fleet = [(h.rank, h.lo, h.hi) for h in js._driver._fleet.workers]
        mb = js.run(steps).extra["host_backend"]
        want = (mb.round_payload_bytes, mb.rpc_calls)
    finally:
        js.close()
    run = rows[1]
    assert run["fleet"] == fleet
    assert (run["round_payload_bytes"], run["rpc_calls"]) == want
    assert np.all(np.isfinite(run["g_losses"]))


def _reference_serve_stats(U, C, rounds, n_requests):
    """The reference example's serving pass: its session trained
    ``rounds``, the workload submitted twice and drained; (stats, number
    of buckets)."""
    from repro.data.mixtures import make_user_domains as jdomains
    from repro.serve import GenerationService as JService
    users, union = jdomains(U, 2, 1.0)
    jds = JDataset([u.sample for u in users], union.sample,
                   {"shard_sizes": [1000] * U})
    jfcfg = japp.DistGANConfig(num_users=U, selection="topk",
                               upload_frac=0.3)
    js = JSession(_jpair(32, z=8), jfcfg, jds,
                  _jspec(distgan_serve.serve_spec(C)))
    js.run(rounds)
    svc = JService.from_session(js)
    rng = np.random.default_rng(0)
    sizes = rng.integers(1, 18, size=n_requests)
    tenants = rng.integers(0, U, size=n_requests)
    for _ in range(2):
        for u, n in zip(tenants, sizes):
            svc.submit(int(u), int(n), seed=int(u))
        svc.drain()
    return svc.stats(), len(svc.serve.buckets())


def test_serve_contracts_and_accounting_match_the_reference(capsys):
    """``--quick`` (U 16, C 4, 8 rounds, 80 requests): served == replay,
    the hot swap serves new bytes, the bucket count and the per-user
    accounting (requests, samples, bytes of each user, and the totals)
    bitwise the reference's on the same workload, and the rejection
    filter raises the user's own-D score."""
    rows = distgan_serve.main(["--quick", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve] determinism: request bytes == replay bytes" in out
    assert rows[1]["served_equals_replay"] and rows[1]["hot_swap_new_bytes"]
    assert rows[1]["generation"] == 1
    assert rows[1]["score_filtered"] > rows[1]["score_plain"]
    st, n_buckets = _reference_serve_stats(16, 4, 8, 80)
    assert rows[0]["buckets"] == n_buckets
    assert rows[0]["request_programs"] <= n_buckets
    acct = rows[2]
    assert acct["per_user"] == {int(u): dict(a)
                                for u, a in st["per_user"].items()}
    assert (acct["total_samples"], acct["total_bytes"]) == (
        st["total_samples"], st["total_bytes"])
    assert (f"[account] total: {st['total_samples']} samples, "
            f"{st['total_bytes']} bytes served") in out
