"""Decode on the CPU: ``decode_step`` of the dense, vlm and ssm families
held to the reference's token by token, the slot-pool cache helpers, the
continuous-batching engine against the reference's engine and against its
own replay and ``greedy_decode``, the synthetic batches and the serve
launcher.

Tolerance of ``decode_step`` against the reference: 1e-4 on logits of
scale ~1 (f32, reduced configs; measured <= 3.9e-5), and within
ULP_FACTOR x the reference's own rounding floor: how far its logits move
when every weight moves by one ULP (1.7e-6 to 3.1e-5 by family).  The
reference's XLA evaluates rsqrt, exp, sin, cos and tanh with its own
polynomials, a few ULP from torch's in 5-60 % of entries, and these stacks
carry a ULP anywhere into the logits at that size; the reference's own
decode and forward differ by as much (up to 4.4e-5), and the port's decode
is held to its forward within ULP_FACTOR x that gap.  The engine's greedy
tokens equal the reference engine's exactly; at temperature 0.7 they
equal it wherever the perturbed top two are further apart than the
tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.spec import DecodeSpec, FederationSpec, ServeSpec
from repro_torch.models import model as M
from repro_torch.models.cache import (cache_nbytes, cache_spec, merge_slots,
                                      reset_slots)
from repro_torch.models.common import tree_leaves
from repro_torch.serve.decode import DecodeEngine, DecodeRequest

DECODE_TOL = 1e-4
ULP_FACTOR = 3
FAMILIES = {"tinyllama-1.1b": {}, "mamba2-780m": {},
            "tinyllama-window8": {"window": 8},
            "chameleon-34b": {}, "qwen2-72b": {}}


def _cfgs(name):
    from repro.configs.base import get_config as jax_config
    arch = "tinyllama-1.1b" if name == "tinyllama-window8" else name
    jcfg = dataclasses.replace(jax_config(arch).reduced(), **FAMILIES[name])
    tcfg = dataclasses.replace(get_config(arch).reduced(), **FAMILIES[name])
    return jcfg, tcfg


def _params(jcfg, seed):
    """The reference's random weights, and the same weights in the port."""
    from repro.models import model as JM
    jp = JM.init_params(jcfg, jax.random.key(seed))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _engine(cfg, params, **spec):
    return DecodeEngine(cfg, params, DecodeSpec(**spec), device="cpu")


def _mixed_requests(cfg, n, seed=0, max_gen=6):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, cfg.vocab_size, int(pl)).astype(np.int32),
             int(g))
            for pl, g in zip(rng.integers(2, 12, n),
                             rng.integers(2, max_gen + 1, n))]


# ---------------------------------------------------------------------------
# decode_step and the caches
# ---------------------------------------------------------------------------

def _nudged(tree):
    """Every f32 leaf moved by one ULP toward +inf."""
    return jax.tree.map(lambda a: jnp.asarray(np.nextafter(
        np.asarray(a), np.float32(np.inf))) if a.dtype == jnp.float32
        else a, tree)


def _decode_readings(name):
    """Token by token (B 2, S 20): the port's and the reference's jitted
    decode_step logits and final caches, both full-sequence forwards, and
    the reference's rounding floor (the most its logits move when every
    weight moves by one ULP)."""
    from repro.models import model as JM
    jcfg, tcfg = _cfgs(name)
    jp, tp = _params(jcfg, 1)
    B, S = 2, 20
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jcache, tcache = JM.init_cache(jcfg, B, S), M.init_cache(tcfg, B, S)
    ncache, jnudged = JM.init_cache(jcfg, B, S), _nudged(jp)
    if tcfg.window:
        assert tcache["k"].shape[2] == tcfg.window       # (L,B,T,kv,hd)
    step = jax.jit(lambda p, c, t, i: JM.decode_step(p, c, t, i, jcfg))
    outs, jouts, floor = [], [], 0.0
    with torch.no_grad():
        for i in range(S):
            jl, jcache = step(jp, jcache, tokens[:, i:i + 1], jnp.int32(i))
            nl, ncache = step(jnudged, ncache, tokens[:, i:i + 1],
                              jnp.int32(i))
            tl, tcache = M.decode_step(
                tp, tcache, torch.from_numpy(tokens[:, i:i + 1]), i, tcfg)
            floor = max(floor, float(np.abs(np.asarray(nl - jl)).max()))
            outs.append(tl[:, 0].numpy())
            jouts.append(np.asarray(jl)[:, 0])
        full, _ = M.forward(tp, {"tokens": torch.from_numpy(tokens)}, tcfg)
    jfull = JM.forward(jp, {"tokens": jnp.asarray(tokens)}, jcfg)[0]
    return {"port": np.stack(outs, 1), "ref": np.stack(jouts, 1),
            "port_fwd": full.numpy(), "ref_fwd": np.asarray(jfull),
            "floor": floor, "caches": (jcache, tcache)}


@pytest.mark.parametrize("name", list(FAMILIES))
def test_decode_step_matches_reference_and_own_forward(name):
    """Token by token against the reference's jitted decode_step (logits
    and every cache leaf), and against the port's own full-sequence
    forward; a sliding window keeps a ring buffer of the window.  Beside
    DECODE_TOL, each gap is held to the reference's own rounding: the logits
    within ULP_FACTOR x its rounding floor, and decode vs forward within
    ULP_FACTOR x the reference's own decode vs forward."""
    r = _decode_readings(name)
    np.testing.assert_allclose(r["port"], r["ref"], rtol=0, atol=DECODE_TOL)
    for j, t in zip(jax.tree.leaves(r["caches"][0]),
                    tree_leaves(r["caches"][1])):
        scale = max(float(np.abs(np.asarray(j)).max()), 1.0)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=DECODE_TOL * scale)
    np.testing.assert_allclose(r["port"], r["port_fwd"], rtol=0,
                               atol=DECODE_TOL)
    assert np.abs(r["port"] - r["ref"]).max() <= ULP_FACTOR * r["floor"]
    assert np.abs(r["port"] - r["port_fwd"]).max() <= \
        ULP_FACTOR * np.abs(r["ref"] - r["ref_fwd"]).max()


def test_per_row_positions_equal_one_row_at_a_time():
    """attn_decode with one position per row (the engine's slots, here on
    a sliding window) is each row decoded alone at its own position (to
    f32 rounding: a batch of one runs its matmuls at another shape)."""
    _, cfg = _cfgs("tinyllama-window8")
    params = M.init_params(cfg, 3, device="cpu")
    rng = np.random.default_rng(4)
    B, T = 3, 12
    cache = {k: torch.from_numpy(rng.normal(size=s.shape).astype(np.float32))
             for k, s in cache_spec(cfg, B, T).items()}
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 1)))
    pos = torch.tensor([0, 5, 11])
    with torch.no_grad():
        logits, new = M.decode_step(params, cache, toks, pos, cfg)
        for b in range(B):
            one = {k: v[:, b:b + 1] for k, v in cache.items()}
            lb, nb = M.decode_step(params, one, toks[b:b + 1],
                                   int(pos[b]), cfg)
            for got, want in [(lb[0], logits[b])] + [
                    (nb[k][:, 0], new[k][:, b]) for k in new]:
                scale = max(float(want.abs().max()), 1.0)
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=1e-5 * scale)


def test_cache_sizes_and_the_families_still_to_port():
    """The SSM cache is O(1) in sequence length; the families ported last
    (hybrid, MoE + MLA, audio, MoE) have the reference's cache sizes, the
    hybrid's bounded by its window."""
    from repro.configs.base import get_config as jax_config
    from repro.models.cache import cache_spec as jax_spec
    cfg = get_config("mamba2-780m").reduced()
    size = lambda c: sum(np.prod(s.shape) for s in tree_leaves(c))
    assert size(cache_spec(cfg, 2, 1024)) == size(cache_spec(cfg, 2, 524288))
    for arch in ("recurrentgemma-9b", "deepseek-v2-lite-16b",
                 "seamless-m4t-medium", "deepseek-moe-16b"):
        for T in (16, 524288):
            assert size(cache_spec(get_config(arch).reduced(), 2, T)) == \
                sum(np.prod(s.shape) for s in jax.tree.leaves(
                    jax_spec(jax_config(arch).reduced(), 2, T)))
    hybrid = get_config("recurrentgemma-9b").reduced()
    assert size(cache_spec(hybrid, 2, 1024)) == \
        size(cache_spec(hybrid, 2, 524288))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-780m",
                                  "chameleon-34b"])
def test_cache_nbytes_matches_allocation_and_the_reference(arch):
    from repro.configs.base import get_config as jax_config
    from repro.models.cache import cache_nbytes as jax_nbytes
    cfg = get_config(arch).reduced()
    for B, T in [(1, 16), (4, 48)]:
        alloc = sum(t.numel() * t.element_size()
                    for t in tree_leaves(M.init_cache(cfg, B, T)))
        assert cache_nbytes(cfg, B, T) == alloc
        assert alloc == jax_nbytes(jax_config(arch).reduced(), B, T)
    full = get_config(arch)
    assert cache_nbytes(full, 8, 256) == jax_nbytes(jax_config(arch), 8, 256)


def test_reset_and_merge_slots_touch_only_valid_rows():
    cfg = get_config("mamba2-780m").reduced()
    gen = torch.Generator().manual_seed(0)
    pool = {k: torch.randn(s.shape, generator=gen).to(s.dtype)
            for k, s in cache_spec(cfg, 4, 16).items()}
    valid = torch.tensor([True, False, True, False])
    wiped = reset_slots(pool, valid)
    fresh = {k: v + 1 for k, v in pool.items()}
    merged = merge_slots(pool, fresh, valid.numpy())
    for k in pool:
        assert not wiped[k][:, valid].any()
        assert torch.equal(wiped[k][:, ~valid], pool[k][:, ~valid])
        assert torch.equal(merged[k][:, valid], fresh[k][:, valid])
        assert torch.equal(merged[k][:, ~valid], pool[k][:, ~valid])


# ---------------------------------------------------------------------------
# the continuous-batching engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-780m"])
def test_engine_tokens_equal_reference_engine_and_greedy(arch):
    """Greedy pooled tokens equal the reference engine's on the same
    weights and requests, the port's per-request greedy_decode and the
    engine's own replay; programs stay within len(buckets) + 1 and the pool
    is what cache_nbytes prices."""
    from repro.core.spec import DecodeSpec as JaxDecodeSpec
    from repro.serve.decode import DecodeEngine as JaxEngine
    from repro.serve.decode import DecodeRequest as JaxRequest
    from repro_torch.launch.serve import greedy_decode
    jcfg, cfg = _cfgs(arch)
    jp, params = _params(jcfg, 1)
    reqs = _mixed_requests(cfg, 5, seed=2)
    jeng = JaxEngine(jcfg, jp, JaxDecodeSpec(slots=3, max_seq=24))
    eng = _engine(cfg, params, slots=3, max_seq=24)
    jf = [jeng.submit(JaxRequest(user_id=i, prompt=p, max_new=g))
          for i, (p, g) in enumerate(reqs)]
    tf = [eng.submit(DecodeRequest(user_id=i, prompt=p, max_new=g))
          for i, (p, g) in enumerate(reqs)]
    jeng.drain()
    eng.drain()
    for rid, ((p, g), want, got) in enumerate(zip(reqs, jf, tf)):
        out = got.result()
        assert out.dtype == np.int32
        np.testing.assert_array_equal(out, want.result())
        np.testing.assert_array_equal(out, eng.replay(p, g, request_id=rid))
        np.testing.assert_array_equal(out, greedy_decode(
            cfg, params, torch.from_numpy(p)[None].long(), g)[0].numpy())
    pc = eng.program_counts
    assert pc["prefill"] <= len(eng.spec.buckets()) and pc["decode"] == 1
    st = eng.engine_stats()
    assert st["pool_nbytes"] == sum(t.numel() * t.element_size()
                                    for t in tree_leaves(eng.pool))
    assert st["completed"] == 5 and st["occupied"] == 0


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-780m"])
def test_engine_at_temperature_matches_reference_engine(arch):
    """At temperature 0.7 on the same weights, requests and seeds: the
    Gumbel noise of every served position's key, fold_in(fold_in(key(seed),
    request_id), position), within 1e-6 of jax.random.gumbel's; the port's
    tokens equal the reference engine's at every position up to the first
    whose perturbed top-two gap (the reference's logits / T + its noise) is
    within twice the perturbed logits' tolerance, DECODE_TOL / T + 1e-6."""
    from repro.core.spec import DecodeSpec as JaxDecodeSpec
    from repro.models import model as JM
    from repro.serve.decode import DecodeEngine as JaxEngine
    from repro.serve.decode import DecodeRequest as JaxRequest
    from repro_torch import prng
    temp, noise_tol = 0.7, 1e-6
    tol = 2 * (DECODE_TOL / temp + noise_tol)
    jcfg, cfg = _cfgs(arch)
    jp, params = _params(jcfg, 1)
    reqs = _mixed_requests(cfg, 5, seed=3, max_gen=8)
    jeng = JaxEngine(jcfg, jp, JaxDecodeSpec(slots=3, max_seq=24,
                                             temperature=temp))
    eng = _engine(cfg, params, slots=3, max_seq=24, temperature=temp)
    jf = [jeng.submit(JaxRequest(user_id=i, prompt=p, max_new=g,
                                 seed=50 + i)) for i, (p, g) in
          enumerate(reqs)]
    tf = [eng.submit(DecodeRequest(user_id=i, prompt=p, max_new=g,
                                   seed=50 + i)) for i, (p, g) in
          enumerate(reqs)]
    jeng.drain()
    eng.drain()
    step = jax.jit(lambda p, c, t, i: JM.decode_step(p, c, t, i, jcfg))
    compared = 0
    for rid, ((p, g), want, got) in enumerate(zip(reqs, jf, tf)):
        want, got = want.result(), got.result()
        # the reference's logits along its own continuation
        seq = np.concatenate([p, want]).astype(np.int32)
        cache, rows = JM.init_cache(jcfg, 1, 24), []
        for i in range(len(seq) - 1):
            lg, cache = step(jp, cache, seq[None, i:i + 1], jnp.int32(i))
            if i >= len(p) - 1:
                rows.append(np.asarray(lg)[0, 0])
        pos = np.arange(len(p), len(p) + len(want))
        jkeys = [jax.random.fold_in(jax.random.fold_in(
            jax.random.key(50 + rid), rid), int(k)) for k in pos]
        jnoise = np.stack([np.asarray(jax.random.gumbel(k, (cfg.vocab_size,)))
                           for k in jkeys])
        tkeys = prng.fold_in(prng.fold_in(prng.key(
            np.full(len(pos), 50 + rid)), rid), torch.from_numpy(pos))
        np.testing.assert_allclose(
            prng.gumbel(tkeys, (cfg.vocab_size,)).numpy(), jnoise, rtol=0,
            atol=noise_tol)
        top2 = np.sort(np.stack(rows) / temp + jnoise, axis=1)[:, -2:]
        assert len(got) == len(want)
        for j, gap in enumerate(top2[:, 1] - top2[:, 0]):
            if gap <= tol:
                break
            assert got[j] == want[j], (rid, j, gap)
            compared += 1
    assert compared >= sum(g for _, g in reqs) - 2


def test_engine_replay_and_submission_order_invariance():
    """Tokens are a pure function of (params, prompt, seed, request_id):
    reverse-order submission (other slots, other batch-mates) and the solo
    replay agree bit for bit under temperature sampling."""
    cfg = get_config("tinyllama-1.1b").reduced()
    params = M.init_params(cfg, 3, device="cpu")
    reqs = _mixed_requests(cfg, 6, seed=4)
    eng = _engine(cfg, params, slots=3, max_seq=24, temperature=0.7)

    def serve(order):
        futs = {i: eng.submit(
            DecodeRequest(user_id=i, prompt=reqs[i][0],
                          max_new=reqs[i][1], seed=100 + i),
            request_id=i) for i in order}
        eng.drain()
        return {i: f.result() for i, f in futs.items()}

    a = serve(range(len(reqs)))
    b = serve(range(len(reqs) - 1, -1, -1))
    for i in range(len(reqs)):
        np.testing.assert_array_equal(a[i], b[i])
        np.testing.assert_array_equal(
            a[i], eng.replay(reqs[i][0], reqs[i][1], seed=100 + i,
                             request_id=i))


def test_replay_mid_flight_leaves_the_pool_untouched():
    """replay() while slots are occupied runs through the live programs
    and puts the pool back: the in-flight requests finish as if it had
    not run."""
    cfg = get_config("mamba2-780m").reduced()
    params = M.init_params(cfg, 5, device="cpu")
    reqs = _mixed_requests(cfg, 3, seed=7, max_gen=8)
    eng = _engine(cfg, params, slots=2, max_seq=24)
    want = [eng.generate(i, p, g, request_id=i)
            for i, (p, g) in enumerate(reqs)]
    futs = [eng.submit(DecodeRequest(user_id=i, prompt=p, max_new=g),
                       request_id=i) for i, (p, g) in enumerate(reqs)]
    eng.step(force_admit=True)
    before = [t.clone() for t in tree_leaves(eng.pool)]
    np.testing.assert_array_equal(eng.replay(*reqs[2], request_id=2),
                                  want[2])
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                 tree_leaves(eng.pool)))
    eng.drain()
    for w, f in zip(want, futs):
        np.testing.assert_array_equal(f.result(), w)


def test_engine_eos_frees_slot_for_reuse():
    cfg = get_config("tinyllama-1.1b").reduced()
    params = M.init_params(cfg, 5, device="cpu")
    prompt = np.arange(1, 7, dtype=np.int32)
    toks = _engine(cfg, params, slots=1, max_seq=24).generate(
        0, prompt, 8, request_id=0)
    eos = int(toks[2])   # a token greedy decode provably emits mid-run
    eng = _engine(cfg, params, slots=1, max_seq=24, eos_id=eos)
    first = eng.generate(0, prompt, 8, request_id=0)
    assert len(first) <= 3 and first[-1] == eos
    np.testing.assert_array_equal(first, eng.replay(prompt, 8, request_id=0))
    (p2, g2), = _mixed_requests(cfg, 1, seed=6)
    second = eng.generate(1, p2, g2, request_id=1)
    np.testing.assert_array_equal(second, eng.replay(p2, g2, request_id=1))


def test_specs_round_trip_as_the_references_and_validate():
    """DecodeSpec and ServeSpec ride the manifest in the reference's
    layout; bad values are refused."""
    from repro.core.spec import FederationSpec as JaxSpec
    spec = FederationSpec(
        approach="approach1",
        serve=ServeSpec(bucket_sizes=[1, 3, 12], flush_ms=0.5,
                        rate_limit=4),
        decode=DecodeSpec(slots=4, max_seq=32, prefill_buckets=(8, 32),
                          flush_ms=1.0, admit_min=2, eos_id=3,
                          temperature=0.5))
    assert spec.to_json() == JaxSpec.from_json(spec.to_json()).to_json()
    again = FederationSpec.from_dict(spec.to_dict())
    assert again == spec and again.decode.buckets() == (8, 32)
    assert again.serve.buckets() == (1, 3, 12) and again.serve.max_batch == 12
    assert DecodeSpec(max_seq=100).buckets() == (8, 16, 32, 64, 100)
    for bad in (dict(slots=0), dict(max_seq=16, prefill_buckets=(8, 32)),
                dict(slots=4, admit_min=5), dict(temperature=-0.1)):
        with pytest.raises(ValueError):
            DecodeSpec(**bad)
    for bad in (dict(max_batch=12), dict(bucket_sizes=(4, 2)),
                dict(oversample=0), dict(rate_window_s=0.0)):
        with pytest.raises(ValueError):
            ServeSpec(**bad)
    with pytest.raises(ValueError, match="unknown key"):
        FederationSpec.from_dict({"approach": "approach1",
                                  "decode": {"slot": 4}})


def test_synthetic_batches_equal_the_references():
    from repro.data.synthetic import TokenStream as JaxStream
    from repro.data.synthetic import synthetic_batch_for as jax_batch
    from repro_torch import prng
    from repro_torch.data.synthetic import TokenStream, synthetic_batch_for
    for arch in ("tinyllama-1.1b", "seamless-m4t-medium"):
        cfg = get_config(arch).reduced()
        from repro.configs.base import get_config as jax_config
        want = jax_batch(jax_config(arch).reduced(), 3, 16,
                         jax.random.key(11))
        got = synthetic_batch_for(cfg, 3, 16, prng.key(11))
        for k in ("tokens", "targets"):
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        if "src_embeds" in want:
            np.testing.assert_allclose(got["src_embeds"].numpy(),
                                       np.asarray(want["src_embeds"]),
                                       rtol=0, atol=1e-6)
    js, ts = JaxStream(97, 12, 3, seed=5), TokenStream(97, 12, 3, seed=5)
    for step in (0, 4):
        for k in ("tokens", "targets"):
            np.testing.assert_array_equal(ts.batch(step)[k].numpy(),
                                          np.asarray(js.batch(step)[k]))


def test_service_routes_mixed_sample_and_decode_traffic():
    """One service, two traffic classes drained together: decode bytes
    equal their replay, tokens join the tenant's accounting, and the rate
    window is shared across classes."""
    from repro_torch.core.approaches import DistGANConfig
    from repro_torch.core.gan import MLPGanConfig, make_mlp_pair
    from repro_torch.core.session import FederationSession
    from repro_torch.data.federated import FederatedDataset
    from repro_torch.data.mixtures import make_user_domains
    from repro_torch.serve import GenerationService, RateLimitExceeded

    users, union = make_user_domains(2, 2, 1.0)
    sess = FederationSession(
        make_mlp_pair(MLPGanConfig(data_dim=2, z_dim=8, g_hidden=16,
                                   d_hidden=16)),
        DistGANConfig(num_users=2),
        FederatedDataset([u.sample for u in users], union.sample, {}),
        FederationSpec("approach1", batch_size=8, eval_samples=0,
                       serve=ServeSpec(max_batch=16, flush_ms=0.5,
                                       rate_limit=3, rate_window_s=60.0),
                       decode=DecodeSpec(slots=2, max_seq=24)),
        device="cpu")
    sess.run(2)
    svc = GenerationService.from_session(sess)
    cfg = get_config("tinyllama-1.1b").reduced()
    eng = svc.attach_lm(cfg, M.init_params(cfg, 0, device="cpu"))
    assert eng.spec == sess.spec.decode and eng.device == svc.device
    sample_fut = svc.submit(0, 4, seed=9)
    prompt = np.arange(1, 8, dtype=np.int32)
    dec_fut = svc.submit_decode(0, prompt, 5, seed=1, request_id=0)
    svc.drain()
    assert sample_fut.result().shape == (4, 2)
    toks = dec_fut.result()
    np.testing.assert_array_equal(
        toks, svc.decoder.replay(prompt, 5, seed=1, request_id=0))
    st = svc.stats()
    acc = st["per_user"][0]
    assert acc["requests"] == 2 and acc["samples"] == 4
    assert acc["tokens"] == len(toks)
    assert st["decode"]["completed"] == 1
    svc.submit_decode(0, prompt, 2, seed=2)
    with pytest.raises(RateLimitExceeded):
        svc.submit(0, 2, seed=3)
    svc.drain()


def test_serve_launcher_runs_on_the_cpu(capsys):
    from repro_torch.launch.serve import main
    for extra in ([], ["--continuous", "--slots", "2"]):
        main(["--arch", "mamba2-780m", "--reduced", "--batch", "3",
              "--prompt-len", "6", "--gen", "4", "--device", "cpu"] + extra)
    out = capsys.readouterr().out
    rows = [line for line in out.splitlines() if "first row" in line]
    assert len(rows) == 2 and rows[0] == rows[1]


if __name__ == "__main__":
    # the readings behind DECODE_TOL and ULP_FACTOR, family by family:
    # PYTHONPATH=src python tests/test_torch_decode.py
    for name in FAMILIES:
        r = _decode_readings(name)
        gap = lambda a, b: float(np.abs(r[a] - r[b]).max())
        print(f"{name}: port vs reference {gap('port', 'ref'):.2e}, "
              f"reference floor {r['floor']:.2e}, port decode vs forward "
              f"{gap('port', 'port_fwd'):.2e}, reference decode vs forward "
              f"{gap('ref', 'ref_fwd'):.2e}")
