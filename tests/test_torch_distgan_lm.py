"""The Distributed-GAN protocol over LM backbone critics
(``repro_torch.core.distgan_lm``) held to the JAX reference on the CPU, at
the reference test's sizes (V 64, d 64, 2 / 2 heads, hd 32, d_ff 128, seq
16).

* ``user_token_stream`` / ``bigram_match_score``: the reference's bits;
* the critic over users stacked on a leading axis equals per-user calls
  bitwise, for per-user and shared, int and soft batches;
* one approach-2 round (the reference's own LM case) from a carried
  LM-critic state, after two reference rounds of warm-up, against the
  reference's jitted step with its own draws: every weight and loss within
  ``ROUND_ATOL`` = 1e-5 (measured 2.8e-7).  The Adam moments carry the
  round's gradients, which the nearly saturated attention of a
  random-init critic makes as sensitive as in the train step
  (``tests/test_torch_train.py``): where the reference's own moments move
  more than ``ROUND_ATOL / ULP_FACTOR`` when its weights move one ULP, a
  leaf is held within ``ULP_FACTOR`` x that floor (the embedding's first
  moment: port 2.5e-5, floor 3.3e-5);
* the reference's ``test_distgan_lm_integration_runs`` case through the
  port's ``run_distgan``;
* a token dataset reaches ``d_apply`` as int32 on the full, cohort and
  host paths (the session used to stage every batch as f32);
* a federation-trained critic, exported by ``critic_lm_params`` under
  ``critic_lm_config``, serves through ``GenerationService.attach_lm``: its
  greedy tokens equal the reference engine's on the same weights, and its
  ``decode_step`` logits the reference's within 1e-4 (the decode
  tolerance of ``tests/test_torch_decode.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.core import approaches as japp
from repro.core import distgan_lm as jlm
from repro.models import model as JM
from repro_torch.configs.base import get_config
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import approaches as tapp
from repro_torch.core import distgan_lm as tlm
from repro_torch.core.protocol import run_distgan
from repro_torch.core.session import FederationSession
from repro_torch.core.spec import (BackendSpec, DecodeSpec, EngineSpec,
                                   FederationSpec, ParticipationSpec)
from repro_torch.data.federated import FederatedDataset
from repro_torch.models import model as TM
from repro_torch.models.common import tree_leaves, tree_map

ROUND_ATOL = 1e-5
ULP_FACTOR = 3
SMALL = dict(vocab_size=64, d_model=64, num_heads=2, num_kv_heads=2,
             head_dim=32, d_ff=128)
U, B, S = 2, 8, 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The critics are tiny: on a CPU shared by several test workers,
    torch's intra-op threads only contend, so this module runs torch on
    one thread."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cfgs(arch):
    jbb = dataclasses.replace(jget_config(arch).reduced(), **SMALL)
    bb = dataclasses.replace(get_config(arch).reduced(), **SMALL)
    kw = dict(seq_len=S, z_dim=32, g_hidden=64)
    return jlm.LMGanConfig(backbone=jbb, **kw), tlm.LMGanConfig(
        backbone=bb, **kw)


def _streams(mod):
    return (mod.user_token_stream(64, S, a=3, c=7),
            mod.user_token_stream(64, S, a=5, c=11))


def _dataset(mod=tlm):
    s1, s2 = _streams(mod)
    union = lambda rng, n: np.concatenate([s1(rng, n // 2),
                                           s2(rng, n - n // 2)])
    return FederatedDataset([s1, s2], union, {})


def test_token_streams_and_bigram_score_equal_the_references():
    for (js, ts) in zip(_streams(jlm), _streams(tlm)):
        a = js(np.random.default_rng(3), 11)
        b = ts(np.random.default_rng(3), 11)
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(4)
    soft = rng.random((6, S, 64)).astype(np.float32)
    toks = _streams(tlm)[0](rng, 6)
    for x in (soft, toks):
        assert tlm.bigram_match_score(x, 3, 7, 64) == \
            jlm.bigram_match_score(jnp.asarray(x), 3, 7, 64)
    assert tlm.bigram_match_score(toks, 3, 7, 64) > 0.8


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-780m"])
def test_stacked_critic_equals_per_user_calls(arch):
    _, cfg = _cfgs(arch)
    pair = tlm.make_lm_pair(cfg)
    gen = torch.Generator().manual_seed(0)
    users = [pair.init(gen, "cpu")[1] for _ in range(3)]
    stacked = tree_map(lambda *ls: torch.stack(ls), *users)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, 64, (3, 4, S)).astype(np.int32))
    soft = torch.softmax(torch.from_numpy(
        rng.normal(size=(4, S, 64)).astype(np.float32)), -1)
    with torch.no_grad():
        per_user = pair.d_apply(stacked, toks)
        shared = pair.d_apply(stacked, soft)
        for u in range(3):
            assert torch.equal(per_user[u], pair.d_apply(users[u], toks[u]))
            assert torch.equal(shared[u], pair.d_apply(users[u], soft))
            one_hot = torch.nn.functional.one_hot(toks[u].long(), 64).float()
            assert torch.equal(per_user[u], pair.d_apply(users[u], one_hot))
    assert per_user.shape == shared.shape == (3, 4)


def test_the_audio_family_cannot_be_a_critic():
    _, cfg = _cfgs("seamless-m4t-medium")
    with pytest.raises(ValueError, match="audio"):
        tlm.make_lm_pair(cfg)


def _np_state(state):
    return {f: jax.tree.map(np.asarray, getattr(state, f))
            for f in ("g", "g_opt", "ds", "d_opts", "server_d", "step")}


def test_one_approach2_round_matches_jitted_reference():
    jcfg, cfg = _cfgs("tinyllama-1.1b")
    jpair = jlm.make_lm_pair(jcfg)
    fcfg = japp.DistGANConfig(num_users=U)
    body = jax.jit(japp.make_approach2_body(jpair, fcfg))
    state = japp.init_state(jpair, fcfg, jax.random.key(0))
    rng = np.random.default_rng(2)
    s1, s2 = _streams(tlm)
    real = lambda: np.stack([s1(rng, B), s2(rng, B)])
    for _ in range(2):
        state, _ = body(state, jnp.asarray(real()))
    _, kz1, kz2 = jax.random.split(state.key, 3)
    z1 = np.array(jpair.sample_z(kz1, B))
    z2 = np.array(jpair.sample_z(kz2, B))
    before = _np_state(state)
    x = real()
    out, jm = body(state, jnp.asarray(x))
    want = _np_state(out)
    # the reference's floor: the same round from weights moved one ULP
    bump_rng = np.random.default_rng(0)

    def bump(a):
        to = np.where(bump_rng.random(a.shape) < 0.5, np.inf, -np.inf)
        return jnp.asarray(np.nextafter(np.asarray(a), to.astype(a.dtype)))

    nudged = state._replace(**{f: jax.tree.map(bump, getattr(state, f))
                               for f in ("g", "ds", "server_d")})
    floor = _np_state(body(nudged, jnp.asarray(x))[0])

    pair = tlm.make_lm_pair(cfg)
    step = tapp.make_approach2_step(pair, tapp.DistGANConfig(num_users=U))
    st, m = step(state_from_numpy(before, "cpu"), torch.from_numpy(x),
                 z1=torch.from_numpy(z1), z2=torch.from_numpy(z2))
    got = state_to_numpy(st)
    gap = lambda a, b: float(np.max(np.abs(np.asarray(a, np.float64)
                                           - np.asarray(b, np.float64))))
    for g, w, f in zip(jax.tree.leaves(got), jax.tree.leaves(want),
                       jax.tree.leaves(floor)):
        assert gap(g, w) <= max(ROUND_ATOL, ULP_FACTOR * gap(f, w)), \
            (gap(g, w), gap(f, w))
    for k in ("d_loss", "g_loss"):
        assert gap(m[k].numpy(), np.asarray(jm[k])) <= ROUND_ATOL


def test_integration_case_runs_through_the_port():
    """The reference's ``test_distgan_lm_integration_runs``."""
    for arch in ("tinyllama-1.1b", "mamba2-780m"):
        _, cfg = _cfgs(arch)
        r = run_distgan(tlm.make_lm_pair(cfg), tapp.DistGANConfig(
            num_users=2), _dataset(), "approach2", steps=6, batch_size=8,
            seed=0, eval_samples=16, device="cpu")
        assert np.all(np.isfinite(r.g_losses)), arch
        assert r.samples.shape == (16, 16, 64)


def _recording_pair(cfg):
    pair = tlm.make_lm_pair(cfg)
    seen = []

    def d_apply(params, x):
        if not x.is_floating_point():
            seen.append((x.dtype, tuple(x.shape)))
        return pair.d_apply(params, x)

    return dataclasses.replace(pair, d_apply=d_apply), seen


@pytest.mark.parametrize("path", ["full", "cohort", "host"])
def test_token_batches_reach_the_critic_as_int32(path):
    _, cfg = _cfgs("tinyllama-1.1b")
    pair, seen = _recording_pair(cfg)
    U4 = 4
    s = _streams(tlm)
    ds = FederatedDataset([s[u % 2] for u in range(U4)],
                          lambda rng, n: s[0](rng, n), {})
    kw = {}
    if path != "full":
        kw["participation"] = ParticipationSpec(scheduler="uniform",
                                                cohort_size=2)
    if path == "host":
        kw["backend"] = BackendSpec(kind="host")
    spec = FederationSpec("approach1", batch_size=4, eval_samples=0,
                          engine=EngineSpec(rounds_per_jit=2), **kw)
    sess = FederationSession(pair, tapp.DistGANConfig(num_users=U4), ds,
                             spec, device="cpu")
    res = sess.run(3)
    assert np.all(np.isfinite(res.g_losses))
    C = U4 if path == "full" else 2
    assert seen and set(seen) == {(torch.int32, (C, 4, S))}, set(seen)


def test_trained_critic_serves_through_attach_lm():
    from repro.core.spec import DecodeSpec as JDecodeSpec
    from repro.serve.decode import DecodeEngine as JEngine
    from repro.serve.decode import DecodeRequest as JRequest
    from repro_torch.serve import GenerationService

    jcfg, cfg = _cfgs("tinyllama-1.1b")
    pair = tlm.make_lm_pair(cfg)
    sess = FederationSession(
        pair, tapp.DistGANConfig(num_users=2), _dataset(),
        FederationSpec("approach1", batch_size=8, eval_samples=0,
                       decode=DecodeSpec(slots=2, max_seq=24)),
        device="cpu")
    res = sess.run(3)
    critic = tlm.critic_lm_params(res.state.server_d)
    assert "head" not in critic and "head" in res.state.server_d
    lm_cfg = tlm.critic_lm_config(cfg)
    assert lm_cfg.tie_embeddings
    svc = GenerationService.from_session(sess)
    svc.attach_lm(lm_cfg, critic)
    prompts = [np.arange(1, 7, dtype=np.int32),
               np.array([5, 9, 33, 2], np.int32)]
    futs = [svc.submit_decode(i, p, 8, request_id=i)
            for i, p in enumerate(prompts)]
    svc.drain()

    jparams = jax.tree.map(jnp.asarray, jax.tree.map(
        lambda t: t.detach().numpy(), critic))
    jlm_cfg = jlm.critic_lm_config(jcfg)
    jeng = JEngine(jlm_cfg, jparams, JDecodeSpec(slots=2, max_seq=24))
    jf = [jeng.submit(JRequest(user_id=i, prompt=p, max_new=8))
          for i, p in enumerate(prompts)]
    jeng.drain()
    step = jax.jit(lambda p, c, t, i: JM.decode_step(p, c, t, i, jlm_cfg))
    for p, fut, want in zip(prompts, futs, jf):
        toks = fut.result()
        np.testing.assert_array_equal(toks, want.result())
        seq = np.concatenate([p, toks])[None]
        jc = JM.init_cache(jlm_cfg, 1, seq.shape[1])
        tc = TM.init_cache(lm_cfg, 1, seq.shape[1], device="cpu")
        with torch.no_grad():
            for i in range(seq.shape[1] - 1):
                jl, jc = step(jparams, jc, seq[:, i:i + 1], jnp.int32(i))
                tl, tc = TM.decode_step(critic, tc, torch.from_numpy(
                    seq[:, i:i + 1].copy()), i, lm_cfg)
                np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                           rtol=0, atol=1e-4)
    assert all(np.isfinite(tree_leaves(critic)[0].numpy()).ravel())
