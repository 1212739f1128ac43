"""The rest of the LM zoo on the port (``repro_torch.models``) held to the
JAX reference on the CPU, at reduced size: the forward, loss and decode of
the MoE (deepseek-moe-16b), MoE + MLA (deepseek-v2-lite-16b), hybrid
(recurrentgemma-9b) and audio (seamless-m4t-medium) families; their cache
layouts; the continuous-batching engine against the reference's; audio
``greedy_decode``.  Their blocks (RG-LRU, MLA, cross-attention,
``blockwise_sdpa``, the encoder), B3's plain version at head dim 256 and
the CPU's elementwise forms are held in ``test_torch_lm_zoo_blocks.py``.

Weights are the reference's, carried across with ``params_from_numpy``;
inputs are seeded numpy.  On the CPU the port evaluates tanh, exp,
sigmoid, silu, log-sigmoid and softplus in XLA's own formulas, and the
RG-LRU gate's 1 - a^2 as the reference's jitted program does (1 - exp(2
log a)), so what remains is f32 summation order in the matmuls (oneDNN's
against XLA's) and XLA's own norms and softmax, which the random-init
stacks amplify (a stacked weight's fan-in is its leading (layer) dim, so
its std is 1/sqrt(layers) and the residual stream reaches 1e3-1e4).
Tolerances (atol on logits of scale ~1.3, ``TOL``; measured on a CPU in
brackets): MoE 2e-4 [forward 6.5e-5, decode 2.4e-6], MoE +
MLA 2e-4 [3.2e-5, 5.5e-6], the hybrid 2e-4 [7.9e-6, 5.1e-6], audio 5e-4
[1.3e-4, 2.8e-4].

Decode is held as ``tests/test_torch_decode.py`` holds it: against the
reference within ULP_FACTOR x the reference's rounding floor, how far its
decode logits move when every weight moves one ULP (7e-6 to 1.2e-4 by
family), and against its own forward within the reference's
test_decode.py bound (2e-3; MoE at capacity factor 8, so routing is
dropless both ways) and within ULP_FACTOR x the larger of the
reference's floor and its own decode-vs-forward gap.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import model as JM
from repro.models.cache import cache_nbytes as jcache_nbytes
from repro.models.cache import cache_spec as jcache_spec
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.spec import DecodeSpec
from repro_torch.models import model as TM
from repro_torch.models.cache import cache_nbytes, cache_spec
from repro_torch.models.common import tree_leaves
from repro_torch.serve.decode import DecodeEngine, DecodeRequest

ZOO = ("deepseek-moe-16b", "deepseek-v2-lite-16b", "recurrentgemma-9b",
       "seamless-m4t-medium")
# atol of the forward / decode logits (see the module docstring)
TOL = {"deepseek-moe-16b": 2e-4, "deepseek-v2-lite-16b": 2e-4,
       "recurrentgemma-9b": 2e-4, "seamless-m4t-medium": 5e-4}
ULP_FACTOR = 3


def _cfgs(arch, **kw):
    return (dataclasses.replace(jget_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


def _params(jcfg, seed):
    jp = JM.init_params(jcfg, jax.random.key(seed))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _batch(jcfg, B, S, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    out = {"tokens": toks, "targets": rng.integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)}
    if jcfg.arch_type == "audio":
        out["src_embeds"] = _x((B, S // jcfg.encoder_downsample,
                                jcfg.d_model), seed + 1)
    return out


# ---------------------------------------------------------------------------
# the families: forward, loss, decode, caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ZOO)
def test_forward_and_loss_match_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    rng = np.random.default_rng(1)
    # leaves the reference initialises to zero (biases, norm scales - 1)
    # get small random values, so that their use is checked too
    params = jax.tree.map(
        lambda a: a if np.any(a) else (0.1 * rng.normal(size=a.shape)
                                       ).astype(a.dtype),
        jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.key(0))))
    jp = jax.tree.map(jnp.asarray, params)
    tp = params_from_numpy(params, "cpu", tcfg.param_dtype)
    batch = _batch(jcfg, 2, 32, 2)
    fwd = jax.jit(lambda p, b: JM.forward(p, b, jcfg)[0])
    jlogits = np.asarray(fwd(jp, jax.tree.map(jnp.asarray, batch)))
    with torch.no_grad():
        tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
        tlogits, aux = TM.forward(tp, tbatch, tcfg)
        tloss, tm = TM.loss_fn(tp, tbatch, tcfg)
    assert tlogits.dtype == torch.float32
    np.testing.assert_allclose(tlogits.numpy(), jlogits, rtol=0,
                               atol=TOL[arch])
    jloss, jm = JM.loss_fn(jp, jax.tree.map(jnp.asarray, batch), jcfg)
    np.testing.assert_allclose(float(tm["ce"]), float(jm["ce"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    assert (float(aux) > 0) == (jcfg.arch_type == "moe")


def _nudged(tree):
    """Every f32 leaf moved by one ULP toward +inf."""
    return jax.tree.map(lambda a: jnp.asarray(np.nextafter(
        np.asarray(a), np.float32(np.inf))), tree)


def _decode(arch, **kw):
    """Token by token (B 2, S 16, the reference's test_decode.py case; the
    audio family with its cross cache from src_embeds): the port's and the
    reference's jitted decode_step logits, both forwards, both final
    caches and the reference's rounding floor (the most its logits move
    when every weight moves one ULP)."""
    jcfg, tcfg = _cfgs(arch, **kw)
    jp, tp = _params(jcfg, 1)
    B, S = 2, 16
    batch = _batch(jcfg, B, S, 3)
    toks = batch["tokens"]
    jnudged = _nudged(jp)
    jc, tc = JM.init_cache(jcfg, B, S), TM.init_cache(tcfg, B, S)
    nc = JM.init_cache(jcfg, B, S)
    if jcfg.arch_type == "audio":
        src = batch["src_embeds"]
        jc = JM.prefill_audio_cache(jp, jc, jnp.asarray(src), jcfg)
        nc = JM.prefill_audio_cache(jnudged, nc, jnp.asarray(src), jcfg)
        tc = TM.prefill_audio_cache(tp, tc, torch.from_numpy(src), tcfg)
    step = jax.jit(lambda p, c, t, i: JM.decode_step(p, c, t, i, jcfg))
    outs, jouts, floor = [], [], 0.0
    with torch.no_grad():
        for i in range(S):
            jl, jc = step(jp, jc, toks[:, i:i + 1], jnp.int32(i))
            nl, nc = step(jnudged, nc, toks[:, i:i + 1], jnp.int32(i))
            tl, tc = TM.decode_step(tp, tc, torch.from_numpy(
                toks[:, i:i + 1]), i, tcfg)
            floor = max(floor, float(np.abs(np.asarray(nl - jl)).max()))
            outs.append(tl[:, 0].numpy())
            jouts.append(np.asarray(jl)[:, 0])
        tfull = TM.forward(tp, {k: torch.from_numpy(v)
                                for k, v in batch.items()}, tcfg)[0].numpy()
    jfull = np.asarray(jax.jit(lambda p, b: JM.forward(p, b, jcfg)[0])(
        jp, jax.tree.map(jnp.asarray, batch)))
    return (np.stack(outs, 1), np.stack(jouts, 1), tfull, jfull, jc, tc,
            floor)


@pytest.mark.parametrize("arch", ZOO)
def test_decode_matches_reference_and_forward(arch):
    """decode_step token by token against the reference's (logits and every
    cache leaf) and against the forward, by the bounds of the module
    docstring."""
    kw = {"capacity_factor": 8.0} if "deepseek" in arch else {}
    dec, jdec, fwd, jfwd, jc, tc, floor = _decode(arch, **kw)
    np.testing.assert_allclose(dec, jdec, rtol=0, atol=TOL[arch])
    assert np.abs(dec - jdec).max() <= ULP_FACTOR * floor
    for j, t in zip(jax.tree.leaves(jc), tree_leaves(tc)):
        scale = max(float(np.abs(np.asarray(j)).max()), 1.0)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=TOL[arch] * scale)
    assert np.abs(dec - fwd).max() < 2e-3
    assert np.abs(dec - fwd).max() <= ULP_FACTOR * max(
        floor, np.abs(jdec - jfwd).max())


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ZOO)
def test_cache_layouts_equal_the_references(arch, reduced):
    """cache_spec (every leaf's shape and dtype) and cache_nbytes equal the
    reference's; at full width as the engine's 8 x 256 pool; the hybrid's
    attention cache is the window, not max_seq."""
    jcfg, tcfg = jget_config(arch), get_config(arch)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    for B, T in ((2, 16), (8, 256), (1, 4096)):
        jspec, tspec = jcache_spec(jcfg, B, T), cache_spec(tcfg, B, T)
        jl = jax.tree_util.tree_flatten_with_path(jspec)[0]
        tl = jax.tree_util.tree_flatten_with_path(tspec)[0]
        assert [tuple(str(k.key) for k in p) for p, _ in jl] == \
            [tuple(str(k.key) for k in p) for p, _ in tl]
        for (_, j), (_, t) in zip(jl, tl):
            assert t.shape == j.shape
            assert str(t.dtype).split(".")[-1] == str(j.dtype)
        assert cache_nbytes(tcfg, B, T) == jcache_nbytes(jcfg, B, T)
    if tcfg.arch_type == "hybrid":
        assert cache_spec(tcfg, 2, 524288)["groups"]["attn"]["k"].shape[2] \
            == tcfg.window
    alloc = sum(t.numel() * t.element_size()
                for t in tree_leaves(TM.init_cache(get_config(arch).reduced(),
                                                   3, 24, device="cpu")))
    assert alloc == cache_nbytes(get_config(arch).reduced(), 3, 24)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _requests(cfg, n, seed):
    """Prompts of 2-8 tokens (one prefill bucket, one program to build in
    each engine), 2-5 new tokens."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, cfg.vocab_size, int(pl)).astype(np.int32),
             int(g)) for pl, g in zip(rng.integers(2, 9, n),
                                      rng.integers(2, 6, n))]


@pytest.mark.parametrize("arch", ZOO[:3])
def test_engine_tokens_equal_reference_engine(arch):
    """Greedy pooled tokens of the hybrid and both MoE families equal the
    reference engine's (which routes each slot's token alone, under vmap)
    on the same weights and requests, and the engine's own replay; reverse
    submission order (other slots, other batch-mates) gives the same
    bytes."""
    from repro.core.spec import DecodeSpec as JaxDecodeSpec
    from repro.serve.decode import DecodeEngine as JaxEngine
    from repro.serve.decode import DecodeRequest as JaxRequest
    jcfg, cfg = _cfgs(arch)
    jp, params = _params(jcfg, 1)
    reqs = _requests(cfg, 4, seed=2)
    jeng = JaxEngine(jcfg, jp, JaxDecodeSpec(slots=2, max_seq=16))
    eng = DecodeEngine(cfg, params, DecodeSpec(slots=2, max_seq=16),
                       device="cpu")
    jf = [jeng.submit(JaxRequest(user_id=i, prompt=p, max_new=g))
          for i, (p, g) in enumerate(reqs)]
    tf = {i: eng.submit(DecodeRequest(user_id=i, prompt=p, max_new=g),
                        request_id=i) for i, (p, g) in enumerate(reqs)}
    jeng.drain()
    eng.drain()
    rev = {i: eng.submit(DecodeRequest(user_id=i, prompt=reqs[i][0],
                                       max_new=reqs[i][1]), request_id=i)
           for i in reversed(range(len(reqs)))}
    eng.drain()
    for rid, (p, g) in enumerate(reqs):
        out = tf[rid].result()
        np.testing.assert_array_equal(out, jf[rid].result())
        np.testing.assert_array_equal(out, rev[rid].result())
        np.testing.assert_array_equal(out, eng.replay(p, g, request_id=rid))


def test_engine_refuses_audio_and_greedy_decode_serves_it():
    """The audio family decodes through greedy_decode with its source
    embeddings (equal tokens to the reference's), not through the engine,
    as in the reference."""
    from repro.launch.serve import greedy_decode as jgreedy
    from repro_torch.launch.serve import greedy_decode
    jcfg, cfg = _cfgs("seamless-m4t-medium")
    jp, params = _params(jcfg, 2)
    with pytest.raises(NotImplementedError, match="greedy_decode"):
        DecodeEngine(cfg, params, DecodeSpec(slots=2, max_seq=16),
                     device="cpu")
    prompt = np.random.default_rng(4).integers(
        1, cfg.vocab_size, (2, 6)).astype(np.int32)
    src = _x((2, 3, cfg.d_model), 5)
    want = np.asarray(jgreedy(jcfg, jp, jnp.asarray(prompt), 5,
                              src_embeds=jnp.asarray(src)))
    got = greedy_decode(cfg, params, torch.from_numpy(prompt).long(), 5,
                        src_embeds=torch.from_numpy(src))
    np.testing.assert_array_equal(got.numpy(), want)
