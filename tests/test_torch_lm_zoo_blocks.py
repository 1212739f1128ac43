"""The blocks of the rest of the LM zoo (``repro_torch.models``) held to the
JAX reference on the CPU, at reduced size, on the reference's weights
(carried across with ``params_from_numpy``) and seeded numpy inputs: the
RG-LRU gates, scan, block and decode, MLA's forward and absorbed decode
with per-row positions, cross-attention, ``blockwise_sdpa`` and the
encoder; B3's plain version at head dim 256 against the reference's Pallas
kernel in interpret mode; and the elementwise forms the port evaluates on
the CPU as the reference's jitted XLA does.  The reference runs jitted, as
its models do.  Each tolerance is relative to the output's scale, about 3x
what was measured (stated per test); the families as a whole are held in
``test_torch_zoo.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import attention as jattn
from repro.models import model as JM
from repro.models import rglru as jrglru
from repro.models import transformer as JT
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import rglru as trglru
from repro_torch.models import transformer as TT
from repro_torch.models.common import tree_map


def _cfgs(arch, **kw):
    return (dataclasses.replace(jget_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


def _params(jcfg, seed):
    jp = JM.init_params(jcfg, jax.random.key(seed))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _layer(jtree, ttree, i=0):
    return (jax.tree.map(lambda a: a[i], jtree),
            tree_map(lambda a: a[i], ttree))


def _scaled_close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, (err, scale, err / scale)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def test_rglru_scan_and_block_match_reference():
    """The doubling scan against jax.lax.associative_scan (another tree
    order: within 2e-6 of scale), the gates within 1e-6 of scale (their
    r x r products summed in another order; exp, sigmoid and log-sigmoid
    are XLA's), the block within 3e-6 of its scale (measured 1.4e-6).  The
    reference runs jitted, as its models do: XLA turns a * a into exp(2
    log a) there, which the port follows."""
    jcfg, tcfg = _cfgs("recurrentgemma-9b")
    jp, tp = _params(jcfg, 0)
    jl, tl = _layer(jp["groups"]["sub0"]["rec"], tp["groups"]["sub0"]["rec"])
    u = _x((2, 37, jcfg.lru_width), 1)
    for j, t in zip(jax.jit(jrglru._gates)(jl, jnp.asarray(u)),
                    trglru._gates(tl, torch.from_numpy(u))):
        _scaled_close(t.numpy(), j, 1e-6)
    _scaled_close(trglru.rglru_scan(tl, torch.from_numpy(u)).numpy(),
                  jax.jit(jrglru.rglru_scan)(jl, jnp.asarray(u)), 2e-6)
    x = _x((2, 37, jcfg.d_model), 2)
    _scaled_close(trglru.rglru_block_forward(tl, torch.from_numpy(x),
                                             tcfg).numpy(),
                  jax.jit(lambda p, x: jrglru.rglru_block_forward(
                      p, x, jcfg))(jl, jnp.asarray(x)), 3e-6)


def test_rglru_decode_steps_equal_the_block_and_the_reference():
    """Step by step from a zero state: the port's decode equals its own
    block forward (1e-6 of scale) and the reference's jitted decode, state
    included (1e-5 of scale)."""
    jcfg, tcfg = _cfgs("recurrentgemma-9b")
    jp, tp = _params(jcfg, 3)
    jl, tl = _layer(jp["groups"]["sub1"]["rec"], tp["groups"]["sub1"]["rec"])
    B, S, r, W = 2, 12, jcfg.lru_width, jcfg.conv_width
    x = _x((B, S, jcfg.d_model), 4)
    js = {"h": jnp.zeros((B, r)), "conv": jnp.zeros((B, W - 1, r))}
    ts = {"h": torch.zeros((B, r)), "conv": torch.zeros((B, W - 1, r))}
    outs = []
    step = jax.jit(lambda p, x, s: jrglru.rglru_block_decode(p, x, jcfg, s))
    for i in range(S):
        jy, js = step(jl, jnp.asarray(x[:, i:i + 1]), js)
        ty, ts = trglru.rglru_block_decode(tl, torch.from_numpy(
            x[:, i:i + 1]), tcfg, ts)
        _scaled_close(ty.numpy(), jy, 1e-5)
        outs.append(ty)
    for k in ("h", "conv"):
        _scaled_close(ts[k].numpy(), js[k], 1e-5)
    _scaled_close(torch.cat(outs, 1).numpy(), trglru.rglru_block_forward(
        tl, torch.from_numpy(x), tcfg).numpy(), 1e-6)


# ---------------------------------------------------------------------------
# attention: MLA, cross-attention, blockwise, the encoder
# ---------------------------------------------------------------------------

def test_mla_forward_and_decode_with_per_row_positions():
    """mla_forward against the reference; mla_decode against the
    reference's at one position, and with one position per row equal to
    each row decoded alone at its own (the engine's slots); 5e-5 of scale
    (measured 1.4e-5 forward, 3.5e-6 decode)."""
    jcfg, tcfg = _cfgs("deepseek-v2-lite-16b")
    jp, tp = _params(jcfg, 5)
    ja, ta = _layer(jp["layers"]["attn"], tp["layers"]["attn"])
    B, S, T = 3, 16, 12
    x = _x((B, S, jcfg.d_model), 6)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    _scaled_close(tattn.mla_forward(ta, torch.from_numpy(x), tcfg,
                                    positions=torch.from_numpy(pos)).numpy(),
                  jax.jit(lambda p, x, q: jattn.mla_forward(
                      p, x, jcfg, positions=q))(ja, jnp.asarray(x),
                                                jnp.asarray(pos)), 5e-5)
    cache = {"c_kv": _x((B, T, jcfg.kv_lora_rank), 7),
             "k_rope": _x((B, T, jcfg.rope_head_dim), 8)}
    xt = _x((B, 1, jcfg.d_model), 9)
    jy, jc = jax.jit(lambda p, x, c: jattn.mla_decode(p, x, jcfg, c, 5))(
        ja, jnp.asarray(xt), jax.tree.map(jnp.asarray, cache))
    tc = {k: torch.from_numpy(v) for k, v in cache.items()}
    ty, tcn = tattn.mla_decode(ta, torch.from_numpy(xt), tcfg, tc, 5)
    _scaled_close(ty.numpy(), jy, 1e-5)
    for k in cache:
        _scaled_close(tcn[k].numpy(), jc[k], 1e-5)
    rows = torch.tensor([0, 6, 11])
    ty, tcn = tattn.mla_decode(ta, torch.from_numpy(xt), tcfg, tc, rows)
    for b in range(B):
        one = {k: v[b:b + 1] for k, v in tc.items()}
        yb, cb = tattn.mla_decode(ta, torch.from_numpy(xt[b:b + 1]), tcfg,
                                  one, int(rows[b]))
        _scaled_close(yb[0].numpy(), ty[b].numpy(), 1e-5)
        for k in cache:
            _scaled_close(cb[k][0].numpy(), tcn[k][b].numpy(), 1e-6)


def test_cross_attention_blockwise_and_encoder_match_reference():
    """Cross-attention and attention through blockwise_sdpa within 3e-5 of
    scale (measured 1.1e-5), the two-layer encoder within 1e-4 (3.0e-5);
    blockwise_sdpa itself within 2e-6 of the reference's and of the
    port's dense sdpa."""
    jcfg, tcfg = _cfgs("seamless-m4t-medium")
    jp, tp = _params(jcfg, 10)
    jd, td = _layer(jp["decoder"], tp["decoder"])
    x, enc = _x((2, 12, jcfg.d_model), 11), _x((2, 5, jcfg.d_model), 12)
    _scaled_close(tattn.cross_attn_forward(
        td["cross"], torch.from_numpy(x), torch.from_numpy(enc),
        tcfg).numpy(), jax.jit(lambda p, x, e: jattn.cross_attn_forward(
            p, x, e, jcfg))(jd["cross"], jnp.asarray(x), jnp.asarray(enc)),
        3e-5)
    src = _x((2, 16, jcfg.d_model), 13)
    pos = np.tile(np.arange(16, dtype=np.int32), (2, 1))
    _scaled_close(TT.encoder_forward(tp, torch.from_numpy(src), tcfg,
                                     torch.from_numpy(pos)).numpy(),
                  jax.jit(lambda p, s, q: JT.encoder_forward(p, s, jcfg, q))(
                      jp, jnp.asarray(src), jnp.asarray(pos)), 1e-4)
    q, k, v = _x((2, 64, 4, 16), 14), _x((2, 64, 2, 16), 15), \
        _x((2, 64, 2, 16), 16)
    for causal, window in ((True, 0), (True, 24), (False, 0)):
        got = tattn.blockwise_sdpa(*map(torch.from_numpy, (q, k, v)), 0.25,
                                   causal=causal, window=window, block=16)
        want = jax.jit(lambda q, k, v: jattn.blockwise_sdpa(
            q, k, v, 0.25, causal=causal, window=window, block=16))(
            *map(jnp.asarray, (q, k, v)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)
        mask = tattn.causal_mask(64, 64, window=window) if causal else \
            torch.ones((1, 1, 1, 64, 64), dtype=torch.bool)
        np.testing.assert_allclose(got.numpy(), tattn.sdpa(
            *map(torch.from_numpy, (q, k, v)), mask, 0.25).numpy(),
            atol=2e-6)
    tcfg_b = dataclasses.replace(tcfg, attn_impl="blockwise", attn_block=4)
    jcfg_b = dataclasses.replace(jcfg, attn_impl="blockwise", attn_block=4)
    pos = np.tile(np.arange(12, dtype=np.int32), (2, 1))
    _scaled_close(tattn.attn_forward(
        td["attn"], torch.from_numpy(x), tcfg_b,
        positions=torch.from_numpy(pos)).numpy(), jax.jit(
            lambda p, x, q: jattn.attn_forward(p, x, jcfg_b, positions=q))(
            jd["attn"], jnp.asarray(x), jnp.asarray(pos)), 3e-5)


# ---------------------------------------------------------------------------
# the flash kernel's plain version at head dim 256
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window", [(True, 64), (True, 0),
                                           (False, 0)])
def test_flash_plain_at_hd_256_matches_reference_pallas(causal, window):
    """recurrentgemma-9b's attention shape, cut in length: MQA (16 heads
    over 1), hd 256, sliding window; the plain version against the
    reference's Pallas kernel in interpret mode and its oracle, at the
    f32 tolerance of tests/test_kernels.py."""
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro_torch.kernels import ops
    q, k, v = _x((1, 128, 16, 256), 20), _x((1, 128, 1, 256), 21), \
        _x((1, 128, 1, 256), 22)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=causal, window=window, bq=64,
                              bkv=64).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    np.testing.assert_allclose(got, np.asarray(jops.flash_attention(
        jq, jk, jv, causal=causal, window=window, bq=64, bkv=64)), atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(jref.flash_attention_ref(
        jq, jk, jv, causal=causal, window=window)), atol=2e-5)


# ---------------------------------------------------------------------------
# the elementwise forms on the CPU
# ---------------------------------------------------------------------------

def test_xla_elementwise_forms_bitwise_and_position_free():
    """On the CPU tanh (gelu, softcap), exp, sigmoid and silu are the
    reference's jitted formulas, bit for bit (log-sigmoid and softplus
    within an ULP: XLA's log1p above sqrt(2) - 1), and every elementwise
    function on the decode path gives a row the same bits wherever it sits
    in the batch, also across the chunks of torch's CPU threads (torch's
    own CPU sigmoid, gelu and exp do not)."""
    from repro_torch.models import common as tcommon
    # above torch's grain (32,768 elements), so more than one thread chunk
    x = _x((40003,), 30, 5.0)
    jx = jnp.asarray(x)
    for fn, want in ((tcommon.tanh, jnp.tanh), (tcommon.exp, jnp.exp),
                     (tcommon.sigmoid, jax.nn.sigmoid),
                     (tcommon.activation("gelu"), jax.nn.gelu),
                     (tcommon.silu, jax.nn.silu)):
        np.testing.assert_array_equal(fn(torch.from_numpy(x)).numpy(),
                                      np.asarray(jax.jit(want)(jx)))
    for fn, want in ((tcommon.log_sigmoid, jax.nn.log_sigmoid),
                     (tcommon.softplus, jax.nn.softplus)):
        np.testing.assert_allclose(fn(torch.from_numpy(x)).numpy(),
                                   np.asarray(jax.jit(want)(jx)),
                                   rtol=2.5e-7, atol=0)
    t = torch.from_numpy(x)
    for fn in (tcommon.tanh, tcommon.exp, tcommon.sigmoid,
               tcommon.log_sigmoid, tcommon.activation("gelu"),
               tcommon.silu, tcommon.softplus):
        whole = fn(t)
        for off in (1, 7):
            assert torch.equal(fn(t[off:]), whole[off:])
        assert torch.equal(torch.stack([fn(t[i:i + 1])[0]
                                        for i in range(16)]), whole[:16])
