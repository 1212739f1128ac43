"""The port's LM forward (``repro_torch.models``) held to the JAX reference
on the CPU: each module on the same parameters (carried across with
``params_from_numpy``) and inputs, and the whole prefill forward of the
reduced ``tinyllama-1.1b`` and ``mamba2-780m`` with the kernel flags on.
On the CPU the port's kernel flags take the kernels' plain versions; the
reference runs its Pallas kernels in interpret mode.  Tolerances are the
reference's own for the flag-on forwards (``tests/test_kernels.py``)."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as jget_config
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import mlp as jmlp
from repro.models import model as JM
from repro.models import ssm as jssm
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import mlp as tmlp
from repro_torch.models import model as TM
from repro_torch.models import ssm as tssm

ROOT = Path(__file__).resolve().parents[1]


def _cfgs(arch, chunk=None):
    j, t = jget_config(arch).reduced(), get_config(arch).reduced()
    if chunk:
        j = dataclasses.replace(j, chunk_size=chunk)
        t = dataclasses.replace(t, chunk_size=chunk)
    return j, t


def _layer0_params(jcfg, tcfg, seed=0):
    """Layer 0 of the reference's init, as (jax tree, port tree)."""
    jp = jax.tree.map(lambda a: a[0], JM.init_params(
        jcfg, jax.random.key(seed))["layers"])
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                                 tcfg.param_dtype)


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got.detach().numpy()),
                               np.asarray(want), atol=atol, rtol=rtol)


def _close_to_scale(got, want, rel):
    """max |got - want| <= rel * max |want|.  The reference's init draws a
    stacked weight with std 1/sqrt(layers) (its fan-in is the leading layer
    dim), so a reduced block's activations reach 1e2-1e4 and f32
    summation-order differences grow with them; the SSM block adds
    exp(cum_i - cum_j) over cumulative sums in the hundreds."""
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, (err, scale, err / scale)


# ---------------------------------------------------------------------------
# common
# ---------------------------------------------------------------------------

def test_norms_match_reference():
    x = _x((2, 8, 32), 0, 3.0)
    scale, bias = _x((32,), 1, 0.5), _x((32,), 2, 0.5)
    _close(tcommon.rms_norm(torch.from_numpy(x), torch.from_numpy(scale),
                            1e-6),
           jcommon.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6), 1e-6)
    _close(tcommon.layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                              torch.from_numpy(bias), 1e-5),
           jcommon.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                              jnp.asarray(bias), 1e-5), 1e-6)


@pytest.mark.parametrize("heads", [True, False])
def test_apply_rope_matches_reference(heads):
    shape = (2, 8, 4, 16) if heads else (2, 8, 16)
    x = _x(shape, 3)
    pos = np.tile(np.arange(8, dtype=np.int32) * 37, (2, 1))
    _close(tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                              10000.0),
           jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0),
           2e-6)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def test_mlp_forward_matches_reference():
    jcfg, tcfg = _cfgs("tinyllama-1.1b")
    jp, tp = _layer0_params(jcfg, tcfg)
    x = _x((2, 16, jcfg.d_model), 4)
    _close_to_scale(tmlp.mlp_forward(tp["mlp"], torch.from_numpy(x), tcfg),
           jmlp.mlp_forward(jp["mlp"], jnp.asarray(x), jcfg), 1e-5)


@pytest.mark.parametrize("use_flash", [False, True])
def test_attn_forward_matches_reference(use_flash):
    jcfg, tcfg = _cfgs("tinyllama-1.1b")
    jp, tp = _layer0_params(jcfg, tcfg)
    x = _x((2, 32, jcfg.d_model), 5)
    pos = np.tile(np.arange(32, dtype=np.int32), (2, 1))
    got = tattn.attn_forward(tp["attn"], torch.from_numpy(x), tcfg,
                             positions=torch.from_numpy(pos),
                             use_flash=use_flash)
    want = jattn.attn_forward(jp["attn"], jnp.asarray(x), jcfg,
                              positions=jnp.asarray(pos),
                              use_flash=use_flash)
    _close_to_scale(got, want, 2e-5)


def test_causal_conv1d_matches_reference():
    x, w = _x((2, 24, 12), 6), _x((4, 12), 7)
    _close(tssm.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w)),
           jssm.causal_conv1d(jnp.asarray(x), jnp.asarray(w)), 1e-6)


def test_ssd_chunked_matches_reference_with_tail_padding():
    """S = 40 is not a multiple of the chunk (16): the tail is padded."""
    rng = np.random.default_rng(8)
    B, S, H, P, G, N = 2, 40, 4, 16, 2, 8
    x = (rng.normal(size=(B, S, H, P)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, S, H)))).astype(np.float32)
    A = -np.exp(rng.uniform(0.0, 1.0, size=(H,))).astype(np.float32)
    Bm = (rng.normal(size=(B, S, G, N)) * 0.3).astype(np.float32)
    Cm = (rng.normal(size=(B, S, G, N)) * 0.3).astype(np.float32)
    y, state = tssm.ssd_chunked(*map(torch.from_numpy, (x, dt, A, Bm, Cm)),
                                16)
    jy, jstate = jssm.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), 16)
    assert tuple(y.shape) == (B, S, H, P)
    _close(y, jy, 1e-5, 1e-5)
    _close(state, jstate, 1e-5, 1e-5)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_ssm_forward_matches_reference(use_kernel):
    jcfg, tcfg = _cfgs("mamba2-780m", chunk=16)
    jp, tp = _layer0_params(jcfg, tcfg, seed=1)
    x = _x((2, 32, jcfg.d_model), 9)
    got = tssm.ssm_forward(tp["ssm"], torch.from_numpy(x), tcfg,
                           use_kernel=use_kernel)
    want = jssm.ssm_forward(jp["ssm"], jnp.asarray(x), jcfg,
                            use_kernel=use_kernel)
    _close_to_scale(got, want, 5e-5)


# ---------------------------------------------------------------------------
# the slice as a whole: prefill forward and loss with the kernels on
# ---------------------------------------------------------------------------

_SLICE = [("tinyllama-1.1b", None, "use_flash", 2e-4, 0.0),
          ("mamba2-780m", 16, "use_ssm_kernel", 5e-4, 1e-4),
          # the other dense / vlm features: QKV bias, QK-norm, LayerNorm
          ("qwen2-72b", None, "use_flash", 2e-4, 0.0),
          ("chameleon-34b", None, "use_flash", 2e-4, 0.0),
          ("stablelm-1.6b", None, "use_flash", 2e-4, 0.0)]


@pytest.mark.parametrize("arch,chunk,flag,atol,rtol", _SLICE,
                         ids=[s[0] for s in _SLICE])
def test_forward_and_loss_match_reference(arch, chunk, flag, atol, rtol):
    jcfg, tcfg = _cfgs(arch, chunk)
    rng = np.random.default_rng(1)
    # leaves the reference initialises to zero (biases, norm scales - 1,
    # dt_bias) get small random values, so that their use is checked too
    params = jax.tree.map(
        lambda a: a if np.any(a) else (0.1 * rng.normal(size=a.shape)
                                       ).astype(a.dtype),
        jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.key(0))))
    jp = jax.tree.map(jnp.asarray, params)
    tp = params_from_numpy(params, "cpu", tcfg.param_dtype)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    targets = rng.integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(tokens), "targets": jnp.asarray(targets)}
    tbatch = {"tokens": torch.from_numpy(tokens),
              "targets": torch.from_numpy(targets)}
    jlogits, _ = JM.forward(jp, jbatch, jcfg, **{flag: True})
    tlogits, aux = TM.forward(tp, tbatch, tcfg, **{flag: True})
    assert tlogits.dtype == torch.float32 and float(aux) == 0.0
    _close(tlogits, jlogits, atol, rtol)
    jloss, jm = JM.loss_fn(jp, jbatch, jcfg, **{flag: True})
    tloss, tm = TM.loss_fn(tp, tbatch, tcfg, **{flag: True})
    np.testing.assert_allclose(float(tm["ce"]), float(jm["ce"]), rtol=1e-5)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------

def _decl_table(decls, leaf_type):
    out = {}

    def walk(tree, path):
        if isinstance(tree, leaf_type):
            out[path] = (tuple(tree.shape), tree.init, tree.scale)
            return
        for k in tree:
            walk(tree[k], path + (k,))

    walk(decls, ())
    return out


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-780m",
                                  "qwen2-72b", "chameleon-34b"])
def test_model_decls_match_reference(arch, reduced):
    """Same key paths, shapes and initialisers as the reference's tree, from
    the declarations alone (nothing is allocated at full width)."""
    jcfg, tcfg = jget_config(arch), get_config(arch)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert _decl_table(TM.model_decls(tcfg), tcommon.P) == \
        _decl_table(JM.model_decls(jcfg), jcommon.P)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-780m"])
def test_init_params_tree_matches_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jp = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.key(0)))
    tp = params_to_numpy(TM.init_params(tcfg, 0, device="cpu"))
    jleaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    tflat = {tuple(str(k.key) for k in path): leaf
             for path, leaf in jax.tree_util.tree_flatten_with_path(tp)[0]}
    assert len(jleaves) == len(tflat)
    for path, leaf in jleaves:
        t = tflat[tuple(str(k.key) for k in path)]
        assert t.shape == leaf.shape and t.dtype == leaf.dtype
    a_log = tp["layers"]["ssm"]["A_log"] if arch == "mamba2-780m" else None
    if a_log is not None:     # log of uniform(1, 16), as the reference draws
        assert np.all(a_log >= 0.0) and np.all(a_log <= np.log(16.0))


def test_unported_families_raise():
    for arch in ("deepseek-moe-16b", "recurrentgemma-9b",
                 "seamless-m4t-medium", "deepseek-v2-lite-16b"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TM.model_decls(get_config(arch).reduced())


def test_params_round_trip_through_numpy():
    """Nested trees of any depth; bf16 leaves from JAX (ml_dtypes) arrive
    without ml_dtypes in the port; the config's param dtype is applied."""
    rng = np.random.default_rng(0)
    tree = {"a": {"b": {"c": rng.normal(size=(3, 4)).astype(np.float32)}},
            "d": rng.normal(size=(5,)).astype(ml_dtypes.bfloat16),
            "e": rng.normal(size=(2, 2)).astype(np.float16)}
    f32 = params_from_numpy(tree, "cpu")
    back = params_to_numpy(f32)
    np.testing.assert_array_equal(back["a"]["b"]["c"], tree["a"]["b"]["c"])
    np.testing.assert_array_equal(back["d"], tree["d"].astype(np.float32))
    np.testing.assert_array_equal(back["e"], tree["e"].astype(np.float32))
    bf = params_from_numpy(tree, "cpu", "bfloat16")
    assert bf["a"]["b"]["c"].dtype == torch.bfloat16
    np.testing.assert_array_equal(params_to_numpy(bf)["d"],
                                  tree["d"].astype(np.float32))


# ---------------------------------------------------------------------------
# imports and devices
# ---------------------------------------------------------------------------

def test_model_import_and_get_config_leave_jax_out():
    """``get_config`` imports its module from a string: it must name the
    port's configs, never the reference's (a fresh interpreter; this one
    already holds jax)."""
    code = ("import sys, repro_torch.models.model, repro_torch.kernels.ops; "
            "from repro_torch.configs.base import get_config; "
            "[get_config(a) for a in ('tinyllama-1.1b', 'mamba2-780m')]; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_init_params_refuses_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg = get_config("tinyllama-1.1b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.init_params(cfg, 0)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    assert params["embed"].device.type == "cpu"
