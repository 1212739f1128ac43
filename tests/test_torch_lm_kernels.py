"""The LM kernels' plain PyTorch versions (what a CPU tensor runs) held to
the JAX reference: flash attention against the reference's Pallas kernel
(interpret mode) and its dense oracle, the SSD scan against the Pallas SSD
kernel and the sequential oracle, on the same numpy inputs, at the
tolerances of ``tests/test_kernels.py``.  The Hopper kernels themselves
are held to these plain versions on the card (``tests/test_torch_cuda_lm.py``
and ``chip_smoke.py``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as tssd


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _qkv(B, S, H, K, hd, seed):
    return (_normal((B, S, H, hd), seed), _normal((B, S, K, hd), seed + 1),
            _normal((B, S, K, hd), seed + 2))


# (B, S, H, K, hd, causal, window, bq): the cases of tests/test_kernels.py
_FLASH_CASES = [
    (2, 256, 4, 4, 64, True, 0, 128),      # causal, MHA
    (2, 256, 4, 2, 64, True, 0, 128),      # causal, GQA 2
    (2, 128, 8, 1, 32, True, 0, 128),      # causal, MQA
    (1, 256, 2, 2, 64, True, 64, 128),     # sliding window
    (1, 256, 2, 2, 64, True, 128, 128),
    (1, 128, 2, 2, 64, False, 0, 128),     # non-causal
]


@pytest.mark.parametrize("case", _FLASH_CASES, ids=lambda c: "-".join(
    map(str, c)))
def test_flash_plain_matches_reference_f32(case):
    B, S, H, K, hd, causal, window, bq = case
    q, k, v = _qkv(B, S, H, K, hd, S + H + window)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              window=window, bq=bq, bkv=bq).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    kern = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                bq=bq, bkv=bq)
    oracle = jref.flash_attention_ref(jq, jk, jv, causal=causal,
                                      window=window)
    np.testing.assert_allclose(got, np.asarray(kern), atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(oracle), atol=2e-5)


@pytest.mark.parametrize("case", _FLASH_CASES[:3], ids=lambda c: "-".join(
    map(str, c)))
def test_flash_plain_matches_reference_bf16(case):
    """bf16 inputs, f32 arithmetic, the output rounded to bf16."""
    B, S, H, K, hd, causal, window, bq = case
    q, k, v = _qkv(B, S, H, K, hd, 7 * S + H)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=causal, bq=bq, bkv=bq)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    kern = jops.flash_attention(jq, jk, jv, causal=causal, bq=bq, bkv=bq)
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(kern, np.float32), atol=2e-2)


def _ssd_inputs(B, S, H, P, G, N, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(B, S, H, P)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, S, H)))).astype(np.float32)
    A = -np.exp(rng.uniform(0.0, 1.0, size=(H,))).astype(np.float32)
    Bm = (rng.normal(size=(B, S, G, N)) * 0.3).astype(np.float32)
    Cm = (rng.normal(size=(B, S, G, N)) * 0.3).astype(np.float32)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("chunk", [16, 32, 64])
@pytest.mark.parametrize("G", [1, 2])
def test_ssd_plain_matches_reference(chunk, G):
    B, S, H, P, N = 2, 128, 4, 32, 16
    arrs = _ssd_inputs(B, S, H, P, G, N, chunk + G)
    got = ops.ssd_scan(*map(torch.from_numpy, arrs), chunk=chunk).numpy()
    jarrs = [jnp.asarray(a) for a in arrs]
    kern = jops.ssd_scan(*jarrs, chunk=chunk)
    oracle = jref.ssd_scan_ref(*jarrs)
    np.testing.assert_allclose(got, np.asarray(kern), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got, np.asarray(oracle), atol=1e-4, rtol=1e-4)


def test_cpu_tensors_take_the_plain_versions():
    """No launch is counted for a CPU tensor, the kernel wrappers refuse
    one, and the TPU kernels' shape contracts hold on both routes."""
    ops.reset_launch_counts()
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 128, 2, 1, 32, 0))
    ops.flash_attention(q, k, v)
    x, dt, A, Bm, Cm = map(torch.from_numpy, _ssd_inputs(1, 64, 2, 16, 1, 8,
                                                         0))
    ops.ssd_scan(x, dt, A, Bm, Cm, chunk=32)
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 0 and counts["ssd_scan"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        tflash.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        tssd.ssd_scan(x, dt, A, Bm, Cm, chunk=32)
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(q, k, v, bq=96, bkv=96)
    with pytest.raises(ValueError, match="multiple"):
        ops.ssd_scan(x, dt, A, Bm, Cm, chunk=48)

