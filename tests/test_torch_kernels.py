"""The port's kernels held to the JAX reference: the plain PyTorch versions
(what a CPU tensor runs) equal the reference's eager oracles and its
interpret-mode Pallas kernels BITWISE — top-k masks including ties and
degenerate rows, int8 codes, scales and dequantized rows in both rounding
modes.  The Hopper kernels themselves are held bitwise to the plain
versions in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.quantize import (_hash_u01, dequantize_rows_pallas,
                                    quantize_rows_pallas)
from repro.kernels.topk_select import BLOCK
from repro_torch.kernels import ops, ref
from repro_torch.kernels import quantize as tquant
from repro_torch.kernels import topk_select as ttopk


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _codec_rows(r=4, n=1000, seed=0):
    x = np.random.default_rng(seed).normal(scale=0.1, size=(r, n)
                                           ).astype(np.float32)
    x[1, :n // 2] = 0.0          # half-sparse row
    x[2] = 0.0                   # all-zero row (scale 0 path)
    return x


# ---------------------------------------------------------------------------
# top-k: plain version vs the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [100, 5000, BLOCK, BLOCK + 17, 3 * BLOCK])
@pytest.mark.parametrize("frac", [0.01, 0.1, 0.5, 1.0])
def test_topk_plain_matches_reference_bitwise(n, frac):
    x = _normal((n,), n + int(frac * 100))
    got = ops.topk_mask(torch.from_numpy(x), frac).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jref.topk_mask_global_ref(jnp.asarray(x), frac)))
    np.testing.assert_array_equal(
        got, np.asarray(jops.topk_mask(jnp.asarray(x), frac)))


@pytest.mark.parametrize("n", [257, 5000, BLOCK + 3])
@pytest.mark.parametrize("frac", [0.05, 0.3, 0.9])
def test_topk_plain_keeps_ties_like_reference(n, frac):
    x = np.round(_normal((n,), n) * 4) / 4
    got = ops.topk_mask(torch.from_numpy(x), frac).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jops.topk_mask(jnp.asarray(x), frac)))
    assert got.sum() >= max(int(n * frac), 1)


def test_topk_plain_degenerate_rows():
    """All-ones, all-zero (threshold 0: every entry kept, kept_frac 1.0),
    all-equal negative rows."""
    for x in [np.ones(300), np.zeros(300), -np.ones(300) * 0.5]:
        x = x.astype(np.float32)
        got = ops.topk_mask(torch.from_numpy(x), 0.1).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jref.topk_mask_global_ref(jnp.asarray(x), 0.1)))
    assert ops.topk_mask(torch.zeros(300), 0.1).all()


def _special_row(case, n=16389):
    x = _normal((n,), 41)
    if case == "nan":                       # one NaN: the reference keeps it
        x[int(n * 0.1)] = np.nan
    elif case == "nans":
        x[:: 1000] = np.nan
    elif case == "all_nan":
        x[:] = np.nan
    elif case == "inf":
        x[:: 97] = np.inf
    elif case == "neg_inf":
        x[1:: 89] = -np.inf
    elif case == "nan_inf":
        x[:: 97] = np.inf
        x[5] = np.nan
        x[6] = -np.nan
    elif case == "subnormals":
        x[::2] *= np.float32(1e-40)
    return x.astype(np.float32)


@pytest.mark.parametrize("frac", [0.01, 0.1, 1.0])
@pytest.mark.parametrize("case", ["nan", "nans", "all_nan", "inf", "neg_inf",
                                  "nan_inf", "subnormals"])
def test_topk_plain_orders_nan_and_inf_like_reference(case, frac):
    """The global mask orders |x| by its bit pattern, as the reference and
    B1 do: NaN above +inf, so a NaN is always kept."""
    x = _special_row(case)
    got = ops.topk_mask(torch.from_numpy(x), frac).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jops.topk_mask(jnp.asarray(x), frac)))
    assert got[np.isnan(x)].all()


def test_topk_plain_bit_order_equals_value_order_on_finite_rows():
    """On finite rows the bit-pattern threshold is the value threshold:
    the mask is what ``torch.topk`` over the magnitudes gives."""
    x = _normal((4, BLOCK + 17), 13)
    x[1] = np.round(x[1] * 4) / 4
    x[2, ::2] = 0.0
    x[2, 1::4] = -0.0
    x[3, ::2] *= np.float32(1e-40)
    t = torch.from_numpy(x)
    for frac in (0.01, 0.1, 0.5, 1.0):
        mag = t.abs()
        kth = torch.topk(mag, max(int(t.shape[1] * frac), 1),
                         dim=-1).values[..., -1:]
        assert torch.equal(ref.topk_mask_global_ref(t, frac), mag >= kth)


def test_topk_plain_frac_over_one_and_half_rows_match_reference():
    """k over N keeps every entry, as the reference's bisection does; bf16
    and f16 rows are cast to f32 first, as the reference casts them."""
    x = _special_row("nan_inf", 5000)
    got = ops.topk_mask(torch.from_numpy(x), 1.5).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jops.topk_mask(jnp.asarray(x), 1.5)))
    assert got.all()
    for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16),
                          (torch.float16, jnp.float16)):
        h = torch.from_numpy(np.round(_normal((3, 5000), 3) * 8) / 8).to(dtype)
        got = ops.topk_mask(h, 0.1).numpy()
        for r in range(3):
            np.testing.assert_array_equal(got[r], np.asarray(jops.topk_mask(
                jnp.asarray(h[r].float().numpy()).astype(jdtype), 0.1)))


def test_topk_row_batched_equals_per_row_reference():
    """One (C, N) call equals C per-row reference calls (the reference's
    per-user list at approaches.py:224-227)."""
    x = _normal((5, BLOCK + 5), 7)
    x[1] = np.round(x[1] * 2) / 2          # a row with ties
    x[3] = 0.0                             # an all-zero row
    x[4, :: 50] = np.nan                   # NaN rows keep their NaNs
    got = ops.topk_mask(torch.from_numpy(x), 0.1).numpy()
    for r in range(5):
        np.testing.assert_array_equal(
            got[r], np.asarray(jops.topk_mask(jnp.asarray(x[r]), 0.1)))


# ---------------------------------------------------------------------------
# int8 codec: plain version vs the reference's eager oracle and kernel
# ---------------------------------------------------------------------------

def test_hash_matches_reference_uint32_stream():
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 2**31 - 1, 4096).astype(np.int32)
    cols = rng.integers(0, 2**31 - 1, 4096).astype(np.int32)
    for seed in (0, 1, 123, 2**31 - 2):
        want = np.asarray(_hash_u01(jnp.asarray(rows), jnp.asarray(cols),
                                    jnp.int32(seed)))
        got = ref.hash_u01(torch.from_numpy(rows), torch.from_numpy(cols),
                           seed).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("shape", [(4, 1000), (3, BLOCK + 17)])
def test_quantize_plain_matches_eager_reference_bitwise(stochastic, shape):
    x = _codec_rows(*shape, seed=shape[1])
    seed = 123 if stochastic else None
    jseed = jnp.int32(123) if stochastic else None
    q, s = ops.quantize_rows(torch.from_numpy(x), stochastic=stochastic,
                             seed=seed)
    for qr, sr in (jref.quantize_rows_ref(jnp.asarray(x),
                                          stochastic=stochastic, seed=jseed),
                   quantize_rows_pallas(jnp.asarray(x),
                                        stochastic=stochastic, seed=jseed)):
        np.testing.assert_array_equal(q.numpy(), np.asarray(qr))
        np.testing.assert_array_equal(s.numpy(), np.asarray(sr))
        want = np.asarray(jref.dequantize_rows_ref(qr, sr))
        np.testing.assert_array_equal(ops.dequantize_rows(q, s).numpy(), want)
        np.testing.assert_array_equal(
            want, np.asarray(dequantize_rows_pallas(qr, sr)))


def test_cpu_tensors_never_reach_the_kernels():
    """A CPU tensor takes the plain version (no launch is counted); the
    kernel wrappers themselves refuse a CPU tensor."""
    ops.reset_launch_counts()
    x = torch.from_numpy(_codec_rows())
    ops.topk_mask(x, 0.1)
    ops.topk_mask(x, 0.1, mode="block")
    ops.dequantize_rows(*ops.quantize_rows(x))
    assert ops.launch_counts() == {"topk_mask_rows": 0, "topk_mask_block": 0,
                                   "quantize_rows": 0, "dequantize_rows": 0,
                                   "flash_attention": 0, "ssd_scan": 0}
    with pytest.raises(ValueError, match="CUDA"):
        ttopk.topk_mask_rows(x, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        ttopk.topk_mask_block_rows(x, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        tquant.quantize_rows(x)


# ---------------------------------------------------------------------------
# int8 codec on subnormal, NaN and inf rows: the reference's f32 flushes
# subnormals to zero and converts NaN to the integer 0
# ---------------------------------------------------------------------------

_TINY = 127 * 2.0 ** -126        # the least absmax with a normal scale


def _edge_rows():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(6, 4096)).astype(np.float32)
    x[0] *= np.float32(1e-37)                  # absmax < 127 * 2**-126
    x[1] = np.float32(5e-39)                   # subnormal entries under
    x[1, 0] = np.float32(1e-36)                # a subnormal scale
    x[2] *= np.float32(1e-38)                  # normal scale, subnormal
    x[2, 0] = np.float32(3 * _TINY)            # entries among normals
    x[3, ::7] = np.inf                         # inf times inv = 0 is NaN
    x[4, 5] = np.nan
    x[5] = np.abs(x[5]) * np.float32(2.0 ** -126) + np.float32(_TINY)
    return x


@pytest.mark.parametrize("stochastic", [False, True])
def test_quantize_plain_flushes_subnormals_like_reference(stochastic):
    """Rows whose absmax is below 127 * 2**-126 (scale 0, every code 0),
    subnormal entries under a normal scale (coded 0, also under stochastic
    rounding), NaN and inf rows (codes 0): bitwise the reference's eager
    codec and its interpret-mode kernel, dequantized rows too."""
    x = _edge_rows()
    seed = 77 if stochastic else None
    jseed = jnp.int32(77) if stochastic else None
    q, s = ops.quantize_rows(torch.from_numpy(x), stochastic=stochastic,
                             seed=seed)
    assert float(s[0]) == 0.0 and float(s[1]) == 0.0
    assert not q[:2].any() and not q[3].any()
    for qr, sr in (jref.quantize_rows_ref(jnp.asarray(x),
                                          stochastic=stochastic, seed=jseed),
                   quantize_rows_pallas(jnp.asarray(x),
                                        stochastic=stochastic, seed=jseed)):
        np.testing.assert_array_equal(q.numpy(), np.asarray(qr))
        np.testing.assert_array_equal(s.numpy(), np.asarray(sr))
        np.testing.assert_array_equal(
            ops.dequantize_rows(q, s).numpy(),
            np.asarray(jref.dequantize_rows_ref(qr, sr)))


def test_dequantize_plain_takes_a_subnormal_scale_as_zero():
    """``q * scale`` with a subnormal scale is 0 in the reference (and no
    product with a normal scale and |q| >= 1 underflows)."""
    q = np.array([[100, -3, 0, 127], [1, -1, 127, -127]], np.int8)
    scale = np.array([3e-39, 2.0 ** -126], np.float32)
    got = ops.dequantize_rows(torch.from_numpy(q), torch.from_numpy(scale))
    want = np.asarray(jref.dequantize_rows_ref(jnp.asarray(q),
                                               jnp.asarray(scale)))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    np.testing.assert_array_equal(
        want, np.asarray(dequantize_rows_pallas(jnp.asarray(q),
                                                jnp.asarray(scale))))
    assert not got[0].any() and got[1].abs().min() >= 2.0 ** -126


def test_host_numpy_codec_is_the_references_bitwise():
    """The streaming driver's host codec (``stage_rows``) is numpy and does
    not flush, bit for bit the reference's ``_np_quantize_rows``; on rows
    without subnormals it equals B2's plain version."""
    from repro.core.session import _np_dequantize_rows as jdq
    from repro.core.session import _np_quantize_rows as jq
    from repro_torch.core.session import (_np_dequantize_rows,
                                          _np_quantize_rows)
    rows = np.concatenate([_codec_rows(), _edge_rows()[:3, :1000]])
    with np.errstate(all="ignore"):
        q, s = _np_quantize_rows(rows)
        qr, sr = jq(rows)
    np.testing.assert_array_equal(q, qr)
    np.testing.assert_array_equal(s, sr)
    np.testing.assert_array_equal(_np_dequantize_rows(q, s), jdq(qr, sr))
    normal = _codec_rows(n=3000, seed=4)
    q, s = _np_quantize_rows(normal)
    qp, sp = ops.quantize_rows(torch.from_numpy(normal))
    np.testing.assert_array_equal(q, qp.numpy())
    np.testing.assert_array_equal(s, sp.numpy())
    np.testing.assert_array_equal(_np_dequantize_rows(q, s),
                                  ops.dequantize_rows(qp, sp).numpy())
