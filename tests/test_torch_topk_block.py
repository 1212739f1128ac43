"""The block-local top-k (the port of ``topk_mask_pallas``) held BITWISE to
the reference on the CPU.

The port's plain version ``kernels/ref.py::topk_mask_block_ref`` repeats the
TPU kernel's 32-step f32 bisection, so it is compared with the reference's
kernel itself (``repro.kernels.ops.topk_mask(mode="block")``, Pallas in
interpret mode here) on every case, and with the reference's ``top_k``
oracle ``ref.topk_mask_ref`` where the two agree by construction (normal
draws: no ties near a k-th value).  Rows holding NaN, +-inf and subnormals
are held to the reference's kernel too: a NaN makes its slice's ``hi`` NaN
and keeps every other entry, and the reference's f32 flushes subnormals
(magnitudes and mids) to zero.  ``ref.topk_mask_block_select``, the plain
emulation of the Hopper kernel's algorithm (the exact k-th magnitude, then
the 32 steps replayed on scalars), is held to the reference's kernel on
every case.  The Hopper kernel is held to the plain version on the card
(``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.topk_select import BLOCK as JBLOCK
from repro_torch.kernels import ops, ref


def _normal(n, seed):
    return np.random.default_rng(seed).normal(size=(n,)).astype(np.float32)


def _reference(x, frac):
    return np.asarray(jops.topk_mask(jnp.asarray(x), frac, mode="block"))


_MIN_NORMAL = np.float32(2.0 ** -126)


def _special(case, n=2 * JBLOCK + 100):
    """A vector of 3 slices (the last one short) with special values."""
    x = _normal(n, 29)
    if case == "nan":
        x[100] = np.nan
    elif case == "nans":
        x[:: 1000] = np.nan
    elif case == "inf":
        x[:: 97] = np.inf                  # fewer than k in a slice
        x[JBLOCK: 2 * JBLOCK: 3] = np.inf  # more than k in slice 1
    elif case == "neg_inf":
        x[1:: 89] = -np.inf
    elif case == "nan_inf":
        x[:: 97] = np.inf
        x[JBLOCK + 7] = np.nan
    elif case == "subnormals":             # 3 in 4 subnormal
        x[np.arange(n) % 4 != 0] *= np.float32(1e-40)
    elif case == "subnormal_mids":         # hi < 2 x least normal
        x = (np.abs(x) / np.abs(x).max() * 1.4 + 0.5) * _MIN_NORMAL
    elif case == "ties":
        x = np.round(x * 4) / 4
    elif case == "zeros":
        x[:] = 0.0
    elif case == "zero_slice":
        x[JBLOCK:] = 0.0
        x[JBLOCK + 5: JBLOCK + 9] = 0.25
    elif case == "short":
        x = x[:5000]
    elif case == "huge":                   # lo + h overflows to inf
        x = x / np.abs(x).max() * np.float32(3.4e38)
    elif case == "scaled":                 # magnitudes 1e-30 .. 1e30
        x = x * np.float32(10.0) ** np.linspace(-30, 30, n).astype(np.float32)
    return x.astype(np.float32)


SPECIAL = ["nan", "nans", "inf", "neg_inf", "nan_inf", "subnormals",
           "subnormal_mids", "huge"]


def test_block_size_is_the_reference_slice():
    assert ref.BLOCK == JBLOCK == 8192


@pytest.mark.parametrize("n", [JBLOCK, 3 * JBLOCK, JBLOCK + 17, 5000])
@pytest.mark.parametrize("frac", [0.01, 0.1, 0.5])
def test_block_topk_matches_reference_kernel_and_oracle(n, frac):
    x = _normal(n, n)
    got = ops.topk_mask(torch.from_numpy(x), frac, mode="block").numpy()
    np.testing.assert_array_equal(got, _reference(x, frac))
    np.testing.assert_array_equal(
        got, np.asarray(jref.topk_mask_ref(jnp.asarray(x), frac)))


@pytest.mark.parametrize("case", ["ties", "zeros", "sparse_tail"])
def test_block_topk_degenerate_cases_match_reference_kernel(case):
    """Ties at quarter steps, an all-zero vector (every entry kept, lo = 0)
    and a slice that is zero but for a few entries: the bisection's answer,
    which may differ from a top_k oracle, is the reference kernel's."""
    n = 2 * JBLOCK + 100
    x = _normal(n, 11)
    if case == "ties":
        x = np.round(x * 4) / 4
    elif case == "zeros":
        x = np.zeros(n, np.float32)
    else:
        x[JBLOCK:] = 0.0
        x[JBLOCK + 5: JBLOCK + 9] = 0.25
    got = ops.topk_mask(torch.from_numpy(x), 0.1, mode="block").numpy()
    np.testing.assert_array_equal(got, _reference(x, 0.1))
    if case == "zeros":
        assert got.all()


@pytest.mark.parametrize("frac", [0.1, 0.5])
@pytest.mark.parametrize("case", SPECIAL)
def test_block_topk_special_values_match_reference_kernel(case, frac):
    """NaN, +-inf and subnormals through ``ops.topk_mask(mode="block")`` on
    the CPU, bitwise the reference's kernel."""
    x = _special(case)
    got = ops.topk_mask(torch.from_numpy(x), frac, mode="block").numpy()
    np.testing.assert_array_equal(got, _reference(x, frac))
    if case == "nan":                      # every entry of slice 0 but NaN
        assert got[:JBLOCK].sum() == JBLOCK - 1 and not got[100]


@pytest.mark.parametrize("frac", [0.01, 0.1, 0.5, 1.0])
@pytest.mark.parametrize("case", SPECIAL + ["normal", "ties", "zeros",
                                            "zero_slice", "short", "scaled"])
def test_kernel_emulation_matches_reference_kernel(case, frac):
    """The Hopper kernel's algorithm (exact v_k on bit patterns, then the
    32 steps replayed with ``v_k >= mid``) equals the reference's kernel and
    the plain bisection bitwise."""
    x = _special(case)
    got = ref.topk_mask_block_select(torch.from_numpy(x), frac).numpy()
    np.testing.assert_array_equal(got, _reference(x, frac))
    np.testing.assert_array_equal(
        got, ref.topk_mask_block_ref(torch.from_numpy(x), frac).numpy())


def test_block_topk_frac_over_one_and_half_rows_match_reference():
    """k over the slice (frac 1.5) keeps every entry but NaN; bf16 and f16
    rows are cast to f32 first, as the reference casts them."""
    x = _special("nan_inf")
    got = ops.topk_mask(torch.from_numpy(x), 1.5, mode="block").numpy()
    np.testing.assert_array_equal(got, _reference(x, 1.5))
    np.testing.assert_array_equal(got, ~np.isnan(x))
    for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16),
                          (torch.float16, jnp.float16)):
        h = torch.from_numpy(_normal(JBLOCK + 17, 3)).to(dtype)
        want = np.asarray(jops.topk_mask(
            jnp.asarray(h.float().numpy()).astype(jdtype), 0.1, mode="block"))
        np.testing.assert_array_equal(
            ops.topk_mask(h, 0.1, mode="block").numpy(), want)


def test_block_topk_rows_are_independent_vectors():
    """A (3, N) batch equals three single-row calls: each row is padded and
    sliced on its own, as the global mode treats rows."""
    n = JBLOCK + 17
    x = np.stack([_normal(n, s) for s in range(3)])
    x[1] = np.round(x[1] * 4) / 4
    got = ops.topk_mask(torch.from_numpy(x), 0.1, mode="block").numpy()
    for r in range(3):
        np.testing.assert_array_equal(
            got[r], ops.topk_mask(torch.from_numpy(x[r]), 0.1,
                                  mode="block").numpy())
    np.testing.assert_array_equal(got[0], _reference(x[0], 0.1))


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="mode"):
        ops.topk_mask(torch.zeros(10), 0.1, mode="radix")
