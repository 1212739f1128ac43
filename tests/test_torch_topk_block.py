"""The block-local top-k (the port of ``topk_mask_pallas``) held BITWISE to
the reference on the CPU.

The port's plain version ``kernels/ref.py::topk_mask_block_ref`` repeats the
TPU kernel's 32-step f32 bisection, so it is compared with the reference's
kernel itself (``repro.kernels.ops.topk_mask(mode="block")``, Pallas in
interpret mode here) on every case, and with the reference's ``top_k``
oracle ``ref.topk_mask_ref`` where the two agree by construction (normal
draws: no ties near a k-th value).  The Hopper kernel is held to the same
plain version on the card (``tests/test_torch_cuda.py``).
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
