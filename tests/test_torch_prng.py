"""``repro_torch.prng`` against ``jax.random`` (threefry2x32, partitionable)
on the CPU.

Keys, ``fold_in``, ``split``, ``bits``, ``uniform`` and ``randint`` are held
BITWISE, on vectorised keys and on negative and 64-bit seeds.  ``normal``
and the Gumbel noise go through XLA's f32 log / erfinv formulas, which the
port follows but whose CPU log differs from the port's Cephes expansion in
a few hundredths of a percent of inputs: they are held within 1e-6 (they
agree bitwise on ~99.9 % of draws, asserted as >= 99 %), and a draw never
depends on the batch it is computed in (bitwise).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.models.common import silu, softplus

SEEDS = [0, 1, 7, -1, -123456789, 2**31 - 1, 2**31, 2**32 + 5,
         -2**40 - 3, 2**63 - 1]
NORMAL_TOL = 1e-6


def _kd(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


def _bits32(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def _jax_key(seed: int, rid: int, off: int):
    """The reference's slot key, seeds cast to uint32 as its sampler
    casts them."""
    u = lambda v: np.uint32(np.int64(v) & 0xFFFFFFFF)
    return jax.random.fold_in(jax.random.fold_in(jax.random.key(u(seed)),
                                                 u(rid)), u(off))


def _slot_keys():
    rng = np.random.default_rng(0)
    seeds = np.asarray(SEEDS + list(rng.integers(-2**40, 2**40, 22)),
                       dtype=np.int64)
    rids = rng.integers(0, 2**33, len(seeds))
    offs = rng.integers(0, 300, len(seeds))
    tkeys = prng.fold_in(prng.fold_in(prng.key(seeds), rids), offs)
    jkeys = [_jax_key(int(s), int(r), int(o))
             for s, r, o in zip(seeds, rids, offs)]
    return jkeys, tkeys


def test_key_matches_jax_for_negative_and_64_bit_seeds():
    for s in SEEDS:
        np.testing.assert_array_equal(prng.key(s).numpy(),
                                      _kd(jax.random.key(s)))
    batch = prng.key(np.asarray([0, 5, 2**32 + 9]))
    assert batch.shape == (3, 2)
    np.testing.assert_array_equal(batch[2].numpy(), _kd(jax.random.key(9)))


def test_fold_in_split_and_bits_bitwise_on_vectorised_keys():
    jkeys, tkeys = _slot_keys()
    np.testing.assert_array_equal(tkeys.numpy(),
                                  np.stack([_kd(k) for k in jkeys]))
    split = prng.split(tkeys, 3)
    assert split.shape == (len(jkeys), 3, 2)
    bits = prng.bits(tkeys, (4, 33))
    for i, k in enumerate(jkeys):
        np.testing.assert_array_equal(split[i].numpy(),
                                      _kd(jax.random.split(k, 3)))
        np.testing.assert_array_equal(
            bits[i].numpy(),
            np.asarray(jax.random.bits(k, (4, 33))).astype(np.int64))


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-3.0, 5.0)])
def test_uniform_bitwise(lo, hi):
    jkeys, tkeys = _slot_keys()
    got = prng.uniform(tkeys, (257,), lo, hi).numpy()
    for i, k in enumerate(jkeys):
        want = jax.random.uniform(k, (257,), jnp.float32, lo, hi)
        np.testing.assert_array_equal(_bits32(got[i]), _bits32(want))


@pytest.mark.parametrize("lo,hi", [(0, 512), (0, 32000), (-5, 2**31 - 1),
                                   (-2**31, 7), (3, 3)])
def test_randint_bitwise(lo, hi):
    jkeys, tkeys = _slot_keys()
    got = prng.randint(tkeys, (5, 11), lo, hi).numpy()
    for i, k in enumerate(jkeys):
        want = np.asarray(jax.random.randint(k, (5, 11), lo, hi))
        np.testing.assert_array_equal(got[i], want)


def test_normal_within_tolerance_and_mostly_bitwise():
    jkeys, tkeys = _slot_keys()
    got = prng.normal(tkeys, (512,)).numpy()
    want = np.stack([np.asarray(jax.random.normal(k, (512,)))
                     for k in jkeys])
    np.testing.assert_allclose(got, want, rtol=0, atol=NORMAL_TOL)
    assert np.mean(_bits32(got) == _bits32(want)) >= 0.99


def test_gumbel_and_categorical():
    """The Gumbel noise within 1e-6 of the reference's; categorical draws
    equal wherever the two best perturbed logits are further apart than
    twice that."""
    jkeys, tkeys = _slot_keys()
    V = 97
    g = prng.gumbel(tkeys, (V,)).numpy()
    jg = np.stack([np.asarray(jax.random.gumbel(k, (V,))) for k in jkeys])
    np.testing.assert_allclose(g, jg, rtol=0, atol=NORMAL_TOL)
    logits = np.random.default_rng(1).normal(size=(len(jkeys), V)).astype(
        np.float32)
    got = prng.categorical(tkeys, torch.from_numpy(logits)).numpy()
    want = np.asarray([jax.random.categorical(k, jnp.asarray(row))
                       for k, row in zip(jkeys, logits)])
    top2 = np.sort(jg + logits, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * NORMAL_TOL
    assert clear.sum() >= len(jkeys) - 2
    np.testing.assert_array_equal(got[clear], want[clear])


def test_draws_do_not_depend_on_the_batch():
    """A key's normals, Gumbel noise, SiLU and softplus are the same bits
    alone and at any position of a larger batch (torch's vectorised CPU
    loops would evaluate a tensor's tail another way)."""
    _, tkeys = _slot_keys()
    n = tkeys.shape[0]
    for fn in (lambda k: prng.normal(k, (13,)),
               lambda k: prng.gumbel(k, (13,))):
        batch = fn(tkeys)
        for i in range(n):
            assert torch.equal(fn(tkeys[i:i + 1])[0], batch[i])
    x = torch.from_numpy(np.random.default_rng(2).normal(
        scale=8.0, size=(n, 13)).astype(np.float32))
    for f in (silu, softplus):
        whole = f(x)
        for i in range(n):
            assert torch.equal(f(x[i:i + 1])[0], whole[i])
