"""The port's flat-row federation pieces and data plumbing held to the JAX
reference: FlatLayout order, selection, codecs, combiners and the upload
pricing table on the same inputs (bitwise where the arithmetic is the
same operation sequence), and the numpy data copies (bitwise batches)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import federated as jfed
from repro.core.approaches import d_flat_layout as jax_d_flat_layout
from repro.core.gan import MLPGanConfig as JaxMLPCfg
from repro.core.gan import make_mlp_pair as jax_make_mlp_pair
from repro.data import federated as jdata
from repro.data import mixtures as jmix
from repro_torch.core import federated as tfed
from repro_torch.core.approaches import d_flat_layout
from repro_torch.core.gan import MLPGanConfig, make_mlp_pair
from repro_torch.data import federated as tdata
from repro_torch.data import mixtures as tmix

SMALL = dict(data_dim=64, z_dim=16, g_hidden=32, d_hidden=32)


def _rows(c=3, n=2000, seed=0):
    x = np.random.default_rng(seed).normal(scale=0.01, size=(c, n)
                                           ).astype(np.float32)
    return x


def test_flat_layout_order_matches_reference_bitwise():
    """Bias before weight in sorted-key order; converted params flatten to
    exactly the reference's flat row."""
    jpair = jax_make_mlp_pair(JaxMLPCfg(**SMALL))
    _, d = jpair.init(jax.random.key(0))
    want = np.array(jax_d_flat_layout(jpair).flatten(d))
    layout = d_flat_layout(make_mlp_pair(MLPGanConfig(**SMALL)))
    td = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), d)
    got = layout.flatten(td).numpy()
    np.testing.assert_array_equal(got, want)
    assert layout.n == jax_d_flat_layout(jpair).n
    assert [p for p in layout.paths] == [("l1", "b"), ("l1", "w"),
                                         ("l2", "b"), ("l2", "w"),
                                         ("l3", "b"), ("l3", "w")]
    back = layout.unflatten(torch.from_numpy(want))
    for k in d:
        for leaf in d[k]:
            np.testing.assert_array_equal(back[k][leaf].numpy(),
                                          np.asarray(d[k][leaf]))
    stacked = layout.unflatten_stacked(torch.from_numpy(np.stack([want] * 2)))
    np.testing.assert_array_equal(
        layout.flatten_stacked(stacked).numpy(), np.stack([want] * 2))


def test_select_rows_match_per_row_reference_bitwise():
    x = _rows()
    got, kept = tfed.select_delta_flat(torch.from_numpy(x), "topk", frac=0.1,
                                       use_kernel=True)
    for r in range(x.shape[0]):
        m, k = jfed.select_delta_flat(jnp.asarray(x[r]), "topk", frac=0.1,
                                      use_kernel=True)
        np.testing.assert_array_equal(got[r].numpy(), np.asarray(m))
        assert float(kept[r]) == pytest.approx(float(k), abs=1e-7)


def _special_row(case, n=16389):
    x = np.random.default_rng(41).normal(size=n).astype(np.float32)
    if case == "nan":
        x[int(n * 0.1)] = np.nan
    elif case == "nans":
        x[:: 1000] = np.nan
    elif case == "all_nan":
        x[:] = np.nan
    elif case == "inf":
        x[:: 97] = np.inf
    elif case == "neg_inf":
        x[1:: 89] = -np.inf
    elif case == "inf_dropped":            # more infs than k: ties kept
        x[:: 7] = np.inf
        x[3:: 7] = -np.inf
    elif case == "nan_inf":
        x[:: 97] = np.inf
        x[5] = np.nan
    return x


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("frac", [0.01, 0.1])
@pytest.mark.parametrize("case", ["nan", "nans", "all_nan", "inf", "neg_inf",
                                  "inf_dropped", "nan_inf"])
def test_select_topk_nan_and_inf_rows_match_reference_bitwise(case, frac,
                                                              use_kernel):
    """Both top-k routes on rows holding NaN or +-inf, bit for bit: the
    non-kernel mask orders |x| by value (a NaN is dropped), the kernel's by
    bit pattern (a NaN is kept), and a dropped entry is +0 as the
    reference's masking leaves it."""
    x = _special_row(case)
    got, kept = tfed.select_delta_flat(torch.from_numpy(x[None]), "topk",
                                       frac=frac, use_kernel=use_kernel)
    m, k = jfed.select_delta_flat(jnp.asarray(x), "topk", frac=frac,
                                  use_kernel=use_kernel)
    np.testing.assert_array_equal(got[0].numpy().view(np.int32),
                                  np.asarray(m).view(np.int32))
    assert float(kept[0]) == pytest.approx(float(k), abs=1e-7)


def test_combine_max_abs_matches_reference_on_ties():
    """Rows that tie in magnitude (also with opposite signs): the first
    user wins, as with jnp.argmax."""
    x = np.round(_rows(4, 500, 1) * 400) / 4
    x[2, :50] = -x[0, :50]                 # |tie| with opposite sign
    x[3, 50:100] = x[1, 50:100]            # exact tie
    want = np.asarray(jfed.combine_max_abs(jnp.asarray(x)))
    np.testing.assert_array_equal(
        tfed.combine_max_abs(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("name", ["mean", "masked_mean", "staleness_mean",
                                  "staleness_max_abs"])
def test_other_combiners_match_reference(name):
    x = _rows(4, 500, 2)
    x[1, ::3] = 0.0
    ages = np.array([0, 3, 1, 7], np.int32)
    jfn, tfn = jfed.COMBINERS[name], getattr(tfed, f"combine_{name}")
    if getattr(jfn, "needs_ages", False):
        want = jfn(jnp.asarray(x), jnp.asarray(ages), decay=0.7)
        got = tfn(torch.from_numpy(x), torch.from_numpy(ages), decay=0.7)
    else:
        want, got = jfn(jnp.asarray(x)), tfn(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-9)


@pytest.mark.parametrize("codec,stochastic", [
    ("none", False), ("bf16", False), ("int8", False), ("int8", True),
    ("topk_int8", False), ("topk_int8", True)])
def test_codec_transport_matches_reference(codec, stochastic):
    """Bitwise against the reference's eager codec; against its jitted
    kernel path at that path's own contract (tests/test_compress.py: XLA
    rewrites /127, so the scale may move by an ULP)."""
    x = _rows(3, 3000, 4)
    x[1, ::2] = 0.0
    seed = 77 if stochastic else None
    jseed = jnp.int32(77) if stochastic else None
    for use_kernel in (False, True):
        got = tfed.codec_transport(torch.from_numpy(x), codec,
                                   stochastic=stochastic, seed=seed,
                                   use_kernel=use_kernel).numpy()
        eager = np.asarray(jfed.codec_transport(
            jnp.asarray(x), codec, stochastic=stochastic, seed=jseed))
        np.testing.assert_array_equal(got, eager)
        jitted = np.asarray(jfed.codec_transport(
            jnp.asarray(x), codec, stochastic=stochastic, seed=jseed,
            use_kernel=True))
        scale = np.abs(x).max(axis=1, keepdims=True) / 127.0
        assert np.all(np.abs(got - jitted) <= scale * (1 + 1e-6) + 1e-12)


@pytest.mark.parametrize("policy", ["none", "topk", "random", "threshold",
                                    "shared_random"])
@pytest.mark.parametrize("codec", ["none", "bf16", "int8", "topk_int8"])
def test_upload_bytes_match_reference(policy, codec):
    n = 267009
    kf = 0.137 if policy == "threshold" else None
    assert tfed.upload_bytes_flat(n, policy, 0.1, kept_frac=kf,
                                  codec=codec) == \
        jfed.upload_bytes_flat(n, policy, 0.1, kept_frac=kf, codec=codec)


def _digits(mod):
    rng = np.random.default_rng(0)
    templates, sample = mod.digits_like_mixture(list(range(10)), size=28)
    data = sample(rng, 600).reshape(600, -1)
    labels = rng.integers(0, 10, 600)
    return templates, data, labels


def test_data_batches_match_reference_bitwise():
    jt, jdat, jlab = _digits(jmix)
    tt, tdat, tlab = _digits(tmix)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tdat, jdat)
    np.testing.assert_array_equal(tlab, jlab)
    cov_j, best_j = jmix.template_coverage(jdat[:50], jt)
    cov_t, best_t = tmix.template_coverage(tdat[:50], tt)
    assert cov_t == cov_j
    np.testing.assert_array_equal(best_t, best_j)
    pairs = [
        (jdata.dirichlet_partition(jdat, jlab, 8, 0.5, seed=3),
         tdata.dirichlet_partition(tdat, tlab, 8, 0.5, seed=3)),
        (jdata.federated_split(jdat, jlab, [[0, 1, 2, 3, 4], [5, 6, 7, 8, 9]]),
         tdata.federated_split(tdat, tlab, [[0, 1, 2, 3, 4], [5, 6, 7, 8, 9]])),
        (jdata.quantity_skew_partition(jdat, 5, seed=1),
         tdata.quantity_skew_partition(tdat, 5, seed=1)),
    ]
    for jds, tds in pairs:
        assert tds.meta == jds.meta
        jr, tr = np.random.default_rng(9), np.random.default_rng(9)
        for _ in range(3):
            for u in range(jds.num_users):
                np.testing.assert_array_equal(tds.user_batch(u, tr, 16),
                                              jds.user_batch(u, jr, 16))
        np.testing.assert_array_equal(tds.union_sampler(tr, 32),
                                      jds.union_sampler(jr, 32))


# ---------------------------------------------------------------------------
# Subnormal rows: the reference's f32 compares flush subnormals to zero
# ---------------------------------------------------------------------------

def _subnormal_rows():
    rng = np.random.default_rng(21)
    x = rng.normal(size=(3, 4096)).astype(np.float32)
    x[0] *= np.float32(1e-39)                 # every entry subnormal
    x[1, :3000] *= np.float32(1e-39)          # part subnormal
    x[2, ::2] *= np.float32(1e-40)            # a subnormal tail
    return x


@pytest.mark.parametrize("frac", [0.1, 0.5])
def test_topk_mask_takes_a_subnormal_kth_magnitude_as_zero(frac):
    """The non-kernel top-k keeps every entry where the k-th magnitude is
    subnormal (the reference reads the threshold as 0); the kernel route
    orders bit patterns and is left as it was."""
    x = _subnormal_rows()
    got, kept = tfed.select_delta_flat(torch.from_numpy(x), "topk",
                                       frac=frac, use_kernel=False)
    for r in range(3):
        m, k = jfed.select_delta_flat(jnp.asarray(x[r]), "topk", frac=frac)
        np.testing.assert_array_equal(got[r].numpy().view(np.int32),
                                      np.asarray(m).view(np.int32))
        assert float(kept[r]) == pytest.approx(float(k), abs=1e-7)
    assert float(kept[0]) == 1.0


def test_threshold_mask_and_priced_bytes_on_part_subnormal_rows():
    """``threshold`` at tau = 0 drops subnormal entries as the reference
    does, so the kept fraction, and the upload bytes priced from it, equal
    the reference's."""
    x = _subnormal_rows()
    got, kept = tfed.select_delta_flat(torch.from_numpy(x), "threshold")
    n = x.shape[1]
    for r in range(3):
        m, k = jfed.select_delta_flat(jnp.asarray(x[r]), "threshold")
        np.testing.assert_array_equal(got[r].numpy().view(np.int32),
                                      np.asarray(m).view(np.int32))
        assert float(kept[r]) == pytest.approx(float(k), abs=1e-7)
        for codec in ("none", "topk_int8"):
            assert tfed.upload_bytes_flat(
                n, "threshold", kept_frac=float(kept[r]), codec=codec) == \
                jfed.upload_bytes_flat(n, "threshold", kept_frac=float(k),
                                       codec=codec)
    assert float(kept[0]) == 0.0
    assert float(kept[1]) == pytest.approx(1096 / 4096, abs=1e-7)
