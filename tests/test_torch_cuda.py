"""The Hopper kernels held BITWISE to their plain PyTorch versions on the
card, and the main path's kernel routing on a CUDA session.

Every test here needs a CUDA device and nvcc: it carries the ``cuda``
marker and skips without a card.  The file imports no JAX, so it runs on
a machine that has none (``tests/conftest.py`` imports JAX, hence
``--noconftest`` there):

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import quantize as tquant
from repro_torch.kernels import topk_select as ttopk

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the Hopper kernels run only on the card")
    return torch.device("cuda")


def _rows(shape, seed, scale=1.0):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        scale=scale, size=shape).astype(np.float32))


@pytest.mark.parametrize("n", [1, 7, 100, 5000, 8192 + 17, 267009])
@pytest.mark.parametrize("frac", [0.01, 0.1, 1.0])
def test_topk_kernel_matches_plain_bitwise(cuda, n, frac):
    x = _rows((8, n), n).to(cuda)
    x[1] = torch.round(x[1] * 4) / 4           # ties
    x[2] = 0.0                                 # all-zero row: t = 0
    x[3] = -0.5                                # all-equal row
    got = ttopk.topk_mask_rows(x, frac)
    assert torch.equal(got, ref.topk_mask_global_ref(x, frac))
    assert got[2].all()


@pytest.mark.parametrize("rows,n", [(3, 1_000_003), (1, 267009),
                                    (33, 20011)])
def test_topk_kernel_beyond_shared_memory_and_one_wave(cuda, rows, n):
    """A slice too large for shared memory (N = 1,000,003: the passes read
    device memory), one row, and 33 rows (clusters in more than one wave);
    a row view at an odd offset, so no row starts 16-byte aligned."""
    x = _rows((rows, n + 1), n)[:, 1:].contiguous().to(cuda)
    x[0, : n // 3] = torch.round(x[0, : n // 3] * 4) / 4
    odd = _rows((rows * n + 1,), rows).to(cuda)[1:].view(rows, n)
    for t in (x, odd):
        for frac in (0.01, 0.1):
            assert torch.equal(ttopk.topk_mask_rows(t, frac),
                               ref.topk_mask_global_ref(t, frac))


def _special_rows(x):
    """Rows 1-7 of ``x`` (8, n) made hard: ties, an all-zero row, zero tail
    slices, a NaN and +-inf, subnormals among normals, magnitudes near the
    least normal (subnormal mids), +inf and magnitudes near the largest
    float."""
    n = x.shape[1]
    x[1] = torch.round(x[1] * 4) / 4           # ties
    x[2] = 0.0                                 # all-zero row: lo = 0
    x[3, n // 3:] = 0.0                        # zero tail slices
    x[4, n // 2] = float("nan")                # its slice keeps all but NaN
    x[4, :: 97] = float("inf")
    x[4, 1:: 89] = float("-inf")
    x[5, ::2] *= 1e-40                         # subnormals count as 0
    x[6] = (x[6].abs() + 0.5) * 1.1754944e-38  # mids go subnormal
    x[7, : n // 2: 3] = float("inf")
    x[7, n // 2:] *= 5e37                      # lo + h overflows
    return x


@pytest.mark.parametrize("n", [5000, 8192, 8192 + 17, 3 * 8192, 267009,
                               675584])
@pytest.mark.parametrize("frac", [0.01, 0.1, 0.5, 1.0])
def test_block_topk_kernel_matches_plain_bitwise(cuda, n, frac):
    """Every row case, with x aligned as the mask is and one element off
    (an odd offset into a larger buffer: scalar loads), and the CPU's plain
    version and kernel emulation on the same rows."""
    x = _special_rows(_rows((8, n), n)).to(cuda)
    off = torch.empty(8 * n + 1, device=cuda)[1:].view(8, n)
    off.copy_(x)
    want = ref.topk_mask_block_ref(x, frac)
    for t in (x, off):
        assert torch.equal(ttopk.topk_mask_block_rows(t, frac), want)
    assert torch.equal(ref.topk_mask_block_select(x, frac), want)
    assert torch.equal(ref.topk_mask_block_ref(x.cpu(), frac), want.cpu())
    assert want[2].all()


def test_topk_kernel_keeps_nan_like_the_plain_version(cuda):
    """A NaN is above +inf in the bit order of the reference and of B1, so
    the global mask always keeps it; the repaired plain version agrees."""
    x = _rows((4, 16389), 5).to(cuda)
    x[0, 1638] = float("nan")
    x[1, :: 7] = float("nan")
    x[2, 5] = float("inf")
    x[2, 6] = float("nan")
    x[3, :] = float("nan")
    for frac in (0.01, 0.1, 1.0):
        got = ttopk.topk_mask_rows(x, frac)
        assert torch.equal(got, ref.topk_mask_global_ref(x, frac))
        assert got[x.isnan()].all()
    assert int(ttopk.topk_mask_rows(x, 0.1)[0].sum()) == 1638


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("block", [False, True])
def test_topk_wrappers_cast_half_rows_to_f32(cuda, dtype, block):
    """bf16 / f16 rows are cast to f32 first, as the reference casts them."""
    x = _rows((3, 20011), 9).to(cuda).to(dtype)
    x[1] = torch.round(x[1] * 4) / 4
    fn, plain = ((ttopk.topk_mask_block_rows, ref.topk_mask_block_ref)
                 if block else (ttopk.topk_mask_rows,
                                ref.topk_mask_global_ref))
    got = fn(x, 0.1)
    assert torch.equal(got, plain(x.float(), 0.1))
    assert torch.equal(got, plain(x.cpu(), 0.1).to(cuda))


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("n", [1, 7, 77, 1000, 267009, 1_000_003])
def test_codec_kernels_match_plain_bitwise(cuda, stochastic, n):
    x = _rows((8, n), n, scale=0.1).to(cuda)
    x[1, : n // 2] = 0.0
    x[2] = 0.0
    seed = 2**31 - 2 if stochastic else None
    q, s = tquant.quantize_rows(x, stochastic=stochastic, seed=seed)
    qr, sr = ref.quantize_rows_ref(x, stochastic=stochastic, seed=seed)
    assert torch.equal(q, qr) and torch.equal(s, sr)
    assert torch.equal(tquant.dequantize_rows(q, s),
                       ref.dequantize_rows_ref(qr, sr))


def test_codec_seed_tensor_equals_seed_value(cuda):
    """A one-element int32 or uint32 seed tensor on the card gives the codes
    of the same seed passed as an int; a seed on another device is
    refused."""
    x = _rows((33, 20011), 4, scale=0.1).to(cuda)
    want = ref.quantize_rows_ref(x, stochastic=True, seed=2**31 - 2)
    for dtype in (torch.int32, torch.uint32):
        seed = torch.full((1,), 2**31 - 2, dtype=dtype, device=cuda)
        q, s = tquant.quantize_rows(x, stochastic=True, seed=seed)
        assert torch.equal(q, want[0]) and torch.equal(s, want[1])
    with pytest.raises(ValueError, match="seed"):
        tquant.quantize_rows(x, stochastic=True,
                             seed=torch.tensor([5], dtype=torch.int32))


def test_kernels_replay_in_a_cuda_graph(cuda):
    """``topk_mask_rows`` and stochastic ``quantize_rows`` with a device
    seed captured in one CUDA graph: new rows and a new seed written into
    the static buffers before each replay give the plain versions' results
    on them, bitwise."""
    x = _rows((8, 267009), 11).to(cuda)
    seed = torch.zeros((1,), dtype=torch.int32, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ttopk.topk_mask_rows(x, 0.1)
        tquant.quantize_rows(x, stochastic=True, seed=seed)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        mask = ttopk.topk_mask_rows(x, 0.1)
        q, s = tquant.quantize_rows(x, stochastic=True, seed=seed)
    for step, value in enumerate((7, 2**31 - 2, 123)):
        x.copy_(_rows((8, 267009), 20 + step).to(cuda))
        x[1] = torch.round(x[1] * 4) / 4
        seed.fill_(value)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(mask, ref.topk_mask_global_ref(x, 0.1))
        qr, sr = ref.quantize_rows_ref(x, stochastic=True, seed=value)
        assert torch.equal(q, qr) and torch.equal(s, sr)


def test_one_device_launch_per_call(cuda):
    """``topk_mask_rows`` and ``quantize_rows`` each run as one kernel on the
    device: no memset, no second launch."""
    from torch.profiler import ProfilerActivity, profile
    x = _rows((8, 267009), 12).to(cuda)
    for fn in (lambda: ttopk.topk_mask_rows(x, 0.1),
               lambda: tquant.quantize_rows(x),
               lambda: tquant.quantize_rows(x, stochastic=True, seed=3)):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ops = [e.name for e in prof.events()
               if e.device_type.name == "CUDA"]
        assert len(ops) == 1, ops


def test_max_abs_fold_takes_first_user_on_ties_on_the_card(cuda):
    """``torch.argmax`` keeps the first maximal index on the card too, so
    the fold equals the CPU's (which tests/test_torch_federated.py holds
    to the reference) on rows that tie, also across signs."""
    from repro_torch.core.federated import combine_max_abs
    x = torch.round(_rows((4, 5000), 3) * 4) / 4
    x[2, :500] = -x[0, :500]
    x[3, 500:1000] = x[1, 500:1000]
    assert torch.equal(combine_max_abs(x.to(cuda)).cpu(), combine_max_abs(x))


def test_cuda_tensors_launch_the_kernels(cuda):
    """``kernels.ops`` sends a CUDA tensor to the kernel (counted), never to
    the plain version."""
    ops.reset_launch_counts()
    x = _rows((3, 5000), 1).to(cuda)
    ops.topk_mask(x, 0.1)
    ops.topk_mask(x, 0.1, mode="block")
    ops.dequantize_rows(*ops.quantize_rows(x, stochastic=True, seed=5))
    assert ops.launch_counts() == {"topk_mask_rows": 1, "topk_mask_block": 1,
                                   "quantize_rows": 1, "dequantize_rows": 1,
                                   "flash_attention": 0, "ssd_scan": 0}
    with pytest.raises(ValueError, match="contiguous"):
        ttopk.topk_mask_rows(x.t(), 0.1)
    with pytest.raises(ValueError):
        ttopk.topk_mask_rows(x.double(), 0.1)


def test_cohort_session_launches_the_kernels_every_round(cuda):
    """A cohort-virtualized approach-1 session with int8 uploads and error
    feedback runs on the card: one top-k, one quantize and one dequantize
    launch per round, on C rows; the store stays on the card."""
    from repro_torch.core.approaches import DistGANConfig
    from repro_torch.core.gan import MLPGanConfig, make_mlp_pair
    from repro_torch.core.protocol import run_distgan
    from repro_torch.data import digits_like_mixture, dirichlet_partition
    rng = np.random.default_rng(0)
    _, sample = digits_like_mixture(list(range(10)), size=8)
    data = sample(rng, 400).reshape(400, -1)
    dataset = dirichlet_partition(data, rng.integers(0, 10, 400), 6, 0.5)
    ops.reset_launch_counts()
    res = run_distgan(
        make_mlp_pair(MLPGanConfig(data_dim=64, z_dim=16, g_hidden=32,
                                   d_hidden=32)),
        DistGANConfig(num_users=6, combiner="staleness_max_abs"), dataset,
        "approach1", steps=8, batch_size=16, eval_samples=0,
        rounds_per_jit=4, participation="uniform", cohort_size=3,
        fuse_store_rounds=True, codec="topk_int8", device=cuda)
    counts = ops.launch_counts()
    assert (counts["topk_mask_rows"], counts["quantize_rows"],
            counts["dequantize_rows"]) == (8, 8, 8)
    assert np.all(np.isfinite(res.g_losses)) and res.d_losses.shape == (8, 3)
    assert res.extra["participation_counts"].sum() == 8 * 3
    assert res.state.ds["l1"]["w"].device.type == "cuda"


# ---------------------------------------------------------------------------
# The round engines as CUDA graphs
# ---------------------------------------------------------------------------

_SMALL = dict(data_dim=64, z_dim=16, g_hidden=32, d_hidden=32)

_GRAPH_CASES = {
    "approach1-none": ("approach1", dict(codec="none")),
    "approach1-topk_int8": ("approach1", dict(codec="topk_int8")),
    "approach1-topk_int8-sr": ("approach1", dict(codec="topk_int8",
                                                 codec_stochastic=True)),
    "approach1-random-int8-sr": ("approach1", dict(
        selection="random", codec="int8", codec_stochastic=True)),
    "approach2": ("approach2", {}),
    "approach3": ("approach3", {}),
    "baseline": ("baseline", {}),
    "download_first-sr": ("download_first", dict(codec="topk_int8",
                                                 codec_stochastic=True)),
}


def _equal_carries(a, b):
    from repro_torch.core.engine import carry_tensors
    ta, tb = carry_tensors(a), carry_tensors(b)
    return len(ta) == len(tb) and all(torch.equal(x, y)
                                      for x, y in zip(ta, tb)) \
        and torch.equal(a.generator.get_state(), b.generator.get_state())


@pytest.mark.parametrize("case", list(_GRAPH_CASES))
def test_graph_engine_equals_eager_chunk_bitwise(cuda, case):
    """``make_engine`` replays a captured chunk on a CUDA carry: two chunks
    of 4 rounds (capture, then a replay) and one of 3 (a graph of its own)
    give the eager chunk's state and metrics bitwise, drawing the same
    noise from the state's generator."""
    from repro_torch.core import approaches as tapp
    from repro_torch.core import engine as teng
    from repro_torch.core.gan import MLPGanConfig, make_mlp_pair
    from repro_torch.core.spec import resolve_approach
    approach, kw = _GRAPH_CASES[case]
    pair = make_mlp_pair(MLPGanConfig(**_SMALL))
    fcfg = tapp.DistGANConfig(num_users=3, error_feedback=False, **kw)
    sync = resolve_approach(approach).sync_ds
    shape = (8, 64) if approach == "baseline" else (3, 8, 64)
    reals = _rows((11,) + shape, 5).to(cuda)
    eager = teng.make_eager_engine(pair, fcfg, approach)
    graph = teng.make_engine(pair, fcfg, approach)
    a = tapp.init_state(pair, fcfg, 0, cuda, sync_ds=sync)
    b = tapp.init_state(pair, fcfg, 0, cuda, sync_ds=sync)
    for start, k in ((0, 4), (4, 4), (8, 3)):
        a, ma = eager(a, reals[start:start + k])
        b, mb = graph(b, reals[start:start + k])
        torch.cuda.synchronize()
        assert all(torch.equal(ma[key], mb[key]) for key in ma)
    assert _equal_carries(a, b)


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("approach,ef", [("approach1", True),
                                         ("approach1", False),
                                         ("download_first", True),
                                         ("approach2", False),
                                         ("approach3", False)])
def test_cohort_graph_engines_equal_eager_chunk_bitwise(cuda, approach, ef,
                                                        fuse):
    """Both cohort engines replay their chunk on a CUDA carry bitwise equal
    to the eager chunk (stochastic int8 with error feedback and adaptive
    weights where the approach uploads), and the plain engine leaves the
    carry it was given as it was."""
    from repro_torch.core import approaches as tapp
    from repro_torch.core import engine as teng
    from repro_torch.core import federated as tfed
    from repro_torch.core.gan import MLPGanConfig, make_mlp_pair
    from repro_torch.core.spec import resolve_approach
    pair = make_mlp_pair(MLPGanConfig(**_SMALL))
    uploads = resolve_approach(approach).uploads
    fcfg = tapp.DistGANConfig(
        num_users=8, combiner="staleness_max_abs",
        codec="topk_int8" if uploads else "none", error_feedback=ef,
        codec_stochastic=uploads)
    sync = resolve_approach(approach).sync_ds
    sched = tfed.make_schedule("uniform", 8, 3, 9,
                               np.random.default_rng(1))
    wts = torch.from_numpy(tfed.participation_weights(sched, 8)).to(cuda) \
        if uploads else None
    idx = torch.from_numpy(sched.astype(np.int64)).to(cuda)
    reals = _rows((9, 3, 8, 64), 6).to(cuda)
    mk = teng.make_fused_store_engine if fuse else teng.make_cohort_engine
    graph = mk(pair, fcfg, approach, adaptive=uploads)
    eager = teng.make_eager_cohort_engine(pair, fcfg, approach, uploads,
                                          copy_carry=not fuse)
    a = teng.init_cohort_state(pair, fcfg, 0, cuda, sync_ds=sync)
    b = teng.init_cohort_state(pair, fcfg, 0, cuda, sync_ds=sync)
    given = b
    for start, k in ((0, 4), (4, 4), (8, 1)):
        sl = slice(start, start + k)
        a, ma = eager(a, reals[sl], idx[sl], None if wts is None else wts[sl])
        b, mb = graph(b, reals[sl], idx[sl], None if wts is None else wts[sl])
        torch.cuda.synchronize()
        assert all(torch.equal(ma[key], mb[key]) for key in ma)
    assert _equal_carries(a, b)
    assert (b is given) == fuse
    if not fuse:
        assert _equal_carries(given, teng.init_cohort_state(
            pair, fcfg, 0, cuda, sync_ds=sync))


def _graph_session(cuda, engine="fused", codec="topk_int8", stochastic=True,
                   rpj=4):
    from repro_torch.core.approaches import DistGANConfig
    from repro_torch.core.gan import MLPGanConfig, make_mlp_pair
    from repro_torch.core.session import FederationSession
    from repro_torch.core.spec import (CombineSpec, CompressionSpec,
                                       EngineSpec, FederationSpec)
    from repro_torch.data import digits_like_mixture, dirichlet_partition
    rng = np.random.default_rng(0)
    _, sample = digits_like_mixture(list(range(10)), size=8)
    data = sample(rng, 400).reshape(400, -1)
    dataset = dirichlet_partition(data, rng.integers(0, 10, 400), 3, 0.5)
    spec = FederationSpec(
        "approach1", batch_size=8, eval_samples=16,
        engine=EngineSpec(kind=engine, rounds_per_jit=rpj),
        combine=CombineSpec(compression=CompressionSpec(
            codec=codec, error_feedback=False, stochastic=stochastic)))
    return FederationSession(make_mlp_pair(MLPGanConfig(**_SMALL)),
                             DistGANConfig(num_users=3), dataset, spec,
                             device=cuda)


@pytest.mark.parametrize("codec,stochastic", [("none", False),
                                              ("topk_int8", True)])
def test_graph_windows_and_per_step_equal_one_window(cuda, codec,
                                                     stochastic):
    """On the card, ``run(5); run(6)`` equals ``run(11)`` bitwise through
    graphs of chunk lengths 4, 1, 2 and 3, and the ``per_step`` loop (a
    one-round graph, fetched every round) equals the fused engine."""
    from repro_torch.convert import state_to_numpy
    whole = _graph_session(cuda, codec=codec, stochastic=stochastic).run(11)
    sess = _graph_session(cuda, codec=codec, stochastic=stochastic)
    first = sess.run(5)
    first_g = first.g_losses.copy()
    second = sess.run(6)
    per_step = _graph_session(cuda, "per_step", codec, stochastic).run(11)
    for other in (second, per_step):
        want, got = state_to_numpy(whole.state), state_to_numpy(other.state)
        for key in want:
            for x, y in zip(_leaves(want[key]), _leaves(got[key])):
                np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(
        np.concatenate([first_g, second.g_losses]), whole.g_losses)
    np.testing.assert_array_equal(per_step.g_losses, whole.g_losses)
    np.testing.assert_array_equal(second.samples, whole.samples)
    assert _graph_lengths(sess) == [1, 2, 4]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _graph_lengths(sess):
    """The chunk lengths a session's engine has captured."""
    return sorted(sess._driver.eng.graphs.graphs)


def test_launch_counts_count_graph_replays(cuda):
    """A captured kernel counts once per replay: a lossy session of 6
    rounds in chunks of 4 and 2 counts 6 top-k, quantize and dequantize
    launches (not the warm-up's or the capture's), and 6 more rounds
    through the same two graphs count 6 more."""
    sess = _graph_session(cuda)
    ops.reset_launch_counts()
    sess.run(6)
    want = dict.fromkeys(ops.launch_counts(), 0)
    want.update(topk_mask_rows=6, quantize_rows=6, dequantize_rows=6)
    assert ops.launch_counts() == want
    assert _graph_lengths(sess) == [2, 4]
    sess.run(6)
    want.update(topk_mask_rows=12, quantize_rows=12, dequantize_rows=12)
    assert ops.launch_counts() == want
    assert _graph_lengths(sess) == [2, 4]


def test_chunked_staging_equals_whole_window(cuda, monkeypatch):
    """A window over the staging cap goes chunk by chunk through two pinned
    host buffers, each chunk's copy on a side stream while the previous
    chunk replays: the same rounds, bitwise, as the window staged whole, for
    the fused and the cohort engine."""
    from repro_torch.core import session as tsess
    from repro_torch.core.approaches import DistGANConfig
    from repro_torch.core.gan import MLPGanConfig, make_mlp_pair
    from repro_torch.core.session import FederationSession
    from repro_torch.core.spec import (CombineSpec, CompressionSpec,
                                       EngineSpec, FederationSpec,
                                       ParticipationSpec)
    from repro_torch.data import digits_like_mixture, dirichlet_partition
    rng = np.random.default_rng(0)
    _, sample = digits_like_mixture(list(range(10)), size=8)
    data = sample(rng, 400).reshape(400, -1)
    dataset = dirichlet_partition(data, rng.integers(0, 10, 400), 6, 0.5)

    def run(cohort):
        spec = FederationSpec(
            "approach1", batch_size=8, eval_samples=0,
            engine=EngineSpec(rounds_per_jit=3, fuse_store_rounds=cohort),
            participation=ParticipationSpec(
                "uniform" if cohort else "full",
                cohort_size=3 if cohort else None),
            combine=CombineSpec(compression=CompressionSpec(
                codec="topk_int8", error_feedback=cohort, stochastic=True)))
        sess = FederationSession(make_mlp_pair(MLPGanConfig(**_SMALL)),
                                 DistGANConfig(num_users=6), dataset, spec,
                                 device=cuda)
        return [sess.run(8), sess.run(7)], sess._driver.state

    for cohort in (False, True):
        monkeypatch.setattr(tsess, "_STAGE_CAP_BYTES", 256 * 1024 * 1024)
        whole, ws = run(cohort)
        monkeypatch.setattr(tsess, "_STAGE_CAP_BYTES", 1)
        chunked, cs = run(cohort)
        assert _equal_carries(ws, cs)
        for a, b in zip(whole, chunked):
            np.testing.assert_array_equal(a.g_losses, b.g_losses)
            np.testing.assert_array_equal(a.d_losses, b.d_losses)


# ---------------------------------------------------------------------------
# The conv pair and checkpoints on the card
# ---------------------------------------------------------------------------

CONV_D_WIDTH = 675584    # the DCGAN D at 64 x 64 x 3, 64 base filters


def test_topk_and_codec_bitwise_at_the_conv_d_width(cuda):
    """B1 and B2 on 8 rows of the paper-width conv D (slices beyond shared
    memory, so B1's passes read device memory), upload fraction 0.1:
    bitwise their plain versions, ties and a half-sparse row included."""
    x = (_rows((8, CONV_D_WIDTH), 31) * 2e-4).to(cuda)
    x[1] = torch.round(x[1] * 2e4) / 2e4
    x[5, :CONV_D_WIDTH // 2] = 0.0
    assert torch.equal(ttopk.topk_mask_rows(x, 0.1),
                       ref.topk_mask_global_ref(x, 0.1))
    for stochastic, seed in ((False, None), (True, 2**31 - 2)):
        q, s = tquant.quantize_rows(x, stochastic=stochastic, seed=seed)
        qr, sr = ref.quantize_rows_ref(x, stochastic=stochastic, seed=seed)
        assert torch.equal(q, qr) and torch.equal(s, sr)
        assert torch.equal(tquant.dequantize_rows(q, s),
                           ref.dequantize_rows_ref(qr, sr))


_CONV = dict(image_size=16, channels=3, z_dim=16, base_filters=8)
_CONV_CASES = {
    "approach1-topk_int8-sr": ("approach1", dict(codec="topk_int8",
                                                 codec_stochastic=True)),
    "approach2": ("approach2", {}),
    "approach3-wgan": ("approach3", dict(loss_type="wgan", b1=0.0)),
    "baseline": ("baseline", {}),
}


@pytest.mark.parametrize("case", list(_CONV_CASES))
def test_conv_graph_engine_equals_eager_chunk_bitwise(cuda, case):
    """The DCGAN pair's rounds (cuDNN convolutions, per-user batch norms)
    replayed from CUDA graphs equal the eager chunk bitwise: deterministic
    cuDNN in both, the same algorithms captured as run."""
    from repro_torch.core import approaches as tapp
    from repro_torch.core import engine as teng
    from repro_torch.core.gan import ConvGanConfig, make_conv_pair
    from repro_torch.core.spec import resolve_approach
    approach, kw = _CONV_CASES[case]
    pair = make_conv_pair(ConvGanConfig(**_CONV))
    fcfg = tapp.DistGANConfig(num_users=3, error_feedback=False, **kw)
    sync = resolve_approach(approach).sync_ds
    shape = (8, 16, 16, 3) if approach == "baseline" else (3, 8, 16, 16, 3)
    reals = _rows((7,) + shape, 8).clamp(-1, 1).to(cuda)
    eager = teng.make_eager_engine(pair, fcfg, approach)
    graph = teng.make_engine(pair, fcfg, approach)
    a = tapp.init_state(pair, fcfg, 0, cuda, sync_ds=sync)
    b = tapp.init_state(pair, fcfg, 0, cuda, sync_ds=sync)
    for start, k in ((0, 3), (3, 3), (6, 1)):
        a, ma = eager(a, reals[start:start + k])
        b, mb = graph(b, reals[start:start + k])
        torch.cuda.synchronize()
        assert all(torch.equal(ma[key], mb[key]) for key in ma)
    assert _equal_carries(a, b)
    assert not torch.backends.cudnn.deterministic   # put back after


def _ckpt_session(cuda, kind):
    from repro_torch.core.approaches import DistGANConfig
    from repro_torch.core.gan import (ConvGanConfig, MLPGanConfig,
                                      make_conv_pair, make_mlp_pair)
    from repro_torch.core.session import FederationSession
    from repro_torch.core.spec import (CombineSpec, CompressionSpec,
                                       EngineSpec, FederationSpec,
                                       ParticipationSpec)
    from repro_torch.data import FederatedDataset
    rng = np.random.default_rng(0)
    conv = kind == "conv_approach1"
    shape = (16, 16, 3) if conv else (64,)
    shards = [rng.uniform(-1, 1, (50,) + shape).astype(np.float32)
              for _ in range(6)]
    dataset = FederatedDataset(
        [lambda r, n, x=x: x[r.integers(0, 50, n)] for x in shards],
        lambda r, n: shards[0][r.integers(0, 50, n)], {})
    cohort = kind == "cohort_fused_store"
    spec = FederationSpec(
        "approach1", batch_size=8, eval_samples=4,
        engine=EngineSpec(rounds_per_jit=4, fuse_store_rounds=cohort),
        participation=ParticipationSpec("uniform" if cohort else "full",
                                        cohort_size=3 if cohort else None),
        combine=CombineSpec(compression=CompressionSpec(
            codec="topk_int8", error_feedback=cohort, stochastic=True)))
    pair = (make_conv_pair(ConvGanConfig(**_CONV)) if conv else
            make_mlp_pair(MLPGanConfig(**_SMALL)))
    fcfg = DistGANConfig(num_users=6)
    return (FederationSession(pair, fcfg, dataset, spec, device=cuda),
            (pair, fcfg, dataset))


@pytest.mark.parametrize("kind", ["fused", "cohort_fused_store",
                                  "conv_approach1"])
def test_save_restore_resumes_bitwise_under_graphs(cuda, kind, tmp_path):
    """``run(5); save; restore; run(5)`` on the card, every chunk a graph
    replay, equals ``run(10)`` bitwise: the restored session builds its
    carry from the file before its first capture."""
    from repro_torch.core.session import FederationSession
    full, _ = _ckpt_session(cuda, kind)
    want = full.run(10)
    first, args = _ckpt_session(cuda, kind)
    w1 = first.run(5)
    first.save(str(tmp_path))
    second = FederationSession.restore(str(tmp_path), *args, device=cuda)
    w2 = second.run(5)
    np.testing.assert_array_equal(np.concatenate([w1.g_losses, w2.g_losses]),
                                  want.g_losses)
    np.testing.assert_array_equal(np.concatenate([w1.d_losses, w2.d_losses]),
                                  want.d_losses)
    np.testing.assert_array_equal(w2.samples, want.samples)
    assert _equal_carries(second._driver.state, full._driver.state)


# ---------------------------------------------------------------------------
# The int8 codec where the reference's f32 flushes subnormals
# ---------------------------------------------------------------------------

def _edge_rows(n, seed):
    """An absmax below 127 * 2^-126 (scale 0), subnormal entries under a
    subnormal and under a normal scale, inf entries (inf times inv = 0 is
    NaN: coded 0), a NaN, magnitudes just above the least normal scale."""
    x = _rows((7, n), seed)
    tiny = 127 * 2.0 ** -126
    x[0] *= 1e-37
    x[1] = 5e-39
    x[1, 0] = 1e-36
    x[2] *= 1e-38
    x[2, 0] = 3 * tiny
    x[3, ::7] = float("inf")
    x[3, 1::11] = float("-inf")
    x[4, n // 2] = float("nan")
    x[5] = x[5].abs() * 2.0 ** -126 + tiny
    return x


def _same_floats(a, b):
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        a[~nan].view(torch.int32), b[~nan].view(torch.int32))


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("n", [1, 77, 4096, 267009, 1_000_003])
def test_codec_kernels_flush_subnormals_like_plain(cuda, stochastic, n):
    """B2 on the flushed edges equals the repaired plain versions bitwise,
    signed zeros and NaN scales included; the flushed rows code to 0."""
    x = _edge_rows(n, n).to(cuda)
    seed = 123 if stochastic else None
    q, s = tquant.quantize_rows(x, stochastic=stochastic, seed=seed)
    qr, sr = ref.quantize_rows_ref(x, stochastic=stochastic, seed=seed)
    assert torch.equal(q, qr) and _same_floats(s, sr)
    if n > 1:
        assert not (q[0].any() or q[1].any() or q[3].any())
    assert _same_floats(tquant.dequantize_rows(q, s),
                        ref.dequantize_rows_ref(qr, sr))


def test_dequantize_kernel_takes_a_subnormal_scale_as_zero(cuda):
    q = torch.randint(-127, 128, (6, 5000), dtype=torch.int8, device=cuda)
    scale = torch.tensor([3e-39, 2.0 ** -126, 0.0, float("nan"),
                          float("inf"), 1e-3], device=cuda)
    got = tquant.dequantize_rows(q, scale)
    assert _same_floats(got, ref.dequantize_rows_ref(q, scale))
    assert not got[0].any()


# ---------------------------------------------------------------------------
# The host streaming backend on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["sync", "no_prefetch", "async",
                                  "superbatch", "stage_rows"])
def test_host_stream_on_the_card(cuda, mode):
    """A host-backend session on the card (pinned store, copy streams, one
    graph per round or per window): the sync modes equal the device cohort
    engine on the same schedule within 1e-6 (ages bitwise), async stays
    finite with its lag, and the int8 row legs add one quantize and one
    dequantize launch per round."""
    from repro_torch.core.approaches import DistGANConfig
    from repro_torch.core.gan import MLPGanConfig, make_mlp_pair
    from repro_torch.core.protocol import run_distgan
    from repro_torch.data import digits_like_mixture, dirichlet_partition
    rng = np.random.default_rng(0)
    _, sample = digits_like_mixture(list(range(10)), size=8)
    data = sample(rng, 400).reshape(400, -1)
    dataset = dirichlet_partition(data, rng.integers(0, 10, 400), 6, 0.5)
    pair = make_mlp_pair(MLPGanConfig(**_SMALL))
    kw = dict(steps=9, batch_size=16, eval_samples=0, rounds_per_jit=4,
              participation="uniform", cohort_size=3, codec="topk_int8",
              device=cuda)
    fcfg = DistGANConfig(num_users=6, combiner="staleness_max_abs")
    dev = run_distgan(pair, fcfg, dataset, "approach1",
                      fuse_store_rounds=True, **kw)
    host_kw = {"sync": {}, "no_prefetch": dict(prefetch=False),
               "async": dict(async_rounds=1),
               "superbatch": dict(fuse_store_rounds=True),
               "stage_rows": dict(stage_rows=True)}[mode]
    ops.reset_launch_counts()
    host = run_distgan(pair, fcfg, dataset, "approach1", state_backend="host",
                       **host_kw, **kw)
    legs = 9 if mode == "stage_rows" else 0
    counts = ops.launch_counts()
    assert (counts["topk_mask_rows"], counts["quantize_rows"],
            counts["dequantize_rows"]) == (9, 9 + legs, 9 + legs)
    assert host.extra["host_backend"].pinned
    assert host.extra["fused_store"] == (mode == "superbatch")
    assert np.all(np.isfinite(host.g_losses))
    if mode in ("sync", "no_prefetch", "superbatch"):
        np.testing.assert_array_equal(host.extra["mean_age"],
                                      dev.extra["mean_age"])
        np.testing.assert_allclose(host.g_losses, dev.g_losses, atol=1e-6,
                                   rtol=0)
        np.testing.assert_allclose(host.d_losses, dev.d_losses, atol=1e-6,
                                   rtol=0)
        for a, b in zip(_state_leaves(host.state), _state_leaves(dev.state)):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def _state_leaves(state):
    from repro_torch.models.common import tree_leaves
    return [t for f in ("g", "ds", "d_opts", "server_d")
            for t in tree_leaves(getattr(state, f))]


@pytest.mark.parametrize("name", ["adamw", "adamw_wd", "sgd_momentum"])
def test_optimizer_step_on_the_card_equals_the_cpu_step_bitwise(cuda, name):
    """Three steps of the port's optimizers on the card and on the CPU from
    the same parameters and gradients: the same bits (Adam's sqrt correctly
    rounded on both, ``p + u`` rounded once from the exact f64 product)."""
    from repro_torch import optim as topt
    make = {"adamw": lambda: topt.adamw(2e-4, b1=0.5, b2=0.999),
            "adamw_wd": lambda: topt.adamw(topt.linear_warmup(1e-3, 2),
                                           weight_decay=0.01),
            "sgd_momentum": lambda: topt.sgd(0.05, momentum=0.9)}[name]
    rng = np.random.default_rng(21)
    p0 = {"w": (rng.normal(size=(8, 784, 256)) * 0.05).astype(np.float32),
          "b": (rng.normal(size=(8, 256)) * 0.05).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * 1e-3).astype(np.float32)
              for k, v in p0.items()} for _ in range(3)]
    out = {}
    for dev in ("cpu", "cuda"):
        opt = make()
        p = {k: torch.tensor(v, device=dev) for k, v in p0.items()}
        st = opt.init(p)
        for g in grads:
            topt.apply_updates(p, opt.update(
                {k: torch.from_numpy(v).to(dev) for k, v in g.items()},
                st, p))
        out[dev] = {k: v.cpu() for k, v in p.items()}
    for k in p0:
        assert torch.equal(out["cpu"][k].view(torch.int32),
                           out["cuda"][k].view(torch.int32)), k
