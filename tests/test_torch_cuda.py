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


@pytest.mark.parametrize("n", [5000, 8192, 8192 + 17, 3 * 8192, 267009])
@pytest.mark.parametrize("frac", [0.01, 0.1, 0.5])
def test_block_topk_kernel_matches_plain_bitwise(cuda, n, frac):
    x = _rows((8, n), n).to(cuda)
    x[1] = torch.round(x[1] * 4) / 4           # ties
    x[2] = 0.0                                 # all-zero row: lo = 0
    x[3, n // 3:] = 0.0                        # zero tail slices
    got = ttopk.topk_mask_block_rows(x, frac)
    assert torch.equal(got, ref.topk_mask_block_ref(x, frac))
    assert got[2].all()


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
