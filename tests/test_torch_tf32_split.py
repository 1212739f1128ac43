"""The split-TF32 arithmetic of the f32 kernels
(``csrc/flash_attention_tf32.cu``, ``csrc/ssd_scan_tf32.cu``) on the CPU,
before any card sees it.

``kernels/ref.py::tf32_split_matmul`` emulates a split-TF32 product: each
operand rounded to hi = tf32(a) and lo = tf32(a - hi) (Veltkamp's split, as
the kernels round) and three TF32 products accumulated in f32.  Attention
and the chunked SSD scan computed with it
(``ref.flash_attention_tf32_emulation``, ``ref.ssd_scan_tf32_emulation``,
which the profilers also run on the card), in the kernels' order of work
(scores in units of log2 e; the SSD's per-group scores C B^T, chunk states,
f32 state carry, then C S_before and G' x), are held to the f32 plain
versions (``ref.flash_attention_ref``, ``ref.ssd_scan_ref``) at the f32
contracts of the card (2e-5; 1e-4 + 1e-4 |plain|) on the shapes the card
checks.  The route and launch-plan choice and the bound reckoning are pure
functions, tested here too.  The kernels themselves are held to the plain
versions on the card (``tests/test_torch_cuda_lm.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from repro_torch import timing
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as tssd


def _normal(shape, seed, scale=1.0):
    return torch.from_numpy((np.random.default_rng(seed).normal(size=shape)
                             * scale).astype(np.float32))


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 7.5, 3e4])
def test_split_is_two_tf32_values_carrying_x(scale):
    """hi and lo keep 11 significant bits (the low 13 mantissa bits zero),
    hi is x to nearest (half a TF32 ulp, 2^-11 relative) and hi + lo carries
    x to 2^-22 relative."""
    x = _normal((4096,), 1, scale)
    hi, lo = ref.tf32_split(x)
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    xd = x.double()
    assert float(((xd - hi.double()).abs() / xd.abs()).max()) <= 2.0 ** -11
    rest = (xd - hi.double() - lo.double()).abs() / xd.abs()
    assert float(rest.max()) <= 2.0 ** -22


def test_split_rounds_to_nearest_not_toward_zero():
    """The tensor core would truncate; the kernels round, so the split of a
    value just below a TF32 step goes up and the error is unbiased."""
    step = 2.0 ** -10                         # a TF32 ulp at 1.0
    x = torch.tensor([1.0 + 0.75 * step, -(1.0 + 0.75 * step)])
    hi, _ = ref.tf32_split(x)
    assert hi.tolist() == [1.0 + step, -(1.0 + step)]
    # the magnitude lost on average: ~0 rounded, ~2^-12 of |x| truncated
    xs = _normal((1 << 16,), 5)
    truncated = (xs.view(torch.int32) & ~0x1FFF).view(torch.float32)
    for part, lo, hi in ((ref.tf32_round(xs), -1e-5, 1e-5),
                         (truncated, 1e-4, 3e-4)):
        bias = float((xs.abs().double() - part.abs().double()).mean())
        assert lo < bias < hi, bias


@pytest.mark.parametrize("M,K,N", [(16, 8, 8), (64, 128, 64), (128, 64, 32),
                                   (256, 2048, 64)])
def test_split_matmul_matches_f32_products(M, K, N):
    """Three TF32 products come as close to the f64 product as an f32
    matmul does (within 2x of its error and 1e-6 relative to the row
    norms)."""
    a, b = _normal((M, K), M + K), _normal((K, N), K + N)
    exact = a.double() @ b.double()
    split_err = (ref.tf32_split_matmul(a, b).double() - exact).abs().max()
    f32_err = ((a @ b).double() - exact).abs().max()
    scale = float(a.double().norm(dim=1).max() * b.double().norm(dim=0).max())
    assert float(split_err) <= max(2 * float(f32_err), 1e-6 * scale)


def test_one_tf32_product_would_not_hold_the_contracts():
    """Why the split: hi . hi alone misses by ~1e-3 relative."""
    a, b = _normal((64, 64), 3), _normal((64, 64), 4)
    hi_only = ref.tf32_round(a) @ ref.tf32_round(b)
    exact = a.double() @ b.double()
    assert float((hi_only.double() - exact).abs().max()) > 1e-3


# (B, S, T, H, K, hd, causal, window): the f32 cases chip_smoke.py and
# tests/test_kernels.py check, then the card tests' split-TF32 cases (hd 32
# and 128, a window off the 32-key tile, unmasked, T != S, H / K = 8, a
# full-width head group)
_FLASH = [(2, 256, 256, 4, 4, 64, True, 0), (2, 256, 256, 4, 2, 64, True, 0),
          (2, 128, 128, 8, 1, 32, True, 0), (1, 256, 256, 2, 2, 64, True, 64),
          (1, 256, 256, 2, 2, 64, True, 128),
          (1, 128, 128, 2, 2, 64, False, 0),
          (2, 192, 192, 4, 2, 32, True, 0), (1, 256, 256, 4, 1, 128, True, 0),
          (1, 320, 320, 4, 2, 64, True, 100),
          (1, 192, 192, 4, 4, 128, False, 0),
          (2, 128, 320, 4, 2, 64, False, 0), (1, 320, 128, 4, 2, 32, True, 0),
          (1, 256, 256, 16, 2, 64, True, 0),
          (1, 2048, 2048, 8, 1, 64, True, 0)]


@pytest.mark.parametrize("case", _FLASH, ids=lambda c: "-".join(map(str, c)))
def test_split_tf32_attention_holds_the_f32_contract(case):
    B, S, T, H, K, hd, causal, window = case
    q, k, v = (_normal(s, 30 + i) for i, s in enumerate(
        [(B, S, H, hd), (B, T, K, hd), (B, T, K, hd)]))
    got = ref.flash_attention_tf32_emulation(q, k, v, causal=causal,
                                             window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


def _ssd(B, S, H, P, G, N, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.normal(size=(B, S, H, P)) * 0.5
                          ).astype(np.float32))
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.normal(size=(B, S, H)).astype(np.float32)))
    A = -torch.exp(torch.from_numpy(rng.uniform(0, 1, (H,)).astype(
        np.float32)))
    Bm = torch.from_numpy((rng.normal(size=(B, S, G, N)) * 0.3).astype(
        np.float32))
    Cm = torch.from_numpy((rng.normal(size=(B, S, G, N)) * 0.3).astype(
        np.float32))
    return x, dt, A, Bm, Cm


# (B, S, H, P, G, N, chunk): the f32 cases chip_smoke.py checks (chunks
# 16, 32, 64; G 1, 2), then the card tests' split-TF32 cases (P 16 and
# 128, N 4, 12, 20, S not a multiple of 64, chunk 40 and 512) and
# mamba2-780m's head (P 64, N 128, chunk 256) over two chunks
_SSD = [(2, 128, 4, 32, g, 16, c) for c in (16, 32, 64) for g in (1, 2)] + [
    (2, 256, 4, 16, 1, 4, 16), (1, 256, 4, 128, 2, 12, 32),
    (2, 192, 2, 32, 2, 20, 64), (1, 240, 4, 16, 2, 16, 48),
    (1, 120, 2, 32, 1, 20, 40), (1, 1024, 2, 64, 1, 16, 512),
    (1, 512, 2, 64, 1, 128, 256)]


@pytest.mark.parametrize("case", _SSD, ids=lambda c: "-".join(map(str, c)))
def test_split_tf32_ssd_holds_the_f32_contract(case):
    B, S, H, P, G, N, chunk = case
    arrs = _ssd(B, S, H, P, G, N, S + N + P + G)
    got = ref.ssd_scan_tf32_emulation(*arrs, chunk)
    want = ref.ssd_scan_ref(*arrs)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def _cuda_core_smem(P, N, chunk):
    """Bytes the CUDA-core f32 kernel that this route replaced needed (its
    smem_bytes): the shapes it took are the f32 route's floor."""
    floats = N * P + 2 * 64 * (N + 4) + 64 * P + 64 * 68 + 3 * chunk
    return 4 * floats


# the shared memory a block may take on an H100 (sharedMemPerBlockOptin);
# the wrapper reads the device's own (ssd_scan.smem_limit)
H100_SMEM = 232448


@pytest.mark.parametrize("P", [16, 32, 64, 128])
def test_plan_takes_every_shape_the_cuda_core_kernel_took(P):
    """No f32 shape that the old kernel ran may start to raise: for every
    N (a multiple of 4) and chunk it fitted, tf32_plan finds a plan whose
    shared memory fits, within the plan's limits."""
    for N in range(4, 420, 4):
        for chunk in (16, 32, 40, 48, 64, 96, 128, 256, 512, 1024, 2048,
                      8192, 16384):
            if _cuda_core_smem(P, N, chunk) > H100_SMEM:
                continue
            plan = tssd.tf32_plan(P, N, chunk, H100_SMEM)
            assert plan["rows"] % 16 == 0 and 16 <= plan["rows"] <= 128
            assert plan["keys1"] in (16, 32)
            assert max(tssd.tf32_smem(P, N, chunk,
                                      *tssd.tf32_plan_args(plan))) \
                <= H100_SMEM


def test_plan_at_full_width_and_small_chunks():
    """mamba2-780m's head takes the fastest measured plan (PERF.md);
    small chunks shrink the CTA and the key tiles to the chunk."""
    assert tssd.tf32_plan(64, 128, 256, H100_SMEM) == {"rows": 128,
                                                       "keys1": 32}
    assert tssd.tf32_plan(32, 16, 16, H100_SMEM) == {"rows": 16,
                                                     "keys1": 16}
    assert tssd.tf32_plan(32, 16, 40, H100_SMEM)["rows"] == 48
    with pytest.raises(ValueError, match="N=1024"):
        tssd.tf32_plan(64, 1024, 256, H100_SMEM)


@pytest.mark.parametrize("limit", [H100_SMEM, 166912, 101376])
def test_plan_is_the_largest_that_fits_the_device(limit):
    """The plan follows the device's limit (an H100's, an A100's, 99 KB):
    it fits, and the next larger CTA of the chunk scan would not."""
    for P, N, chunk in ((64, 128, 256), (128, 176, 128), (128, 128, 256),
                        (32, 64, 512), (16, 16, 32)):
        plan = tssd.tf32_plan(P, N, chunk, limit)
        scores, state, scan = tssd.tf32_smem(P, N, chunk,
                                             *tssd.tf32_plan_args(plan))
        assert max(scores, state, scan) <= limit
        if plan["rows"] < min(128, chunk):
            bigger = tssd.tf32_smem(P, N, chunk, 2 * plan["rows"],
                                    plan["keys1"])[2]
            assert bigger > limit


def test_f32_route_ctas_at_full_width():
    assert tssd.tf32_ctas(4, 2048, 48, 64, 1, 128, 256, 128) == {
        "chunk_scores": 4 * 8 * 1 * 4 * 4, "chunk_state": 1536,
        "state_passing": 1536, "chunk_scan": 3072}


def test_routes_by_dtype_name_the_split_tf32_sources():
    from repro_torch.kernels import flash_attention as tflash
    assert tssd.route(torch.float32) == ("f32", "ssd_scan_tf32")
    assert tflash.route(torch.float32) == ("f32", "flash_attention_tf32")
    assert tssd.TF32_PHASES == {"chunk_scores": 8, "chunk_state": 1,
                                "state_passing": 2, "chunk_scan": 4}
    assert sum(tssd.TF32_PHASES.values()) == tssd.TF32_ALL_PHASES


@pytest.mark.parametrize("nbytes,flops,split,cores", [
    # tinyllama-1.1b attention in f32: q, k, v, out; the causal pairs
    (4 * (2 * 4 * 2048 * 32 * 64 + 2 * 4 * 2048 * 4 * 64),
     4 * 64 * 4 * 32 * 2048 * 2049 // 2, 0.4166, 1.0262),
    # mamba2-780m SSD in f32 (the counting of chip_smoke.py)
    (4 * (2 * 4 * 2048 * 48 * 64 + 2 * 4 * 2048 * 128) + 4 * (4 * 2048 * 48
                                                           + 48),
     4 * 48 * 8 * (2 * (256 * 257 // 2) * (128 + 64) + 4 * 256 * 128 * 64),
     0.1957, 0.4819)])
def test_f32_bounds_take_the_lower_of_split_tf32_and_cuda_cores(
        nbytes, flops, split, cores):
    b = timing.f32_bounds(nbytes, flops)
    assert b["split_tf32_bound_ms"] == pytest.approx(split, rel=2e-3)
    assert b["cuda_core_bound_ms"] == pytest.approx(cores, rel=2e-3)
    assert b["bound_ms"] == b["split_tf32_bound_ms"]
    assert b["bound_by"] == "operations"


def test_bound_is_the_larger_of_bytes_and_operations():
    assert timing.bound_ms(3.35e9, 0.0, timing.F32_OPS_PER_S) == (
        pytest.approx(1.0), "bytes")
    assert timing.bound_ms(0.0, 67e9, timing.F32_OPS_PER_S) == (
        pytest.approx(1.0), "operations")
    # a split-TF32 kernel's bound is below the CUDA cores' (3 x 67 < 495)
    # and above a plain TF32 product's
    b = timing.f32_bounds(0.0, 1e12)
    assert 1e12 / timing.TF32_OPS_PER_S * 1e3 < b["bound_ms"] < \
        b["cuda_core_bound_ms"]
