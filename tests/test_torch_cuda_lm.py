"""The LM Hopper kernels (flash attention, the SSD scan) held to their plain
PyTorch versions on the card, and the reduced LM forwards on the card
(kernels) against the CPU (plain versions).

Every test here needs a CUDA device and nvcc: it carries the ``cuda``
marker and skips without a card.  The file imports no JAX (run it with
``--noconftest`` where JAX is missing):

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda_lm.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.models import model as TM
from repro_torch.models.ssm import ssd_chunked

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the Hopper kernels run only on the card")
    return torch.device("cuda")


def _normal(shape, seed, scale=1.0):
    return torch.from_numpy((np.random.default_rng(seed).normal(size=shape)
                             * scale).astype(np.float32))


# (B, S, H, K, hd, causal, window): the cases of tests/test_kernels.py
_FLASH = [(2, 256, 4, 4, 64, True, 0), (2, 256, 4, 2, 64, True, 0),
          (2, 128, 8, 1, 32, True, 0), (1, 256, 2, 2, 64, True, 64),
          (1, 256, 2, 2, 64, True, 128), (1, 128, 2, 2, 64, False, 0),
          (1, 192, 4, 2, 128, True, 0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", _FLASH, ids=lambda c: "-".join(map(str, c)))
def test_flash_kernel_matches_plain(cuda, case, dtype):
    B, S, H, K, hd, causal, window = case
    q, k, v = (_normal(s, i).to(cuda, dtype) for i, s in enumerate(
        [(B, S, H, hd), (B, S, K, hd), (B, S, K, hd)]))
    got = tflash.flash_attention(q, k, v, causal=causal, window=window,
                                 bq=64, bkv=64)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)


# bf16 cases of the wgmma kernel: hd 32/64/128, the ragged S 192 (a
# 128-row tile half past S), window edges, unmasked, and one full-width
# tinyllama head group (S 2048, 8 query heads over one kv head)
_WGMMA = [(2, 192, 4, 2, 32, True, 0), (1, 192, 8, 1, 64, True, 64),
          (1, 192, 2, 2, 128, False, 0), (1, 384, 4, 1, 128, True, 128),
          (2, 256, 8, 2, 32, False, 0), (1, 2048, 8, 1, 64, True, 0),
          (1, 2048, 8, 1, 64, True, 128)]


@pytest.mark.parametrize("case", _WGMMA, ids=lambda c: "-".join(map(str, c)))
def test_flash_wgmma_bf16_matches_plain(cuda, case):
    B, S, H, K, hd, causal, window = case
    q, k, v = (_normal(s, 10 + i).to(cuda, torch.bfloat16)
               for i, s in enumerate([(B, S, H, hd), (B, S, K, hd),
                                      (B, S, K, hd)]))
    ops.reset_launch_counts()
    got = tflash.flash_attention(q, k, v, causal=causal, window=window,
                                 bq=64, bkv=64)
    assert ops.flash_route_counts() == {"wgmma": 1, "f32": 0}
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=0)


def test_flash_routes_by_dtype(cuda):
    """A bf16 call counts on the wgmma route, an f32 call on the f32 route;
    the total counts both."""
    q = _normal((1, 128, 4, 64), 0).to(cuda)
    k = _normal((1, 128, 2, 64), 1).to(cuda)
    ops.reset_launch_counts()
    tflash.flash_attention(q, k, k)
    assert ops.flash_route_counts() == {"wgmma": 0, "f32": 1}
    qb, kb = q.to(torch.bfloat16), k.to(torch.bfloat16)
    ops.flash_attention(qb, kb, kb)
    ops.flash_attention(qb, kb, kb, causal=False)
    torch.cuda.synchronize()
    assert ops.flash_route_counts() == {"wgmma": 2, "f32": 1}
    assert ops.launch_counts()["flash_attention"] == 3
    with pytest.raises(ValueError, match="one type"):
        tflash.flash_attention(qb, k, k)


def _ssd(B, S, H, P, G, N, seed, dtype):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.normal(size=(B, S, H, P)) * 0.5
                          ).astype(np.float32)).to(dtype)
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.normal(size=(B, S, H)).astype(np.float32)))
    A = -torch.exp(torch.from_numpy(rng.uniform(0, 1, (H,)).astype(
        np.float32)))
    Bm = torch.from_numpy((rng.normal(size=(B, S, G, N)) * 0.3).astype(
        np.float32)).to(dtype)
    Cm = torch.from_numpy((rng.normal(size=(B, S, G, N)) * 0.3).astype(
        np.float32)).to(dtype)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("chunk", [16, 32, 64, 256])
@pytest.mark.parametrize("G", [1, 2])
def test_ssd_kernel_matches_plain(cuda, chunk, G):
    arrs = [a.to(cuda) for a in _ssd(2, 512, 4, 32, G, 16, chunk + G,
                                      torch.float32)]
    got = tssd.ssd_scan(*arrs, chunk=chunk)
    want = ref.ssd_scan_ref(*arrs)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_ssd_kernel_full_state_width(cuda):
    """N 128, P 64 (mamba2-780m's head) in f32, three chunks of 256."""
    arrs = [a.to(cuda) for a in _ssd(1, 768, 2, 64, 1, 128, 5,
                                      torch.float32)]
    got = tssd.ssd_scan(*arrs, chunk=256)
    torch.testing.assert_close(got, ref.ssd_scan_ref(*arrs), atol=1e-4,
                               rtol=1e-4)


# f32 cases of the split-TF32 kernel (B, S, H, P, G, N, chunk): chunks 16,
# 32, 64 and 256, P 16 and 128, N 4, 12 and 20 (not multiples of 8, zero-
# padded to 8 in shared memory), G 1 and 2, S not a multiple of 64 (chunk
# 48, and chunk 40 whose last 16-row tile is half padding), a 512-step
# chunk (four 128-row blocks), and N 340 at P 16 and N 176 at P 128, the
# widest states the CUDA-core kernel took, where tf32_plan falls back to
# smaller CTAs or key tiles
_SSD_TF32 = [(2, 256, 4, 16, 1, 4, 16), (1, 256, 4, 128, 2, 12, 32),
             (2, 192, 2, 32, 2, 20, 64), (1, 512, 4, 64, 1, 128, 256),
             (1, 240, 4, 16, 2, 16, 48), (1, 120, 2, 32, 1, 20, 40),
             (1, 1024, 2, 64, 1, 16, 512), (1, 256, 2, 16, 1, 340, 64),
             (1, 256, 2, 128, 1, 176, 128), (2, 512, 8, 128, 2, 64, 256)]


@pytest.mark.parametrize("case", _SSD_TF32,
                         ids=lambda c: "-".join(map(str, c)))
def test_ssd_tf32_matches_plain(cuda, case):
    """The split-TF32 f32 route at 1e-4 + 1e-4 |plain|, one launch counted
    on the f32 route."""
    B, S, H, P, G, N, chunk = case
    arrs = [a.to(cuda) for a in _ssd(B, S, H, P, G, N, S + N + P,
                                      torch.float32)]
    ops.reset_launch_counts()
    got = ops.ssd_scan(*arrs, chunk=chunk)
    assert ops.ssd_route_counts() == {"wgmma": 0, "f32": 1}
    want = ref.ssd_scan_ref(*arrs)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == arrs[0].shape
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("P", [16, 32, 64, 128])
def test_ssd_tf32_smem_sums_are_the_kernels(cuda, P):
    """tf32_plan's shared-memory sums are the kernel's own for every plan
    and shape it may meet, and the limit it plans within is the device's."""
    limit = tssd.smem_limit(cuda)
    for N in (4, 12, 20, 128, 176, 340):
        for chunk in (16, 32, 40, 48, 64, 256, 512):
            for rows in (16, 32, 48, 64, 128):
                for keys1 in (16, 32):
                    assert tssd.device_smem(P, N, chunk, rows, keys1,
                                            cuda) == (
                        *tssd.tf32_smem(P, N, chunk, rows, keys1), limit)


# f32 cases of the split-TF32 flash kernel (B, S, T, H, K, hd, causal,
# window): hd 32 and 128, a window that is not a multiple of the 64-key
# tile, unmasked, T != S (causal and not), and H / K = 8
_FLASH_TF32 = [(2, 192, 192, 4, 2, 32, True, 0),
               (1, 256, 256, 4, 1, 128, True, 0),
               (1, 320, 320, 4, 2, 64, True, 100),
               (1, 192, 192, 4, 4, 128, False, 0),
               (2, 128, 320, 4, 2, 64, False, 0),
               (1, 320, 128, 4, 2, 32, True, 0),
               (1, 256, 256, 16, 2, 64, True, 0),
               (1, 2048, 2048, 8, 1, 64, True, 0)]


@pytest.mark.parametrize("case", _FLASH_TF32,
                         ids=lambda c: "-".join(map(str, c)))
def test_flash_tf32_matches_plain(cuda, case):
    """The split-TF32 f32 route at 2e-5, one launch counted on the f32
    route."""
    B, S, T, H, K, hd, causal, window = case
    q, k, v = (_normal(s, 20 + i).to(cuda) for i, s in enumerate(
        [(B, S, H, hd), (B, T, K, hd), (B, T, K, hd)]))
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, causal=causal, window=window, bq=64,
                              bkv=64)
    assert ops.flash_route_counts() == {"wgmma": 0, "f32": 1}
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


def test_f32_routes_copy_unaligned_bases(cuda):
    """f32 tensors whose base is not 16-byte aligned still run (the wrapper
    copies them for cp.async) and agree with the plain versions."""
    x, dt, A, Bm, Cm = (a.to(cuda) for a in _ssd(1, 128, 2, 32, 1, 16, 7,
                                                 torch.float32))
    flat = torch.zeros(1 + x.numel(), device=cuda)
    xs = flat[1:].view(x.shape)          # base 4 bytes past alignment
    xs.copy_(x)
    torch.testing.assert_close(ops.ssd_scan(xs, dt, A, Bm, Cm, chunk=32),
                               ref.ssd_scan_ref(x, dt, A, Bm, Cm),
                               atol=1e-4, rtol=1e-4)
    q = _normal((1, 128, 2, 32), 8).to(cuda)
    flat = torch.zeros(1 + q.numel(), device=cuda)
    qs = flat[1:].view(q.shape)
    qs.copy_(q)
    torch.testing.assert_close(ops.flash_attention(qs, q, q),
                               ref.flash_attention_ref(q, q, q), atol=2e-5,
                               rtol=0)


def _dist(got, want):
    got, want = got.double(), want.double()
    return (float(torch.linalg.vector_norm(got - want)
                  / torch.linalg.vector_norm(want)),
            float((got - want).abs().max()))


# (B, S, H, P, G, N, chunk): the cases of tests/test_torch_ssd_wgmma.py
# (chunks of 64, 128 and 256 over 2-3 chunks, P 32 and 64, N 16 and 128,
# G 1 and 2), then the full state width over 3 chunks, P 128, a 192-row
# chunk (a chunk-scan CTA with one 64-row tile), and N 256 with P 128 at
# chunk 256 (one ring stage: two do not fit in shared memory)
_SSD_WGMMA = [(1, 128, 2, 32, 1, 16, 64), (1, 192, 4, 64, 2, 16, 64),
              (1, 256, 2, 64, 1, 128, 128), (1, 384, 4, 32, 2, 128, 128),
              (1, 512, 2, 32, 2, 16, 256), (1, 768, 2, 64, 1, 128, 256),
              (2, 768, 8, 64, 1, 128, 256), (1, 512, 4, 128, 2, 64, 256),
              (1, 384, 2, 64, 1, 128, 192), (1, 512, 2, 128, 1, 256, 256)]


@pytest.mark.parametrize("case", _SSD_WGMMA,
                         ids=lambda c: "-".join(map(str, c)))
def test_ssd_wgmma_bf16_matches_plain(cuda, case):
    """The bf16 kernel against the f32 recurrence on the same bf16 inputs:
    relative L2 and max |diff| each within 1.25x those of the model's plain
    path (ssd_chunked) in bf16, and relative L2 within 1e-2 (the criterion
    of tests/test_torch_ssd_wgmma.py)."""
    B, S, H, P, G, N, chunk = case
    x, dt, A, Bm, Cm = (a.to(cuda) for a in _ssd(B, S, H, P, G, N,
                                                 S + N + P + G,
                                                 torch.bfloat16))
    ops.reset_launch_counts()
    got = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    assert ops.ssd_route_counts() == {"wgmma": 1, "f32": 0}
    truth = ref.ssd_scan_ref(x.float(), dt, A, Bm.float(), Cm.float())
    plain, _ = ssd_chunked(x, dt, A, Bm, Cm, chunk)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    kern_l2, kern_max = _dist(got, truth)
    plain_l2, plain_max = _dist(plain, truth)
    assert kern_l2 <= 1.25 * plain_l2, (kern_l2, plain_l2)
    assert kern_max <= 1.25 * plain_max, (kern_max, plain_max)
    assert kern_l2 <= 1e-2


def test_ssd_routes_by_dtype(cuda):
    """A bf16 call counts on the wgmma route, an f32 call on the f32 route;
    the total counts both."""
    arrs = [a.to(cuda) for a in _ssd(1, 256, 2, 64, 1, 128, 3,
                                      torch.float32)]
    ops.reset_launch_counts()
    ops.ssd_scan(*arrs, chunk=64)
    assert ops.ssd_route_counts() == {"wgmma": 0, "f32": 1}
    x, dt, A, Bm, Cm = arrs
    xb, Bb, Cb = (t.to(torch.bfloat16) for t in (x, Bm, Cm))
    ops.ssd_scan(xb, dt, A, Bb, Cb, chunk=64)
    ops.ssd_scan(xb, dt, A, Bb, Cb, chunk=128)
    torch.cuda.synchronize()
    assert ops.ssd_route_counts() == {"wgmma": 2, "f32": 1}
    assert ops.launch_counts()["ssd_scan"] == 3


@pytest.mark.parametrize("S,P,N,chunk,what", [
    (256, 64, 128, 32, "chunk"), (240, 64, 128, 48, "chunk"),
    (256, 48, 128, 64, "P"), (256, 64, 8, 64, "N")])
def test_ssd_wgmma_refuses_what_it_does_not_take(cuda, S, P, N, chunk,
                                                 what):
    """bf16 CUDA tensors at shapes the wgmma kernel does not take raise;
    nothing falls back to the f32 kernel or the plain version."""
    x, dt, A, Bm, Cm = (a.to(cuda) for a in _ssd(1, S, 2, P, 1, N, 0,
                                                 torch.bfloat16))
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match=what):
        ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    assert ops.ssd_route_counts() == {"wgmma": 0, "f32": 0}


def test_ssd_wgmma_refuses_unaligned_bases(cuda):
    x, dt, A, Bm, Cm = (a.to(cuda) for a in _ssd(1, 128, 2, 32, 1, 16, 0,
                                                 torch.bfloat16))
    flat = torch.zeros(1 + x.numel(), dtype=torch.bfloat16, device=cuda)
    xs = flat[1:].view(x.shape)          # base 2 bytes past alignment
    xs.copy_(x)
    with pytest.raises(ValueError, match="16-byte"):
        ops.ssd_scan(xs, dt, A, Bm, Cm, chunk=64)


_LM = [("tinyllama-1.1b", None, "use_flash", 2e-4, 0.0),
       ("mamba2-780m", 16, "use_ssm_kernel", 5e-4, 1e-4)]


@pytest.mark.parametrize("arch,chunk,flag,atol,rtol", _LM,
                         ids=[c[0] for c in _LM])
def test_reduced_forward_card_matches_cpu(cuda, arch, chunk, flag, atol,
                                          rtol):
    cfg = get_config(arch).reduced()
    if chunk:
        cfg = dataclasses.replace(cfg, chunk_size=chunk)
    cpu = TM.init_params(cfg, 0, device="cpu")
    card = TM.init_params(cfg, 0, device=cuda)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int64))
    ops.reset_launch_counts()
    got, _ = TM.forward(card, {"tokens": tokens.to(cuda)}, cfg,
                        **{flag: True})
    assert ops.launch_counts()[{"use_flash": "flash_attention",
                                "use_ssm_kernel": "ssd_scan"}[flag]] == \
        cfg.num_layers
    routes = (ops.flash_route_counts() if flag == "use_flash"
              else ops.ssd_route_counts())
    assert routes == {"wgmma": 0, "f32": cfg.num_layers}
    want, _ = TM.forward(cpu, {"tokens": tokens}, cfg, **{flag: True})
    torch.testing.assert_close(got.cpu(), want, atol=atol, rtol=rtol)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = _normal((1, 128, 2, 48), 0).to(cuda)
    with pytest.raises(ValueError, match="hd"):
        tflash.flash_attention(q, q, q)
    q = _normal((1, 128, 3, 32), 0).to(cuda)
    k = _normal((1, 128, 2, 32), 1).to(cuda)
    with pytest.raises(ValueError, match="H % K"):
        tflash.flash_attention(q, k, k)
    flat = torch.zeros(1 + 128 * 2 * 32, dtype=torch.bfloat16, device=cuda)
    q = flat[1:].view(1, 128, 2, 32)          # base 2 bytes past alignment
    with pytest.raises(ValueError, match="16-byte"):
        tflash.flash_attention(q, q, q)
    x, dt, A, Bm, Cm = (a.to(cuda) for a in _ssd(1, 64, 2, 32, 1, 16, 0,
                                                 torch.float32))
    with pytest.raises(ValueError, match="multiple"):
        tssd.ssd_scan(x, dt, A, Bm, Cm, chunk=48)
    with pytest.raises(ValueError, match="one type"):
        tssd.ssd_scan(x.to(torch.bfloat16), dt, A, Bm, Cm, chunk=32)
