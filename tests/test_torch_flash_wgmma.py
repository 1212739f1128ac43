"""The bf16 tensor-core flash-attention kernel (``csrc/flash_attention_wgmma.cu``)
on the CPU: an emulation of its arithmetic in PyTorch held to the JAX
reference, and the dtype routing of the wrapper.

The emulation repeats what the kernel does, tile by tile: bf16 inputs,
128-row query tiles and 128-key kv tiles (64-key at hd 256; keys past T
zero, as TMA fills them), f32 scores, the row max taken on the raw scores and moved to units
of ``scale * log2(e)``, ``p = exp2(s * scale * log2(e) - m)`` (one FMA in
the kernel), kv tiles that the mask hides entirely skipped, masks only on
tiles that straddle the diagonal, a window edge or T, ``p`` rounded to bf16
before ``p.v``, ``l`` summed from the f32 ``p`` and clamped at 1e-30, the
output in bf16.  It is held at atol 2e-2 (the bf16 tolerance of
``tests/test_kernels.py``) to the reference's ``flash_attention_pallas`` in
interpret mode and to its dense oracle.  The kernel itself is held to the
plain version on the card (``tests/test_torch_cuda_lm.py``)."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import flash_attention as tflash

TILE = 128
LOG2E = 1.4426950408889634
MASK = -2.0e38


def wgmma_emulation(q, k, v, *, causal, window, scale=None):
    """The kernel's arithmetic on bf16 q (B,S,H,hd), k/v (B,T,K,hd)."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    scale_log2 = torch.tensor(scale, dtype=torch.float32) * torch.tensor(
        LOG2E, dtype=torch.float32)
    KV = 64 if hd == 256 else TILE         # keys per kv tile
    t_pad = -(-T // KV) * KV
    kf = torch.zeros((B, t_pad, H, hd))
    vf = torch.zeros((B, t_pad, H, hd))
    kf[:, :T] = k.float().repeat_interleave(H // K, dim=2)
    vf[:, :T] = v.float().repeat_interleave(H // K, dim=2)
    out = torch.empty_like(q)
    for q0 in range(0, S, TILE):
        rows = torch.arange(q0, q0 + TILE)
        qt = torch.zeros((B, TILE, H, hd))
        n = min(TILE, S - q0)
        qt[:, :n] = q[:, q0:q0 + n].float()
        q_last = q0 + n - 1
        kv_end = min(T, q_last + 1) if causal else T
        kv_first = max(0, q0 - window + 1) if window else 0
        m = torch.full((B, H, TILE), MASK)
        l = torch.zeros((B, H, TILE))
        acc = torch.zeros((B, H, TILE, hd))
        for t in range(kv_first // KV, -(-kv_end // KV)):
            k0 = t * KV
            keys = torch.arange(k0, k0 + KV)
            s = torch.einsum("bqhd,bkhd->bhqk", qt, kf[:, k0:k0 + KV])
            need_mask = (k0 + KV > T or (causal and k0 + KV - 1 > q0)
                         or (window > 0 and k0 <= q0 + TILE - 1 - window))
            if need_mask:
                ok = (keys < T)[None, :].expand(TILE, KV)
                if causal:
                    ok = ok & (keys[None, :] <= rows[:, None])
                if window:
                    ok = ok & (keys[None, :] > rows[:, None] - window)
                s = torch.where(ok, s, torch.full_like(s, MASK))
            mx = torch.maximum(m, s.amax(-1) * scale_log2)
            p = torch.exp2(s * scale_log2 - mx[..., None])
            if need_mask:
                p = torch.where(ok, p, torch.zeros_like(p))
            alpha = torch.exp2(m - mx)
            l = alpha * l + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(torch.bfloat16).float(),
                vf[:, k0:k0 + KV])
            m = mx
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        out[:, q0:q0 + n] = o.permute(0, 2, 1, 3)[:, :n].to(torch.bfloat16)
    return out


def _qkv(B, S, H, K, hd, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32) for shape in
                 ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd)))


# (B, S, H, K, hd, causal, window): head dims 32/64/128/256; MHA, GQA 2
# and 8, MQA at hd 256 (recurrentgemma-9b's); causal, windows 64, 100 and
# 128, unmasked; S 192 runs a ragged 128-row tile
_CASES = [
    (1, 256, 2, 2, 32, True, 0),
    (1, 256, 4, 2, 64, True, 0),
    (1, 256, 8, 1, 128, True, 0),
    (1, 256, 2, 2, 64, True, 64),
    (1, 256, 4, 2, 128, True, 128),
    (1, 256, 8, 1, 32, True, 128),
    (1, 128, 2, 1, 32, False, 0),
    (1, 256, 8, 1, 64, False, 0),
    (1, 192, 4, 2, 64, True, 0),
    (1, 192, 2, 2, 128, True, 64),
    (1, 192, 8, 1, 32, False, 0),
    (2, 192, 4, 4, 64, True, 128),
    (1, 256, 4, 1, 256, True, 64),
    (1, 192, 2, 1, 256, True, 100),
]


@pytest.mark.parametrize("case", _CASES, ids=lambda c: "-".join(map(str, c)))
def test_emulation_matches_reference(case):
    B, S, H, K, hd, causal, window = case
    q, k, v = _qkv(B, S, H, K, hd, 11 * S + 3 * H + hd + window)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = wgmma_emulation(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    got = got.float().numpy()
    blk = math.gcd(S, TILE)          # the reference's tiles divide S
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    kern = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                bq=blk, bkv=blk)
    oracle = jref.flash_attention_ref(jq, jk, jv, causal=causal,
                                      window=window)
    np.testing.assert_allclose(got, np.asarray(kern, np.float32), atol=2e-2)
    np.testing.assert_allclose(got, np.asarray(oracle, np.float32),
                               atol=2e-2)
    plain = ref.flash_attention_ref(tq, tk, tv, causal=causal,
                                    window=window)
    np.testing.assert_allclose(got, plain.float().numpy(), atol=2e-2)


def test_emulation_rounds_only_p():
    """With p's bf16 rounding the only change, the emulation's f32 output
    stays within a bf16 step of the f32 plain version on bf16 inputs."""
    q, k, v = _qkv(1, 256, 4, 2, 64, 5)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = wgmma_emulation(tq, tk, tv, causal=True, window=0).float()
    want = ref.flash_attention_ref(tq.float(), tk.float(), tv.float(),
                                   causal=True)
    err = (got - want).abs().max().item()
    assert 0.0 < err <= 2e-2


def test_window_one_returns_each_rows_value():
    """Causal window 1: every row sees only its own key, so every other
    score of its tiles is masked (p = 0 explicitly) and out = v exactly."""
    q, k, v = _qkv(1, 128, 2, 2, 32, 9)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = wgmma_emulation(tq, tk, tv, causal=True, window=1)
    torch.testing.assert_close(got.float(), tv.float(), atol=0, rtol=0)


def test_dtype_routing():
    """bf16 takes the wgmma kernel, f32 the split-TF32 kernel, anything else
    is refused; both sources are built by build.py."""
    assert tflash.route(torch.bfloat16) == ("wgmma", "flash_attention_wgmma")
    assert tflash.route(torch.float32) == ("f32", "flash_attention_tf32")
    with pytest.raises(ValueError, match="f32 or bf16"):
        tflash.route(torch.float16)
    assert {"flash_attention_tf32", "flash_attention_wgmma"} <= set(
        build.sources())
    # the source and the shared Hopper header it includes
    src = (build.CSRC / "flash_attention_wgmma.cu").read_text()
    assert '#include "hopper.cuh"' in src
    src += (build.CSRC / "hopper.cuh").read_text()
    for instr in ("wgmma.mma_async", "cp.async.bulk.tensor", "mbarrier",
                  "setmaxnreg"):
        assert instr in src
    assert "bfloat16" not in (build.CSRC /
                              "flash_attention_tf32.cu").read_text()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_tensors_never_reach_a_kernel(dtype):
    q, k, v = (torch.from_numpy(a).to(dtype) for a in _qkv(1, 128, 2, 1, 32,
                                                           0))
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v)
    assert got.dtype == dtype
    assert ops.launch_counts()["flash_attention"] == 0
    assert ops.flash_route_counts() == {"wgmma": 0, "f32": 0}
    with pytest.raises(ValueError, match="CUDA"):
        tflash.flash_attention(q, k, v)


def test_route_counters_reset():
    tflash.launches, tflash.route_launches["wgmma"] = 5, 3
    tflash.route_launches["f32"] = 2
    assert ops.launch_counts()["flash_attention"] == sum(
        ops.flash_route_counts().values())
    ops.reset_launch_counts()
    assert ops.launch_counts()["flash_attention"] == 0
    assert ops.flash_route_counts() == {"wgmma": 0, "f32": 0}
    # the split stays beside launch_counts(), whose keys are unchanged
    assert set(ops.launch_counts()) == {
        "topk_mask_rows", "topk_mask_block", "quantize_rows",
        "dequantize_rows", "flash_attention", "ssd_scan"}
