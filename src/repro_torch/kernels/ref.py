"""Plain PyTorch versions of the Hopper kernels (port of the reference's
``kernels/ref.py``).

These are the oracles every kernel is held to and the path a CPU tensor
takes through ``kernels/ops.py``.  The codec and top-k versions are held
bitwise, so they repeat the reference's eager arithmetic operation by
operation:

* divisions are tensor-by-tensor (a division by a Python scalar may be
  lowered to a multiply by its reciprocal, which rounds differently);
* ``torch.round`` is half-to-even, like ``jnp.round``;
* the stochastic-rounding hash runs in int64 with ``& 0xFFFFFFFF`` after
  every step, which reproduces uint32 wraparound on any device.
"""

from __future__ import annotations

import math

import torch

_M32 = 0xFFFFFFFF
MIN_NORMAL = 2.0 ** -126           # f32's least normal magnitude


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``(h * c) mod 2**32`` for int64 ``h`` in [0, 2**32) without int64
    overflow: split ``c`` into 16-bit halves."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _M32


def hash_u01(row: torch.Tensor, col: torch.Tensor, seed) -> torch.Tensor:
    """The reference's counter hash ``_hash_u01`` (``quantize.py:37-49``):
    uint32 xorshift-multiply mix of (row, column, seed) -> f32 in [0, 1).
    ``seed`` is an int or a one-element integer tensor (read on the
    device, as the kernel reads a seed tensor)."""
    if isinstance(seed, torch.Tensor):
        s = seed.reshape(()).to(device=col.device, dtype=torch.int64) & _M32
        seed_term = _mul32(s, 0xC2B2AE3D)
    else:
        seed_term = ((int(seed) & _M32) * 0xC2B2AE3D) & _M32
    h = (_mul32(col.to(torch.int64), 0x9E3779B1)
         + _mul32(row.to(torch.int64), 0x85EBCA77) + seed_term) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    return h.to(torch.float32) * (1.0 / 4294967296.0)


def quantize_rows_ref(x: torch.Tensor, *, stochastic: bool = False,
                      seed=None):
    """(R, N) f32 -> (q int8 (R, N), scale f32 (R,)):
    ``scale = max|x[r]| / 127``, ``inv = where(scale > 0, 1/scale, 0)``,
    ``q = clip(round(x * inv), -127, 127)`` (or stochastic rounding keyed
    by the counter hash on ``seed``, an int or a one-element tensor).

    As the reference's f32 does (XLA on the CPU and the TPU flush
    subnormals to zero), subnormal entries, a subnormal scale (an absmax
    below ``127 * 2**-126``) and a subnormal ``x * inv`` count as 0, and a
    NaN ``x * inv`` (a NaN entry, or an inf one times ``inv = 0``) codes as
    0, as XLA converts NaN to an integer."""
    x = flush_subnormals(x.to(torch.float32))
    absmax = torch.amax(torch.abs(x), dim=1)
    scale = flush_subnormals(absmax / torch.full_like(absmax, 127.0))
    inv = torch.where(scale > 0, torch.ones_like(scale) / scale,
                      torch.zeros_like(scale))
    y = flush_subnormals(x * inv[:, None])
    y = torch.where(torch.isnan(y), torch.zeros_like(y), y)
    if stochastic:
        assert seed is not None, "stochastic rounding needs a seed"
        y = torch.clamp(y, -127.0, 127.0)
        f = torch.floor(y)
        rows = torch.arange(x.shape[0], device=x.device)[:, None]
        cols = torch.arange(x.shape[1], device=x.device)[None, :]
        u = hash_u01(rows.expand(x.shape), cols.expand(x.shape), seed)
        q = f + (u < (y - f)).to(torch.float32)
        return torch.clamp(q, -127.0, 127.0).to(torch.int8), scale
    return torch.clamp(torch.round(y), -127.0, 127.0).to(torch.int8), scale


def dequantize_rows_ref(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``q * scale[r]`` as f32, a subnormal scale taken as 0 as the
    reference's f32 takes it.  Nothing else can underflow: for ``|q| >= 1``
    the product's magnitude is at least the scale's."""
    return q.to(torch.float32) * flush_subnormals(
        scale.to(torch.float32))[:, None]


def topk_k(n: int, frac: float) -> int:
    """``k = max(int(n * frac), 1)`` with Python float semantics, exactly
    as the reference computes it (``topk_select.py:121``)."""
    return max(int(n * frac), 1)


BLOCK = 8 * 128 * 8      # the block-local top-k's slice (topk_select.py:40)
_BISECT_ITERS = 32
_INF_BITS = 0x7F800000


def mag_bits(x: torch.Tensor) -> torch.Tensor:
    """``|x|`` as int32 bit patterns, ``x`` cast to f32 first (the
    reference's ``_mag_bits``, ``topk_select.py:94-99``): the patterns'
    order is the magnitudes' order, with NaN above +inf."""
    return x.to(torch.float32).contiguous().view(torch.int32) & 0x7FFFFFFF


def flush_subnormals(v: torch.Tensor) -> torch.Tensor:
    """``v`` with its subnormals as zeros of their sign, as the reference's
    f32 takes them (XLA on the CPU and the TPU flush subnormals to zero);
    NaN and inf pass."""
    return torch.where(torch.abs(v) < MIN_NORMAL, v * 0, v)


def topk_mask_block_ref(x: torch.Tensor, frac: float) -> torch.Tensor:
    """Block-local top-k, the reference kernel's own arithmetic
    (``topk_select.py:45-87``): each row is zero-padded to a multiple of
    ``BLOCK`` and every ``BLOCK`` slice keeps ``|x| >= lo`` after a 32-step
    f32 bisection (``lo = 0``, ``hi = max|x|``, ``mid = 0.5 * (lo + hi)``,
    ``count(|x| >= mid) >= k`` -> ``lo = mid`` else ``hi = mid``) with
    ``k = max(int(BLOCK * frac), 1)``, subnormal magnitudes and mids taken
    as 0.  A NaN in a slice makes its ``hi`` NaN and keeps ``lo = 0``.
    ``x`` is (N,) or (C, N); a row is padded on its own."""
    if x.ndim == 1:
        return topk_mask_block_ref(x[None], frac)[0]
    rows, n = x.shape
    k = topk_k(BLOCK, frac)
    mag = flush_subnormals(torch.abs(x.to(torch.float32)))
    mag = torch.nn.functional.pad(mag, (0, (-n) % BLOCK)).reshape(-1, BLOCK)
    hi = torch.amax(mag, dim=1)
    lo = torch.zeros_like(hi)
    half = torch.full_like(hi, 0.5)
    for _ in range(_BISECT_ITERS):
        mid = flush_subnormals(half * (lo + hi))
        take = torch.sum(mag >= mid[:, None], dim=1) >= k
        lo, hi = torch.where(take, mid, lo), torch.where(take, hi, mid)
    return (mag >= lo[:, None]).reshape(rows, -1)[:, :n]


def topk_mask_block_select(x: torch.Tensor, frac: float) -> torch.Tensor:
    """The block top-k as the Hopper kernel computes it
    (``csrc/topk_block.cu``): per zero-padded slice, ``hi`` the largest
    ``|x|`` pattern (NaN above +inf), ``v_k`` the exact k-th largest pattern
    (subnormals as 0), then the reference's 32 steps replayed on scalars
    with ``count(|x| >= mid) >= k`` read as ``v_k >= mid``; a NaN ``hi`` or
    ``k > BLOCK`` keeps ``lo = 0``.  Equal to :func:`topk_mask_block_ref`
    on every input.  A plain emulation for the tests; no path of the port
    calls it."""
    if x.ndim == 1:
        return topk_mask_block_select(x[None], frac)[0]
    rows, n = x.shape
    k = topk_k(BLOCK, frac)
    bits = mag_bits(x)
    bits = torch.where(bits < 0x00800000, torch.zeros_like(bits), bits)
    bits = torch.nn.functional.pad(bits, (0, (-n) % BLOCK)).reshape(-1, BLOCK)
    hi_bits = torch.amax(bits, dim=1)
    select = hi_bits <= _INF_BITS
    if k <= BLOCK:
        vk = torch.topk(bits, k, dim=1).values[:, -1].view(torch.float32)
    else:
        select = torch.zeros_like(select)
        vk = torch.zeros(bits.shape[0], dtype=torch.float32, device=x.device)
    hi = hi_bits.view(torch.float32)
    lo = torch.zeros_like(hi)
    half = torch.full_like(hi, 0.5)
    for _ in range(_BISECT_ITERS):
        mid = flush_subnormals(half * (lo + hi))
        take = select & (vk >= mid)
        lo, hi = torch.where(take, mid, lo), torch.where(take, hi, mid)
    mag = bits.view(torch.float32)
    return (mag >= lo[:, None]).reshape(rows, -1)[:, :n]


def topk_mask_global_ref(x: torch.Tensor, frac: float) -> torch.Tensor:
    """Row-wise full-vector top-k: keep entries whose ``|x|`` bit pattern is
    ``>=`` the k-th largest pattern of their row (ties kept), ordered as
    the reference and the kernel order them (:func:`mag_bits`: a NaN is
    above +inf, so it is always kept).  ``k`` over N keeps every entry, as
    k = N does.  ``x`` is (N,) or (C, N)."""
    k = min(topk_k(x.shape[-1], frac), x.shape[-1])
    bits = mag_bits(x)
    kth = torch.topk(bits, k, dim=-1).values[..., -1:]
    return bits >= kth


def flash_attention_ref(q, k, v, *, causal=True, window=0, scale=None):
    """Dense attention matching the flash kernel: q (B,S,H,hd), k/v
    (B,T,K,hd) with H % K == 0 -> (B,S,H,hd) in q's type.  Scores, softmax
    and the weighted sum in f32; masked scores are the finite -2e38."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    G = H // K
    qg = q.reshape(B, S, K, G, hd).to(torch.float32)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.to(torch.float32)) * scale
    qp = torch.arange(S, device=q.device)[:, None]
    kp = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= kp > qp - window
    s = torch.where(mask, s, torch.full_like(s, -2.0e38))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.to(torch.float32))
    return out.reshape(B, S, H, hd).to(q.dtype)


def ssd_scan_ref(x, dt, A, Bm, Cm, *, chunk: int = 256):
    """Sequential-recurrence version of the SSD kernel (O(S) scan, exact in
    f32): x (B,S,H,P), dt (B,S,H), A (H,), Bm/Cm (B,S,G,N) -> y (B,S,H,P)
    in x's type.  ``chunk`` is accepted for the kernel's signature and does
    not change the result."""
    del chunk
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Bh = torch.repeat_interleave(Bm, rep, dim=2).to(torch.float32)
    Ch = torch.repeat_interleave(Cm, rep, dim=2).to(torch.float32)
    xf = x.to(torch.float32)
    dtf = dt.to(torch.float32)
    Af = A.to(torch.float32)
    state = torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * Af)                      # (B,H)
        state = state * decay[..., None, None] + torch.einsum(
            "bhn,bhp->bhnp", Bh[:, t], xf[:, t] * dtf[:, t, :, None])
        ys.append(torch.einsum("bhn,bhnp->bhp", Ch[:, t], state))
    return torch.stack(ys, dim=1).to(x.dtype)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to nearest with 11 significant bits (a TF32 value),
    as the split-TF32 kernels round (``csrc/tf32_mma.cuh::round_tf32``:
    Veltkamp's split with 2^13 + 1, each f32 operation rounded on its
    own)."""
    x = x.to(torch.float32)
    c = x * torch.tensor(8193.0, dtype=torch.float32)
    return c - (c - x)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``x = hi + lo`` with ``hi = tf32(x)`` and ``lo = tf32(x - hi)``."""
    x = x.to(torch.float32)
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def tf32_split_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the split-TF32 kernels take it (``flash_attention_tf32.cu``,
    ``ssd_scan_tf32.cu``): each operand split into TF32 hi + lo and three
    TF32 products (lo.hi, hi.lo, hi.hi; lo.lo dropped) accumulated in f32,
    the small terms first.  The product of two TF32 values is exact in f32.
    A plain emulation for the tests and the profilers; no path of the port
    calls it."""
    a_hi, a_lo = tf32_split(a)
    b_hi, b_lo = tf32_split(b)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


_LOG2E = 1.4426950408889634
_MASK = -2.0e38


def flash_attention_tf32_emulation(q, k, v, *, causal, window=0,
                                   scale=None):
    """Attention as the f32 kernel computes it: q k^T and p v split TF32,
    scores in units of log2 e, the finite -2e38 mask, p zeroed where masked,
    out = acc / max(l, 1e-30).  Dense rows: the kernel's online softmax
    over tiles differs by rescalings exact to f32 rounding, and its
    exponentials are ex2.approx.  For the tests and the profilers; no path
    of the port calls it."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    scale_log2 = torch.tensor(scale, dtype=torch.float32) * torch.tensor(
        _LOG2E, dtype=torch.float32)
    kh = k.repeat_interleave(H // K, dim=2).permute(0, 2, 3, 1)  # B,H,hd,T
    vh = v.repeat_interleave(H // K, dim=2).permute(0, 2, 1, 3)  # B,H,T,hd
    s = tf32_split_matmul(q.permute(0, 2, 1, 3), kh) * scale_log2
    qi = torch.arange(S, device=q.device)[:, None]
    kj = torch.arange(T, device=q.device)[None, :]
    live = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        live &= kj <= qi
    if window:
        live &= kj > qi - window
    s = torch.where(live, s, torch.full_like(s, _MASK))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(live, torch.exp2(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    out = tf32_split_matmul(p, vh) / torch.clamp(l, min=1e-30)
    return out.permute(0, 2, 1, 3)


def ssd_scan_tf32_emulation(x, dt, A, Bm, Cm, chunk):
    """The chunked SSD scan as the f32 kernel computes it: per-group scores
    G = C B^T, chunk states (B o w)^T x, the f32 state carry, y = e^cum
    (C S_before) + G' x with G' = G e^(cum_i - cum_j) dt_j (j <= i), every
    product split TF32 and cum in units of log2 e; exact exponentials
    where the kernel's are ex2.approx.  For the tests and the profilers;
    no path of the port calls it."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc, rep = S // chunk, H // G
    xc = x.reshape(Bsz, nc, chunk, H, P).permute(0, 1, 3, 2, 4)  # b,c,h,l,p
    dtc = dt.reshape(Bsz, nc, chunk, H).permute(0, 1, 3, 2)      # b,c,h,l
    Bc = Bm.reshape(Bsz, nc, chunk, G, N).permute(0, 1, 3, 2, 4)  # b,c,g,l,n
    Cc = Cm.reshape(Bsz, nc, chunk, G, N).permute(0, 1, 3, 2, 4)
    cum2 = torch.cumsum(dtc * A[None, None, :, None], dim=-1) * torch.tensor(
        _LOG2E, dtype=torch.float32)
    scores = tf32_split_matmul(Cc, Bc.transpose(-1, -2))     # b,c,g,l,l
    scores = scores.repeat_interleave(rep, dim=2)
    Bh = Bc.repeat_interleave(rep, dim=2)
    Ch = Cc.repeat_interleave(rep, dim=2)
    w = dtc * torch.exp2(cum2[..., -1:] - cum2)
    states = tf32_split_matmul((Bh * w[..., None]).transpose(-1, -2), xc)
    decay = torch.exp2(cum2[..., -1])                            # b,c,h
    before = torch.zeros_like(states)
    carry = torch.zeros_like(states[:, 0])
    for c in range(nc):
        before[:, c] = carry
        carry = carry * decay[:, c, :, None, None] + states[:, c]
    y = tf32_split_matmul(Ch, before) * torch.exp2(cum2)[..., None]
    diff = cum2[..., :, None] - cum2[..., None, :]
    i = torch.arange(chunk, device=x.device)
    diff = torch.where(i[None, :] <= i[:, None], diff,
                       torch.full_like(diff, float("-inf")))
    gp = scores * torch.exp2(diff) * dtc[..., None, :]
    y = y + tf32_split_matmul(gp, xc)
    return y.permute(0, 1, 3, 2, 4).reshape(Bsz, S, H, P)
