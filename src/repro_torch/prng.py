"""Counter-based PRNG: jax.random's threefry2x32, as the reference uses it.

The reference keys every served slot with ``fold_in(fold_in(key(seed),
request_id), index)`` and draws its latent or its next token from that key
(``serve/sampler.py``, ``serve/decode.py``); this module computes the same
keys and the same draws in torch, so the port serves the reference's
samples rather than samples of the same law.

Keys are int64 tensors of shape ``(..., 2)`` holding two 32-bit words (the
reference's ``jax.random.key_data``); every function takes a batch of keys
and derives one result per key in one vectorised call.  All integer work
is int64 masked to 32 bits, so it runs the same on the CPU and on CUDA and
inside a CUDA graph.  ``jax_threefry_partitionable`` is on (the default of
jax 0.5 and later): ``bits`` hashes the flat element index, ``split`` is
the fold-like split.

``key``, ``fold_in``, ``split``, ``bits``, ``uniform`` and ``randint``
equal ``jax.random`` bit for bit.  ``normal`` (sqrt(2) * erfinv of a
uniform) and the Gumbel noise of ``categorical`` (two logarithms) follow
XLA's f32 formulas: erfinv is Giles' polynomial, log and log1p are XLA's
Cephes-style expansions, and the multiply-adds XLA's CPU backend fuses
into FMAs are rounded once here too.  They are written in additions,
multiplications, divisions, square roots and selects only, which torch
rounds the same way on every device and at every position of a tensor
(its vectorised CPU loops would otherwise evaluate the tail of a tensor
with another ``log`` than the body), so a slot's draw never depends on the
batch it is computed in.  The same forms of exp and tanh (and ``fma``)
serve the models on the CPU (``models/common.py``), where the reference's
jitted programs evaluate them so.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_F32_ONE_BITS = 0x3F800000
_TINY = float(np.finfo(np.float32).tiny)
_NEG_ONE_UP = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))

__all__ = ["key", "fold_in", "split", "bits", "uniform", "normal",
           "randint", "gumbel", "categorical", "threefry2x32", "fma", "exp",
           "tanh", "log", "log1p"]


def _u32(x, device=None) -> torch.Tensor:
    """An int, a numpy array or a tensor -> int64 tensor of its low 32 bits
    (negative values wrap, as the reference's ``uint32`` casts do)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device or x.device, dtype=torch.int64) & _MASK
    arr = np.asarray(np.asarray(x).astype(np.int64) & _MASK)
    return torch.from_numpy(arr).to(device)


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter pair ``(x0, x1)`` under the
    key ``(k0, k1)``; every argument an int64 tensor of 32-bit values,
    broadcast together.  Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & _MASK
    x1 = (x1 + k1) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def key(seed, device=None) -> torch.Tensor:
    """``jax.random.key_data(jax.random.key(seed))``: ``(..., 2)`` keys for
    an int or an array of seeds (the high word is 0, as in the reference's
    32-bit mode; the low word is the seed modulo 2^32)."""
    lo = _u32(seed, device)
    return torch.stack([torch.zeros_like(lo), lo], dim=-1)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` of each key with ``data`` (an int or an
    array broadcast against the keys' batch shape, taken modulo 2^32)."""
    d = _u32(data, keys.device)
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def _counters(shape, keys: torch.Tensor):
    """The flat element index of ``shape`` as (hi, lo) 32-bit words, shaped
    to broadcast after the keys' batch dims."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)
    idx = idx.reshape((1,) * (keys.ndim - 1) + tuple(shape))
    return idx >> 32, idx & _MASK


def _batch_words(keys: torch.Tensor, ndim: int):
    pad = (...,) + (None,) * ndim
    return keys[..., 0][pad], keys[..., 1][pad]


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (the fold-like split): ``(..., num, 2)``."""
    hi, lo = _counters((num,), keys)
    k0, k1 = _batch_words(keys, 1)
    y0, y1 = threefry2x32(k0, k1, hi, lo)
    return torch.stack([y0, y1], dim=-1)


def bits(keys: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits`` (uint32) of each key: int64 values in [0, 2^32),
    shape ``keys.shape[:-1] + shape``."""
    shape = tuple(shape)
    hi, lo = _counters(shape, keys)
    k0, k1 = _batch_words(keys, len(shape))
    y0, y1 = threefry2x32(k0, k1, hi, lo)
    return y0 ^ y1


def fma(a, b, c):
    """f32 fused multiply-add ``a * b + c`` (``a`` a tensor; ``b``, ``c``
    tensors or floats), rounded once, as XLA's CPU backend fuses a multiply
    and an add: the product is exact in f64, so only the f64 sum's
    rounding (never seen to matter) separates it from a true FMA."""
    return (a.to(torch.float64) * b + c).to(torch.float32)


def _unit(keys: torch.Tensor, shape) -> torch.Tensor:
    """Floats in [0, 1): 23 random mantissa bits under exponent 0, less 1."""
    b = (bits(keys, shape) >> 9) | _F32_ONE_BITS
    return b.to(torch.int32).view(torch.float32) - 1.0


def uniform(keys: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in f32: ``max(minval, u * (maxval - minval) +
    minval)`` on the [0, 1) floats, the multiply-add fused as XLA fuses
    it."""
    lo = np.float32(minval)
    span = float(np.float32(maxval) - lo)
    u = fma(_unit(keys, shape), span, float(lo))
    return torch.clamp_min(u, float(lo))


def _f32(x) -> float:
    return float(np.float32(x))


# XLA's log1p: a rational function for |x| < sqrt(2) - 1 (Cephes), else
# log(1 + x); coefficients highest degree first, rounded to f32.
_LOG1P_NUM = [_f32(c) for c in (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
    6.5787325942061044846969e0, 2.9911919328553073277375e1,
    6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1)]
_LOG1P_DEN = [_f32(c) for c in (
    1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
    2.2176239823732856465394e2, 3.0909872225312059774938e2,
    2.1642788614495947685003e2, 6.0118660497603843919306e1)]
# XLA's f32 log on the CPU (Cephes' logf): ln(x) = k ln 2 + ln(m)
_LOG_P = [_f32(c) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1)]
_LOG_Q1, _LOG_Q2 = _f32(-2.12194440e-4), _f32(0.693359375)
_SQRTHF = _f32(0.707106781186547524)


def log(x: torch.Tensor) -> torch.Tensor:
    """f32 natural log in XLA's CPU form; 0 -> -inf, +inf -> +inf, x < 0
    or NaN -> NaN."""
    m = torch.clamp_min(x, _TINY)               # subnormals cut off
    ib = m.view(torch.int32)
    e = ((ib >> 23) - 0x7F).to(torch.float32) + 1.0
    m = ((ib & ~0x7F800000) | 0x3F000000).view(torch.float32)   # [0.5, 1)
    small = m < _SQRTHF
    e = e - small.to(torch.float32)
    m = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    x2 = m * m
    x3 = x2 * m
    y = fma(m, _LOG_P[0], _LOG_P[1])
    y1 = fma(m, _LOG_P[3], _LOG_P[4])
    y2 = fma(m, _LOG_P[6], _LOG_P[7])
    y = fma(y, m, _LOG_P[2])
    y1 = fma(y1, m, _LOG_P[5])
    y2 = fma(y2, m, _LOG_P[8])
    y = fma(y, x3, y1)
    y = fma(y, x3, y2)
    y = y * x3
    y = y + e * _LOG_Q1
    out = fma(x2, -0.5, m)
    out = out + y
    out = fma(e, _LOG_Q2, out)
    out = torch.where(x == 0, float("-inf"), out)
    out = torch.where(x == float("inf"), float("inf"), out)
    return torch.where((x < 0) | torch.isnan(x), float("nan"), out)


# XLA's f32 exp on the CPU (Cephes' expf): e^x = 2^n e^r with n = floor(x
# log2 e + 1/2) clamped to +-127, r = x - n ln 2 in two steps, e^r by a
# polynomial of degree 7, 2^n written into the exponent bits (0 at -127)
_EXP_P = [_f32(c) for c in (
    1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
    1.6666665459e-1, 5.0000001201e-1)]
_EXP_C1, _EXP_C2 = _f32(0.693359375), _f32(-2.12194440e-4)
_LOG2E = _f32(1.44269504088896341)


def exp(x: torch.Tensor) -> torch.Tensor:
    """f32 e^x in XLA's CPU form (bit for bit), input clamped to [-87.8,
    88.8]."""
    x = torch.clamp(x.to(torch.float32), _f32(-87.8), _f32(88.8))
    n = torch.clamp(torch.floor(fma(x, _LOG2E, 0.5)), -127.0, 127.0)
    r = fma(n, -_EXP_C1, x)
    r = fma(n, -_EXP_C2, r)
    z = fma(r, _EXP_P[0], _EXP_P[1])
    for c in _EXP_P[2:]:
        z = fma(z, r, c)
    z = fma(z, r * r, r) + 1.0
    pow2 = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return z * pow2


# XLA's f32 tanh on the CPU: x clamped to +-_TANH_CLAMP, then a rational
# function of x^2 by Horner's rule in fused multiply-adds; x itself below
# 4e-4
_TANH_CLAMP = _f32(7.99881172180175781)
_TANH_NUM = [_f32(c) for c in (
    -2.76076847742355e-16, 2.00018790482477e-13, -8.60467152213735e-11,
    5.12229709037114e-08, 1.48572235717979e-05, 6.37261928875436e-04,
    4.89352455891786e-03)]
_TANH_DEN = [_f32(c) for c in (
    1.19825839466702e-06, 1.18534705686654e-04, 2.26843463243900e-03,
    4.89352518554385e-03)]


def tanh(x: torch.Tensor) -> torch.Tensor:
    """f32 tanh in XLA's CPU form (bit for bit)."""
    x = x.to(torch.float32)
    xc = torch.clamp(x, -_TANH_CLAMP, _TANH_CLAMP)
    x2 = xc * xc
    r = (xc * _horner(_TANH_NUM, x2)) / _horner(_TANH_DEN, x2)
    return torch.where(torch.abs(x) < _f32(0.0004), x, r)


def _horner(coeffs, x):
    p = torch.zeros_like(x)
    for c in coeffs:
        p = fma(p, x, c)
    return p


def log1p(x: torch.Tensor) -> torch.Tensor:
    """f32 ``log(1 + x)`` in XLA's form: a rational function below sqrt(2)
    - 1, else ``log(x + 1)``."""
    x2 = x * x
    small = x + fma(x2, -0.5, x * x2 * (_horner(_LOG1P_NUM, x)
                                         / _horner(_LOG1P_DEN, x)))
    return torch.where(x.abs() < _f32(0.41421356237309504880), small,
                       log(x + 1.0))


# Giles' single-precision erfinv, as XLA evaluates it (w < 5 and w >= 5
# branches, coefficients highest degree first)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """f32 inverse error function in XLA's form (+-1 -> +-inf)."""
    w = -log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _f32(_ERFINV_LT5[0]), _f32(_ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = fma(p, w, torch.where(lt, _f32(a), _f32(b)))
    out = p * x
    return torch.where(x.abs() == 1.0, x * float("inf"), out)


def normal(keys: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.normal`` in f32: sqrt(2) * erfinv(u), u uniform on
    (-1, 1)."""
    u = uniform(keys, shape, _NEG_ONE_UP, 1.0)
    return erfinv(u) * _f32(math.sqrt(2.0))


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """``a * b`` modulo 2^32 for 32-bit ``a`` and ``b``, without leaving
    int64."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def randint(keys: torch.Tensor, shape, minval: int, maxval: int
            ) -> torch.Tensor:
    """``jax.random.randint`` into int32 (``minval <= x < maxval``, both
    within int32): two 32-bit draws folded modulo the span, as the
    reference does.  Returns int64 tensors of the int32 values."""
    if not (-2**31 <= minval <= 2**31 - 1 and -2**31 <= maxval <= 2**31 - 1):
        raise ValueError(f"randint bounds must be int32, got [{minval}, "
                         f"{maxval})")
    k = split(keys, 2)
    hi, lo = bits(k[..., 0, :], shape), bits(k[..., 1, :], shape)
    span = maxval - minval if maxval > minval else 1
    mult = ((2 ** 16 % span) ** 2 & _MASK) % span
    off = ((_mul32(hi % span, mult) + lo % span) & _MASK) % span
    return off + minval


def gumbel(keys: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel`` in f32: -log(-log(u)), u uniform on [tiny,
    1)."""
    u = uniform(keys, shape, _TINY, 1.0)
    return -log(-log(u))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis: one draw per key,
    ``argmax(gumbel + logits)`` (``keys (..., 2)``, ``logits (..., V)``)."""
    g = gumbel(keys, (logits.shape[-1],))
    return torch.argmax(g + logits.to(torch.float32), dim=-1)
