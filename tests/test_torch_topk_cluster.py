"""The one-launch cluster kernels of the federation round on the CPU:
``csrc/topk_select.cu`` (B1, the global top-k mask) and the quantize half of
``csrc/quantize.cu`` (B2), each emulated in PyTorch and held BITWISE to the
JAX reference.

The top-k emulation repeats the kernel's algorithm: the row cut into one
slice per CTA of a cluster (``ceil(N / 8)`` elements, the last slices
shorter or empty), the 31-bit magnitude patterns, four 8-bit digit passes
(bits 24..30, 16..23, 8..15, 0..7) in which each slice counts its elements
that match the prefix fixed so far into 256 bins, the slices' histograms
summed (what every CTA reads through distributed shared memory), the digit
picked by a suffix scan over the bins with the counts above it subtracted
from k, an early stop once the picked bin is taken whole, and the mask
``bits >= prefix``.  The quantize emulation takes each
slice's max of the patterns, the cluster's max of those, scale and inv as
the kernel computes them, and codes each slice with the stochastic-rounding
hash keyed by the GLOBAL column.  The kernels themselves are held to the
plain versions on the card (``tests/test_torch_cuda.py``)."""

import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import profile_codec
from repro_torch.kernels import build
from repro_torch.kernels import quantize as tquant
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.kernels import topk_select as ttopk

CLUSTER = 8           # CTAs per row, ``row_cluster::kCluster``
BINS, SHIFTS = 256, (24, 16, 8, 0)


def slices(n, cl):
    """The kernel's [lo, hi) per CTA rank (``row_cluster::slice_of``)."""
    length = -(-n // cl)
    out = []
    for rank in range(cl):
        lo = min(n, rank * length)
        out.append((lo, min(n, lo + length)))
    return out


def mag_bits(x):
    return x.view(torch.int32).to(torch.int64) & 0x7FFFFFFF


def topk_cluster_emulation(x, frac, cl):
    """(C, N) f32 -> (C, N) bool, the kernel's radix select per row."""
    rows, n = x.shape
    k = ref.topk_k(n, frac)
    out = torch.empty((rows, n), dtype=torch.bool)
    for r in range(rows):
        bits = mag_bits(x[r])
        prefix, krem = 0, k
        for p, shift in enumerate(SHIFTS):
            hist = torch.zeros(BINS, dtype=torch.int64)
            for lo, hi in slices(n, cl):
                b = bits[lo:hi]
                if p:
                    b = b[(b >> (shift + 8)) == (prefix >> (shift + 8))]
                hist += torch.bincount((b >> shift) & (BINS - 1),
                                       minlength=BINS)
            ge = torch.flip(torch.cumsum(torch.flip(hist, [0]), 0), [0])
            gt = ge - hist
            hits = torch.nonzero((gt < krem) & (krem <= ge)).flatten()
            assert hits.numel() == 1, "exactly one bin holds the k-th"
            d = int(hits[0])
            prefix |= d << shift
            krem -= int(gt[d])
            if krem == int(hist[d]):       # the whole bin is taken
                break
        out[r] = bits >= prefix
    return out


def quantize_cluster_emulation(x, cl, *, stochastic=False, seed=None):
    """(R, N) f32 -> (q int8, scale f32), the kernel's arithmetic per slice:
    slice maxima of the patterns, their max, ``scale = absmax * f32(1/127)``
    (0 where subnormal) and ``inv`` by IEEE division, each slice coded on its
    own from ``y = x * inv``, 0 where x or y is subnormal, zero or NaN."""
    rows, n = x.shape
    q = torch.empty((rows, n), dtype=torch.int8)
    scale = torch.empty(rows, dtype=torch.float32)
    for r in range(rows):
        parts = slices(n, cl)
        maxima = [int(mag_bits(x[r, lo:hi]).max()) if hi > lo else 0
                  for lo, hi in parts]
        absmax = torch.tensor([max(maxima)], dtype=torch.int32).view(
            torch.float32)
        s = absmax * torch.full_like(absmax, ref.INV_127)
        s = torch.where(s.abs() < ref.MIN_NORMAL, s * 0, s)
        inv = torch.where(s > 0, torch.ones_like(s) / s, torch.zeros_like(s))
        scale[r] = s[0]
        for lo, hi in parts:
            xs = x[r, lo:hi]
            p = xs * inv
            keep = (xs.abs() >= ref.MIN_NORMAL) & (p.abs() >= ref.MIN_NORMAL)
            y = torch.where(keep, p, torch.zeros_like(p))
            if stochastic:
                y = torch.clamp(y, -127.0, 127.0)
                f = torch.floor(y)
                u = ref.hash_u01(torch.full((hi - lo,), r),
                                 torch.arange(lo, hi), seed)
                v = f + (u < (y - f)).to(torch.float32)
            else:
                v = torch.round(y)
            q[r, lo:hi] = torch.clamp(v, -127.0, 127.0).to(torch.int8)
    return q, scale


def _rows(rows, n, seed):
    x = np.random.default_rng(seed).normal(size=(rows, n)).astype(np.float32)
    return x * np.float32(2e-4)


def _jax_mask(x, frac):
    """The JAX reference per row: its Pallas kernel (interpret mode) and its
    top_k oracle, which must agree."""
    out = []
    for row in x:
        got = np.asarray(jops.topk_mask(jnp.asarray(row), frac))
        np.testing.assert_array_equal(
            got, np.asarray(jref.topk_mask_global_ref(jnp.asarray(row), frac)))
        out.append(got)
    return np.stack(out)


# 267,009 (the D row) cut to 3001; 1000 and 8193 do not divide by 8 or 16;
# 1 and 7 leave most CTAs of a cluster an empty slice
@pytest.mark.parametrize("n", [1, 7, 1000, 3001, 8193])
@pytest.mark.parametrize("frac", [0.01, 0.1, 1.0])
def test_topk_emulation_matches_reference_bitwise(n, frac):
    x = _rows(3, n, n)
    x[1] = np.round(x[1] * 2e4) / 4e4          # quarter steps: ties
    x[2, : n // 2] = 0.0                       # half-zero row
    want = _jax_mask(x, frac)
    got = topk_cluster_emulation(torch.from_numpy(x), frac, CLUSTER).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fill", [0.0, 0.25, -0.5])
def test_topk_emulation_degenerate_rows(fill):
    """All-equal rows (all zero: t = 0, every entry kept)."""
    x = np.full((2, 300), fill, np.float32)
    want = _jax_mask(x, 0.1)
    assert want.all()
    np.testing.assert_array_equal(
        topk_cluster_emulation(torch.from_numpy(x), 0.1, CLUSTER).numpy(),
        want)


@pytest.mark.parametrize("n", [1, 7, 3001, 8193])
@pytest.mark.parametrize("stochastic", [False, True])
def test_quantize_emulation_matches_reference_bitwise(n, stochastic):
    x = _rows(4, n, n) * np.float32(500.0)
    x[1, : n // 2] = 0.0
    x[2] = 0.0                                 # scale 0: every code 0
    seed = 2**31 - 2 if stochastic else None
    jseed = jnp.int32(seed) if stochastic else None
    qr, sr = jops.quantize_rows(jnp.asarray(x), stochastic=stochastic,
                                seed=jseed)
    q, s = quantize_cluster_emulation(torch.from_numpy(x), CLUSTER,
                                      stochastic=stochastic, seed=seed)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qr))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sr))


@pytest.mark.parametrize("stochastic", [False, True])
def test_quantize_emulation_flushes_like_reference(stochastic):
    """Where the reference's f32 flushes: an absmax below 127 * 2^-126,
    subnormal entries under a subnormal and a normal scale, inf and NaN
    entries, magnitudes just above the least normal scale."""
    x = np.random.default_rng(5).normal(size=(6, 3001)).astype(np.float32)
    tiny = np.float32(127 * 2.0 ** -126)
    x[0] *= np.float32(1e-37)
    x[1] = np.float32(5e-39)
    x[1, 0] = np.float32(1e-36)
    x[2] *= np.float32(1e-38)
    x[2, 0] = 3 * tiny
    x[3, ::7] = np.inf
    x[4, 1500] = np.nan
    x[5] = np.abs(x[5]) * np.float32(2.0 ** -126) + tiny
    seed = 77 if stochastic else None
    jseed = jnp.int32(77) if stochastic else None
    qr, sr = jops.quantize_rows(jnp.asarray(x), stochastic=stochastic,
                                seed=jseed)
    q, s = quantize_cluster_emulation(torch.from_numpy(x), CLUSTER,
                                      stochastic=stochastic, seed=seed)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qr))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sr))


def test_slices_cover_each_row_once():
    """Every element lies in exactly one CTA's slice, in rank order."""
    for n in (1, 7, 15, 16, 17, 1000, 267009):
        parts = slices(n, CLUSTER)
        assert parts[0][0] == 0 and parts[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))


def test_wrappers_take_a_cluster_the_kernels_accept():
    """The kernels' cluster size, one constant of ``row_cluster.cuh``, is
    the emulation's and a portable one (at most 8 CTAs): no kernel asks
    for the non-portable cluster size, and no C entry takes a cluster."""
    header = (build.CSRC / "row_cluster.cuh").read_text()
    assert re.findall(r"constexpr int kCluster = (\d+);", header) == [
        str(CLUSTER)]
    assert 1 <= CLUSTER <= 8
    for src in ("row_cluster.cuh", "topk_select.cu", "quantize.cu"):
        text = (build.CSRC / src).read_text()
        assert "NonPortableClusterSize" not in text
        assert "int cluster" not in text


def _c_params(src, entry):
    """The parameter count of the C entry point ``entry`` of ``src``."""
    text = (build.CSRC / f"{src}.cu").read_text()
    params = re.search(rf"\nint {entry}\(([^)]*)\)", text).group(1)
    return len(params.split(","))


def _bind_ssd(dtype, entry):
    """The SSD wrapper's binding of ``dtype``'s route, returning ``entry``
    (the f32 route binds its shared-memory report beside its forward)."""
    def bind(lib):
        fwd = tssd.bind(lib, dtype)
        return fwd if entry.endswith("_fwd") else getattr(lib, entry)
    return bind


@pytest.mark.parametrize("src,entry,bind,index", [
    ("topk_select", "topk_mask_rows", ttopk.bind, None),
    ("quantize", "quantize_rows", tquant.bind, 0),
    ("quantize", "dequantize_rows", tquant.bind, 1),
    ("ssd_scan_tf32", "ssd_scan_tf32_fwd",
     _bind_ssd(torch.float32, "ssd_scan_tf32_fwd"), None),
    ("ssd_scan_tf32", "ssd_scan_tf32_smem",
     _bind_ssd(torch.float32, "ssd_scan_tf32_smem"), None),
    ("ssd_scan_wgmma", "ssd_scan_wgmma_fwd",
     _bind_ssd(torch.bfloat16, "ssd_scan_wgmma_fwd"), None)])
def test_bindings_match_the_c_signatures(src, entry, bind, index):
    """Each wrapper's ctypes ``argtypes`` has one entry per parameter of
    its C entry point (a missing one would cut a 64-bit pointer)."""
    lib = SimpleNamespace(**{
        e: SimpleNamespace(argtypes=None, restype=None)
        for e in ("topk_mask_rows", "quantize_rows", "dequantize_rows",
                  "ssd_scan_tf32_fwd", "ssd_scan_tf32_smem",
                  "ssd_scan_wgmma_fwd")})
    fns = bind(lib)
    fn = fns if index is None else fns[index]
    assert fn is getattr(lib, entry)
    assert len(fn.argtypes) == _c_params(src, entry)


def _stamp_indices(src):
    """The indices the kernels of ``src`` pass to ROW_CLUSTER_STAMP, with
    ``p`` over the passes and ``k*`` constants of the source."""
    text = (build.CSRC / f"{src}.cu").read_text()
    consts = {}
    for name, expr in re.findall(r"constexpr int (k\w+) = ([^;]+);", text):
        try:
            consts[name] = eval(expr, {}, dict(consts))
        except (NameError, SyntaxError):     # not a plain expression
            pass
    out = set()
    for expr in re.findall(r"ROW_CLUSTER_STAMP\(([^)]+)\);", text):
        for p in range(consts.get("kPasses", 1)):
            out.add(eval(expr, {}, dict(consts, p=p)))
    return out


@pytest.mark.parametrize("src,phases", [
    ("topk_select", profile_codec.TOPK_PHASES),
    ("quantize", profile_codec.QUANT_PHASES),
    ("topk_block", profile_codec.BLOCK_PHASES)])
def test_stamp_variant_names_every_phase(monkeypatch, src, phases):
    """``profile_codec --stamps`` builds the source with the package's
    flags and ``-DROW_CLUSTER_STAMPS``, and names one phase per stamp after
    the first (stamp 0, the kernel's start)."""
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    cmd = build.nvcc_command(src, build.BUILD_DIR / "x.so",
                             profile_codec.STAMP_FLAGS)
    assert cmd[0] == "nvcc" and cmd[-1] == str(build.CSRC / f"{src}.cu")
    assert "-DROW_CLUSTER_STAMPS" in cmd
    assert all(f in cmd for f in build.nvcc_flags(src))
    assert _stamp_indices(src) == set(range(len(phases) + 1))


def test_cpu_quantize_takes_a_seed_tensor():
    """A one-element seed tensor on the CPU route gives the codes of the
    same seed as an int (the card reads it through a pointer)."""
    from repro_torch.kernels import ops
    x = torch.from_numpy(_rows(3, 1000, 5) * np.float32(500.0))
    for dtype in (torch.int32, torch.uint32):
        seed = torch.full((1,), 123, dtype=dtype)
        got = ops.quantize_rows(x, stochastic=True, seed=seed)
        want = ops.quantize_rows(x, stochastic=True, seed=123)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_profile_round_counts_these_kernels():
    """``profile_round``'s "own kernels" time names exactly the kernels of
    the two sources, so it cannot silently drop to zero."""
    import re

    from repro_torch import profile_round
    from repro_torch.kernels import build
    names = set()
    for src in ("topk_select", "quantize"):
        text = (build.CSRC / f"{src}.cu").read_text()
        names |= set(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\(\w+\)\s+)?(\w+)\(",
            text))
    assert names == set(profile_round._OWN)
