"""The bf16 tensor-core SSD scan kernel (``csrc/ssd_scan_wgmma.cu``) on the
CPU: an emulation of its arithmetic in PyTorch held to the JAX reference,
the dtype routing of the wrapper, its route counters, the shapes the bf16
route refuses, and the build cache's hash of the shared headers.

The emulation repeats what the kernel does: bf16 inputs; cum, the inclusive
cumsum of dt * A over each chunk, in f32 and in units of log2(e); phase 1,
the chunk states ``S_c = B^T (x o w)`` with ``w_j = dt_j 2^(cum_last -
cum_j)`` and ``x o w`` rounded to bf16; phase 2, the f32 state carry over
the chunks with ``S_before`` rounded to bf16; phase 3 in 64-row tiles,
``acc = (C S_before) o 2^cum_i`` and, for each 64-column kv tile j <= i,
``G = C B_j^T`` in f32, ``G' = G o 2^(cum_i - cum_j) o dt_j`` with j > i set
to -inf BEFORE the exponential, G' split into two bf16 operands ``hi =
bf16(G')`` and ``lo = bf16(G' - hi)``, ``acc += hi x_j + lo x_j`` with x raw;
every accumulator f32, y rounded to bf16 once.

The criterion, on bf16-valued inputs made from numpy and handed to both
frameworks: against the f32 oracle (the reference's sequential
``ssd_scan_ref`` in f32), the emulation's relative L2 error and its max
|diff| are each at most 1.25x those of the JAX model's own plain path
``ssd_chunked`` run in bf16 on the same inputs (the tensor cores take bf16
operands: the route rounds x o w and S_before where that path rounds them,
and carries G' as two bf16 operands);
and its relative L2 error is at most ``REL_L2_BOUND`` from the oracle and
from the reference's Pallas kernel (interpret mode, f32 arithmetic, y
rounded once).  The kernel itself is held to the same criterion on the card
(``tests/test_torch_cuda_lm.py``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import ssm as jssm
from repro_torch.kernels import build, ops
from repro_torch.kernels import ssd_scan as tssd

TILE = 64
LOG2E = 1.4426950408889634
# Three bf16 rounding points (x o w, S_before, y) and G' to ~2^-17, each
# rounding off by at most 2^-9 relative and about 2^-9 / sqrt(3) on
# average: together ~3.4e-3 rel L2 if they added up in phase, so 1e-2
# leaves a factor of three over that while catching a lost or doubled term
# (rel L2 ~ 1).
REL_L2_BOUND = 1e-2
RATIO = 1.25


def wgmma_emulation(x, dt, A, Bm, Cm, *, chunk):
    """The kernel's arithmetic: bf16 x (B,S,H,P), Bm/Cm (B,S,G,N), f32 dt
    (B,S,H) and A (H,) -> bf16 y (B,S,H,P)."""
    f32 = torch.float32
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc = S // chunk

    def rnd(t):
        return t.to(torch.bfloat16).to(f32)

    xc = x.to(f32).reshape(Bsz, nc, chunk, H, P)
    Bc = Bm.to(f32).repeat_interleave(H // G, dim=2).reshape(
        Bsz, nc, chunk, H, N)
    Cc = Cm.to(f32).repeat_interleave(H // G, dim=2).reshape(
        Bsz, nc, chunk, H, N)
    dtc = dt.to(f32).reshape(Bsz, nc, chunk, H)
    cum2 = torch.cumsum(dtc * A.to(f32), dim=2) * torch.tensor(LOG2E, dtype=f32)
    last = cum2[:, :, -1:]

    # phase 1: chunk states from x o w rounded to bf16
    xw = rnd(xc * (dtc * torch.exp2(last - cum2))[..., None])
    states = torch.einsum("bcjhn,bcjhp->bchnp", Bc, xw)
    decay = torch.exp2(last[:, :, 0])                       # (B, nc, H)

    # phase 2: f32 carry, S_before rounded to bf16
    s = torch.zeros((Bsz, H, N, P), dtype=f32)
    before = []
    for c in range(nc):
        before.append(rnd(s))
        s = s * decay[:, c, :, None, None] + states[:, c]
    s_before = torch.stack(before, dim=1)                   # (B,nc,H,N,P)

    # phase 3: 64-row tiles, 64-column kv tiles at or left of the diagonal
    tri = torch.ones((TILE, TILE), dtype=torch.bool).tril()
    y = torch.empty((Bsz, nc, chunk, H, P), dtype=f32)
    for ti in range(chunk // TILE):
        rows = slice(ti * TILE, (ti + 1) * TILE)
        ci = cum2[:, :, rows]
        acc = torch.einsum("bcihn,bchnp->bcihp", Cc[:, :, rows], s_before) \
            * torch.exp2(ci)[..., None]
        for tj in range(ti + 1):
            cols = slice(tj * TILE, (tj + 1) * TILE)
            g = torch.einsum("bcihn,bcjhn->bcijh", Cc[:, :, rows],
                             Bc[:, :, cols])
            d = ci[:, :, :, None, :] - cum2[:, :, None, cols, :]
            if tj == ti:          # mask before the exponential
                d = d.masked_fill(~tri[None, None, :, :, None],
                                  float("-inf"))
            gp = g * (torch.exp2(d) * dtc[:, :, None, cols, :])
            hi = rnd(gp)
            acc = acc + torch.einsum("bcijh,bcjhp->bcihp", hi + rnd(gp - hi),
                                     xc[:, :, cols])
        y[:, :, rows] = acc
    return y.reshape(Bsz, S, H, P).to(torch.bfloat16)


def _inputs(B, S, H, P, G, N, seed):
    """bf16-valued f32 x, Bm, Cm and f32 dt, A from numpy."""
    rng = np.random.default_rng(seed)

    def bf16_valued(a):
        return torch.from_numpy(a.astype(np.float32)).to(
            torch.bfloat16).float().numpy()

    x = bf16_valued(rng.normal(size=(B, S, H, P)) * 0.5)
    dt = np.log1p(np.exp(rng.normal(size=(B, S, H)))).astype(np.float32)
    A = -np.exp(rng.uniform(0.0, 1.0, size=(H,))).astype(np.float32)
    Bm = bf16_valued(rng.normal(size=(B, S, G, N)) * 0.3)
    Cm = bf16_valued(rng.normal(size=(B, S, G, N)) * 0.3)
    return x, dt, A, Bm, Cm


def _dist(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return (float(np.linalg.norm(got - want) / np.linalg.norm(want)),
            float(np.abs(got - want).max()))


# (B, S, H, P, G, N, chunk): chunks of 64, 128 and 256 over 2-3 chunks,
# P 32 and 64, N 16 and 128, G 1 and 2
_CASES = [
    (1, 128, 2, 32, 1, 16, 64),
    (1, 192, 4, 64, 2, 16, 64),
    (1, 256, 2, 64, 1, 128, 128),
    (1, 384, 4, 32, 2, 128, 128),
    (1, 512, 2, 32, 2, 16, 256),
    (1, 768, 2, 64, 1, 128, 256),
]


@pytest.mark.parametrize("case", _CASES, ids=lambda c: "-".join(map(str, c)))
def test_emulation_matches_reference(case):
    B, S, H, P, G, N, chunk = case
    x, dt, A, Bm, Cm = _inputs(B, S, H, P, G, N, 13 * S + 7 * N + P + G)
    got = wgmma_emulation(*(torch.from_numpy(a).to(torch.bfloat16)
                            if a.ndim == 4 else torch.from_numpy(a)
                            for a in (x, dt, A, Bm, Cm)), chunk=chunk)
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, H, P)
    got = got.float().numpy()

    jx, jB, jC = (jnp.asarray(a, jnp.bfloat16) for a in (x, Bm, Cm))
    jdt, jA = jnp.asarray(dt), jnp.asarray(A)
    oracle = np.asarray(jref.ssd_scan_ref(jnp.asarray(x), jdt, jA,
                                          jnp.asarray(Bm), jnp.asarray(Cm)))
    plain, _ = jssm.ssd_chunked(jx, jdt, jA, jB, jC, chunk)
    kern = jops.ssd_scan(jx, jdt, jA, jB, jC, chunk=chunk)

    emu_l2, emu_max = _dist(got, oracle)
    plain_l2, plain_max = _dist(np.asarray(plain, np.float32), oracle)
    assert emu_l2 <= RATIO * plain_l2, (emu_l2, plain_l2)
    assert emu_max <= RATIO * plain_max, (emu_max, plain_max)
    assert emu_l2 <= REL_L2_BOUND
    assert _dist(got, np.asarray(kern, np.float32))[0] <= REL_L2_BOUND


def test_emulation_mask_precedes_the_exponential():
    """A decay steep enough that exp(cum_i - cum_j) for j > i overflows f32:
    masking after the exponential would give inf * 0 = nan."""
    x, dt, A, Bm, Cm = _inputs(1, 128, 2, 32, 1, 16, 3)
    A = np.full_like(A, -60.0)
    dt = np.full_like(dt, 3.0)              # cum falls 180 per step
    args = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)]
    args = [a.to(torch.bfloat16) if a.ndim == 4 else a for a in args]
    got = wgmma_emulation(*args, chunk=64).float()
    assert torch.isfinite(got).all()
    # each step forgets the past: y_i = dt_i (C_i . B_i) x_i
    want = (args[4].float() * args[3].float()).sum(-1)[..., None] \
        * args[1][..., None] * args[0].float()
    torch.testing.assert_close(got, want.to(torch.bfloat16).float(),
                               atol=2e-2, rtol=2e-2)


def test_dtype_routing():
    """bf16 takes the wgmma kernel, f32 the split-TF32 kernel, anything else
    is refused; both sources and the shared header are in csrc/."""
    assert tssd.route(torch.bfloat16) == ("wgmma", "ssd_scan_wgmma")
    assert tssd.route(torch.float32) == ("f32", "ssd_scan_tf32")
    with pytest.raises(ValueError, match="f32 or bf16"):
        tssd.route(torch.float16)
    assert {"ssd_scan_tf32", "ssd_scan_wgmma"} <= set(build.sources())
    src = (build.CSRC / "ssd_scan_wgmma.cu").read_text()
    for needle in ('#include "hopper.cuh"', "wgmma_ss_n64<0, 0>",
                   "wgmma_ss_n64<1, 1>", "wgmma_rs_n64", "tma_load",
                   "mbar_wait"):
        assert needle in src
    header = (build.CSRC / "hopper.cuh").read_text()
    for instr in ("wgmma.mma_async", "cp.async.bulk.tensor", "mbarrier",
                  "cuTensorMapEncodeTiled"):
        assert instr in header
    assert '#include "hopper.cuh"' in (
        build.CSRC / "flash_attention_wgmma.cu").read_text()
    assert "bfloat16" not in (build.CSRC / "ssd_scan_tf32.cu").read_text()


@pytest.mark.parametrize("S,P,N,chunk,what", [
    (256, 64, 128, 32, "chunk"), (240, 64, 128, 48, "chunk"),
    (512, 64, 128, 512, "chunk"), (256, 48, 128, 64, "P"),
    (256, 16, 128, 64, "P"), (256, 64, 8, 64, "N"), (256, 64, 24, 64, "N"),
    (256, 64, 272, 64, "N"), (320, 64, 128, 128, "multiple")])
def test_wgmma_shape_refusals(S, P, N, chunk, what):
    with pytest.raises(ValueError, match=what):
        tssd.check_wgmma_shape(S, P, N, chunk)


@pytest.mark.parametrize("S,P,N,chunk", [(2048, 64, 128, 256),
                                         (128, 32, 16, 64),
                                         (768, 128, 256, 256),
                                         (192, 32, 16, 192)])
def test_wgmma_accepted_shapes(S, P, N, chunk):
    tssd.check_wgmma_shape(S, P, N, chunk)


def test_wgmma_ctas_at_full_width():
    assert tssd.wgmma_ctas(4, 2048, 48, 64, 128, 256) == {
        "chunk_state": 1536, "state_passing": 1536, "chunk_scan": 3072}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_tensors_never_reach_a_kernel(dtype):
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in _inputs(1, 128, 2, 32,
                                                             1, 16, 0))
    x, Bm, Cm = (t.to(dtype) for t in (x, Bm, Cm))
    ops.reset_launch_counts()
    got = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=64)
    assert got.dtype == dtype
    assert ops.launch_counts()["ssd_scan"] == 0
    assert ops.ssd_route_counts() == {"wgmma": 0, "f32": 0}
    with pytest.raises(ValueError, match="CUDA"):
        tssd.ssd_scan(x, dt, A, Bm, Cm, chunk=64)


def test_route_counters_reset():
    tssd.launches, tssd.route_launches["wgmma"] = 5, 3
    tssd.route_launches["f32"] = 2
    assert ops.launch_counts()["ssd_scan"] == sum(
        ops.ssd_route_counts().values())
    ops.reset_launch_counts()
    assert ops.launch_counts()["ssd_scan"] == 0
    assert ops.ssd_route_counts() == {"wgmma": 0, "f32": 0}
    assert ops.flash_route_counts() == {"wgmma": 0, "f32": 0}
    # the split stays beside launch_counts(), whose keys are unchanged
    assert set(ops.launch_counts()) == {
        "topk_mask_rows", "topk_mask_block", "quantize_rows",
        "dequantize_rows", "flash_attention", "ssd_scan"}


def test_header_edit_changes_the_build_target(tmp_path, monkeypatch):
    """The library name hashes the source, the flags and every csrc/*.cuh,
    so an edited header can never reuse a stale build."""
    (tmp_path / "k.cu").write_text('#include "hopper.cuh"\nint f();\n')
    (tmp_path / "hopper.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build._target("k")
    assert build._target("k") == first
    (tmp_path / "hopper.cuh").write_text("// v2\n")
    second = build._target("k")
    assert second != first and second.name.startswith("k-")
    (tmp_path / "k.cu").write_text('#include "hopper.cuh"\nint g();\n')
    assert build._target("k") not in (first, second)
