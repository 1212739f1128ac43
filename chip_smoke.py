#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line) when
it goes wrong:

1. environment — the card's name and power limit (``nvidia-smi``), the
   torch and CUDA versions;
2. build — every kernel under ``src/repro_torch/kernels/csrc`` with nvcc
   for sm_90a, all sources at once (the wall seconds of each);
3. kernels — each Hopper kernel on the card at its main path's shape and
   on edge cases, held to its plain PyTorch version on the same inputs:
   top-k and the int8 codec BITWISE (8 user rows of the 784/256/256 MLP
   discriminator, N = 267,009 f32, upload fraction 0.1; also rows of 1 and
   7 elements, rows beyond shared memory (N = 1,000,003), one row and 33
   rows at an odd address, a seed in device memory, and both kernels
   replayed from a CUDA graph with new rows and a new seed written into its
   buffers), each of them one device operation per call (torch.profiler);
   the codec also on the rows where the reference's f32 flushes
   subnormals (an absmax below 127 * 2^-126, subnormal entries, inf and
   NaN entries; subnormal, NaN and inf scales into dequantize);
   flash attention
   at tinyllama-1.1b's full width (B 4, S 2048, 32 q heads over 4 kv heads,
   hd 64; causal and window 128) on both routes: bf16 on the wgmma kernel
   within 2e-2, f32 on the split-TF32 kernel within 2e-5, and the f32
   cases of ``tests/test_kernels.py`` within 2e-5; the SSD scan at
   mamba2-780m's full width (B 4, S 2048, H 48, P 64, G 1, N 128, chunk
   256) on both routes: bf16 on the wgmma kernel, whose distance from the
   f32 recurrence (relative L2 and max |diff|) must be within
   ``SSD_BF16_RATIO`` of the model's own plain path in bf16 and within
   ``SSD_BF16_REL_L2``, f32 on the split-TF32 kernel at the same shape, and
   the f32 cases within 1e-4 + 1e-4 |plain|; the bf16 route's three
   launches and the f32 route's four timed apart, with their CTA counts.
   CUDA-event times (median of 30 after warm-up, host enqueue included) of
   the kernel, the plain version and, where one exists, the single PyTorch
   call computing the same function; each kernel's device time (30 calls
   replayed from one CUDA graph); the least time the card needs for each
   kernel's bytes or operations (for the f32 routes, the lower of their
   split-TF32 and CUDA-core bounds, both printed);
4. federation path — ``FederationSession`` approach-1 federation at the
   paper's full MLP width (8 users, Dirichlet-split 28x28 digit-like data,
   batch 64, fused engine, 16 rounds per chunk, each chunk one CUDA graph
   replay; every session of phases 4-7 runs on graphs): 64 rounds with codec
   ``none``, then 32 rounds each of ``topk_int8`` with deterministic and
   stochastic rounding.  Launch counts are zeroed before each run and must
   show one launch of each kernel per round where the run uses it; losses
   must be finite and the state on the card.  A small session run on the
   card and on the CPU (plain versions) from the same seed must agree;
5. block-local top-k — the kernel held BITWISE to its plain version on the
   cases of ``tests/test_kernels.py``, ties, all-zero rows and the main
   shape (8 x 267,009, fraction 0.1), timed beside its plain version and
   ``torch.topk`` over the 8192-element slices; then its entry point
   ``ops.topk_mask(mode="block")`` once with the counts zeroed;
6. cohort path — cohort-virtualized approach-1 federation at full MLP
   width: U = 256 and U = 32 logical users in a resident store on the card,
   a uniform cohort of 8 per round, ``topk_int8`` uploads with error
   feedback, the ``staleness_max_abs`` fold, 64 + 32 rounds in two windows
   with the fused-store engine, and U = 256 again with the plain cohort
   engine, which must give the same state bitwise.  One top-k, quantize
   and dequantize launch per round; ``last_round`` must equal the value
   computed from the schedule on the host.  Prints the U = 256 / U = 32
   ratio of steady ms per round.  Then approaches 2, 3 and the baseline,
   16 + 16 rounds each with 8 users, and approach 2 with a cohort of 4 of
   16 users; finite losses.  A small cohort session with error-fed int8
   uploads on the card and on the CPU must agree;
7. host streaming — the ``host`` backend at full MLP width: approach 1,
   ``topk_int8`` with error feedback, a uniform cohort of 8 of U = 256 and
   U = 1024 users, whose (U, N) store lives in pinned host memory, 64
   rounds in each of five modes: (a) the synchronous stream, (b) without
   data prefetch, (c) one round in flight, (d) superbatch windows of 16,
   (e) int8 row staging.  One top-k, quantize and dequantize launch per
   round (one more quantize and dequantize on (e)'s legs); (a) and (b) held
   to the device cohort engine on the same schedule and (d) to (a) within
   1e-6 per round and on the final store, ages and staleness bitwise; peak
   device memory must not grow with U.  Prints ms per round, host stall
   per round, pinned and device GB, the U = 1024 / U = 256 ratio and the
   stall ratio (c) / (b).  Small host sessions on the card and on the CPU
   must agree;
8. SPMD federation (``core/spmd.py``, one user or cohort member per rank of
   a users mesh on ``torch.distributed``) — B1 and B2 held BITWISE to their
   plain versions at one rank's row (1 x 267,009) and timed there; (a) NCCL
   at world size 1 in this process, paper MLP, batch 64, ``topk_int8``:
   ``make_spmd_step`` (8 rounds), ``make_spmd_engine`` (16), the
   replicated-store, sharded-store and rows engines at U = 256, C = 1 with
   error feedback (16 each; the three stores and losses bitwise equal) and
   the ``spmd`` backend session (32 rounds, pinned host store); launch
   counts zeroed before each run: one top-k, quantize and dequantize per
   round; the same ranks on the CPU over gloo must agree with the card (the
   engine at full width, a small session); (b) SPMD_RANKS gloo ranks
   sharing the card (``spawn_users``): approaches 1 (``topk_int8`` + EF), 2
   and 3 on the replicated-store, sharded-store and rows engines at U =
   256, the sharded and rows stores equal to the replicated one bitwise, G
   and the server D the same bytes on every rank.  ms per round of each
   engine, peak device and pinned GB, beside the card's name and power
   limit;
9. graphs against the eager chunk — each main-path run, the cohort U = 256
   run on both engines and approaches 2, 3 and the baseline, 48 rounds from
   one seed through the eager chunk and through the CUDA graphs the session
   replays: carries and losses bitwise equal, the graph's steady ms per
   round no higher, the peak device memory of each; windows of 5 + 6 rounds
   equal to one of 11 under graphs;
10. LM prefill path — ``models.model.loss_fn`` (the full-sequence forward
   and its cross-entropy) of tinyllama-1.1b with ``use_flash=True``, then
   of mamba2-780m with ``use_ssm_kernel=True``, at their full published
   width in bf16, random weights from seed 0 on the card, answering three
   scoring requests each (B 4; S 2048, 2048, 512; tokens from a numpy
   seed).  Launch counts are zeroed before each model and must show one
   launch per layer per forward, every one on the wgmma route (flash for
   tinyllama, the SSD scan for mamba2); the CE must be finite and near
   ln V.  The
   logits of the first request must agree with the model's own plain path
   (flag off) on the card within ``LM_REL_L2``, in bf16 and with the same
   weights in f32, and the bf16 kernel path must be no farther from the
   f32 logits than the bf16 plain path (``LM_F32_RATIO``); the f32
   forward with its kernel on runs with the counts zeroed and must launch
   the f32 route once per layer.  The reduced f32 configs from one seed on
   the card (kernels, f32 route) and on the CPU (plain versions) must agree
   at the reference's tolerances;
11. checkpoints — the main path (approach 1, ``topk_int8`` with stochastic
   rounding, chunks of 16): 16 rounds, ``save``, then a fresh process
   (this script with ``--resume-main``) restores, runs 16 rounds and saves;
   its state and losses must equal an uninterrupted 32-round run BITWISE
   (G, the Ds, the server D, every optimizer buffer, the step and the
   round-noise generator).  The cohort fused-store engine at U = 256, C =
   8 (``topk_int8`` + EF + SR) the same way, restored in this process (the
   error-feedback residual too).  One run with ``autosave_every=8`` whose
   autosaves hold the uninterrupted trajectory.  Save and restore wall
   seconds and the checkpoints' bytes are printed;
12. the conv pair — (a) the DCGAN pair at the paper's CelebA/LSUN width
   (64 x 64 x 3, z 100, 64 base filters: 2,297,728 G and 675,584 D
   parameters), approach 1, 8 users of Dirichlet(0.5)-split digit-like
   images at 64 x 64 (tiled to 3 channels), batch 64, ``topk_int8`` with
   error feedback, 32 rounds through the eager chunk and through the CUDA
   graphs: bitwise equal, one top-k, quantize and dequantize launch per
   round; steady ms per round of both, first chunk, peak GB; the eager
   chunk's time with deterministic cuDNN and without.  B1 and B2 held
   BITWISE to their plain versions on 8 rows of 675,584 and timed there.
   (b) the repo's Tables 3-4 run (32 x 32 x 1, z 64, 32 filters, 2 users
   holding digits 0-4 / 5-9, approach 3, batch 32, 64 rounds): finite
   losses, template coverage printed.  (c) W-GAN approach 3 on the paper
   MLP (d_lr 5e-4, g_lr 1e-4, b1 0), 32 rounds: finite losses, every
   critic weight within +-wgan_clip.  Then one round of (a) at U = 2 from
   the same weights on the card and on the CPU must agree within
   ``CONV_LOSS_RTOL`` (losses) and ``CONV_LEAF_REL`` / ``CONV_LEAF_LR_STEPS``
   (every state leaf);
13. the result: a ``kernels`` JSON line, the card line, and as the last
   line ``{"ok": true, "device": {...}}``.

Needs one CUDA device and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

MAIN_ROWS, MAIN_N, FRAC = 8, 267009, 0.1
BIG_N = 1_000_003     # top-k and codec slices beyond shared memory
LM_BATCH, LM_SEQS = 4, (2048, 2048, 512)
# the kernels' shapes on the LM path at full width (B = LM_BATCH)
FLASH_FULL = dict(S=2048, H=32, K=4, hd=64)            # tinyllama-1.1b
SSD_FULL = dict(S=2048, H=48, P=64, G=1, N=128, chunk=256)  # mamba2-780m
# The bf16 SSD route feeds the tensor cores bf16 operands: it rounds x o w
# and S_before as well as y, where the model's plain path (ssd_chunked)
# rounds them too, and carries the decayed scores G' as two bf16 operands.
# Against the f32 recurrence on the same bf16 inputs its relative L2 error
# and max |diff| must each be within SSD_BF16_RATIO of the plain path's in
# bf16, and its relative L2 error within SSD_BF16_REL_L2 (three roundings
# of 2^-9 relative at most: ~3.4e-3 in phase; a lost or doubled term is
# ~1).
SSD_BF16_RATIO, SSD_BF16_REL_L2 = 1.25, 1e-2
# Full-width logits, kernel path vs the model's plain path (flag off), as
# relative L2 error: (bf16 as the model runs, the same weights in f32).
# The random-init stack (weights of std 1/sqrt(layers), a residual stream
# growing to thousands) amplifies rounding differences layer by layer: in
# bf16 the two paths sit equally far from the f32 logits (0.30 tinyllama,
# 0.49-0.50 mamba2) and ~9 % / ~44 % from each other; in f32 they differ by
# 1.4e-4 / 7.3e-3 (the SSD's exp(cum_i - cum_j) over sums in the hundreds
# is sensitive to summation order).  Each bound is about twice what this
# script measured (PERF.md).
LM_REL_L2 = {"tinyllama-1.1b": (0.2, 1e-3), "mamba2-780m": (0.8, 2e-2)}
# ... and the bf16 kernel path must be no farther from the f32 logits than
# the bf16 plain path is, up to this factor.
LM_F32_RATIO = 1.05
# The DCGAN pair at the paper's CelebA/LSUN width, and its D's row width
CONV_FULL = dict(image_size=64, channels=3, z_dim=100, base_filters=64)
CONV_D_N, CONV_G_N = 675584, 2297728
CONV_ROUNDS = 32
# One conv round at U = 2 on the card vs the CPU.  Losses: rtol 1e-4 (f32
# sums in another order through ~3 M parameters; measured 1.2e-5).  Every
# state leaf: |card - cpu| <= CONV_LEAF_REL * max|leaf| + CONV_LEAF_LR_STEPS
# * lr.  Adam's first step is +-lr per element, so an element whose
# gradient rounds to the other sign moves 2 lr; and where the top-k fold
# takes another coordinate at its threshold (deltas an ULP apart) the
# server D differs there by a delta (~lr), which shifts G's gradient, and
# so its Adam moments, by a small fraction of their largest entry (the
# printed ``max_rel_beyond_lr``; PERF.md has the measured value).
CONV_LOSS_RTOL, CONV_LEAF_REL, CONV_LEAF_LR_STEPS = 1e-4, 2e-2, 4
# checkpoints are written inside the checkout, in a directory git ignores
CKPT_DIR = ROOT / "build" / "chip_smoke_ckpt"


def _fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _kernel_phase(torch, dev):
    """Bitwise checks on the main shape and edge cases; timings at the main
    shape.  Returns the per-kernel records (launches filled in later)."""
    from repro_torch.kernels import quantize as tq
    from repro_torch.kernels import ref
    from repro_torch.kernels import topk_select as tt

    gen = torch.Generator(device=dev).manual_seed(0)
    main = torch.randn((MAIN_ROWS, MAIN_N), generator=gen, device=dev) * 2e-4
    main[1] = torch.round(main[1] * 2e4) / 2e4          # heavy ties
    main[5, : MAIN_N // 2] = 0.0                         # half-sparse row

    def rows(n, r=3):
        x = torch.randn((r, n), generator=gen, device=dev)
        return x

    def odd_rows(n, r):
        """(r, n) rows whose base sits 4 bytes past an allocation."""
        return torch.randn((r * n + 1,), generator=gen, device=dev)[1:].view(
            r, n)

    topk_cases = [(main, FRAC), (main, 1.0), (main, 0.01)]
    for n in (1, 7, 100, 5000, 8192, 8192 + 17, 3 * 8192):
        for frac in (0.01, 0.1, 0.5, 1.0):
            topk_cases.append((rows(n), frac))
    degenerate = torch.stack([torch.zeros(300, device=dev),
                              torch.ones(300, device=dev),
                              torch.full((300,), -0.5, device=dev)])
    # beyond shared memory (the passes read device memory), one row, and
    # 33 rows (clusters in more than one wave)
    big, one, many = rows(BIG_N), odd_rows(MAIN_N, 1), odd_rows(20011, 33)
    topk_cases += [(degenerate, 0.1), (torch.round(rows(5000) * 4) / 4, 0.3),
                   (big, FRAC), (one, FRAC), (many, FRAC), (many, 0.01)]
    for x, frac in topk_cases:
        got = tt.topk_mask_rows(x, frac)
        if not torch.equal(got, ref.topk_mask_global_ref(x, frac)):
            raise AssertionError(f"topk_mask_rows != plain at {tuple(x.shape)}"
                                 f" frac={frac}")
    if not tt.topk_mask_rows(degenerate, 0.1)[0].all():
        raise AssertionError("all-zero row must keep every entry (t = 0)")

    codec_cases = [main, rows(1), rows(7), rows(1000), rows(8192 + 17),
                   degenerate, torch.zeros((2, 77), device=dev), big, one,
                   many]
    for x in codec_cases:
        for stochastic, seed in ((False, None), (True, 123),
                                 (True, 2**31 - 2)):
            q, s = tq.quantize_rows(x, stochastic=stochastic, seed=seed)
            qr, sr = ref.quantize_rows_ref(x, stochastic=stochastic,
                                           seed=seed)
            if not (torch.equal(q, qr) and torch.equal(s, sr)):
                raise AssertionError(
                    f"quantize_rows != plain at {tuple(x.shape)} "
                    f"stochastic={stochastic}")
            if not torch.equal(tq.dequantize_rows(q, s),
                               ref.dequantize_rows_ref(qr, sr)):
                raise AssertionError(f"dequantize_rows != plain at "
                                     f"{tuple(x.shape)}")

    _subnormal_codec_check(torch, tq, ref, dev)
    seed_t = torch.full((1,), 2**31 - 2, dtype=torch.int32, device=dev)
    if not all(torch.equal(a, b) for a, b in zip(
            tq.quantize_rows(many, stochastic=True, seed=seed_t),
            ref.quantize_rows_ref(many, stochastic=True, seed=2**31 - 2))):
        raise AssertionError("quantize_rows with a device seed != plain")
    _graph_replay_check(torch, tt, tq, ref, main)
    _one_launch_check(torch, tt, tq, main)
    del big, one, many

    k = ref.topk_k(MAIN_N, FRAC)
    elems = MAIN_ROWS * MAIN_N
    q_main, s_main = tq.quantize_rows(main)
    recs = []

    def record(*args, **kwargs):
        recs.append(_record(torch, *args, **kwargs))

    def lib_topk():
        kth = torch.topk(torch.abs(main), k, dim=1).values[:, -1:]
        return torch.abs(main) >= kth

    mask_err = float((tt.topk_mask_rows(main, FRAC).float()
                      - ref.topk_mask_global_ref(main, FRAC).float())
                     .abs().max())
    record("topk_mask_rows", "src/repro_torch/kernels/csrc/topk_select.cu",
           "src/repro/kernels/topk_select.py:110",
           lambda: tt.topk_mask_rows(main, FRAC),
           lambda: ref.topk_mask_global_ref(main, FRAC), lib_topk,
           nbytes=elems * 4 + elems * 1, ops=elems, err=mask_err)
    for stochastic in (False, True):
        seed = 123 if stochastic else None
        q, s = tq.quantize_rows(main, stochastic=stochastic, seed=seed)
        qr, sr = ref.quantize_rows_ref(main, stochastic=stochastic, seed=seed)
        err = max(float((q.float() - qr.float()).abs().max()),
                  float((s - sr).abs().max()))
        record("quantize_rows" + ("_stochastic" if stochastic else ""),
               "src/repro_torch/kernels/csrc/quantize.cu",
               "src/repro/kernels/quantize.py:83",
               lambda: tq.quantize_rows(main, stochastic=stochastic,
                                        seed=seed),
               lambda: ref.quantize_rows_ref(main, stochastic=stochastic,
                                             seed=seed), None,
               nbytes=elems * 4 + elems + MAIN_ROWS * 4,
               ops=elems * (6 if stochastic else 3), err=err)
    deq_err = float((tq.dequantize_rows(q_main, s_main)
                     - ref.dequantize_rows_ref(q_main, s_main)).abs().max())
    record("dequantize_rows", "src/repro_torch/kernels/csrc/quantize.cu",
           "src/repro/kernels/quantize.py:136",
           lambda: tq.dequantize_rows(q_main, s_main),
           lambda: ref.dequantize_rows_ref(q_main, s_main), None,
           nbytes=elems + MAIN_ROWS * 4 + elems * 4, ops=elems, err=deq_err)
    return recs, len(topk_cases), len(codec_cases)


def _codec_edge_rows(torch, dev, n: int):
    """Rows of n where the reference's f32 flushes: an absmax below 127 *
    2^-126 (scale 0), subnormal entries under a subnormal and under a normal
    scale, inf entries (inf times inv = 0 is NaN, coded 0), a NaN, and
    magnitudes just above the least normal scale."""
    gen = torch.Generator(device=dev).manual_seed(n)
    x = torch.randn((7, n), generator=gen, device=dev)
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
    x[6] *= 2e-4                                  # a normal row beside them
    return x


def _same_floats(torch, a, b) -> bool:
    """Equal bit patterns (so signed zeros too), NaN where NaN."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        a[~nan].view(torch.int32), b[~nan].view(torch.int32))


def _subnormal_codec_check(torch, tq, ref, dev) -> None:
    """B2 on the flushed edges, BITWISE against the plain versions: the
    edge rows at the main width, at 1 and 4096 elements and beyond shared
    memory, both rounding modes; dequantize with subnormal, least-normal,
    zero, NaN and inf scales."""
    for n in (1, 4096, MAIN_N, BIG_N):
        x = _codec_edge_rows(torch, dev, n)
        for stochastic, seed in ((False, None), (True, 123)):
            q, s = tq.quantize_rows(x, stochastic=stochastic, seed=seed)
            qr, sr = ref.quantize_rows_ref(x, stochastic=stochastic,
                                           seed=seed)
            if not (torch.equal(q, qr) and _same_floats(torch, s, sr)):
                raise AssertionError(f"quantize_rows != plain on the edge "
                                     f"rows (n={n}, stochastic={stochastic})")
            if n > 1 and (q[0].any() or q[1].any() or q[3].any()):
                raise AssertionError("a flushed row kept nonzero codes")
            if not _same_floats(torch, tq.dequantize_rows(q, s),
                                ref.dequantize_rows_ref(qr, sr)):
                raise AssertionError(f"dequantize_rows != plain on the edge "
                                     f"rows (n={n})")
    q = torch.randint(-127, 128, (6, MAIN_N), dtype=torch.int8, device=dev)
    scale = torch.tensor([3e-39, 2.0 ** -126, 0.0, float("nan"),
                          float("inf"), 1e-3], device=dev)
    got, want = tq.dequantize_rows(q, scale), ref.dequantize_rows_ref(q, scale)
    if not _same_floats(torch, got, want) or got[0].any():
        raise AssertionError("dequantize_rows != plain with subnormal, NaN "
                             "and inf scales")


def _graph_replay_check(torch, tt, tq, ref, main) -> None:
    """``topk_mask_rows`` and stochastic ``quantize_rows`` with a device seed
    captured in one CUDA graph: new rows and a new seed written into the
    static buffers before each replay must give the plain versions' results
    on them, bitwise."""
    x = main.clone()
    seed = torch.zeros((1,), dtype=torch.int32, device=main.device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tt.topk_mask_rows(x, FRAC)
        tq.quantize_rows(x, stochastic=True, seed=seed)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        mask = tt.topk_mask_rows(x, FRAC)
        q, s = tq.quantize_rows(x, stochastic=True, seed=seed)
    gen = torch.Generator(device=main.device).manual_seed(3)
    for value in (7, 2**31 - 2):
        x.copy_(torch.randn(x.shape, generator=gen, device=x.device))
        x[1] = torch.round(x[1] * 4) / 4
        seed.fill_(value)
        graph.replay()
        torch.cuda.synchronize()
        qr, sr = ref.quantize_rows_ref(x, stochastic=True, seed=value)
        if not (torch.equal(mask, ref.topk_mask_global_ref(x, FRAC))
                and torch.equal(q, qr) and torch.equal(s, sr)):
            raise AssertionError(f"graph replay != plain (seed {value})")
    del graph


def _one_launch_check(torch, tt, tq, main) -> None:
    """``topk_mask_rows`` and ``quantize_rows`` each run as exactly one
    device operation (no memset, no second kernel), by ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    for name, fn in (("topk_mask_rows", lambda: tt.topk_mask_rows(main, FRAC)),
                     ("quantize_rows", lambda: tq.quantize_rows(main)),
                     ("quantize_rows_stochastic",
                      lambda: tq.quantize_rows(main, stochastic=True,
                                               seed=123))):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ops = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
        if len(ops) != 1:
            raise AssertionError(f"{name}: {len(ops)} device operations per "
                                 f"call, want 1: {ops}")


def _record(torch, name, source, replaces, kern, plain, library, nbytes, ops,
            err, peak=None, split_tf32=False):
    """One kernel's line of the ``kernels`` JSON (launches filled in after
    the main path's run).  ``ms`` is the event time of one call with the
    host's enqueue, ``device_ms`` the device time of one call (30 calls
    replayed from one CUDA graph).  The bound (``repro_torch.timing``, H100
    SXM data-sheet rates) is the bytes' time or the operations' at ``peak``
    (f32 on the CUDA cores by default); for an f32 kernel whose products
    are split TF32 (``split_tf32``) the lower of two: three TF32 products
    per product at 495 TFLOP/s, or f32 products at 67 TFLOP/s, both kept
    in the line.  ``share_of_bound`` is the bound over the device time."""
    from repro_torch.timing import (F32_OPS_PER_S, bound_ms, event_ms,
                                    f32_bounds, graph_ms)
    if split_tf32:
        bounds = f32_bounds(nbytes, ops)
    else:
        t, by = bound_ms(nbytes, ops, peak or F32_OPS_PER_S)
        bounds = {"bound_ms": t, "bound_by": by}
    rec = {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": 0, "max_abs_err": err,
        "ms": event_ms(kern), "device_ms": graph_ms(kern),
        "plain_ms": event_ms(plain), **bounds,
        "library_ms": None if library is None else event_ms(library)}
    rec["share_of_bound"] = rec["bound_ms"] / rec["device_ms"]
    return rec


# (B, S, H, K, hd, causal, window): the f32 cases of tests/test_kernels.py
FLASH_F32_CASES = [(2, 256, 4, 4, 64, True, 0), (2, 256, 4, 2, 64, True, 0),
                   (2, 128, 8, 1, 32, True, 0), (1, 256, 2, 2, 64, True, 64),
                   (1, 256, 2, 2, 64, True, 128),
                   (1, 128, 2, 2, 64, False, 0)]


def _flash_pairs(S: int, T: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask keeps in one (b, h)."""
    total = 0
    for i in range(S):
        hi = min(i, T - 1) if causal else T - 1
        lo = max(0, i - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


def _lm_kernel_phase(torch, dev):
    """Flash attention and the SSD scan held to their plain versions at the
    LM path's full-width bf16 shapes and on the f32 cases of
    tests/test_kernels.py; timings at the full-width shapes.  Returns the
    two records and a dict of what was checked."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as tfl
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as tss
    from repro_torch.models.ssm import ssd_chunked
    from repro_torch.profile_ssd import F32Runner, Runner
    from repro_torch.timing import BF16_OPS_PER_S, event_ms

    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).to(dtype)

    def ssd_inputs(B, S, H, P, G, N, dtype):
        return (randn((B, S, H, P), dtype, 0.5),
                F.softplus(randn((B, S, H))),
                -torch.exp(torch.rand((H,), generator=gen, device=dev)),
                randn((B, S, G, N), dtype, 0.3),
                randn((B, S, G, N), dtype, 0.3))

    def ssd_err(got, want, atol, rtol):
        diff = (got.float() - want.float()).abs()
        over = float((diff - (atol + rtol * want.float().abs())).max())
        return float(diff.max()), over

    info = {"flash_f32_worst": 0.0, "ssd_f32_worst": 0.0}
    for B, S, H, K, hd, causal, window in FLASH_F32_CASES:
        q = randn((B, S, H, hd))
        k, v = randn((B, S, K, hd)), randn((B, S, K, hd))
        blk = min(128, S)
        got = tfl.flash_attention(q, k, v, causal=causal, window=window,
                                  bq=blk, bkv=blk)
        err = float((got - ref.flash_attention_ref(
            q, k, v, causal=causal, window=window)).abs().max())
        if not err <= 2e-5:
            raise AssertionError(f"flash f32 {(B, S, H, K, hd)} causal="
                                 f"{causal} window={window}: {err} > 2e-5")
        info["flash_f32_worst"] = max(info["flash_f32_worst"], err)
    for chunk in (16, 32, 64):
        for G in (1, 2):
            arrs = ssd_inputs(2, 128, 4, 32, G, 16, torch.float32)
            err, over = ssd_err(tss.ssd_scan(*arrs, chunk=chunk),
                                ref.ssd_scan_ref(*arrs), 1e-4, 1e-4)
            if over > 0:
                raise AssertionError(f"ssd f32 chunk={chunk} G={G}: "
                                     f"{err} beyond 1e-4 + 1e-4 |plain|")
            info["ssd_f32_worst"] = max(info["ssd_f32_worst"], err)
    # the wrapper plans the f32 route with the kernel's own shared-memory
    # sums and the device's limit
    limit = tss.smem_limit(dev)
    for P, N, chunk in ((32, 16, 16), (32, 16, 32), (32, 16, 64),
                        (64, 128, 256), (16, 340, 64), (128, 176, 128)):
        plan = tss.tf32_plan_args(tss.tf32_plan(P, N, chunk, limit))
        sums = tss.device_smem(P, N, chunk, *plan, dev)
        if sums != (*tss.tf32_smem(P, N, chunk, *plan), limit):
            raise AssertionError(f"ssd f32 shared memory {(P, N, chunk)} "
                                 f"plan {plan}: kernel {sums}, wrapper "
                                 f"{tss.tf32_smem(P, N, chunk, *plan)} "
                                 f"within {limit}")
    info["ssd_f32_smem_limit"] = limit

    # full width: tinyllama-1.1b attention, mamba2-780m SSD, bf16
    B = LM_BATCH
    S, H, K, hd = (FLASH_FULL[k] for k in ("S", "H", "K", "hd"))
    q = randn((B, S, H, hd), torch.bfloat16)
    k, v = randn((B, S, K, hd), torch.bfloat16), randn((B, S, K, hd),
                                                       torch.bfloat16)
    flash_err = {}
    for window in (0, 128):
        got = tfl.flash_attention(q, k, v, causal=True, window=window)
        want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
        flash_err[window] = float((got.float() - want.float()).abs().max())
        if not flash_err[window] <= 2e-2:
            raise AssertionError(f"flash bf16 full width window={window}: "
                                 f"{flash_err[window]} > 2e-2")
    info["flash_bf16_window128_err"] = flash_err[128]
    info["flash_window128_ms"] = event_ms(
        lambda: tfl.flash_attention(q, k, v, causal=True, window=128))
    flops = 4 * hd * B * H * _flash_pairs(S, S, True, 0)
    flash_recs = []
    # bf16 -> the wgmma kernel, f32 -> the split-TF32 kernel, same shape
    for name, source, dtype, peak, tol in (
            ("flash_attention", "flash_attention_wgmma.cu", torch.bfloat16,
             BF16_OPS_PER_S, 2e-2),
            ("flash_attention_f32", "flash_attention_tf32.cu", torch.float32,
             None, 2e-5)):
        qd, kd, vd = (t.to(dtype) for t in (q, k, v))
        err = float((tfl.flash_attention(qd, kd, vd, causal=True).float()
                     - ref.flash_attention_ref(qd, kd, vd, causal=True)
                     .float()).abs().max())
        if not err <= tol:
            raise AssertionError(f"{name} full width: {err} > {tol}")
        qh, kh, vh = (t.transpose(1, 2) for t in (qd, kd, vd))  # head-major
        flash_recs.append(_record(
            torch, name, f"src/repro_torch/kernels/csrc/{source}",
            "src/repro/kernels/flash_attention.py:87",
            lambda: tfl.flash_attention(qd, kd, vd, causal=True),
            lambda: ref.flash_attention_ref(qd, kd, vd, causal=True),
            lambda: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True, enable_gqa=True),
            nbytes=qd.element_size() * (2 * qd.numel() + kd.numel()
                                        + vd.numel()),
            ops=flops, err=err, peak=peak, split_tf32=peak is None))
        del qd, kd, vd, qh, kh, vh
    torch.cuda.empty_cache()

    S, Hs, P, G, N, chunk = (SSD_FULL[k] for k in ("S", "H", "P", "G", "N",
                                                   "chunk"))
    x, dt, A, Bm, Cm = ssd_inputs(B, S, Hs, P, G, N, torch.bfloat16)
    # bf16 route: distance from the f32 recurrence on the same bf16 inputs,
    # held to the model's own plain path (ssd_chunked) in bf16
    got = tss.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk).float()
    truth = ref.ssd_scan_ref(x.float(), dt, A, Bm.float(), Cm.float(),
                             chunk=chunk)
    plain = ssd_chunked(x, dt, A, Bm, Cm, chunk)[0].float()
    kern_l2, plain_l2 = _rel_l2(torch, got, truth), _rel_l2(torch, plain,
                                                            truth)
    kern_max = float((got - truth).abs().max())
    plain_max = float((plain - truth).abs().max())
    info.update(ssd_bf16_rel_l2=kern_l2, ssd_bf16_max_abs=kern_max,
                ssd_plain_bf16_rel_l2=plain_l2,
                ssd_plain_bf16_max_abs=plain_max)
    if not (kern_l2 <= SSD_BF16_RATIO * plain_l2
            and kern_max <= SSD_BF16_RATIO * plain_max
            and kern_l2 <= SSD_BF16_REL_L2):
        raise AssertionError(
            f"ssd bf16 full width vs the f32 recurrence: rel L2 {kern_l2}, "
            f"max {kern_max}; plain path in bf16 {plain_l2}, {plain_max} "
            f"(want <= {SSD_BF16_RATIO}x and rel L2 <= {SSD_BF16_REL_L2})")
    del got, truth, plain
    torch.cuda.empty_cache()
    # the bf16 route's three launches timed apart
    ctas = tss.wgmma_ctas(B, S, Hs, P, N, chunk)
    phase_ms = Runner(tss.wgmma_entry(), x, dt, A, Bm, Cm,
                      chunk).launch_ms(30)
    info["ssd_wgmma_phases"] = {name: {"ctas": ctas[name],
                                       "ms": phase_ms[name]}
                                for name in ctas}
    print(f"[kernels] ssd_scan bf16 (wgmma) launches, CTAs and event ms: "
          f"{json.dumps(info['ssd_wgmma_phases'])}", flush=True)

    nc = S // chunk
    tri = chunk * (chunk + 1) // 2
    ssd_flops = B * Hs * nc * (2 * tri * (N + P) + 4 * chunk * N * P)
    ssd_recs = []
    # bf16 -> the wgmma kernel, f32 -> the split-TF32 kernel, same shape
    for name, source, dtype, peak in (
            ("ssd_scan", "ssd_scan_wgmma.cu", torch.bfloat16,
             BF16_OPS_PER_S),
            ("ssd_scan_f32", "ssd_scan_tf32.cu", torch.float32, None)):
        xd, Bd, Cd = (t.to(dtype) for t in (x, Bm, Cm))
        if dtype == torch.float32:
            err, over = ssd_err(tss.ssd_scan(xd, dt, A, Bd, Cd, chunk=chunk),
                                ref.ssd_scan_ref(xd, dt, A, Bd, Cd), 1e-4,
                                1e-4)
            if over > 0:
                raise AssertionError(f"ssd f32 full width: {err} beyond "
                                     f"1e-4 + 1e-4 |plain|")
            info["ssd_f32_full_width_err"] = err
            info["ssd_f32_full_width_over_tol"] = over
            # the f32 route's four launches timed apart, with their CTAs
            runner = F32Runner(xd, dt, A, Bd, Cd, chunk)
            ctas = tss.tf32_ctas(B, S, Hs, P, G, N, chunk, runner.plan[0])
            phase_ms = runner.phase_ms(30)
            del runner
            info["ssd_f32_phases"] = {
                name: {"ctas": ctas[name], "device_ms": phase_ms[name]}
                for name in ctas}
            print(f"[kernels] ssd_scan f32 (split TF32) launches, CTAs and "
                  f"device ms: {json.dumps(info['ssd_f32_phases'])}",
                  flush=True)
        else:
            err = kern_max
        size = xd.element_size()
        ssd_bytes = size * (2 * xd.numel() + Bd.numel() + Cd.numel()) + \
            4 * (dt.numel() + A.numel())
        ssd_recs.append(_record(
            torch, name, f"src/repro_torch/kernels/csrc/{source}",
            "src/repro/kernels/ssd_scan.py:73",
            lambda: tss.ssd_scan(xd, dt, A, Bd, Cd, chunk=chunk),
            lambda: ref.ssd_scan_ref(xd, dt, A, Bd, Cd, chunk=chunk), None,
            nbytes=ssd_bytes, ops=ssd_flops, err=err, peak=peak,
            split_tf32=peak is None))
        del xd, Bd, Cd
    torch.cuda.empty_cache()
    return flash_recs + ssd_recs, info


def _lm_prefill(torch, dev):
    """The LM prefill path at full width: per model, three scoring requests
    through ``loss_fn`` with its kernel on, launch counts zeroed just before
    and read just after; then the first request against the plain path.
    Prints a line per request and per model; returns (per-request lines,
    launch totals, the ms of each f32 forward with its kernel on)."""
    import math

    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M

    requests, models, totals, f32_ms = [], [], {}, {}
    for arch, flag, kname in (("tinyllama-1.1b", "use_flash",
                               "flash_attention"),
                              ("mamba2-780m", "use_ssm_kernel", "ssd_scan")):
        cfg = get_config(arch)
        t0 = time.perf_counter()
        params = M.init_params(cfg, 0, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        rng = np.random.default_rng(0)
        batches = [{key: torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (LM_BATCH, seq))).to(dev)
            for key in ("tokens", "targets")} for seq in LM_SEQS]
        ln_v = math.log(cfg.vocab_size)
        ops.reset_launch_counts()
        for batch in batches:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = ops.launch_counts()[kname]
            routes = _route_counts(ops, kname)
            t = time.perf_counter()
            _, metrics = M.loss_fn(params, batch, cfg, **{flag: True})
            ce = float(metrics["ce"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            per_fwd = ops.launch_counts()[kname] - before
            if per_fwd != cfg.num_layers:
                raise AssertionError(f"{arch}: {per_fwd} {kname} launches in "
                                     f"a forward, want {cfg.num_layers}: the "
                                     f"path bypassed the kernel")
            got = {r: n - routes[r]
                   for r, n in _route_counts(ops, kname).items()}
            if got != {"wgmma": cfg.num_layers, "f32": 0}:
                raise AssertionError(f"{arch}: bf16 forward {kname} routes "
                                     f"{got}, want every launch on wgmma")
            if not (math.isfinite(ce) and abs(ce - ln_v) < 2.0):
                raise AssertionError(f"{arch}: CE {ce} not near ln V {ln_v}")
            seq = batch["tokens"].shape[1]
            requests.append({
                "model": arch, "kernel": kname, "batch": LM_BATCH,
                "seq": seq, "ms": wall * 1e3,
                "tokens_per_s": LM_BATCH * seq / wall,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                "ce": ce, "ln_v": ln_v, "launches_per_forward": per_fwd})
        counts = ops.launch_counts()
        others = {k: v for k, v in counts.items() if k != kname and v}
        if others:
            raise AssertionError(f"{arch}: unexpected launches {others}")
        totals[kname] = (counts[kname], cfg.num_layers)

        models.append(_lm_vs_plain(torch, M, cfg, params, flag,
                                   {"tokens": batches[0]["tokens"]}))
        f32_counts = models[-1].pop("f32_forward_launches")
        routes = models[-1][f"f32_forward_{kname}_routes"]
        if routes != {"wgmma": 0, "f32": cfg.num_layers} or \
                f32_counts[kname] != cfg.num_layers:
            raise AssertionError(f"{arch}: f32 forward {kname} routes "
                                 f"{routes}, want every launch on f32")
        totals[f"{kname}_f32"] = (routes["f32"], cfg.num_layers)
        f32_ms[f"{kname}_f32"] = models[-1]["f32_kernel_forward_ms"]
        models[-1].update(init_s=init_s, params=sum(
            t.numel() for t in _np_leaves(params)))
        for line in requests[-len(LM_SEQS):] + models[-1:]:
            print("[lm] " + json.dumps(line), flush=True)
        _check_lm_vs_plain(models[-1])
        del params
        torch.cuda.empty_cache()
    return requests, totals, f32_ms


def _route_counts(ops, kname: str) -> dict:
    """Launches of the LM kernel ``kname`` by route (wgmma, f32)."""
    return {"flash_attention": ops.flash_route_counts,
            "ssd_scan": ops.ssd_route_counts}[kname]()


def _rel_l2(torch, a, b) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def _lm_vs_plain(torch, M, cfg, params, flag, batch) -> dict:
    """Logits of the kernel path against the model's own plain path (flag
    off) on one request: in bf16 as the model runs, and with the same
    weights in f32, where the plain path is the arbiter of both bf16
    paths."""
    import dataclasses

    from repro_torch.kernels import ops
    from repro_torch.models.common import tree_map

    got, _ = M.forward(params, batch, cfg, **{flag: True})
    want, _ = M.forward(params, batch, cfg, **{flag: False})
    line = {"model": cfg.name, "layers": cfg.num_layers,
            "logits_max_abs_diff": float((got - want).abs().max()),
            "logits_max_abs": float(want.abs().max()),
            "logits_rel_l2": _rel_l2(torch, got, want),
            "argmax_agree": float((got.argmax(-1) == want.argmax(-1))
                                  .float().mean())}
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    p32 = tree_map(lambda t: t.to(torch.float32), params)
    truth, _ = M.forward(p32, batch, cfg32, **{flag: False})
    line["kernel_vs_f32_rel_l2"] = _rel_l2(torch, got, truth)
    line["plain_vs_f32_rel_l2"] = _rel_l2(torch, want, truth)
    del got, want
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    got32, _ = M.forward(p32, batch, cfg32, **{flag: True})
    torch.cuda.synchronize()
    line["f32_kernel_forward_ms"] = (time.perf_counter() - t) * 1e3
    line["f32_forward_launches"] = ops.launch_counts()
    line["f32_forward_flash_attention_routes"] = ops.flash_route_counts()
    line["f32_forward_ssd_scan_routes"] = ops.ssd_route_counts()
    line["f32_kernel_vs_plain_rel_l2"] = _rel_l2(torch, got32, truth)
    del p32, got32, truth
    torch.cuda.empty_cache()
    return line


def _check_lm_vs_plain(line: dict) -> None:
    bf16_tol, f32_tol = LM_REL_L2[line["model"]]
    if not line["logits_rel_l2"] <= bf16_tol:
        raise AssertionError(f"{line['model']}: kernel vs plain bf16 logits "
                             f"rel L2 {line['logits_rel_l2']} > {bf16_tol}")
    if not line["f32_kernel_vs_plain_rel_l2"] <= f32_tol:
        raise AssertionError(f"{line['model']}: kernel vs plain f32 logits "
                             f"rel L2 {line['f32_kernel_vs_plain_rel_l2']} > "
                             f"{f32_tol}")
    if not line["kernel_vs_f32_rel_l2"] <= \
            LM_F32_RATIO * line["plain_vs_f32_rel_l2"]:
        raise AssertionError(f"{line['model']}: the bf16 kernel path is "
                             f"farther from f32 than the plain path: {line}")


def _lm_cpu_agreement(torch, dev) -> dict:
    """The reduced f32 configs from one seed, on the card (kernels) and on
    the CPU (plain versions), at the reference's tolerances
    (tests/test_kernels.py: 2e-4; 5e-4 + 1e-4 |x| at chunk 16)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M

    worst = {}
    for arch, flag, kname, chunk, atol, rtol in (
            ("tinyllama-1.1b", "use_flash", "flash_attention", None, 2e-4,
             0.0),
            ("mamba2-780m", "use_ssm_kernel", "ssd_scan", 16, 5e-4, 1e-4)):
        cfg = get_config(arch).reduced()
        if chunk:
            cfg = dataclasses.replace(cfg, chunk_size=chunk)
        tokens = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (2, 32)))
        ops.reset_launch_counts()
        got, _ = M.forward(M.init_params(cfg, 0, device=dev),
                           {"tokens": tokens.to(dev)}, cfg, **{flag: True})
        routes = _route_counts(ops, kname)
        if ops.launch_counts()[kname] != cfg.num_layers or \
                routes != {"wgmma": 0, "f32": cfg.num_layers}:
            raise AssertionError(f"{arch}: card forward did not use {kname}"
                                 f" on the f32 route: {routes}")
        want, _ = M.forward(M.init_params(cfg, 0, device="cpu"),
                            {"tokens": tokens}, cfg, **{flag: True})
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   atol=atol, rtol=rtol)
        worst[arch] = float((got.cpu() - want).abs().max())
    return worst


def _digits_dataset(num_users: int, size: int, per_class: int):
    import numpy as np

    from repro_torch.data import digits_like_mixture, dirichlet_partition
    rng = np.random.default_rng(0)
    data, labels = [], []
    for c in range(10):
        _, sample = digits_like_mixture([c], size=size)
        data.append(sample(rng, per_class))
        labels.append(np.full(per_class, c))
    data = np.concatenate(data).reshape(10 * per_class, -1)
    return dirichlet_partition(data, np.concatenate(labels), num_users,
                               alpha=0.5, seed=0)


def _session(pair, dataset, num_users, codec, stochastic, device,
             batch=64, rpj=16, eval_samples=256, approach="approach1",
             scheduler="full", cohort=None, fuse=False, ef=False,
             combiner="max_abs", fcfg=None, backend=None, stage_rows=False,
             mesh=None):
    from repro_torch.core.session import FederationSession
    from repro_torch.core.spec import (BackendSpec, CombineSpec,
                                       CompressionSpec, EngineSpec,
                                       FederationSpec, ParticipationSpec)
    spec = FederationSpec(
        approach, batch_size=batch, seed=0, eval_samples=eval_samples,
        engine=EngineSpec(kind="fused", rounds_per_jit=rpj,
                          fuse_store_rounds=fuse),
        participation=ParticipationSpec(scheduler, cohort_size=cohort),
        backend=backend or BackendSpec(),
        combine=CombineSpec(combiner=combiner, compression=CompressionSpec(
            codec=codec, error_feedback=ef, stochastic=stochastic,
            stage_rows=stage_rows)))
    return FederationSession(pair, fcfg or _fcfg(num_users), dataset, spec,
                             device=device, mesh=mesh)


def _fcfg(num_users):
    from repro_torch.core.approaches import DistGANConfig
    return DistGANConfig(num_users=num_users, upload_frac=FRAC)


def _main_path(torch, dev):
    """The three main-path runs; returns (per-run lines, launch totals)."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.models.common import tree_leaves

    pair = _paper_pair()
    dataset = _digits_dataset(MAIN_ROWS, 28, 400)
    totals = {k: 0 for k in ("topk_mask_rows", "quantize_rows",
                             "quantize_rows_stochastic", "dequantize_rows")}
    lines = []
    for codec, stochastic, rounds in (("none", False, 64),
                                      ("topk_int8", False, 32),
                                      ("topk_int8", True, 32)):
        sess = _session(pair, dataset, MAIN_ROWS, codec, stochastic, dev)
        ops.reset_launch_counts()
        res = sess.run(rounds)
        counts = ops.launch_counts()
        lossy = codec != "none"
        want = dict.fromkeys(counts, 0)
        want.update(topk_mask_rows=rounds,
                    quantize_rows=rounds if lossy else 0,
                    dequantize_rows=rounds if lossy else 0)
        if counts != want:
            raise AssertionError(f"launch counts {counts} != {want} "
                                 f"({codec}, stochastic={stochastic})")
        for k in ("topk_mask_rows", "quantize_rows", "dequantize_rows"):
            totals[k + ("_stochastic" if stochastic and k == "quantize_rows"
                        else "")] += counts[k]
        if not (np.all(np.isfinite(res.g_losses))
                and np.all(np.isfinite(res.d_losses))):
            raise AssertionError(f"non-finite losses ({codec})")
        if res.g_losses.shape != (rounds,) or \
                res.d_losses.shape != (rounds, MAIN_ROWS):
            raise AssertionError("loss shapes")
        leaves = [t for tree in (res.state.g, res.state.ds,
                                 res.state.server_d, res.state.d_opts,
                                 res.state.g_opt) for t in tree_leaves(tree)]
        if not all(t.device == torch.device(dev) for t in leaves):
            raise AssertionError(f"state left {dev}")
        kmin = int(MAIN_N * FRAC) / MAIN_N
        if not kmin <= res.extra["kept_frac"] <= 1.0:
            raise AssertionError(f"kept_frac {res.extra['kept_frac']}")
        if res.samples.shape != (256, 784) or \
                not np.all(np.abs(res.samples) <= 1.0):
            raise AssertionError("generator samples")
        lines.append({
            "run": f"approach1 codec={codec} stochastic={stochastic}",
            "rounds": rounds, "launches": counts,
            "steady_ms_per_round": res.step_time_s * 1e3,
            "best_chunk_ms_per_round": res.extra["min_step_time_s"] * 1e3,
            "first_chunk_s": res.extra["compile_s"],
            "g_loss_first_last": [float(res.g_losses[0]),
                                  float(res.g_losses[-1])],
            "kept_frac": res.extra["kept_frac"],
            "upload_bytes_per_round": res.extra["upload_bytes_per_round"]})
    return lines, totals


def _cpu_agreement(torch, dev) -> dict:
    """A small session from one seed on the card (kernels) and on the CPU
    (plain versions): the noise is drawn on the host, so the runs differ
    only by summation order and, through it, an occasional top-k boundary
    coordinate (one Adam-sized delta, ~lr)."""
    import numpy as np

    from repro_torch.convert import state_to_numpy
    from repro_torch.core.gan import MLPGanConfig, make_mlp_pair
    from repro_torch.kernels import ops

    pair = make_mlp_pair(MLPGanConfig(data_dim=64, z_dim=16, g_hidden=32,
                                      d_hidden=32))
    dataset = _digits_dataset(3, 8, 60)
    worst = {}
    for codec, stochastic in (("none", False), ("topk_int8", True)):
        before = dict(ops.launch_counts())
        a = _session(pair, dataset, 3, codec, stochastic, dev, batch=16,
                     rpj=4, eval_samples=0).run(6)
        b = _session(pair, dataset, 3, codec, stochastic, "cpu", batch=16,
                     rpj=4, eval_samples=0).run(6)
        if ops.launch_counts()["topk_mask_rows"] != \
                before["topk_mask_rows"] + 6:
            raise AssertionError("card session did not use the kernels")
        np.testing.assert_allclose(a.g_losses, b.g_losses, atol=1e-3)
        sa, sb = state_to_numpy(a.state), state_to_numpy(b.state)
        diffs = []
        for key in sa:
            for x, y in zip(_np_leaves(sa[key]), _np_leaves(sb[key])):
                np.testing.assert_allclose(x, y, atol=2e-3, rtol=1e-3)
                diffs.append(float(np.max(np.abs(np.asarray(x, np.float64)
                                                 - y))))
        worst[f"{codec}{'_sr' if stochastic else ''}"] = max(diffs)
    return worst


def _np_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _np_leaves(tree[k])]
    return [tree]


def _block_topk_phase(torch, dev):
    """The block-local top-k held BITWISE to its plain version on the cases
    of tests/test_kernels.py (as 3-row batches), ties at quarter steps,
    all-zero rows, rows holding NaN, +-inf, subnormals and magnitudes near
    the least normal, frac 1.0 and 1.5, rows 4 bytes off the mask's
    alignment, and the main shape and the conv D's width (8 x 675,584);
    timings at the main shape, and at the conv D's width under
    ``at_conv_d_width``.  Returns its record (launches filled in by
    ``_block_topk_path``), the main input and the number of cases."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import topk_select as tt

    gen = torch.Generator(device=dev).manual_seed(2)
    blk = ref.BLOCK

    def randn(shape):
        return torch.randn(shape, generator=gen, device=dev)

    main = randn((MAIN_ROWS, MAIN_N)) * 2e-4
    conv = randn((MAIN_ROWS, CONV_D_N)) * 2e-4
    zeros = torch.zeros((2, blk + 17), device=dev)
    special = randn((7, 2 * blk + 100))
    special[0, 5000] = float("nan")                   # slice 0 keeps all
    special[0, :: 97] = float("inf")                  # but the NaN
    special[1, 1:: 89] = float("-inf")
    special[2, ::2] *= 1e-40                          # subnormals count 0
    special[3] = (special[3].abs() + 0.5) * 1.1754944e-38   # subnormal mids
    special[4, ::3] = float("inf")
    special[5, blk:] = 0.0
    special[6] *= 5e37                                # lo + h overflows
    off = torch.empty(3 * 20011 + 1, device=dev)[1:].view(3, 20011)
    off.copy_(randn((3, 20011)))                      # x 4 bytes off
    cases = [(randn((3, n)), frac) for n in (blk, 3 * blk, blk + 17, 5000)
             for frac in (0.01, 0.1, 0.5)]
    cases += [(torch.round(randn((3, 2 * blk + 100)) * 4) / 4, 0.1),
              (zeros, 0.1), (main, FRAC), (main, 1.0), (conv, FRAC),
              (conv, 0.01), (off, 0.1)]
    cases += [(special, frac) for frac in (0.01, 0.1, 0.5, 1.0, 1.5)]
    for x, frac in cases:
        if not torch.equal(tt.topk_mask_block_rows(x, frac),
                           ref.topk_mask_block_ref(x, frac)):
            raise AssertionError(f"topk_mask_block_rows != plain at "
                                 f"{tuple(x.shape)} frac={frac}")
    if not tt.topk_mask_block_rows(zeros, 0.1).all():
        raise AssertionError("all-zero rows must keep every entry (lo = 0)")
    nan_slice = tt.topk_mask_block_rows(special, 0.1)[0, :blk]
    if int(nan_slice.sum()) != blk - 1:
        raise AssertionError("a slice holding a NaN keeps every other entry")

    def lib_topk(x):
        rows, n = x.shape
        mag = torch.nn.functional.pad(x.abs(), (0, (-n) % blk)).view(-1, blk)
        kth = torch.topk(mag, ref.topk_k(blk, FRAC), dim=1).values[:, -1:]
        return (mag >= kth).view(rows, -1)[:, :n]

    def record(x):
        rows, n = x.shape
        slots = rows * -(-n // blk) * blk
        err = float((tt.topk_mask_block_rows(x, FRAC).float()
                     - ref.topk_mask_block_ref(x, FRAC).float()).abs().max())
        # bytes: x read once, the mask written once; operations: |x| and
        # its pattern, the max, the first digit's count and the mask's
        # compare over every (zero-padded) slot
        return _record(torch, "topk_mask_block",
                       "src/repro_torch/kernels/csrc/topk_block.cu",
                       "src/repro/kernels/topk_select.py:65",
                       lambda: tt.topk_mask_block_rows(x, FRAC),
                       lambda: ref.topk_mask_block_ref(x, FRAC),
                       lambda: lib_topk(x), nbytes=rows * n * 5,
                       ops=slots * 4, err=err)

    rec = record(main)
    r = record(conv)
    rec["at_conv_d_width"] = {
        "shape": [MAIN_ROWS, CONV_D_N], "k": ref.topk_k(blk, FRAC),
        **{key: r[key] for key in ("ms", "device_ms", "plain_ms", "bound_ms",
                                   "bound_by", "library_ms",
                                   "share_of_bound", "max_abs_err")}}
    del conv
    return rec, main, len(cases)


def _block_topk_path(torch, main) -> dict:
    """B5's entry point, ``ops.topk_mask(mode="block")``, on the main shape
    with the counts zeroed just before and read just after."""
    from repro_torch.kernels import ops, ref
    ops.reset_launch_counts()
    mask = ops.topk_mask(main, FRAC, mode="block")
    counts = ops.launch_counts()
    want = dict.fromkeys(counts, 0)
    want["topk_mask_block"] = 1
    if counts != want:
        raise AssertionError(f"ops.topk_mask(mode='block') launches {counts}"
                             f" != {want}")
    if not torch.equal(mask, ref.topk_mask_block_ref(main, FRAC)):
        raise AssertionError("ops.topk_mask(mode='block') != plain")
    return {"launches": counts["topk_mask_block"],
            "kept_frac": float(mask.float().mean())}


COHORT_C, COHORT_US, COHORT_WINDOWS = 8, (256, 32), (64, 32)


def _state_tensors(cstate) -> list:
    s = cstate.store
    return ([s.d_flat, s.opt_flat, s.residual, s.last_round, cstate.step]
            + [t for tree in (cstate.g, cstate.g_opt, cstate.server_d)
               for t in _np_leaves(tree)])


def _paper_pair():
    from repro_torch.core.gan import MLPGanConfig, make_mlp_pair
    return make_mlp_pair(MLPGanConfig(data_dim=784, z_dim=64, g_hidden=256,
                                      d_hidden=256))


def _cohort_phase(torch, dev):
    """Cohort-virtualized approach-1 federation at full MLP width: U logical
    users in a resident store on the card, a uniform cohort of C = 8 per
    round, topk_int8 uploads with error feedback, the staleness-aware fold.
    U = 256 and U = 32 with the fused-store engine, then U = 256 with the
    plain cohort engine, each over two windows; counts zeroed per window.
    Returns (per-run lines, launch totals, the U-independence ratio)."""
    import numpy as np

    from repro_torch.kernels import ops

    pair = _paper_pair()
    totals = dict.fromkeys(("topk_mask_rows", "quantize_rows",
                            "dequantize_rows"), 0)
    lines, finals = [], {}
    for U in COHORT_US:
        dataset = _digits_dataset(U, 28, 400)
        for fuse in (True, False) if U == COHORT_US[0] else (True,):
            sess = _session(pair, dataset, U, "topk_int8", False, dev,
                            eval_samples=0, scheduler="uniform",
                            cohort=COHORT_C, fuse=fuse, ef=True,
                            combiner="staleness_max_abs")
            results = []
            for rounds in COHORT_WINDOWS:
                ops.reset_launch_counts()
                res = sess.run(rounds)
                counts = ops.launch_counts()
                want = dict.fromkeys(counts, 0)
                want.update(dict.fromkeys(totals, rounds))
                if counts != want:
                    raise AssertionError(f"cohort U={U}: launches {counts} "
                                         f"!= {want}")
                for key in totals:
                    totals[key] += counts[key]
                if not (np.all(np.isfinite(res.g_losses))
                        and np.all(np.isfinite(res.d_losses))):
                    raise AssertionError(f"cohort U={U}: non-finite losses")
                if res.d_losses.shape != (rounds, COHORT_C) or \
                        res.extra["participation_counts"].sum() != \
                        rounds * COHORT_C:
                    raise AssertionError(f"cohort U={U}: loss shape or "
                                         f"participation counts")
                results.append(res)
            cstate = sess._driver.state
            last = np.zeros(U, np.int64)
            schedule = np.concatenate([r.extra["schedule"] for r in results])
            for r, row in enumerate(schedule):
                last[row] = r + 1
            if not np.array_equal(cstate.store.last_round.cpu().numpy(),
                                  last):
                raise AssertionError(f"cohort U={U}: last_round differs from"
                                     f" the schedule")
            if cstate.store.d_flat.device != torch.device(dev):
                raise AssertionError("the store left the card")
            store_gb = sum(t.numel() * t.element_size() for t in
                           _state_tensors(cstate)[:3]) / 1e9
            lines.append({
                "run": f"cohort approach1 U={U} C={COHORT_C} uniform "
                       f"topk_int8+EF staleness_max_abs "
                       f"{'fused_store' if fuse else 'plain'}",
                "rounds": list(COHORT_WINDOWS), "launches_per_round": 1,
                "steady_ms_per_round": [r.step_time_s * 1e3
                                        for r in results],
                "best_chunk_ms_per_round": [r.extra["min_step_time_s"] * 1e3
                                            for r in results],
                "first_chunk_s": [r.extra["compile_s"] for r in results],
                "store_gb": store_gb,
                "mean_age": float(np.mean(results[-1].extra["mean_age"])),
                "staleness_max": int(results[-1].extra["staleness"].max()),
                "upload_bytes_per_round":
                    results[-1].extra["upload_bytes_per_round"],
                "g_loss_first_last": [float(results[0].g_losses[0]),
                                      float(results[-1].g_losses[-1])]})
            if U == COHORT_US[0]:
                finals[fuse] = (cstate, np.concatenate(
                    [r.d_losses for r in results]))
            del sess, cstate, results
        del dataset
    (fused, fused_d), (plain, plain_d) = finals[True], finals[False]
    if not (np.array_equal(fused_d, plain_d) and all(
            torch.equal(a, b) for a, b in zip(_state_tensors(fused),
                                              _state_tensors(plain)))):
        raise AssertionError("fused-store and plain cohort engines differ")
    del finals, fused, plain
    torch.cuda.empty_cache()
    ms = {line["run"].split()[2]: line["steady_ms_per_round"][0]
          for line in lines if "fused_store" in line["run"]}
    return lines, totals, ms[f"U={COHORT_US[0]}"] / ms[f"U={COHORT_US[1]}"]


def _approaches_phase(torch, dev) -> list:
    """Approaches 2, 3 and the baseline at full MLP width, 16 + 16 rounds
    each with 8 users under full participation, then approach 2 under a
    uniform cohort of 4 of 16 users.  They upload nothing, so no kernel
    launches."""
    import numpy as np

    from repro_torch.kernels import ops

    pair, lines = _paper_pair(), []
    for approach, U, sched, C in (("approach2", 8, "full", None),
                                  ("approach3", 8, "full", None),
                                  ("baseline", 8, "full", None),
                                  ("approach2", 16, "uniform", 4)):
        sess = _session(pair, _digits_dataset(U, 28, 400), U, "none", False,
                        dev, rpj=8, approach=approach, scheduler=sched,
                        cohort=C)
        ops.reset_launch_counts()
        results = [sess.run(16), sess.run(16)]
        if any(ops.launch_counts().values()):
            raise AssertionError(f"{approach}: unexpected kernel launches "
                                 f"{ops.launch_counts()}")
        for res in results:
            if not (np.all(np.isfinite(res.g_losses))
                    and np.all(np.isfinite(res.d_losses))):
                raise AssertionError(f"{approach}: non-finite losses")
            if res.samples.shape != (256, 784) or \
                    not np.all(np.abs(res.samples) <= 1.0):
                raise AssertionError(f"{approach}: generator samples")
        lines.append({
            "run": f"{approach} U={U} {sched}" + (f" C={C}" if C else ""),
            "rounds": [16, 16],
            "steady_ms_per_round": [r.step_time_s * 1e3 for r in results],
            "first_chunk_s": [r.extra["compile_s"] for r in results],
            "g_loss_first_last": [float(results[0].g_losses[0]),
                                  float(results[-1].g_losses[-1])]})
    return lines


GRAPH_ROUNDS = 48


def _eager_twin(sess):
    """``sess`` with its engine swapped for the eager chunk it captures."""
    from repro_torch.core.engine import (make_eager_cohort_engine,
                                         make_eager_engine)
    drv, sp = sess._driver, sess.spec
    if drv.mode == "cohort":
        drv.eng = make_eager_cohort_engine(
            sess.pair, sess.fcfg, sp.approach,
            adaptive=sp.combine.adaptive_server_scale,
            copy_carry=not drv.fused_store)
    else:
        drv.eng = make_eager_engine(sess.pair, sess.fcfg, sp.approach)
    return sess


def _graph_phase(torch, dev) -> list:
    """Each main-path run, the cohort U = 256 run on both engines and
    approaches 2, 3 and the baseline from one seed, through the eager chunk
    (first) and through the graphs: the carries and losses must be equal
    BITWISE and the graph no slower per round; the peak device memory each
    run took.  Then, under graphs, windows of 5 + 6 rounds must equal one of
    11 (chunks of 4: graphs of 4, 1, 2 and 3 rounds)."""
    import numpy as np

    from repro_torch.core.engine import carry_tensors

    pair = _paper_pair()
    main_data = _digits_dataset(MAIN_ROWS, 28, 400)
    cohort_data = _digits_dataset(COHORT_US[0], 28, 400)
    runs = [(f"approach1 codec={c} stochastic={sr}",
             lambda dv, c=c, sr=sr: _session(pair, main_data, MAIN_ROWS, c, sr,
                                             dv, eval_samples=0))
            for c, sr in (("none", False), ("topk_int8", False),
                          ("topk_int8", True))]
    runs += [(f"cohort approach1 U={COHORT_US[0]} C={COHORT_C} topk_int8+EF "
              f"{'fused_store' if fuse else 'plain'}",
              lambda dv, fuse=fuse: _session(
                  pair, cohort_data, COHORT_US[0], "topk_int8", False, dv,
                  eval_samples=0, scheduler="uniform", cohort=COHORT_C,
                  fuse=fuse, ef=True, combiner="staleness_max_abs"))
             for fuse in (True, False)]
    runs += [(f"{a} U={MAIN_ROWS} full",
              lambda dv, a=a: _session(pair, main_data, MAIN_ROWS, "none",
                                       False, dv, rpj=8, eval_samples=0,
                                       approach=a))
             for a in ("approach2", "approach3", "baseline")]
    lines = []
    for name, make in runs:
        out = {}
        for kind in ("eager", "graph"):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            sess = make(dev)
            if kind == "eager":
                _eager_twin(sess)
            res = sess.run(GRAPH_ROUNDS)
            out[kind] = (sess, res, (torch.cuda.max_memory_allocated()
                                     - base) / 1e9)
        (es, er, epeak), (gs, gr, gpeak) = out["eager"], out["graph"]
        if not (np.array_equal(er.g_losses, gr.g_losses)
                and np.array_equal(er.d_losses, gr.d_losses)):
            raise AssertionError(f"{name}: graph losses != eager")
        ec, gc = es._driver.state, gs._driver.state
        if not (all(torch.equal(a, b) for a, b in zip(carry_tensors(ec),
                                                       carry_tensors(gc)))
                and torch.equal(ec.generator.get_state(),
                                gc.generator.get_state())):
            raise AssertionError(f"{name}: graph state != eager, bitwise")
        if not np.all(np.isfinite(gr.g_losses)):
            raise AssertionError(f"{name}: non-finite losses")
        ems, gms = er.step_time_s * 1e3, gr.step_time_s * 1e3
        if gms > ems:
            raise AssertionError(f"{name}: graph {gms:.3f} ms per round is "
                                 f"slower than eager {ems:.3f}")
        lines.append({
            "run": name, "rounds": GRAPH_ROUNDS,
            "rounds_per_chunk": gs.spec.engine.rounds_per_jit,
            "bitwise": True, "eager_ms_per_round": ems,
            "graph_ms_per_round": gms, "speedup": ems / gms,
            "eager_best_chunk_ms_per_round":
                er.extra["min_step_time_s"] * 1e3,
            "graph_best_chunk_ms_per_round":
                gr.extra["min_step_time_s"] * 1e3,
            "eager_first_chunk_s": er.extra["compile_s"],
            "graph_first_chunk_s": gr.extra["compile_s"],
            "eager_peak_gb": epeak, "graph_peak_gb": gpeak})
        del out, es, gs, er, gr, ec, gc
        torch.cuda.empty_cache()

    whole = _session(pair, main_data, MAIN_ROWS, "topk_int8", True, dev,
                     rpj=4, eval_samples=0)
    parts = _session(pair, main_data, MAIN_ROWS, "topk_int8", True, dev,
                     rpj=4, eval_samples=0)
    w = whole.run(11)
    p1 = parts.run(5).g_losses.copy()
    p2 = parts.run(6).g_losses
    if sorted(parts._driver.eng.graphs.graphs) != [1, 2, 4] or not (
            np.array_equal(np.concatenate([p1, p2]), w.g_losses)
            and all(torch.equal(a, b) for a, b in zip(
                carry_tensors(whole._driver.state),
                carry_tensors(parts._driver.state)))):
        raise AssertionError("windows of 5 + 6 rounds != one of 11 under "
                             "graphs")
    lines.append({"run": "approach1 topk_int8 SR, windows 5 + 6 vs 11, "
                         "chunks of 4", "bitwise": True,
                  "graph_lengths": sorted(whole._driver.eng.graphs.graphs)})
    return lines


def _cohort_cpu_agreement(torch, dev) -> dict:
    """A small cohort session (U 6, C 3, topk_int8 with stochastic rounding
    and error feedback) from one seed on the card (kernels) and on the CPU
    (plain versions), at ``_cpu_agreement``'s tolerances; the schedule and
    ``last_round`` bitwise."""
    import numpy as np

    from repro_torch.convert import state_to_numpy
    from repro_torch.core.gan import MLPGanConfig, make_mlp_pair
    from repro_torch.kernels import ops

    pair = make_mlp_pair(MLPGanConfig(data_dim=64, z_dim=16, g_hidden=32,
                                      d_hidden=32))
    dataset = _digits_dataset(6, 8, 60)
    kw = dict(batch=16, rpj=4, eval_samples=0, scheduler="uniform", cohort=3,
              fuse=True, ef=True, combiner="staleness_max_abs")
    ops.reset_launch_counts()
    sa = _session(pair, dataset, 6, "topk_int8", True, dev, **kw)
    a = sa.run(6)
    counts = ops.launch_counts()
    if (counts["topk_mask_rows"], counts["quantize_rows"],
            counts["dequantize_rows"]) != (6, 6, 6):
        raise AssertionError(f"card cohort session launches {counts}")
    sb = _session(pair, dataset, 6, "topk_int8", True, "cpu", **kw)
    b = sb.run(6)
    np.testing.assert_array_equal(a.extra["schedule"], b.extra["schedule"])
    np.testing.assert_allclose(a.g_losses, b.g_losses, atol=1e-3)
    xa, xb = state_to_numpy(a.state), state_to_numpy(b.state)
    pairs = [(x, y) for key in xa
             for x, y in zip(_np_leaves(xa[key]), _np_leaves(xb[key]))]
    ca, cb = sa._driver.state.store, sb._driver.state.store
    np.testing.assert_array_equal(ca.last_round.cpu().numpy(),
                                  cb.last_round.numpy())
    pairs.append((ca.residual.cpu().numpy(), cb.residual.numpy()))
    diffs = []
    for x, y in pairs:
        np.testing.assert_allclose(x, y, atol=2e-3, rtol=1e-3)
        diffs.append(float(np.max(np.abs(np.asarray(x, np.float64) - y))))
    return {"cohort_topk_int8_sr_ef": max(diffs)}


# ---------------------------------------------------------------------------
# Host streaming
# ---------------------------------------------------------------------------

HOST_C, HOST_US, HOST_ROUNDS, HOST_K = 8, (256, 1024), 64, 16
# (a) synchronous stream, (b) without data prefetch, (c) one round in
# flight (bounded staleness), (d) superbatch windows of HOST_K rounds,
# (e) int8 row staging
HOST_MODES = {"a_sync": {}, "b_no_prefetch": dict(prefetch=False),
              "c_async1": dict(async_rounds=1),
              "d_superbatch": dict(fuse=True),
              "e_stage_rows": dict(stage_rows=True)}
# the host stream against the device cohort engine, and the superbatch
# against the stream: per round and on the final store
HOST_ATOL = 1e-6


def _max_diff(torch, a, b) -> float:
    """max |a - b| in f32 on the card (either may be a host array)."""
    dev = torch.device("cuda")
    return float((torch.as_tensor(a).to(dev)
                  - torch.as_tensor(b).to(dev)).abs().max())


def _host_session(torch, pair, dataset, U, dev, mode_kw):
    from repro_torch.core.spec import BackendSpec
    backend = BackendSpec("host", async_rounds=mode_kw.get("async_rounds", 0),
                          prefetch=mode_kw.get("prefetch", True),
                          materialize_state=False)
    return _session(pair, dataset, U, "topk_int8", False, dev,
                    eval_samples=0, scheduler="uniform", cohort=HOST_C,
                    ef=True, rpj=HOST_K, fuse=mode_kw.get("fuse", False),
                    backend=backend,
                    stage_rows=mode_kw.get("stage_rows", False))


def _host_phase(torch, dev):
    """The host streaming backend at the paper's MLP width: approach 1,
    topk_int8 with error feedback, a uniform cohort of 8 of U = 256 and U =
    1024 users whose (U, N) store (D, Adam moments, residual) lives in
    pinned host memory, batch 64, 64 rounds in each mode of HOST_MODES.
    Launch counts zeroed per run: one top-k, quantize and dequantize per
    round in the graph, one more quantize and dequantize per round on the
    int8 row legs.  (a) and (b) held to the device cohort engine on the
    same schedule and (d) to (a), per round and on the final store, within
    HOST_ATOL, ages and staleness bitwise; (c) ages by its lag.  Peak
    device memory (above what was allocated before the run) must not grow
    with U.  Returns (lines, launch totals, summary)."""
    import gc

    import numpy as np

    from repro_torch.kernels import ops

    pair = _paper_pair()
    totals = dict.fromkeys(("topk_mask_rows", "quantize_rows",
                            "dequantize_rows"), 0)
    lines, summary = [], {"ms_per_round": {}, "stall_ms_per_round": {},
                          "peak_device_gb": {}, "pinned_host_gb": {},
                          "vs_device_cohort_max_abs": {},
                          "superbatch_vs_sync_max_abs": {}}
    for U in HOST_US:
        dataset = _digits_dataset(U, 28, 400)
        kept = {}
        for mode, kw in HOST_MODES.items():
            sess = _host_session(torch, pair, dataset, U, dev, kw)
            gc.collect()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            res = sess.run(HOST_ROUNDS)
            torch.cuda.synchronize()
            peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
            counts = ops.launch_counts()
            legs = HOST_ROUNDS if kw.get("stage_rows") else 0
            want = dict.fromkeys(counts, 0)
            want.update(topk_mask_rows=HOST_ROUNDS,
                        quantize_rows=HOST_ROUNDS + legs,
                        dequantize_rows=HOST_ROUNDS + legs)
            if counts != want:
                raise AssertionError(f"host {mode} U={U}: launches {counts} "
                                     f"!= {want}")
            for key in totals:
                totals[key] += counts[key]
            be = res.extra["host_backend"]
            if not (np.all(np.isfinite(res.g_losses))
                    and np.all(np.isfinite(res.d_losses))
                    and res.d_losses.shape == (HOST_ROUNDS, HOST_C)):
                raise AssertionError(f"host {mode} U={U}: losses")
            if res.state is not None or not be.pinned or \
                    res.extra["fused_store"] != kw.get("fuse", False):
                raise AssertionError(f"host {mode} U={U}: state, pinning or "
                                     f"fused_store")
            last = np.zeros(U, np.int64)
            for r, row in enumerate(res.extra["schedule"]):
                last[row] = r + 1
            if not np.array_equal(be.last_round.numpy(), last):
                raise AssertionError(f"host {mode} U={U}: last_round")
            ages = res.extra["mean_age"]
            if mode == "c_async1" and not np.all(ages[1:] >= 0):
                raise AssertionError("async ages")
            key = f"{mode} U={U}"
            summary["ms_per_round"][key] = res.extra["min_step_time_s"] * 1e3
            summary["stall_ms_per_round"][key] = \
                res.extra["host_stall_s_per_round"] * 1e3
            summary["peak_device_gb"][key] = peak_gb
            summary["pinned_host_gb"][key] = be.nbytes / 1e9
            lines.append({
                "run": f"host approach1 U={U} C={HOST_C} uniform topk_int8+EF"
                       f" {mode}", "rounds": HOST_ROUNDS, "launches": counts,
                "best_ms_per_round": res.extra["min_step_time_s"] * 1e3,
                "steady_ms_per_round": res.step_time_s * 1e3,
                "host_stall_ms_per_round":
                    res.extra["host_stall_s_per_round"] * 1e3,
                "first_round_s": res.extra["compile_s"],
                "pinned_host_gb": be.nbytes / 1e9,
                "peak_device_gb": peak_gb,
                "mean_age_last": float(ages[-1]),
                "g_loss_first_last": [float(res.g_losses[0]),
                                      float(res.g_losses[-1])]})
            if mode in ("a_sync", "b_no_prefetch", "d_superbatch"):
                kept[mode] = (res, be)
            if mode == "d_superbatch":
                a, a_be = kept["a_sync"]
                diff = max(_max_diff(torch, res.g_losses, a.g_losses),
                           _max_diff(torch, res.d_losses, a.d_losses),
                           _max_diff(torch, be.d_flat, a_be.d_flat),
                           _max_diff(torch, be.residual, a_be.residual))
                summary["superbatch_vs_sync_max_abs"][f"U={U}"] = diff
                if diff > HOST_ATOL or not (
                        np.array_equal(res.extra["mean_age"],
                                       a.extra["mean_age"])
                        and np.array_equal(res.extra["staleness"],
                                           a.extra["staleness"])):
                    raise AssertionError(f"superbatch != sync stream at "
                                         f"U={U} (max |diff| {diff})")
                del kept["d_superbatch"]
            del sess, res, be
        # the device cohort engine on the same schedule, after the host
        # runs so its (U, N) store is not in their peak
        gc.collect()
        dsess = _session(pair, dataset, U, "topk_int8", False, dev,
                         eval_samples=0, scheduler="uniform", cohort=HOST_C,
                         ef=True, rpj=HOST_K, fuse=True)
        want_res = dsess.run(HOST_ROUNDS)
        store = dsess._driver.state.store
        for mode, (res, be) in kept.items():
            if not (np.array_equal(res.extra["schedule"],
                                   want_res.extra["schedule"])
                    and np.array_equal(res.extra["mean_age"],
                                       want_res.extra["mean_age"])
                    and np.array_equal(be.last_round.numpy(),
                                       store.last_round.cpu().numpy())):
                raise AssertionError(f"host {mode} U={U}: schedule or ages "
                                     f"differ from the device cohort engine")
            diff = max(_max_diff(torch, res.g_losses, want_res.g_losses),
                       _max_diff(torch, res.d_losses, want_res.d_losses),
                       *(_max_diff(torch, getattr(be, n), getattr(store, n))
                         for n in ("d_flat", "opt_flat", "residual")))
            summary["vs_device_cohort_max_abs"][f"{mode} U={U}"] = diff
            if diff > HOST_ATOL:
                raise AssertionError(f"host {mode} U={U} differs from the "
                                     f"device cohort engine by {diff}")
        del dsess, want_res, store, kept, dataset
        gc.collect()
        torch.cuda.empty_cache()
    lo, hi = HOST_US
    for mode in HOST_MODES:
        p_lo = summary["peak_device_gb"][f"{mode} U={lo}"]
        p_hi = summary["peak_device_gb"][f"{mode} U={hi}"]
        if p_hi > 1.05 * p_lo + 0.064:
            raise AssertionError(f"host {mode}: peak device memory grew with "
                                 f"U ({p_lo:.3f} -> {p_hi:.3f} GB)")
    ms = summary["ms_per_round"]
    stall = summary["stall_ms_per_round"]
    summary["u_ratio_ms_per_round"] = {
        mode: ms[f"{mode} U={hi}"] / ms[f"{mode} U={lo}"]
        for mode in HOST_MODES}
    summary["stall_ratio_async_over_no_prefetch"] = {
        f"U={u}": stall[f"c_async1 U={u}"] / stall[f"b_no_prefetch U={u}"]
        for u in HOST_US}
    return lines, totals, summary


def _host_cpu_agreement(torch, dev) -> dict:
    """A small host-backend session (U 6, C 3, topk_int8 with stochastic
    rounding and error feedback), synchronous and with int8 row staging,
    from one seed on the card (kernels) and on the CPU (plain versions), at
    ``_cpu_agreement``'s tolerances; the schedule and ``last_round``
    bitwise.  With int8 row staging the stored D rows are int8 codes times
    a row scale: where the card and the CPU round a value an ULP apart
    across a code boundary, a code flips by one, so the D rows are held to
    one code step (the row's absmax / 127) more."""
    import numpy as np

    from repro_torch.core.gan import MLPGanConfig, make_mlp_pair
    from repro_torch.core.spec import BackendSpec
    from repro_torch.kernels import ops

    pair = make_mlp_pair(MLPGanConfig(data_dim=64, z_dim=16, g_hidden=32,
                                      d_hidden=32))
    dataset = _digits_dataset(6, 8, 60)
    worst = {}
    for stage in (False, True):
        kw = dict(batch=16, rpj=4, eval_samples=0, scheduler="uniform",
                  cohort=3, ef=True, combiner="staleness_max_abs",
                  backend=BackendSpec("host"), stage_rows=stage)
        codec = "int8" if stage else "topk_int8"
        ops.reset_launch_counts()
        a = _session(pair, dataset, 6, codec, True, dev, **kw).run(6)
        if ops.launch_counts()["dequantize_rows"] != (12 if stage else 6):
            raise AssertionError(f"card host session launches "
                                 f"{ops.launch_counts()}")
        b = _session(pair, dataset, 6, codec, True, "cpu", **kw).run(6)
        np.testing.assert_array_equal(a.extra["schedule"], b.extra["schedule"])
        np.testing.assert_allclose(a.g_losses, b.g_losses, atol=1e-3)
        ba, bb = a.extra["host_backend"], b.extra["host_backend"]
        np.testing.assert_array_equal(ba.last_round.numpy(),
                                      bb.last_round.numpy())
        diffs = []
        for name in ("d_flat", "opt_flat", "residual"):
            x, y = getattr(ba, name).numpy(), getattr(bb, name).numpy()
            step = (np.abs(y).max(axis=1, keepdims=True) / 127
                    if stage and name == "d_flat" else 0.0)
            if np.any(np.abs(x - y) > 2e-3 + 1e-3 * np.abs(y) + step):
                raise AssertionError(f"host {codec} stage_rows={stage}: "
                                     f"{name} card vs CPU beyond tolerance")
            diffs.append(float(np.max(np.abs(x.astype(np.float64) - y))))
        worst[f"host_{codec}_sr_ef{'_stage_rows' if stage else ''}"] = \
            max(diffs)
    return worst


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _same_arrays(torch, a: list, b: list) -> bool:
    """Two lists of checkpoint leaves equal bitwise (shapes, types,
    values; wherever they live)."""
    return len(a) == len(b) and all(
        x.shape == y.shape and x.dtype == y.dtype
        and torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))


def _dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.iterdir() if f.is_file())


def _main_ckpt_session(dev, pair=None, dataset=None):
    """The main path as the checkpoint phase runs it (and the resumed
    process rebuilds it): approach 1, topk_int8 with stochastic rounding,
    chunks of 16, no samples."""
    pair = pair or _paper_pair()
    dataset = dataset or _digits_dataset(MAIN_ROWS, 28, 400)
    return _session(pair, dataset, MAIN_ROWS, "topk_int8", True, dev,
                    eval_samples=0), pair, dataset


def _resume_main(ckpt: str, out: str) -> int:
    """``--resume-main CKPT OUT``: restore the main path from CKPT in this
    (fresh) process on the card, run 16 rounds, save into OUT with the
    window's losses; print the wall seconds as one JSON line."""
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch

    from repro_torch.core.session import FederationSession
    if not torch.cuda.is_available():
        return _fail("no CUDA device (torch.cuda.is_available() is False)")
    t0 = time.perf_counter()
    sess = FederationSession.restore(ckpt, _paper_pair(), _fcfg(MAIN_ROWS),
                                     _digits_dataset(MAIN_ROWS, 28, 400))
    restore_s = time.perf_counter() - t0
    res = sess.run(16)
    sess.save(out)
    np.savez(Path(out) / "losses.npz", g=res.g_losses, d=res.d_losses)
    print(json.dumps({"restore_s": restore_s, "round": sess.round}))
    return 0


def _checkpoint_phase(torch, dev) -> list:
    """Save / restore / autosave against uninterrupted runs, bitwise."""
    import numpy as np

    from repro_torch.checkpoint import latest_step, read_leaves, tree_flatten
    from repro_torch.core.session import FederationSession

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    lines = []
    whole, pair, data = _main_ckpt_session(dev)
    want = whole.run(32)
    want_arrays = tree_flatten(whole._driver.arrays())

    first = _main_ckpt_session(dev, pair, data)[0]
    got1 = first.run(16)
    t0 = time.perf_counter()
    first.save(str(CKPT_DIR / "main"))
    save_s = time.perf_counter() - t0
    out = CKPT_DIR / "main_resumed"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--resume-main",
         str(CKPT_DIR / "main"), str(out)], capture_output=True, text=True,
        timeout=400, cwd=ROOT)
    child_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"resume process failed: {proc.stderr[-3000:]}")
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    losses = np.load(out / "losses.npz")
    if not (np.array_equal(np.concatenate([got1.g_losses, losses["g"]]),
                           want.g_losses)
            and np.array_equal(np.concatenate([got1.d_losses, losses["d"]]),
                               want.d_losses)
            and _same_arrays(torch, read_leaves(str(out), 32), want_arrays)):
        raise AssertionError("main path: save at 16, restore in a fresh "
                             "process, 16 more != 32 uninterrupted")
    lines.append({"run": "main path approach1 topk_int8 SR, save at 16, "
                         "restore in a fresh process, 16 more",
                  "bitwise": True, "leaves": len(want_arrays),
                  "save_s": save_s, "restore_s": child["restore_s"],
                  "resume_process_s": child_s,
                  "checkpoint_bytes": _dir_bytes(CKPT_DIR / "main")})

    auto = _main_ckpt_session(dev, pair, data)[0]
    t0 = time.perf_counter()
    res = auto.run(32, autosave_every=8, autosave_path=str(CKPT_DIR / "auto"))
    auto_s = time.perf_counter() - t0
    steps = sorted(int(f.name[5:13]) for f in (CKPT_DIR / "auto").iterdir()
                   if f.suffix == ".msgpack")
    if not (steps == [8, 16, 24, 32]
            and latest_step(str(CKPT_DIR / "auto")) == 32
            and np.array_equal(res.g_losses, want.g_losses)
            and _same_arrays(torch, read_leaves(str(CKPT_DIR / "auto"), 16),
                             read_leaves(str(CKPT_DIR / "main"), 16))
            and _same_arrays(torch, read_leaves(str(CKPT_DIR / "auto"), 32),
                             want_arrays)):
        raise AssertionError("autosaves do not hold the uninterrupted "
                             "trajectory")
    lines.append({"run": "main path, run(32, autosave_every=8)",
                  "autosaves": steps, "bitwise": True, "wall_s": auto_s,
                  "plain_wall_s": want.wall_time_s})
    del whole, first, auto
    shutil.rmtree(CKPT_DIR / "auto")

    U = COHORT_US[0]
    cdata = _digits_dataset(U, 28, 400)

    def cohort():
        return _session(pair, cdata, U, "topk_int8", True, dev,
                        eval_samples=0, scheduler="uniform", cohort=COHORT_C,
                        fuse=True, ef=True, combiner="staleness_max_abs")

    whole = cohort()
    want = whole.run(32)
    want_arrays = tree_flatten(whole._driver.arrays())
    del whole
    part = cohort()
    got1 = part.run(16)
    t0 = time.perf_counter()
    part.save(str(CKPT_DIR / "cohort"))
    save_s = time.perf_counter() - t0
    del part
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    restored = FederationSession.restore(str(CKPT_DIR / "cohort"), pair,
                                         _fcfg(U), cdata)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    got2 = restored.run(16)
    if not (np.array_equal(np.concatenate([got1.g_losses, got2.g_losses]),
                           want.g_losses)
            and np.array_equal(np.concatenate([got1.d_losses,
                                               got2.d_losses]),
                               want.d_losses)
            and _same_arrays(torch, tree_flatten(restored._driver.arrays()),
                             want_arrays)):
        raise AssertionError("cohort fused store: save at 16, restore, 16 "
                             "more != 32 uninterrupted")
    lines.append({"run": f"cohort U={U} C={COHORT_C} topk_int8+EF+SR fused "
                         f"store, save at 16, restore in process, 16 more",
                  "bitwise": True, "leaves": len(want_arrays),
                  "save_s": save_s, "restore_s": restore_s,
                  "checkpoint_bytes": _dir_bytes(CKPT_DIR / "cohort")})
    del restored, want_arrays
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return lines


# ---------------------------------------------------------------------------
# The DCGAN pair, W-GAN
# ---------------------------------------------------------------------------

def _image_dataset(num_users: int, size: int, channels: int, per_class: int):
    """Digit-like images at ``size`` x ``size``, tiled to ``channels``, NHWC,
    Dirichlet(0.5)-split over ``num_users``."""
    import numpy as np

    from repro_torch.data import digits_like_mixture, dirichlet_partition
    rng = np.random.default_rng(0)
    data, labels = [], []
    for c in range(10):
        _, sample = digits_like_mixture([c], size=size)
        data.append(sample(rng, per_class))
        labels.append(np.full(per_class, c))
    data = np.repeat(np.concatenate(data)[..., None], channels, axis=-1)
    return dirichlet_partition(data, np.concatenate(labels), num_users,
                               alpha=0.5, seed=0)


def _conv_width_kernels(torch, dev, recs) -> int:
    """B1 and B2 on 8 rows of the paper-width conv D (675,584, beyond B1's
    shared memory), held BITWISE to their plain versions and timed; the
    times go into each record under ``at_conv_d_width``."""
    return _kernels_at(torch, dev, recs, MAIN_ROWS, CONV_D_N, 4,
                       "at_conv_d_width")


def _kernels_at(torch, dev, recs, rows: int, n: int, seed: int,
                key: str) -> int:
    """B1 and B2 on (rows, n) Adam-sized deltas (one row of heavy ties,
    one half sparse where there are enough rows), held BITWISE to their
    plain versions and timed; the times go into each record under
    ``key``.  Returns the number of cases."""
    from repro_torch.kernels import quantize as tq
    from repro_torch.kernels import ref
    from repro_torch.kernels import topk_select as tt

    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((rows, n), generator=gen, device=dev) * 2e-4
    if rows > 5:
        x[1] = torch.round(x[1] * 2e4) / 2e4             # heavy ties
        x[5, : n // 2] = 0.0                             # half-sparse row
    cases = 0
    for frac in (FRAC, 0.01, 1.0):
        cases += 1
        if not torch.equal(tt.topk_mask_rows(x, frac),
                           ref.topk_mask_global_ref(x, frac)):
            raise AssertionError(f"topk_mask_rows != plain at {rows} x {n}"
                                 f" frac={frac}")
    for stochastic, seed in ((False, None), (True, 123), (True, 2**31 - 2)):
        cases += 1
        q, s = tq.quantize_rows(x, stochastic=stochastic, seed=seed)
        qr, sr = ref.quantize_rows_ref(x, stochastic=stochastic, seed=seed)
        if not (torch.equal(q, qr) and torch.equal(s, sr) and torch.equal(
                tq.dequantize_rows(q, s), ref.dequantize_rows_ref(qr, sr))):
            raise AssertionError(f"codec != plain at {rows} x {n}")
    k = ref.topk_k(n, FRAC)
    elems = rows * n
    q, s = tq.quantize_rows(x)

    def lib_topk():
        kth = torch.topk(torch.abs(x), k, dim=1).values[:, -1:]
        return torch.abs(x) >= kth

    timed = {
        "topk_mask_rows": (lambda: tt.topk_mask_rows(x, FRAC),
                           lambda: ref.topk_mask_global_ref(x, FRAC),
                           lib_topk, elems * 5, elems),
        "quantize_rows": (lambda: tq.quantize_rows(x),
                          lambda: ref.quantize_rows_ref(x), None,
                          elems * 5 + rows * 4, elems * 3),
        "quantize_rows_stochastic": (
            lambda: tq.quantize_rows(x, stochastic=True, seed=123),
            lambda: ref.quantize_rows_ref(x, stochastic=True, seed=123),
            None, elems * 5 + rows * 4, elems * 6),
        "dequantize_rows": (lambda: tq.dequantize_rows(q, s),
                            lambda: ref.dequantize_rows_ref(q, s), None,
                            elems * 5 + rows * 4, elems)}
    for rec in recs:
        if rec["name"] in timed:
            kern, plain, lib, nbytes, ops = timed[rec["name"]]
            r = _record(torch, rec["name"], rec["source"], rec["replaces"],
                        kern, plain, lib, nbytes=nbytes, ops=ops, err=0.0)
            rec[key] = {
                "shape": [rows, n], "k": k,
                **{key: r[key] for key in ("ms", "device_ms", "plain_ms",
                                           "bound_ms", "bound_by",
                                           "library_ms", "share_of_bound")}}
    del x, q, s
    return cases


def _conv_full_phase(torch, dev):
    """(a): the DCGAN pair at full width, eager chunk then graphs, 32 rounds
    each from one seed; returns (line, launch totals of the graph run)."""
    import numpy as np

    from repro_torch.core import engine as teng
    from repro_torch.core.gan import ConvGanConfig, make_conv_pair
    from repro_torch.kernels import ops
    from repro_torch.models.common import tree_leaves

    pair = make_conv_pair(ConvGanConfig(**CONV_FULL))
    g, d = (sum(math.prod(t.shape) for t in tree_leaves(tree))
            for tree in (pair.g_decls, pair.d_decls))
    if (g, d) != (CONV_G_N, CONV_D_N):
        raise AssertionError(f"conv pair parameters G {g}, D {d}")
    data = _image_dataset(MAIN_ROWS, CONV_FULL["image_size"],
                          CONV_FULL["channels"], 200)

    def make(dv):
        return _session(pair, data, MAIN_ROWS, "topk_int8", False, dv,
                        eval_samples=64, scheduler="full", cohort=MAIN_ROWS,
                        fuse=True, ef=True)

    out = {}
    for kind in ("eager", "graph"):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        sess = make(dev)
        if kind == "eager":
            _eager_twin(sess)
        ops.reset_launch_counts()
        res = sess.run(CONV_ROUNDS)
        counts = ops.launch_counts()
        want = dict.fromkeys(counts, 0)
        want.update(topk_mask_rows=CONV_ROUNDS, quantize_rows=CONV_ROUNDS,
                    dequantize_rows=CONV_ROUNDS)
        if counts != want:
            raise AssertionError(f"conv {kind}: launches {counts} != {want}")
        out[kind] = (sess, res, counts, (torch.cuda.max_memory_allocated()
                                         - base) / 1e9)
    (es, er, _, epeak), (gs, gr, counts, gpeak) = out["eager"], out["graph"]
    differ = [name for name, same in (
        ("g_losses", np.array_equal(er.g_losses, gr.g_losses)),
        ("d_losses", np.array_equal(er.d_losses, gr.d_losses)),
        ("samples", np.array_equal(er.samples, gr.samples))) if not same]
    differ += [f"carry tensor {i}" for i, (a, b) in enumerate(zip(
        teng.carry_tensors(es._driver.state),
        teng.carry_tensors(gs._driver.state))) if not torch.equal(a, b)]
    if differ:
        raise AssertionError(f"conv pair: graph != eager chunk, bitwise: "
                             f"{differ}")
    if not (np.all(np.isfinite(gr.g_losses))
            and np.all(np.isfinite(gr.d_losses))):
        raise AssertionError("conv pair: non-finite losses")
    size, ch = CONV_FULL["image_size"], CONV_FULL["channels"]
    if gr.samples.shape != (64, size, size, ch) or \
            not np.all(np.abs(gr.samples) <= 1.0):
        raise AssertionError("conv pair: generator samples")
    line = {"run": f"conv approach1 {size}x{size}x{ch} "
                   f"f{CONV_FULL['base_filters']} z{CONV_FULL['z_dim']} "
                   f"U={MAIN_ROWS} B=64 topk_int8+EF",
            "rounds": CONV_ROUNDS, "bitwise": True, "launches": counts,
            "eager_ms_per_round": er.step_time_s * 1e3,
            "graph_ms_per_round": gr.step_time_s * 1e3,
            "eager_first_chunk_s": er.extra["compile_s"],
            "graph_first_chunk_s": gr.extra["compile_s"],
            "eager_peak_gb": epeak, "graph_peak_gb": gpeak,
            "g_loss_first_last": [float(gr.g_losses[0]),
                                  float(gr.g_losses[-1])],
            "kept_frac": gr.extra["kept_frac"]}
    del out, es, gs, er, gr
    torch.cuda.empty_cache()
    line["eager_ms_per_round_cudnn"] = _cudnn_cost(torch, make, dev)
    return line, counts


def _cudnn_cost(torch, make, dev) -> dict:
    """Steady ms per round of the conv pair's eager chunk with the engines'
    deterministic cuDNN and with cuDNN's defaults (deterministic off, no
    autotuning), in turns: what determinism costs."""
    import contextlib

    from repro_torch.core import engine as teng
    saved = teng.deterministic_convolutions
    times = {"deterministic": [], "default": []}
    try:
        for kind in ("deterministic", "default", "deterministic", "default"):
            teng.deterministic_convolutions = (
                saved if kind == "deterministic" else contextlib.nullcontext)
            res = _eager_twin(make(dev)).run(CONV_ROUNDS)
            times[kind].append(res.step_time_s * 1e3)
            del res
    finally:
        teng.deterministic_convolutions = saved
    return times


def _conv_paper_phase(torch, dev) -> dict:
    """(b): the repo's Tables 3-4 run, 32 x 32 x 1, 2 users (digits 0-4 /
    5-9), approach 3, batch 32, 64 rounds: finite losses, coverage printed
    (not asserted)."""
    import numpy as np

    from repro_torch.core.gan import ConvGanConfig, make_conv_pair
    from repro_torch.data import (FederatedDataset, digits_like_mixture,
                                  template_coverage)
    t1, s1 = digits_like_mixture([0, 1, 2, 3, 4], size=32)
    t2, s2 = digits_like_mixture([5, 6, 7, 8, 9], size=32)
    templates = np.concatenate([t1, t2])

    def union(rng, n):
        h = n // 2
        return np.concatenate([s1(rng, h), s2(rng, n - h)])[..., None]

    ds = FederatedDataset([lambda r, n: s1(r, n)[..., None],
                           lambda r, n: s2(r, n)[..., None]], union, {})
    pair = make_conv_pair(ConvGanConfig(image_size=32, channels=1, z_dim=64,
                                        base_filters=32))
    res = _session(pair, ds, 2, "none", False, dev, batch=32, rpj=16,
                   approach="approach3").run(64)
    if not (np.all(np.isfinite(res.g_losses))
            and np.all(np.isfinite(res.d_losses))):
        raise AssertionError("Tables 3-4 conv run: non-finite losses")
    cov, _ = template_coverage(res.samples[..., 0], templates, thresh=0.35)
    return {"run": "conv approach3 32x32x1 f32 z64 U=2 B=32 (Tables 3-4)",
            "rounds": 64, "template_coverage": cov,
            "steady_ms_per_round": res.step_time_s * 1e3,
            "first_chunk_s": res.extra["compile_s"],
            "g_loss_first_last": [float(res.g_losses[0]),
                                  float(res.g_losses[-1])]}


def _wgan_phase(torch, dev) -> dict:
    """(c): W-GAN approach 3 on the paper MLP, 32 rounds: finite losses,
    every critic weight within +-wgan_clip."""
    import numpy as np

    from repro_torch.core.approaches import DistGANConfig
    from repro_torch.models.common import tree_leaves
    fcfg = DistGANConfig(num_users=MAIN_ROWS, loss_type="wgan", d_lr=5e-4,
                         g_lr=1e-4, b1=0.0)
    res = _session(_paper_pair(), _digits_dataset(MAIN_ROWS, 28, 400),
                   MAIN_ROWS, "none", False, dev, rpj=8, approach="approach3",
                   fcfg=fcfg).run(32)
    clip = max(float(t.abs().max()) for t in tree_leaves(res.state.ds))
    if not (np.all(np.isfinite(res.g_losses))
            and np.all(np.isfinite(res.d_losses))):
        raise AssertionError("W-GAN: non-finite losses")
    if clip > np.float32(fcfg.wgan_clip):
        raise AssertionError(f"W-GAN critic weight {clip} beyond the clip")
    return {"run": f"wgan approach3 paper MLP U={MAIN_ROWS}", "rounds": 32,
            "max_abs_critic_weight": clip, "wgan_clip": fcfg.wgan_clip,
            "steady_ms_per_round": res.step_time_s * 1e3,
            "g_loss_first_last": [float(res.g_losses[0]),
                                  float(res.g_losses[-1])]}


def _conv_cpu_agreement(torch, dev) -> dict:
    """One round of the full-width conv run at U = 2 from one seed on the
    card (kernels, cuDNN) and on the CPU (plain versions): losses within
    CONV_LOSS_RTOL, every state leaf within CONV_LEAF_REL of its largest
    entry plus CONV_LEAF_LR_STEPS steps of lr, the round-noise generators
    equal.  Returns the worst absolute diff, the worst diff beyond the lr
    steps relative to its leaf's largest entry, and how many elements
    exceed the main path's card-vs-CPU bound (atol 2e-3, rtol 1e-3)."""
    import numpy as np

    from repro_torch.checkpoint import tree_flatten
    from repro_torch.core.gan import ConvGanConfig, make_conv_pair
    from repro_torch.kernels import ops

    pair = make_conv_pair(ConvGanConfig(**CONV_FULL))
    data = _image_dataset(2, CONV_FULL["image_size"], CONV_FULL["channels"],
                          40)
    runs = []
    for dv in (dev, "cpu"):
        sess = _session(pair, data, 2, "topk_int8", False, dv, rpj=1,
                        eval_samples=0, scheduler="full", cohort=2,
                        fuse=True, ef=True)
        ops.reset_launch_counts()
        res = sess.run(1)
        runs.append((res, tree_flatten(sess._driver.arrays()),
                     ops.launch_counts()["topk_mask_rows"]))
    (ra, xa, na), (rb, xb, nb) = runs
    if (na, nb) != (1, 0):
        raise AssertionError(f"conv card-vs-CPU: top-k launches {na}, {nb}")
    np.testing.assert_allclose(ra.g_losses, rb.g_losses, rtol=CONV_LOSS_RTOL)
    np.testing.assert_allclose(ra.d_losses, rb.d_losses, rtol=CONV_LOSS_RTOL)
    if not torch.equal(xa[-1], xb[-1]):
        raise AssertionError("conv card-vs-CPU: generator states differ")
    lr = _fcfg(2).d_lr
    worst, worst_rel, beyond = 0.0, 0.0, 0
    steps = CONV_LEAF_LR_STEPS * lr
    for i, (a, b) in enumerate(zip(xa[:-1], xb[:-1])):
        a, b = a.cpu().double().numpy(), b.double().numpy()
        if not a.size:
            continue
        diff, scale = np.abs(a - b), float(np.max(np.abs(b)))
        bound = CONV_LEAF_REL * scale + steps
        if float(diff.max()) > bound:
            raise AssertionError(f"conv card-vs-CPU: leaf {i} differs by "
                                 f"{float(diff.max())} > {bound}")
        worst = max(worst, float(diff.max()))
        worst_rel = max(worst_rel, max(float(diff.max()) - steps, 0.0)
                        / max(scale, 1e-30))
        beyond += int(np.sum(diff > 2e-3 + 1e-3 * np.abs(b)))
    return {"max_abs_diff": worst, "max_rel_beyond_lr": worst_rel,
            "elements_beyond_2e-3": beyond, "elements": sum(
                t.numel() for t in xb[:-1]),
            "loss_rel_diff": float(np.max(np.abs(ra.d_losses - rb.d_losses)
                                          / np.abs(rb.d_losses)))}


# ---------------------------------------------------------------------------
# SPMD federation (core/spmd.py): a users mesh on torch.distributed
# ---------------------------------------------------------------------------

SPMD_U, SPMD_ROUNDS, SPMD_K = 256, 32, 8
SPMD_RANKS, SPMD_RANK_ROUNDS = 4, 4


def _spmd_fcfg(num_users: int, ef: bool, approach: str = "approach1"):
    """topk_int8 uploads (error feedback only where a cohort store keeps
    the residual) for approach 1; plain approaches 2 and 3."""
    from repro_torch.core.approaches import DistGANConfig
    if approach != "approach1":
        return DistGANConfig(num_users=num_users, upload_frac=FRAC)
    return DistGANConfig(num_users=num_users, upload_frac=FRAC,
                         codec="topk_int8", error_feedback=ef)


def _spmd_batches(dataset, sched, batch: int = 64):
    """(R, C, B, 784) batches of the scheduled users from one seeded
    stream (every rank draws the same)."""
    import numpy as np
    rng = np.random.default_rng(1)
    return np.stack([np.stack([np.asarray(dataset.user_batch(int(u), rng,
                                                             batch))
                               for u in row]) for row in sched]
                    ).astype(np.float32)


def _halves(torch, run, k: int):
    """``run(start, k)`` for rounds [0, k) then [k, 2k), the device synced
    around the second: (outputs of both, steady ms per round of the second
    half; the first pays the kernels' loads and the allocator's warm-up)."""
    first = run(0, k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    second = run(k, k)
    torch.cuda.synchronize()
    return (first, second), (time.perf_counter() - t0) * 1e3 / k


def _stream_ms(stats) -> float:
    """Steady ms per round of a streamed run: its retire stamps after the
    first round."""
    rt = stats.retire_t
    return (rt[-1] - rt[0]) * 1e3 / (len(rt) - 1)


def _spmd_session(pair, dataset, U, dev, mesh, rounds):
    from repro_torch.core.spec import BackendSpec
    return _session(pair, dataset, U, "topk_int8", False, dev,
                    eval_samples=0, scheduler="uniform", cohort=mesh.size,
                    ef=True, rpj=SPMD_K, backend=BackendSpec("spmd"),
                    mesh=mesh).run(rounds)


def _spmd_world1(torch, dev, mesh, cpu_mesh):
    """(a) NCCL at world size 1, paper MLP, batch 64, topk_int8 (+ EF on
    the cohort paths), B1 and B2 on the kernels, launch counts zeroed
    before each run and read after it: one top-k, quantize and dequantize
    per round.  Returns (lines, launch totals)."""
    import numpy as np

    from repro_torch.core import session as tsess
    from repro_torch.core import spmd
    from repro_torch.core.engine import init_host_backend
    from repro_torch.core.federated import make_schedule
    from repro_torch.kernels import ops

    pair = _paper_pair()
    totals = dict.fromkeys(("topk_mask_rows", "quantize_rows",
                            "dequantize_rows"), 0)
    lines = []

    def counted(run, rounds, what, **line):
        ops.reset_launch_counts()
        out = run()
        counts = ops.launch_counts()
        want = dict.fromkeys(counts, 0)
        want.update(topk_mask_rows=rounds, quantize_rows=rounds,
                    dequantize_rows=rounds)
        if counts != want:
            raise AssertionError(f"spmd {what}: launches {counts} != {want}")
        for k in totals:
            totals[k] += counts[k]
        lines.append({"run": what, "rounds": rounds, "launches": counts,
                      **line})
        return out

    K = SPMD_K
    one = _digits_dataset(1, 28, 400)
    reals = _spmd_batches(one, np.zeros((2 * K, 1), np.int64))
    fcfg = _spmd_fcfg(1, ef=False)
    state = spmd.init_spmd_state(pair, fcfg, 0, mesh, sync_ds=True)
    step = spmd.make_spmd_step(pair, fcfg, mesh, "approach1")
    (_, g), ms = counted(lambda: _halves(torch, lambda a, k: [
        float(step(state, reals[r])[1]["g_loss"]) for r in range(a, a + k)],
        K), 2 * K, "make_spmd_step U=1")
    lines[-1]["ms_per_round"] = ms
    eng = spmd.make_spmd_engine(pair, fcfg, mesh, "approach1")
    state = spmd.init_spmd_state(pair, fcfg, 0, mesh, sync_ds=True)
    (_, (_, m)), ms = counted(lambda: _halves(
        torch, lambda a, k: eng(state, reals[a:a + k]), K), 2 * K,
        "make_spmd_engine U=1")
    lines[-1]["ms_per_round"] = ms
    if not np.all(np.isfinite(m["g_loss"].cpu().numpy() + g)):
        raise AssertionError("spmd step / engine: losses")

    # the three cohort engines at C = 1 over a U = 256 store
    dataset = _digits_dataset(SPMD_U, 28, 400)
    fcfg = _spmd_fcfg(SPMD_U, ef=True)
    sched = make_schedule("uniform", SPMD_U, 1, 2 * K,
                          np.random.default_rng(2))
    reals = _spmd_batches(dataset, sched)
    ends = {}
    for form, mk, sharded in (
            ("replicated", spmd.make_spmd_cohort_engine, False),
            ("sharded", spmd.make_spmd_fused_store_engine, True)):
        cs = spmd.init_spmd_cohort_state(pair, fcfg, 0, mesh, sync_ds=True,
                                         sharded=sharded)
        e = mk(pair, fcfg, mesh, "approach1", 1)
        base = _peak_base(torch)
        box = [cs]

        def run(a, k, e=e, box=box):
            box[0], m = e(box[0], reals[a:a + k], sched[a:a + k])
            return m["g_loss"].cpu().numpy()

        g, ms = counted(lambda: _halves(torch, run, K), 2 * K,
                        f"{form}-store cohort engine U={SPMD_U} C=1")
        lines[-1].update(ms_per_round=ms, peak_device_gb=(
            torch.cuda.max_memory_allocated() - base) / 1e9)
        ends[form] = (box[0], np.concatenate(g))
    shared, be = init_host_backend(pair, fcfg, 0, dev, sync_ds=True)
    rows_eng = spmd.make_spmd_cohort_rows_engine(pair, fcfg, mesh,
                                                 "approach1", 1)
    shared, mets, stats = counted(lambda: tsess.stream_cohort_rounds(
        rows_eng, shared, be, sched, lambda r: reals[r]), 2 * K,
        f"rows engine (host store) U={SPMD_U} C=1")
    lines[-1].update(ms_per_round=_stream_ms(stats),
                     pinned_host_gb=be.nbytes / 1e9)
    (rep, g_rep), (sh, g_sh) = ends["replicated"], ends["sharded"]
    for name in ("d_flat", "opt_flat", "last_round", "residual"):
        a = getattr(rep.store, name)
        if not (torch.equal(a, getattr(sh.store, name))
                and torch.equal(a.cpu(), getattr(be, name))):
            raise AssertionError(f"spmd cohort engines differ on {name}")
    if not (np.array_equal(g_rep, g_sh) and np.array_equal(
            g_rep, np.array([float(m["g_loss"]) for m in mets]))):
        raise AssertionError("spmd cohort engines' losses differ")
    del ends, rep, sh, be

    # the spmd backend session
    base = _peak_base(torch)
    res = counted(lambda: _spmd_session(pair, dataset, SPMD_U, dev, mesh,
                                        SPMD_ROUNDS), SPMD_ROUNDS,
                  f"spmd backend session U={SPMD_U} C=1 topk_int8+EF")
    be = res.extra["host_backend"]
    if not (np.all(np.isfinite(res.g_losses))
            and be.pinned == (mesh.device.type == "cuda")
            and res.extra["state_backend"] == "spmd"):
        raise AssertionError("spmd session")
    lines[-1].update(
        best_ms_per_round=res.extra["min_step_time_s"] * 1e3,
        steady_ms_per_round=res.step_time_s * 1e3,
        host_stall_ms_per_round=res.extra["host_stall_s_per_round"] * 1e3,
        pinned_host_gb=be.nbytes / 1e9,
        peak_device_gb=(torch.cuda.max_memory_allocated() - base) / 1e9)
    del res, be
    return lines, totals


def _peak_base(torch) -> int:
    """Reset the peak-memory counter; the bytes allocated now, which a
    run's peak is counted above."""
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _first_codec_calls(ops):
    """Wrap B1's and B2's wrappers so that the first call of each (the
    round-0 mask, codes and scales of an SPMD run) keeps its inputs and
    outputs; returns the record and a function that unwraps them."""
    seen, orig = {}, {}
    for name in ("topk_mask", "quantize_rows", "dequantize_rows"):
        fn = orig[name] = getattr(ops, name)

        def tap(*args, _name=name, _fn=fn, **kw):
            out = _fn(*args, **kw)
            seen.setdefault(_name, (args, kw, out))
            return out
        setattr(ops, name, tap)

    def restore():
        for name, fn in orig.items():
            setattr(ops, name, fn)
    return seen, restore


def _cross_check_round0(torch, seen: dict, dev) -> None:
    """A run's round-0 B1 mask, B2 codes and scales and dequantized row,
    recomputed on the other device from the same inputs (the card's
    kernels or the CPU's plain versions): bitwise equal."""
    from repro_torch.kernels import ops

    def there(t):
        return (t.to(dev if t.device.type == "cpu" else "cpu")
                if isinstance(t, torch.Tensor) else t)

    for name in ("topk_mask", "quantize_rows", "dequantize_rows"):
        args, kw, out = seen[name]
        again = getattr(ops, name)(*map(there, args),
                                   **{k: there(v) for k, v in kw.items()})
        for a, b in zip(out if isinstance(out, tuple) else (out,),
                        again if isinstance(again, tuple) else (again,)):
            if not torch.equal(a.cpu().view(-1).view(torch.uint8),
                               b.cpu().view(-1).view(torch.uint8)):
                raise AssertionError(f"round-0 {name}: card and CPU differ "
                                     f"on the same inputs")


def _spmd_cpu_agreement(torch, dev, mesh, cpu_mesh) -> dict:
    """The same ranks on the card (NCCL, kernels) and on the CPU (gloo,
    plain versions), from one seed (the noise is drawn on the host): the
    SPMD engine at full width, 16 rounds, and a small spmd session (U 8,
    C 1, topk_int8 + EF, 12 rounds), at ``_cpu_agreement``'s tolerances.
    Each engine run's round-0 B1 mask and B2 codes, scales and dequantized
    row equal, bitwise, what the other device computes from the same
    inputs (the run's own delta and masked row)."""
    import numpy as np

    from repro_torch.core import spmd
    from repro_torch.kernels import ops
    from repro_torch.models.common import tree_leaves

    pair = _paper_pair()
    one = _digits_dataset(1, 28, 400)
    reals = _spmd_batches(one, np.zeros((2 * SPMD_K, 1), np.int64))
    fcfg = _spmd_fcfg(1, ef=False)
    runs = []
    for m in (mesh, cpu_mesh):
        st = spmd.init_spmd_state(pair, fcfg, 0, m, sync_ds=True)
        seen, restore = _first_codec_calls(ops)
        try:
            st, met = spmd.make_spmd_engine(pair, fcfg, m, "approach1")(
                st, reals)
        finally:
            restore()
        _cross_check_round0(torch, seen, dev)
        runs.append((met["g_loss"].cpu().numpy(), [
            t.cpu().numpy() for t in tree_leaves(st.g)
            + tree_leaves(st.server_d) + tree_leaves(st.ds)]))
    np.testing.assert_allclose(runs[0][0], runs[1][0], atol=1e-3)
    worst = {"engine_full_width": max(
        float(np.max(np.abs(a.astype(np.float64) - b)))
        for a, b in zip(runs[0][1], runs[1][1]))}
    for a, b in zip(runs[0][1], runs[1][1]):
        np.testing.assert_allclose(a, b, atol=2e-3, rtol=1e-3)
    from repro_torch.core.gan import MLPGanConfig, make_mlp_pair
    small = make_mlp_pair(MLPGanConfig(data_dim=64, z_dim=16, g_hidden=32,
                                       d_hidden=32))
    dataset = _digits_dataset(8, 8, 60)
    a, b = (_spmd_session(small, dataset, 8, m.device, m, 12)
            for m in (mesh, cpu_mesh))
    np.testing.assert_array_equal(a.extra["schedule"], b.extra["schedule"])
    np.testing.assert_allclose(a.g_losses, b.g_losses, atol=1e-3)
    ba, bb = a.extra["host_backend"], b.extra["host_backend"]
    diffs = []
    for name in ("d_flat", "opt_flat", "residual"):
        x, y = getattr(ba, name).numpy(), getattr(bb, name).numpy()
        np.testing.assert_allclose(x, y, atol=2e-3, rtol=1e-3)
        diffs.append(float(np.max(np.abs(x.astype(np.float64) - y))))
    worst["session_u8"] = max(diffs)
    return worst


def _spmd_gloo_rank(mesh, rounds: int) -> dict:
    """(b) one of SPMD_RANKS gloo ranks sharing the card: approaches 1
    (topk_int8 + EF), 2 and 3 on the replicated-store, sharded-store and
    rows engines at U = 256, C = SPMD_RANKS, ``rounds`` rounds each.  The
    sharded store (all-gathered from the ranks) and the rows engine's host
    store must equal the replicated store bitwise, and G and the server D
    the same bytes on every rank (an all-gather of their bits)."""
    import numpy as np
    import torch

    from repro_torch.core import collectives as coll
    from repro_torch.core import session as tsess
    from repro_torch.core import spmd
    from repro_torch.core.engine import CohortShared
    from repro_torch.core.federated import HostStateBackend, make_schedule
    from repro_torch.kernels import ops
    from repro_torch.models.common import tree_leaves

    pair = _paper_pair()
    C, dev = mesh.size, mesh.device
    dataset = _digits_dataset(SPMD_U, 28, 400)
    sched = make_schedule("uniform", SPMD_U, C, rounds,
                          np.random.default_rng(3))
    reals = _spmd_batches(dataset, sched)
    out = {"ms_per_round": {}, "max_abs_vs_replicated": {}, "launches": {}}

    def bits(t):
        return t.contiguous().view(-1).view(torch.int32)

    for approach in ("approach1", "approach2", "approach3"):
        fcfg = _spmd_fcfg(SPMD_U, ef=True, approach=approach)
        init = spmd.init_spmd_cohort_state(pair, fcfg, 0, mesh,
                                           sync_ds=approach == "approach1")
        ends = {}
        for form in ("replicated", "sharded", "rows"):
            ops.reset_launch_counts()
            cs = (spmd.shard_cohort_state(init, mesh) if form == "sharded"
                  else init)
            if form == "rows":
                c = init.clone()
                shared = CohortShared(c.g, c.g_opt, c.server_d, c.step,
                                      c.generator)
                be = HostStateBackend.from_store(c.store,
                                                 pin=dev.type == "cuda")
                del c
                eng = spmd.make_spmd_cohort_rows_engine(pair, fcfg, mesh,
                                                        approach, C)
                shared, mets, stats = tsess.stream_cohort_rounds(
                    eng, shared, be, sched, lambda r: reals[r])
                ms = _stream_ms(stats)
                ends[form] = (shared.g, shared.server_d, be.d_flat,
                              np.array([float(m["g_loss"]) for m in mets]))
            else:
                mk = (spmd.make_spmd_cohort_engine if form == "replicated"
                      else spmd.make_spmd_fused_store_engine)
                e = mk(pair, fcfg, mesh, approach, C)
                box = [cs]

                def run(a, k, e=e, box=box):
                    box[0], m = e(box[0], reals[a:a + k], sched[a:a + k])
                    return m["g_loss"].cpu().numpy()

                g, ms = _halves(torch, run, rounds // 2)
                cs = box[0]
                store = cs.store.d_flat
                if form == "sharded":
                    store = coll.all_gather_bits(store.reshape(-1), mesh
                                                 ).reshape(SPMD_U, -1)
                ends[form] = (cs.g, cs.server_d, store, np.concatenate(g))
            key = f"{approach} {form}"
            out["ms_per_round"][key] = ms
            out["launches"][key] = ops.launch_counts()
            lossy = approach == "approach1"
            if out["launches"][key]["topk_mask_rows"] != (
                    rounds if lossy else 0) or out["launches"][key][
                    "quantize_rows"] != (rounds if lossy else 0):
                raise AssertionError(f"rank {mesh.rank} {key}: launches "
                                     f"{out['launches'][key]}")
            g, server, _, losses = ends[form]
            if not np.all(np.isfinite(losses)):
                raise AssertionError(f"{key}: losses")
            flat = torch.cat([bits(t) for t in tree_leaves(g)
                              + tree_leaves(server)])
            every = coll.all_gather(flat, mesh)
            if not bool((every == every[0]).all()):
                raise AssertionError(f"{key}: G / server D differ between "
                                     f"ranks")
        rep = ends["replicated"]
        for form in ("sharded", "rows"):
            other = ends[form]
            diff = float((other[2].to(dev) - rep[2]).abs().max())
            out["max_abs_vs_replicated"][f"{approach} {form}"] = diff
            if not (torch.equal(other[2].to(dev), rep[2])
                    and np.array_equal(other[3], rep[3])):
                raise AssertionError(f"{approach}: {form} store != "
                                     f"replicated (max |diff| {diff})")
        del init, ends, rep
    out["peak_device_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def _spmd_phase(torch, dev):
    """The SPMD federation: (a) NCCL at world size 1 in this process (and
    the same ranks on the CPU over gloo), (b) SPMD_RANKS gloo ranks
    sharing the card.  Returns (lines, launch totals, summary)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import UsersMesh, make_users_mesh, spawn_users

    init = CKPT_DIR.parent / "spmd_rendezvous"
    init.parent.mkdir(parents=True, exist_ok=True)
    init.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{init}", rank=0,
                            world_size=1)
    try:
        mesh = make_users_mesh(1, backend="nccl", device=dev)
        cpu_mesh = UsersMesh(dist.new_group(ranks=[0], backend="gloo"), 0, 1,
                             torch.device("cpu"))
        t0 = time.perf_counter()
        lines, totals = _spmd_world1(torch, dev, mesh, cpu_mesh)
        summary = {"world1_s": time.perf_counter() - t0,
                   "card_vs_cpu_worst": _spmd_cpu_agreement(
                       torch, dev, mesh, cpu_mesh)}
    finally:
        dist.destroy_process_group()
        init.unlink(missing_ok=True)
    t0 = time.perf_counter()
    ranks = spawn_users(_spmd_gloo_rank, SPMD_RANKS, backend="gloo",
                        device="cuda", args=(SPMD_RANK_ROUNDS,),
                        timeout_s=300)
    summary["gloo_ranks"] = {
        "ranks": SPMD_RANKS, "rounds": SPMD_RANK_ROUNDS,
        "ms_per_round_rank0": ranks[0]["ms_per_round"],
        "max_abs_vs_replicated": ranks[0]["max_abs_vs_replicated"],
        "peak_device_gb_per_rank": [r["peak_device_gb"] for r in ranks],
        "seconds": time.perf_counter() - t0}
    return lines, totals, summary


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        return _fail(f"{SRC / 'repro_torch'} not found: run from a checkout "
                     f"of the repository")
    import torch
    if not torch.cuda.is_available():
        return _fail("no CUDA device (torch.cuda.is_available() is False)")
    sys.path.insert(0, str(SRC))
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build

    dev = resolve_device()
    card = _card_line()
    print(f"[env] {card} | torch {torch.__version__} | cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}", flush=True)

    build_s = build.build_all()
    print(f"[build] {len(build.sources())} sources in {build_s:.2f} s: "
          + (", ".join(f"{n} {t:.2f} s" for n, t in
                       sorted(build.build_seconds.items()))
             or "all built before"), flush=True)
    for name, log in sorted(build.build_logs.items()):
        for line in log.strip().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    t0 = time.perf_counter()
    recs, n_topk, n_codec = _kernel_phase(torch, dev)
    print(f"[kernels] bitwise vs plain: {n_topk} top-k cases, {n_codec} codec"
          f" cases x 3 modes ({time.perf_counter() - t0:.1f} s)", flush=True)

    t0 = time.perf_counter()
    lines, totals = _main_path(torch, dev)
    for line in lines:
        print("[main] " + json.dumps(line), flush=True)
    print(f"[main] {time.perf_counter() - t0:.1f} s", flush=True)
    for rec in recs:
        rec["launches"] = totals[rec["name"]]
        if rec["launches"] < 1:
            raise AssertionError(f"{rec['name']} never launched on the main "
                                 f"path")

    worst = _cpu_agreement(torch, dev)
    print(f"[check] card vs CPU small session, worst |diff|: "
          f"{json.dumps(worst)}", flush=True)

    t0 = time.perf_counter()
    block_rec, block_main, n_block = _block_topk_phase(torch, dev)
    block_path = _block_topk_path(torch, block_main)
    block_rec["launches"] = block_path["launches"]
    del block_main
    print(f"[kernels] block top-k bitwise vs plain: {n_block} cases; entry "
          f"point {json.dumps(block_path)} ({time.perf_counter() - t0:.1f} s)",
          flush=True)

    t0 = time.perf_counter()
    lines, cohort_totals, ratio = _cohort_phase(torch, dev)
    for line in lines:
        print("[cohort] " + json.dumps(line), flush=True)
    print(f"[cohort] steady ms/round U={COHORT_US[0]} / U={COHORT_US[1]}: "
          f"{ratio:.4f} (fused store, first window); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for rec in recs:
        rec["launches"] += cohort_totals.get(rec["name"], 0)

    t0 = time.perf_counter()
    for line in _approaches_phase(torch, dev):
        print("[approaches] " + json.dumps(line), flush=True)
    print(f"[approaches] {time.perf_counter() - t0:.1f} s", flush=True)

    worst = _cohort_cpu_agreement(torch, dev)
    print(f"[check] card vs CPU small cohort session, worst |diff|: "
          f"{json.dumps(worst)}", flush=True)

    t0 = time.perf_counter()
    lines, host_totals, host_summary = _host_phase(torch, dev)
    for line in lines:
        print("[host] " + json.dumps(line), flush=True)
    print("[host] " + json.dumps(host_summary), flush=True)
    print(f"[host] {time.perf_counter() - t0:.1f} s", flush=True)
    for rec in recs:
        rec["launches"] += host_totals.get(rec["name"], 0)
    worst = _host_cpu_agreement(torch, dev)
    print(f"[check] card vs CPU small host sessions, worst |diff|: "
          f"{json.dumps(worst)}", flush=True)

    t0 = time.perf_counter()
    n_spmd = _kernels_at(torch, dev, recs, 1, MAIN_N, 5, "at_spmd_row")
    print(f"[kernels] B1/B2 bitwise vs plain at 1 x {MAIN_N} (one rank's "
          f"row): {n_spmd} cases; " + json.dumps(
              {r["name"]: r["at_spmd_row"] for r in recs
               if "at_spmd_row" in r}), flush=True)
    lines, spmd_totals, spmd_summary = _spmd_phase(torch, dev)
    for line in lines:
        print(f"[spmd] {card} | " + json.dumps(line), flush=True)
    print(f"[spmd] {card} | " + json.dumps(spmd_summary), flush=True)
    print(f"[spmd] {time.perf_counter() - t0:.1f} s", flush=True)
    for rec in recs:
        rec["launches"] += spmd_totals.get(rec["name"], 0)

    t0 = time.perf_counter()
    for line in _graph_phase(torch, dev):
        print("[graph] " + json.dumps(line), flush=True)
    print(f"[graph] eager chunk vs CUDA graph bitwise; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    for line in _checkpoint_phase(torch, dev):
        print("[ckpt] " + json.dumps(line), flush=True)
    print(f"[ckpt] {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    n_conv = _conv_width_kernels(torch, dev, recs)
    print(f"[kernels] B1/B2 bitwise vs plain at 8 x {CONV_D_N}: {n_conv} "
          f"cases; " + json.dumps({r["name"]: r["at_conv_d_width"]
                                   for r in recs
                                   if "at_conv_d_width" in r}), flush=True)
    line, conv_counts = _conv_full_phase(torch, dev)
    print("[conv] " + json.dumps(line), flush=True)
    for rec in recs:
        rec["launches"] += conv_counts.get(rec["name"], 0)
    print("[conv] " + json.dumps(_conv_paper_phase(torch, dev)), flush=True)
    print("[conv] " + json.dumps(_wgan_phase(torch, dev)), flush=True)
    worst = _conv_cpu_agreement(torch, dev)
    print(f"[check] conv card vs CPU, one round at U=2 (losses rtol "
          f"{CONV_LOSS_RTOL}; leaves {CONV_LEAF_REL} x max|leaf| + "
          f"{CONV_LEAF_LR_STEPS} lr): {json.dumps(worst)}", flush=True)
    print(f"[conv] {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    lm_recs, info = _lm_kernel_phase(torch, dev)
    print(f"[kernels] LM kernels vs plain ({time.perf_counter() - t0:.1f} s):"
          f" {json.dumps(info)}", flush=True)

    t0 = time.perf_counter()
    requests, totals, f32_ms = _lm_prefill(torch, dev)
    for rec in lm_recs:
        rec["launches"], rec["launches_per_forward"] = totals[rec["name"]]
        full = [r["ms"] for r in requests
                if r["kernel"] == rec["name"] and r["seq"] == LM_SEQS[0]]
        # the f32 routes: driven by the f32 forward of the first request
        whole, what = ((min(full), f"the fastest S={LM_SEQS[0]} request")
                       if full else (f32_ms[rec["name"]],
                                     "the f32 forward"))
        print(f"[lm] {rec['name']}: {rec['launches_per_forward']} x "
              f"{rec['ms']:.4f} ms = "
              f"{rec['launches_per_forward'] * rec['ms'] / whole:.3f} "
              f"of {what} ({whole:.2f} ms)", flush=True)
    print(f"[lm] {time.perf_counter() - t0:.1f} s", flush=True)

    worst = _lm_cpu_agreement(torch, dev)
    print(f"[check] card vs CPU reduced LM forwards, worst |diff|: "
          f"{json.dumps(worst)}", flush=True)

    print(json.dumps({"kernels": recs + [block_rec] + lm_recs}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--resume-main"] and len(sys.argv) == 4:
        sys.exit(_resume_main(sys.argv[2], sys.argv[3]))
    sys.exit(main())
