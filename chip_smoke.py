#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line) when
it goes wrong:

1. environment — the card's name and power limit (``nvidia-smi``), the
   torch and CUDA versions;
2. build — every kernel under ``src/repro_torch/kernels/csrc`` with nvcc
   for sm_90a, all sources at once;
3. kernels — each Hopper kernel on the card at the main path's shape
   (8 user rows of the 784/256/256 MLP discriminator, N = 267,009 f32,
   upload fraction 0.1) and on edge cases, held BITWISE to its plain
   PyTorch version on the same inputs; CUDA-event times (median of 30
   after warm-up) of the kernel, the plain version and, where one exists,
   the single PyTorch call computing the same function; the least time
   the card needs for the bytes each must move;
4. main path — ``FederationSession`` approach-1 federation at the paper's
   full MLP width (8 users, Dirichlet-split 28x28 digit-like data, batch
   64, fused engine, 16 rounds per chunk): 64 rounds with codec ``none``,
   then 32 rounds each of ``topk_int8`` with deterministic and stochastic
   rounding.  Launch counts are zeroed before each run and must show one
   launch of each kernel per round where the run uses it; losses must be
   finite and the state on the card.  A small session run on the card and
   on the CPU (plain versions) from the same seed must agree;
5. the result: a ``kernels`` JSON line, the card line, and as the last
   line ``{"ok": true, "device": {...}}``.

Needs one CUDA device and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_OPS_PER_S = 67e12            # f32 outside the tensor cores
MAIN_ROWS, MAIN_N, FRAC = 8, 267009, 0.1


def _fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(torch, fn, reps: int = 30, warm: int = 5) -> float:
    """Median CUDA-event time of one call (host enqueue included, inputs
    resident in L2 as on the main path, where the rows were just written)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def _bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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

    topk_cases = [(main, FRAC), (main, 1.0), (main, 0.01)]
    for n in (100, 5000, 8192, 8192 + 17, 3 * 8192):
        for frac in (0.01, 0.1, 0.5, 1.0):
            topk_cases.append((rows(n), frac))
    degenerate = torch.stack([torch.zeros(300, device=dev),
                              torch.ones(300, device=dev),
                              torch.full((300,), -0.5, device=dev)])
    topk_cases += [(degenerate, 0.1), (torch.round(rows(5000) * 4) / 4, 0.3)]
    for x, frac in topk_cases:
        got = tt.topk_mask_rows(x, frac)
        if not torch.equal(got, ref.topk_mask_global_ref(x, frac)):
            raise AssertionError(f"topk_mask_rows != plain at {tuple(x.shape)}"
                                 f" frac={frac}")
    if not tt.topk_mask_rows(degenerate, 0.1)[0].all():
        raise AssertionError("all-zero row must keep every entry (t = 0)")

    codec_cases = [main, rows(1000), rows(8192 + 17), degenerate,
                   torch.zeros((2, 77), device=dev)]
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

    k = ref.topk_k(MAIN_N, FRAC)
    elems = MAIN_ROWS * MAIN_N
    q_main, s_main = tq.quantize_rows(main)
    recs = []

    def record(name, source, replaces, kern, plain, library, nbytes, ops,
               err):
        bound_ms, bound_by = _bound(nbytes, ops)
        recs.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": _time_ms(torch, kern), "plain_ms": _time_ms(torch, plain),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None if library is None
            else _time_ms(torch, library)})

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
             batch=64, rpj=16, eval_samples=256):
    from repro_torch.core.approaches import DistGANConfig
    from repro_torch.core.session import FederationSession
    from repro_torch.core.spec import (CombineSpec, CompressionSpec,
                                       EngineSpec, FederationSpec)
    spec = FederationSpec(
        "approach1", batch_size=batch, seed=0, eval_samples=eval_samples,
        engine=EngineSpec(kind="fused", rounds_per_jit=rpj),
        combine=CombineSpec(compression=CompressionSpec(
            codec=codec, error_feedback=False, stochastic=stochastic)))
    return FederationSession(pair, DistGANConfig(num_users=num_users,
                                                 upload_frac=FRAC),
                             dataset, spec, device=device)


def _main_path(torch, dev):
    """The three main-path runs; returns (per-run lines, launch totals)."""
    import numpy as np

    from repro_torch.core.gan import MLPGanConfig, make_mlp_pair
    from repro_torch.kernels import ops
    from repro_torch.models.common import tree_leaves

    pair = make_mlp_pair(MLPGanConfig(data_dim=784, z_dim=64, g_hidden=256,
                                      d_hidden=256))
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
        want = {"topk_mask_rows": rounds,
                "quantize_rows": rounds if lossy else 0,
                "dequantize_rows": rounds if lossy else 0}
        if counts != want:
            raise AssertionError(f"launch counts {counts} != {want} "
                                 f"({codec}, stochastic={stochastic})")
        for k, v in counts.items():
            totals[k + ("_stochastic" if stochastic and k == "quantize_rows"
                        else "")] += v
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
    print(f"[build] {len(build.sources())} sources in {build_s:.2f} s",
          flush=True)
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

    print(json.dumps({"kernels": recs}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
