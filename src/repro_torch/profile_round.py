"""Where a main-path round's time goes on the GPU.

    PYTHONPATH=src python -m repro_torch.profile_round [--rounds 16]
        [--codec topk_int8] [--stochastic] [--trace chiprun_out/round.json]

Runs approach-1 federation at the paper's full MLP width (784/256/256,
z 64; 8 users of Dirichlet-split 28x28 digit-like data; batch 64; fused
engine), warms up one chunk, times one chunk of ``--rounds`` rounds unprofiled,
then profiles one more with ``torch.profiler`` (CPU + CUDA activities)
and prints one JSON line: wall ms per round with and without the
profiler, device-busy ms per round (the union of kernel and memcpy
intervals on the device), the idle share against the unprofiled wall, device operations per
round, the time in this package's own kernels, the top device kernels by
time and the top host operations by self CPU time.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core.approaches import DistGANConfig
from repro_torch.core.gan import MLPGanConfig, make_mlp_pair
from repro_torch.core.session import FederationSession
from repro_torch.core.spec import (CombineSpec, CompressionSpec, EngineSpec,
                                   FederationSpec)
from repro_torch.data import digits_like_mixture, dirichlet_partition

# the kernels of csrc/topk_select.cu and csrc/quantize.cu (B1, B2)
_OWN = ("topk_mask_cluster", "quantize_cluster", "dequantize")


def _dataset(num_users: int):
    rng = np.random.default_rng(0)
    data, labels = [], []
    for c in range(10):
        _, sample = digits_like_mixture([c], size=28)
        data.append(sample(rng, 400))
        labels.append(np.full(400, c))
    return dirichlet_partition(np.concatenate(data).reshape(4000, -1),
                               np.concatenate(labels), num_users, alpha=0.5,
                               seed=0)


def _busy_ms(intervals) -> float:
    """Length of the union of [start, end) intervals (microseconds in)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=16)
    ap.add_argument("--users", type=int, default=8)
    ap.add_argument("--codec", default="topk_int8")
    ap.add_argument("--stochastic", action="store_true")
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_round needs a CUDA device")

    pair = make_mlp_pair(MLPGanConfig(data_dim=784, z_dim=64, g_hidden=256,
                                      d_hidden=256))
    spec = FederationSpec(
        "approach1", batch_size=64, eval_samples=0,
        engine=EngineSpec(kind="fused", rounds_per_jit=args.rounds),
        combine=CombineSpec(compression=CompressionSpec(
            codec=args.codec, error_feedback=False,
            stochastic=args.stochastic)))
    sess = FederationSession(pair, DistGANConfig(num_users=args.users,
                                                 upload_frac=0.1),
                             _dataset(args.users), spec)
    sess.run(args.rounds)                                 # warm-up chunk
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess.run(args.rounds)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sess.run(args.rounds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if args.trace:
        prof.export_chrome_trace(args.trace)

    kernels, intervals = {}, []
    launches = 0
    for ev in prof.events():
        if ev.device_type.name != "CUDA":
            continue
        start = ev.time_range.start
        end = ev.time_range.end
        intervals.append((start, end))
        launches += 1
        kernels.setdefault(ev.name, [0, 0.0])
        kernels[ev.name][0] += 1
        kernels[ev.name][1] += (end - start) / 1e3
    r = args.rounds
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
    busy = _busy_ms(intervals)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:15]
    own_ms = sum(v[1] for k, v in kernels.items()
                 if any(k.startswith(o) or f" {o}" in k or f"::{o}" in k
                        for o in _OWN))
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "rounds": r,
        "codec": args.codec, "stochastic": args.stochastic,
        "wall_ms_per_round_unprofiled": plain_wall * 1e3 / r,
        "wall_ms_per_round_profiled": wall * 1e3 / r,
        "device_busy_ms_per_round": busy / r,
        "device_idle_share_unprofiled": 1.0 - busy / (plain_wall * 1e3),
        "device_ops_per_round": launches / r,
        "own_kernels_ms_per_round": own_ms / r,
        "top_device_ops": [{"name": k[:80], "calls_per_round": v[0] / r,
                            "ms_per_round": v[1] / r} for k, v in top],
        "top_host_ops": [{"name": a.key[:60], "calls_per_round": a.count / r,
                          "self_cpu_ms_per_round":
                              a.self_cpu_time_total / 1e3 / r}
                         for a in host[:12]]}))


if __name__ == "__main__":
    main()
