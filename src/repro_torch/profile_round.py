"""Where a main-path round's time goes on the GPU, through the CUDA-graph
engine and through the eager chunk.

    PYTHONPATH=src python -m repro_torch.profile_round [--rounds 16]
        [--codec topk_int8] [--stochastic] [--conv]
        [--trace chiprun_out/round.json]
    PYTHONPATH=src python -m repro_torch.profile_round --host [--users 256]
    PYTHONPATH=src python -m repro_torch.profile_round --spmd [--users 256]

Runs approach-1 federation at the paper's full MLP width (784/256/256,
z 64; 8 users of Dirichlet-split 28x28 digit-like data; batch 64; fused
engine; ``--conv``: the DCGAN pair at the paper's CelebA/LSUN width, 64 x
64 x 3 images, z 100, 64 base filters) twice in one process from one seed: first as the session runs it
(a CUDA graph per chunk), then with its engine swapped for the eager chunk
(``core.engine.make_eager_engine``).  Each warms up one chunk of
``--rounds`` rounds, times a window of four chunks unprofiled, then
profiles one more chunk with ``torch.profiler`` (CPU + CUDA activities).
Prints one JSON line with, for each: wall ms per round of the timed window
(its data sampling and staging included) and of the profiled chunk, the
window's steady ms per round (``RunResult.step_time_s``: its last three
chunks, staging excluded), device-busy ms per round (the union of kernel
and memcpy intervals on the device), the idle share against the window's
wall and against the steady round, device operations per round, the time
in this package's own kernels, the top device kernels by time and the top
host operations by self CPU time.  For the graph it also takes
one chunk apart (``breakdown``, per round, best of 5): the host's noise
draws, loading them and the reals into the graph's buffers, the
``replay()`` call, and the replay's device time between CUDA events.
``--trace`` writes the graph run's Chrome trace.

``--host`` profiles the host streaming backend instead (``--users``
logical users, default 256, a uniform cohort of 8, ``topk_int8`` with
error feedback, the store in pinned host memory), in each of its modes
(sync, no prefetch, one round in flight, superbatch windows of
``--rounds``, int8 row staging), with the same window, plus host clocks
around the stream's host stages: the store's gathers and scatters and the
batch sampling, ms per round over every round run.

``--spmd`` profiles the ``spmd`` backend the same way (``--users`` logical
users, default 256, one cohort member per rank of a users mesh of one
NCCL rank in this process, ``topk_int8`` with error feedback, eager
rounds), with the host stages and the NCCL calls per round.  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core.approaches import DistGANConfig
from repro_torch.core.engine import make_eager_engine
from repro_torch.core.gan import (ConvGanConfig, MLPGanConfig,
                                  make_conv_pair, make_mlp_pair)
from repro_torch.core.session import FederationSession
from repro_torch.core.spec import (BackendSpec, CombineSpec,
                                   CompressionSpec, EngineSpec,
                                   FederationSpec, ParticipationSpec)
from repro_torch.data import digits_like_mixture, dirichlet_partition

# the kernels of csrc/topk_select.cu and csrc/quantize.cu (B1, B2)
_OWN = ("topk_mask_cluster", "quantize_cluster", "dequantize")


def _dataset(num_users: int, conv: bool = False):
    """28 x 28 digit-like images as flat rows, or (``conv``) at 64 x 64
    tiled to 3 channels (NHWC), Dirichlet(0.5)-split over the users."""
    rng = np.random.default_rng(0)
    size, per_class = (64, 200) if conv else (28, 400)
    data, labels = [], []
    for c in range(10):
        _, sample = digits_like_mixture([c], size=size)
        data.append(sample(rng, per_class))
        labels.append(np.full(per_class, c))
    data = np.concatenate(data)
    data = (np.repeat(data[..., None], 3, axis=-1) if conv
            else data.reshape(len(data), -1))
    return dirichlet_partition(data, np.concatenate(labels), num_users,
                               alpha=0.5, seed=0)


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


def _profile(sess, rounds: int, trace: str | None) -> dict:
    """A warm-up chunk, a timed window of four chunks, one profiled chunk
    of ``sess``."""
    sess.run(rounds)                                      # warm-up chunk
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sess.run(4 * rounds)
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t0) / 4
    steady_ms = res.step_time_s * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sess.run(rounds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if trace:
        prof.export_chrome_trace(trace)

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
    r = rounds
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
    busy = _busy_ms(intervals)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:15]
    own_ms = sum(v[1] for k, v in kernels.items()
                 if any(k.startswith(o) or f" {o}" in k or f"::{o}" in k
                        for o in _OWN))
    return {
        "wall_ms_per_round_unprofiled": plain_wall * 1e3 / r,
        "wall_ms_per_round_profiled": wall * 1e3 / r,
        "device_busy_ms_per_round": busy / r,
        "device_idle_share_unprofiled": 1.0 - busy / (plain_wall * 1e3),
        "steady_ms_per_round": steady_ms,
        "device_idle_share_steady": 1.0 - busy / r / steady_ms,
        "device_ops_per_round": launches / r,
        "own_kernels_ms_per_round": own_ms / r,
        "top_device_ops": [{"name": k[:80], "calls_per_round": v[0] / r,
                            "ms_per_round": v[1] / r} for k, v in top],
        "top_host_ops": [{"name": a.key[:60], "calls_per_round": a.count / r,
                          "self_cpu_ms_per_round":
                              a.self_cpu_time_total / 1e3 / r}
                         for a in host[:12]]}


def _replay_breakdown(sess, rounds: int, reps: int = 5) -> dict:
    """One chunk of the session's graph engine taken apart, best of
    ``reps``: the host's noise draws for the chunk, loading them and the
    reals into the graph's buffers, the ``replay()`` call itself, and the
    replay's device time between CUDA events (on the state as it stands)."""
    graphs = sess._driver.eng.graphs
    g, carry = graphs.graphs[rounds], graphs.carry
    shape = tuple(g.inputs["reals"].shape[1:])
    best = dict.fromkeys(("draw_ms", "load_ms", "replay_call_ms",
                          "replay_device_ms"), float("inf"))
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        draws = [graphs.draw(carry.generator, shape) for _ in range(rounds)]
        t1 = time.perf_counter()
        g.load(g.inputs, draws)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        start, end = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        start.record()
        t3 = time.perf_counter()
        g.graph.replay()
        t4 = time.perf_counter()
        end.record()
        torch.cuda.synchronize()
        for key, value in (("draw_ms", t1 - t0), ("load_ms", t2 - t1),
                           ("replay_call_ms", t4 - t3)):
            best[key] = min(best[key], value * 1e3)
        best["replay_device_ms"] = min(best["replay_device_ms"],
                                       start.elapsed_time(end))
    out = {f"{k}_per_round": v / rounds for k, v in best.items()}
    out["graph_lengths"] = sorted(graphs.graphs)
    return out


HOST_MODES = ("sync", "no_prefetch", "async", "superbatch", "stage_rows")


def _host_spec(mode: str, rounds: int) -> FederationSpec:
    return FederationSpec(
        "approach1", batch_size=64, eval_samples=0,
        engine=EngineSpec(rounds_per_jit=rounds,
                          fuse_store_rounds=mode == "superbatch"),
        participation=ParticipationSpec("uniform", cohort_size=8),
        backend=BackendSpec("host", async_rounds=int(mode == "async"),
                            prefetch=mode != "no_prefetch",
                            materialize_state=False),
        combine=CombineSpec("staleness_max_abs", compression=CompressionSpec(
            "topk_int8", stage_rows=mode == "stage_rows")))


def _host_stages(sess) -> dict:
    """Host clocks around the host stream's stages: the store's gathers
    (rows and residuals) and scatters, and the batch sampling.  Returns
    the accumulator (seconds), which the session's runs fill."""
    acc = dict.fromkeys(("gather", "scatter", "sample"), 0.0)

    def timed(fn, key):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                acc[key] += time.perf_counter() - t0
        return run

    be = sess._driver.backend
    be.gather_rows = timed(be.gather_rows, "gather")
    be.gather_residual = timed(be.gather_residual, "gather")
    be.scatter_rows = timed(be.scatter_rows, "scatter")
    sess._batch_cohort = timed(sess._batch_cohort, "sample")
    return acc


def _host_main(args, pair) -> dict:
    fcfg = DistGANConfig(num_users=args.users, upload_frac=0.1)
    dataset = _dataset(args.users)
    out = {}
    for mode in HOST_MODES:
        sess = FederationSession(pair, fcfg, dataset,
                                 _host_spec(mode, args.rounds))
        acc = _host_stages(sess)
        out[mode] = _profile(sess, args.rounds, None)
        run = 6 * args.rounds       # warm-up, window of 4, profiled chunk
        out[mode].update({f"host_{k}_ms_per_round": v * 1e3 / run
                          for k, v in acc.items()})
        del sess
    return out


def _spmd_main(args, pair) -> dict:
    """The spmd session at world size 1 (NCCL, file:// rendezvous in a
    temporary directory)."""
    import os
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_users_mesh

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method="file://" + os.path.join(
            tmp, "rendezvous"), rank=0, world_size=1)
        try:
            spec = dataclasses.replace(
                _host_spec("sync", args.rounds),
                participation=ParticipationSpec("uniform", cohort_size=1),
                backend=BackendSpec("spmd", materialize_state=False))
            sess = FederationSession(
                pair, DistGANConfig(num_users=args.users, upload_frac=0.1),
                _dataset(args.users), spec, mesh=make_users_mesh(1))
            acc = _host_stages(sess)
            out = _profile(sess, args.rounds, args.trace)
            run = 6 * args.rounds
            out.update({f"host_{k}_ms_per_round": v * 1e3 / run
                        for k, v in acc.items()})
            del sess
        finally:
            dist.destroy_process_group()
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=16)
    ap.add_argument("--users", type=int, default=None,
                    help="users (default 8; 256 with --host)")
    ap.add_argument("--codec", default="topk_int8")
    ap.add_argument("--stochastic", action="store_true")
    ap.add_argument("--conv", action="store_true",
                    help="the DCGAN pair at 64 x 64 x 3, 64 base filters")
    ap.add_argument("--trace", default=None)
    ap.add_argument("--host", action="store_true",
                    help="the host streaming backend, in each of its modes")
    ap.add_argument("--spmd", action="store_true",
                    help="the spmd backend at one NCCL rank")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_round needs a CUDA device")

    pair = (make_conv_pair(ConvGanConfig(image_size=64, channels=3, z_dim=100,
                                         base_filters=64)) if args.conv else
            make_mlp_pair(MLPGanConfig(data_dim=784, z_dim=64, g_hidden=256,
                                       d_hidden=256)))
    if args.spmd:
        args.users = args.users or 256
        print(json.dumps({"device": torch.cuda.get_device_name(0),
                          "users": args.users, "rounds": args.rounds,
                          "spmd": _spmd_main(args, pair)}))
        return
    if args.host:
        args.users = args.users or 256
        print(json.dumps({"device": torch.cuda.get_device_name(0),
                          "users": args.users, "rounds": args.rounds,
                          "host": _host_main(args, pair)}))
        return
    spec = FederationSpec(
        "approach1", batch_size=64, eval_samples=0,
        engine=EngineSpec(kind="fused", rounds_per_jit=args.rounds),
        combine=CombineSpec(compression=CompressionSpec(
            codec=args.codec, error_feedback=False,
            stochastic=args.stochastic)))
    args.users = args.users or 8
    fcfg = DistGANConfig(num_users=args.users, upload_frac=0.1)
    dataset = _dataset(args.users, args.conv)
    out = {"device": torch.cuda.get_device_name(0), "rounds": args.rounds,
           "codec": args.codec, "stochastic": args.stochastic,
           "pair": "conv" if args.conv else "mlp"}
    for name in ("graph", "eager"):
        sess = FederationSession(pair, fcfg, dataset, spec)
        if name == "eager":
            sess._driver.eng = make_eager_engine(pair, sess.fcfg,
                                                 "approach1")
        out[name] = _profile(sess, args.rounds,
                             args.trace if name == "graph" else None)
        if name == "graph":
            out[name]["breakdown"] = _replay_breakdown(sess, args.rounds)
        del sess
    print(json.dumps(out))


if __name__ == "__main__":
    main()
