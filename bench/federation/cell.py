"""One run of a federation cell: set-up, the timed window, the check.

Set-up makes the images from the seed, builds the program's session and
makes the window's own call once: ``run(R)``, which captures the chunk
graphs that the window replays.  The check reads that call: its first
rounds' losses, and the state after it.  The window then calls ``run(R)``
again and again, as a training job does between checkpoints, until
``seconds`` have passed, and stops at the first call boundary after that.
With ``trace`` the session's batch draws are clocked over the window, and
``TRACE_CALLS`` more calls are profiled after it.  Once the memory peak
is read, the program is freed and the plain reference follows the checked
call from the same seed.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from bench import yardstick
from bench.federation import compare
from bench.federation import data as bdata
from bench.federation import program, reference

TRACE_CALLS = 1


def _window(sess, rounds_per_call: int, seconds: float | None,
            calls: int | None = None):
    """``run(R)`` until ``seconds`` have passed (or for ``calls`` calls);
    returns (rounds, wall seconds, rounds with a non-finite loss, each
    call's seconds).  Each result is dropped before the next call, so
    that two returned states are never alive at once."""
    rounds = bad = 0
    t0 = time.perf_counter()
    stamps = [t0]
    while True:
        res = sess.run(rounds_per_call)
        stamps.append(time.perf_counter())
        bad += int(np.sum(~np.isfinite(res.g_losses)
                          | ~np.all(np.isfinite(res.d_losses), axis=1)))
        del res
        rounds += rounds_per_call
        if (len(stamps) > calls if seconds is None
                else time.perf_counter() - t0 >= seconds):
            break
    if sess.device.type == "cuda":
        torch.cuda.synchronize()
    calls_s = [b - a for a, b in zip(stamps, stamps[1:])]
    return rounds, time.perf_counter() - t0, bad, calls_s


def run(config: dict, workload: dict, seed: int, seconds: float,
        trace: bool, device: torch.device, t_start: float) -> dict:
    cuda = device.type == "cuda"
    images, labels = bdata.images(seed, workload["data"]["images"],
                                  config["image_size"], config["channels"])
    sess = program.build(config, workload, seed, images, labels, device)
    R = workload["rounds_per_call"]
    prog = program.first_call(sess, R)          # captures the chunk graphs
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    clock = yardstick.HostClock()
    if cuda:
        setup_peak = torch.cuda.max_memory_reserved()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    if trace:
        from torch.profiler import record_function
        program.hook_batches(
            sess, lambda fn: clock.wrap(fn, "batch", record_function))
    rounds, wall, bad, calls_s = _window(sess, R, seconds)
    out = {"attempted": rounds, "failed": bad, "calls_s": calls_s,
           "end_to_end": {"round_ms": wall * 1e3 / rounds,
                          "setup_s": setup_s}}
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        with profile(activities=acts) as prof:
            with record_function("bench.window"):
                traced, _, bad, _ = _window(sess, R, None, TRACE_CALLS)
        members = workload["cohort"] or workload["users"]
        out["attempted"] += traced
        out["failed"] += bad
        out["trace"] = {
            "prof": prof, "rounds": traced, "round_s": wall / rounds,
            "batch_s": clock.seconds["batch"] / (rounds + traced),
            "members": members, "config": config,
            "flops": reference.load_model(workload["config"]).round_flops(
                config, members, workload["batch"])}
    if cuda:
        out["memory_peak_bytes"] = max(setup_peak,
                                       torch.cuda.max_memory_reserved())
        out["window_gb"] = (torch.cuda.max_memory_allocated() / 1e9,
                            torch.cuda.max_memory_reserved() / 1e9)

    del sess
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = reference.run(config, workload, seed, images, labels, R, device)
    out["checks"] = compare.gaps(prog, ref)
    return out
