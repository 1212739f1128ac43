"""The benchmark's general part: it finds a cell's workload, configuration
and code by name, checks the device, runs the cell, reads the
per-layer metrics from their readers, decides ``correct`` against the
cell's limits and builds the result line.

A cell ``<name>`` is ``workloads/<name>.json``; it names its configuration
(``configs/<config>.json``, with the plain model ``configs/<config>.py``
beside it) and its kind, whose code runs it (``bench/<kind>/cell.py``).
A per-layer metric ``<metric>`` is read by ``metrics/<metric>.py``'s
``read(ctx)``, which returns ``None`` when the trace holds nothing for it.
"""

from __future__ import annotations

import importlib
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent
MANIFEST = ROOT.parent / "BENCHMARK.json"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TOP = 10


def load_json(*parts) -> dict:
    return json.loads(ROOT.joinpath(*parts).read_text())


def manifest() -> dict:
    return json.loads(MANIFEST.read_text())


def cell_metrics(man: dict, cell: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that ``cell`` reports."""
    return [m for m in man[kind] if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def reduce_trace(prof, label: str = "bench.window") -> dict:
    """A profiler run reduced to what the readers take: the traced
    window's bounds (the ``label`` span), every device operation and every
    host operation as ``(name, start_us, end_us)``."""
    device, host, window = [], [], None
    for ev in prof.events():
        span = (ev.name, ev.time_range.start, ev.time_range.end)
        if ev.name.startswith("bench."):      # the benchmark's own labels
            if ev.name == label and ev.device_type.name == "CPU":
                window = span[1:]
            if ev.device_type.name == "CPU":
                host.append(span)
        elif ev.device_type.name == "CUDA":
            device.append(span)
        else:
            host.append(span)
    return {"device_ops": device, "host_ops": host, "window_us": window}


def breakdown(ctx: dict) -> dict:
    """The device operations that took most time, and the longest idle
    gaps, each named by the host operation that overlaps it most (the
    window's own label where none does)."""
    from bench import yardstick

    lo, hi = ctx["window_us"]
    total: dict[str, float] = {}
    for name, s, e in ctx["device_ops"]:
        total[name[:120]] = total.get(name[:120], 0.0) + (e - s) / 1e6
    ops = sorted(total.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(yardstick.idle_gaps(
        [(s, e) for _, s, e in ctx["device_ops"]], lo, hi),
        key=lambda g: g[0] - g[1])[:TOP]
    named = []
    for s, e in gaps:
        overlap: dict[str, float] = {}
        for n, hs, he in ctx["host_ops"]:
            if hs < e and he > s and n != "bench.window":
                overlap[n] = overlap.get(n, 0.0) + min(he, e) - max(hs, s)
        name = max(overlap, key=overlap.get) if overlap else "bench.window"
        named.append([name[:120], (e - s) / 1e6])
    return {"device_ops": [list(kv) for kv in ops], "idle_gaps": named}


def read_metric(name: str, ctx: dict):
    mod = importlib.import_module(f"bench.metrics.{name}")
    return mod.read(ctx)


def execute(cell: str, seed: int, seconds: float, trace: bool, t_start: float,
            *, device=None, workload: dict | None = None,
            config: dict | None = None) -> tuple[dict, list[str]]:
    """One run of ``cell``.  Returns the result line's object and the
    lines for standard error: the window's calls, then each compared
    number beside its limit.  ``device``
    ``None`` asks for the CUDA devices the cell needs (and raises
    ``SystemExit`` without them); a test passes ``"cpu"`` and may pass a
    ``workload`` and ``config`` of its own."""
    import torch

    man = manifest()
    entry = next(w for w in man["workloads"] if w["name"] == cell)
    workload = workload or load_json("workloads", f"{cell}.json")
    config = config or load_json("configs", f"{workload['config']}.json")
    if device is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < entry["chips"]):
            raise SystemExit(f"{cell} needs {entry['chips']} CUDA device(s)")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    runner = importlib.import_module(f"bench.{workload['kind']}.cell")
    out = runner.run(config, workload, seed, seconds, trace, device, t_start)

    if trace:
        ctx = dict(out["trace"])
        prof = ctx.pop("prof")
        metrics = {}
        if device.type == "cuda":          # no device trace on the CPU
            ctx.update(reduce_trace(prof))
            for m in cell_metrics(man, cell, "per_layer"):
                value = read_metric(m["name"], ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["end_to_end"][m["name"]],
                               "unit": m["unit"]}
                   for m in cell_metrics(man, cell, "end_to_end")
                   if m["name"] in out["end_to_end"]}

    limits = workload["limits"]
    checks = {name: {"value": value, "limit": limits.get(name)}
              for name, value in out["checks"].items()}
    correct = bool(checks) and all(
        c["limit"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": entry["chips"],
           "memory_peak_bytes": out.get("memory_peak_bytes", 0)}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if trace and "device_ops" in ctx:
        from bench import yardstick

        lo, hi = ctx["window_us"]
        dev["busy_s"] = yardstick.busy_us(yardstick.clip(
            [(s, e) for _, s, e in ctx["device_ops"]], lo, hi)) / 1e6
        dev["window_s"] = (hi - lo) / 1e6
        result["breakdown"] = breakdown(ctx)
    result["checks"] = checks
    calls = sorted(out["calls_s"])
    lines = [f"window: {len(calls)} calls, s a call min {calls[0]!r} "
             f"median {calls[len(calls) // 2]!r} max {calls[-1]!r}; "
             f"allocated and reserved GB {out.get('window_gb')!r}"]
    lines += [f"check {name} {c['value']!r} limit {c['limit']!r}"
              for name, c in checks.items()]
    return result, lines
