"""BENCHMARK.json against the files it names: every cell resolves to its
workload, configuration, plain model and code by name, every per-layer
metric to its reader, and every name and unit keeps to its characters."""

import json
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CHECKS = ("init_gap", "loss_gap", "chunk_loss_gap", "step_gap", "state_gap")


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda w: w["name"])
def test_cell_resolves_by_name(cell):
    w = json.loads((BENCH / "workloads" / f"{cell['name']}.json").read_text())
    assert w["name"] == cell["name"] and w["config"] == cell["config"]
    assert (BENCH / w["kind"] / "cell.py").is_file()
    assert (BENCH / "configs" / f"{w['config']}.json").is_file()
    assert (BENCH / "configs" / f"{w['config']}.py").is_file()
    assert cell["config"] in {c["name"] for c in MAN["configs"]}
    assert cell["chips"] in (1, 4) and 1 <= len(cell["why"]) <= 200
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert set(m.get("workloads", [])) <= {x["name"] for x in
                                                MAN["workloads"]}
    limits = w["limits"]
    assert set(limits) == set(CHECKS)
    assert limits["init_gap"] == limits["step_gap"] == 0.0


def test_metrics_resolve_by_name():
    for m in MAN["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]
        assert m["moves"] in {e["name"] for e in MAN["end_to_end"]}
    assert "setup_s" in {e["name"] for e in MAN["end_to_end"]}


def test_configs_name_their_files():
    for c in MAN["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and path.is_relative_to(BENCH)
        assert json.loads(path.read_text())["name"] == c["name"]
        assert c["source"].startswith("https://")


def test_names_and_units_keep_to_their_characters():
    names = [x["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in MAN[key]]
    names += [w[k] for w in MAN["workloads"] for k in ("config", "traffic")]
    names += [k for c in MAN["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = [x["name"] for x in MAN[key]]
        assert len(seen) == len(set(seen)), key
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in MAN["end_to_end"]:
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock",
                                                          "device_trace")
    for p in BENCH.rglob("*"):
        rel = p.relative_to(ROOT).as_posix()
        if "__pycache__" not in rel:
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_readers_read_a_trace_and_return_none_on_nothing():
    import importlib
    import sys

    sys.path.insert(0, str(ROOT))
    names = [m["name"] for m in MAN["per_layer"]]
    ops = [("void (anonymous namespace)::topk_mask_cluster<true>(float)",
            0.0, 40.0),
           ("void (anonymous namespace)::quantize_cluster<true, false>()",
            40.0, 70.0),
           ("dequantize(signed char const*, long long)", 70.0, 90.0),
           ("void at::native::elementwise_kernel<128>", 160.0, 170.0)]
    config = json.loads((BENCH / "configs" / "paper-mlp.json").read_text())
    ctx = {"window_us": (0.0, 200.0), "device_ops": ops, "rounds": 1,
           "round_s": 400e-6, "members": 8, "batch_s": 2e-5,
           "config": config, "flops": {"total": 1e8}}
    read = {n: importlib.import_module(f"bench.metrics.{n}").read
            for n in names}
    got = {n: f(ctx) for n, f in read.items()}
    rows = 8 * 267009
    expect = {"idle_share": 1 - 100 / 400, "batch_ms": 2e-2,
              "mfu": 100 * 1e8 / (400e-6 * 67e12),
              "topk_roofline": 100 * 5 * rows / 3.35e12 / 40e-6,
              "codec_roofline": 100 * (10 * rows + 64) / 3.35e12 / 50e-6}
    assert got.keys() == expect.keys()
    for n, v in expect.items():
        assert abs(got[n] - v) <= 1e-9 * v, (n, got[n], v)
    empty = dict(ctx, device_ops=[], batch_s=0.0)
    assert all(f(empty) is None for n, f in read.items()
               if n != "mfu"), {n: f(empty) for n, f in read.items()}
