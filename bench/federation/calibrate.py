"""The readings that a federation cell's limits are set from, on the chip at
the cell's own size (no measured window: the numbers compare the first
rounds):

    PYTHONPATH=src python3 -m bench.federation.calibrate --workload <cell> \
        --seeds <n> ... --control-seeds <n> ... [--out <file.json>]

For each of ``--seeds`` the program's readings (the window's own call,
``run(R)``, as a run's set-up makes it) against the plain reference; for
each of ``--control-seeds`` the control (the reference in TF32, in the
program's place) and the planted faults (``reference.run``'s ``fault``,
in the reference put in the program's place) against the reference.
Prints one JSON line a reading and a summary: each number's largest
reading over the program's seeds and its smallest over the control's and
each fault's.
"""

from __future__ import annotations

import argparse
import gc
import json
import pathlib
import sys
import time

import torch

from bench import harness
from bench.federation import compare
from bench.federation import data as bdata
from bench.federation import program, reference

FAULTS = ("half_batch", "chunk_batch")


def program_reading(config, workload, seed, device) -> dict:
    images, labels = bdata.images(seed, workload["data"]["images"],
                                  config["image_size"], config["channels"])
    sess = program.build(config, workload, seed, images, labels, device)
    rounds = workload["rounds_per_call"]
    prog = program.first_call(sess, rounds)
    del sess
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference.run(config, workload, seed, images, labels, rounds,
                        device)
    return compare.gaps(prog, ref)


def planted_readings(config, workload, seed, device) -> dict:
    """``{"control": gaps, <fault>: gaps, ...}`` of the reference put in
    the program's place."""
    images, labels = bdata.images(seed, workload["data"]["images"],
                                  config["image_size"], config["channels"])
    args = (config, workload, seed, images, labels,
            workload["rounds_per_call"], device)
    ref = reference.run(*args)
    out = {"control": compare.gaps(reference.run(*args, prec="tf32"), ref)}
    for fault in FAULTS:
        out[fault] = compare.gaps(reference.run(*args, fault=fault), ref)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    workload = harness.load_json("workloads", f"{args.workload}.json")
    config = harness.load_json("configs", f"{workload['config']}.json")
    device = torch.device("cuda", 0)
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        rows.append({"kind": "program", "seed": seed,
                     **program_reading(config, workload, seed, device),
                     "s": time.perf_counter() - t0})
        print(json.dumps(rows[-1]), flush=True)
    for seed in args.control_seeds:
        for kind, gaps in planted_readings(config, workload, seed,
                                           device).items():
            rows.append({"kind": kind, "seed": seed, **gaps})
            print(json.dumps(rows[-1]), flush=True)
    names = compare.NAMES
    summary = {"workload": args.workload,
               "device": (torch.cuda.get_device_name(device)
                          if device.type == "cuda" else "cpu"),
               "lower": {n: max(r[n] for r in rows if r["kind"] == "program")
                         for n in names}}
    for kind in ("control",) + FAULTS:
        summary[kind] = {n: min(r[n] for r in rows if r["kind"] == kind)
                         for n in names}
    print(json.dumps(summary), flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(
            json.dumps({"rows": rows, "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
