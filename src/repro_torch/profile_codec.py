"""Device time of the federation round's two kernels on the GPU.

    PYTHONPATH=src python -m repro_torch.profile_codec [--reps 30]
        [--src OTHER/src] [--stamps] [--block]

Runs the global top-k mask (``topk_select.topk_mask_rows``), the int8
row codec (``quantize.quantize_rows`` deterministic and stochastic,
``quantize.dequantize_rows``) and the block-local top-k mask
(``topk_select.topk_mask_block_rows``) through their public wrappers at the
main path's shape: 8 rows of 267,009 f32 (the D rows of 8 users of the
784/256/256 MLP discriminator), upload fraction 0.1, inputs from a seed on
the card.  The block top-k is also timed at 8 rows of 675,584 (the conv
D's width), beside two yardsticks at both shapes: ``copy_floor``, one
PyTorch elementwise kernel that reads the same f32 and writes the bools
(``torch.ge(x, 0)``), the floor that the bytes and one launch set; and
``library``, ``torch.topk`` over the zero-padded 8192-slices and a compare.
``--block`` runs only the block top-k's lines.  ``--src`` times the
kernels of another source tree instead (for example the parent commit
unpacked with ``git archive``): its ``repro_torch`` is imported in place of
this one, so two versions can be timed in turns on one card, each in its
own process.  Prints one JSON line per kernel:

* ``event_ms``: CUDA-event time of one call, host enqueue included (median
  of ``--reps`` after warm-up), what the host-bound round pays;
* ``device_ms``: ``--reps`` calls captured in one ``torch.cuda.CUDAGraph``,
  the replay timed with events and divided by ``--reps``: device time per
  call without the host;
* ``device_us``: ``torch.profiler`` device microseconds per call, by
  kernel name (memsets included);
* ``exact``: the result equals the plain version in ``kernels/ref.py``.

``--stamps`` instead builds this tree's ``csrc/topk_select.cu``,
``csrc/quantize.cu`` and ``csrc/topk_block.cu`` with ``STAMP_FLAGS`` into
libraries of their own (``build.load_variant``) and prints, per kernel, the
SM clock cycles between the stamps that thread 0 of the first CTA of the
first row records at the end of each phase (``csrc/row_cluster.cuh``),
from one launch after warm-up.

Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json

import torch

from repro_torch.profile_common import import_tree
from repro_torch.timing import event_ms, graph_ms

MAIN_ROWS, MAIN_N, FRAC, SEED = 8, 267009, 0.1, 123
CONV_N = 675584              # the conv D's width (core/gan.py, 64 filters)
STAMP_FLAGS = ("-DROW_CLUSTER_STAMPS",)

# phase names of the stamps, in stamp order (csrc/topk_select.cu, quantize.cu)
TOPK_PHASES = ["load issued"] + [
    f"pass {p}: {what}" for p in range(4)
    for what in ("swept", "columns summed", "pushed + barrier", "picked")
] + ["mask stored"]
QUANT_PHASES = ["loaded + max (+ SR hashes)", "pushed + barrier", "scale",
                "coded + stored"]
BLOCK_PHASES = ["loads issued", "pass 0 counted"] + [
    what for p in range(4) for what in (
        (f"pick {p}", f"pass {p + 1} counted") if p < 3 else (f"pick {p}",))
] + ["candidates gathered", "v_k selected", "32-step replay", "mask stored"]


def profiler_us(fn, reps: int) -> dict[str, float]:
    """``torch.profiler`` device microseconds per call, by kernel name."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {ev.key[:60]: ev.device_time_total / reps
            for ev in prof.key_averages() if ev.device_time_total > 0}


def stamps(x) -> None:
    """Cycles between the phase stamps of the top-k and quantize kernels
    (the package's own C interfaces and inputs)."""
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import quantize as tq
    from repro_torch.kernels import topk_select as tt
    rows, n = x.shape
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty((rows, n), dtype=torch.bool, device=x.device)
    q = torch.empty((rows, n), dtype=torch.int8, device=x.device)
    scale = torch.empty((rows,), dtype=torch.float32, device=x.device)
    topk_lib = build.load_variant("topk_select", "stamps", STAMP_FLAGS)
    quant_lib = build.load_variant("quantize", "stamps", STAMP_FLAGS)
    block_lib = build.load_variant("topk_block", "stamps", STAMP_FLAGS)
    topk, (quant, _) = tt.bind(topk_lib), tq.bind(quant_lib)
    block = tt.bind_block(block_lib)
    runs = [("topk_mask_rows", topk_lib, TOPK_PHASES,
             lambda: topk(x.data_ptr(), out.data_ptr(), rows, n,
                          ref.topk_k(n, FRAC), stream)),
            ("topk_mask_block", block_lib, BLOCK_PHASES,
             lambda: block(x.data_ptr(), out.data_ptr(), rows, n,
                           ref.topk_k(ref.BLOCK, FRAC), stream))]
    for stochastic in (False, True):
        runs.append((
            "quantize_rows" + ("_stochastic" if stochastic else ""),
            quant_lib, QUANT_PHASES,
            lambda sr=stochastic: quant(
                x.data_ptr(), q.data_ptr(), scale.data_ptr(), rows, n,
                int(sr), None, SEED, stream)))
    host = (ctypes.c_longlong * 32)()
    for name, lib, phases, launch in runs:
        for _ in range(3):
            build.check(launch(), name)
        torch.cuda.synchronize()
        build.check(lib.row_cluster_stamps(host), "row_cluster_stamps")
        build.check(launch(), name)
        torch.cuda.synchronize()
        build.check(lib.row_cluster_stamps(host), "row_cluster_stamps")
        t = list(host)
        cycles, last = {}, 0            # an early stop leaves passes unset
        for i, phase in enumerate(phases, start=1):
            if t[i]:
                cycles[phase] = t[i] - t[last]
                last = i
        print(json.dumps({"kernel": name, "stamps_of": "thread 0, CTA 0, row 0",
                          "shape": [rows, n],
                          "device": torch.cuda.get_device_name(0),
                          "cycles": cycles, "total_cycles": t[last] - t[0]}),
              flush=True)


def main_input(dev, n=MAIN_N):
    """(MAIN_ROWS, n) rows: N(0, 2e-4), one row of ties at 5e-5 steps,
    one half-zero row."""
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((MAIN_ROWS, n), generator=gen, device=dev) * 2e-4
    x[1] = torch.round(x[1] * 2e4) / 2e4
    x[5, : n // 2] = 0.0
    return x


def block_library(x, frac):
    """``torch.topk`` over the zero-padded 8192-slices of ``x`` and a
    compare: one PyTorch call's worth of the block top-k, a yardstick."""
    from repro_torch.kernels.ref import BLOCK, topk_k
    rows, n = x.shape
    mag = torch.nn.functional.pad(x.abs(), (0, (-n) % BLOCK)).view(-1, BLOCK)
    kth = torch.topk(mag, topk_k(BLOCK, frac), dim=1).values[:, -1:]
    return (mag >= kth).view(rows, -1)[:, :n]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", help="source tree whose kernels to time "
                                  "(default: this one)")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--stamps", action="store_true",
                    help="print the phase stamps of the kernels instead")
    ap.add_argument("--block", action="store_true",
                    help="time only the block top-k and its yardsticks")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_codec needs a CUDA device")
    if args.src:
        import_tree(args.src)
    from repro_torch.kernels import quantize as tq
    from repro_torch.kernels import ref
    from repro_torch.kernels import topk_select as tt

    x = main_input(torch.device("cuda"))
    if args.stamps:
        stamps(x)
        return 0
    conv = main_input(torch.device("cuda"), CONV_N)
    cases = {}
    for tag, rows in (("", x), ("_conv_d", conv)):
        cases["topk_mask_block" + tag] = (
            lambda r=rows: tt.topk_mask_block_rows(r, FRAC),
            lambda r=rows: ref.topk_mask_block_ref(r, FRAC))
        cases["copy_floor" + tag] = (lambda r=rows: torch.ge(r, 0.0), None)
        cases["library_block" + tag] = (
            lambda r=rows: block_library(r, FRAC), None)
    if args.block:
        return run(cases, args)
    q, s = tq.quantize_rows(x)
    cases |= {
        "topk_mask_rows": (lambda: tt.topk_mask_rows(x, FRAC),
                           lambda: ref.topk_mask_global_ref(x, FRAC)),
        "quantize_rows": (lambda: tq.quantize_rows(x),
                          lambda: ref.quantize_rows_ref(x)),
        "quantize_rows_stochastic": (
            lambda: tq.quantize_rows(x, stochastic=True, seed=SEED),
            lambda: ref.quantize_rows_ref(x, stochastic=True, seed=SEED)),
        "dequantize_rows": (lambda: tq.dequantize_rows(q, s),
                            lambda: ref.dequantize_rows_ref(q, s)),
    }
    return run(cases, args)


def run(cases, args) -> int:
    """Times each case and prints its JSON line; ``exact`` compares with
    the plain version where the case has one."""
    for name, (kern, plain) in cases.items():
        got = kern()
        exact = None
        if plain is not None:
            want = plain()
            if isinstance(got, tuple):
                exact = all(torch.equal(a, b) for a, b in zip(got, want))
            else:
                exact = torch.equal(got, want)
        shape = got[0].shape if isinstance(got, tuple) else got.shape
        print(json.dumps({
            "kernel": name, "src": args.src or "package",
            "shape": list(shape),
            "device": torch.cuda.get_device_name(0), "exact": exact,
            "event_ms": event_ms(kern, args.reps),
            "device_ms": graph_ms(kern, args.reps),
            "device_us": profiler_us(kern, args.reps)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
