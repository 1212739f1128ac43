"""Where the SSD scan's time goes on the GPU, and A/B of kernel builds.

    PYTHONPATH=src python -m repro_torch.profile_ssd [SOURCE[:FLAGS] ...]
        [--reps 50]
    PYTHONPATH=src python -m repro_torch.profile_ssd --f32 [--src OTHER/src]
        [--request] [--reps 30]

Both run at mamba2-780m's full shape (B 4, S 2048, H 48, P 64, G 1, N 128,
chunk 256; inputs from a seed on the card).

The bf16 route (default): the package's own kernel (``package``) and each
other SOURCE (a copy of ``csrc/ssd_scan_wgmma.cu`` beside a copy of
``csrc/hopper.cuh``; FLAGS, separated by commas, are extra nvcc flags such
as ``-DNAME=1``), built with the package's nvcc flags.  Prints one JSON
line per source: its relative L2 error and max |diff| from the f32
recurrence (``ref.ssd_scan_ref``), the CTA count of each launch, the
CUDA-event ms (median of ``--reps`` after warm-up, host enqueue included)
of the whole call and of each of its three launches alone, timed in turns
(A, B, ..., B, A), and the device microseconds of each kernel from
``torch.profiler``.  The launches go straight to the C entry point, so none
is counted as a launch of the wrapper.

``--f32``: the f32 route through its public wrapper (``ssd_scan.ssd_scan``
on f32 inputs): max |diff| from ``ref.ssd_scan_ref``, event ms and device
ms (``--reps`` calls captured in one CUDA graph).  ``--src`` times another
source tree's f32 route instead (for example the parent commit unpacked
with ``git archive``; its ``repro_torch`` is imported in place of this
one), so two versions can be timed in turns on one card, each in its own
process.  In this tree it also prints the device ms of each of the four
launches for the wrapper's plan (``ssd_scan.tf32_plan``) and the max
|diff| of the split-TF32 emulation (``ref.ssd_scan_tf32_emulation``, exact
exponentials) on the same inputs, its sums in f32 and on the tensor cores
(``allow_tf32``: products of TF32 values are exact, so only the sums
differ).  ``--request`` adds the host ms of three mamba2-780m scoring
requests of 4 x 2048 tokens with f32 weights and the kernel on.  Needs a
CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
from pathlib import Path

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from repro_torch.kernels import build, ref
from repro_torch.kernels import ssd_scan as tss
from repro_torch.profile_common import (emulated_err, import_tree,
                                       lm_request_ms)
from repro_torch.timing import event_ms, graph_ms

SHAPE = dict(B=4, S=2048, H=48, P=64, G=1, N=128, chunk=256)


def _build(spec: str, tag: str):
    """The C entry point of one source (``path[:flag,flag]``)."""
    path, _, flags = spec.partition(":")
    lib = build.load_variant("ssd_scan_wgmma", f"profile_ssd_{tag}",
                             tuple(f for f in flags.split(",") if f),
                             Path(path))
    fn = lib.ssd_scan_wgmma_fwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


class Runner:
    """Calls one C entry point of the bf16 route on fixed bf16 inputs x
    (B,S,H,P), Bm/Cm (B,S,G,N) and f32 dt, A, with its own scratch."""

    def __init__(self, entry, x, dt, A, Bm, Cm, chunk):
        self.entry, self.args = entry, (x, dt, A, Bm, Cm)
        self.chunk = chunk
        B, S, H, P = x.shape
        self.dims = (B, S, H, P, Bm.shape[2], Bm.shape[3])
        self.scratch = tss.wgmma_scratch(B, S, H, P, Bm.shape[3], chunk,
                                         x.device)
        self.y = torch.empty_like(x)

    def __call__(self, phases: int = tss.ALL_PHASES) -> torch.Tensor:
        x, dt, A, Bm, Cm = self.args
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = self.entry(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                        Bm.data_ptr(), Cm.data_ptr(), self.y.data_ptr(),
                        *(t.data_ptr() for t in self.scratch), *self.dims,
                        self.chunk, phases, stream)
        build.check(rc, "ssd_scan_wgmma")
        return self.y

    def launch_ms(self, reps: int) -> dict[str, float]:
        """Event ms of the whole call and of each launch alone."""
        self()          # the scratch the later launches read
        out = {"all": event_ms(self, reps)}
        for name, mask in tss.PHASES.items():
            out[name] = event_ms(lambda m=mask: self(m), reps)
        return out


class F32Runner:
    """Calls the f32 route's C entry point with the wrapper's plan on fixed
    f32 inputs, with its own scratch (this tree only)."""

    def __init__(self, x, dt, A, Bm, Cm, chunk):
        self.entry, self.args, self.chunk = tss.tf32_entry(), (x, dt, A, Bm,
                                                               Cm), chunk
        B, S, H, P = x.shape
        self.dims = (B, S, H, P, Bm.shape[2], Bm.shape[3])
        self.plan = tss.tf32_plan_args(tss.tf32_plan(
            P, Bm.shape[3], chunk, tss.smem_limit(x.device)))
        self.scratch = tss.tf32_scratch(B, S, H, P, *Bm.shape[2:], chunk,
                                        x.device)
        self.y = torch.empty_like(x)

    def __call__(self, phases: int = tss.TF32_ALL_PHASES) -> torch.Tensor:
        x, dt, A, Bm, Cm = self.args
        rc = self.entry(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                        Bm.data_ptr(), Cm.data_ptr(), self.y.data_ptr(),
                        *(t.data_ptr() for t in self.scratch), *self.dims,
                        self.chunk, *self.plan, phases,
                        torch.cuda.current_stream().cuda_stream)
        build.check(rc, "ssd_scan_tf32")
        return self.y

    def phase_ms(self, reps: int) -> dict[str, float]:
        """Device ms of the whole call and of each launch alone (after a
        full call, so each reads what the launch before it wrote)."""
        self()
        out = {"all": graph_ms(self, reps)}
        for name, mask in tss.TF32_PHASES.items():
            out[name] = graph_ms(lambda m=mask: self(m), reps)
        return out


def _inputs(dtype):
    dev = torch.device("cuda")
    B, S, H, P, G, N = (SHAPE[k] for k in ("B", "S", "H", "P", "G", "N"))
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).to(dtype)

    x = randn((B, S, H, P), dtype, 0.5)
    dt = F.softplus(randn((B, S, H)))
    A = -torch.exp(torch.rand((H,), generator=gen, device=dev))
    Bm = randn((B, S, G, N), dtype, 0.3)
    Cm = randn((B, S, G, N), dtype, 0.3)
    return x, dt, A, Bm, Cm


def f32_main(args) -> int:
    if args.src:
        import_tree(args.src)
    # this tree's kernels or, after import_tree, the other tree's
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as tss
    chunk = SHAPE["chunk"]
    x, dt, A, Bm, Cm = _inputs(torch.float32)
    want = ref.ssd_scan_ref(x, dt, A, Bm, Cm)

    def call():
        return tss.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)

    print(json.dumps({
        "kernel": "ssd_scan_f32", "src": args.src or "package",
        "shape": SHAPE, "device": torch.cuda.get_device_name(0),
        "max_abs_err": float((call() - want).abs().max()),
        "event_ms": event_ms(call, args.reps),
        "device_ms": graph_ms(call, args.reps)}), flush=True)
    if not args.src:
        runner = F32Runner(x, dt, A, Bm, Cm, chunk)
        print(json.dumps({
            "plan": runner.plan, "device_ms": runner.phase_ms(args.reps),
            "emulated_err": emulated_err(
                lambda: ref.ssd_scan_tf32_emulation(x, dt, A, Bm, Cm, chunk),
                want)}), flush=True)
        del runner
    del x, dt, A, Bm, Cm, want
    torch.cuda.empty_cache()
    if args.request:
        print(json.dumps({"request": "mamba2-780m f32 4x2048",
                          "src": args.src or "package",
                          "device": torch.cuda.get_device_name(0),
                          "ms": lm_request_ms("mamba2-780m",
                                              "use_ssm_kernel")}),
              flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="*", default=["package"])
    ap.add_argument("--reps", type=int, default=None)
    ap.add_argument("--f32", action="store_true",
                    help="time the f32 route (see the module docstring)")
    ap.add_argument("--src", help="with --f32: source tree whose f32 route "
                                  "to time (default: this one)")
    ap.add_argument("--request", action="store_true",
                    help="with --f32: time f32 mamba2-780m requests too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_ssd needs a CUDA device")
    if args.f32:
        args.reps = args.reps or 30
        return f32_main(args)
    args.reps = args.reps or 50
    B, S, H, P, G, N, chunk = (SHAPE[k] for k in ("B", "S", "H", "P", "G",
                                                   "N", "chunk"))
    x, dt, A, Bm, Cm = _inputs(torch.bfloat16)
    truth = ref.ssd_scan_ref(x.float(), dt, A, Bm.float(), Cm.float())
    runners = [Runner(tss.wgmma_entry() if spec == "package"
                      else _build(spec, str(i)), x, dt, A, Bm, Cm, chunk)
               for i, spec in enumerate(args.sources)]

    rows = []
    for spec, run in zip(args.sources, runners):
        diff = run().double() - truth.double()
        rows.append({"source": spec, "shape": SHAPE,
                     "ctas": tss.wgmma_ctas(B, S, H, P, N, chunk),
                     "rel_l2": float(diff.norm() / truth.double().norm()),
                     "max_abs": float(diff.abs().max()), "event_ms": []})
    order = list(range(len(runners)))
    for i in order + order[::-1]:
        rows[i]["event_ms"].append(runners[i].launch_ms(args.reps))
    for row, run in zip(rows, runners):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                run()
            torch.cuda.synchronize()
        row["device_us"] = {
            ev.key[ev.key.index("ssd_"):].split("(")[0].split("<")[0]:
                ev.device_time for ev in prof.key_averages()
            if "ssd_" in ev.key}
    for row in rows:
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
