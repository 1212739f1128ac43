"""Where the bf16 SSD scan's time goes on the GPU, and A/B of kernel sources.

    PYTHONPATH=src python -m repro_torch.profile_ssd [SOURCE[:FLAGS] ...]
        [--reps 50]

Runs the bf16 route of the SSD scan at mamba2-780m's full shape (B 4,
S 2048, H 48, P 64, G 1, N 128, chunk 256; inputs from a seed on the card)
for the package's own kernel (``package``, the default) and for each other
SOURCE (a copy of ``csrc/ssd_scan_wgmma.cu`` beside a copy of
``csrc/hopper.cuh``; FLAGS, separated by commas, are extra nvcc flags such
as ``-DNAME=1``), built with the package's nvcc flags.  Prints one JSON
line per source: its relative L2 error and max |diff| from the f32
recurrence (``ref.ssd_scan_ref``), the CTA count of each launch, the
CUDA-event ms (median of ``--reps`` after warm-up, host enqueue included)
of the whole call and of each of its three launches alone, timed in turns
(A, B, ..., B, A), and the device microseconds of each kernel from
``torch.profiler``.  The launches go straight to the C entry point, so none
is counted as a launch of the wrapper.  Needs a CUDA device and nvcc.
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
from repro_torch.timing import event_ms

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="*", default=["package"])
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_ssd needs a CUDA device")
    dev = torch.device("cuda")
    B, S, H, P, G, N, chunk = (SHAPE[k] for k in ("B", "S", "H", "P", "G",
                                                   "N", "chunk"))
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).to(dtype)

    x = randn((B, S, H, P), torch.bfloat16, 0.5)
    dt = F.softplus(randn((B, S, H)))
    A = -torch.exp(torch.rand((H,), generator=gen, device=dev))
    Bm = randn((B, S, G, N), torch.bfloat16, 0.3)
    Cm = randn((B, S, G, N), torch.bfloat16, 0.3)
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
