"""Device time of the f32 flash-attention route on the GPU.

    PYTHONPATH=src python -m repro_torch.profile_flash [--src OTHER/src]
        [--request] [--reps 30]

Runs the f32 route of flash attention through its public wrapper
(``flash_attention.flash_attention``) at tinyllama-1.1b's full shape (q
4 x 2048 x 32 x 64, k/v 4 x 2048 x 4 x 64, causal; inputs from a seed on
the card).  ``--src`` times the kernels of another source tree instead (for
example the parent commit unpacked with ``git archive``): its
``repro_torch`` is imported in place of this one, so two versions can be
timed in turns on one card, each in its own process.  Prints one JSON line:

* ``event_ms``: CUDA-event time of one call, host enqueue included (median
  of ``--reps`` after warm-up);
* ``device_ms``: ``--reps`` calls captured in one CUDA graph, the replay
  timed with events and divided by ``--reps``;
* ``max_abs_err``: against the plain version (``ref.flash_attention_ref``);
* ``emulated_err`` (this tree only): the max |diff| of the split-TF32
  emulation (``ref.flash_attention_tf32_emulation``, exact exponentials,
  dense softmax) on the same inputs, its sums in f32 and on the tensor
  cores (``profile_common.emulated_err``).

``--request`` adds the host ms of three tinyllama-1.1b scoring requests of
4 x 2048 tokens with f32 weights and the kernel on
(``profile_common.lm_request_ms``).  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import json

import torch

from repro_torch.profile_common import (emulated_err, import_tree,
                                       lm_request_ms)
from repro_torch.timing import event_ms, graph_ms

SHAPE = dict(B=4, S=2048, H=32, K=4, hd=64)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", help="source tree whose kernels to time "
                                  "(default: this one)")
    ap.add_argument("--request", action="store_true")
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_flash needs a CUDA device")
    if args.src:
        import_tree(args.src)
    from repro_torch.kernels import ref
    from repro_torch.kernels import flash_attention as tfl

    dev = torch.device("cuda")
    B, S, H, K, hd = (SHAPE[k] for k in ("B", "S", "H", "K", "hd"))
    gen = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn((B, S, H, hd), generator=gen, device=dev)
    k = torch.randn((B, S, K, hd), generator=gen, device=dev)
    v = torch.randn((B, S, K, hd), generator=gen, device=dev)
    want = ref.flash_attention_ref(q, k, v, causal=True)

    def call():
        return tfl.flash_attention(q, k, v, causal=True)

    row = {"kernel": "flash_attention_f32", "src": args.src or "package",
           "shape": SHAPE, "device": torch.cuda.get_device_name(0),
           "max_abs_err": float((call() - want).abs().max()),
           "event_ms": event_ms(call, args.reps),
           "device_ms": graph_ms(call, args.reps)}
    if not args.src:
        row["emulated_err"] = emulated_err(
            lambda: ref.flash_attention_tf32_emulation(q, k, v, causal=True),
            want)
    print(json.dumps(row), flush=True)
    del q, k, v, want
    torch.cuda.empty_cache()
    if args.request:
        print(json.dumps({"request": "tinyllama-1.1b f32 4x2048",
                          "src": args.src or "package",
                          "device": torch.cuda.get_device_name(0),
                          "ms": lm_request_ms("tinyllama-1.1b",
                                              "use_flash")}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
