"""Bucket invariance and dispatch time of the GAN sampler on the GPU.

    PYTHONPATH=src python -m repro_torch.profile_serve [--reps 20]
        [--chunks 16,none]

Builds ``serve.sampler.SamplerEngine`` over the paper's MLP pair
(784/256/256, z 64) and the DCGAN pair at 64 x 64 x 3 (64 filters, z 100),
random weights from a seed, on the ladder of ``ServeSpec(max_batch=128)``,
once for each ``--chunks`` entry:

* a number n (``chunk<n>``): G and D applied in zero-padded chunks of n
  rows, so every call has one shape whatever the bucket (the engine serves
  with ``ROW_CHUNK`` = 32);
* ``none`` (``bucket``): ``row_chunk=None``, one G (or D) call over the
  whole bucket.

For each pair and form it prints one JSON line, after the card's name and
power limit:

* ``slot_max_abs``: per bucket, the max |diff| between one slot served
  alone in bucket 1 and the same slot last among random batch-mates in
  that bucket (0.0 = bitwise);
* ``score_max_abs``: the same for D's score of one image;
* ``dispatch_ms``: CUDA-event time of one ``sample_bucket`` call (input
  loads, graph replay, the output's copy; host enqueue included), median
  of ``--reps``;
* ``replay_ms``: the same for the graph replay alone.

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from repro_torch.core.gan import (ConvGanConfig, MLPGanConfig,
                                  make_conv_pair, make_mlp_pair)
from repro_torch.core.spec import ServeSpec
from repro_torch.serve.sampler import ROW_CHUNK, SamplerEngine
from repro_torch.timing import event_ms

PAIRS = {
    "mlp": lambda: make_mlp_pair(MLPGanConfig(data_dim=784, z_dim=64,
                                              g_hidden=256, d_hidden=256)),
    "dcgan": lambda: make_conv_pair(ConvGanConfig(
        image_size=64, channels=3, z_dim=100, base_filters=64)),
}


def _slot_diffs(eng, g, ladder, rng) -> dict:
    want = eng.sample_bucket(g, 1, [12345], [678], [9])[0]
    out = {}
    for b in ladder:
        mates = rng.integers(0, 2**31, (3, b - 1))
        got = eng.sample_bucket(g, b, list(mates[0]) + [12345],
                                list(mates[1]) + [678],
                                list(mates[2] % 500) + [9])[b - 1]
        out[b] = float((got - want).abs().max())
    return out


def _score_diffs(eng, d, x, ladder) -> dict:
    first = eng.score_bucket(d, x[:1])[0]
    return {b: float(np.abs(eng.score_bucket(d, x[:b])[0] - first))
            for b in ladder}


def _times(eng, g, ladder, reps) -> tuple[dict, dict]:
    dispatch, replay = {}, {}
    for b in ladder:
        n = list(range(b))
        dispatch[b] = event_ms(
            lambda: eng.sample_bucket(g, b, [7] * b, n, n), reps=reps, warm=3)
        prog = eng._request_progs[b]
        replay[b] = event_ms(prog, reps=reps, warm=3)
    return dispatch, replay


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--chunks", default=f"{ROW_CHUNK},none")
    args = ap.parse_args(argv)
    forms = {("bucket" if c == "none" else f"chunk{c}"):
             (None if c == "none" else int(c))
             for c in args.chunks.split(",")}
    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    ladder = ServeSpec(max_batch=128).buckets()
    for name, make in PAIRS.items():
        pair = make()
        g, d = pair.init(torch.Generator().manual_seed(0), dev)
        for form, chunk in forms.items():
            eng = SamplerEngine(pair, ladder, device=dev, row_chunk=chunk)
            rng = np.random.default_rng(0)
            slot = _slot_diffs(eng, g, ladder, rng)
            x = eng.sample_request(g, 3, 7, ladder[-1])
            score = _score_diffs(eng, d, x, ladder)
            dispatch, replay = _times(eng, g, ladder, args.reps)
            print(json.dumps({
                "pair": name, "form": form, "buckets": list(ladder),
                "slot_max_abs": slot, "score_max_abs": score,
                "bitwise": not any(slot.values()) and not any(score.values()),
                "dispatch_ms": dispatch, "replay_ms": replay}), flush=True)
            del eng
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
