"""Compressed delta transport on the PyTorch port: sweep the upload codecs
over the host-resident store at U=64 and U=512.

Every round each cohort member ships one flat D-delta row; the
``CompressionSpec`` section of ``CombineSpec`` sets what actually crosses
the wire — dense float32 (``none``), a bf16 cast, int8 with a per-row
absmax scale, or ``topk_int8`` composed with the top-k selection (int32
indices + int8 codes + one f32 scale).  Lossy codecs keep a per-user
``(U, N)`` error-feedback residual (EF-SGD): the quantization error of
round k is re-added to the user's round-k+1 delta.  The run reports the
PRICED bytes a round (``upload_bytes_flat``, the one pricing table), the
measured host stall, and 8-Gaussian mode coverage with EF on and off.

Each round launches one top-k mask (B1) over the cohort's 8 rows; the
``int8`` and ``topk_int8`` runs also launch one int8 quantize and one
dequantize (B2) a round.  The round's program and the host gather /
scatter touch only the C=8 cohort rows, at every U.

    PYTHONPATH=src python -m repro_torch.examples.distgan_compress \\
        [--quick] [--users 64 512] [--cohort 8] [--steps N] [--device cpu]

``--quick`` runs 200 rounds a variant, 800 without it (``--steps``
overrides both).  Runs on CUDA unless ``--device cpu`` is given.
"""

import argparse

from repro_torch.core.approaches import DistGANConfig, d_flat_layout
from repro_torch.core.gan import MLPGanConfig, make_mlp_pair
from repro_torch.core.session import FederationSession
from repro_torch.core.spec import (BackendSpec, CombineSpec, CompressionSpec,
                                   EngineSpec, FederationSpec,
                                   ParticipationSpec)
from repro_torch.examples.distgan_stream import pooled_dataset, ring_pool

# (codec, error_feedback) variants; EF is only meaningful for lossy codecs
# (codec="none" runs the exact uncompressed round)
VARIANTS = [("none", False)] + [(codec, ef)
                                for codec in ("bf16", "int8", "topk_int8")
                                for ef in (True, False)]


def compress_spec(codec: str, ef: bool, C: int, B: int = 64
                  ) -> FederationSpec:
    return FederationSpec(
        approach="approach1", batch_size=B, seed=0,
        engine=EngineSpec(kind="fused", rounds_per_jit=16),
        participation=ParticipationSpec("uniform", cohort_size=C),
        backend=BackendSpec("host", materialize_state=False),
        combine=CombineSpec(
            combiner="max_abs",
            compression=CompressionSpec(codec=codec, error_feedback=ef)))


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--users", type=int, nargs="+", default=[64, 512])
    ap.add_argument("--cohort", type=int, default=8)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    C, modes = args.cohort, 8
    steps = args.steps or (200 if args.quick else 800)

    mix, pool, sampler = ring_pool(modes)
    pair = make_mlp_pair(MLPGanConfig(data_dim=2, z_dim=16, g_hidden=128,
                                      d_hidden=128))
    full_row_bytes = C * d_flat_layout(pair).n * 4   # dense f32, C rows

    print(f"{'U':>4} {'codec':>10} {'ef':>3} {'bytes/rnd':>10} "
          f"{'us/round':>9} {'stall us':>9} {'modes':>6} {'on-mode':>8}")
    rows, dense_bytes = [], {}
    for U in args.users:
        ds = pooled_dataset(U, pool, sampler)
        fcfg = DistGANConfig(num_users=U, selection="topk", upload_frac=0.1)
        for codec, ef in VARIANTS:
            r = FederationSession(pair, fcfg, ds, compress_spec(codec, ef, C),
                                  device=args.device).run(steps)
            cov, hist = mix.mode_coverage(r.samples)
            nbytes = r.extra["upload_bytes_per_round"]
            if codec == "none":
                dense_bytes[U] = nbytes
            step_us = r.extra["min_step_time_s"] * 1e6
            stall_us = r.extra["host_stall_s_per_round"] * 1e6
            print(f"{U:>4} {codec:>10} {'+' if ef else '-':>3} "
                  f"{nbytes:>10} {step_us:>9.0f} {stall_us:>9.0f} "
                  f"{(hist > 10).sum():>4}/{modes} {cov:>8.2f}", flush=True)
            rows.append({"users": U, "codec": codec, "ef": ef,
                         "upload_bytes_per_round": nbytes,
                         "us_per_round": step_us, "stall_us": stall_us,
                         "modes_hit": int((hist > 10).sum()),
                         "on_mode_frac": float(cov), "rounds": steps,
                         "g_losses": r.g_losses.tolist()})
        red, full = dense_bytes[U] / nbytes, full_row_bytes / nbytes
        print(f"     topk_int8 ships x{red:.1f} fewer upload bytes than "
              f"f32 values at the same kept fraction (U={U}); vs the full "
              f"dense f32 row ({full_row_bytes} bytes a round) x{full:.1f}")
        rows.append({"users": U, "vs_f32_values": red,
                     "vs_dense_f32_row": full})
    print(f"\nbytes/round is priced per cohort row (C={C} uploads/round) "
          f"by the single pricing table; EF (+) re-injects each round's "
          f"quantization error into the next delta, ef=- drops it (compare "
          f"the modes / on-mode columns of each pair)")
    return rows


if __name__ == "__main__":
    main()
