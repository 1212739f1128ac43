"""Multi-process federation end to end on the PyTorch port: the MD-GAN
topology as a fleet.

The launcher materializes a ``FederationSpec`` into per-worker subprocess
jobs — spawn -> health-check -> run -> collect -> teardown — each worker a
numpy-only shard holder for a contiguous range of the (U, N) host store.
The coordinator (this process) owns the generator / server-D carry,
gathers each round's scheduled cohort rows over the length-prefixed
MessagePack RPC wire, runs the cohort rows engine on its device, and
scatters the updated rows back, with the D-row legs packed as int8 + a
per-row scale (the ``stage_rows`` transport) and the measured payload
bytes asserted equal to the ``upload_bytes_flat`` pricing on every call.

The script then saves the session — each worker checkpoints its own
shard, the coordinator writes the manifest — restores it at a DIFFERENT
worker count (the shard files re-slice by row range), continues training,
and verifies that the continued trajectory matches a single-process
``host``-backend run bitwise; it exits 1 otherwise.  Each round launches
one top-k mask (B1), one int8 quantize and one dequantize (B2) in the
round, and one more quantize and dequantize on the staged row legs.

    PYTHONPATH=src python -m repro_torch.examples.distgan_multihost \\
        [--quick] [--users U] [--workers W] [--cohort C] [--steps N] \\
        [--device cpu]

Defaults: U 2048 over 4 workers, C 8, 60 rounds (``--quick``: 256 over 2,
12 rounds).  Runs on CUDA unless ``--device cpu`` is given.
"""

import argparse
import tempfile

import numpy as np

from repro_torch.core.approaches import (DistGANConfig, d_flat_layout,
                                         d_opt_flat_layout)
from repro_torch.core.gan import MLPGanConfig, make_mlp_pair
from repro_torch.core.session import FederationSession
from repro_torch.core.spec import (BackendSpec, CombineSpec, CompressionSpec,
                                   FederationSpec, ParticipationSpec)
from repro_torch.examples.distgan_stream import pooled_dataset, ring_pool


def multihost_spec(kind: str, C: int, workers=None, B: int = 32
                   ) -> FederationSpec:
    return FederationSpec(
        approach="approach1", batch_size=B, seed=0, eval_samples=0,
        participation=ParticipationSpec(scheduler="uniform", cohort_size=C),
        backend=BackendSpec(kind=kind, workers=workers,
                            materialize_state=False),
        combine=CombineSpec(compression=CompressionSpec(
            codec="topk_int8", error_feedback=True, stage_rows=True)))


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--users", type=int, default=None)
    ap.add_argument("--workers", type=int, default=None)
    ap.add_argument("--cohort", type=int, default=None)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    U, C, W = (256, 8, 2) if args.quick else (2048, 8, 4)
    steps = 12 if args.quick else 60
    U, C, W = args.users or U, args.cohort or C, args.workers or W
    steps = args.steps or steps

    _, pool, sampler = ring_pool()
    ds = pooled_dataset(U, pool, sampler)
    pair = make_mlp_pair(MLPGanConfig(data_dim=2, z_dim=8, g_hidden=32,
                                      d_hidden=32))
    fcfg = DistGANConfig(num_users=U, selection="topk", upload_frac=0.5)

    nd = d_flat_layout(pair).n
    no = d_opt_flat_layout(pair, fcfg).n
    print(f"U={U} users over {W} workers, C={C}, rows nd={nd} no={no}")
    rows = [{"users": U, "workers": W, "cohort": C, "nd": nd, "no": no}]

    # -- phase 1: train on the fleet, watch the wire ----------------------
    tmp = tempfile.TemporaryDirectory(prefix="distgan-multihost-")
    path = tmp.name
    sess = FederationSession(pair, fcfg, ds,
                             multihost_spec("multihost", C, W),
                             device=args.device)
    try:
        fleet = [(h.rank, h.lo, h.hi) for h in sess._driver._fleet.workers]
        print("fleet:", fleet)
        r = sess.run(steps)
        mb = r.extra["host_backend"]
        step_us = r.extra["min_step_time_s"] * 1e6
        print(f"ran {steps} rounds: step={step_us:.0f}us "
              f"g_loss[-1]={r.g_losses[-1]:.3f}")
        print(f"wire: payload={mb.round_payload_bytes}B over {mb.rpc_calls} "
              f"RPCs (socket incl envelope: {mb.socket_bytes}B) — every "
              f"call asserted == upload_bytes_flat pricing")
        rows.append({"fleet": fleet, "rounds": steps,
                     "us_per_round": step_us,
                     "g_losses": r.g_losses.tolist(),
                     "round_payload_bytes": mb.round_payload_bytes,
                     "rpc_calls": mb.rpc_calls,
                     "socket_bytes": mb.socket_bytes})

        # -- phase 2: sharded save, re-partitioned restore ----------------
        sess.save(path)
    finally:
        sess.close()
    W2 = W + 1
    with tmp:
        restored = FederationSession.restore(path, pair, fcfg, ds,
                                             device=args.device, workers=W2)
        print(f"restored at {W2} workers (was {W}) from {path}")
        try:
            r2 = restored.run(steps)
        finally:
            restored.close()

    # -- phase 3: the single-process reference ----------------------------
    ref = FederationSession(pair, fcfg, ds, multihost_spec("host", C),
                            device=args.device)
    try:
        ref.run(steps)
        r_ref = ref.run(steps)
    finally:
        ref.close()
    match = np.array_equal(r_ref.g_losses, r2.g_losses)
    print(f"continued trajectory vs single-process host backend: "
          f"{'BITWISE MATCH' if match else 'MISMATCH'}")
    rows.append({"restored_workers": W2, "rounds": steps,
                 "g_losses": r2.g_losses.tolist(), "bitwise_match": match})
    if not match:
        raise SystemExit(1)
    return rows


if __name__ == "__main__":
    main()
