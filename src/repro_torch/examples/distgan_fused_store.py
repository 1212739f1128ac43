"""Store-resident fused cohort rounds on the PyTorch port: the same
federation run at three dispatch granularities, same trajectory contract,
very different host traffic.

* ``per_round`` (host store, streamed): every round pays a host row
  gather, one round's replay, and a blocking scatter-back — K host stalls
  per K rounds.
* ``superbatch`` (host store, ``fuse_store_rounds=True``): the session
  gathers a whole ``rounds_per_jit`` window of scheduled rows as one
  (K, C, N) block, replays ONE K-round program (users repeating inside the
  window read their in-window update through an exact write-after-read
  forward — ages stay exact), and blocks a single time before scattering
  the window back.  K host stalls become 1.
* ``device fused`` (device store, ``fuse_store_rounds=True``): the (U, N)
  store lives in the engine's carry — gather -> train -> scatter for the
  whole window runs inside one program with no per-round host traffic.

All three are the SAME ``FederationSpec`` modulo the backend / engine
fields.  Participation bookkeeping (schedule, ages, ``last_round``) is
EXACT across all three, and the first 8 rounds' generator losses agree
within 1e-6 (checked here); the training values may part by an ULP a
round where the programs sum in another order, which compounds
chaotically over a long run as any ULP perturbation does in GAN training
— the tail of this script prints that divergence growth rather than
hiding it.  Each round launches one top-k mask (B1) over the cohort's
rows.

    PYTHONPATH=src python -m repro_torch.examples.distgan_fused_store \\
        [--users 512] [--cohort 8] [--rounds-per-jit 16] [--steps 192] \\
        [--device cpu]

Runs on CUDA unless ``--device cpu`` is given.
"""

import argparse

import numpy as np

from repro_torch.core.approaches import DistGANConfig
from repro_torch.core.gan import MLPGanConfig, make_mlp_pair
from repro_torch.core.session import FederationSession
from repro_torch.core.spec import (BackendSpec, EngineSpec, FederationSpec,
                                   ParticipationSpec)
from repro_torch.examples.distgan_stream import pooled_dataset, ring_pool

MODES = (("per_round", "host", False), ("superbatch", "host", True),
         ("device_fused", "device", True))


def fused_spec(backend: str, fused: bool, C: int, K: int,
               B: int = 64) -> FederationSpec:
    return FederationSpec(
        approach="approach1", batch_size=B, seed=0, eval_samples=0,
        engine=EngineSpec(kind="fused", rounds_per_jit=K,
                          fuse_store_rounds=fused),
        participation=ParticipationSpec("round_robin", cohort_size=C),
        backend=BackendSpec(backend))


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--users", type=int, default=512)
    ap.add_argument("--cohort", type=int, default=8)
    ap.add_argument("--rounds-per-jit", type=int, default=16)
    ap.add_argument("--steps", type=int, default=192)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    U, C, K, steps = args.users, args.cohort, args.rounds_per_jit, args.steps

    _, pool, sampler = ring_pool()
    ds = pooled_dataset(U, pool, sampler)
    pair = make_mlp_pair(MLPGanConfig(data_dim=2, z_dim=16, g_hidden=64,
                                      d_hidden=64))
    fcfg = DistGANConfig(num_users=U, selection="topk", upload_frac=0.5)

    runs, rows = {}, []
    print(f"{'mode':>14} {'us/round':>9} {'fused':>6} {'host stall us':>14}")
    for name, backend, fused in MODES:
        r = FederationSession(pair, fcfg, ds,
                              fused_spec(backend, fused, C, K),
                              device=args.device).run(steps)
        runs[name] = r
        stall = r.extra.get("host_stall_s_per_round")
        step_us = r.extra["min_step_time_s"] * 1e6
        print(f"{name:>14} {step_us:>9.0f} "
              f"{str(r.extra['fused_store']):>6} "
              f"{'-' if stall is None else f'{stall * 1e6:.0f}':>14}",
              flush=True)
        rows.append({"mode": name, "us_per_round": step_us,
                     "fused_store": bool(r.extra["fused_store"]),
                     "host_stall_us": None if stall is None else stall * 1e6,
                     "staleness": np.asarray(r.extra["staleness"]).tolist(),
                     "g_losses": r.g_losses.tolist(), "rounds": steps})

    # the fused paths compute the per-round trajectory, not an
    # approximation: participation bookkeeping is EXACT, and the first
    # rounds agree within 1e-6; over a long run an ULP's difference
    # compounds chaotically, as any reassociation does in GAN training —
    # shown below, not papered over
    base = runs["per_round"]
    for name in ("superbatch", "device_fused"):
        np.testing.assert_array_equal(runs[name].extra["staleness"],
                                      base.extra["staleness"])
        np.testing.assert_allclose(runs[name].g_losses[:8],
                                   base.g_losses[:8], rtol=0, atol=1e-6)
        assert np.all(np.isfinite(runs[name].g_losses))
    print("\n|g_loss - per_round| as ULP drift compounds:")
    spans = (8, 64, steps)
    for name in ("superbatch", "device_fused"):
        divs = [float(np.max(np.abs(runs[name].g_losses[:n]
                                    - base.g_losses[:n]))) for n in spans]
        print(f"{name:>14} " + " ".join(f"rounds<={n}: {d:.1e}"
                                        for n, d in zip(spans, divs)))
        rows.append({"mode": name, "drift": dict(zip(map(str, spans),
                                                     divs))})
    print(f"\nbookkeeping exact across all three modes; superbatch turns "
          f"{K} host stalls/window into 1, the device store runs the "
          f"whole {K}-round window in one replay")
    return rows


if __name__ == "__main__":
    main()
