"""Host-resident user store on the PyTorch port: the SAME C=8 streamed
cohort round serves 64, 512 and 4096 logical users.  The per-user
discriminator / optimizer rows live in pinned host buffers
(``HostStateBackend``) — the card never holds a (U, N) buffer, so the
population is bounded by host RAM, and only the scheduled cohort's 8 rows
cross the host <-> device boundary a round.

Each run is described by a declarative ``FederationSpec`` and driven
through a ``FederationSession``.  Runs are ASYNC with bounded staleness
(``async_rounds=2``): round k's scatter-back may land up to 2 rounds after
round k+1 launches, while the session stages round k+1's rows and data
under round k's compute.  Each round launches one top-k mask (B1) over
the cohort's rows.

The sweep compares two registered approach-1 sync policies per U:

* ``approach1``       — members train from the server copy of their LAST
  participation, which grows older as U grows (the run prints the mean
  age it measured over the last 20 rounds);
* ``download_first``  — members pull the CURRENT server D before
  training, so deltas are always rebased on today's server point.

    PYTHONPATH=src python -m repro_torch.examples.distgan_stream \\
        [--users 64 512 4096] [--cohort 8] [--steps 600] [--device cpu]

Runs on CUDA unless ``--device cpu`` is given.
"""

import argparse

import numpy as np

from repro_torch.core.approaches import (DistGANConfig, d_flat_layout,
                                         d_opt_flat_layout)
from repro_torch.core.gan import MLPGanConfig, make_mlp_pair
from repro_torch.core.session import FederationSession
from repro_torch.core.spec import (BackendSpec, CombineSpec, FederationSpec,
                                   ParticipationSpec)
from repro_torch.data import FederatedDataset, GaussianMixture

APPROACHES = ("approach1", "download_first")


def ring_pool(modes: int = 8, n: int = 20_000):
    """The 8-Gaussian ring, a pool of ``n`` points from seed 0, and a
    sampler drawing from the pool.  Returns (mixture, pool, sampler)."""
    mix = GaussianMixture.ring(modes)
    pool = mix.sample(np.random.default_rng(0), n)

    def sampler(rng_, k):
        return pool[rng_.integers(0, len(pool), size=k)]

    return mix, pool, sampler


def pooled_dataset(U: int, pool, sampler) -> FederatedDataset:
    """Every user draws from the same pool."""
    return FederatedDataset([sampler] * U, sampler,
                            {"shard_sizes": [len(pool)] * U})


def stream_spec(approach: str, C: int, B: int = 64) -> FederationSpec:
    return FederationSpec(
        approach=approach, batch_size=B, seed=0,
        participation=ParticipationSpec("uniform", cohort_size=C),
        backend=BackendSpec("host", async_rounds=2, materialize_state=False),
        combine=CombineSpec("staleness_mean", staleness_decay=0.9,
                            adaptive_server_scale=True))


def host_mb(pair, fcfg, U: int) -> float:
    """Resident footprint: U rows of D params + optimizer moments, on the
    HOST (the card holds C rows at a time)."""
    return 4e-6 * U * (d_flat_layout(pair).n
                       + d_opt_flat_layout(pair, fcfg).n)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--users", type=int, nargs="+", default=[64, 512, 4096])
    ap.add_argument("--cohort", type=int, default=8)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    C, steps, modes = args.cohort, args.steps, 8

    mix, pool, sampler = ring_pool(modes)
    pair = make_mlp_pair(MLPGanConfig(data_dim=2, z_dim=16, g_hidden=128,
                                      d_hidden=128))

    print(f"{'U':>5} {'approach':>15} {'us/round':>9} {'modes':>6} "
          f"{'on-mode':>8} {'mean age':>9} {'host MB':>8}")
    rows = []
    for U in args.users:
        ds = pooled_dataset(U, pool, sampler)
        fcfg = DistGANConfig(num_users=U, selection="topk", upload_frac=0.5)
        for approach in APPROACHES:
            r = FederationSession(pair, fcfg, ds, stream_spec(approach, C),
                                  device=args.device).run(steps)
            cov, hist = mix.mode_coverage(r.samples)
            mb = host_mb(pair, fcfg, U)
            age = float(r.extra["mean_age"][-20:].mean())
            step_us = r.extra["min_step_time_s"] * 1e6
            print(f"{U:>5} {approach:>15} {step_us:>9.0f} "
                  f"{(hist > 10).sum():>4}/{modes} {cov:>8.2f} "
                  f"{age:>9.1f} {mb:>8.1f}", flush=True)
            rows.append({"users": U, "approach": approach,
                         "us_per_round": step_us,
                         "modes_hit": int((hist > 10).sum()),
                         "on_mode_frac": float(cov), "mean_age_last20": age,
                         "mean_age": np.asarray(r.extra["mean_age"]).tolist(),
                         "host_mb": mb, "rounds": steps,
                         "g_losses": r.g_losses.tolist()})
    us = {u: min(r["us_per_round"] for r in rows if r["users"] == u)
          for u in args.users}
    ages = {r["users"]: r["mean_age_last20"] for r in rows}
    print(f"\nbest us/round at U={max(us)} over U={min(us)}: "
          f"x{us[max(us)] / us[min(us)]:.2f} (compiled width C={C}; host "
          f"gather/scatter touches C rows); mean age of a member's server "
          f"copy over the last 20 rounds: "
          + ", ".join(f"U={u} {a:.1f}" for u, a in ages.items())
          + " rounds — approach1 trains from that stale copy "
          "(rounds/user ~ steps*C/U), download_first rebases every delta "
          "on the current server D")
    return rows


if __name__ == "__main__":
    main()
