"""Cohort-virtualized Distributed-GAN on the PyTorch port: 64 LOGICAL
users, but every round only a cohort of 8 trains — the round's program is
shaped by the cohort width, so the same engine scales to thousands of
logical users (the MD-GAN / BGAN partial-participation regime).

The data is split non-IID with a Dirichlet(alpha) label-skew partition;
the run uses the shard-size-weighted scheduler and the staleness-aware
argmax-|.| server fold (stale uploads are age-discounted).  Each round
launches one top-k mask (B1) over the cohort's 8 delta rows.

    PYTHONPATH=src python -m repro_torch.examples.distgan_cohort \\
        [--users 64] [--cohort 8] [--steps 400] [--rounds-per-jit 16] \\
        [--device cpu]

Runs on CUDA unless ``--device cpu`` is given.
"""

import argparse

import numpy as np

from repro_torch.core.approaches import DistGANConfig
from repro_torch.core.gan import MLPGanConfig, make_mlp_pair
from repro_torch.core.protocol import run_distgan
from repro_torch.data import GaussianMixture, dirichlet_partition

MODES, BATCH = 8, 64


def ring_data(modes: int = MODES, n: int = 20_000, seed: int = 0):
    """The labeled union data: a 2-D ring of ``modes`` Gaussians, label =
    mode index.  Returns (mixture, data, labels)."""
    mix = GaussianMixture.ring(modes)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, modes, size=n)
    data = (mix.modes[labels]
            + rng.normal(0, mix.std, (len(labels), 2))).astype(np.float32)
    return mix, data, labels


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--users", type=int, default=64)
    ap.add_argument("--cohort", type=int, default=8)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--rounds-per-jit", type=int, default=16)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    U, C, steps, K = args.users, args.cohort, args.steps, args.rounds_per_jit

    mix, data, labels = ring_data()
    ds = dirichlet_partition(data, labels, num_users=U, alpha=0.3, seed=0)
    sizes = np.asarray(ds.meta["shard_sizes"])
    print(f"dirichlet(0.3) split over {U} users: shard sizes "
          f"min={sizes.min()} median={int(np.median(sizes))} "
          f"max={sizes.max()}")

    pair = make_mlp_pair(MLPGanConfig(data_dim=2, z_dim=16, g_hidden=128,
                                      d_hidden=128))
    fcfg = DistGANConfig(num_users=U, selection="topk", upload_frac=0.5,
                         combiner="staleness_max_abs", staleness_decay=0.7)
    r = run_distgan(pair, fcfg, ds, "approach1", steps=steps,
                    batch_size=BATCH, seed=0, participation="weighted",
                    cohort_size=C, rounds_per_jit=K, device=args.device)

    counts = r.extra["participation_counts"]
    stale = r.extra["staleness"]
    cov, hist = mix.mode_coverage(r.samples)
    print(f"approach1 U={U} C={C} weighted: "
          f"g_loss={r.g_losses[-1]:.3f} "
          f"modes_hit={(hist > 10).sum()}/{MODES} "
          f"on_mode_frac={cov:.2f}")
    print(f"participation: users_touched={(counts > 0).sum()}/{U} "
          f"rounds/user min={counts.min()} max={counts.max()}; "
          f"staleness mean={stale.mean():.1f} max={stale.max()}")
    step_us = r.extra["min_step_time_s"] * 1e6
    print(f"per-round {step_us:.0f} us "
          f"(compiled width C={C}, resident users U={U})")
    return [{"users": U, "shard_sizes": sizes.tolist()},
            {"approach": "approach1", "g_losses": r.g_losses.tolist(),
             "modes_hit": int((hist > 10).sum()), "on_mode_frac": float(cov),
             "participation_counts": np.asarray(counts).tolist(),
             "staleness": np.asarray(stale).tolist(), "rounds": steps},
            {"us_per_round": step_us}]


if __name__ == "__main__":
    main()
