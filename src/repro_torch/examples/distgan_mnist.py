"""The paper, end to end, on the PyTorch port: two users with disjoint
private "digit" classes (user 1 holds 0-4, user 2 holds 5-9, the paper's
MNIST split) train one GAN with each of the three Distributed-GAN
approaches and the union baseline, on the paper's MLP G/D (Tables 1-2)
over 28x28 images, never sharing raw data.  It prints each approach's
template coverage per user, its losses, its time per round and the
paper's §5.5 modeled epoch time.

    PYTHONPATH=src python -m repro_torch.examples.distgan_mnist [--steps 1500]

Runs on CUDA unless ``--device cpu`` is given.
"""

import argparse
import time

import numpy as np

from repro_torch.core.approaches import DistGANConfig
from repro_torch.core.gan import MLPGanConfig, make_mlp_pair
from repro_torch.core.protocol import (effective_epoch_time,
                                       measure_component_times, run_distgan)
from repro_torch.data import (digits_like_mixture, federated_split,
                              template_coverage)


def build_dataset(n_per_class=400, size=28):
    templates, _ = digits_like_mixture(list(range(10)), size=size)
    rng = np.random.default_rng(0)
    data, labels = [], []
    for c in range(10):
        _, sample = digits_like_mixture([c], size=size)
        data.append(sample(rng, n_per_class))
        labels.append(np.full(n_per_class, c))
    data = np.concatenate(data).reshape(-1, size * size)
    labels = np.concatenate(labels)
    ds = federated_split(data, labels, [[0, 1, 2, 3, 4], [5, 6, 7, 8, 9]])
    return ds, templates


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--engine", choices=["fused", "per_step"],
                    default="fused",
                    help="fused = K rounds per chunk (one CUDA graph replay "
                         "on the card); per_step = one round at a time")
    ap.add_argument("--rounds-per-jit", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    ds, templates = build_dataset()
    pair = make_mlp_pair(MLPGanConfig(data_dim=784, z_dim=64, g_hidden=256,
                                      d_hidden=256))
    t_base, t_d = measure_component_times(
        pair, DistGANConfig(num_users=2), ds, args.batch, iters=15,
        device=args.device)
    N = 10_000
    results = {}
    for approach, fcfg in [
        ("baseline", DistGANConfig(num_users=2)),
        ("approach1", DistGANConfig(num_users=2, selection="topk",
                                    upload_frac=0.5)),
        ("approach2", DistGANConfig(num_users=2)),
        ("approach3", DistGANConfig(num_users=2)),
    ]:
        t0 = time.time()
        r = run_distgan(pair, fcfg, ds, approach, steps=args.steps,
                        batch_size=args.batch, seed=0, eval_samples=1024,
                        engine=args.engine,
                        rounds_per_jit=args.rounds_per_jit,
                        device=args.device)
        cov, best = template_coverage(r.samples.reshape(-1, 28, 28),
                                      templates, thresh=0.35)
        u1 = (best[:5] > 0.35).sum()
        u2 = (best[5:] > 0.35).sum()
        eff = effective_epoch_time(r, 2, approach, t_base=t_base, t_d=t_d,
                                   per_samples=N, batch_size=args.batch)
        results[approach] = (cov, u1, u2, eff)
        print(f"{approach:10s} | coverage {cov:4.2f} "
              f"(user1 classes {u1}/5, user2 classes {u2}/5) | "
              f"g_loss {r.g_losses[0]:.2f}->{r.g_losses[-1]:.2f} | "
              f"step {r.step_time_s * 1e3:.2f} ms | "
              f"modeled epoch({N}) {eff:.3f} s "
              f"({time.time() - t0:.0f}s wall, {r.extra['device']})",
              flush=True)

    base = results["baseline"][3]
    best_d = min(v[3] for k, v in results.items() if k != "baseline")
    print(f"\npaper §5.5 claim: distributed epoch vs serial union baseline: "
          f"x{base / best_d:.2f} speedup (modeled, users' D phases parallel; "
          f"measured t_base={t_base * 1e3:.2f}ms t_d={t_d * 1e3:.2f}ms)")
    print("paper claim C2: approaches cover BOTH users' private classes "
          "without sharing data — see per-user class counts above.")


if __name__ == "__main__":
    main()
