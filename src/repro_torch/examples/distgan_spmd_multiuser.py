"""The paper's §5.7 large-scale layout on the PyTorch port: 5 users as 5
ranks of a users mesh (``torch.distributed``), approaches 1 and 2.  Raw
data stays on its rank: only selected deltas (approach 1) and D
probabilities and G gradients (approach 2) cross the users axis.  Each rank
draws every user's batches from the same seeded stream and trains on its
own; the fused SPMD engine runs 16 rounds per call.  Prints each
approach's mode coverage of the 10-mode union and how many users' modes it
reaches.

    PYTHONPATH=src python -m repro_torch.examples.distgan_spmd_multiuser \\
        [--steps 800] [--device cpu] [--backend gloo]

Runs on CUDA (NCCL, one card per rank) unless ``--device cpu`` is given
(gloo ranks); ``--backend gloo`` puts CUDA ranks on gloo instead, so the 5
ranks can share one card.
"""

import argparse

import numpy as np
import torch

from repro_torch.core.approaches import DistGANConfig
from repro_torch.core.gan import MLPGanConfig, make_mlp_pair
from repro_torch.core.spmd import init_spmd_state, make_spmd_engine
from repro_torch.data import make_user_domains
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.launch.mesh import spawn_users

U, BATCH, RPJ = 5, 64, 16


def _pair():
    return make_mlp_pair(MLPGanConfig(data_dim=2, z_dim=16, g_hidden=128,
                                      d_hidden=128))


def _rank(mesh, steps: int) -> list:
    """One rank's federation for each approach: a row per approach, its
    summary line and the rank's kernel launches in that run."""
    pair = _pair()
    users, union = make_user_domains(U, 2, separation=1.0)
    rng = np.random.default_rng(0)
    rows = []
    for approach in ("approach1", "approach2"):
        before = ops.launch_counts()
        fcfg = DistGANConfig(num_users=U, selection="topk", upload_frac=0.5)
        state = init_spmd_state(pair, fcfg, 0, mesh,
                                sync_ds=approach == "approach1")
        engine = make_spmd_engine(pair, fcfg, mesh, approach)
        # every rank draws the same stream; each reads its own user's slice
        reals = np.stack([
            np.stack([users[u].sample(rng, BATCH) for u in range(U)])
            for _ in range(steps)]).astype(np.float32)
        for start in range(0, steps, RPJ):
            state, m = engine(state, reals[start:start + RPJ])
        gen = torch.Generator().manual_seed(1)
        with torch.no_grad():
            samples = pair.g_apply(state.g, pair.sample_z(
                gen, 2048, mesh.device)).cpu().numpy()
        _, hist = union.mode_coverage(samples)
        per_user = [int((hist[u * 2:(u + 1) * 2] > 10).any())
                    for u in range(U)]
        g_loss, hit = float(m["g_loss"][-1]), int((hist > 10).sum())
        rows.append({"approach": approach, "g_loss": g_loss,
                     "modes_hit": hit, "users_covered": sum(per_user),
                     "rounds": steps,
                     "launches": {k: n - before[k] for k, n
                                  in ops.launch_counts().items()},
                     "line": f"{approach}: g_loss={g_loss:.3f} "
                             f"modes_hit={hit}/{U * 2} "
                             f"users_covered={sum(per_user)}/{U}"})
    return rows


def main(argv=None) -> list:
    """Rank 0's rows, each with every rank's launches (by rank)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--backend", default=None,
                    help="nccl (default on cuda) or gloo (default on cpu)")
    args = ap.parse_args(argv)
    resolve_device(args.device)      # no card: raise here, not in a rank
    backend = args.backend or ("gloo" if args.device == "cpu" else "nccl")
    print(f"mesh: {U} ranks on {args.device} ({backend})", flush=True)
    ranks = spawn_users(_rank, U, backend=backend, device=args.device,
                        args=(args.steps,))
    rows = ranks[0]
    for i, row in enumerate(rows):
        row["launches"] = [r[i]["launches"] for r in ranks]
        print(row["line"], flush=True)
    return rows


if __name__ == "__main__":
    main()
