"""Multi-tenant generation serving over a live FederationSession, on the
PyTorch port.

The paper's closing argument (§7) is that the platform should "provide
model for users who lack computing power": after federated training, the
server-held generator is a *service*.  This example trains a small
approach-1 federation on the host-store backend (one top-k mask, B1, a
round), then stands up a ``repro_torch.serve.GenerationService`` over the
live session and shows the full serving story (no hand-written kernel
runs while serving):

* a mixed-size request workload (1..17 samples per request, many tenants)
  coalesced by the micro-batcher into padded power-of-two bucket
  dispatches, with the program count (CUDA graphs on the card) bounded by
  the bucket ladder;
* **determinism**: a served request is byte-identical to its
  ``replay(seed, request_id, n)`` — batching is invisible in the bytes;
* **hot-swap**: training continues (``session.run``) and
  ``service.refresh()`` atomically publishes the newer generator between
  batches;
* **per-user rejection filtering**: a tenant's samples filtered by its
  OWN discriminator row from the host store;
* per-user accounting (requests / samples / bytes served).

    PYTHONPATH=src python -m repro_torch.examples.distgan_serve \\
        [--quick] [--device cpu]

U 64, C 8, 24 rounds, 240 requests (``--quick``: 16, 4, 8, 80).  Runs on
CUDA unless ``--device cpu`` is given.
"""

import argparse
import time

import numpy as np

from repro_torch.core.approaches import DistGANConfig
from repro_torch.core.gan import MLPGanConfig, make_mlp_pair
from repro_torch.core.session import FederationSession
from repro_torch.core.spec import (BackendSpec, FederationSpec,
                                   ParticipationSpec, ServeSpec)
from repro_torch.data import FederatedDataset, make_user_domains
from repro_torch.serve import GenerationService


def workload(U: int, n_requests: int):
    """The mixed multi-tenant request sizes and tenants, from seed 0."""
    rng = np.random.default_rng(0)
    sizes = rng.integers(1, 18, size=n_requests)
    tenants = rng.integers(0, U, size=n_requests)
    return sizes, tenants


def serve_spec(C: int) -> FederationSpec:
    return FederationSpec(
        approach="approach1", batch_size=32, eval_samples=0,
        participation=ParticipationSpec("uniform", cohort_size=C),
        backend=BackendSpec("host"),
        serve=ServeSpec(max_batch=32, flush_ms=1.0))


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    U, C = (16, 4) if args.quick else (64, 8)
    rounds = 8 if args.quick else 24
    n_requests = 80 if args.quick else 240

    pair = make_mlp_pair(MLPGanConfig(data_dim=2, z_dim=8, g_hidden=32,
                                      d_hidden=32))
    users, union = make_user_domains(U, 2, 1.0)
    ds = FederatedDataset([u.sample for u in users], union.sample,
                          {"shard_sizes": [1000] * U})
    fcfg = DistGANConfig(num_users=U, selection="topk", upload_frac=0.3)

    print(f"[train] U={U} C={C}: {rounds} rounds on the host store...")
    sess = FederationSession(pair, fcfg, ds, serve_spec(C),
                             device=args.device)
    sess.run(rounds)

    svc = GenerationService.from_session(sess)

    # mixed-size multi-tenant workload, micro-batched
    sizes, tenants = workload(U, n_requests)
    futs = [svc.submit(int(u), int(n), seed=int(u))
            for u, n in zip(tenants, sizes)]
    svc.drain()  # build the bucket programs outside the timed pass

    futs = [svc.submit(int(u), int(n), seed=int(u))
            for u, n in zip(tenants, sizes)]
    t0 = time.perf_counter()
    svc.drain()
    dt = time.perf_counter() - t0
    total = int(sizes.sum())
    st = svc.stats()
    bat = st["batcher"]
    n_buckets = len(svc.serve.buckets())
    print(f"[serve] {n_requests} requests / {total} samples in {dt:.3f}s "
          f"({total / dt:,.0f} samples/s)")
    print(f"[serve] flushes={bat['flushes']} "
          f"(~{total / max(bat['flushes'] // 2, 1):.1f} samples/dispatch), "
          f"padding={bat['padded_slots'] / max(bat['dispatched_slots'], 1):.2f}, "
          f"compiled request programs={st['programs']['request']} "
          f"<= buckets={n_buckets}")
    rows = [{"requests": n_requests, "samples": total, "s": dt,
             "samples_per_s": total / dt, "flushes": bat["flushes"],
             "padded_slots": bat["padded_slots"],
             "dispatched_slots": bat["dispatched_slots"],
             "request_programs": st["programs"]["request"],
             "buckets": n_buckets}]

    # determinism: served bytes == replay bytes, batching invisible
    probe = futs[0].result()
    rep = svc.replay(seed=int(tenants[0]), request_id=int(n_requests),
                     n=int(sizes[0]))
    same = bool(np.array_equal(probe, rep))
    assert same, "served != replay"
    print("[serve] determinism: request bytes == replay bytes "
          f"(request_id={n_requests}, n={sizes[0]})")

    # hot-swap: train on, publish the newer generator between batches
    sess.run(rounds // 2)
    gen = svc.refresh()
    rep2 = svc.replay(seed=int(tenants[0]), request_id=int(n_requests),
                      n=int(sizes[0]))
    swapped = not np.array_equal(rep, rep2)
    print(f"[serve] hot-swap: generation={gen}, same request now serves "
          f"{'new' if swapped else 'IDENTICAL (bug)'}"
          " bytes from the refreshed generator")

    # per-user rejection filter: tenant 0's own D row scores candidates
    plain = svc.sample(0, 64, seed=123)
    filt = svc.sample_filtered(0, 64, seed=123)
    d0 = svc.user_d_params(0)
    s_plain = float(svc.engine.score_bucket(d0, plain).mean())
    s_filt = float(svc.engine.score_bucket(d0, filt).mean())
    print(f"[serve] rejection filter (user 0, x{svc.serve.oversample} "
          f"oversample): own-D score {s_plain:+.3f} -> {s_filt:+.3f}")
    rows.append({"served_equals_replay": same, "generation": gen,
                 "hot_swap_new_bytes": swapped, "score_plain": s_plain,
                 "score_filtered": s_filt})

    # accounting as of the timed pass
    top = sorted(st["per_user"].items(),
                 key=lambda kv: -kv[1]["samples"])[:3]
    for u, acc in top:
        print(f"[account] user {u:3d}: {acc['requests']} requests, "
              f"{acc['samples']} samples, {acc['bytes']} bytes")
    print(f"[account] total: {st['total_samples']} samples, "
          f"{st['total_bytes']} bytes served")
    rows.append({"per_user": {int(u): dict(a)
                              for u, a in st["per_user"].items()},
                 "total_samples": st["total_samples"],
                 "total_bytes": st["total_bytes"]})
    return rows


if __name__ == "__main__":
    main()
