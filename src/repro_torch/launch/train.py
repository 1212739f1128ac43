"""Training launcher (port of the reference's ``launch/train.py``): real
steps of ``launch/steps.py``'s train step, on one device or on a
``(data, model)`` mesh of ranks.

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --reduced --steps 20 --batch 8 --seq 128 [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --reduced --steps 5 --data 2 --model 2 --backend gloo [--device cpu]

The card is the default device; ``--device cpu`` runs on the CPU (the
plain path; training runs every kernel off either way, as the reference
does).  ``--data`` / ``--model`` are the reference's mesh axis sizes.  At
1 x 1 the step runs on plain tensors on one device.  Above that it runs
on ``launch.mesh.make_host_mesh(data, model)``: the parameters are
DTensors placed by ``launch.steps.param_pspecs`` (the reference's
``NamedSharding``s), the batch by ``batch_specs``.  The ranks come from
``torchrun`` (its environment names them) or are spawned here, joined by
``--backend``, which the caller names: NCCL takes one rank per card;
ranks that share one card, or run on the CPU, take gloo (as
``launch.mesh.MESH_GLOO``, whose all-gathers work on CUDA tensors).

Weights are drawn from ``--seed`` in full on every rank, exactly as at 1 x
1, then split, so a mesh run starts from the 1 x 1 run's weights bit for
bit; batches are ``TokenStream``'s, the reference's bit for bit; the audio
family's frame embeddings are ``prng.normal`` of ``prng.key(step)``, as
the reference draws them.

With ``--ckpt-dir`` a run resumes from the directory's latest step: like
the reference, it restores the weights only (the optimizer state starts
fresh).  Checkpoints hold the full tensors in the reference's layout, and
each save and restore prints the sha256 of the full weights' bytes.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import tempfile
import time

import torch

from repro_torch import prng
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs.base import get_config
from repro_torch.data.synthetic import TokenStream
from repro_torch.device import resolve_device
from repro_torch.launch.steps import (batch_pspec, distribute,
                                      full_tensors, make_train_step,
                                      param_pspecs)
from repro_torch.models import model as M
from repro_torch.models.common import tree_leaves
from repro_torch.optim import adamw, cosine_schedule


def weights_digest(params) -> str:
    """sha256 over every leaf's bytes, in tree order (bf16 by its bits)."""
    h = hashlib.sha256()
    for t in tree_leaves(params):
        t = t.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        h.update(t.numpy().tobytes())
    return h.hexdigest()


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--data", type=int, default=1, help="data-axis size")
    ap.add_argument("--model", type=int, default=1, help="model-axis size")
    ap.add_argument("--backend", default=None,
                    help="nccl | gloo: joins the ranks of a mesh run")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    world = args.data * args.model
    if world == 1:
        return _run(args)
    if args.backend is None:
        raise SystemExit(f"--data {args.data} --model {args.model} runs "
                         f"{world} ranks: name their backend with "
                         f"--backend (nccl: one rank per card; gloo: ranks "
                         f"sharing a card or on the CPU)")
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return _mesh_rank(int(os.environ["RANK"]), args, None)
    with tempfile.TemporaryDirectory(prefix="train_mesh_") as tmp:
        torch.multiprocessing.spawn(
            _mesh_rank, args=(args, os.path.join(tmp, "rendezvous")),
            nprocs=world, join=True)


def _mesh_rank(rank: int, args, init_file) -> None:
    """One rank of a mesh run: joined by ``args.backend`` (torchrun's
    environment, or the spawned ranks' ``file://`` rendezvous)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh, register_mesh_gloo

    world = args.data * args.model
    backend = (register_mesh_gloo() if args.backend == "gloo"
               else args.backend)
    if init_file is None:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, init_method=f"file://{init_file}",
                                rank=rank, world_size=world)
    try:
        if torch.device(args.device or "cuda").type == "cpu":
            torch.set_num_threads(1)
        _run(args, make_host_mesh(args.data, args.model,
                                  device=args.device))
    finally:
        dist.destroy_process_group()


def _run(args, mesh=None) -> None:
    """The training loop, on one device (``mesh`` None) or on ``mesh``;
    on a mesh every rank runs it and rank 0 prints."""
    rank0 = mesh is None or mesh.get_rank() == 0
    say = print if rank0 else (lambda *a, **k: None)
    dev = resolve_device(args.device)
    if mesh is not None and dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()

    sched = cosine_schedule(args.lr, args.warmup, args.steps)
    opt = adamw(sched, b1=0.9, b2=0.95, weight_decay=0.1)
    step_fn, opt = make_train_step(cfg, opt)
    params = M.init_params(cfg, args.seed, device=dev)

    start = 0
    if args.ckpt_dir and (ls := latest_step(args.ckpt_dir)) is not None:
        params = restore_checkpoint(args.ckpt_dir, ls, params, device=dev)
        say(f"[train] restored step {ls} from {args.ckpt_dir}")
        say(f"[train] restored weights sha256 {weights_digest(params)}")
        start = ls
    if mesh is not None:
        params = distribute(params, param_pspecs(cfg, mesh), mesh)
        bspec = batch_pspec(cfg, mesh, args.batch) + (None,)
    opt_state = opt.init(params)

    stream = TokenStream(cfg.vocab_size, args.seq, args.batch,
                         seed=args.seed)
    t0 = time.perf_counter()
    n_params = sum(x.numel() for x in tree_leaves(params))
    shape = ({"data": 1, "model": 1} if mesh is None else
             dict(zip(mesh.mesh_dim_names, mesh.shape)))
    say(f"[train] {cfg.name}: {n_params/1e6:.1f}M params, mesh {shape} on "
        f"{dev}")
    for i in range(start, args.steps):
        batch = {k: v.to(dev) for k, v in stream.batch(i).items()}
        if cfg.arch_type == "audio":
            batch["src_embeds"] = prng.normal(
                prng.key(i, dev),
                (args.batch, max(args.seq // cfg.encoder_downsample, 1),
                 cfg.d_model))
        if mesh is not None:
            batch = distribute(batch, {k: bspec + (None,) * (v.ndim - 2)
                                       for k, v in batch.items()}, mesh)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if i % args.log_every == 0 or i == args.steps - 1:
            m = {k: float(v) for k, v in full_tensors(metrics).items()}
            say(f"[train] step {i}: loss={m['loss']:.4f} "
                f"ce={m['ce']:.4f} gnorm={m['grad_norm']:.2f} "
                f"({time.perf_counter()-t0:.1f}s)", flush=True)
        if args.ckpt_every and args.ckpt_dir and \
                (i + 1) % args.ckpt_every == 0:
            full = full_tensors(params)
            if rank0:
                save_checkpoint(args.ckpt_dir, i + 1, full)
                say(f"[train] saved step {i + 1} weights sha256 "
                    f"{weights_digest(full)}", flush=True)
            if mesh is not None:
                torch.distributed.barrier()
    say(f"[train] done in {time.perf_counter()-t0:.1f}s")


if __name__ == "__main__":
    main()
