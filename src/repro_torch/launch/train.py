"""Training launcher (port of the reference's ``launch/train.py``): real
steps of ``launch/steps.py``'s train step on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --reduced --steps 20 --batch 8 --seq 128 [--device cpu]

The card is the default device; ``--device cpu`` runs on the CPU (the
plain path; training runs every kernel off either way, as the reference
does).  ``--data`` / ``--model`` are the reference's mesh axis sizes: one
device takes only 1 x 1 (a mesh launcher is ROADMAP queue A item 13).
Weights are drawn from ``--seed``; batches are ``TokenStream``'s, the
reference's bit for bit; the audio family's frame embeddings are
``prng.normal`` of ``prng.key(step)``, as the reference draws them.

With ``--ckpt-dir`` a run resumes from the directory's latest step: like
the reference, it restores the weights only (the optimizer state starts
fresh).  Each save and restore prints the sha256 of the weights' bytes.
"""

from __future__ import annotations

import argparse
import hashlib
import time

import torch

from repro_torch import prng
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs.base import get_config
from repro_torch.data.synthetic import TokenStream
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
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


def main(argv=None):
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
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if (args.data, args.model) != (1, 1):
        raise SystemExit(
            f"--data {args.data} --model {args.model}: this launcher runs "
            f"on one device (1 x 1); a mesh launcher is ROADMAP queue A "
            f"item 13")
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()

    sched = cosine_schedule(args.lr, args.warmup, args.steps)
    opt = adamw(sched, b1=0.9, b2=0.95, weight_decay=0.1)
    step_fn, opt = make_train_step(cfg, opt)
    params = M.init_params(cfg, args.seed, device=dev)
    opt_state = opt.init(params)

    start = 0
    if args.ckpt_dir and (ls := latest_step(args.ckpt_dir)) is not None:
        params = restore_checkpoint(args.ckpt_dir, ls, params, device=dev)
        print(f"[train] restored step {ls} from {args.ckpt_dir}")
        print(f"[train] restored weights sha256 {weights_digest(params)}")
        start = ls

    stream = TokenStream(cfg.vocab_size, args.seq, args.batch,
                         seed=args.seed)
    t0 = time.perf_counter()
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"[train] {cfg.name}: {n_params/1e6:.1f}M params, mesh "
          f"{{'data': 1, 'model': 1}} on {dev}")
    for i in range(start, args.steps):
        batch = {k: v.to(dev) for k, v in stream.batch(i).items()}
        if cfg.arch_type == "audio":
            batch["src_embeds"] = prng.normal(
                prng.key(i, dev),
                (args.batch, max(args.seq // cfg.encoder_downsample, 1),
                 cfg.d_model))
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if i % args.log_every == 0 or i == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            print(f"[train] step {i}: loss={m['loss']:.4f} "
                  f"ce={m['ce']:.4f} gnorm={m['grad_norm']:.2f} "
                  f"({time.perf_counter()-t0:.1f}s)", flush=True)
        if args.ckpt_every and args.ckpt_dir and \
                (i + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, i + 1, params)
            print(f"[train] saved step {i + 1} weights sha256 "
                  f"{weights_digest(params)}", flush=True)
    print(f"[train] done in {time.perf_counter()-t0:.1f}s")


if __name__ == "__main__":
    main()
