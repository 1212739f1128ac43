"""Quickstart on the PyTorch port: train a reduced assigned architecture
for a few steps, then serve a few greedy tokens from it — the port's
public API in one file.

    PYTHONPATH=src python -m repro_torch.examples.quickstart \\
        [--arch tinyllama-1.1b] [--steps 30] [--device cpu]

Runs on CUDA unless ``--device cpu`` is given.  Training runs with every
kernel off (as the JAX reference trains) and decode launches none.
"""

import argparse

from repro_torch.configs.base import get_config
from repro_torch.data.synthetic import TokenStream
from repro_torch.device import resolve_device
from repro_torch.launch.serve import greedy_decode
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as M
from repro_torch.models.common import tree_leaves
from repro_torch.optim import adamw


def train(cfg, params, stream, steps: int, rows: list | None = None):
    """``steps`` AdamW(1e-3) steps on ``stream``'s batches, in place on
    ``params``' device; every 10th step and the last are printed (and
    appended to ``rows``).  Returns (params, the loss of every step)."""
    dev = tree_leaves(params)[0].device
    step_fn, opt = make_train_step(cfg, adamw(1e-3))
    opt_state = opt.init(params)
    losses = []
    for i in range(steps):
        batch = {k: v.to(dev) for k, v in stream.batch(i).items()}
        params, opt_state, m = step_fn(params, opt_state, batch)
        losses.append(float(m["loss"]))
        if i % 10 == 0 or i == steps - 1:
            print(f"step {i:3d}  loss {losses[-1]:.4f}", flush=True)
            if rows is not None:
                rows.append({"step": i, "loss": losses[-1]})
    return params, losses


def serve(cfg, params, prompt, gen_len: int):
    """Greedy tokens (B, gen_len) after ``prompt`` (B, S0), on the
    params' device."""
    dev = tree_leaves(params)[0].device
    return greedy_decode(cfg, params, prompt.to(dev), gen_len)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    print(f"== {cfg.name} (reduced: {cfg.num_layers}L d={cfg.d_model}) ==")
    rows = [{"arch": cfg.name, "layers": cfg.num_layers,
             "d_model": cfg.d_model}]

    # --- train ---
    # weights from the port's generator at seed 0: not the reference's
    # jax.random.key(0) draws, so the losses and tokens differ from its
    params = M.init_params(cfg, 0, device=dev)
    stream = TokenStream(cfg.vocab_size, seq_len=64, batch_size=8, seed=0)
    params, _ = train(cfg, params, stream, args.steps, rows)

    # --- serve ---
    prompt = stream.batch(999)["tokens"][:2, :8]
    gen = serve(cfg, params, prompt, gen_len=12)
    print("prompt :", prompt[0].tolist())
    print("greedy :", gen[0].tolist())
    rows.append({"prompt": prompt[0].tolist(), "greedy": gen[0].tolist()})
    return rows


if __name__ == "__main__":
    main()
