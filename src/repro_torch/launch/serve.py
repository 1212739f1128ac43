"""Serving launcher (port of the reference's ``launch/serve.py``): batched
greedy decode against the KV/state cache, or the same workload through the
slot-based continuous-batching engine (``serve/decode.py``).
``cache_nbytes`` is re-exported from ``models/cache.py``, its home.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \\
      --reduced --batch 4 --prompt-len 32 --gen 32 [--continuous --slots 8] \\
      [--device cpu]

The card is the default device; ``--device cpu`` runs the plain path on
the CPU.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import prng
from repro_torch.configs.base import get_config
from repro_torch.data.synthetic import synthetic_batch_for
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.cache import cache_nbytes  # noqa: F401  (re-export)


def greedy_decode(cfg, params, prompt: torch.Tensor, gen_len: int, *,
                  src_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """prompt: (B, S0) token tensor -> generated (B, gen_len), on the
    prompt's device.  Prefill is token-by-token decode (uniform across the
    SSM and attention families); the audio family first fills its cross
    K/V from ``src_embeds`` (B, S_src, d).  The whole batch routes as one
    MoE group, as the reference's batched step does."""
    B, S0 = prompt.shape
    cache = M.init_cache(cfg, B, S0 + gen_len, device=prompt.device)
    if cfg.arch_type == "audio":
        if src_embeds is None:
            raise ValueError("the audio family decodes against src_embeds")
        with torch.no_grad():
            cache = M.prefill_audio_cache(params, cache, src_embeds, cfg)
    tok = prompt[:, 0:1]
    out = []
    with torch.no_grad():
        for i in range(S0 + gen_len - 1):
            logits, cache = M.decode_step(params, cache, tok, i, cfg)
            nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
            tok = prompt[:, i + 1:i + 2] if i + 1 < S0 else nxt
            if i + 1 >= S0:
                out.append(nxt)
    return torch.cat(out, dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help="any config id (configs/base.py ARCH_IDS, with "
                         "dashes); --continuous takes every family but "
                         "audio")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--continuous", action="store_true",
                    help="serve through the slot-based continuous-"
                         "batching engine instead of per-request greedy")
    ap.add_argument("--slots", type=int, default=8,
                    help="decode-slot pool width (with --continuous)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = M.init_params(cfg, args.seed, device=dev)
    batch = synthetic_batch_for(cfg, args.batch, args.prompt_len,
                                prng.key(args.seed + 1, dev))
    prompts = batch["tokens"]

    if args.continuous:
        from repro_torch.core.spec import DecodeSpec
        from repro_torch.serve.decode import DecodeEngine, DecodeRequest

        spec = DecodeSpec(slots=args.slots,
                          max_seq=args.prompt_len + args.gen)
        eng = DecodeEngine(cfg, params, spec, device=dev)
        print(f"[serve] slot pool: {spec.slots} x {spec.max_seq} = "
              f"{eng.pool_nbytes / 1e6:.2f} MB shared cache block")
        t0 = time.perf_counter()
        futs = [eng.submit(DecodeRequest(user_id=i, prompt=p.cpu().numpy(),
                                         max_new=args.gen))
                for i, p in enumerate(prompts)]
        eng.drain()
        gen = torch.stack([torch.from_numpy(f.result()) for f in futs])
        dt = time.perf_counter() - t0
        st = eng.engine_stats()
        print(f"[serve] {cfg.name} on {dev}: generated {tuple(gen.shape)} "
              f"in {dt:.1f}s ({args.batch * args.gen / dt:.1f} tok/s incl. "
              f"graph capture); programs {st['programs']}, mean occupancy "
              f"{st.get('mean_occupancy', 0):.1f}")
    else:
        t0 = time.perf_counter()
        gen = greedy_decode(cfg, params, prompts, args.gen,
                            src_embeds=batch.get("src_embeds")).cpu()
        dt = time.perf_counter() - t0
        print(f"[serve] {cfg.name} on {dev}: generated {tuple(gen.shape)} "
              f"in {dt:.1f}s ({args.batch * args.gen / dt:.1f} tok/s)")
    print("[serve] first row:", gen[0, :16].tolist())


if __name__ == "__main__":
    main()
