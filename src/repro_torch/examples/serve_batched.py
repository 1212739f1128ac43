"""Batched serving demo on the PyTorch port: decode a batch of requests
with the KV / state cache for three different cache families (dense GQA
ring-buffer window, SSM constant state, MLA compressed) — the per-request
loop is the shared ``repro_torch.launch.serve.greedy_decode`` helper, then
the same workload runs through the slot-based continuous-batching engine
(``repro_torch.serve.decode``): one pre-allocated cache pool, per-step
admission into freed slots, byte-identical tokens (asserted).  No
hand-written kernel runs on this path.

    PYTHONPATH=src python -m repro_torch.examples.serve_batched [--device cpu]

Runs on CUDA unless ``--device cpu`` is given.  The prompts are the JAX
reference's (``prng.randint`` computes ``jax.random.randint`` bit for
bit); the weights come from the port's generator at seed 0.
"""

import argparse
import time

import numpy as np

from repro_torch import prng
from repro_torch.configs.base import get_config
from repro_torch.core.spec import DecodeSpec
from repro_torch.device import resolve_device
from repro_torch.launch.serve import cache_nbytes, greedy_decode
from repro_torch.models import model as M
from repro_torch.serve.decode import DecodeEngine, DecodeRequest

ARCHS = ("tinyllama-1.1b", "mamba2-780m", "deepseek-v2-lite-16b")


def prompts_for(cfg, batch: int, prompt_len: int):
    """(batch, prompt_len) int64 token ids from key 1, on the CPU."""
    return prng.randint(prng.key(1), (batch, prompt_len), 0, cfg.vocab_size)


def serve(arch: str, batch=4, prompt_len=16, gen=16, params=None,
          device=None) -> dict:
    """``batch`` requests of ``arch`` (reduced) through ``greedy_decode``
    one at a time, then through one ``DecodeEngine`` pool; ``params``
    (default: drawn from seed 0) on ``device``.  Returns the printed
    numbers and both token arrays."""
    dev = resolve_device(device)
    cfg = get_config(arch).reduced()
    if params is None:
        params = M.init_params(cfg, 0, device=dev)
    prompt = prompts_for(cfg, batch, prompt_len).to(dev)
    # baseline: one request at a time through the B=1 greedy helper — the
    # engine's byte-determinism contract is against exactly this loop
    t0 = time.perf_counter()
    gen_toks = np.concatenate([
        greedy_decode(cfg, params, row[None, :], gen).cpu().numpy()
        for row in prompt])
    dt = time.perf_counter() - t0
    cache_bytes = cache_nbytes(cfg, batch, prompt_len + gen)
    greedy_tps = batch * gen / dt
    print(f"{arch:22s} cache={cache_bytes/1e6:6.2f}MB "
          f"{greedy_tps:6.1f} tok/s  first: {gen_toks[0, :8].tolist()}",
          flush=True)

    # the same requests through the continuous-batching slot pool: one
    # shared cache block, tokens byte-identical to the per-request loop
    eng = DecodeEngine(cfg, params,
                       DecodeSpec(slots=batch, max_seq=prompt_len + gen),
                       device=dev)
    prompts = prompt.cpu().numpy()
    t0 = time.perf_counter()
    futs = [eng.submit(DecodeRequest(user_id=i, prompt=p, max_new=gen))
            for i, p in enumerate(prompts)]
    eng.drain()
    dt = time.perf_counter() - t0
    pooled = np.stack([f.result() for f in futs])
    match = np.array_equal(pooled, gen_toks)
    st = eng.engine_stats()
    pool_tps = batch * gen / dt
    print(f"{'':22s} pool ={eng.pool_nbytes/1e6:6.2f}MB "
          f"{pool_tps:6.1f} tok/s  programs={st['programs']} "
          f"bytes_match_greedy={match}", flush=True)
    assert match, "continuous batching changed the bytes"
    return {"arch": arch, "cache_nbytes": cache_bytes,
            "greedy_tok_per_s": greedy_tps, "pool_nbytes": eng.pool_nbytes,
            "pool_tok_per_s": pool_tps, "programs": st["programs"],
            "bytes_match_greedy": match, "prompts": prompts.tolist(),
            "greedy": gen_toks.tolist(), "pooled": pooled.tolist()}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    return [serve(arch, device=dev) for arch in ARCHS]


if __name__ == "__main__":
    main()
