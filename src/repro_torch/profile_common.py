"""What the profilers (``profile_codec``, ``profile_ssd``, ``profile_flash``)
share beyond the timing helpers of ``repro_torch.timing``: ``import_tree``
times another source tree's kernels, ``lm_request_ms`` times a scoring
request of an LM config through ``loss_fn``, ``emulated_err`` reports how
far a split-TF32 emulation lands from the plain version.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import torch


def import_tree(src: str) -> None:
    """Import ``repro_torch`` from the source tree ``src`` (for example the
    parent commit unpacked with ``git archive``) from now on."""
    for name in [m for m in sys.modules
                 if m == "repro_torch" or m.startswith("repro_torch.")]:
        del sys.modules[name]
    sys.path.insert(0, str(Path(src).resolve()))


def lm_request_ms(arch: str, flag: str, *, batch: int = 4, seq: int = 2048,
                  dtype: str = "float32", reps: int = 3, seed: int = 0):
    """Host ms of ``reps`` scoring requests (``loss_fn`` with the kernel flag
    ``flag`` on, ending in a device sync) of ``arch`` at full width with its
    weights in ``dtype``, after one warm-up request; random weights from
    ``seed`` on the card.  Imports the ``repro_torch`` in use."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config(arch), param_dtype=dtype,
                              compute_dtype=dtype)
    params = M.init_params(cfg, seed, device=torch.device("cuda"))
    rng = np.random.default_rng(seed)
    batch_ = {key: torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (batch, seq))).cuda()
        for key in ("tokens", "targets")}
    out = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, metrics = M.loss_fn(params, batch_, cfg, **{flag: True})
        float(metrics["ce"])
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    del params
    torch.cuda.empty_cache()
    return out[1:]


def emulated_err(emulate, want: torch.Tensor) -> dict[str, float]:
    """Max |emulate() - want| with the emulation's matmuls summed in f32
    (``f32_sums``) and on the tensor cores (``tensor_core_sums``, cuBLAS
    with ``allow_tf32``: the split operands are TF32 values, so their
    products are exact either way and only the sums differ)."""
    out = {}
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        for name, tf32 in (("f32_sums", False), ("tensor_core_sums", True)):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            out[name] = float((emulate() - want).abs().max())
            torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    return out
