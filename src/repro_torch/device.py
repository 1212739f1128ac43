"""Device resolution for the port's entry points.

``resolve_device(None)`` is CUDA: the port is written for the GPU, and a
run that silently fell back to the CPU would report CPU numbers under a
GPU's name.  The tests ask for ``device="cpu"`` explicitly, which routes
every kernel wrapper to its plain PyTorch version.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` or ``"cuda"`` -> the current CUDA device (raises when there
    is none); ``"cpu"`` -> the CPU.  A ``torch.device`` passes through
    after the same check."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run the plain PyTorch "
                "path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        # The JAX reference computes in full f32; TF32 would keep ~3
        # decimal digits in every matmul/convolution on the card.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


@contextlib.contextmanager
def deterministic_convolutions():
    """cuDNN restricted to deterministic algorithms, chosen without
    autotuning, for the block's duration (the caller's settings are put
    back after): a convolution's backward then sums in one fixed order,
    so an eager chunk, its CUDA-graph replay and a resumed run agree
    bitwise.  No effect on the CPU."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
