"""PyTorch + CUDA port of the Distributed-GAN federation (``repro``).

The JAX package ``repro`` is the reference; this package mirrors its
module layout (``core/approaches.py``, ``core/federated.py``, ...) so each
port module sits beside its counterpart.  It imports ``torch`` and numpy,
never ``jax`` and nothing of ``repro``.

Entry points run on CUDA unless the caller passes ``device="cpu"``
(:func:`repro_torch.device.resolve_device`); with no GPU and no explicit
CPU request they raise instead of quietly running on the CPU.
"""

import importlib

__all__ = ["resolve_device"]


def __getattr__(name: str):
    # lazy, so a process that imports only torch-free modules (the
    # multihost worker) never imports torch
    if name == "resolve_device":
        return importlib.import_module("repro_torch.device").resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
