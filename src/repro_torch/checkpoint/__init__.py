"""Checkpoints in the reference's layout (``msgpack_ckpt``) over the
port's own MessagePack codec (``msgpack_codec``, numpy-free and torch-free,
which the multihost worker imports alone)."""

import importlib

__all__ = ["save_checkpoint", "latest_step", "restore_checkpoint",
           "read_leaves", "tree_flatten", "tree_unflatten"]


def __getattr__(name: str):
    # lazy: importing the codec must not import torch
    if name in __all__:
        return getattr(importlib.import_module(
            "repro_torch.checkpoint.msgpack_ckpt"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
