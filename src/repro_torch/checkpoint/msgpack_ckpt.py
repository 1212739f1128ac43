"""Msgpack tree checkpoints (port of the reference's
``checkpoint/msgpack_ckpt.py``), file for file compatible with it.

Layout: ``<dir>/step_<n:08d>.msgpack``, written to ``.tmp`` and renamed
into place.  The file is one map ``{"treedef": str, "leaves": [...]}``;
each leaf is ``{"dtype", "shape", "data"}`` with the raw bytes of a
C-ordered array, bfloat16 as its uint16 view.  Leaves go in the
reference's tree order: dict keys sorted, list and tuple items in order
(as a NamedTuple's fields), ``None`` no leaf, so a state tree that
mirrors the reference's has the reference's leaves in its order.  The
``treedef`` string describes the port's tree; restore takes the
structure from its ``target``, as the reference's does.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from repro_torch.checkpoint.msgpack_codec import pack, unpackb
from repro_torch.device import resolve_device

_BF16 = "bfloat16"


def tree_flatten(tree) -> list:
    """The leaves of ``tree`` in the reference's order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_flatten(v)]
    return [tree]


def tree_unflatten(tree, leaves: list):
    """``tree``'s structure with ``leaves`` in its leaf slots."""
    it = iter(leaves)

    def rebuild(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: rebuild(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(rebuild(v) for v in node)
        return next(it)

    out = rebuild(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has slots")
    return out


def _describe(tree) -> str:
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        return "[" + ", ".join(_describe(v) for v in tree) + "]"
    return "*"


def _encode_leaf(x) -> dict:
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return {"dtype": _BF16, "shape": list(t.shape),
                    "data": t.view(torch.int16).numpy().tobytes()}
        arr = t.numpy()
    else:
        arr = np.ascontiguousarray(x)
    return {"dtype": str(arr.dtype), "shape": list(arr.shape),
            "data": arr.tobytes()}


def _decode_leaf(d: dict) -> torch.Tensor:
    """A stored leaf as a CPU tensor (bfloat16 from its uint16 view)."""
    shape = tuple(d["shape"])
    if d["dtype"] == _BF16:
        raw = np.frombuffer(d["data"], np.int16).reshape(shape)
        return torch.from_numpy(raw.copy()).view(torch.bfloat16)
    arr = np.frombuffer(d["data"], np.dtype(d["dtype"])).reshape(shape)
    return torch.from_numpy(arr.copy())


def _path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}.msgpack")


def save_checkpoint(ckpt_dir: str, step: int, tree) -> str:
    """Write ``tree``'s leaves as step ``step``; returns the file's path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    payload = {"treedef": _describe(tree),
               "leaves": [_encode_leaf(x) for x in tree_flatten(tree)]}
    path = _path(ckpt_dir, step)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pack(payload, f.write)
    os.replace(tmp, path)
    return path


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir)
             if (m := re.match(r"step_(\d+)\.msgpack$", f))]
    return max(steps) if steps else None


def read_leaves(ckpt_dir: str, step: int) -> list:
    """Step ``step``'s stored leaves, in order, as CPU tensors."""
    with open(_path(ckpt_dir, step), "rb") as f:
        payload = unpackb(f.read())
    return [_decode_leaf(d) for d in payload["leaves"]]


def check_leaves(stored: list, targets: list, skip=()) -> None:
    """The reference's restore checks: as many leaves as the target, each
    of the target's shape (``skip``: leaf indices exempt from the shape
    check)."""
    if len(stored) != len(targets):
        raise ValueError(f"checkpoint has {len(stored)} leaves, target has "
                         f"{len(targets)}")
    for i, (arr, tgt) in enumerate(zip(stored, targets)):
        if i not in skip and tuple(arr.shape) != tuple(tgt.shape):
            raise ValueError(f"shape mismatch {tuple(arr.shape)} vs "
                             f"{tuple(tgt.shape)}")


def restore_checkpoint(ckpt_dir: str, step: int, target, device=None):
    """Step ``step`` in ``target``'s structure, each leaf cast to the
    target leaf's dtype and moved to ``device`` (CUDA unless ``"cpu"``
    is passed).  ``target``'s leaves need only shapes and dtypes (meta
    tensors do)."""
    dev = resolve_device(device)
    targets = tree_flatten(target)
    stored = read_leaves(ckpt_dir, step)
    check_leaves(stored, targets)
    return tree_unflatten(target, [
        arr.to(device=dev, dtype=tgt.dtype)
        for arr, tgt in zip(stored, targets)])
