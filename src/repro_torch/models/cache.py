"""Decode caches per architecture family (port of the reference's
``models/cache.py``): dense / vlm / MoE self-attention K/V (a ring buffer
of the window, if any), the ssm conv and SSD states, the hybrid's
per-group RG-LRU and windowed K/V states, MLA's compressed ``c_kv`` /
``k_rope`` and the audio decoder's self and cross K/V.

Caches are nested dicts whose leaves carry a leading ``layers`` (or
``groups``) dim, as the stacked layer parameters do.  ``cache_spec`` gives
each leaf's shape and dtype with nothing allocated; ``init_cache`` allocates
zeros.

Slot-pool layout (``repro_torch.serve.decode``): every leaf carries the
batch dim at **axis 1** — ``(L, B, ...)`` — so a cache of width S is a
pool of S independent decode slots, in every family.  ``cache_nbytes``
prices the pool from the spec; ``reset_slots`` zeroes some slots and
``merge_slots`` publishes freshly prefilled rows into theirs, every other
slot keeping its bits.  ``cache_logical_axes`` names each leaf's logical
axes for the decode step's shardings (``launch/steps.py::cache_pspecs``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.common import dtype_of, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """Shape and dtype of one cache leaf (jax's ``ShapeDtypeStruct``)."""

    shape: tuple
    dtype: torch.dtype

    @property
    def nbytes(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n * torch.empty((), dtype=self.dtype).element_size()


def _attn_kv(L, B, T, K, hd, dt):
    return {"k": LeafSpec((L, B, T, K, hd), dt),
            "v": LeafSpec((L, B, T, K, hd), dt)}


def cache_spec(cfg, batch: int, max_len: int):
    """``LeafSpec`` tree of the decode cache (nothing allocated)."""
    dt = dtype_of(cfg.compute_dtype)
    L, B = cfg.num_layers, batch
    at = cfg.arch_type
    if at == "ssm":
        H, N, P_ = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
        W, di = cfg.conv_width, cfg.d_inner
        GN = cfg.ssm_n_groups * cfg.ssm_state
        return {
            "ssd": LeafSpec((L, B, H, N, P_), torch.float32),
            "conv_x": LeafSpec((L, B, W - 1, di), dt),
            "conv_B": LeafSpec((L, B, W - 1, GN), dt),
            "conv_C": LeafSpec((L, B, W - 1, GN), dt),
        }
    if at == "hybrid":
        period = len(cfg.block_pattern)
        G = cfg.num_layers // period
        tail = cfg.num_layers - G * period
        r, W = cfg.lru_width, cfg.conv_width
        Tw = min(max_len, cfg.window) if cfg.window else max_len
        rec = lambda n: {"h": LeafSpec((n, B, r), torch.float32),
                         "conv": LeafSpec((n, B, W - 1, r), dt)}
        spec = {"groups": {"rec1": rec(G), "rec2": rec(G),
                           "attn": _attn_kv(G, B, Tw, cfg.num_kv_heads,
                                            cfg.head_dim, dt)}}
        if tail:
            spec["tail"] = rec(tail)
        return spec
    if cfg.use_mla:
        return {
            "c_kv": LeafSpec((L, B, max_len, cfg.kv_lora_rank), dt),
            "k_rope": LeafSpec((L, B, max_len, cfg.rope_head_dim), dt),
        }
    if cfg.is_encoder_decoder:
        S_src = max(max_len // cfg.encoder_downsample, 1)
        K, hd = cfg.num_kv_heads, cfg.head_dim
        return {"self": _attn_kv(L, B, max_len, K, hd, dt),
                "cross": _attn_kv(L, B, S_src, K, hd, dt)}
    # dense / moe / vlm self-attention: a ring buffer of the window, if any
    T = min(max_len, cfg.window) if cfg.window else max_len
    return _attn_kv(L, B, T, cfg.num_kv_heads, cfg.head_dim, dt)


def _leaf_axes(name: str, nd: int) -> tuple:
    """A cache leaf's logical axes by its name (the reference's rules)."""
    if name in ("k", "v"):
        return (("layers", "batch", None, "kv_heads", None)[:nd] if nd == 5
                else ("batch", None, "kv_heads", None))
    if name == "ssd":
        return ("layers", "batch", "ssm_heads", None, None)
    if name == "conv_x":
        return ("layers", "batch", None, "heads")
    if name in ("conv_B", "conv_C"):
        return ("layers", "batch", None, None)
    if name == "h":
        return ("layers", "batch", "lru_dim")
    if name == "conv":
        return ("layers", "batch", None, "lru_dim")
    if name == "c_kv":
        return ("layers", "batch", None, "kv_lora")
    if name == "k_rope":
        return ("layers", "batch", None, None)
    return ("batch",) + (None,) * (nd - 1)


def cache_logical_axes(cfg):
    """The tree of each cache leaf's logical axes (the decode step's
    shardings), by leaf name; a leaf the rules do not name shards its
    first dim as ``batch``."""

    def walk(tree, name):
        if isinstance(tree, dict):
            return {k: walk(tree[k], k) for k in sorted(tree)}
        return _leaf_axes(name, len(tree.shape))

    return walk(cache_spec(cfg, 2, 8), None)


def init_cache(cfg, batch: int, max_len: int, *, device=None):
    """Zeros in the layout of ``cache_spec`` on ``device``."""
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                          device=device),
                    cache_spec(cfg, batch, max_len))


def cache_nbytes(cfg, batch: int, seq_len: int) -> int:
    """Decode-cache footprint of a (batch, seq_len) serving shape from the
    spec: the one pricing function for ``launch.serve.greedy_decode``'s
    per-request caches and the decode engine's slot pool."""
    return sum(s.nbytes for s in tree_leaves(cache_spec(cfg, batch, seq_len)))


def _slot_mask(valid: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """A per-slot bool (B,) broadcast against a (L, B, ...) leaf."""
    return valid.to(device=leaf.device, dtype=torch.bool).reshape(
        (1, -1) + (1,) * (leaf.ndim - 2))


def _as_bool(valid) -> torch.Tensor:
    return valid if isinstance(valid, torch.Tensor) else torch.as_tensor(
        valid, dtype=torch.bool)


def reset_slots(cache, valid):
    """Zero the slots where ``valid`` (bool (B,)) is True; every other slot
    keeps its bits (a freed slot leaks nothing into the next tenant)."""
    valid = _as_bool(valid)
    return tree_map(lambda c: torch.where(_slot_mask(valid, c),
                                          torch.zeros_like(c), c), cache)


def merge_slots(pool, fresh, valid):
    """``fresh`` (the pool's layout) in the slots where ``valid`` is True,
    ``pool``'s bits in every other slot.  A prefilled row replaces its
    slot's whole state (the fresh side starts from zeros), so admission is
    the per-slot reset too."""
    valid = _as_bool(valid)
    return tree_map(lambda p, f: torch.where(_slot_mask(valid, p), f, p),
                    pool, fresh)
