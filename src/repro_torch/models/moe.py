"""Fine-grained Mixture-of-Experts (port of the reference's
``models/moe.py``, DeepSeekMoE-style): shared experts plus top-k routed
experts with a capacity-bounded, sort-based dispatch.

Capacity C = ceil(T * k / E * capacity_factor); a (token, slot) beyond its
expert's capacity is dropped (its combine weight is zero).  The dispatch
comes from a stable sort of the expert ids, as the reference's does.

The reference fills its (E, C, d) buffer with one scatter ``.at[e, p].set``
in which every dropped (token, slot) writes a zero row at position 0 of
its expert, and XLA applies duplicate indices in order: the last writer
wins, so an expert that overflows loses the row of the first token routed
to it (ROADMAP queue C).  The port builds the same buffer by a gather,
with no scatter at all: position p of expert e takes the p-th entry of e
in sorted order, and row 0 of an expert that overflowed is zero.  The
combine (the reference's ``.at[t].add``) is a sum over each token's k
slots in slot order.  Nothing here reads a device value on the host, so
the decode engine can capture the path in a CUDA graph.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models.common import (P, activation, on_blocks, on_mesh,
                                       settle_grad)
from repro_torch.models.mlp import mlp_decls, mlp_forward


def moe_decls(cfg):
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    decls = {
        "router": P((d, E), ("embed", None), scale=0.02),
        "experts": {
            "w_gate": P((E, d, f), ("experts", "embed", "expert_ffn")),
            "w_up": P((E, d, f), ("experts", "embed", "expert_ffn")),
            "w_down": P((E, f, d), ("experts", "expert_ffn", "embed")),
        },
    }
    if cfg.num_shared_experts:
        decls["shared"] = mlp_decls(cfg, cfg.moe_d_ff * cfg.num_shared_experts)
    return decls


def route(router_w, x, cfg):
    """x: (T, d) -> (weights (T, k), expert ids (T, k), aux loss): f32
    logits, softmax, top-k, DeepSeek's renormalisation and the Switch
    load-balance loss."""
    logits = x.to(torch.float32) @ router_w.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.topk(probs, cfg.experts_per_token, dim=-1)
    top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)
    E = cfg.num_experts
    experts = torch.arange(E, device=x.device)
    one_hot = (top_i[..., None] == experts).to(torch.float32)   # (T, k, E)
    frac_tokens = torch.mean(torch.sum(one_hot, dim=1), dim=0)
    frac_probs = torch.mean(probs, dim=0)
    aux = E * torch.sum(frac_tokens * frac_probs) / cfg.experts_per_token
    return top_w, top_i, aux


def _sorted_dispatch(top_i, E: int):
    """Stable sort of the flat expert ids of ``top_i`` (..., T, k) along the
    last (T * k) axis: (order, sorted ids, each expert's first index in
    the sorted ids (..., E), and its count (..., E)).  On a mesh, each
    rank sorts its block of groups (``searchsorted`` has no sharding
    rules)."""
    if on_mesh(top_i):
        return on_blocks(lambda t: _sorted_dispatch(t, E), (top_i,),
                         (("g", None, None),), (("g", None),) * 4)
    flat_e = top_i.reshape(*top_i.shape[:-2], -1)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, -1, order)
    experts = torch.arange(E, device=top_i.device,
                           dtype=sorted_e.dtype).expand(
        *sorted_e.shape[:-1], E).contiguous()
    first = torch.searchsorted(sorted_e, experts, side="left")
    count = torch.searchsorted(sorted_e, experts, side="right") - first
    return order, sorted_e, first, count


def _positions(order, sorted_e, first):
    """Each flat (token, slot)'s rank within its expert (..., T * k): its
    rank in sorted order less the index where its expert's group starts,
    put back in flat order (``order`` is a permutation: no index repeats)."""
    rank = torch.arange(order.shape[-1], device=order.device).expand_as(order)
    start = torch.gather(first, -1, sorted_e)
    return torch.zeros_like(order).scatter(-1, order, rank - start)


def _dispatch_indices(top_i, E: int, C: int):
    """Sort-based position-in-expert computation.

    top_i: (T, k) expert ids.  Returns (pos (T, k) int32, keep (T, k)):
    each (token, slot)'s position within its expert's capacity buffer, and
    whether it is within C."""
    order, sorted_e, first, _ = _sorted_dispatch(top_i, E)
    pos = _positions(order, sorted_e, first).to(torch.int32)
    return pos.reshape(top_i.shape), (pos < C).reshape(top_i.shape)


def _expert_ffn(buf, w, cfg):
    """(..., E, C, d) -> (..., E, C, d): each expert's gated MLP on its
    rows (one batched product per weight over the experts)."""
    *lead, E, C, d = buf.shape
    rows = buf.reshape(-1, E, C, d).transpose(0, 1).reshape(E, -1, d)
    act = activation(cfg.act)
    h = act(torch.bmm(rows, w["w_gate"])) * torch.bmm(rows, w["w_up"])
    out = torch.bmm(h, w["w_down"])
    return out.reshape(E, -1, C, d).transpose(0, 1).reshape(*lead, E, C, d)


def _dispatch_groups(xt, top_w, top_i, w, cfg, C):
    """Dispatch / compute / combine for G token groups at once: xt (G, Tg,
    d), top_w / top_i (G, Tg, k) -> (G, Tg, d), each group as the
    reference's ``_dispatch_one_group``."""
    G, T, d = xt.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    order, sorted_e, first, count = _sorted_dispatch(top_i, E)
    dev = xt.device
    # (e, p) <- the p-th entry of expert e in sorted order, if p < count
    p = torch.arange(C, device=dev)
    src = torch.clamp(first[..., None] + p, max=T * k - 1)      # (G, E, C)
    flat = torch.gather(order, -1, src.reshape(G, -1)).reshape(G, E, C)
    live = p < count[..., None]
    # an expert that overflowed has its row 0 zeroed, as the reference's
    # last writer (a dropped slot) leaves it
    live = live & ~((p == 0) & (count[..., None] > C))
    tok = torch.div(flat, k, rounding_mode="floor")
    buf = torch.gather(xt, 1, tok.reshape(G, -1, 1).expand(-1, -1, d))
    buf = buf.reshape(G, E, C, d) * live[..., None].to(xt.dtype)
    out_buf = _expert_ffn(buf, w, cfg)                          # (G, E, C, d)
    if on_mesh(out_buf):
        # the combine reads any expert's rows: the experts' dim made whole
        # (an all-gather over the axes that shard it) before the gather,
        # whose backward then scatters into a whole gradient (a sharded
        # one would need a pending sum some releases cannot place)
        from torch.distributed.tensor import Replicate
        out_buf = out_buf.redistribute(out_buf.device_mesh, [
            Replicate() if p.is_shard() and p.dim == 1 else p
            for p in out_buf.placements])

    pos = _positions(order, sorted_e, first)
    flat_e = top_i.reshape(G, -1)
    keep = pos < C
    flat_p = torch.where(keep, pos, torch.zeros_like(pos))
    slot = (flat_e * C + flat_p)[..., None].expand(-1, -1, d)
    per_slot = torch.gather(out_buf.reshape(G, E * C, d), 1, slot)
    wgt = (top_w.reshape(G, -1) * keep).to(per_slot.dtype)[..., None]
    terms = (per_slot * wgt).reshape(G, T, k, d)
    y = torch.zeros((G, T, d), dtype=per_slot.dtype, device=dev)
    for j in range(k):          # the reference's in-order .at[t].add
        y = y + terms[:, :, j]
    return y


def _dispatch_one_group(xt, top_w, top_i, w, cfg, C):
    """Dispatch / compute / combine for one token group.  xt: (T, d)."""
    return _dispatch_groups(xt[None], top_w[None], top_i[None], w, cfg,
                            C)[0]


def moe_forward(params, x, cfg):
    """x: (B, S, d) -> (y, aux loss).

    With ``cfg.moe_groups = G > 1`` dividing the B * S tokens, dispatch is
    grouped (GShard-style): tokens are routed within G groups of
    consecutive tokens, each with its own capacity, as the reference's
    vmap over groups; here the groups go through one batched dispatch."""
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    k = cfg.experts_per_token
    # the tokens feed the router, the dispatch and the shared experts: on a
    # mesh each path's gradient is settled before they are summed
    top_w, top_i, aux = route(params["router"], settle_grad(xt), cfg)

    G = cfg.moe_groups or 1
    if not (G > 1 and T % G == 0):
        G = 1
    Tg = T // G
    C = max(int(math.ceil(Tg * k / cfg.num_experts * cfg.capacity_factor)),
            1)
    y = _dispatch_groups(settle_grad(xt).reshape(G, Tg, d),
                         top_w.reshape(G, Tg, k), top_i.reshape(G, Tg, k),
                         params["experts"], cfg, C).reshape(T, d)
    if cfg.num_shared_experts:
        y = y + mlp_forward(params["shared"], settle_grad(xt)[None], cfg)[0]
    return y.reshape(B, S, d), aux
