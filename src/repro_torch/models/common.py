"""Shared building blocks (port of the reference's ``models/common.py``):
typed parameter declarations and ``build``, norms, activations, RoPE and
softcap.

Parameter trees are plain nested dicts of tensors.  ``build`` walks the
declarations in sorted-key order, the order jax flattens a dict in, so the
n-th leaf drawn here is the n-th leaf of the reference's tree.  The draws
themselves come from a CPU ``torch.Generator`` (jax's threefry stream
cannot be reproduced), so one seed gives the same weights on every device;
a CUDA generator draws on its card instead (other values, drawn fast: the
full-width smoke runs on the card use it).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch import prng


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


@dataclasses.dataclass(frozen=True)
class P:
    """A parameter declaration: shape, per-dim logical axes, initializer."""

    shape: tuple[int, ...]
    logical: tuple[str | None, ...]
    init: str = "normal"          # normal | zeros | ones | uniform_scaled | custom
    scale: float | None = None    # stddev override for "normal"
    fn: Callable | None = None    # custom init fn(generator, shape, dtype)

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)

    def materialize(self, generator: torch.Generator, dtype: torch.dtype):
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dtype,
                               device=generator.device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dtype,
                              device=generator.device)
        if self.init == "custom":
            return self.fn(generator, self.shape, dtype)
        fan_in = self.shape[0]
        if self.init == "uniform_scaled":
            bound = math.sqrt(3.0 / fan_in)
            u = torch.rand(self.shape, generator=generator,
                           dtype=torch.float32, device=generator.device)
            return (u * (2 * bound) - bound).to(dtype)
        std = self.scale
        if std is None:
            std = 1.0 / math.sqrt(max(fan_in, 1))
        z = torch.randn(self.shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return (z * std).to(dtype)


def tree_leaves(tree) -> list:
    """Leaves of a nested dict in jax's flatten order (sorted keys)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    """``jax.tree.map`` over nested dicts (structure taken from ``tree``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def build(decls, generator: torch.Generator, dtype=torch.float32,
          device=None):
    """Materialize a nested dict of :class:`P` declarations into tensors,
    drawing leaves in sorted-key order from ``generator`` (on its device),
    then moving them to ``device``."""
    return tree_map(
        lambda d: d.materialize(generator, dtype).to(device), decls)


def on_mesh(t) -> bool:
    """True for a DTensor (a tensor placed on a device mesh)."""
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def axes_of(decls):
    """The parallel tree of logical-axes tuples (what ``sharding.rules``
    reads), from the same declarations ``build`` draws."""
    return tree_map(lambda d: d.logical, decls)


def stack_decls(decls, n: int, axis_name: str = "layers"):
    """Lift a per-layer declaration tree to an n-layer stacked tree: prepend
    a ``layers`` dim to every leaf."""
    return tree_map(lambda d: P((n,) + d.shape, (axis_name,) + d.logical,
                                d.init, d.scale, d.fn), decls)


# ---------------------------------------------------------------------------
# Norms / activations
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps: float):
    """RMSNorm in f32; ``scale`` stores (scale - 1), applied as ``1 + scale``."""
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.to(torch.float32))).to(dt)


def layer_norm(x, scale, bias, eps: float):
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps)
    return (out * scale.to(torch.float32)
            + bias.to(torch.float32)).to(dt)


def norm_decl(cfg, width: int | None = None):
    d = width or cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": P((d,), (None,), "ones"),
                "bias": P((d,), (None,), "zeros")}
    return {"scale": P((d,), (None,), "zeros")}  # rmsnorm stores (scale-1)


def apply_norm(params, x, cfg):
    if cfg.norm == "layernorm":
        return layer_norm(x, params["scale"], params["bias"], cfg.norm_eps)
    return rms_norm(x, params["scale"], cfg.norm_eps)


def settle_grad(x):
    """``x`` itself; on a mesh, its gradient arrives in ``x``'s own
    placements (a pending sum completed, shards gathered) before it flows
    on.  For a tensor used on several paths whose gradients DTensor would
    otherwise have to add in placements some releases cannot reconcile (a
    shard and a pending sum)."""
    if not on_mesh(x):
        return x
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(x.to_local(grad_placements=x.placements),
                              x.device_mesh, x.placements, run_check=False,
                              shape=x.shape, stride=x.stride())


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient leaves contiguous: DTensor's backward
    of a reshape views a block's gradient, which some releases refuse on
    a permuted one (an attention block's k and v)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def on_blocks(fn, args, roles, out_roles):
    """``fn(*args)`` of tensors whose dims named in ``roles`` (one tuple
    per argument: a name such as "b" or "h" per independent dim, None
    elsewhere) are computed independently, and ``out_roles`` the same of
    its output (a tuple of them for several outputs).  On DTensors it
    runs on each rank's block, as ``local_map`` runs a function: every
    mesh dim that shards the first argument along a named dim shards each
    argument along its dim of that name (a dim of size 1 broadcasts and
    stays whole), every other dim is replicated and a pending sum
    completed first; plain tensors join replicated.  Autograd runs
    through ``to_local`` / ``from_local``.  Off a mesh: ``fn(*args)``."""
    if not on_mesh(args[0]):
        return fn(*args)
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = args[0].device_mesh
    axes = [roles[0][p.dim] if p.is_shard() else None
            for p in args[0].placements]

    def placements(rl, shape=None):
        return [Shard(rl.index(r)) if r is not None and r in rl and (
            shape is None or shape[rl.index(r)] > 1) else Replicate()
            for r in axes]

    local = []
    for a, rl in zip(args, roles):
        if isinstance(a, torch.Tensor):
            if not on_mesh(a):
                a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                       run_check=False)
            a = a.redistribute(mesh, placements(rl, a.shape)).to_local()
            if a.requires_grad:
                a = _ContiguousGrad.apply(a)
        local.append(a)
    out = fn(*local)
    if isinstance(out, tuple):
        return tuple(DTensor.from_local(y, mesh, placements(rl),
                                        run_check=False)
                     for y, rl in zip(out, out_roles))
    return DTensor.from_local(out, mesh, placements(out_roles),
                              run_check=False)


def _elementwise(fn, *xs):
    """``fn`` of elementwise, position-free tensors of one shape: on
    DTensors, of each rank's block (``on_blocks``, every dim
    independent), since ``prng``'s bit-level formulas have no sharding
    rules of their own."""
    dims = tuple(range(xs[0].ndim))
    return on_blocks(fn, xs, (dims,) * len(xs), dims)


def _cpu_unary(name: str, fwd, bwd):
    """An elementwise function for CPU tensors as an autograd Function:
    the forward ``fwd(x)`` on ``x`` in f32 (XLA's formula, bit for bit,
    position-free) rounded once to ``x``'s type; the backward ``bwd(x, y,
    g)`` in f32, jax's derivative rule for the same primitive (``y`` the
    f32 output), so a gradient never differentiates through ``prng``'s
    bit manipulations (``prng.log`` builds its result from integer views,
    which carry no gradient).  On a DTensor both run on each rank's block
    (``_elementwise``)."""

    def forward(ctx, x):
        xf = x.to(torch.float32)
        y = _elementwise(fwd, xf)
        ctx.save_for_backward(xf, y)
        return y.to(x.dtype)

    def backward(ctx, g):
        xf, y = ctx.saved_tensors
        return _elementwise(bwd, xf, y, g.to(torch.float32)).to(g.dtype)

    return type(name, (torch.autograd.Function,),
                {"forward": staticmethod(forward),
                 "backward": staticmethod(backward)}).apply


def _no_inf(x):
    """jax's ``_replace_inf``: +inf -> 0 (the logaddexp rule's guard)."""
    return torch.where(x == float("inf"), torch.zeros_like(x), x)


# exp: t * y;  logistic: t * y * (1 - y);  tanh: (t + t y) * (1 - y);
# logaddexp(x, 0): t * exp(x - out), both with +inf replaced by 0
_exp = _cpu_unary("XlaExp", prng.exp, lambda x, y, g: g * y)
_sigmoid = _cpu_unary("XlaLogistic",
                      lambda x: 1.0 / (prng.exp(-x) + 1.0),
                      lambda x, y, g: g * (y * (1.0 - y)))
_tanh = _cpu_unary("XlaTanh", prng.tanh,
                   lambda x, y, g: (g + g * y) * (1.0 - y))
_softplus = _cpu_unary(
    "XlaSoftplus",
    lambda x: torch.clamp(x, min=0.0) + prng.log1p(prng.exp(-torch.abs(x))),
    lambda x, y, g: g * prng.exp(_no_inf(x) - _no_inf(y)))
# log_sigmoid(x) = -softplus(-x): its rule is softplus's at -x, -y
_log_sigmoid = _cpu_unary(
    "XlaLogSigmoid",
    lambda x: torch.clamp(x, max=0.0) - prng.log1p(prng.exp(-torch.abs(x))),
    lambda x, y, g: g * prng.exp(_no_inf(-x) - _no_inf(-y)))


def _card_form(x) -> bool:
    """True where torch's own elementwise ops run: on every device but
    the CPU (CUDA, and ``meta``, where the dry run counts the card's
    program); the CPU takes the reference's formulas below."""
    return x.device.type != "cpu"


def silu(x):
    """SiLU, ``x * sigmoid(x)`` as jax writes it.  On the CPU in f32 with
    the reference's own exp (``prng.exp``): torch's vectorised CPU loops
    evaluate the tail of a tensor (and of each thread's chunk) another way
    than its body, in ``silu`` and in ``exp`` alike, so a row's bits would
    depend on where it sits in the batch, which the serving contract
    forbids (a slot's bytes are the same in any batch).  On CUDA every
    element takes the same path already.  Its gradient is the product
    rule over ``sigmoid``'s, as jax differentiates it."""
    if _card_form(x):
        return F.silu(x)
    xf = x.to(torch.float32)
    return (xf * _sigmoid(xf)).to(x.dtype)


def softplus(x):
    """jax's ``logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))``; on the CPU
    with the reference's exp and log1p (``prng``), position-free for the
    reason ``silu`` gives, and jax's gradient ``exp(x - softplus(x))``."""
    if _card_form(x):
        return F.softplus(x)
    return _softplus(x)


def exp(x):
    """e^x.  On the CPU, in f32, the reference's own formula (XLA's CPU
    exp, bit for bit: ``prng.exp``), which differs from torch's in a tenth
    of all entries by an ULP, with the gradient ``t * e^x``; on CUDA
    torch's."""
    if _card_form(x):
        return torch.exp(x)
    return _exp(x)


def sigmoid(x):
    """``1 / (exp(-x) + 1)``, XLA's expansion of the logistic; on the CPU
    by ``exp`` (position-free, as ``silu``: torch's CPU ``sigmoid`` takes
    another path at a tensor's tail), with the gradient ``t y (1 - y)``."""
    if _card_form(x):
        return torch.sigmoid(x)
    return _sigmoid(x)


def log_sigmoid(x):
    """jax's ``-softplus(-x) = min(x, 0) - log1p(exp(-|x|))``; on the CPU
    with XLA's exp and log1p (``prng``), position-free, and softplus's
    gradient at -x.  A DTensor off the CPU takes that formula in torch's
    ops: ``F.logsigmoid``'s backward has no sharding rule."""
    if _card_form(x):
        if on_mesh(x):
            return torch.clamp(x, max=0.0) - torch.log1p(
                torch.exp(-torch.abs(x)))
        return F.logsigmoid(x)
    return _log_sigmoid(x)


def _f32(c: float) -> float:
    return torch.tensor(c, dtype=torch.float32).item()


def tanh(x):
    """tanh.  On the CPU, in f32, the reference's own formula (XLA's CPU
    tanh, bit for bit: ``prng.tanh``), which differs from torch's in a
    third of all entries by an ULP, with jax's gradient ``(t + t y)(1 -
    y)``; on CUDA torch's."""
    if _card_form(x):
        return torch.tanh(x)
    return _tanh(x)


def softmax(x, dim: int = -1):
    """``exp(x - max) / sum`` over ``dim``, as ``jax.nn.softmax`` writes
    it; on the CPU through ``exp`` (position-free), on CUDA torch's."""
    if _card_form(x):
        return torch.softmax(x, dim=dim)
    e = exp(x - torch.amax(x, dim=dim, keepdim=True).detach())
    return e / torch.sum(e, dim=dim, keepdim=True)


_SQRT_2_OVER_PI = _f32(math.sqrt(2.0 / math.pi))


def _gelu_tanh(x):
    """jax.nn.gelu's default tanh approximation, ``x * 0.5 * (1 + tanh(
    sqrt(2/pi) (x + 0.044715 x^3)))``; on the CPU in f32 as the reference's
    jitted program evaluates it (``x + 0.044715 x^3`` one fused
    multiply-add, the reference's ``tanh``), by elementwise ops (torch's
    fused CPU ``gelu`` is not position-free, as ``silu``); its gradient is
    the chain rule over them, as jax differentiates the formula."""
    if _card_form(x):
        return F.gelu(x, approximate="tanh")
    xf = x.to(torch.float32)
    inner = _SQRT_2_OVER_PI * prng.fma(xf * xf * xf, _f32(0.044715), xf)
    return (xf * (0.5 * (1.0 + tanh(inner)))).to(x.dtype)


def activation(name: str):
    return {"silu": silu, "gelu": _gelu_tanh, "relu": F.relu}[name]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    """(head_dim // 2,) f32 inverse frequencies."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd) or (..., S, hd); positions: (..., S).  Rotates the
    two halves of hd (not interleaved pairs) with f32 angles."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, device=x.device)
    ang = positions[..., None].to(torch.float32) * inv   # (..., S, hd/2)
    sin, cos = torch.sin(ang), torch.cos(ang)
    if x.ndim == positions.ndim + 2:                     # head axis present
        sin, cos = sin[..., None, :], cos[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x, cap: float):
    if cap and cap > 0:
        return tanh(x / cap) * cap
    return x
