"""Generator / discriminator pairs of the paper's §6 (port of the
reference's ``core/gan.py``).

* MLP pair (Tables 1-2, the MNIST configuration):
    D: in -> Linear -> LeakyReLU(0.2) -> Linear -> LeakyReLU(0.2) -> Linear
    G: z  -> Linear -> ReLU -> Linear -> ReLU -> Linear -> tanh
* Conv pair (Tables 3-4, the CelebA/LSUN DCGAN configuration):
    D: Conv/LeakyReLU, (Conv/BN/LeakyReLU) x2 -> Conv (logit)
    G: ConvTranspose/BN/ReLU x3 -> ConvTranspose -> tanh

Weights keep the reference's layout and names: ``{"l1": {"w": (in, out),
"b": (out,)}, ...}`` for the MLP, HWIO ``(k, k, cin, cout)`` kernels and
``{"scale", "bias"}`` batch norms for the conv pair, so a flat D row is
the reference's, element for element.  Images are NHWC at the API, as in
the reference; the conv pair computes on NCHW-shaped tensors held in
channels-last memory (NHWC strides, which cuDNN's f32 grouped
convolutions take without layout transposes), weights permuted at use.
Batch norm takes
the statistics of the batch it is called on (population variance, eps
1e-5, no running statistics), as the reference's does.

``d_apply`` takes stacked parameters with leading user dims too (the
port's form of the reference's ``vmap`` over users): the MLP's ``w (U,
in, out)`` against ``x (U, B, in)`` (or a shared ``(B, in)`` batch) is
one batched matmul; the conv D's ``w (U, k, k, cin, cout)`` against ``x
(U, B, H, W, C)`` (or a shared ``(B, H, W, C)`` batch) is one grouped
convolution per layer with the users folded into the channels, so batch
norm is per user and channel and each user gets exactly its own
gradient.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.common import P, build


@dataclasses.dataclass(frozen=True)
class MLPGanConfig:
    data_dim: int = 784          # 28*28
    z_dim: int = 64
    g_hidden: int = 256
    d_hidden: int = 256
    name: str = "mlp_gan"


def mlp_d_decls(cfg: MLPGanConfig):
    h = cfg.d_hidden
    return {
        "l1": {"w": P((cfg.data_dim, h), (None, "ffn")),
               "b": P((h,), ("ffn",), "zeros")},
        "l2": {"w": P((h, h), ("ffn", None)), "b": P((h,), (None,), "zeros")},
        "l3": {"w": P((h, 1), (None, None)), "b": P((1,), (None,), "zeros")},
    }


def mlp_g_decls(cfg: MLPGanConfig):
    h = cfg.g_hidden
    return {
        "l1": {"w": P((cfg.z_dim, h), (None, "ffn")),
               "b": P((h,), ("ffn",), "zeros")},
        "l2": {"w": P((h, h), ("ffn", None)), "b": P((h,), (None,), "zeros")},
        "l3": {"w": P((h, cfg.data_dim), (None, None)),
               "b": P((cfg.data_dim,), (None,), "zeros")},
    }


def _linear(x, layer):
    b = layer["b"]
    if b.ndim > 1:                      # stacked: (U, out) -> (U, 1, out)
        b = b.unsqueeze(-2)
    return torch.matmul(x, layer["w"]) + b


def mlp_d_apply(params, x):
    """x: (..., B, data_dim) -> logits (..., B)."""
    h = F.leaky_relu(_linear(x, params["l1"]), 0.2)
    h = F.leaky_relu(_linear(h, params["l2"]), 0.2)
    return _linear(h, params["l3"])[..., 0]


def mlp_g_apply(params, z):
    """z: (B, z_dim) -> samples (B, data_dim) in [-1, 1]."""
    h = torch.relu(_linear(z, params["l1"]))
    h = torch.relu(_linear(h, params["l2"]))
    return torch.tanh(_linear(h, params["l3"]))


# ---------------------------------------------------------------------------
# Conv pair (DCGAN)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ConvGanConfig:
    image_size: int = 32         # padded 28->32 or native 32/64
    channels: int = 1
    z_dim: int = 100
    base_filters: int = 64
    name: str = "conv_gan"


def _conv_decl(cin, cout, k=4):
    return {"w": P((k, k, cin, cout), (None, None, None, "ffn"), scale=0.02)}


def _bn_decl(c):
    return {"scale": P((c,), (None,), "ones"),
            "bias": P((c,), (None,), "zeros")}


def conv_d_decls(cfg: ConvGanConfig):
    f = cfg.base_filters
    return {
        "c1": _conv_decl(cfg.channels, f),
        "c2": _conv_decl(f, 2 * f), "bn2": _bn_decl(2 * f),
        "c3": _conv_decl(2 * f, 4 * f), "bn3": _bn_decl(4 * f),
        "c4": _conv_decl(4 * f, 1, k=cfg.image_size // 8),
    }


def conv_g_decls(cfg: ConvGanConfig):
    f = cfg.base_filters
    s0 = cfg.image_size // 8
    return {
        "c1": _conv_decl(cfg.z_dim, 4 * f, k=s0), "bn1": _bn_decl(4 * f),
        "c2": _conv_decl(4 * f, 2 * f), "bn2": _bn_decl(2 * f),
        "c3": _conv_decl(2 * f, f), "bn3": _bn_decl(f),
        "c4": _conv_decl(f, cfg.channels),
    }


def _batchnorm(h, p, eps=1e-5, per_row=False):
    """NCHW ``h``: statistics over the batch and both spatial dims, per
    channel; ``p`` leaves ``(C,)`` or stacked ``(U, C)`` for users folded
    into the channels.  ``per_row``: each image is a batch of its own (the
    statistics of one image), as the reference's serving path applies the
    pair under ``vmap`` over rows."""
    dims = (2, 3) if per_row else (0, 2, 3)
    mu = h.mean(dim=dims, keepdim=True)
    var = torch.square(h - mu).mean(dim=dims, keepdim=True)
    scale = p["scale"].reshape(1, -1, 1, 1)
    bias = p["bias"].reshape(1, -1, 1, 1)
    return (h - mu) * torch.rsqrt(var + eps) * scale + bias


def _oihw(w):
    """HWIO ``(k, k, cin, cout)`` or stacked ``(U, k, k, cin, cout)`` ->
    the ``(U * cout, cin, k, k)`` weight of a convolution whose output
    channels are the users' blocks in turn."""
    if w.ndim == 4:
        return w.permute(3, 2, 0, 1)
    u, k1, k2, cin, cout = w.shape
    return w.permute(0, 4, 3, 1, 2).reshape(u * cout, cin, k1, k2)


_NHWC = torch.channels_last


def _conv(h, w, stride, padding, groups):
    """The reference's ``"SAME"`` convolution at stride 2, k 4 on an even
    size pads 1 on each side; its ``"VALID"`` one pads nothing."""
    return F.conv2d(h.contiguous(memory_format=_NHWC),
                    _oihw(w).contiguous(memory_format=_NHWC), stride=stride,
                    padding=padding, groups=groups)


def conv_d_apply(params, x, per_row=False):
    """x: (B, H, W, C) -> logits (B,); with stacked ``(U, ...)`` params, x
    (U, B, H, W, C) or a shared (B, H, W, C) -> logits (U, B).
    ``per_row``: each image its own batch (``_batchnorm``)."""
    stacked = params["c1"]["w"].ndim == 5
    u = params["c1"]["w"].shape[0] if stacked else 1
    if x.ndim == 5:                # per-user batches: users into channels
        _, b, hh, ww, c = x.shape
        h = x.permute(1, 2, 3, 0, 4).reshape(b, hh, ww, u * c)
        h = h.permute(0, 3, 1, 2)
        g1 = u
    else:                          # one batch, seen by every user
        h = x.permute(0, 3, 1, 2)
        g1 = 1
    h = F.leaky_relu(_conv(h, params["c1"]["w"], 2, 1, g1), 0.2)
    h = F.leaky_relu(_batchnorm(_conv(h, params["c2"]["w"], 2, 1, u),
                                params["bn2"], per_row=per_row), 0.2)
    h = F.leaky_relu(_batchnorm(_conv(h, params["c3"]["w"], 2, 1, u),
                                params["bn3"], per_row=per_row), 0.2)
    h = _conv(h, params["c4"]["w"], 1, 0, u)        # (B, U, 1, 1)
    logits = h[:, :, 0, 0]
    return logits.t() if stacked else logits[:, 0]


def _conv_transpose(h, w, stride, padding):
    """``jax.lax.conv_transpose`` (``transpose_kernel=False``) with an HWIO
    kernel: a transposed convolution by the kernel flipped in both spatial
    dims, as ``(cin, cout, k, k)``.  ``"SAME"`` at stride 2, k 4 is
    ``padding=1``; ``"VALID"`` is ``padding=0``."""
    w = w.flip(0, 1).permute(2, 3, 0, 1)
    return F.conv_transpose2d(h.contiguous(memory_format=_NHWC),
                              w.contiguous(memory_format=_NHWC),
                              stride=stride, padding=padding)


def conv_g_apply(params, z, cfg: ConvGanConfig, per_row=False):
    """z: (B, z_dim) -> images (B, H, W, C) in [-1, 1].  ``per_row``: each
    image its own batch (``_batchnorm``)."""
    h = z[:, :, None, None]
    h = torch.relu(_batchnorm(_conv_transpose(h, params["c1"]["w"], 1, 0),
                              params["bn1"], per_row=per_row))
    assert h.shape[2] == cfg.image_size // 8, (h.shape, cfg.image_size)
    h = torch.relu(_batchnorm(_conv_transpose(h, params["c2"]["w"], 2, 1),
                              params["bn2"], per_row=per_row))
    h = torch.relu(_batchnorm(_conv_transpose(h, params["c3"]["w"], 2, 1),
                              params["bn3"], per_row=per_row))
    h = torch.tanh(_conv_transpose(h, params["c4"]["w"], 2, 1))
    return h.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Bundles
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GanPair:
    """Callable bundle: init + apply for one (G, D) family.  ``g_rows`` /
    ``d_rows`` apply G / D to a batch in which every row is a batch of its
    own (what the reference computes under ``vmap`` over rows, serving's
    form); ``None`` where the pair couples no rows (the MLP), so
    ``g_apply`` / ``d_apply`` serve."""

    cfg: object
    g_decls: object
    d_decls: object
    g_apply: object
    d_apply: object
    z_dim: int
    g_rows: object = None
    d_rows: object = None

    def init(self, generator: torch.Generator, device=None,
             dtype=torch.float32):
        """(g, d) parameter dicts; G's leaves are drawn before D's."""
        g = build(self.g_decls, generator, dtype, device)
        d = build(self.d_decls, generator, dtype, device)
        return g, d

    def sample_z(self, generator: torch.Generator, n: int, device=None):
        """Standard-normal latents, drawn on the host generator and moved
        to ``device`` (the same draws on every device)."""
        z = torch.randn((n, self.z_dim), generator=generator,
                        dtype=torch.float32)
        return z.to(device)


def make_mlp_pair(cfg: MLPGanConfig | None = None) -> GanPair:
    cfg = cfg or MLPGanConfig()
    return GanPair(cfg, mlp_g_decls(cfg), mlp_d_decls(cfg),
                   mlp_g_apply, mlp_d_apply, cfg.z_dim)


def make_conv_pair(cfg: ConvGanConfig | None = None) -> GanPair:
    cfg = cfg or ConvGanConfig()
    return GanPair(cfg, conv_g_decls(cfg), conv_d_decls(cfg),
                   lambda p, z: conv_g_apply(p, z, cfg), conv_d_apply,
                   cfg.z_dim,
                   g_rows=lambda p, z: conv_g_apply(p, z, cfg, per_row=True),
                   d_rows=lambda p, x: conv_d_apply(p, x, per_row=True))
