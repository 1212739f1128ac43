"""The paper's three Distributed-GAN approaches and the single-node
baseline as PyTorch round bodies (port of the reference's
``core/approaches.py``): approach 1 (alg. 1, selective-gradient federated
server discriminator) and its ``download_first`` variant, approach 2
(alg. 2, averaged-output multi-discriminator), approach 3 (alg. 3,
round-robin G against each D_j) and ``baseline`` (one GAN on the union
data), each with the paper's BCE objective or, under ``loss_type="wgan"``,
the weight-clipped W-GAN critic (clipped after every D step).  The bodies
take any ``GanPair``: the MLP pair and the DCGAN conv pair run the same
code.

State layout, as in the reference:

    DistGANState(g, g_opt, ds, d_opts, server_d, step, generator)

``ds`` holds the U local discriminators stacked on a leading user axis
(``w (U, in, out)``); user u's real data enters only through slice u of
``real (U, B, data_dim)``; under the cohort engine the user axis holds
the C gathered rows.  On a rank of the SPMD engines (``core/spmd.py``)
the state holds that rank's user only: ``ds`` / ``d_opts`` with a leading
axis of 1, and G, its optimizer, the server D, the step and the generator
replicated, equal on every rank.  The reference's ``vmap`` over users is a batched
matmul over that leading axis, and one backward pass over the sum of the
per-user losses gives each user exactly its own gradient (the users share
no parameter).

The body updates D, G, the server D and every optimizer buffer IN PLACE,
where the reference donates the state to its jitted step
(``approaches.py:163-167``, ``engine.py:101``).  A round's noise (the
latent batches, the stochastic-rounding seed, the ``random`` selection's
uniforms) is drawn from the state's host ``torch.Generator`` by the
approach's registered noise function (``make_*_noise``), in the order
the body consumes it, so a run's draws do not depend on the device.  The
body takes any of them as keywords and draws only the rest: the CUDA-graph
engines draw a chunk's noise before a replay and hand it in through
device buffers, and the tests inject the reference's own draws (``z1``,
``z2``, ``seed``; approach 3 takes one pair per member, stacked ``(C, B,
z_dim)``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import losses
from repro_torch.core.federated import (codec_transport, make_flat_layout,
                                        random_uniforms, select_delta_flat,
                                        shared_random_idx)
from repro_torch.core.spec import register_approach, resolve_combiner
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim import adamw, apply_updates


@dataclasses.dataclass
class DistGANState:
    g: Any
    g_opt: Any
    ds: Any          # stacked (U, ...) local discriminators
    d_opts: Any      # stacked optimizer states (step is (U,))
    server_d: Any    # approach 1's server discriminator
    step: torch.Tensor
    generator: torch.Generator   # host generator for the round noise

    def clone(self) -> "DistGANState":
        """A deep copy (tensors and the host generator's position)."""
        gen = torch.Generator()
        gen.set_state(self.generator.get_state())
        copy = lambda t: t.clone()
        return DistGANState(*(tree_map(copy, getattr(self, f)) for f in
                              ("g", "g_opt", "ds", "d_opts", "server_d")),
                            self.step.clone(), gen)


@dataclasses.dataclass(frozen=True)
class DistGANConfig:
    num_users: int = 2
    g_lr: float = 2e-4
    d_lr: float = 2e-4
    b1: float = 0.5          # paper-era DCGAN Adam betas
    b2: float = 0.999
    selection: str = "topk"  # approach 1 upload policy
    upload_frac: float = 0.1
    combiner: str = "max_abs"
    server_scale: float = 1.0  # fold factor for combined deltas
    staleness_decay: float = 0.5  # delta age discount (staleness_* combiners)
    use_topk_kernel: bool = True  # Hopper top-k + int8 codec kernels
    loss_type: str = "bce"     # bce (paper) | wgan (beyond-paper, ref [1])
    wgan_clip: float = 0.05
    codec: str = "none"        # upload wire codec (spec.CODECS)
    error_feedback: bool = True   # EF-SGD residual for lossy codecs
    codec_stochastic: bool = False  # stochastic rounding (int8 codecs)
    stage_rows: bool = False   # host/SPMD backends only


def _opts(fcfg: DistGANConfig):
    g_opt = adamw(fcfg.g_lr, b1=fcfg.b1, b2=fcfg.b2)
    d_opt = adamw(fcfg.d_lr, b1=fcfg.b1, b2=fcfg.b2)
    return g_opt, d_opt


def init_state(pair, fcfg: DistGANConfig, seed: int, device, *,
               sync_ds: bool = False) -> DistGANState:
    """Fresh state.  G and D are drawn from a host generator seeded with
    ``seed`` (so the weights are the same on every device); the round
    noise generator continues that stream.  ``sync_ds=True`` (approach 1):
    local Ds start at the server weights (paper §3.1 step 1); otherwise
    each user draws its own D."""
    gen = torch.Generator().manual_seed(seed)
    g_opt_def, d_opt_def = _opts(fcfg)
    g, d0 = pair.init(gen, device)
    u = fcfg.num_users
    if sync_ds:
        ds = tree_map(lambda s: s.unsqueeze(0).repeat((u,) + (1,) * s.ndim),
                      d0)
    else:
        users = [pair.init(gen, device)[1] for _ in range(u)]
        ds = tree_map(lambda *leaves: torch.stack(leaves), *users)
    return DistGANState(g, g_opt_def.init(g), ds, d_opt_def.init(ds, (u,)),
                        d0, torch.zeros((), dtype=torch.int32, device=device),
                        gen)


def _d_shapes(pair):
    return tree_map(lambda d: torch.empty(d.shape, device="meta"),
                    pair.d_decls)


def state_template(pair, fcfg: DistGANConfig) -> DistGANState:
    """``init_state``'s shapes and types as meta tensors (nothing drawn)."""
    g_opt_def, d_opt_def = _opts(fcfg)
    meta = lambda d: torch.empty(d.shape, device="meta")
    g, d0 = tree_map(meta, pair.g_decls), tree_map(meta, pair.d_decls)
    u = fcfg.num_users
    ds = tree_map(lambda t: torch.empty((u,) + t.shape, device="meta"), d0)
    return DistGANState(g, g_opt_def.init(g), ds, d_opt_def.init(ds, (u,)),
                        d0, torch.empty((), dtype=torch.int32, device="meta"),
                        torch.Generator())


def d_flat_layout(pair):
    """FlatLayout of one discriminator of ``pair`` (shapes only)."""
    return make_flat_layout(_d_shapes(pair))


def d_opt_flat_layout(pair, fcfg: DistGANConfig):
    """FlatLayout of one user's D-optimizer state in jax tree order
    (``mu`` leaves, ``nu`` leaves, ``step``), the int step stored as f32:
    the cohort store's optimizer rows line up with the reference's."""
    _, d_opt_def = _opts(fcfg)
    return make_flat_layout(d_opt_def.init(_d_shapes(pair)))


def _grad(loss_fn, params):
    """(loss, grads) of ``loss_fn(params)`` w.r.t. every leaf, taken on
    detached copies so the caller can update ``params`` in place."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    proxy = tree_map(lambda _: next(it), params)
    loss = loss_fn(proxy)
    grads = torch.autograd.grad(loss.sum(), leaves)
    git = iter(grads)
    return loss.detach(), tree_map(lambda _: next(git), params)


def _d_update_fn(pair, d_opt_def, fcfg: DistGANConfig | None = None):
    """All users' D steps at once: ``ds``/``opts`` stacked on the user
    axis, ``real (U, B, ...)``, one shared ``fake (B, ...)``.  Under
    ``loss_type="wgan"`` the critic loss, and every D clipped to
    ``[-wgan_clip, wgan_clip]`` after its step."""
    wgan = fcfg is not None and fcfg.loss_type == "wgan"
    d_loss = losses.wgan_d_loss if wgan else losses.d_loss

    def update(ds, opts, real, fake):
        def loss_fn(dp):
            return d_loss(pair.d_apply(dp, real), pair.d_apply(dp, fake))
        loss, grads = _grad(loss_fn, ds)                    # (U,)
        apply_updates(ds, d_opt_def.update(grads, opts, ds))
        if wgan:
            losses.clip_params(ds, fcfg.wgan_clip)
        return loss
    return update


def _g_loss_single(fcfg: DistGANConfig, scores):
    if fcfg.loss_type == "wgan":
        return losses.wgan_g_loss(scores)
    return losses.g_loss_nonsat(scores)


def _g_step(pair, fcfg, g_opt_def, state, d, z):
    """One G step against discriminator ``d`` (the non-saturating or the
    W-GAN generator loss on ``G(z)``); returns the loss."""

    def g_loss(gp):
        return _g_loss_single(fcfg, pair.d_apply(d, pair.g_apply(gp, z)))

    gl, grads = _grad(g_loss, state.g)
    with torch.no_grad():
        apply_updates(state.g, g_opt_def.update(grads, state.g_opt, state.g))
    return gl.reshape(())


def _copy_into(dst_tree, src_tree) -> None:
    for d, s in zip(tree_leaves(dst_tree), tree_leaves(src_tree)):
        d.copy_(s)


# ---------------------------------------------------------------------------
# Round noise: each approach's host draws, in the order its body takes them
# ---------------------------------------------------------------------------

def _draw_seed(generator: torch.Generator) -> torch.Tensor:
    """A stochastic-rounding seed in [0, 2**31 - 1) as a (1,) int32 tensor,
    which the codec kernel reads on the device."""
    value = int(torch.randint(0, 2**31 - 1, (), generator=generator))
    return torch.tensor([value], dtype=torch.int32)


def make_approach1_noise(pair, fcfg: DistGANConfig):
    """Approach 1 (and ``download_first``): ``z1``, ``z2`` (B, z_dim); then
    ``seed`` iff a lossy codec rounds stochastically; then ``uniforms``
    (C, N) iff the selection is ``random``; then ``idx``, the shared
    coordinates, iff it is ``shared_random`` (the SPMD body's: every rank
    draws the round's noise from the same replicated generator, with C =
    1, as the reference's shards split one replicated key)."""
    n = d_flat_layout(pair).n
    stochastic = fcfg.codec != "none" and fcfg.codec_stochastic
    uniform = fcfg.selection == "random"
    shared = fcfg.selection == "shared_random"

    def draw(gen, real_shape, z1=None, z2=None, seed=None, uniforms=None,
             idx=None):
        C, B = real_shape[0], real_shape[1]
        out = {"z1": pair.sample_z(gen, B) if z1 is None else z1,
               "z2": pair.sample_z(gen, B) if z2 is None else z2}
        if stochastic:
            out["seed"] = _draw_seed(gen) if seed is None else seed
        if uniform:
            out["uniforms"] = (random_uniforms((C, n), gen)
                               if uniforms is None else uniforms)
        if shared:
            out["idx"] = (shared_random_idx(n, fcfg.upload_frac, gen)
                          if idx is None else idx)
        return out

    return draw


def _latent_noise(batch_axis: int):
    """``z1`` then ``z2`` (B, z_dim), B the real batch's ``batch_axis``."""

    def factory(pair, fcfg: DistGANConfig):
        def draw(gen, real_shape, z1=None, z2=None):
            B = real_shape[batch_axis]
            return {"z1": pair.sample_z(gen, B) if z1 is None else z1,
                    "z2": pair.sample_z(gen, B) if z2 is None else z2}
        return draw

    return factory


make_approach2_noise = _latent_noise(1)
make_baseline_noise = _latent_noise(0)


def make_approach3_noise(pair, fcfg: DistGANConfig):
    """Approach 3: member by member, ``z1[j]`` then ``z2[j]`` (B, z_dim),
    stacked (C, B, z_dim)."""

    def draw(gen, real_shape, z1=None, z2=None):
        if z1 is not None and z2 is not None:
            return {"z1": z1, "z2": z2}
        C, B = real_shape[0], real_shape[1]
        za, zb = [], []
        for j in range(C):
            za.append(pair.sample_z(gen, B) if z1 is None else z1[j])
            zb.append(pair.sample_z(gen, B) if z2 is None else z2[j])
        return {"z1": torch.stack(za), "z2": torch.stack(zb)}

    return draw


def _on(dev, t):
    """A drawn tensor on ``dev`` (an int seed passes through)."""
    return t.to(dev) if isinstance(t, torch.Tensor) else t


# ---------------------------------------------------------------------------
# Approach 1: selective-gradient federated server discriminator
# ---------------------------------------------------------------------------

def make_approach1_body(pair, fcfg: DistGANConfig):
    g_opt_def, d_opt_def = _opts(fcfg)
    d_update = _d_update_fn(pair, d_opt_def, fcfg)
    combiner = resolve_combiner(fcfg.combiner)
    layout = d_flat_layout(pair)
    lossy = fcfg.codec != "none"
    ef = lossy and fcfg.error_feedback
    draw = make_approach1_noise(pair, fcfg)

    def body(state: DistGANState, real, ages=None, weights=None,
             residual=None, *, z1=None, z2=None, seed=None, uniforms=None):
        """real: (C, B, ...) private batches of the participating users.
        ``ages`` (C,) feeds the staleness-aware combiners, ``weights`` (C,)
        scales each member's upload before the fold, ``residual`` (C, N)
        is each member's error-feedback row (passed iff the codec is
        lossy and error feedback is on; the body then returns
        ``(state, metrics, new_residual)``).  ``z1``/``z2`` (B, z_dim),
        ``seed`` (an int or a (1,) int32 tensor) and ``uniforms`` (C, N)
        replace the generator's draws when given.  Metrics stay on the
        device."""
        assert (residual is not None) == ef, \
            "residual rows are passed iff a lossy codec runs with " \
            "error feedback"
        dev = real.device
        noise = {k: _on(dev, v) for k, v in draw(
            state.generator, real.shape, z1=z1, z2=z2, seed=seed,
            uniforms=uniforms).items()}
        z1, z2 = noise["z1"], noise["z2"]

        with torch.no_grad():
            fake = pair.g_apply(state.g, z1)
            old_flat = layout.flatten_stacked(state.ds)        # (C, N) copy
        d_losses = d_update(state.ds, state.d_opts, real, fake)

        with torch.no_grad():
            # users upload selected deltas; the server folds them (alg. 1
            # lines 3-5) — one (C, N) subtract, one row-batched selection,
            # one argmax-|.| over a contiguous buffer
            delta = layout.flatten_stacked(state.ds) - old_flat
            if ef:
                # EF-SGD: re-add what last round's compression dropped
                # before selection
                delta = delta + residual
            masked, kept = select_delta_flat(
                delta, fcfg.selection, frac=fcfg.upload_frac,
                uniforms=noise.get("uniforms"),
                use_kernel=fcfg.use_topk_kernel)
            if lossy:
                masked = codec_transport(masked, fcfg.codec,
                                         stochastic=fcfg.codec_stochastic,
                                         seed=noise.get("seed"),
                                         use_kernel=fcfg.use_topk_kernel)
            if ef:
                new_residual = delta - masked
            if weights is not None:
                masked = masked * weights[:, None]
            if getattr(combiner, "needs_ages", False):
                combined = combiner(masked, ages, decay=fcfg.staleness_decay)
            else:
                combined = combiner(masked)                    # (N,)
            server_flat = (layout.flatten(state.server_d)
                           + fcfg.server_scale * combined)
            _copy_into(state.server_d, layout.unflatten(server_flat))
            # download phase (paper §3.1): local models re-sync to the
            # server so next round's deltas are w.r.t. the shared point
            for d, s in zip(tree_leaves(state.ds),
                            tree_leaves(state.server_d)):
                d.copy_(s.unsqueeze(0).expand_as(d))

        # G trains against the server D only (alg. 1 lines 7-10)
        gl = _g_step(pair, fcfg, g_opt_def, state, state.server_d, z2)
        with torch.no_grad():
            state.step += 1
        metrics = {"d_loss": d_losses, "g_loss": gl,
                   "kept_frac": torch.mean(kept)}
        if ef:
            return state, metrics, new_residual
        return state, metrics

    return body


# ---------------------------------------------------------------------------
# Approach 1 variant: download-first sync
# ---------------------------------------------------------------------------

def make_download_first_body(pair, fcfg: DistGANConfig):
    """Approach 1 with a download phase BEFORE local training: every member
    overwrites its local D with the current server D, then trains and
    uploads; ages are zeroed for the combiner.  Under full participation
    every member re-synced last round, so this equals ``approach1``."""
    base = make_approach1_body(pair, fcfg)

    def body(state: DistGANState, real, ages=None, weights=None,
             residual=None, **noise):
        with torch.no_grad():
            for d, s in zip(tree_leaves(state.ds),
                            tree_leaves(state.server_d)):
                d.copy_(s.unsqueeze(0).expand_as(d))
        zero_ages = None if ages is None else torch.zeros_like(ages)
        return base(state, real, zero_ages, weights, residual, **noise)

    return body


# ---------------------------------------------------------------------------
# Approaches 2, 3 and the baseline
# ---------------------------------------------------------------------------

def _row(tree, j: int):
    """Member ``j`` of a stacked tree as (1, ...) views: in-place updates
    of the views land in the stacked tensors."""
    return tree_map(lambda x: x[j:j + 1], tree)


def _one(dev):
    return torch.ones((), dtype=torch.float32, device=dev)


def make_approach2_body(pair, fcfg: DistGANConfig):
    g_opt_def, d_opt_def = _opts(fcfg)
    d_update = _d_update_fn(pair, d_opt_def, fcfg)
    draw = make_approach2_noise(pair, fcfg)
    g_loss_avg = (losses.wgan_g_loss_avg if fcfg.loss_type == "wgan"
                  else losses.g_loss_avg_probs)

    def body(state: DistGANState, real, ages=None, weights=None, *,
             z1=None, z2=None):
        """Every member trains its D on the shared fake batch; G trains
        against the members' AVERAGED output probabilities (alg. 2; the
        averaged critic scores under W-GAN)."""
        dev = real.device
        noise = draw(state.generator, real.shape, z1=z1, z2=z2)
        z1, z2 = noise["z1"].to(dev), noise["z2"].to(dev)
        with torch.no_grad():
            fake = pair.g_apply(state.g, z1)
        d_losses = d_update(state.ds, state.d_opts, real, fake)
        ds = state.ds

        def g_loss(gp):
            return g_loss_avg(pair.d_apply(ds, pair.g_apply(gp, z2)))

        gl, grads = _grad(g_loss, state.g)
        with torch.no_grad():
            apply_updates(state.g, g_opt_def.update(grads, state.g_opt,
                                                    state.g))
            state.step += 1
        return state, {"d_loss": d_losses, "g_loss": gl,
                       "kept_frac": _one(dev)}

    return body


def make_approach3_body(pair, fcfg: DistGANConfig):
    g_opt_def, d_opt_def = _opts(fcfg)
    d_update = _d_update_fn(pair, d_opt_def, fcfg)
    draw = make_approach3_noise(pair, fcfg)

    def body(state: DistGANState, real, ages=None, weights=None, *,
             z1=None, z2=None):
        """alg. 3: for each member j in turn, train D_j on a fresh fake
        batch, then step G against D_j alone.  ``z1``/``z2`` (C, B, z_dim)
        replace the per-member draws."""
        dev, C = real.device, real.shape[0]
        noise = draw(state.generator, real.shape, z1=z1, z2=z2)
        z1, z2 = noise["z1"].to(dev), noise["z2"].to(dev)
        g_losses, d_losses = [], []
        for j in range(C):
            za, zb = z1[j], z2[j]
            with torch.no_grad():
                fake = pair.g_apply(state.g, za)
            d_j = _row(state.ds, j)
            d_losses.append(d_update(d_j, _row(state.d_opts, j),
                                     real[j:j + 1], fake))
            g_losses.append(_g_step(pair, fcfg, g_opt_def, state, d_j, zb))
        with torch.no_grad():
            state.step += 1
        return state, {"d_loss": torch.cat(d_losses),
                       "g_loss": torch.mean(torch.stack(g_losses)),
                       "kept_frac": _one(dev)}

    return body


def make_baseline_body(pair, fcfg: DistGANConfig):
    g_opt_def, d_opt_def = _opts(fcfg)
    d_update = _d_update_fn(pair, d_opt_def, fcfg)
    draw = make_baseline_noise(pair, fcfg)

    def body(state: DistGANState, real, ages=None, weights=None, *,
             z1=None, z2=None):
        """real: (B, ...) union-data batch; one D (user row 0) and G train
        as a normal GAN (no privacy boundary, no cohort)."""
        dev = real.device
        noise = draw(state.generator, real.shape, z1=z1, z2=z2)
        z1, z2 = noise["z1"].to(dev), noise["z2"].to(dev)
        with torch.no_grad():
            fake = pair.g_apply(state.g, z1)
        d = _row(state.ds, 0)
        dl = d_update(d, _row(state.d_opts, 0), real[None], fake)
        gl = _g_step(pair, fcfg, g_opt_def, state, d, z2)
        with torch.no_grad():
            state.step += 1
        return state, {"d_loss": dl, "g_loss": gl, "kept_frac": _one(dev)}

    return body


register_approach("approach1", make_approach1_body, make_approach1_noise,
                  sync_ds=True, uploads=True)
register_approach("approach2", make_approach2_body, make_approach2_noise)
register_approach("approach3", make_approach3_body, make_approach3_noise)
register_approach("baseline", make_baseline_body, make_baseline_noise,
                  user_axis=False)
register_approach("download_first", make_download_first_body,
                  make_approach1_noise, sync_ds=True, uploads=True)
