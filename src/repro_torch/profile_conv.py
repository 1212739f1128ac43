"""Time the DCGAN discriminator step of a federation round on the GPU in
several forms of the users' stacked convolutions, to pick the fastest one
that stays deterministic.

    PYTHONPATH=src python -m repro_torch.profile_conv

One approach-1 D step (``core.approaches._d_update_fn``: forward on the
users' real batches and the shared fake batch, backward, AdamW) at the
paper's CelebA/LSUN width (64 x 64 x 3, 64 base filters, 8 users, batch
64), from one seed, in each form:

* ``grouped``: the users folded into the channels, one grouped convolution
  per layer, activations and weights in channels-last memory
  (``core.gan.conv_d_apply`` as shipped);
* ``grouped_nchw``: the same with every convolution's input and weight
  made contiguous NCHW first (the layout before channels-last);
* ``per_user`` / ``per_user_nchw``: one ungrouped convolution per user and
  layer, the users' logits stacked;

each with cuDNN's deterministic algorithms
(``device.deterministic_convolutions``) and with its defaults.  Prints one
JSON line: CUDA-event ms per step (median of ``ITERS`` after two warm-up
steps), whether two steps from one state give the same state
bitwise, and the largest difference of the updated weights from the
shipped form.  Needs a CUDA device.
"""

from __future__ import annotations

import contextlib
import json
import statistics

import torch
import torch.nn.functional as F

from repro_torch.core import approaches as tapp
from repro_torch.core import gan as tgan
from repro_torch.device import deterministic_convolutions, resolve_device
from repro_torch.models.common import tree_leaves, tree_map

CFG = dict(image_size=64, channels=3, z_dim=100, base_filters=64)
USERS, BATCH, ITERS = 8, 64, 10


def _per_user(d_apply):
    """A stacked D applied user by user with the unstacked form."""
    def apply(params, x):
        if params["c1"]["w"].ndim == 4:
            return d_apply(params, x)
        u = params["c1"]["w"].shape[0]
        return torch.stack([d_apply(tree_map(lambda t: t[i], params),
                                    x[i] if x.ndim == 5 else x)
                            for i in range(u)])
    return apply


@contextlib.contextmanager
def _nchw():
    """Every convolution's input and weight made contiguous NCHW."""
    conv = F.conv2d

    def conv_nchw(h, w, *a, **k):
        return conv(h.contiguous(), w.contiguous(), *a, **k)
    tgan.F.conv2d = conv_nchw
    try:
        yield
    finally:
        tgan.F.conv2d = conv


def _step_fn(pair, fcfg, form):
    d_apply = pair.d_apply if form.startswith("grouped") else \
        _per_user(pair.d_apply)
    stacked = tgan.GanPair(pair.cfg, pair.g_decls, pair.d_decls,
                           pair.g_apply, d_apply, pair.z_dim)
    _, d_opt_def = tapp._opts(fcfg)
    return tapp._d_update_fn(stacked, d_opt_def, fcfg)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_conv needs a CUDA device")
    dev = resolve_device()
    pair = tgan.make_conv_pair(tgan.ConvGanConfig(**CFG))
    fcfg = tapp.DistGANConfig(num_users=USERS)
    state = tapp.init_state(pair, fcfg, 0, dev)
    gen = torch.Generator().manual_seed(1)
    size, ch = CFG["image_size"], CFG["channels"]
    real = torch.rand((USERS, BATCH, size, size, ch),
                      generator=gen).mul(2).sub(1).to(dev)
    with torch.no_grad():
        fake = pair.g_apply(state.g, pair.sample_z(gen, BATCH, dev))
    ref_ds = None
    out = {"device": torch.cuda.get_device_name(0), "users": USERS,
           "batch": BATCH, "forms": {}}
    for form in ("grouped", "per_user", "grouped_nchw", "per_user_nchw"):
        for det in (True, False):
            step = _step_fn(pair, fcfg, form)
            layout = _nchw() if form.endswith("nchw") else \
                contextlib.nullcontext()
            cudnn = deterministic_convolutions() if det else \
                contextlib.nullcontext()
            results = []
            with layout, cudnn:
                for _ in range(2):                # two steps from one state
                    st = state.clone()
                    step(st.ds, st.d_opts, real, fake)
                    results.append(st.ds)
                times = []
                st = state.clone()
                for _ in range(ITERS):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    step(st.ds, st.d_opts, real, fake)
                    end.record()
                    torch.cuda.synchronize()
                    times.append(start.elapsed_time(end))
            same = all(torch.equal(a, b) for a, b in zip(
                tree_leaves(results[0]), tree_leaves(results[1])))
            if ref_ds is None:
                ref_ds = results[0]
            diff = max(float((a - b).abs().max()) for a, b in zip(
                tree_leaves(results[0]), tree_leaves(ref_ds)))
            out["forms"][f"{form}{'' if det else '_default'}"] = {
                "ms_per_step": statistics.median(times),
                "repeatable_bitwise": same, "max_diff_vs_grouped": diff}
            del results, st
            torch.cuda.empty_cache()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
