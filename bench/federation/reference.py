"""The plain reference of a Distributed-GAN round (approach 1, alg. 1 of
arXiv:1911.08128), written from the configuration alone in plain PyTorch.
It imports nothing of the program.

A round, for the round's members in cohort order:

1. ``z1``, ``z2`` drawn from the run's generator (which drew G's, then
   D's initial weights); the fake batch ``G(z1)``;
2. each member's D step from its stored row: BCE on its real batch and on
   the shared fake batch, Adam;
3. its delta row (new - stored), plus its error-feedback residual when a
   lossy codec runs with error feedback;
4. the top-k mask by magnitude (ties kept), the int8 round trip of the
   masked row (per-row absmax scale), the new residual;
5. the server fold (per coordinate the largest magnitude, the first member
   on ties; under ``staleness_max_abs`` each delta scaled by
   ``decay ** age`` first), added to the server D;
6. every member's stored row re-synced to the server D, stamped with the
   round;
7. G's step against the server D on ``G(z2)``, Adam.

The users' stored rows are held sparsely: a user that never trained holds
the initial D and zero optimizer state.  ``prec="tf32"`` is the control:
products in TF32 (on a CUDA device cuBLAS's TF32 switch; on the CPU the
operands rounded to TF32's 10-bit mantissa).  ``fault`` plants one:
``"half_batch"``, every loss the mean over the first half of its batch;
``"chunk_batch"``, every round of a chunk of ``chunk`` rounds trained on
the real batches drawn for the chunk's first round.
"""

from __future__ import annotations

import contextlib
import importlib.util
import pathlib

import numpy as np
import torch

from bench.federation import data as bdata

CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "configs"
INV_127 = 0.007874015718698502     # f32(1 / 127)


def load_model(name: str):
    """The plain model module ``configs/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        f"bench_config_{name.replace('-', '_')}", CONFIGS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Precision:
    """How the reference's products round: ``f32`` or ``tf32``."""

    def __init__(self, name: str, device: torch.device):
        if name not in ("f32", "tf32"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.emulate = name == "tf32" and device.type == "cpu"

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        """A product's operand: rounded to TF32 (nearest, ties to even)
        when emulated, its gradient passed straight through."""
        if not self.emulate:
            return t
        bits = t.detach().contiguous().view(torch.int32)
        bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
        return t + (bits.view(torch.float32) - t).detach()

    @contextlib.contextmanager
    def scope(self):
        m = torch.backends.cuda.matmul
        saved = m.allow_tf32
        m.allow_tf32 = self.name == "tf32"
        try:
            yield
        finally:
            m.allow_tf32 = saved


def leaves(tree, prefix=""):
    """``(name, tensor)`` of a nested dict in sorted-key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def flat(tree) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for _, t in leaves(tree)])


def unflat(row: torch.Tensor, like):
    """A flat row as a tree shaped like ``like`` (views into ``row``)."""
    parts = iter(torch.split(row, [t.numel() for _, t in leaves(like)]))
    return tree_map(lambda t: next(parts).view(t.shape), like)


def bce(logits: torch.Tensor, target: float) -> torch.Tensor:
    """Binary cross-entropy on logits, ``max(l, 0) - l t + log1p(e^-|l|)``."""
    return (torch.clamp(logits, min=0) - logits * target
            + torch.log1p(torch.exp(-torch.abs(logits))))


class Adam:
    """Adam with bias correction, no weight decay; the update direction
    ``(mu / c1) / (sqrt(nu / c2) + eps)``, ``p + (-lr) * d`` rounded once
    to f32 (a fused multiply-add)."""

    def __init__(self, lr: float, b1: float, b2: float, eps: float):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.neg_lr = float(torch.tensor(-lr, dtype=torch.float32))

    def init(self, params):
        return {"mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params), "t": 0}

    def step(self, params, grads, state):
        state["t"] += 1
        dev = next(iter(leaves(params)))[1].device
        t = torch.tensor(float(state["t"]), device=dev)
        c1 = 1.0 - torch.pow(torch.tensor(self.b1, device=dev), t)
        c2 = 1.0 - torch.pow(torch.tensor(self.b2, device=dev), t)

        def one(p, g, mu, nu):
            mu.copy_(self.b1 * mu + (1 - self.b1) * g)
            nu.copy_(self.b2 * nu + (1 - self.b2) * (g * g))
            d = (mu / c1) / (torch.sqrt((nu / c2).double()).float() + self.eps)
            return (p.double() + d.double() * self.neg_lr).float()

        return tree_map(one, params, grads, state["mu"], state["nu"])


def grad(loss_fn, params):
    """``(loss, grads)`` of ``loss_fn(params)`` w.r.t. every leaf."""
    req = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss = loss_fn(req)
    grads = iter(torch.autograd.grad(loss, [t for _, t in leaves(req)]))
    return loss.detach(), tree_map(lambda _: next(grads), req)


def topk_mask(row: torch.Tensor, frac: float) -> torch.Tensor:
    """``|x| >=`` the row's k-th largest magnitude, ``k = max(int(N frac),
    1)``: ties kept."""
    mag = torch.abs(row)
    k = max(int(row.numel() * frac), 1)
    return mag >= torch.topk(mag, k).values[-1]


def int8_round_trip(row: torch.Tensor) -> torch.Tensor:
    """Per-row absmax int8: ``scale = max|x| * f32(1/127)``, ``q =
    clip(round(x / scale), -127, 127)`` (half to even), back as ``q *
    scale``."""
    scale = torch.amax(torch.abs(row)) * torch.tensor(INV_127,
                                                      device=row.device)
    if scale <= 0:
        return torch.zeros_like(row)
    inv = torch.ones_like(scale) / scale
    q = torch.clamp(torch.round(row * inv), -127.0, 127.0)
    return q * scale


def fold(rows: torch.Tensor, ages, combiner: str, decay: float):
    """The server fold of the members' ``(C, N)`` uploads."""
    if combiner == "staleness_max_abs":
        w = torch.pow(torch.full((len(ages),), decay, dtype=torch.float32,
                                 device=rows.device),
                      torch.tensor(ages, dtype=torch.float32,
                                   device=rows.device))
        rows = w[:, None] * rows
    elif combiner != "max_abs":
        raise ValueError(f"no plain fold for {combiner!r}")
    idx = torch.argmax(torch.abs(rows), dim=0, keepdim=True)
    return torch.take_along_dim(rows, idx, dim=0)[0]


class Store:
    """The users' stored D rows, optimizer states, residuals and stamps,
    held sparsely over the initial D."""

    def __init__(self, d0, adam: Adam, residual: bool):
        self.d0, self.adam, self.residual = d0, adam, residual
        self.rows: dict[int, dict] = {}

    def get(self, u: int) -> dict:
        if u not in self.rows:
            d = tree_map(torch.clone, self.d0)
            res = torch.zeros_like(flat(d)) if self.residual else None
            self.rows[u] = {"d": d, "opt": self.adam.init(d), "last": 0,
                            "res": res}
        return self.rows[u]


def _sum_sq(acc: dict, key: str, t: torch.Tensor) -> None:
    acc[key] = acc.get(key, 0.0) + torch.sum(t.double() * t.double())


def run(config: dict, workload: dict, seed: int, images: np.ndarray,
        labels: np.ndarray, rounds: int, device, *, prec: str = "f32",
        fault: str | None = None, chunk: int = 16) -> dict:
    """The first ``rounds`` rounds of ``workload`` from ``seed``: the same
    readings as ``program.first_call`` takes from the program, plus the
    norms of each leaf's first gradient (for the exclusion rule).
    ``chunk`` is the program's chunk length (``EngineSpec``'s default)."""
    if fault not in (None, "half_batch", "chunk_batch"):
        raise ValueError(f"unknown fault {fault!r}")
    device = torch.device(device)
    model = load_model(workload["config"])
    prec_ = Precision(prec, device)
    gen = torch.Generator().manual_seed(seed)
    g, d0 = model.init(config, gen)
    g = tree_map(lambda t: t.to(device), g)
    d0 = tree_map(lambda t: t.to(device), d0)
    out = {"init": {"g": {k: v.cpu() for k, v in leaves(g)},
                    "d_flat": flat(d0).cpu()},
           "losses": [], "grad": {}, "members": [], "chunk": chunk}
    g_init = tree_map(torch.clone, g)
    opt_g = Adam(config["g_lr"], config["b1"], config["b2"], config["eps"])
    opt_d = Adam(config["d_lr"], config["b1"], config["b2"], config["eps"])
    g_state = opt_g.init(g)
    lossy = workload["codec"] != "none"
    ef = lossy and workload["error_feedback"]
    store = Store(d0, opt_d, ef)
    server = tree_map(torch.clone, d0)
    B = workload["batch"]
    half = B // 2 if fault == "half_batch" else B
    shards = bdata.dirichlet_shards(images, labels, workload["users"],
                                    workload["data"]["alpha"],
                                    bdata.partition_seed(seed))
    drng, srng = bdata.data_rng(seed), bdata.schedule_rng(seed)
    C = workload["cohort"] or workload["users"]

    def mean(x):
        return x[..., :half].mean(-1)

    with prec_.scope():
        for step in range(rounds):
            members = bdata.cohort(srng, workload["users"], C,
                                   workload["scheduler"])
            out["members"].append([int(u) for u in members])
            z1 = torch.randn((B, config["z_dim"]), generator=gen).to(device)
            z2 = torch.randn((B, config["z_dim"]), generator=gen).to(device)
            drawn = [torch.from_numpy(bdata.user_batch(
                images, shards[u], drng, B)).to(device) for u in members]
            if fault != "chunk_batch" or step % chunk == 0:
                reals = drawn
            with torch.no_grad():
                fake = model.g_apply(config, g, z1, prec_)
            deltas, d_losses, ages = [], [], []
            for j, u in enumerate(members):
                row = store.get(int(u))
                real = reals[j]

                def d_loss(dp):
                    return (mean(bce(model.d_apply(config, dp, real, prec_),
                                     1.0))
                            + mean(bce(model.d_apply(config, dp, fake, prec_),
                                       0.0)))

                loss, grads = grad(d_loss, row["d"])
                d_losses.append(loss)
                if step == 0:
                    for k, v in leaves(grads):
                        out["grad"][f"d{j}.{k}"] = float(
                            torch.linalg.vector_norm(v))
                new = opt_d.step(row["d"], grads, row["opt"])
                delta = flat(new) - flat(row["d"])
                if ef:
                    delta = delta + row["res"]
                deltas.append(delta)
                ages.append(step - row["last"])
            uploads = []
            for j, u in enumerate(members):
                delta = deltas[j]
                sent = torch.where(topk_mask(delta, workload["upload_frac"]),
                                   delta, torch.zeros_like(delta))
                if lossy:
                    sent = int8_round_trip(sent)
                if ef:
                    store.get(int(u))["res"] = delta - sent
                uploads.append(sent)
            combined = fold(torch.stack(uploads), ages, workload["combiner"],
                            workload["staleness_decay"])
            server = unflat(flat(server) + combined, server)
            for u in members:
                row = store.get(int(u))
                row["d"] = tree_map(torch.clone, server)
                row["last"] = step + 1

            def g_loss(gp):
                fake2 = model.g_apply(config, gp, z2, prec_)
                return mean(bce(model.d_apply(config, server, fake2, prec_),
                                1.0))

            _, g_grads = grad(g_loss, g)
            if step == 0:
                for k, v in leaves(g_grads):
                    out["grad"][f"g.{k}"] = float(torch.linalg.vector_norm(v))
            g = opt_g.step(g, g_grads, g_state)
            out["losses"].append(torch.stack(d_losses))
    out["losses"] = torch.stack(out["losses"]).tolist()
    users = range(workload["users"])
    out["steps"] = [store.rows[u]["opt"]["t"] if u in store.rows else 0
                    for u in users]
    out["last"] = [store.rows[u]["last"] if u in store.rows else 0
                   for u in users]
    sq: dict = {}
    for key, now, was in (("g", g, g_init), ("server", server, d0)):
        for (k, p), (_, p0) in zip(leaves(now), leaves(was)):
            _sum_sq(sq, f"{key}.{k}", p - p0)
    names = [k for k, _ in leaves(d0)]
    for u in sorted(store.rows):
        row = store.rows[u]
        for (k, p), (_, p0) in zip(leaves(row["d"]), leaves(d0)):
            _sum_sq(sq, f"rows.{k}", p - p0)
        for part in ("mu", "nu"):
            for k, t in leaves(row["opt"][part]):
                _sum_sq(sq, f"{part}.{k}", t)
        if ef:
            for k, t in zip(names, torch.split(
                    row["res"], [t.numel() for _, t in leaves(d0)])):
                _sum_sq(sq, f"res.{k}", t)
    out["state"] = {k: float(torch.sqrt(v)) for k, v in sq.items()}
    return out
