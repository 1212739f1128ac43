"""The system under test: a ``repro_torch`` federation session built from a
configuration and a workload, and what the benchmark reads back from it.

This is the one module of the benchmark that imports the program.  The
session is ``repro_torch.core.session.FederationSession`` on the
``device`` backend; its ``run(rounds)`` is the call the window drives.
"""

from __future__ import annotations

import torch

from repro_torch.core.approaches import DistGANConfig
from repro_torch.core.gan import MLPGanConfig, make_mlp_pair
from repro_torch.core.session import FederationSession
from repro_torch.core.spec import (CombineSpec, CompressionSpec, EngineSpec,
                                   FederationSpec, ParticipationSpec)
from repro_torch.data import dirichlet_partition

from bench.federation import data as bdata
from bench.federation.reference import leaves, unflat


def _pair(config: dict):
    return make_mlp_pair(MLPGanConfig(
        data_dim=config["data_dim"], z_dim=config["z_dim"],
        g_hidden=config["g_hidden"], d_hidden=config["d_hidden"]))


def build(config: dict, workload: dict, seed: int, images, labels,
          device) -> FederationSession:
    """The session of ``workload`` over ``config``'s pair, on ``device``,
    its users' shards split by the program from the benchmark's images."""
    users = workload["users"]
    fcfg = DistGANConfig(
        num_users=users, g_lr=config["g_lr"], d_lr=config["d_lr"],
        b1=config["b1"], b2=config["b2"], selection=workload["selection"],
        upload_frac=workload["upload_frac"], use_topk_kernel=True)
    spec = FederationSpec(
        workload["approach"], batch_size=workload["batch"], seed=seed,
        eval_samples=0, engine=EngineSpec(),
        participation=ParticipationSpec(workload["scheduler"],
                                        workload["cohort"]),
        combine=CombineSpec(
            workload["combiner"], staleness_decay=workload["staleness_decay"],
            compression=CompressionSpec(
                workload["codec"], error_feedback=workload["error_feedback"],
                stochastic=False)))
    dataset = dirichlet_partition(images, labels, users,
                                  workload["data"]["alpha"],
                                  seed=bdata.partition_seed(seed))
    return FederationSession(_pair(config), fcfg, dataset, spec,
                             device=device)


def hook_batches(sess: FederationSession, wrap) -> None:
    """Route the session's per-round batch drawing through ``wrap(fn)``."""
    name = "_batch_cohort" if sess.cohort_virtual else "_batch_full"
    setattr(sess, name, wrap(getattr(sess, name)))


def _trained(sess, res) -> tuple[list, torch.Tensor]:
    """Each round's members, and every user that trained (sorted)."""
    if sess.cohort_virtual:
        rows = [[int(u) for u in m] for m in res.extra["schedule"]]
    else:
        rows = [list(range(sess.fcfg.num_users))] * len(res.d_losses)
    users = sorted({u for m in rows for u in m})
    return rows, torch.tensor(users, device=res.state.step.device)


def _norms(prefix: str, stacked, idx: torch.Tensor, base=None) -> dict:
    """``{prefix.leaf: norm}`` of each leaf's rows ``idx`` (minus ``base``'s
    leaf), all the rows of a leaf taken as one vector."""
    out = {}
    for k, t in leaves(stacked):
        rows = t.index_select(0, idx)
        if base is not None:
            rows = rows - base[k]
        out[f"{prefix}.{k}"] = float(torch.linalg.vector_norm(rows))
    return out


def first_call(sess: FederationSession, rounds: int) -> dict:
    """Make the window's own call ``run(rounds)`` once and read what the
    check compares: the initial G and D, every round's losses and members,
    each user's Adam step count (and, in a cohort, its last round), and
    the norm of each leaf of the state after the call: G's and the server
    D's change, and over every user that trained its stored D row's
    change, its Adam ``mu`` and ``nu`` and its error-feedback residual."""
    g0 = {k: v.detach().clone() for k, v in leaves(sess.generator_params())}
    d0_flat = torch.from_numpy(sess.user_d_flat(0))
    res = sess.run(rounds)
    st = res.state
    d0 = dict(leaves(unflat(d0_flat.to(st.step.device), st.server_d)))
    members, idx = _trained(sess, res)
    state = {f"g.{k}": float(torch.linalg.vector_norm(p - g0[k]))
             for k, p in leaves(st.g)}
    state.update({f"server.{k}": float(torch.linalg.vector_norm(p - d0[k]))
                  for k, p in leaves(st.server_d)})
    state.update(_norms("rows", st.ds, idx, d0))
    state.update(_norms("mu", st.d_opts["mu"], idx))
    state.update(_norms("nu", st.d_opts["nu"], idx))
    out = {"init": {"g": {k: v.cpu() for k, v in g0.items()},
                    "d_flat": d0_flat},
           "losses": res.d_losses.tolist(), "members": members,
           "chunk": sess.spec.engine.rounds_per_jit,
           "steps": st.d_opts["step"].cpu().tolist(), "state": state}
    if sess.cohort_virtual:
        out["last"] = (rounds - res.extra["staleness"]).tolist()
        residual = sess._driver.state.store.residual
        if residual is not None:
            names, sizes = zip(*[(k, t.numel())
                                 for k, t in leaves(st.server_d)])
            parts = torch.split(residual.index_select(0, idx), sizes, dim=1)
            out["state"].update(
                {f"res.{k}": float(torch.linalg.vector_norm(t))
                 for k, t in zip(names, parts)})
    del res, st
    return out
