"""The SPMD cohort engines and the ``spmd`` backend of the port held to the
JAX reference on the CPU: one cohort member per gloo rank (C = 2 ranks, U
= 4 logical users, 3 rounds).

As in ``tests/test_torch_spmd.py``, the reference runs once for the file
in a subprocess with forced host devices and exports its oracles, the port
runs on ranks started by ``spawn_users`` at the same time, both from the
reference's initial state, the port with the reference's draws.

* ``make_spmd_cohort_engine`` (replicated store) and
  ``make_spmd_fused_store_engine`` (sharded store) against the reference's,
  in five forms: ``topk_int8`` + stochastic rounding + error feedback under
  ``staleness_max_abs``; a top-k and a dense ``int8`` upload, each with
  error feedback + ``stage_rows`` under ``staleness_mean`` (pmin of the
  ages); approaches 2 and 3.  Losses, the
  store and the shared state within ATOL = 1e-5, ``last_round`` and the
  ages' mean bitwise, kept fractions to 1e-6.  Inside the port the sharded
  store equals the replicated one bitwise (without ``stage_rows``, whose
  sharded gather quantizes too, as the reference's does), and the rows
  engine through ``stream_cohort_rounds`` equals the replicated store
  engine bitwise.
* The ``spmd`` backend: ``FederationSession(..., mesh=)`` for approaches
  1, 2 and 3 against the reference's ``SpmdStreamDriver`` session (its
  schedule and data bitwise: the same numpy streams on every rank); G and
  the server D bitwise equal on every rank, and the host-store replicas
  too; save on rank 0, restore on every rank, resume bitwise.
* The sharded gather lands an owned -0.0 as -0.0, where the replicated
  store's f32 psum gives +0.0 (as the reference's); the ``stage_rows``
  int8 transport is the reference's inline formula bitwise on NaN, +-inf,
  subnormal-scale and subnormal ``x * inv`` rows.
"""

import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import approaches as japp
from repro.core import engine as jeng
from repro.core import federated as jfed
from repro_torch.convert import cohort_state_from_numpy, shared_from_numpy
from repro_torch.core import approaches as tapp
from repro_torch.core import collectives as coll
from repro_torch.core import federated as tfed
from repro_torch.core import session as tsess
from repro_torch.core import spmd
from repro_torch.core.engine import CohortShared
from repro_torch.core.gan import MLPGanConfig, make_mlp_pair
from repro_torch.core.protocol import run_distgan
from repro_torch.core.session import FederationSession
from repro_torch.core.spec import BackendSpec, FederationSpec
from repro_torch.data import dirichlet_partition
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import UsersMesh, spawn_users
from repro_torch.models.common import tree_leaves
from test_torch_spmd import (JPAIR, SMALL, SRC, B, _bitwise, _np_tree,
                             noise_tensors, spmd_draws)

C, U, K = 2, 4, 3
ATOL = 1e-5

ENGINE_CASES = {
    "a1-topk-int8-sr-ef": ("approach1", dict(
        codec="topk_int8", codec_stochastic=True, error_feedback=True,
        combiner="staleness_max_abs")),
    # at Adam's first step every |delta| is ~lr: the top-k threshold sits
    # among near-equal deltas, so this case holds the optimizer's rounding
    # too (tests/test_torch_optim.py pins that step to the reference's)
    "a1-topk-int8-ef-stage-rows": ("approach1", dict(
        codec="int8", error_feedback=True, stage_rows=True,
        combiner="staleness_mean")),
    "a2": ("approach2", {}),
    "a3": ("approach3", {}),
    "a1-int8-ef-stage-rows-dense": ("approach1", dict(
        codec="int8", error_feedback=True, stage_rows=True, selection="none",
        combiner="staleness_mean")),
}
# cases whose sharded form is held to the reference's program with the
# gathered row rounded before the D step (see _REF and
# test_sharded_stage_rows_reference_depends_on_its_fusion)
ROUNDED_ROWS = ("a1-topk-int8-ef-stage-rows",)
SESSION_CASES = {
    "a1": ("approach1", dict(codec="topk_int8", stochastic=True,
                             error_feedback=True), "staleness_max_abs"),
    "a2": ("approach2", {}, "max_abs"),
    "a3": ("approach3", {}, "max_abs"),
}


def _jfcfg(kw):
    return japp.DistGANConfig(num_users=U, upload_frac=0.3, **kw)


def _manifest(approach, comp, combiner):
    return {"approach": approach, "batch_size": B, "seed": 0,
            "eval_samples": 0,
            "participation": {"scheduler": "uniform", "cohort_size": C},
            "backend": {"kind": "spmd"},
            "combine": {"combiner": combiner, "compression": comp}}


def _data():
    rng = np.random.default_rng(5)
    data = rng.normal(size=(200, SMALL["data_dim"])).astype(np.float32)
    return data, rng.integers(0, 4, 200)


def _session_fcfg(comp, combiner, pkg):
    return pkg.DistGANConfig(
        num_users=U, upload_frac=0.3, combiner=combiner,
        codec=comp.get("codec", "none"),
        error_feedback=comp.get("error_feedback", True),
        codec_stochastic=comp.get("stochastic", False))


def _inputs():
    rng = np.random.default_rng(0)
    sched = jfed.make_schedule("uniform", U, C, K, np.random.default_rng(1))
    engines = {}
    for name, (approach, kw) in ENGINE_CASES.items():
        fcfg = _jfcfg(kw)
        cs = jeng.init_cohort_state(JPAIR, fcfg, jax.random.key(0),
                                    sync_ds=approach == "approach1")
        engines[name] = {
            "init": _np_tree(cs._replace(key=None)._asdict()),
            "reals": rng.normal(size=(K, C, B, SMALL["data_dim"])
                                ).astype(np.float32),
            "draws": spmd_draws(cs.key, approach, fcfg, C, K)}
    sessions = {}
    for name, (approach, comp, combiner) in SESSION_CASES.items():
        fcfg = _session_fcfg(comp, combiner, japp)
        sh, be = jeng.init_host_backend(JPAIR, fcfg, jax.random.key(0),
                                        sync_ds=approach == "approach1")
        sessions[name] = {
            "shared": _np_tree(sh._replace(key=None)._asdict()),
            "store": tuple(None if t is None else np.array(t) for t in (
                be.d_flat, be.opt_flat, be.last_round, be.residual)),
            "draws": spmd_draws(sh.key, approach, fcfg, C, K)}
    return {"sched": sched, "engines": engines, "sessions": sessions,
            "data": _data()}


# ---------------------------------------------------------------------------
# The reference, once for the file, in a subprocess with 2 host devices
# ---------------------------------------------------------------------------

_REF = textwrap.dedent("""
    import dataclasses, os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.core import approaches as japp, engine as jeng
    from repro.core import spmd as jspmd
    from repro.core.gan import MLPGanConfig, make_mlp_pair
    from repro.core.session import FederationSession
    from repro.core.spec import FederationSpec
    from repro.data.federated import dirichlet_partition

    inp = pickle.load(open(sys.argv[1], "rb"))
    C, U = inp["C"], inp["U"]
    pair = make_mlp_pair(MLPGanConfig(**inp["small"]))
    mesh = Mesh(np.array(jax.devices()[:C]), ("users",))
    sched = jnp.asarray(inp["sched"])
    tree = lambda t: jax.tree.map(np.asarray, t)
    out = {}
    for name, (approach, kw) in inp["engine_spec"].items():
        fcfg = japp.DistGANConfig(num_users=U, upload_frac=0.3, **kw)
        reals = jnp.asarray(inp["engines"][name]["reals"])
        for form, mk in (("replicated", jeng.make_spmd_cohort_engine),
                         ("sharded", jeng.make_spmd_fused_store_engine)):
            cs = jeng.init_cohort_state(pair, fcfg, jax.random.key(0),
                                        sync_ds=approach == "approach1")
            cs, m = mk(pair, fcfg, mesh, approach, C)(cs, reals, sched)
            out[name, form] = {"metrics": tree(m), "state": tree(
                cs._replace(key=None)._asdict())}
        if name in inp["rounded"]:
            # the same sharded program with each member's gathered D row
            # materialized before its D step (an optimization barrier), so
            # the dequantized row is rounded to f32 as written; plain jit
            # fuses the dequantize into the step
            restack = jspmd._restack
            jspmd._restack = lambda t: restack(jax.lax.optimization_barrier(t))
            cs = jeng.init_cohort_state(pair, fcfg, jax.random.key(0),
                                        sync_ds=approach == "approach1")
            cs, m = jeng.make_spmd_fused_store_engine(
                pair, fcfg, mesh, approach, C)(cs, reals, sched)
            jspmd._restack = restack
            out[name, "sharded-rounded"] = {"metrics": tree(m), "state": tree(
                cs._replace(key=None)._asdict())}
    data, labels = inp["data"]
    ds = dirichlet_partition(data, labels, U, 0.5)
    for name, manifest in inp["manifests"].items():
        fcfg = japp.DistGANConfig(num_users=U, upload_frac=0.3)
        sess = FederationSession(pair, fcfg, ds,
                                 FederationSpec.from_dict(manifest),
                                 mesh=mesh)
        res = sess.run(len(inp["sched"]))
        be, sh = sess._driver.backend, sess._driver.shared
        out["session", name] = {
            "g_losses": res.g_losses, "d_losses": res.d_losses,
            "mean_age": res.extra["mean_age"],
            "schedule": res.extra["schedule"],
            "kept": res.extra["kept_frac"],
            "store": tuple(None if t is None else np.array(t) for t in (
                be.d_flat, be.opt_flat, be.last_round, be.residual)),
            "shared": tree(sh._replace(key=None)._asdict())}
    pickle.dump(out, open(sys.argv[2], "wb"))
""")


def _manifests():
    return {name: _manifest(approach, comp, combiner)
            for name, (approach, comp, combiner) in SESSION_CASES.items()}


def _run_reference(inputs, tmp):
    src, dst = os.path.join(tmp, "ref_in.pkl"), os.path.join(tmp, "ref.pkl")
    with open(src, "wb") as f:
        pickle.dump({"C": C, "U": U, "small": SMALL, "sched": inputs["sched"],
                     "engines": inputs["engines"], "data": inputs["data"],
                     "engine_spec": ENGINE_CASES, "rounded": ROUNDED_ROWS,
                     "manifests": _manifests()}, f)
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", _REF, src, dst], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, dst


# ---------------------------------------------------------------------------
# The port, on 2 gloo ranks
# ---------------------------------------------------------------------------

def _injecting(eng, draws):
    it = iter(draws)
    return lambda *args: eng(*args, noise=next(it))


def _cohort_np(cs) -> dict:
    s = cs.store
    return {"shared": [t.clone() for t in tree_leaves(cs.g)
                       + tree_leaves(cs.g_opt) + tree_leaves(cs.server_d)],
            "step": cs.step.clone(),
            "store": tuple(None if t is None else t.clone() for t in (
                s.d_flat, s.opt_flat, s.last_round, s.residual))}


def _transport_zero(mesh: UsersMesh) -> dict:
    """Rank r's block of 2 store rows; slot 0 is user 2 (rank 1's row 0,
    holding -0.0 in column 1), slot 1 is user 1 (rank 0's row 1)."""
    block = torch.full((2, 3), float(mesh.rank + 1))
    if mesh.rank == 1:
        block[0, 1] = -0.0
    idx = np.array([2, 1])
    own = torch.from_numpy(idx // 2 == mesh.rank)
    loc = torch.from_numpy(np.where(own.numpy(), idx % 2, 0))
    row = block[0] if mesh.rank == 1 else block[1]
    onehot = torch.zeros((C, 1))
    onehot[1 - mesh.rank] = 1.0      # slot 0 belongs to rank 1
    return {"sharded": spmd.gather_owned_rows(block, own, loc, mesh),
            "replicated": coll.psum(onehot * row[None], mesh)}


def _port_rank(mesh: UsersMesh, inputs, ckpt_dir) -> dict:
    pair = make_mlp_pair(MLPGanConfig(**SMALL))
    sched = inputs["sched"]
    out = {"zero": _transport_zero(mesh)}
    for name, (approach, kw) in ENGINE_CASES.items():
        case = inputs["engines"][name]
        fcfg = tapp.DistGANConfig(num_users=U, upload_frac=0.3, **kw)
        draws = [noise_tensors(d) for d in case["draws"]]
        for form, mk, shard in (
                ("replicated", spmd.make_spmd_cohort_engine, None),
                ("sharded", spmd.make_spmd_fused_store_engine, mesh)):
            cs = cohort_state_from_numpy(case["init"], "cpu", mesh=shard)
            cs, m = mk(pair, fcfg, mesh, approach, C)(
                cs, case["reals"], sched, noise=draws)
            out[name, form] = {"metrics": m, "state": _cohort_np(cs)}
        if name == "a1-topk-int8-sr-ef":
            # the rows engine over a host store, from the same point
            cs = cohort_state_from_numpy(case["init"], "cpu")
            shared = CohortShared(cs.g, cs.g_opt, cs.server_d, cs.step,
                                  cs.generator)
            be = tfed.HostStateBackend.from_store(cs.store)
            eng = spmd.make_spmd_cohort_rows_engine(pair, fcfg, mesh,
                                                    approach, C)
            shared, m, _ = tsess.stream_cohort_rounds(
                _injecting(eng, draws), shared, be, sched,
                lambda r: case["reals"][r])
            out[name, "rows"] = {"metrics": m, "store": tuple(
                None if t is None else t.clone() for t in (
                    be.d_flat, be.opt_flat, be.last_round, be.residual))}
    data, labels = inputs["data"]
    ds = dirichlet_partition(data, labels, U, 0.5)
    for name, manifest in _manifests().items():
        case = inputs["sessions"][name]
        spec = FederationSpec.from_dict(manifest)
        sess = FederationSession(pair, tapp.DistGANConfig(
            num_users=U, upload_frac=0.3), ds, spec, mesh=mesh)
        drv = sess._driver
        drv.shared = shared_from_numpy(case["shared"], "cpu")
        drv.backend = tfed.HostStateBackend(*case["store"])
        drv.eng = _injecting(drv.eng, [noise_tensors(d)
                                       for d in case["draws"]])
        res = sess.run(K)
        out["session", name] = {
            "g_losses": res.g_losses, "d_losses": res.d_losses,
            "mean_age": res.extra["mean_age"],
            "schedule": res.extra["schedule"], "kept": res.extra["kept_frac"],
            "backend": res.extra["state_backend"],
            "store": tuple(None if t is None else t.clone() for t in (
                drv.backend.d_flat, drv.backend.opt_flat,
                drv.backend.last_round, drv.backend.residual)),
            "shared": [t.clone() for t in tree_leaves(drv.shared.g)
                       + tree_leaves(drv.shared.g_opt)
                       + tree_leaves(drv.shared.server_d)]}
    # save on rank 0, restore on every rank, resume == uninterrupted
    spec = FederationSpec.from_dict(_manifests()["a1"])
    fcfg = tapp.DistGANConfig(num_users=U, upload_frac=0.3)
    whole = FederationSession(pair, fcfg, ds, spec, mesh=mesh).run(4)
    first = FederationSession(pair, fcfg, ds, spec, mesh=mesh)
    first.run(2)
    first.save(ckpt_dir)
    resumed = FederationSession.restore(ckpt_dir, pair, fcfg, ds, mesh=mesh)
    tail = resumed.run(2)
    out["resume"] = {"whole": whole.g_losses[2:], "tail": tail.g_losses,
                     "whole_store": whole.extra["host_backend"].d_flat,
                     "tail_store": tail.extra["host_backend"].d_flat}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("spmd_cohort"))
    inputs = _inputs()
    proc, dst = _run_reference(inputs, tmp)
    try:
        # repro: allow(RPR002): a torch.distributed backend, no registry key
        port = spawn_users(_port_rank, C, backend="gloo", device="cpu",
                           args=(inputs, os.path.join(tmp, "ckpt")),
                           timeout_s=300)
        log, _ = proc.communicate(timeout=560)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, log
    with open(dst, "rb") as f:
        ref = pickle.load(f)
    return {"ref": ref, "port": port}


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


def _same_on_every_rank(port, get):
    for other in port[1:]:
        for a, b in zip(get(other), get(port[0])):
            if a is not None:
                _bitwise(a.numpy(), b.numpy())


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", ["replicated", "sharded"])
@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_cohort_engine_matches_reference(runs, case, form):
    """Three rounds of each SPMD cohort engine against the reference's
    jitted one, from its initial carry with its draws (for the sharded
    form of ``ROUNDED_ROWS``, the reference's program with each gathered
    row rounded to f32 before the D step, as written)."""
    rounded = form == "sharded" and case in ROUNDED_ROWS
    ref = runs["ref"][case, "sharded-rounded" if rounded else form]
    port = runs["port"]
    got = port[0][case, form]["metrics"]
    for key in ("g_loss", "d_loss"):
        _close(got[key].numpy(), ref["metrics"][key])
    np.testing.assert_array_equal(got["mean_age"].numpy(),
                                  ref["metrics"]["mean_age"])
    np.testing.assert_allclose(got["kept_frac"].numpy(),
                               ref["metrics"]["kept_frac"], atol=1e-6, rtol=0)
    _same_on_every_rank(port, lambda o: o[case, form]["state"]["shared"])
    want_shared = jax.tree.leaves({k: ref["state"][k] for k in (
        "g", "g_opt", "server_d")})
    for a, b in zip(port[0][case, form]["state"]["shared"], want_shared):
        _close(a.numpy(), b)
    stores = [o[case, form]["state"]["store"] for o in port]
    if form == "sharded":
        store = [None if stores[0][i] is None
                 else torch.cat([s[i] for s in stores]) for i in range(4)]
    else:
        for other in stores[1:]:
            for a, b in zip(other, stores[0]):
                if a is not None:
                    _bitwise(a.numpy(), b.numpy())
        store = stores[0]
    ref_store = ref["state"]["store"]
    for i, name in enumerate(("d_flat", "opt_flat", "last_round",
                              "residual")):
        want = ref_store[name] if isinstance(ref_store, dict) else \
            getattr(ref_store, name)
        if want is None:
            assert store[i] is None
        elif name == "last_round":
            np.testing.assert_array_equal(store[i].numpy(), want)
        else:
            _close(store[i].numpy(), want)


@pytest.mark.parametrize("case", [c for c in ENGINE_CASES
                                  if "stage" not in c])
def test_sharded_store_equals_replicated_bitwise(runs, case):
    """Inside the port the sharded store's exchange (int32 one-hot psum in,
    all-gather of bits out) lands the same bytes as the replicated store's
    f32 one-hot psum, so the two engines agree bitwise: store, losses,
    shared state."""
    for out in runs["port"]:
        rep, sh = out[case, "replicated"], out[case, "sharded"]
        for key in ("g_loss", "d_loss", "mean_age", "kept_frac"):
            _bitwise(rep["metrics"][key].numpy(), sh["metrics"][key].numpy())
        for a, b in zip(rep["state"]["shared"], sh["state"]["shared"]):
            _bitwise(a.numpy(), b.numpy())
    stores = [o[case, "sharded"]["state"]["store"] for o in runs["port"]]
    rep = runs["port"][0][case, "replicated"]["state"]["store"]
    for i in range(4):
        if rep[i] is not None:
            _bitwise(torch.cat([s[i] for s in stores]).numpy(),
                     rep[i].numpy())


def test_sharded_stage_rows_reference_depends_on_its_fusion(runs):
    """At Adam's first step every |delta| is ~lr, so the top-k threshold
    sits among near-equal deltas.  Under plain jit the reference fuses the
    ``stage_rows`` dequantize (``q * scale``) of its sharded gather into
    the D step, so the row it trains from is not the rounded f32 product,
    and its round-0 top-k keeps other entries than the same program with
    that row materialized (an optimization barrier).  The port rounds the
    row as written and equals the latter (the test above); the replicated
    store, whose gather is not quantized, agrees in both programs."""
    case = ROUNDED_ROWS[0]
    plain = runs["ref"][case, "sharded"]["metrics"]["kept_frac"]
    rounded = runs["ref"][case, "sharded-rounded"]["metrics"]["kept_frac"]
    replicated = runs["ref"][case, "replicated"]["metrics"]["kept_frac"]
    assert plain[0] != rounded[0]
    np.testing.assert_array_equal(rounded[0], replicated[0])
    np.testing.assert_allclose(
        runs["port"][0][case, "sharded"]["metrics"]["kept_frac"].numpy(),
        rounded, atol=1e-6, rtol=0)


def test_rows_engine_equals_replicated_store_engine(runs):
    """The rows engine through ``stream_cohort_rounds`` (host-store
    replicas, one all-gather a round) equals the replicated-store engine
    bitwise on every rank: the store and the losses."""
    case = "a1-topk-int8-sr-ef"
    for out in runs["port"]:
        rows, rep = out[case, "rows"], out[case, "replicated"]
        for key in ("g_loss", "d_loss", "mean_age", "kept_frac"):
            _bitwise(np.stack([m[key] for m in rows["metrics"]]),
                     rep["metrics"][key].numpy())
        for a, b in zip(rows["store"], rep["state"]["store"]):
            _bitwise(a.numpy(), b.numpy())


@pytest.mark.parametrize("case", list(SESSION_CASES))
def test_spmd_session_matches_reference(runs, case):
    """The ``spmd`` backend session on 2 ranks against the reference's
    ``SpmdStreamDriver`` session on 2 devices: schedule and ages bitwise,
    losses, store rows and the shared state within ATOL, ``last_round``
    bitwise; every rank's replica of the host store and of the shared
    state bitwise equal."""
    ref = runs["ref"]["session", case]
    port = runs["port"]
    got = port[0]["session", case]
    assert got["backend"] == "spmd"
    np.testing.assert_array_equal(got["schedule"], ref["schedule"])
    np.testing.assert_array_equal(got["mean_age"], ref["mean_age"])
    _close(got["g_losses"], ref["g_losses"])
    _close(got["d_losses"], ref["d_losses"])
    assert abs(got["kept"] - float(ref["kept"])) <= 1e-6
    _same_on_every_rank(port, lambda o: o["session", case]["store"])
    _same_on_every_rank(port, lambda o: o["session", case]["shared"])
    for i, (a, b) in enumerate(zip(got["store"], ref["store"])):
        if b is None:
            assert a is None
        elif i == 2:
            np.testing.assert_array_equal(a.numpy(), b)
        else:
            _close(a.numpy(), b)
    want = jax.tree.leaves({k: ref["shared"][k] for k in (
        "g", "g_opt", "server_d")})
    for a, b in zip(got["shared"], want):
        _close(a.numpy(), b)


def test_spmd_session_save_restore_resumes_bitwise(runs):
    """Rank 0 saves after 2 rounds; every rank restores with its mesh and
    runs 2 more: the losses and the host store equal 4 uninterrupted
    rounds bitwise."""
    for out in runs["port"]:
        r = out["resume"]
        _bitwise(r["tail"], r["whole"])
        _bitwise(r["tail_store"].numpy(), r["whole_store"].numpy())


def test_sharded_gather_keeps_negative_zero(runs):
    """An owned -0.0 crosses the sharded store's int32 gather as -0.0 on
    every rank; the replicated store's f32 one-hot psum gives +0.0, as the
    reference's does."""
    for out in runs["port"]:
        z = out["zero"]
        sharded, replicated = z["sharded"].numpy(), z["replicated"].numpy()
        assert np.signbit(sharded[0, 1]) and sharded[0, 1] == 0.0
        np.testing.assert_array_equal(sharded[0], [2.0, -0.0, 2.0])
        np.testing.assert_array_equal(sharded[1], [1.0, 1.0, 1.0])
        assert not np.signbit(replicated[0, 1])
        np.testing.assert_array_equal(replicated, sharded)


def _edge_rows(n=64):
    """Rows where the reference's f32 flushes: NaN, +-inf, an absmax
    whose scale is subnormal, entries whose x * inv is subnormal, a
    subnormal entry, -0.0, all zeros."""
    rows = np.random.default_rng(2).normal(size=(7, n)).astype(np.float32)
    rows[0, 3] = np.nan
    rows[1, 4], rows[1, 9] = np.inf, -np.inf
    rows[2] *= np.float32(1e-38)                 # scale ~ 1e-40: subnormal
    rows[3, 0], rows[3, 1:] = 3e38, 1e-38 * rows[3, 1:]   # x*inv subnormal
    rows[4, 5] = 1e-41                           # a subnormal entry
    rows[5, :] = -0.0
    rows[6, :] = 0.0
    return rows


def test_stage_rows_transport_is_the_references_formula_bitwise():
    """The ``stage_rows`` row transport of the cohort rounds (B2's wrappers
    ``kernels.ops.quantize_rows`` then ``dequantize_rows``, their plain
    versions on the CPU) against the reference's inline jnp formula
    (``spmd.py:327-336``) under jit: codes, scales and the dequantized rows
    bitwise, row 4's scale too, which the reference's eager quotient puts
    1 ULP off."""
    rows = _edge_rows()

    @jax.jit
    def ref(x):
        scale = jnp.max(jnp.abs(x), axis=1) / jnp.float32(127.0)
        inv = jnp.where(scale > 0, jnp.float32(1.0) / scale, jnp.float32(0.0))
        q = jnp.clip(jnp.round(x * inv[:, None]), -127, 127).astype(jnp.int8)
        return q, scale, q.astype(jnp.float32) * scale[:, None]

    wq, ws, wd = (np.asarray(t) for t in ref(rows))
    q, s = kops.quantize_rows(torch.from_numpy(rows))
    _bitwise(q.numpy(), wq)
    _bitwise(s.numpy(), ws)
    _bitwise(kops.dequantize_rows(q, s).numpy(), wd)
    quotient = np.abs(rows[4]).max() / np.float32(127.0)
    assert abs(int(quotient.view(np.int32)) - int(ws.view(np.int32)[4])) == 1


def test_spmd_backend_refusals():
    """``spmd`` resolves; it needs a mesh (``run_distgan`` cannot pass
    one and raises as the reference does); the sharded store needs U %
    C == 0; ``multihost`` needs its worker count."""
    pair = make_mlp_pair(MLPGanConfig(**SMALL))
    data, labels = _data()
    ds = dirichlet_partition(data, labels, U, 0.5)
    fcfg = tapp.DistGANConfig(num_users=U)
    assert BackendSpec("spmd").kind == "spmd"
    with pytest.raises(ValueError, match="mesh"):
        run_distgan(pair, fcfg, ds, "approach1", steps=2, batch_size=B,
                    eval_samples=0, participation="uniform", cohort_size=C,
                    state_backend="spmd", device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        FederationSession(pair, fcfg, ds, FederationSpec.from_dict(
            _manifest("approach1", {}, "max_abs")), device="cpu")
    mesh = UsersMesh(None, 0, 3, torch.device("cpu"))
    with pytest.raises(ValueError, match="U % C == 0"):
        spmd.make_spmd_fused_store_engine(
            pair, dataclasses.replace(fcfg, num_users=4), mesh, "approach1",
            3)
    with pytest.raises(ValueError, match="workers"):
        BackendSpec("multihost")
