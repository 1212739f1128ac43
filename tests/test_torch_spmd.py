"""The SPMD federation of the port (``core/spmd.py``, ``launch/mesh.py``)
held to the JAX reference's ``core/spmd.py`` on the CPU.

The port runs one gloo rank per user (``spawn_users``); the reference runs
once for the file in a subprocess with forced host devices (the main
process keeps its single CPU device, as ``tests/conftest.py`` requires) and
exports every oracle.  Both start from the reference's initial state (rank
r takes slice r of its stacked Ds, ``convert.state_from_numpy(...,
mesh=)``) and the port's bodies take the reference's draws (``z1``, ``z2``,
the codec seed, the ``random`` uniforms, the ``shared_random``
coordinates), replayed here from the bodies' key splits
(``spmd.py:119-122, 236``).  The main process computes those inputs and
runs the reference's subprocess and the port's ranks at the same time.

* The collectives (``core/collectives.py``): a NaN loses ``pmax`` whichever
  rank holds it, as the reference's XLA pmax drops it (gloo's MAX keeps it
  only on rank 0), ``pmin`` too, ``psum``'s gradient is psum's transpose;
  the combine functions agree with the reference's on rows with a NaN, a
  tie and -0.0 (bitwise; the means to a few ULP), ``shared_random`` flat
  and in its tree form.
* ``make_spmd_step`` at U = 2 (approaches 1, 2, 3; approach 1 also with
  ``random`` selection + ``int8`` + stochastic rounding + the mean fold, and
  with ``shared_random``) and at U = 4 (approaches 1 with ``topk_int8`` +
  stochastic rounding, 2, 3), and ``make_spmd_engine`` at U = 4 over a
  padded remainder chunk: per-round losses and the final state within ATOL =
  1e-5 of the reference's jitted programs (torch's CPU matmul sums in
  another order than XLA's), kept fractions to 1e-6; G and the server D
  bitwise equal on every rank; the padded chunks equal one unpadded chunk
  bitwise.
* Approach 2's G gradient through the differentiable pmean equals the
  reference's host (vmap) gradient (``tests/test_spmd.py:59``'s oracle).
* The example twin runs (``--steps 8``).
"""

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
from repro.core import losses as jlosses
from repro.core.gan import MLPGanConfig as JaxMLPCfg
from repro.core.gan import make_mlp_pair as jax_make_mlp_pair
from repro_torch.convert import state_from_numpy
from repro_torch.core import approaches as tapp
from repro_torch.core import collectives as coll
from repro_torch.core import federated as tfed
from repro_torch.core import spmd
from repro_torch.core.gan import MLPGanConfig, make_mlp_pair
from repro_torch.examples import distgan_spmd_multiuser as example
from repro_torch.launch.mesh import UsersMesh, make_users_mesh, spawn_users
from repro_torch.models.common import tree_leaves

SMALL = dict(data_dim=2, z_dim=8, g_hidden=16, d_hidden=16)
B = 8
ATOL = 1e-5
ROUNDS = 3
JPAIR = jax_make_mlp_pair(JaxMLPCfg(**SMALL))
SRC = os.path.join(os.path.dirname(__file__), "..", "src")

# name -> (U, approach, DistGANConfig overrides, driver)
CASES = {
    "a1-u2": (2, "approach1", {}, "step"),
    "a1-random-int8-sr-mean-u2": (2, "approach1", dict(
        selection="random", codec="int8", codec_stochastic=True,
        error_feedback=False, combiner="mean"), "step"),
    "a1-shared-random-u2": (2, "approach1", dict(selection="shared_random"),
                            "step"),
    "a2-u2": (2, "approach2", {}, "step"),
    "a3-u2": (2, "approach3", {}, "step"),
    "a1-topk-int8-sr-u4": (4, "approach1", dict(
        codec="topk_int8", codec_stochastic=True, error_feedback=False),
        "engine"),
    "a2-u4": (4, "approach2", {}, "engine"),
    "a3-u4": (4, "approach3", {}, "engine"),
}
ENGINE_ROUNDS, ENGINE_K = 6, 4          # chunks of 4: 4 + (2 padded to 4)


def _jfcfg(U, kw):
    return japp.DistGANConfig(num_users=U, upload_frac=0.3, **kw)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def spmd_draws(key, approach, fcfg, width, rounds, *, pair=JPAIR, batch=B):
    """The reference SPMD body's draws from carry key ``key`` over
    ``rounds`` rounds, as the port's body takes them."""
    out = []
    lossy = fcfg.codec != "none"
    n = japp.d_flat_layout(pair).n
    for _ in range(rounds):
        keys = jax.random.split(key, 5 if lossy else 4)
        d = {"z1": np.array(pair.sample_z(keys[1], batch)),
             "z2": np.array(pair.sample_z(keys[2], batch))}
        if approach == "approach3":
            kk, z1, z2 = keys[0], [], []
            for _ in range(width):
                kk, a, b = jax.random.split(kk, 3)
                z1.append(np.array(pair.sample_z(a, batch)))
                z2.append(np.array(pair.sample_z(b, batch)))
            d = {"z1": np.stack(z1), "z2": np.stack(z2)}
            key = kk
        else:
            key = keys[0]
        if fcfg.codec_stochastic and lossy:
            d["seed"] = int(jax.random.randint(keys[4], (), 0,
                                               jnp.int32(2**31 - 1)))
        if fcfg.selection == "random":
            d["uniforms"] = np.array(jax.random.uniform(keys[3], (n,)))[None]
        if fcfg.selection == "shared_random":
            k = max(int(n * fcfg.upload_frac), 1)
            d["idx"] = np.array(jax.random.permutation(keys[3], n)[:k])
        out.append(d)
    return out


def _combine_rows(U, n=64):
    """(U, n) delta rows with a NaN (rank 1 only), ties of equal and of
    opposite sign, an all -0.0 column, a column of one -0.0 among +0.0,
    and +-inf."""
    rows = np.random.default_rng(3).normal(size=(U, n)).astype(np.float32)
    rows[1, 5] = np.nan
    rows[:, 7] = rows[0, 7]              # every rank ties, same sign
    rows[1, 9] = -rows[0, 9]             # a tie of opposite signs
    rows[2:, 9] = 0.0
    rows[:, 11] = -0.0
    rows[:, 12] = 0.0
    rows[U - 1, 12] = -0.0
    rows[2, 14] = np.inf
    rows[3, 15] = -np.inf
    return rows


def _inputs():
    rng = np.random.default_rng(0)
    cases = {}
    for name, (U, approach, kw, driver) in CASES.items():
        fcfg = _jfcfg(U, kw)
        state = japp.init_state(JPAIR, fcfg, jax.random.key(0),
                                sync_ds=approach == "approach1")
        rounds = ROUNDS if driver == "step" else ENGINE_ROUNDS
        cases[name] = {
            "init": _np_tree(state._replace(key=None)._asdict()),
            "reals": rng.normal(size=(rounds, U, B, SMALL["data_dim"])
                                ).astype(np.float32),
            "draws": spmd_draws(state.key, approach, fcfg, U, rounds)}
    rows = _combine_rows(4)
    k = max(int(rows.shape[1] * 0.25), 1)
    comb = {"rows": rows, "frac": 0.25,
            "idx": np.array(jax.random.permutation(jax.random.key(7),
                                                   rows.shape[1])[:k])}
    return {"cases": cases, "combine": comb}


# ---------------------------------------------------------------------------
# The reference, once for the file, in a subprocess with 4 host devices
# ---------------------------------------------------------------------------

_REF = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np, jax, jax.flatten_util, jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as PS
    from repro.core import approaches as japp, federated as jfed
    from repro.core.gan import MLPGanConfig, make_mlp_pair
    from repro.core.spmd import make_spmd_step, shard_map_compat
    from repro.core.engine import make_spmd_engine

    inp = pickle.load(open(sys.argv[1], "rb"))
    SMALL, K = inp["small"], inp["engine_k"]
    pair = make_mlp_pair(MLPGanConfig(**SMALL))
    mesh_of = lambda u: Mesh(np.array(jax.devices()[:u]), ("users",))
    out = {}
    for name, (U, approach, kw, driver) in inp["spec"].items():
        case = inp["cases"][name]
        fcfg = japp.DistGANConfig(num_users=U, upload_frac=0.3, **kw)
        state = japp.init_state(pair, fcfg, jax.random.key(0),
                                sync_ds=approach == "approach1")
        reals, mets = case["reals"], []
        if driver == "step":
            step = make_spmd_step(pair, fcfg, mesh_of(U), approach)
            for r in range(len(reals)):
                state, m = step(state, jnp.asarray(reals[r]))
                mets.append(jax.tree.map(np.asarray, m))
            mets = {k: np.stack([m[k] for m in mets]) for k in mets[0]}
        else:
            eng = make_spmd_engine(pair, fcfg, mesh_of(U), approach)
            parts = []
            for start in range(0, len(reals), K):
                chunk = reals[start:start + K]
                k = len(chunk)
                fill = np.broadcast_to(chunk[-1:], (K - k,) + chunk.shape[1:])
                state, m = eng(state, jnp.asarray(np.concatenate([chunk, fill])),
                               jnp.asarray(np.arange(K) < k))
                parts.append({key: np.asarray(v)[:k] for key, v in m.items()})
            mets = {key: np.concatenate([p[key] for p in parts])
                    for key in parts[0]}
        out[name] = {"metrics": mets, "state": jax.tree.map(
            np.asarray, state._replace(key=None)._asdict())}

    comb = inp["combine"]
    rows = comb["rows"]
    mesh = mesh_of(rows.shape[0])
    def sm(f):
        return jax.jit(shard_map_compat(f, mesh, in_specs=(PS("users"),),
                                        out_specs=PS()))
    out["combine"] = {
        "max_abs": np.asarray(sm(lambda d: jfed.combine_max_abs_spmd(d[0]))(rows)),
        "mean": np.asarray(sm(lambda d: jfed.combine_mean_spmd(d[0]))(rows)),
        "shared_random": np.asarray(sm(lambda d: jfed.combine_shared_random_flat_spmd(
            d[0], comb["frac"], jax.random.key(7))[0])(rows)),
        "shared_random_tree": np.asarray(sm(lambda d: jax.flatten_util.ravel_pytree(
            jfed.combine_shared_random_spmd(
                {"b": d[0][:24].reshape(4, 6), "w": d[0][24:]}, comb["frac"],
                jax.random.key(7))[0])[0])(rows))}
    pickle.dump(out, open(sys.argv[2], "wb"))
""")


def _run_reference(inputs, tmp):
    src, dst = os.path.join(tmp, "ref_in.pkl"), os.path.join(tmp, "ref.pkl")
    with open(src, "wb") as f:
        pickle.dump(dict(inputs, spec=CASES, small=SMALL, engine_k=ENGINE_K),
                    f)
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", _REF, src, dst], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, dst


# ---------------------------------------------------------------------------
# The port, on gloo ranks
# ---------------------------------------------------------------------------

def _state_np(state):
    return {"g": tree_leaves(state.g), "server_d": tree_leaves(state.server_d),
            "g_opt": tree_leaves(state.g_opt), "ds": tree_leaves(state.ds),
            "d_opts": tree_leaves(state.d_opts), "step": state.step.clone()}


def _collectives(mesh: UsersMesh) -> dict:
    r = mesh.rank
    x = torch.tensor([1.0 + r, -2.0 * r, 0.5], dtype=torch.float32)
    nan_on = torch.tensor([math_nan() if r == 1 else 1.0, 3.0])
    a = torch.tensor([2.0 + r], requires_grad=True)
    y = coll.psum(a * (r + 1.0), mesh)
    (grad,) = torch.autograd.grad(y.sum(), a)
    return {"pmax": coll.pmax(x, mesh), "pmin": coll.pmin(x, mesh),
            "pmax_nan": coll.pmax(nan_on, mesh),
            "pmin_nan": coll.pmin(nan_on, mesh),
            "psum": coll.psum(x, mesh), "gather": coll.all_gather(x, mesh),
            "pmax_int": coll.pmax(torch.tensor([r, -r], dtype=torch.int32),
                                  mesh),
            "grad": grad, "axis_index": coll.axis_index(mesh)}


def math_nan():
    return float("nan")


def _approach2_grad(mesh: UsersMesh, g, ds, z):
    """The port's approach-2 G gradient on this rank (``spmd.py:208-220``):
    the pmean of the D probabilities inside the loss, then the pmean of
    the gradients."""
    pair = make_mlp_pair(MLPGanConfig(data_dim=2, z_dim=8, g_hidden=32,
                                      d_hidden=32))
    gp = {k: {kk: torch.from_numpy(v).requires_grad_() for kk, v in
              layer.items()} for k, layer in g.items()}
    d = {k: {kk: torch.from_numpy(v[mesh.rank:mesh.rank + 1]) for kk, v in
             layer.items()} for k, layer in ds.items()}
    p = torch.sigmoid(pair.d_apply(d, pair.g_apply(gp, torch.from_numpy(z))))
    loss = -torch.mean(torch.log(coll.pmean(p, mesh) + 1e-7))
    leaves = tree_leaves(gp)
    grads = torch.autograd.grad(loss, leaves)
    return [coll.pmean(x, mesh) for x in grads]


def _delta_tree(row):
    """A delta row as a two-leaf tree (the combine functions' tree form)."""
    return {"b": row[:24].reshape(4, 6), "w": row[24:]}


def _tree_flat(tree):
    """The tree in the reference's ``ravel_pytree`` order (sorted keys)."""
    return torch.cat([tree["b"].reshape(-1), tree["w"].reshape(-1)])


def noise_tensors(draws: dict) -> dict:
    return {k: v if isinstance(v, int) else torch.from_numpy(v)
            for k, v in draws.items()}


def _port_rank(mesh: UsersMesh, inputs) -> dict:
    pair = make_mlp_pair(MLPGanConfig(**SMALL))
    out = {"collectives": _collectives(mesh)}
    for name, (U, approach, kw, driver) in CASES.items():
        if U != mesh.size:
            continue
        case = inputs["cases"][name]
        fcfg = tapp.DistGANConfig(num_users=U, upload_frac=0.3, **kw)
        state = state_from_numpy(case["init"], "cpu", mesh=mesh)
        reals, draws = case["reals"], [noise_tensors(d) for d in case["draws"]]
        if driver == "step":
            step = spmd.make_spmd_step(pair, fcfg, mesh, approach)
            mets = []
            for r in range(len(reals)):
                state, m = step(state, reals[r], noise=draws[r])
                mets.append(m)
            mets = {k: torch.stack([m[k] for m in mets]) for k in mets[0]}
        else:
            eng = spmd.make_spmd_engine(pair, fcfg, mesh, approach)
            one = state.clone()
            parts = []
            for start in range(0, len(reals), ENGINE_K):
                k = min(ENGINE_K, len(reals) - start)
                idx = np.minimum(np.arange(start, start + ENGINE_K),
                                 len(reals) - 1)
                state, m = eng(state, reals[idx], valid=np.arange(ENGINE_K)
                               < k, noise=[draws[i] for i in idx])
                parts.append({key: v[:k] for key, v in m.items()})
            mets = {key: torch.cat([p[key] for p in parts]) for key in parts[0]}
            one, m_one = eng(one, reals, noise=draws)
            out[name + "/one_chunk"] = {"metrics": m_one,
                                        "state": _state_np(one)}
            # the same rounds one make_spmd_step call at a time
            st = state_from_numpy(case["init"], "cpu", mesh=mesh)
            step = spmd.make_spmd_step(pair, fcfg, mesh, approach)
            steps = []
            for r in range(len(reals)):
                st, m = step(st, reals[r], noise=draws[r])
                steps.append(m)
            out[name + "/step"] = {
                "metrics": {k: torch.stack([m[k] for m in steps])
                            for k in steps[0]}, "state": _state_np(st)}
        out[name] = {"metrics": mets, "state": _state_np(state)}
    if mesh.size == 2:
        g, ds, z = inputs["grad"]
        out["grad"] = _approach2_grad(mesh, g, ds, z)
    if mesh.size == 4:
        rows = torch.from_numpy(inputs["combine"]["rows"][mesh.rank])
        idx = torch.from_numpy(inputs["combine"]["idx"])
        out["combine"] = {
            "max_abs": tfed.combine_max_abs_spmd(rows, mesh),
            "mean": tfed.combine_mean_spmd(rows, mesh),
            "shared_random": tfed.combine_shared_random_flat_spmd(
                rows, idx, mesh)[0],
            "shared_random_tree": _tree_flat(tfed.combine_shared_random_spmd(
                _delta_tree(rows), idx, mesh)[0])}
    return out


def _grad_oracle():
    """``tests/test_spmd.py:59``'s inputs and its host (vmap) gradient."""
    pair = jax_make_mlp_pair(JaxMLPCfg(data_dim=2, z_dim=8, g_hidden=32,
                                       d_hidden=32))
    g, _ = pair.init(jax.random.key(0))
    ds = pair.init_user_ds(jax.random.key(1), 2)
    z = pair.sample_z(jax.random.key(2), 16)

    def host_loss(gp):
        f = pair.g_apply(gp, z)
        per = jax.vmap(lambda d: pair.d_apply(d, f))(ds)
        return jlosses.g_loss_avg_probs(per)

    want = jax.grad(host_loss)(g)
    return (_np_tree(g), _np_tree(ds), np.asarray(z)), jax.tree.leaves(want)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("spmd"))
    inputs = _inputs()
    grad_in, want = _grad_oracle()
    inputs["grad"] = grad_in
    proc, dst = _run_reference(inputs, tmp)
    try:
        # repro: allow(RPR002): a torch.distributed backend, no registry key
        port = {u: spawn_users(_port_rank, u, backend="gloo", device="cpu",
                               args=(inputs,), timeout_s=300)
                for u in (2, 4)}
        log, _ = proc.communicate(timeout=560)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, log
    with open(dst, "rb") as f:
        ref = pickle.load(f)
    return {"ref": ref, "port": port, "inputs": inputs, "grad_want": want}


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


def _bitwise(a, b):
    a = np.ascontiguousarray(np.atleast_1d(a))
    b = np.ascontiguousarray(np.atleast_1d(b))
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

def test_collectives_on_gloo_ranks(runs):
    """psum / pmax / pmin / all_gather / axis_index on 2 and 4 ranks; a
    NaN on rank 1 loses pmax and pmin (the reference's XLA pmax drops it;
    gloo's MAX would keep it only on rank 0); psum's gradient is a psum of the
    cotangents: every rank holds y = sum_r (r + 1) a_r, and rank r's
    gradient of its y is U (r + 1) (the U ranks' cotangents summed)."""
    for u, ranks in runs["port"].items():
        xs = np.stack([[1.0 + r, -2.0 * r, 0.5] for r in range(u)]
                      ).astype(np.float32)
        for r, out in enumerate(ranks):
            c = out["collectives"]
            assert c["axis_index"] == r
            _bitwise(c["pmax"].numpy(), xs.max(0))
            _bitwise(c["pmin"].numpy(), xs.min(0))
            _bitwise(c["gather"].numpy(), xs)
            np.testing.assert_allclose(c["psum"].numpy(), xs.sum(0),
                                       rtol=1e-7)
            _bitwise(c["pmax_nan"].numpy(), np.float32([1.0, 3.0]))
            _bitwise(c["pmin_nan"].numpy(), np.float32([1.0, 3.0]))
            np.testing.assert_array_equal(c["pmax_int"].numpy(), [u - 1, 0])
            assert float(c["grad"]) == u * (r + 1)


@pytest.mark.parametrize("fold", ["max_abs", "mean", "shared_random",
                                  "shared_random_tree"])
def test_combine_spmd_matches_reference(runs, fold):
    """The combine functions on 4 ranks against the reference's under
    shard_map, on rows with a NaN on rank 1, ties and -0.0: max_abs
    bitwise (the NaN dropped, as the reference drops it; the sign of zero
    kept), the means (a sum of 4 in another order) to a few ULP with the
    NaN column NaN; ``shared_random`` with the reference's coordinates
    injected, flat and as a two-leaf tree; every rank holds the same
    result."""
    want = runs["ref"]["combine"][fold]
    outs = [o["combine"][fold].numpy() for o in runs["port"][4]]
    for got in outs[1:]:
        _bitwise(got, outs[0])
    if fold == "max_abs":
        _bitwise(outs[0], want)
        assert np.isfinite(outs[0][5])
    else:
        np.testing.assert_allclose(outs[0], want, rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(np.isnan(outs[0]), np.isnan(want))


def _rank_state(ranks, key):
    """The ranks' states as the reference's: stacked Ds / D optimizers
    from each rank's slice, the replicated leaves from rank 0 (after
    checking every rank holds them bitwise)."""
    states = [o[key]["state"] for o in ranks]
    for s in states[1:]:
        for name in ("g", "g_opt", "server_d"):
            for a, b in zip(s[name], states[0][name]):
                _bitwise(a.numpy(), b.numpy())
        _bitwise(s["step"].numpy(), states[0]["step"].numpy())
    full = dict(states[0])
    for name in ("ds", "d_opts"):
        full[name] = [torch.cat([s[name][i] for s in states])
                      for i in range(len(states[0][name]))]
    return full


def _ref_leaves(state):
    return {name: jax.tree.leaves(state[name])
            for name in ("g", "g_opt", "ds", "d_opts", "server_d")}


@pytest.mark.parametrize("case", list(CASES))
def test_spmd_matches_reference(runs, case):
    """Each case against the reference's jitted SPMD step / engine, from
    its initial state and with its draws: per-round losses and the final
    state within ATOL, kept fractions to 1e-6; G, its optimizer, the
    server D and the step bitwise equal on every rank."""
    U = CASES[case][0]
    ref = runs["ref"][case]
    ranks = runs["port"][U]
    port = _rank_state(ranks, case)
    got = ranks[0][case]["metrics"]
    for key in ("g_loss", "d_loss"):
        _close(got[key].numpy(), ref["metrics"][key])
    np.testing.assert_allclose(got["kept_frac"].numpy(),
                               ref["metrics"]["kept_frac"], atol=1e-6, rtol=0)
    want = _ref_leaves(ref["state"])
    for name, leaves in want.items():
        for a, b in zip(port[name], leaves):
            _close(a.numpy(), b)
    assert int(port["step"]) == int(ref["state"]["step"])


@pytest.mark.parametrize("case", [c for c in CASES if CASES[c][3] == "engine"])
def test_spmd_step_at_four_users_matches_reference(runs, case):
    """``make_spmd_step`` at U = 4, round by round, against the reference's
    engine over the same rounds (its scan runs the step's body), within
    ATOL; the port's step and engine agree bitwise."""
    U = CASES[case][0]
    ref = runs["ref"][case]
    ranks = runs["port"][U]
    step = _rank_state(ranks, case + "/step")
    got = ranks[0][case + "/step"]["metrics"]
    for key in ("g_loss", "d_loss"):
        _close(got[key].numpy(), ref["metrics"][key])
        _bitwise(got[key].numpy(),
                 ranks[0][case + "/one_chunk"]["metrics"][key].numpy())
    for name, leaves in _ref_leaves(ref["state"]).items():
        for a, b in zip(step[name], leaves):
            _close(a.numpy(), b)


@pytest.mark.parametrize("case", [c for c in CASES if CASES[c][3] == "engine"])
def test_padded_remainder_chunk_equals_one_chunk(runs, case):
    """Inside the port: the masked rounds of a padded remainder chunk leave
    the carry untouched, so 4 + (2 of 4) rounds equal one chunk of 6
    bitwise."""
    ranks = runs["port"][CASES[case][0]]
    a = _rank_state(ranks, case)
    b = _rank_state(ranks, case + "/one_chunk")
    for name in ("g", "g_opt", "ds", "d_opts", "server_d"):
        for x, y in zip(a[name], b[name]):
            _bitwise(x.numpy(), y.numpy())
    for key in ("g_loss", "d_loss"):
        _bitwise(ranks[0][case]["metrics"][key].numpy(),
                 ranks[0][case + "/one_chunk"]["metrics"][key].numpy())


def test_approach2_grad_matches_host_simulation(runs):
    """The G gradient through the differentiable pmean (psum's transpose)
    equals the reference's stacked-host gradient; a psum whose backward
    were the identity would leave it a factor U = 2 off."""
    want = runs["grad_want"]
    for out in runs["port"][2]:
        for got, w in zip(out["grad"], want):
            np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                       rtol=1e-5, atol=1e-7)


def test_mesh_refusals():
    """No process group, no mesh; a bad mesh size or approach is refused."""
    with pytest.raises(RuntimeError, match="process group"):
        make_users_mesh(2, device="cpu")
    pair = make_mlp_pair(MLPGanConfig(**SMALL))
    mesh = UsersMesh(None, 0, 2, torch.device("cpu"))
    assert mesh.shape["users"] == 2
    with pytest.raises(ValueError, match="num_users"):
        spmd.make_spmd_step(pair, tapp.DistGANConfig(num_users=3), mesh,
                            "approach1")
    with pytest.raises(ValueError, match="approach1/2/3"):
        spmd.make_spmd_body(pair, tapp.DistGANConfig(num_users=2),
                            "baseline", mesh)
    with pytest.raises(ValueError, match="BCE"):
        spmd.make_spmd_body(pair, tapp.DistGANConfig(num_users=2,
                                                     loss_type="wgan"),
                            "approach2", mesh)


def test_example_twin_smoke(capsys):
    """The §5.7 example on 5 gloo ranks, 8 rounds: one coverage line per
    approach."""
    lines = example.main(["--steps", "8", "--device", "cpu"])
    assert len(lines) == 2
    printed = capsys.readouterr().out
    for approach in ("approach1", "approach2"):
        assert f"{approach}: g_loss=" in printed
    assert printed.count("users_covered=") == 2
    assert printed.count("modes_hit=") == 2
