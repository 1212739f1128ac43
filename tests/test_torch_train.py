"""The LM train step (``repro_torch.launch.steps``), remat and the train
launcher (``repro_torch.launch.train``) held to the JAX reference on the
CPU, at reduced size.

Every family's reduced f32 config takes one ``make_train_step`` step from
the reference's weights (carried by ``params_from_numpy``) on the
reference's ``synthetic_batch_for`` batch; the reference takes the same
step through ``jax.jit(make_train_step(cfg)[0])``, and its gradients come
from the jitted ``value_and_grad`` of its ``loss_fn``.  The gradients are
compared, not the stepped weights: Adam's first step is ``g / (|g| +
eps)``, which turns rounding noise near zero into whole steps of ``lr``.

Tolerances.  The loss matches at rtol 1e-5 (measured <= 1.6e-7).  The
gradients cannot be held as tightly: at random init the attention
softmax is nearly saturated (a stacked weight's fan-in is its layer dim),
so its backward turns f32 rounding into relative errors of 1e-4 to 1e-2,
in the reference itself.  The ``reference`` fixture measures that: how
far the reference's own gradients move when every weight moves one ULP
(seeded signs).  The port's gradients must lie within ``ULP_FACTOR`` x
that floor (the largest over leaves, each leaf's error relative to its
largest entry), and never farther than the family logits tolerance of
``tests/test_torch_zoo.py`` would allow where the floor is lower; the
grad norm within ``ULP_FACTOR`` x the relative L2 move of the whole
gradient (which bounds a norm's move), at least rtol 1e-5.
Measured, port error / floor (gradients): 0.3-2.1 over the families
(tinyllama 0.38, the audio family 2.06).

Remat (``cfg.remat``) changes no number: the loss and every gradient
under ``"full"`` and ``"offloadable-dots"`` equal ``"none"``'s bitwise,
while autograd keeps fewer saved tensors outside the checkpointed layers.
The reference's ``test_loss_decreases_tinyllama`` case runs in both
packages from the same weights and the curves are compared, and the
launcher runs end to end (the reference's ``tests/test_system.py`` case)
with a resume.
"""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import ARCHS
from repro.configs.base import get_config as jget_config
from repro.data.synthetic import TokenStream as JTokenStream
from repro.data.synthetic import synthetic_batch_for as jsynthetic_batch_for
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro_torch.checkpoint import latest_step
from repro_torch.configs.base import get_config
from repro_torch.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.data.synthetic import TokenStream
from repro_torch.launch.steps import (loss_and_grads, make_optimizer,
                                      make_serve_step, make_train_step)
from repro_torch.models import model as TM
from repro_torch.models.common import tree_leaves
from repro_torch.optim import adamw

ROOT = Path(__file__).resolve().parents[1]
ULP_FACTOR = 3
# the family logits tolerances of tests/test_torch_zoo.py
_TOL = {"seamless-m4t-medium": 5e-4}
_TOL_DEFAULT = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The reduced models' ops are tiny: on a CPU shared by several test
    workers, torch's intra-op threads only contend (a step slows tenfold
    and more), so this module runs torch on one thread."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _np_batch(batch) -> dict:
    return {k: np.array(v) for k, v in batch.items()}


def _t_batch(batch) -> dict:
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def _one_ulp(tree, seed: int):
    """Every leaf moved one ULP up or down (seeded signs)."""
    rng = np.random.default_rng(seed)

    def bump(a):
        a = np.asarray(a)
        to = np.where(rng.random(a.shape) < 0.5, np.inf, -np.inf)
        return jnp.asarray(np.nextafter(a, to.astype(a.dtype)))

    return jax.tree.map(bump, tree)


@pytest.fixture(scope="module")
def reference():
    """Per arch, once for the module: the reference's weights, batch, its
    jitted train step's metrics and stepped weights, its gradients and
    its one-ULP floor."""
    cache = {}

    def get(arch):
        if arch in cache:
            return cache[arch]
        jcfg = jget_config(arch).reduced()
        jp = JM.init_params(jcfg, jax.random.key(1))
        jb = jsynthetic_batch_for(jcfg, 2, 32, jax.random.key(2))
        step, opt = jmake_train_step(jcfg)
        jst = opt.init(jp)
        stepped, _, jm = jax.jit(step)(jp, jst, jb)
        vg = jax.jit(jax.value_and_grad(JM.loss_fn, has_aux=True),
                     static_argnums=2)
        (_, _), g = vg(jp, jb, jcfg)
        (_, _), g1 = vg(_one_ulp(jp, 0), jb, jcfg)
        gn = lambda t: float(np.sqrt(sum(np.sum(np.square(
            np.asarray(x, np.float64))) for x in jax.tree.leaves(t))))
        moved = [np.asarray(a, np.float64) - np.asarray(b, np.float64)
                 for a, b in zip(jax.tree.leaves(g1), jax.tree.leaves(g))]
        floor = max(float(np.abs(np.asarray(a) - np.asarray(b)).max()
                          / np.abs(np.asarray(a)).max())
                    for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(g1)))
        cache[arch] = dict(
            params=jax.tree.map(np.asarray, jp), batch=_np_batch(jb),
            opt_state=jax.tree.map(np.asarray, jst),
            loss=float(jm["loss"]), grad_norm=float(jm["grad_norm"]),
            grads=[np.asarray(x) for x in jax.tree.leaves(g)],
            stepped=[np.asarray(x) for x in jax.tree.leaves(stepped)],
            grad_floor=floor, norm_floor=gn(moved) / gn(g))
        return cache[arch]

    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jitted_reference(arch, reference):
    ref = reference(arch)
    cfg = get_config(arch).reduced()
    params = params_from_numpy(ref["params"], "cpu")
    batch = _t_batch(ref["batch"])
    _, _, grads = loss_and_grads(params, batch, cfg)
    step, opt = make_train_step(cfg)
    opt_state = opt_state_from_numpy(ref["opt_state"], "cpu")
    fresh = opt.init(params)
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in
               zip(tree_leaves(opt_state), tree_leaves(fresh)))
    before = [p.clone() for p in tree_leaves(params)]
    params, opt_state, m = step(params, opt_state, batch)

    # the reference test's checks (tests/test_archs_smoke.py)
    assert np.isfinite(float(m["loss"])) and np.isfinite(
        float(m["grad_norm"]))
    assert any(bool(torch.any(a != b)) for a, b in
               zip(before, tree_leaves(params)))
    assert int(opt_state["step"]) == 1

    np.testing.assert_allclose(float(m["loss"]), ref["loss"], rtol=1e-5)
    norm_tol = max(1e-5, ULP_FACTOR * ref["norm_floor"])
    np.testing.assert_allclose(float(m["grad_norm"]), ref["grad_norm"],
                               rtol=norm_tol)
    tol = max(_TOL.get(arch, _TOL_DEFAULT), ULP_FACTOR * ref["grad_floor"])
    for jg, tg in zip(ref["grads"], tree_leaves(grads)):
        rel = np.abs(tg.numpy() - jg).max() / np.abs(jg).max()
        assert rel <= tol, (arch, rel, tol, ref["grad_floor"])
    # both packages' steps from the same point differ by at most 2 lr:
    # Adam's first direction g / (|g| + eps) is within (-1, 1) per entry
    # and the decay term is the same
    for jp, tp, p0 in zip(ref["stepped"], tree_leaves(params), before):
        np.testing.assert_allclose(tp.numpy() - p0.numpy(),
                                   jp - p0.numpy(), rtol=0,
                                   atol=2 * 3e-4 + 1e-6)


def _saved_bytes(fn) -> int:
    """Bytes of the tensors autograd saves (outside checkpointed regions,
    whose saved tensors are the checkpoint's own) while ``fn`` runs."""
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return total[0]


@pytest.mark.parametrize("remat", ["full", "offloadable-dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_changes_no_bit(arch, remat):
    base = get_config(arch).reduced()
    params = TM.init_params(base, 7, device="cpu")
    from repro_torch.data.synthetic import synthetic_batch_for
    batch = synthetic_batch_for(base, 2, 32)
    out = {}
    for mode in ("none", remat):
        cfg = dataclasses.replace(base, remat=mode)
        res = {}

        def run():
            res["v"] = loss_and_grads(params, batch, cfg)

        out[mode] = (_saved_bytes(run), res["v"])
    (b0, (l0, m0, g0)), (b1, (l1, m1, g1)) = out["none"], out[remat]
    assert torch.equal(l0, l1)
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(g0), tree_leaves(g1)))
    assert b1 < b0, (b1, b0)


def test_remat_refuses_an_unknown_policy():
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              remat="everything")
    params = TM.init_params(cfg, 0, device="cpu")
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32),
             "targets": torch.zeros((1, 4), dtype=torch.int32)}
    with pytest.raises(ValueError, match="remat"):
        loss_and_grads(params, batch, cfg)


def test_loss_curve_tracks_reference_tinyllama():
    """The reference's ``test_loss_decreases_tinyllama`` (25 steps,
    ``adamw(1e-3)``, ``TokenStream(V, 64, 8, seed=1)``) from the same
    weights in both packages.  The first loss agrees at rtol 1e-5; then
    Adam turns rounding noise into lr-sized moves and the curves part, in
    the reference too: from weights moved one ULP (two sign seeds) its
    own curve lies up to 0.027-0.049 away (measured).  The port's curve
    must lie within ``ULP_FACTOR`` x the larger of those two gaps at
    every step (measured 0.066), and fall by at least 0.3."""
    jcfg = jget_config("tinyllama-1.1b").reduced()
    cfg = get_config("tinyllama-1.1b").reduced()
    jp0 = JM.init_params(jcfg, jax.random.key(3))
    jstep, jopt = jmake_train_step(jcfg, jadamw(1e-3))
    jstep = jax.jit(jstep)
    jstream = JTokenStream(jcfg.vocab_size, 64, 8, seed=1)

    def ref_curve(jp):
        jst, out = jopt.init(jp), []
        for i in range(25):
            jp, jst, jm = jstep(jp, jst, jstream.batch(i))
            out.append(float(jm["loss"]))
        return np.array(out)

    jl = ref_curve(jp0)
    floor = max(np.abs(ref_curve(_one_ulp(jp0, s)) - jl).max()
                for s in (0, 1))
    params = params_from_numpy(jax.tree.map(np.asarray, jp0), "cpu")
    step, opt = make_train_step(cfg, adamw(1e-3))
    st = opt.init(params)
    stream = TokenStream(cfg.vocab_size, 64, 8, seed=1)
    tl = []
    for i in range(25):
        tb = stream.batch(i)
        jb = jstream.batch(i)
        assert all(np.array_equal(np.asarray(jb[k]), tb[k].numpy())
                   for k in jb)
        params, st, m = step(params, st, tb)
        tl.append(float(m["loss"]))
    tl = np.array(tl)
    np.testing.assert_allclose(tl[0], jl[0], rtol=1e-5)
    gap = np.abs(tl - jl)
    assert gap.max() <= ULP_FACTOR * floor, (gap.max(), floor, jl, tl)
    assert tl[-1] < tl[0] - 0.3, tl


def test_make_optimizer_and_serve_step():
    cfg = get_config("tinyllama-1.1b").reduced()
    params = TM.init_params(cfg, 0, device="cpu")
    opt = make_optimizer(cfg, 1e-3)
    st = opt.init(params)
    assert set(st) == {"mu", "nu", "step"}
    cache = TM.init_cache(cfg, 2, 8, device="cpu")
    toks = torch.tensor([[3], [5]], dtype=torch.int32)
    with torch.no_grad():
        a, _ = make_serve_step(cfg)(params, cache, toks, 0)
        b, _ = TM.decode_step(params, cache, toks, 0, cfg)
    assert torch.equal(a, b)


def _launch(*args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *args], capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=timeout)


def test_train_launcher_end_to_end_and_resume(tmp_path):
    """The reference's ``tests/test_system.py`` launcher case on the CPU:
    checkpoint files written, the loss falls; then a second run into the
    same directory resumes at the last saved step: ``restored step 16``,
    the restored weights the saved ones bitwise (sha256 of their bytes;
    weights only, as the reference: the optimizer state starts fresh)."""
    common = ["--arch", "tinyllama-1.1b", "--reduced", "--batch", "4",
              "--seq", "64", "--lr", "2e-3", "--warmup", "2",
              "--ckpt-every", "8", "--device", "cpu", "--ckpt-dir",
              str(tmp_path)]
    r = _launch(*common, "--steps", "16")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "step 15" in r.stdout
    files = os.listdir(tmp_path)
    assert any(f.startswith("step_") for f in files), files
    assert latest_step(str(tmp_path)) == 16
    losses = [float(x) for x in re.findall(r"loss=([\d.]+)", r.stdout)]
    assert losses[-1] < losses[0]

    r2 = _launch(*common, "--steps", "20")
    assert r2.returncode == 0, r2.stdout + r2.stderr
    assert f"restored step 16 from {tmp_path}" in r2.stdout
    saved = re.search(r"saved step 16 weights sha256 (\w+)", r.stdout)[1]
    restored = re.search(r"restored weights sha256 (\w+)", r2.stdout)[1]
    assert saved == restored
    resumed = [float(x) for x in re.findall(r"loss=([\d.]+)", r2.stdout)]
    assert resumed and np.all(np.isfinite(resumed))
    assert "step 19:" in r2.stdout and "step 15:" not in r2.stdout


def test_train_launcher_takes_one_device_only():
    """One device unless the ranks of a mesh are given a backend: ``--data
    2`` alone is refused, naming ``--backend`` (the mesh runs are
    ``tests/test_torch_mesh_train.py``'s)."""
    r = _launch("--arch", "tinyllama-1.1b", "--reduced", "--steps", "1",
                "--data", "2", "--device", "cpu")
    assert r.returncode != 0
    assert "--backend" in r.stderr
