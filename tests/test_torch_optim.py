"""The port's optimizers and schedules held to the reference's
(``repro.optim``): SGD with and without momentum, ``global_norm_clip``,
AdamW with a schedule for its lr, and ``constant`` / ``linear_warmup`` /
``cosine_schedule``.  Tolerance atol 1e-7 / rtol 1e-6 (one f32 op apart;
the schedules' cos is libm's on one side and XLA's on the other).  With a
float lr, AdamW's update is held BITWISE to its formula.  A step of the reference's jitted
AdamW and SGD rounds ``p - lr * direction`` once (XLA on the CPU fuses the
multiply and the add): the port's first AdamW step and its SGD steps equal
it BITWISE, where rounding the product first differs at exact ties."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro_torch import optim as topt

TOL = dict(atol=1e-7, rtol=1e-6)


def _tree(seed, lead=()):
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.normal(size=lead + (4, 3)).astype(np.float32)},
            "b": rng.normal(size=lead + (5,)).astype(np.float32)}


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got, want, **tol):
    jax.tree.map(lambda g, w: np.testing.assert_allclose(
        g.numpy(), np.asarray(w), **(tol or TOL)), got, want)


SCHEDULES = {
    "constant": (lambda m: m.constant(3e-4)),
    "linear_warmup": (lambda m: m.linear_warmup(1e-3, 7)),
    "cosine": (lambda m: m.cosine_schedule(1e-3, 5, 40, final_frac=0.2)),
    "cosine_no_warmup": (lambda m: m.cosine_schedule(2e-3, 0, 9)),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match_reference(name):
    j, t = SCHEDULES[name](jopt), SCHEDULES[name](topt)
    steps = np.arange(0, 50, dtype=np.int32)
    want = np.array([np.asarray(j(jnp.int32(s))) for s in steps])
    got = t(torch.from_numpy(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert float(t(12)) == pytest.approx(float(want[12]), rel=1e-6)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("sched", [False, True])
def test_sgd_steps_match_reference(momentum, sched):
    lr = (lambda m: m.linear_warmup(0.1, 3)) if sched else (lambda m: 0.05)
    jo, to = jopt.sgd(lr(jopt), momentum=momentum), \
        topt.sgd(lr(topt), momentum=momentum)
    jp = _tree(0)
    tp = _t(jp)
    js, ts = jo.init(jp), to.init(tp)
    for i in range(4):
        grads = _tree(10 + i)
        upd, js = jo.update(grads, js, jp)
        jp = jopt.apply_updates(jp, upd)
        topt.apply_updates(tp, to.update(_t(grads), ts, tp))
    _close(tp, jp)
    assert int(ts["step"]) == int(js["step"]) == 4
    if momentum:
        _close(ts["vel"], js["vel"])


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_global_norm_clip_matches_reference(max_norm):
    grads = _tree(3)
    jg, jn = jopt.global_norm_clip(grads, max_norm)
    tg, tn = topt.global_norm_clip(_t(grads), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), **TOL)
    _close(tg, jg)


def test_adamw_with_a_schedule_matches_reference():
    sched = (lambda m: m.cosine_schedule(1e-2, 2, 6))
    jo = jopt.adamw(sched(jopt), b1=0.5, b2=0.999, weight_decay=0.01)
    to = topt.adamw(sched(topt), b1=0.5, b2=0.999, weight_decay=0.01)
    jp = _tree(1)
    tp = _t(jp)
    js, ts = jo.init(jp), to.init(tp)
    for i in range(5):
        grads = _tree(20 + i)
        upd, js = jo.update(grads, js, jp)
        jp = jopt.apply_updates(jp, upd)
        topt.apply_updates(tp, to.update(_t(grads), ts, tp))
    _close(tp, jp, atol=1e-6, rtol=1e-5)
    _close(ts["mu"], js["mu"])


def test_adamw_schedule_broadcasts_over_stacked_users():
    """Stacked per-user optimizers (a (U,) step): user u's update is what
    its own single optimizer gives, the lr read from its own step."""
    sched = topt.linear_warmup(1e-2, 4)
    opt = topt.adamw(sched, b1=0.5, b2=0.999)
    stacked = _t(_tree(2, lead=(3,)))
    st = opt.init(stacked, (3,))
    st["step"] += torch.tensor([0, 2, 5], dtype=torch.int32)
    singles = [jax.tree.map(lambda a: a[u].clone(), stacked) for u in range(3)]
    grads = _t(_tree(7, lead=(3,)))
    topt.apply_updates(stacked, opt.update(grads, st, stacked))
    for u, start in enumerate((0, 2, 5)):
        su = opt.init(singles[u])
        su["step"] += start
        topt.apply_updates(singles[u], opt.update(
            jax.tree.map(lambda a: a[u], grads), su, singles[u]))
        jax.tree.map(lambda a, b: torch.testing.assert_close(
            a[u], b, rtol=0, atol=0), stacked, singles[u])


def test_adamw_float_lr_is_the_unscheduled_formula_bitwise():
    lr, b1, b2, eps = 2e-4, 0.5, 0.999, 1e-8
    p = _t(_tree(4))
    opt = topt.adamw(lr, b1=b1, b2=b2, eps=eps)
    st = opt.init(p)
    mu = jax.tree.map(torch.zeros_like, p)
    nu = jax.tree.map(torch.zeros_like, p)
    for i in range(3):
        g = _t(_tree(30 + i))
        upd = opt.update(g, st, p)
        step = torch.tensor(float(i + 1))
        c1 = 1.0 - torch.pow(torch.tensor(b1), step)
        c2 = 1.0 - torch.pow(torch.tensor(b2), step)
        for path in (("a", "w"), ("b",)):
            get = (lambda t: t[path[0]][path[1]]) if len(path) == 2 else \
                (lambda t: t[path[0]])
            m = b1 * get(mu) + (1 - b1) * get(g)
            v = b2 * get(nu) + (1 - b2) * (get(g) * get(g))
            get(mu).copy_(m)
            get(nu).copy_(v)
            root = torch.sqrt((v / c2).double()).float()
            want = ((m / c1) / (root + eps)).double() * float(np.float32(-lr))
            assert torch.equal(get(upd), want)


def _jit_step(jo):
    @jax.jit
    def step(p, g, st):
        upd, st = jo.update(g, st, p)
        return jopt.apply_updates(p, upd), st
    return step


def test_first_adamw_step_and_sgd_round_as_the_references_jitted_step():
    """The reference's jitted step rounds ``p + (-lr * direction)`` once;
    the port's AdamW (first step) and SGD (every step) give its bits on 2**16
    entries.  One entry, from a federation round at Adam's first step, is
    an exact tie once the product is rounded: rounding twice moves it by
    one unit in the last place, which can flip a top-k mask among the
    near-equal first-step deltas."""
    rng = np.random.default_rng(11)
    n = 1 << 16
    p = (rng.normal(size=n) * 0.2).astype(np.float32)
    gs = [(rng.normal(size=n) * 1e-3).astype(np.float32) for _ in range(3)]
    p[0], gs[0][0] = np.float32(0.15700573), np.float32(0.0007253331)
    for make, steps in ((lambda m: m.adamw(2e-4, b1=0.5, b2=0.999), 1),
                        (lambda m: m.sgd(0.05), 3),
                        (lambda m: m.sgd(m.linear_warmup(0.1, 3)), 3)):
        jo, to = make(jopt), make(topt)
        step = _jit_step(jo)
        jp, js = p, jo.init(p)
        tp = torch.from_numpy(p.copy())
        ts = to.init(tp)
        for g in gs[:steps]:
            jp, js = step(jp, g, js)
            upd = to.update(torch.from_numpy(g), ts, tp)
            topt.apply_updates(tp, upd)
            np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    jo, to = jopt.adamw(2e-4, b1=0.5, b2=0.999), \
        topt.adamw(2e-4, b1=0.5, b2=0.999)
    want = np.asarray(_jit_step(jo)(p, gs[0], jo.init(p))[0])[0]
    tp = torch.from_numpy(p.copy())
    u = to.update(torch.from_numpy(gs[0]), to.init(tp), tp)[0]
    twice = np.float32(p[0] + np.float32(u))
    assert want == np.float32(0.15680574) and twice != want


def test_adamw_sqrt_is_correctly_rounded():
    """Adam's sqrt equals the correctly rounded f32 root (numpy's, and the
    reference's) on 2**20 values, where torch's vectorized CPU sqrt is
    off by one unit in the last place on some of them."""
    from repro_torch.optim.optimizers import _sqrt
    rng = np.random.default_rng(12)
    x = (np.float32(1e-3) * np.square(rng.normal(size=1 << 20) * 1e-3)
         .astype(np.float32)) / np.float32(0.00099998713)
    np.testing.assert_array_equal(_sqrt(torch.from_numpy(x)).numpy(),
                                  np.sqrt(x))
