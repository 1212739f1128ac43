"""The port's contract checker (``repro_torch.analysis``) held to the
reference's (``repro.analysis``) on the CPU: the registry snapshot, the
specimen names of every trace hook, the framework-neutral lint rules on
the reference's own fixtures, the report text; each torch-form rule
firing on a broken case and silent on its clean twin; and the port's
tree clean under both passes."""

import dataclasses
import os
import textwrap

import torch
import pytest

from repro_torch.analysis import Violation, render_json, render_report
from repro_torch.analysis import lint as tlint
from repro_torch.analysis import tracecheck as ttc
from repro_torch.core.engine import TraceSpecimen
from repro_torch.kernels import ops as kops

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "analysis")


def _ref_setup():
    from repro.core.approaches import DistGANConfig
    from repro.core.gan import MLPGanConfig, make_mlp_pair

    pair = make_mlp_pair(MLPGanConfig(data_dim=2, z_dim=4, g_hidden=8,
                                      d_hidden=8))
    return pair, DistGANConfig(num_users=2, selection="topk",
                               upload_frac=0.5)


def _ef(fcfg):
    return dataclasses.replace(fcfg, codec="topk_int8", error_feedback=True)


# ---------------------------------------------------------------------------
# the hooks, held to the reference
# ---------------------------------------------------------------------------

def test_registry_snapshot_equals_reference():
    from repro.core.spec import registry_snapshot as ref_snapshot
    from repro_torch.core.spec import registry_snapshot
    assert registry_snapshot() == ref_snapshot()


@pytest.mark.parametrize("ef", [False, True], ids=["plain", "topk_int8_ef"])
def test_specimen_names_equal_reference(ef):
    from repro.core.engine import trace_specimens as ref_specimens
    from repro.core.spmd import spmd_trace_specimens as ref_spmd
    from repro.launch.mesh import make_users_mesh as ref_mesh
    from repro.multihost.backend import multihost_trace_specimens as ref_mh
    from repro_torch.core.engine import trace_specimens
    from repro_torch.core.spmd import spmd_trace_specimens
    from repro_torch.launch.mesh import UsersMesh
    from repro_torch.multihost.backend import multihost_trace_specimens

    rpair, rcfg = _ref_setup()
    pair, fcfg = ttc._tiny_setup()
    if ef:
        rcfg, fcfg = _ef(rcfg), _ef(fcfg)
    names = lambda specs: [sp.name for sp in specs]
    assert names(trace_specimens(pair, fcfg, device="cpu")) == \
        names(ref_specimens(rpair, rcfg))
    assert names(multihost_trace_specimens(pair, fcfg, device="cpu")) == \
        names(ref_mh(rpair, rcfg))
    # the SPMD names, the reference's from a 1-device users mesh (under
    # EF approach 1 alone, as both checkers run it: the SPMD bodies compress
    # approach 1's uploads only); building the port's specimens calls no
    # collective, so no group is needed
    mesh = UsersMesh(None, 0, 1, torch.device("cpu"))
    which = ("approach1",) if ef else None
    assert names(spmd_trace_specimens(pair, fcfg, mesh,
                                      approaches=which)) == \
        names(ref_spmd(rpair, rcfg, ref_mesh(1), approaches=which))


# ---------------------------------------------------------------------------
# the framework-neutral lint rules on the reference's own fixtures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fixture", [
    "rpr002_bad.py", "rpr002_clean.py", "rpr004_bad.py", "rpr004_clean.py",
    "rpr005_bad.py", "rpr005_clean.py"])
def test_lint_matches_reference_on_its_fixtures(fixture):
    from repro.analysis.lint import run_lint as ref_run_lint
    path = os.path.join(FIXTURES, fixture)
    pairs = lambda vs: sorted((v.rule, v.where.rpartition(":")[2])
                              for v in vs)
    ours = tlint.run_lint(paths=[path])[0]
    assert pairs(ours) == pairs(ref_run_lint(paths=[path])[0])
    assert bool(ours) == fixture.endswith("_bad.py")


def test_report_rendering_equals_reference():
    from repro.analysis import Violation as RefViolation
    from repro.analysis import render_json as ref_json
    from repro.analysis import render_report as ref_report
    rows = [("TRC003", "approach1/fused", "an f64 value"),
            ("RPR004", "src/x.py:7", "np.random.randn draws"),
            ("RPR004", "src/y.py:9", "np.random.rand draws")]
    checked = {"lint_files": 3, "trace_programs": 54}
    ours = [Violation(*r) for r in rows]
    theirs = [RefViolation(*r) for r in rows]
    assert render_report(ours, checked) == ref_report(theirs, checked)
    assert render_json(ours, checked) == ref_json(theirs, checked)
    assert render_report([], checked) == ref_report([], checked)
    assert render_json([], checked) == ref_json([], checked)


# ---------------------------------------------------------------------------
# the torch-form lint rules: a broken fixture fires, its clean twin does not
# ---------------------------------------------------------------------------

_RPR001 = ("""
    import numpy as np
    import torch


    class Store:
        def __init__(self, n):
            self.rows = np.zeros((n, 4), np.float32)

        def snapshot(self):
            return torch.from_numpy(self.rows)
    """, """
    import numpy as np
    import torch


    class Store:
        def __init__(self, n):
            self.rows = np.zeros((n, 4), np.float32)

        def snapshot(self):
            return torch.from_numpy(self.rows).clone()

        def view(self):
            return torch.as_tensor(np.array(self.rows))
    """)

_RPR003 = ("""
    from repro_torch.core.engine import make_engine


    def run(pair, fcfg, state, a, b):
        eng = make_engine(pair, fcfg, "approach1")
        state, m1 = eng(state, a)
        state, m2 = eng(state, b)
        return m1["d_loss"], m2["d_loss"]
    """, """
    from repro_torch.core.engine import make_engine


    def run(pair, fcfg, state, a, b):
        eng = make_engine(pair, fcfg, "approach1")
        state, m1 = eng(state, a)
        first = m1["d_loss"].clone()
        state, m2 = eng(state, b)
        return first, m2["d_loss"]
    """)

_RPR004 = ("""
    import torch


    def noise(n):
        z = torch.randn((n, 4))
        return z.uniform_()
    """, """
    import torch


    def noise(n, gen):
        z = torch.randn((n, 4), generator=gen)
        return z.uniform_(generator=gen)
    """)

_RPR006_REF = """
    def topk_ref(x, frac):
        return x
    """
_RPR006 = ("""
    from repro_torch.kernels import build

    launches = 0
    PLAIN_VERSIONS = {"topk": "topk_missing_ref"}


    def topk(x, frac):
        global launches
        build.load("topk")
        launches += 1
        return x


    def codec(x):
        global launches
        launches += 1
        return x
    """, """
    from repro_torch.kernels import build

    launches = 0
    PLAIN_VERSIONS = {"topk": "topk_ref"}


    def topk(x, frac):
        global launches
        build.load("topk")
        launches += 1
        return x
    """)


def _write(path, src):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(src).lstrip())
    return str(path)


@pytest.mark.parametrize("rule,sources,where", [
    ("RPR001", _RPR001, "mod.py"),
    ("RPR003", _RPR003, "mod.py"),
    ("RPR004", _RPR004, "src/repro_torch/mod.py"),
    ("RPR006", _RPR006, "kernels/wrap.py"),
])
def test_torch_form_rules(tmp_path, rule, sources, where):
    fired = {}
    for kind, src in zip(("bad", "clean"), sources):
        root = tmp_path / kind
        paths = [_write(root / where, src)]
        if rule == "RPR006":
            paths.append(_write(root / "kernels" / "ref.py", _RPR006_REF))
        fired[kind] = tlint.run_lint(paths=paths, root=str(root))[0]
    assert fired["bad"], f"{rule} broken fixture produced no violation"
    assert {v.rule for v in fired["bad"]} == {rule}
    assert fired["clean"] == []
    if rule in ("RPR004", "RPR006"):
        assert len(fired["bad"]) == 2      # both draws / both faults


def test_rpr004_torch_draws_only_inside_the_port(tmp_path):
    path = _write(tmp_path / "tests" / "mod.py", _RPR004[0])
    assert tlint.run_lint(paths=[path], root=str(tmp_path))[0] == []


def test_waiver_suppresses_and_is_counted(tmp_path):
    path = _write(tmp_path / "waived.py", """
        import numpy as np


        def jitter(n):
            # repro: allow(RPR004): demo-only jitter, never in a run
            return np.random.randn(n)
        """)
    violations, checked = tlint.run_lint(paths=[path], root=str(tmp_path))
    assert violations == [] and checked["lint_waived"] == 1


def test_waiver_is_rule_specific(tmp_path):
    path = _write(tmp_path / "wrong_rule.py", """
        import numpy as np


        def jitter(n):
            # repro: allow(RPR001): wrong rule, must not suppress
            return np.random.randn(n)
        """)
    violations, _ = tlint.run_lint(paths=[path], root=str(tmp_path))
    assert [v.rule for v in violations] == ["RPR004"]


# ---------------------------------------------------------------------------
# the trace contracts: toy specimens that break one, and their clean twins
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Carry:
    w: torch.Tensor
    step: torch.Tensor


def _carry():
    return _Carry(torch.ones(4), torch.zeros((), dtype=torch.int32))


def _rebinds(c):
    c.w = c.w * 2.0                   # a new tensor: not in place
    return c, {}


def _in_place(c):
    c.w.mul_(2.0)
    c.step += 1
    return c, {}


def _copies(c):
    return _Carry(c.w * 2.0, c.step + 1), {}


def _reads_host(c):
    c.w.mul_(2.0)
    if c.w.sum().item() > 0:          # a host read of a round value
        c.step += 1
    return c, {}


def _promotes(c):
    c.w.copy_(c.w.to(torch.float64) * 2.0)
    return c, {}


def _topk_twice(c):
    kops.topk_mask(c.w[None], 0.5)
    kops.topk_mask(c.w[None], 0.5)
    return c, {}


def _topk_once(c):
    kops.topk_mask(c.w[None], 0.5)
    return c, {}


@pytest.mark.parametrize("rule,bad,clean,donate,launches", [
    ("TRC001", _rebinds, _in_place, (0,), None),
    ("TRC001", _copies, _in_place, (0,), None),
    ("TRC001", _in_place, _copies, (), None),
    ("TRC002", _reads_host, _in_place, (0,), None),
    ("TRC003", _promotes, _in_place, (0,), None),
    ("TRC004", _topk_twice, _topk_once, (0,), {"topk_mask_rows": 1}),
], ids=["rebound", "copied", "not_a_copy", "host_read", "f64", "launches"])
def test_trace_rule_fires_on_broken_specimen(rule, bad, clean, donate,
                                             launches):
    def specimen(fn):
        # the "not a copy" case holds the in-place body to donate=()
        return TraceSpecimen(f"toy/{fn.__name__}", fn, (_carry(),),
                             donate=donate, expect_graph=False,
                             launches=launches)
    fired = ttc.check_specimen(specimen(bad))
    assert {v.rule for v in fired} == {rule}, fired
    assert ttc.check_specimen(specimen(clean)) == []


def test_f64_outside_the_sites_fires_inside_them_not():
    """The one-rounding sites are named by function: the optimizer's f64
    update passes, the same ops in a toy body fire."""
    from repro_torch.optim import adamw, apply_updates

    opt = adamw(1e-3)
    params = {"w": torch.ones(3)}

    def step(p, st):
        apply_updates(p, opt.update({"w": torch.full((3,), 0.5)}, st, p))
        return p, {}

    sp = TraceSpecimen("toy/adam", step, (params, opt.init(params)),
                       donate=(0, 1), expect_graph=False)
    assert ttc.check_specimen(sp) == []


def test_trc005_serve_ladder_bound(monkeypatch):
    """A sampler that compiles a program per request size (no ladder)
    breaks the bound; the stream program that rebinds its key breaks its
    in-place contract; the real engine keeps both."""
    from repro_torch.serve import sampler as S
    pair, _ = ttc._tiny_setup()
    assert ttc.check_serve_ladder(pair, "cpu") == []
    with monkeypatch.context() as m:
        m.setattr(S.SamplerEngine, "bucket_for", lambda self, k: k)
        fired = ttc.check_serve_ladder(pair, "cpu")
    assert [(v.rule, v.where) for v in fired] == [
        ("TRC005", "serve/request"), ("TRC005", "serve/score"),
        ("TRC005", "serve/stream")]

    def rebinds(self, st, bucket):
        keys = S.prng.split(st["key"], 2)
        st["key"] = keys[1]
        return self.pair.g_apply(st["g"], S.prng.normal(
            keys[0], (bucket, self.pair.z_dim)))

    with monkeypatch.context() as m:
        m.setattr(S.SamplerEngine, "_stream_rows", rebinds)
        fired = ttc.check_serve_ladder(pair, "cpu")
    assert [(v.rule, v.where) for v in fired] == [("TRC001", "serve/stream")]


# ---------------------------------------------------------------------------
# the repository itself
# ---------------------------------------------------------------------------

def test_port_tree_is_clean_under_both_passes():
    """Pass 1 on the CPU over every specimen, the SPMD leg in this process
    at world size 1, the serve and decode ladders; Pass 2 over the port's
    tree, ``chip_smoke.py`` and the port's tests."""
    violations, checked = ttc.run_tracecheck(device="cpu", spmd=1)
    assert violations == [], render_report(violations, checked)
    assert checked["trace_programs"] == 54
    assert "spmd (1 gloo rank)" in checked["trace_backends"]
    calls = checked["trace_kernel_calls"]
    assert calls["approach1/fused"]["calls"] == {"topk_mask_rows": 2}
    assert calls["approach1/cohort"]["calls"] == {"topk_mask_rows": 2}
    assert calls["approach1/superbatch_ef [topk_int8+EF]"]["calls"] == {
        "topk_mask_rows": 2, "quantize_rows": 2, "dequantize_rows": 2}
    assert calls["multihost/stage_pack"]["calls"] == {"quantize_rows": 1}
    assert min(checked["spmd_collective_bytes"].values()) > 0
    violations, checked = tlint.run_lint()
    assert violations == [], render_report(violations, checked)
    assert checked["lint_files"] > 100


def test_cli_lint_pass_exits_clean(capsys):
    from repro_torch.analysis.__main__ import main
    assert main(["--skip-trace", "--json"]) == 0
    assert '"ok": true' in capsys.readouterr().out
