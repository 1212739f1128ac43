"""The dry run (``repro_torch.launch.dryrun``) on fake meshes, held to the
reference's plan and to its own identities, at reduced size on the CPU.

The fake process group takes a process of its own, so two subprocesses
(started together, once for the module) run every count; this process
only compares.  What must hold:

* ``pair_plan`` (and ``LONG_OK``, ``LONG_WINDOWED``, ``ARCH_IDS_PUBLIC``,
  ``_layer_points``) equal the reference's for every pair / config;
* the 1 x 1 meta count's FLOPs equal ``roofline.cost_analysis`` of the
  real CPU step exactly (tinyllama-1.1b reduced, B 8 x 32);
* under ``dp_only`` on a fake 2 x 2 mesh, the per-device FLOPs times 4
  equal the 1 x 1 FLOPs exactly, and the all-reduces carry exactly twice
  the gradients' bytes (one f32 all-reduce a gradient over the flattened
  (data, model) group, ring factor 2), with no other collective.  The
  loss and its metrics are scalars that stay pending (``Partial``) until
  read: reading one costs a 4-byte all-reduce outside the step, so the
  step itself reduces no scalar;
* the 2-point extrapolation equals the direct count at full depth (six
  layers) in FLOPs and collective bytes; its bytes fall short, by the
  stacked weights' gradient accumulation, which grows with depth squared;
* ``cfg.seq_shard`` lowers the all-reduce bytes: the residual stream's
  pending sums arrive as reduce-scatters of its sequence-sharded block,
  which the next norm's input all-gathers;
* one reduced config of each family (dense, ssm, moe, mla, hybrid, audio,
  vlm) dry-runs ``ok`` on a fake 2 x 2 mesh: its train step, prefill and
  decode step.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.data.synthetic import TokenStream
from repro_torch.launch import dryrun
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as M
from repro_torch.models.common import tree_leaves
from repro_torch.roofline import cost_analysis

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
B, S = 8, 32
FAMILIES = {"dense": "tinyllama-1.1b", "ssm": "mamba2-780m",
            "moe": "deepseek-moe-16b", "mla": "deepseek-v2-lite-16b",
            "hybrid": "recurrentgemma-9b", "audio": "seamless-m4t-medium",
            "vlm": "chameleon-34b"}

_IDENTITIES = """
import dataclasses, json, sys
import repro.launch.dryrun as J
from repro.configs.base import get_config as jget_config
from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.launch import dryrun as D
from repro_torch.sharding import NAMED_RULES, MeshShape

out = {"ref": {"LONG_OK": sorted(J.LONG_OK),
               "LONG_WINDOWED": J.LONG_WINDOWED,
               "ARCH_IDS_PUBLIC": J.ARCH_IDS_PUBLIC,
               "plans": {f"{a}|{s}": J.pair_plan(a, s)
                         for a in J.ARCH_IDS_PUBLIC
                         for s in ("train_4k", "prefill_32k", "decode_32k",
                                   "long_500k")},
               "layer_points": {a: list(J._layer_points(jget_config(a)))
                                for a in J.ARCH_IDS_PUBLIC}},
       "port": {"LONG_OK": sorted(D.LONG_OK),
                "LONG_WINDOWED": D.LONG_WINDOWED,
                "ARCH_IDS_PUBLIC": D.ARCH_IDS_PUBLIC,
                "plans": {f"{a}|{s}": D.pair_plan(a, s)
                          for a in D.ARCH_IDS_PUBLIC
                          for s in ("train_4k", "prefill_32k", "decode_32k",
                                    "long_500k")},
                "layer_points": {a: list(D._layer_points(get_config(a)))
                                 for a in D.ARCH_IDS_PUBLIC}}}
B, S = int(sys.argv[2]), int(sys.argv[3])
cfg = get_config("tinyllama-1.1b").reduced()
shp = ShapeConfig("train_small", S, B, "train")
m11 = MeshShape(("data", "model"), (1, 1))
m22 = MeshShape(("data", "model"), (2, 2))

def count(c, mesh, rules="default"):
    r = D.count_step(c, shp, mesh, NAMED_RULES[rules])
    return {"flops": r.flops, "bytes": r.bytes, "records": r.collectives,
            "memory": r.memory_analysis()}

out["c11"] = count(cfg, m11)
out["dp22"] = count(cfg, m22, "dp_only")
out["tp22"] = count(cfg, m22)
out["sp22"] = count(dataclasses.replace(cfg, seq_shard=True), m22)
deep = {"num_layers": 6}
out["direct"] = D.run_one("tinyllama-1.1b", shp, mesh=m22, reduced=True,
                          overrides=deep, save=False)
out["extrap"] = D.run_one_extrapolated("tinyllama-1.1b", shp, mesh=m22,
                                       reduced=True, overrides=deep,
                                       save=False)
out["saved"] = D.run_one("tinyllama-1.1b", shp, mesh=m11, reduced=True,
                         save=True, out_dir=sys.argv[4], tag="t")
with open(sys.argv[1], "w") as f:
    json.dump(out, f, default=str)
"""

_FAMILIES = """
import json, sys
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D
from repro_torch.sharding import MeshShape

B, S = int(sys.argv[2]), int(sys.argv[3])
m22 = MeshShape(("data", "model"), (2, 2))
out = {}
for arch in sys.argv[4:]:
    for kind in ("train", "prefill", "decode"):
        rec = D.run_one(arch, ShapeConfig(kind, S, B, kind), mesh=m22,
                        reduced=True, save=False)
        out[f"{arch}|{kind}"] = {k: rec.get(k) for k in (
            "status", "error", "traceback", "hlo_flops", "chips")}
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    archs = list(FAMILIES.values())
    jobs = {"identities": (_IDENTITIES, [str(tmp / "out")]),
            "families_a": (_FAMILIES, archs[:4]),
            "families_b": (_FAMILIES, archs[4:])}
    procs = {}
    for name, (code, rest) in jobs.items():
        dst = str(tmp / f"{name}.json")
        argv = [sys.executable, "-c", textwrap.dedent(code), dst, str(B),
                str(S)] + rest
        procs[name] = (subprocess.Popen(argv, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True,
                                        env=env), dst)
    out = {}
    try:
        for name, (proc, dst) in procs.items():
            log, _ = proc.communicate(timeout=600)
            assert proc.returncode == 0, log[-4000:]
            with open(dst) as f:
                out[name] = json.load(f)
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out["families"] = {**out.pop("families_a"), **out.pop("families_b")}
    out["out_dir"] = tmp / "out"
    return out


def test_plan_matches_reference(runs):
    ids = runs["identities"]
    assert ids["port"] == ids["ref"]


def test_one_by_one_flops_equal_cost_analysis_of_the_real_step(runs):
    cfg = get_config("tinyllama-1.1b").reduced()
    params = M.init_params(cfg, 0, device="cpu")
    step, opt = make_train_step(cfg)
    state = opt.init(params)
    batch = TokenStream(cfg.vocab_size, S, B, seed=0).batch(0)
    real = cost_analysis(lambda: step(params, state, batch))
    c11 = runs["identities"]["c11"]
    assert c11["flops"] == real["flops"] > 0
    assert c11["records"] == []
    # the bytes differ only by the lookup (F.embedding on a mesh, indexing
    # on one device) and the CPU's elementwise formulas (the meta run
    # counts the card's)
    assert 0.5 < c11["bytes"] / real["bytes accessed"] < 1.5
    n = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    mem = c11["memory"]
    # f32 weights and their two f32 moments, the int32 step counter, the
    # int32 tokens and targets
    assert mem["argument_size_in_bytes"] == 3 * n + 4 + 2 * B * S * 4
    assert mem["alias_size_in_bytes"] == 0 and mem["temp_size_in_bytes"] > 0


def test_dp_only_divides_the_flops_and_reduces_each_gradient_once(runs):
    ids = runs["identities"]
    c11, dp = ids["c11"], ids["dp22"]
    assert dp["flops"] * 4 == c11["flops"]
    cfg = get_config("tinyllama-1.1b").reduced()
    grad_bytes = sum(t.numel() * 4 for t in
                     tree_leaves(M.param_shapes(cfg)))
    kinds = {k for k, _, _ in dp["records"]}
    assert kinds == {"all-reduce"}
    ar = sum(2 * 4 * _numel(shape) for k, shape, dt in dp["records"]
             if k == "all-reduce" and dt == "f32")
    # no scalar in the step: the loss metrics stay pending until read
    scalars = [r for r in dp["records"] if _numel(r[1]) == 1]
    assert scalars == []
    assert ar == 2 * grad_bytes
    assert len(dp["records"]) == len(tree_leaves(M.param_shapes(cfg)))


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def test_extrapolation_equals_the_direct_count(runs):
    ids = runs["identities"]
    direct, extrap = ids["direct"], ids["extrap"]
    assert direct["status"] == extrap["status"] == "ok"
    assert extrap["extrapolation"]["L_true"] == 6
    assert extrap["hlo_flops"] == direct["hlo_flops"]
    assert extrap["collective_bytes"] == pytest.approx(
        direct["collective_bytes"], rel=1e-9)
    # the bytes carry a term quadratic in depth, which the linear fit
    # leaves out: each layer's slice of a stacked weight has a backward
    # that writes a whole stacked gradient
    assert extrap["hlo_bytes"] < direct["hlo_bytes"]


def test_seq_shard_turns_the_stream_all_reduces_into_reduce_scatters(runs):
    ids = runs["identities"]
    tp, sp = ids["tp22"], ids["sp22"]
    bytes_of = lambda run, kind: sum(_numel(s) for k, s, _ in run["records"]
                                     if k == kind)
    assert bytes_of(sp, "all-reduce") < bytes_of(tp, "all-reduce")
    cfg = get_config("tinyllama-1.1b").reduced()
    block = [B // 2, S // 2, cfg.d_model]      # (data 2, model 2)
    stream = lambda run, kind: [r for r in run["records"]
                                if r[0] == kind and list(r[1]) == block]
    assert not stream(tp, "reduce-scatter")
    assert len(stream(sp, "reduce-scatter")) >= 2 * cfg.num_layers
    gathered = [r for r in sp["records"] if r[0] == "all-gather"
                and list(r[1]) == [B, S // 2, cfg.d_model]]
    assert gathered


def test_records_keep_the_reference_keys_and_go_to_out(runs):
    rec = runs["identities"]["saved"]
    path = runs["out_dir"] / "tinyllama-1.1b__train_small__1x1__t.json"
    assert json.loads(path.read_text())["status"] == rec["status"] == "ok"
    ref_keys = {"arch", "shape", "mesh", "plan", "tag", "unroll", "chips",
                "hlo_flops", "hlo_bytes", "collective_bytes", "model_flops",
                "compute_s", "memory_s", "collective_s", "bytes_per_device",
                "dominant", "useful_flops_ratio", "status",
                "memory_analysis", "collectives", "lower_s", "compile_s"}
    assert ref_keys <= set(rec)
    assert set(rec["memory_analysis"]) == {
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "alias_size_in_bytes"}
    assert os.path.basename(os.path.normpath(dryrun.ART_DIR)) == \
        "dryrun_torch"


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_every_family_dry_runs_on_a_fake_2x2_mesh(runs, family, kind):
    rec = runs["families"][f"{FAMILIES[family]}|{kind}"]
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["chips"] == 4 and rec["hlo_flops"] > 0


def test_cli_needs_a_pair():
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "tinyllama-1.1b"])


def test_pair_plan_skips_quadratic_attention_at_524k():
    rec = dryrun.run_one("tinyllama-1.1b", "long_500k", save=False)
    assert rec["plan"] == "skip" and rec["status"].startswith("skipped")
    assert torch.distributed.is_available()
