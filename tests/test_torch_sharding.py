"""The port's sharding rules and spec derivation (``repro_torch.sharding``,
the spec half of ``repro_torch.launch.steps``) held to the reference's.

The reference derives every spec from a mesh's axis names and sizes alone
(``sharding/rules.py:121-122``, ``launch/steps.py:77``), so a
``SimpleNamespace(axis_names=..., devices=np.empty(shape))`` stands in for
its mesh and no 256 or 512 host devices are needed; the port takes a
``MeshShape``.  Every parameter, cache and batch leaf of all 10 shipped
configs at full width, on the meshes (1, 1), (2, 2), (16, 16) and
(2, 16, 16), under the three rule sets, and ``zero1_specs``, must equal
the reference's.  ``logical_to_spec`` is also held to the reference's on
random dims and meshes (hypothesis), and ``local_shape`` to what DTensor
holds on a fake mesh (a subprocess: the fake process group takes a
process of its own).
"""

import json
import os
import subprocess
import sys
import textwrap
import types

import jax
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import PartitionSpec

from repro.configs.base import INPUT_SHAPES as J_SHAPES
from repro.configs.base import get_config as jget_config
from repro.launch import steps as JS
from repro.sharding import rules as JR
from repro_torch.configs.base import INPUT_SHAPES, get_config
from repro_torch.launch import steps as TS
from repro_torch.models import model as TM
from repro_torch.models.common import tree_leaves
from repro_torch.sharding import (NAMED_RULES, MeshShape, local_shape,
                                  logical_to_spec, spec_to_placements)

ARCHS = ["mamba2-780m", "seamless-m4t-medium", "recurrentgemma-9b",
         "deepseek-moe-16b", "stablelm-1.6b", "tinyllama-1.1b", "yi-34b",
         "qwen2-72b", "chameleon-34b", "deepseek-v2-lite-16b"]
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _meshes(name):
    shape, names = MESHES[name]
    return (types.SimpleNamespace(axis_names=names, devices=np.empty(shape)),
            MeshShape(names, shape))


def _ref_leaves(tree) -> list:
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))]


def _ref_dict(specs) -> dict:
    return {k: tuple(v) for k, v in specs.items()}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_reference(arch, mesh):
    jmesh, tmesh = _meshes(mesh)
    jcfg, cfg = jget_config(arch), get_config(arch)
    jshapes = JS.M.param_shapes(jcfg)
    tshapes = TM.param_shapes(cfg)
    assert [tuple(s.shape) for s in jax.tree.leaves(jshapes)] == \
        [tuple(t.shape) for t in tree_leaves(tshapes)]
    assert all(t.device.type == "meta" for t in tree_leaves(tshapes))
    for name in ("default", "dp_only", "fsdp"):
        jrules, rules = JR.NAMED_RULES[name], NAMED_RULES[name]
        jp = JS.param_pspecs(jcfg, jmesh, jrules)
        tp = TS.param_pspecs(cfg, tmesh, rules)
        assert _ref_leaves(jp) == tree_leaves(tp), (arch, mesh, name)
        assert _ref_leaves(JS.zero1_specs(jshapes, jp, jmesh)) == \
            tree_leaves(TS.zero1_specs(tshapes, tp, tmesh)), (arch, name)
        for sname in ("train_4k", "prefill_32k"):
            _, jb = JS.batch_specs(jcfg, jmesh, J_SHAPES[sname], jrules)
            structs, tb = TS.batch_specs(cfg, tmesh, INPUT_SHAPES[sname],
                                         rules)
            assert _ref_dict(jb) == tb, (arch, mesh, name, sname)
            assert sorted(structs) == sorted(tb)
        for sname in ("decode_32k", "long_500k"):
            shp = J_SHAPES[sname]
            jc = JS.cache_pspecs(jcfg, jmesh, shp.global_batch,
                                 JS.serve_max_len(jcfg, shp), jrules)
            tc = TS.cache_pspecs(cfg, tmesh, shp.global_batch,
                                 TS.serve_max_len(cfg, shp), rules)
            assert _ref_leaves(jc) == tree_leaves(tc), (arch, mesh, sname)


@pytest.mark.parametrize("arch", ARCHS)
def test_logical_axes_match_reference(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    is_axes = lambda x: isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)
    assert jax.tree.leaves(JS.M.param_logical_axes(jcfg),
                           is_leaf=is_axes) == \
        tree_leaves(TM.param_logical_axes(cfg))
    assert jax.tree.leaves(JS.cache_logical_axes(jcfg), is_leaf=is_axes) == \
        tree_leaves(TS.cache_logical_axes(cfg))


_LOGICAL = sorted(set(JR.DEFAULT_RULES.rules) | set(JR.FSDP_RULES.rules)
                  | set(JR.DP_ONLY_RULES.rules)) + [None]
_AXES = ("pod", "data", "model")


@settings(max_examples=300, deadline=None)
@given(data=st.data())
def test_logical_to_spec_matches_reference_on_random_dims(data):
    n_axes = data.draw(st.integers(1, 3))
    names = tuple(data.draw(st.permutations(_AXES))[:n_axes])
    sizes = tuple(data.draw(st.sampled_from([1, 2, 3, 4, 8, 16]))
                  for _ in names)
    ndim = data.draw(st.integers(1, 5))
    logical = [data.draw(st.sampled_from(_LOGICAL)) for _ in range(ndim)]
    dims = [data.draw(st.sampled_from([1, 2, 3, 6, 8, 12, 16, 48, 56,
                                       256, 50280])) for _ in range(ndim)]
    rules_name = data.draw(st.sampled_from(sorted(NAMED_RULES)))
    jmesh = types.SimpleNamespace(axis_names=names,
                                  devices=np.empty(sizes))
    want = JR.logical_to_spec(logical, dims, jmesh,
                              JR.NAMED_RULES[rules_name])
    got = logical_to_spec(logical, dims, MeshShape(names, sizes),
                          NAMED_RULES[rules_name])
    assert got == tuple(want)


def test_placements_and_local_shapes():
    from torch.distributed.tensor import Replicate, Shard

    mesh = MeshShape(("pod", "data", "model"), (2, 4, 8))
    assert spec_to_placements((("pod", "data"), None, "model"), mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert spec_to_placements((None,), mesh) == (Replicate(),) * 3
    assert local_shape((64, 3, 16), (("pod", "data"), None, "model"),
                       mesh) == (8, 3, 2)
    with pytest.raises(AssertionError, match="out of mesh order"):
        spec_to_placements((("model", "data"),), mesh)
    with pytest.raises(ValueError, match="does not divide"):
        local_shape((6,), ("data",), mesh)


_LOCAL_SHAPES = """
import json, sys
from repro_torch.configs.base import get_config
from repro_torch.launch.mesh import fake_mesh
from repro_torch.launch.steps import distribute, param_pspecs
from repro_torch.models import model as M
from repro_torch.models.common import tree_leaves
from repro_torch.sharding import NAMED_RULES, local_shape
out = []
for shape, names in (((16, 16), ("data", "model")),
                     ((2, 16, 16), ("pod", "data", "model"))):
    mesh = fake_mesh(shape, names)
    for arch in sys.argv[2:]:
        cfg = get_config(arch)
        for rules in ("default", "fsdp"):
            specs = param_pspecs(cfg, mesh, NAMED_RULES[rules])
            params = distribute(M.param_shapes(cfg), specs, mesh)
            for t, s in zip(tree_leaves(params), tree_leaves(specs)):
                out.append([list(t.to_local().shape),
                            list(local_shape(t.shape, s, mesh)),
                            t.to_local().device.type])
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
"""


def test_local_shape_is_dtensors_on_a_fake_mesh(tmp_path):
    """``local_shape`` of every parameter of four configs at full width
    (meta tensors: nothing allocated) equals ``DTensor.to_local()``'s on
    the fake 16 x 16 and 2 x 16 x 16 meshes."""
    out = tmp_path / "shapes.json"
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_LOCAL_SHAPES), str(out),
         "tinyllama-1.1b", "yi-34b", "mamba2-780m", "deepseek-v2-lite-16b"],
        capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    rows = json.loads(out.read_text())
    assert len(rows) > 100
    for got, want, dev in rows:
        assert got == want and dev == "meta"
