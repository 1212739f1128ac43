"""Dry run on a fake production mesh (port of the reference's
``launch/dryrun.py``): every (architecture x input shape) sharded over
the 256- or 512-rank mesh, and its roofline terms read off one rank's
share of the step.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # 16x16 sweep
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod

No card is needed.  Where the reference lowers and compiles the step, the
port runs ``launch.steps.input_specs(...).fn`` once, on DTensors whose
blocks are ``meta`` tensors (nothing is allocated or computed), over
``launch.mesh.make_production_mesh``'s fake process group, in which this
process is rank 0 and no collective moves data.  What rank 0 runs is
what the reference's per-device ``cost_analysis`` reports, and
:class:`LocalCount` counts it:

* a ``TorchDispatchMode`` above DTensor sees each compute op at its
  GLOBAL shapes (a ``(Shard(0), Shard(1))`` matmul of ``[64,2048] @
  [2048,5632]`` on a 16 x 16 mesh, 1.48e9 FLOP, where rank 0 multiplies
  ``[4,2048] @ [2048,352]``).  So the mode hands every DTensor op on to
  DTensor (``NotImplemented``) and counts the LOCAL ops that DTensor's
  sharding propagation then runs on rank 0's blocks, the collectives it
  issues included: FLOPs by ``torch.utils.flop_counter``'s formulas, the
  ones ``roofline.cost_analysis`` uses; bytes as every non-view op's
  operands plus outputs, unfused (collectives are priced apart);
* the collectives (``_c10d_functional`` all_reduce, all_gather_into_tensor,
  reduce_scatter_tensor, all_to_all_single, and DTensor's
  shard_dim_alltoall), as the reference's kinds (all-reduce, all-gather,
  reduce-scatter, all-to-all) and result shapes, priced by
  ``roofline.collective_bytes``;
* memory, in the reference's four keys: arguments and outputs the exact
  local bytes of the step's inputs and of what it returns (the train
  step updates in place, but its outputs are counted as the reference
  counts its undonated ones), temporaries the peak of the live bytes of
  every storage the run creates (tracked until its last tensor dies),
  aliases 0.

The record keeps the reference's keys: ``roofline_terms(...).to_dict()``,
``status``, ``memory_analysis``, ``collectives``, ``lower_s`` (0: there
is no lowering) and ``compile_s``, here the seconds of the meta run.  A
failure is recorded, as in the reference.  Records go to
``experiments/dryrun_torch/`` (git ignores it), or to ``--out``; the
reference's ``experiments/dryrun/`` is never written.

The port's layer stacks are Python loops, so every layer is counted
(``--unroll`` changes nothing; the reference costs a scanned body once);
``--extrapolate`` fits two depths (``run_one_extrapolated``).  On H100s
a 16-wide model axis spans two 8-GPU NVLink domains, so the collective
term at ``roofline.NVLINK_BW`` is a lower bound.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.base import INPUT_SHAPES, ShapeConfig, get_config
from repro_torch.launch.steps import distribute, input_specs
from repro_torch.roofline.analysis import (_is_view, collective_bytes,
                                           model_flops, roofline_terms)
from repro_torch.sharding.rules import (DEFAULT_RULES, NAMED_RULES,
                                        MeshShape, spec_to_placements)

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

# long_500k needs sub-quadratic attention: it runs for the SSM and hybrid
# families natively and for yi-34b under a sliding-window variant; the
# other full-attention archs skip it (recorded).
LONG_OK = {"mamba2-780m", "recurrentgemma-9b"}
LONG_WINDOWED = {"yi-34b": 8192}

ARCH_IDS_PUBLIC = [
    "mamba2-780m", "seamless-m4t-medium", "recurrentgemma-9b",
    "deepseek-moe-16b", "stablelm-1.6b", "tinyllama-1.1b", "yi-34b",
    "qwen2-72b", "chameleon-34b", "deepseek-v2-lite-16b",
]

# local op name -> the reference's collective kind
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-broadcast", "broadcast_": "collective-broadcast",
}
_HLO_DTYPE = {torch.float32: "f32", torch.bfloat16: "bf16",
              torch.float16: "f16", torch.float64: "f64",
              torch.int32: "s32", torch.int64: "s64", torch.int16: "s16",
              torch.int8: "s8", torch.uint8: "u8", torch.bool: "pred"}
_PLAIN = (torch.Tensor, torch.nn.Parameter)


def pair_plan(arch: str, shape: str) -> str:
    """'run' | 'run-windowed' | 'skip'."""
    if shape != "long_500k":
        return "run"
    if arch in LONG_OK:
        return "run"
    if arch in LONG_WINDOWED:
        return "run-windowed"
    return "skip"


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


class LocalCount(TorchDispatchMode):
    """Rank 0's local work below DTensor (the module docstring): FLOPs,
    unfused bytes, collective records ``(kind, shape, dtype)`` and the
    peak of live bytes of the storages created while it is active
    (the storages of ``args``, the step's inputs, are not counted)."""

    def __init__(self, args=()):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives: list = []
        self.live = 0
        self.peak = 0
        self._storages: dict = {}   # storage id -> [bytes, live tensors]
        self._inputs = {self._key(_local(t)) for t in _tensors(args)}

    @staticmethod
    def _key(t) -> int:
        return t.untyped_storage()._cdata

    def _release(self, key: int) -> None:
        entry = self._storages[key]
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._storages[key]

    def _track(self, out) -> None:
        for t in _tensors(out):
            if type(t) not in _PLAIN:
                continue
            key = self._key(t)
            if key in self._inputs:
                continue
            entry = self._storages.get(key)
            if entry is None:
                nb = t.untyped_storage().nbytes()
                entry = self._storages[key] = [nb, 0]
                self.live += nb
                self.peak = max(self.peak, self.live)
            entry[1] += 1
            weakref.finalize(t, self._release, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t.__name__ == "FakeTensor" for t in types):
            # DTensor's own shape propagation: not rank 0's work
            with _disable_current_modes():
                return func(*args, **kwargs)
        if any(t not in _PLAIN for t in types):
            return NotImplemented       # a DTensor op: count its local ops
        out = func(*args, **kwargs)
        if any(type(t).__name__ == "FakeTensor" for t in _tensors(out)):
            return out      # a factory call of the shape propagation
        name = func._overloadpacket.__name__
        if func.namespace in ("_c10d_functional", "_dtensor"):
            kind = _COLLECTIVES.get(name)
            if kind is not None:
                t = _tensors(out)[0]
                self.collectives.append((kind, tuple(t.shape),
                                         _HLO_DTYPE[t.dtype]))
        elif not _is_view(func):
            packet = func._overloadpacket
            if packet in flop_registry:
                self.flops += int(flop_registry[packet](
                    *args, **kwargs, out_val=out))
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        self._track(out)
        return out


@dataclasses.dataclass
class Count:
    """One counted run: ``LocalCount``'s totals, memory and seconds."""

    flops: float
    bytes: float
    collectives: list
    argument_bytes: int
    output_bytes: int
    temp_bytes: int
    seconds: float

    def memory_analysis(self) -> dict:
        return {"argument_size_in_bytes": self.argument_bytes,
                "output_size_in_bytes": self.output_bytes,
                "temp_size_in_bytes": self.temp_bytes,
                "alias_size_in_bytes": 0}

    @property
    def bytes_per_device(self) -> float:
        return float(self.argument_bytes + self.output_bytes
                     + self.temp_bytes)


def _mesh_for(mesh):
    """A ``DeviceMesh``: ``mesh`` itself, a fake one of a ``MeshShape``."""
    if isinstance(mesh, MeshShape):
        from repro_torch.launch.mesh import fake_mesh
        return fake_mesh(mesh.sizes, mesh.names)
    return mesh


def count_step(cfg, shp: ShapeConfig, mesh, rules=DEFAULT_RULES) -> Count:
    """Run ``input_specs(cfg, shp, mesh, rules).fn`` once on meta DTensors
    on ``mesh`` (a ``DeviceMesh`` or a ``MeshShape`` to fake) and count
    rank 0's share."""
    from torch.distributed.tensor.experimental import implicit_replication

    mesh = _mesh_for(mesh)
    bundle = input_specs(cfg, shp, mesh, rules)
    args = tuple(distribute(a, s, mesh)
                 for a, s in zip(bundle.args, bundle.in_shardings))
    counter = LocalCount(args)
    t0 = time.perf_counter()
    with implicit_replication(), counter:
        out = bundle.fn(*args)
        if bundle.out_shardings is not None:
            out = out.redistribute(
                mesh, spec_to_placements(bundle.out_shardings, mesh))
        out_bytes = _nbytes([_local(t) for t in _tensors(out)])
    seconds = time.perf_counter() - t0
    return Count(flops=float(counter.flops), bytes=float(counter.bytes),
                 collectives=counter.collectives,
                 argument_bytes=_nbytes([_local(t) for t in _tensors(args)]),
                 output_bytes=out_bytes, temp_bytes=counter.peak,
                 seconds=seconds)


def _shape_of(shape) -> ShapeConfig:
    return shape if isinstance(shape, ShapeConfig) else INPUT_SHAPES[shape]


def _config(arch: str, *, reduced: bool = False, remat: str = None,
            overrides: dict = None):
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if remat:
        cfg = dataclasses.replace(cfg, remat=remat)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def _mesh_name(mesh, multi_pod: bool) -> str:
    if mesh is None:
        return "pod2x16x16" if multi_pod else "pod16x16"
    sizes = (mesh.sizes if isinstance(mesh, MeshShape)
             else tuple(mesh.shape))
    return "x".join(str(s) for s in sizes)


def _chips(mesh) -> int:
    n = 1
    for s in (mesh.sizes if isinstance(mesh, MeshShape) else mesh.shape):
        n *= int(s)
    return n


def _fail(rec: dict, e: Exception) -> None:
    rec["status"] = "FAIL"
    rec["error"] = f"{type(e).__name__}: {e}"
    rec["traceback"] = traceback.format_exc()[-2000:]


def run_one(arch: str, shape, *, multi_pod: bool = False, rules=None,
            remat: str = None, save: bool = True, tag: str = "",
            unroll: bool = False, mesh=None, reduced: bool = False,
            overrides: dict = None, out_dir: str = None) -> dict:
    """Count one (arch x shape) on the production mesh, or on ``mesh`` (a
    ``MeshShape``, for small runs), and record its roofline terms.
    ``shape`` is an ``INPUT_SHAPES`` name or a ``ShapeConfig``."""
    shp = _shape_of(shape)
    plan = pair_plan(arch, shp.name)
    mesh_name = _mesh_name(mesh, multi_pod)
    rec = {"arch": arch, "shape": shp.name, "mesh": mesh_name, "plan": plan,
           "tag": tag, "unroll": unroll, "rules": _rules_name(rules)}
    if reduced:
        rec["reduced"] = True
    if overrides:
        rec["overrides"] = dict(overrides)
    if plan == "skip":
        rec["status"] = "skipped (quadratic attention at 524k)"
        return _finish(rec, save, out_dir)
    cfg = _config(arch, reduced=reduced, remat=remat, overrides=overrides)
    if plan == "run-windowed":
        cfg = dataclasses.replace(cfg, window=LONG_WINDOWED[arch])
        rec["variant"] = f"sliding_window={cfg.window}"
    rules = rules or DEFAULT_RULES
    try:
        if mesh is None:
            from repro_torch.launch.mesh import make_production_mesh
            mesh = make_production_mesh(multi_pod=multi_pod)
        c = count_step(cfg, shp, mesh, rules)
        rep = roofline_terms(
            arch=arch, shape=shp.name, mesh_name=mesh_name,
            chips=_chips(mesh),
            cost={"flops": c.flops, "bytes accessed": c.bytes},
            collective=collective_bytes(c.collectives),
            model_fl=model_flops(cfg, shp),
            bytes_per_device=c.bytes_per_device)
        rec.update(rep.to_dict())
        rec["status"] = "ok"
        rec["memory_analysis"] = c.memory_analysis()
        rec["collectives"] = collective_bytes(c.collectives)
        rec["collective_ops"] = _op_counts(c.collectives)
        rec["lower_s"] = 0.0
        rec["compile_s"] = round(c.seconds, 1)
    except Exception as e:  # noqa: BLE001 -- a failure is the result here
        _fail(rec, e)
    return _finish(rec, save, out_dir)


def _op_counts(records) -> dict:
    out: dict = {}
    for kind, _, _ in records:
        out[kind] = out.get(kind, 0) + 1
    return out


def _rules_name(rules) -> str:
    for name, r in NAMED_RULES.items():
        if r is rules or (rules is None and name == "default"):
            return name
    return "custom"


def _layer_points(cfg):
    """Two depths (L1, L2) that keep the arch's layer pattern, for the
    linear-in-depth extrapolation."""
    if cfg.arch_type == "hybrid":
        period = len(cfg.block_pattern)
        tail = cfg.num_layers - (cfg.num_layers // period) * period
        return (period + tail, 2 * period + tail)
    if cfg.arch_type == "moe" and cfg.first_dense_layers:
        nd = cfg.first_dense_layers
        return (nd + 2, nd + 4)
    return (2, 4)


def run_one_extrapolated(arch: str, shape, *, rules=None, remat: str = None,
                         save: bool = True, tag: str = "roofline",
                         overrides: dict = None, mesh=None,
                         reduced: bool = False, out_dir: str = None) -> dict:
    """The roofline terms from two shallow counts: FLOPs and collectives
    are linear in the layer count, so the counts at depths L1 and L2 give
    slope and intercept, evaluated at the true depth.  The bytes and the
    temporaries are extrapolated the same way, which leaves out a term
    quadratic in depth: the backward of each layer's slice of a stacked
    weight writes a whole stacked gradient, and autograd sums them."""
    shp = _shape_of(shape)
    plan = pair_plan(arch, shp.name)
    mesh_name = _mesh_name(mesh, False)
    rec = {"arch": arch, "shape": shp.name, "mesh": mesh_name, "plan": plan,
           "tag": tag, "method": "2-point-linear-extrapolation",
           "rules": _rules_name(rules)}
    if plan == "skip":
        rec["status"] = "skipped (quadratic attention at 524k)"
        return _finish(rec, save, out_dir)
    cfg0 = _config(arch, reduced=reduced, remat=remat)
    if plan == "run-windowed":
        cfg0 = dataclasses.replace(cfg0, window=LONG_WINDOWED[arch])
        rec["variant"] = f"sliding_window={cfg0.window}"
    if overrides:
        cfg0 = dataclasses.replace(cfg0, **overrides)
        rec["overrides"] = dict(overrides)
    rules = rules or DEFAULT_RULES
    L1, L2 = _layer_points(cfg0)
    L_true = cfg0.num_layers

    def costs_at(L, dm):
        cfg = dataclasses.replace(cfg0, num_layers=L)
        if cfg.arch_type == "audio":
            # the encoder's depth scales with the same multiplier
            enc = max(round(cfg0.num_encoder_layers * L / L_true), 1)
            cfg = dataclasses.replace(cfg, num_encoder_layers=enc)
        c = count_step(cfg, shp, dm, rules)
        coll = collective_bytes(c.collectives)
        return {"flops": c.flops, "bytes": c.bytes, "coll": coll["total"],
                "bytes_per_dev": c.bytes_per_device, "coll_detail": coll,
                "seconds": c.seconds}

    try:
        if mesh is None:
            from repro_torch.launch.mesh import make_production_mesh
            mesh = make_production_mesh(multi_pod=False)
        dm = _mesh_for(mesh)
        c1, c2 = costs_at(L1, dm), costs_at(L2, dm)

        def extrap(key):
            slope = (c2[key] - c1[key]) / (L2 - L1)
            return c1[key] + slope * (L_true - L1)

        rep = roofline_terms(
            arch=arch, shape=shp.name, mesh_name=mesh_name,
            chips=_chips(dm),
            cost={"flops": extrap("flops"), "bytes accessed": extrap("bytes")},
            collective={"total": extrap("coll")},
            model_fl=model_flops(cfg0, shp),
            bytes_per_device=extrap("bytes_per_dev"))
        rec.update(rep.to_dict())
        rec["status"] = "ok"
        rec["extrapolation"] = {
            "L1": L1, "L2": L2, "L_true": L_true,
            "c1": {k: v for k, v in c1.items() if k != "coll_detail"},
            "c2": {k: v for k, v in c2.items() if k != "coll_detail"}}
        rec["collectives_at_L2"] = c2["coll_detail"]
        rec["compile_s"] = round(c1["seconds"] + c2["seconds"], 1)
        rec["lower_s"] = 0.0
    except Exception as e:  # noqa: BLE001 -- a failure is the result here
        _fail(rec, e)
    return _finish(rec, save, out_dir)


def _finish(rec: dict, save: bool, out_dir: str = None) -> dict:
    if save:
        d = out_dir or ART_DIR
        os.makedirs(d, exist_ok=True)
        suffix = f"__{rec['tag']}" if rec.get("tag") else ""
        path = os.path.join(
            d, f"{rec['arch']}__{rec['shape']}__{rec['mesh']}{suffix}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1, default=str)
    status = rec["status"]
    extra = ""
    if status == "ok":
        extra = (f" dom={rec['dominant']} comp={rec['compute_s']:.3e}s"
                 f" mem={rec['memory_s']:.3e}s coll={rec['collective_s']:.3e}s"
                 f" useful={rec['useful_flops_ratio']:.2f}"
                 f" (lower {rec['lower_s']}s compile {rec['compile_s']}s)")
    elif status == "FAIL":
        extra = " " + rec["error"][:200]
    print(f"[dryrun] {rec['arch']} x {rec['shape']} @ {rec['mesh']}: "
          f"{status}{extra}", flush=True)
    return rec


def _parse_overrides(pairs) -> dict:
    overrides = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        overrides[k] = v
    return overrides


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--remat", default=None)
    ap.add_argument("--tag", default="")
    ap.add_argument("--unroll", action="store_true",
                    help="accepted for the reference's CLI: the port's "
                         "stacks are loops, every layer is counted")
    ap.add_argument("--extrapolate", action="store_true",
                    help="roofline via a 2-point linear depth fit")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (perf variants)")
    ap.add_argument("--rules", default="default",
                    help="sharding rule set (default | dp_only | fsdp)")
    ap.add_argument("--out", default=None,
                    help="directory for the records (default "
                         "experiments/dryrun_torch/)")
    args = ap.parse_args(argv)

    overrides = _parse_overrides(args.set)
    if args.all:
        archs, shapes = ARCH_IDS_PUBLIC, list(INPUT_SHAPES)
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        archs, shapes = [args.arch], [args.shape]

    rules = NAMED_RULES[args.rules]
    n_fail = 0
    for a in archs:
        for s in shapes:
            if args.extrapolate:
                rec = run_one_extrapolated(
                    a, s, remat=args.remat, tag=args.tag or "roofline",
                    overrides=overrides or None, rules=rules,
                    out_dir=args.out)
            else:
                rec = run_one(a, s, multi_pod=args.multi_pod,
                              remat=args.remat, tag=args.tag,
                              unroll=args.unroll, rules=rules,
                              overrides=overrides or None, out_dir=args.out)
            n_fail += rec["status"] == "FAIL"
    print(f"[dryrun] done, {n_fail} failures")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
