"""Pass 1 — trace contracts (port of the reference's ``analysis/
tracecheck.py``).

The reference lowers each engine program and reads its jaxpr and
StableHLO.  The port's engines are eager torch on the CPU and CUDA graphs
on the card, so each contract is checked on a run instead: every
specimen of the ``trace_specimens`` hooks (``core/engine.py``,
``core/spmd.py``, ``multihost/backend.py``) is called twice on the device
its carry lives on, under a ``TorchDispatchMode`` census of every aten op
it runs (``_Census``), and the serve and decode ladders are driven over
every bucket:

* **TRC001 in place** — after a call, every tensor at a donated argument
  position keeps its storage (``data_ptr()``: updated in place, never
  rebound to a copy), and a donated carry comes back as the carry the
  engine bound; a specimen whose ``donate`` is empty (the engine works on
  a copy) leaves its arguments bitwise unchanged, generators included.
  The sampler's stream program updates its key buffer in place.
* **TRC002 no host sync inside a round** — the census records every host
  read of a tensor (``aten._local_scalar_dense``, ``is_nonzero``,
  ``nonzero``, ``masked_select``) and every blocking device-to-host copy,
  with its call site.  On the card the call also runs under
  ``torch.cuda.set_sync_debug_mode("warn")`` with Python warnings
  recorded, so every synchronizing CUDA call is reported with its site;
  ``torch.cuda.graph``'s own set-up (it synchronizes the device before it
  captures, once per chunk length) is outside a round and counted apart.
  A sync inside a capture makes the capture fail, which is reported too.
  ``SYNC_SITES`` names the one host read a round makes on purpose.
* **TRC003 dtype discipline** — no f64 or complex128 tensor in the
  arguments or the results, and inside the call an f64 result only at
  the port's one-rounding sites (``F64_SITES``, each with its reason).
* **TRC004 program shape** — the kernel launches of a call are
  ``rounds`` times the round's (``kernels.ops`` counts on the card, where
  no call may go to a plain version; the plain-version calls on the CPU);
  on the card a graph engine holds one CUDA graph for the chunk length
  and runs one ``replay()`` a call.
* **TRC005 program-count bounds** — the sampler compiles at most
  ``len(buckets)`` programs per family and the decode engine at most
  ``len(buckets) + 1`` in all, driven over every request size / prefill
  bucket.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import tempfile
import time
import traceback
import warnings

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.analysis import Violation
from repro_torch.kernels import ops as kops

_PORT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SKIP = (os.path.dirname(torch.__file__) + os.sep,
         os.path.dirname(contextlib.__file__) + os.sep)
_BAD_DTYPES = (torch.float64, torch.complex128)
_aten = torch.ops.aten
_GRAPH_SETUP = os.path.join("torch", "cuda", "graphs.py")
_HOST_READS = {_aten._local_scalar_dense, _aten.item, _aten.is_nonzero,
               _aten.nonzero, _aten.masked_select}

# The port's deliberate f64 inside a round, each rounded to f32 once, by
# (file under repro_torch, function): the reason it is there.
F64_SITES = {
    ("optim/optimizers.py", "_lr_scale"):
        "-lr rounded to f32 and held in f64, so that its product with an "
        "f32 direction is exact",
    ("optim/optimizers.py", "_lr_scale.<locals>.<lambda>"):
        "that -lr viewed against a leaf's dims",
    ("optim/optimizers.py", "adamw.<locals>.update.<locals>.upd"):
        "Adam's update, the exact f64 product -lr * direction, which "
        "apply_updates rounds to f32 once (the reference's fused "
        "multiply-add)",
    ("optim/optimizers.py", "sgd.<locals>.update.<locals>.vel"):
        "momentum SGD's update, the same exact product",
    ("optim/optimizers.py", "sgd.<locals>.update.<locals>.<lambda>"):
        "SGD's update, the same exact product",
    ("optim/optimizers.py", "_sqrt"):
        "Adam's sqrt on the CPU, taken in f64, whose rounding to f32 is "
        "the correctly rounded root (torch's vectorized f32 sqrt is not)",
    ("prng.py", "fma"):
        "an f32 fused multiply-add, the product exact in f64 (XLA's CPU "
        "fusion)",
}

# The host reads a round makes on purpose, by (file, function).
SYNC_SITES = {
    ("optim/optimizers.py", "_lr_scale"):
        "a float learning rate rounded to f32: .item() of a CPU tensor "
        "built from a Python float, a host constant, never a round value "
        "(no device sync on any device)",
}


def _rel(filename: str) -> str:
    path = os.path.abspath(filename)
    if path.startswith(_PORT + os.sep):
        return os.path.relpath(path, _PORT).replace(os.sep, "/")
    return path


def _site() -> tuple:
    """``(file, line, function)`` of the innermost frame outside torch,
    the standard library and this module: the code that called the op."""
    f = sys._getframe(1)
    while f is not None:
        fn = f.f_code.co_filename
        if fn != __file__ and not fn.startswith(_SKIP):
            return _rel(fn), f.f_lineno, f.f_code.co_qualname
        f = f.f_back
    return "?", 0, "?"


def _show(site: tuple) -> str:
    return f"{site[0]}:{site[1]} ({site[2]})"


def _is_d2h(func, args, kwargs) -> bool:
    """A blocking device-to-host copy (a non-blocking one into pinned
    memory does not wait for the device)."""
    if func is _aten._to_copy.default:
        dst = kwargs.get("device")
        return (args[0].is_cuda and dst is not None
                and torch.device(dst).type == "cpu"
                and not kwargs.get("non_blocking", False))
    if func is _aten.copy_.default:
        blocking = not (args[2] if len(args) > 2
                        else kwargs.get("non_blocking", False))
        return (args[0].device.type == "cpu" and args[1].is_cuda
                and blocking)
    return False


class _Census(TorchDispatchMode):
    """Every aten op of a call: host reads and device-to-host copies
    (TRC002) and f64 / complex128 results (TRC003), with call sites."""

    def __init__(self):
        super().__init__()
        self.host_reads: list = []
        self.f64: list = []
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        if func.overloadpacket in _HOST_READS or _is_d2h(func, args, kwargs):
            self.host_reads.append((str(func), _site()))
        if any(isinstance(t, torch.Tensor) and t.dtype in _BAD_DTYPES
               for t in tree_flatten(out)[0]):
            self.f64.append((str(func), _site()))
        return out


def _outside(stack) -> tuple:
    """The innermost frame of ``stack`` (``traceback.extract_stack()``)
    outside torch, the standard library and this module."""
    for fr in reversed(stack):
        if fr.filename != __file__ and not fr.filename.startswith(_SKIP):
            return _rel(fr.filename), fr.lineno, fr.name
    return "?", 0, "?"


@contextlib.contextmanager
def _sync_watch(cuda: bool):
    """On the card: each synchronizing CUDA call of the block as ``(site,
    setup)``, ``site`` the code that made it and ``setup`` whether
    ``torch.cuda.graph``'s capture set-up made it; filled in as they
    happen (the sync debug mode's warnings, with the stack they are raised
    on)."""
    found: list = []
    if not cuda:
        yield found
        return

    def note(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            stack = traceback.extract_stack()[:-1]
            setup = any(fr.filename.endswith(_GRAPH_SETUP) for fr in stack)
            found.append((_outside(stack), setup, [
                f"{os.path.basename(fr.filename)}:{fr.lineno}:{fr.name}"
                for fr in stack[-8:]]))

    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        # switching the mode on may raise a warning of its own (seen at
        # the first switch of a process, on the call that switches it),
        # which belongs to no round
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("warn")
        warnings.simplefilter("always")
        warnings.showwarning = note
        try:
            yield found
        finally:
            torch.cuda.set_sync_debug_mode(prev)


# ---------------------------------------------------------------------------
# walking carries
# ---------------------------------------------------------------------------

def _leaves(x, path: str = "") -> list:
    """``(path, tensor or generator)`` of every leaf of a carry, a tree of
    dicts / lists / tuples / dataclasses."""
    if isinstance(x, (torch.Tensor, torch.Generator)):
        return [(path, x)]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return [leaf for f in dataclasses.fields(x)
                for leaf in _leaves(getattr(x, f.name), f"{path}.{f.name}")]
    if isinstance(x, dict):
        return [leaf for k in sorted(x, key=str)
                for leaf in _leaves(x[k], f"{path}[{k!r}]")]
    if isinstance(x, (list, tuple)):
        return [leaf for i, v in enumerate(x)
                for leaf in _leaves(v, f"{path}[{i}]")]
    return []


def _tensors(x) -> list:
    return [t for _, t in _leaves(x) if isinstance(t, torch.Tensor)]


def _bits(t) -> torch.Tensor:
    if isinstance(t, torch.Generator):
        return t.get_state()
    return t.detach().reshape(-1).contiguous().view(torch.uint8).clone()


def _snapshot(x) -> list:
    return [(p, _bits(t)) for p, t in _leaves(x)]


def _device_of(args) -> torch.device:
    for t in _tensors(args):
        return t.device
    return torch.device("cpu")


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def _delta(after: dict, before: dict) -> dict:
    return _nonzero({k: after[k] - before.get(k, 0) for k in after})


# ---------------------------------------------------------------------------
# one specimen
# ---------------------------------------------------------------------------

def check_specimen(sp, *, sync_watch: bool = True,
                   record: dict | None = None,
                   tag: str = "") -> list[Violation]:
    """Every trace contract of one ``TraceSpecimen``, over two calls (the
    second with the returned carry where the carry is donated: on the card
    a graph engine captures in the first and only replays in the second).
    ``sync_watch=False`` leaves out the CUDA sync debug mode (the gloo
    SPMD leg, whose transport synchronizes in its own threads by design);
    ``record`` receives the second call's kernel calls under the
    specimen's name plus ``tag``."""
    out: list[Violation] = []
    where = sp.name
    cuda = _device_of(sp.args).type == "cuda"
    kwargs = sp.kwargs or {}
    want = _nonzero({k: sp.rounds * n for k, n in (sp.launches or {}).items()})
    graphs = getattr(sp.fn, "graphs", None) if sp.expect_graph else None
    if cuda and sp.expect_graph and graphs is None:
        out.append(Violation("TRC004", where, "engine holds no CUDA graphs "
                             "(expected one replay a call on the card)"))
    f64_in = [p for p, t in _leaves(sp.args) if isinstance(t, torch.Tensor)
              and t.dtype in _BAD_DTYPES]
    if f64_in:
        out.append(Violation("TRC003", where,
                             f"f64/complex128 argument(s): {f64_in[:4]}"))

    args = tuple(sp.args)
    for call in (1, 2):
        ptrs = {i: [(p, t.data_ptr()) for p, t in _leaves(args[i])
                    if isinstance(t, torch.Tensor)] for i in sp.donate}
        snap = None if sp.donate else _snapshot(args)
        launches0, plain0 = kops.launch_counts(), kops.plain_counts()
        replays0 = graphs.replays if graphs is not None else 0
        census = _Census()
        try:
            with _sync_watch(cuda and sync_watch) as syncs:
                with census:
                    res = sp.fn(*args, **kwargs)
            if cuda:
                torch.cuda.synchronize()
        except Exception as e:     # a capture a sync broke, or a crash
            rule = "TRC002" if "captur" in str(e) else "TRC004"
            out.append(Violation(rule, where, f"call {call} raised "
                                 f"{type(e).__name__}: {e}"[:400]))
            return out

        # TRC001
        for i in sp.donate:
            now = [(p, t.data_ptr()) for p, t in _leaves(args[i])
                   if isinstance(t, torch.Tensor)]
            moved = [p for (p, a), (_, b) in zip(ptrs[i], now) if a != b]
            if moved or len(now) != len(ptrs[i]):
                out.append(Violation(
                    "TRC001", where,
                    f"call {call}: argument {i} rebound, not updated in "
                    f"place: {moved[:4]}"))
        if 0 in sp.donate and dataclasses.is_dataclass(args[0]):
            if not isinstance(res, tuple) or res[0] is not args[0]:
                out.append(Violation(
                    "TRC001", where, f"call {call}: the returned carry is "
                    f"not the one the engine bound (a copy)"))
        if snap is not None:
            changed = [p for (p, a), (_, b) in zip(snap, _snapshot(args))
                       if not torch.equal(a, b)]
            if changed:
                out.append(Violation(
                    "TRC001", where, f"call {call}: an engine that works on "
                    f"a copy changed its arguments: {changed[:4]}"))

        # TRC002
        reads = [(op, s) for op, s in census.host_reads
                 if (s[0], s[2]) not in SYNC_SITES]
        if reads:
            out.append(Violation(
                "TRC002", where, f"call {call}: host read(s) inside the "
                f"round: " + "; ".join(f"{op} at {_show(s)}"
                                       for op, s in reads[:4])))
        in_round = [(site, stack) for site, setup, stack in syncs
                    if not setup]
        if in_round:
            out.append(Violation(
                "TRC002", where, f"call {call}: synchronizing CUDA call(s) "
                f"at " + "; ".join(f"{_show(s)} [{' < '.join(st[::-1])}]"
                                   for s, st in in_round[:4])))

        # TRC003
        f64 = [(op, s) for op, s in census.f64
               if (s[0], s[2]) not in F64_SITES]
        if f64:
            out.append(Violation(
                "TRC003", where, f"call {call}: f64/complex128 value(s) "
                f"outside the one-rounding sites: " + "; ".join(
                    f"{op} at {_show(s)}" for op, s in f64[:4])))
        f64_out = [p for p, t in _leaves(res) if isinstance(t, torch.Tensor)
                   and t.dtype in _BAD_DTYPES]
        if f64_out:
            out.append(Violation("TRC003", where, f"call {call}: "
                                 f"f64/complex128 result(s): {f64_out[:4]}"))

        # TRC004
        launched = _delta(kops.launch_counts(), launches0)
        plain = _delta(kops.plain_counts(), plain0)
        got, other = (launched, plain) if cuda else (plain, launched)
        if got != want or other:
            what = "kernel launches" if cuda else "plain-version calls"
            out.append(Violation(
                "TRC004", where, f"call {call}: {what} {got} (and "
                f"{'plain-version calls' if cuda else 'launches'} {other}),"
                f" expected {sp.rounds} x {_nonzero(sp.launches or {})}"))
        if cuda and graphs is not None:
            n_replays = graphs.replays - replays0
            g = graphs.graphs.get(sp.rounds)
            if n_replays != 1 or len(graphs.graphs) != 1 or g is None:
                out.append(Violation(
                    "TRC004", where, f"call {call}: {n_replays} replay(s), "
                    f"graphs for chunk lengths {sorted(graphs.graphs)}; "
                    f"expected one replay of one graph of {sp.rounds}"))
            elif _nonzero(g.launches) != want:
                out.append(Violation(
                    "TRC004", where, f"the graph holds "
                    f"{_nonzero(g.launches)}, expected {want}"))
        if record is not None and call == 2:
            record[where + tag] = {"rounds": sp.rounds, "calls": got,
                             "census_ops": census.ops}
        if 0 in sp.donate and isinstance(res, tuple):
            args = (res[0],) + args[1:]
    return out


# ---------------------------------------------------------------------------
# serve / decode program-count bounds
# ---------------------------------------------------------------------------

def check_serve_ladder(pair, device=None) -> list[Violation]:
    from repro_torch.core.engine import sample_shape
    from repro_torch.core.spec import ServeSpec
    from repro_torch.serve.sampler import SamplerEngine

    out = []
    spec = ServeSpec(max_batch=4)
    buckets = spec.buckets()
    eng = SamplerEngine(pair, buckets, device=device)
    g, d = pair.init(torch.Generator().manual_seed(0), eng.device)
    shape = sample_shape(pair)
    eng.seed_stream(0)
    # drive EVERY request size through every family: the ladder bound
    # must hold under the worst-case size mix, not a lucky one
    for n in range(1, spec.max_batch + 1):
        eng.sample_request(g, seed=0, request_id=n, n=n)
        eng.score_bucket(d, np.zeros((n,) + tuple(shape), np.float32))
        eng.sample_stream(g, n)
    bound = len(buckets)
    for fam, cnt in eng.program_counts.items():
        if cnt > bound:
            out.append(Violation(
                "TRC005", f"serve/{fam}",
                f"{cnt} compiled programs after driving sizes "
                f"1..{spec.max_batch}; ladder bound is len(buckets)={bound}"))
    # the stream program's key is updated in place (its documented
    # contract): the program reads the engine's key buffer, which keeps
    # its storage and advances
    key = eng._stream_key
    ptr, before = key.data_ptr(), key.clone()
    eng.sample_stream(g, buckets[-1])
    prog = eng._stream_prog(buckets[-1])
    if (prog.static["key"] is not key or key.data_ptr() != ptr
            or torch.equal(key, before)):
        out.append(Violation(
            "TRC001", "serve/stream",
            "stream program's key buffer is not updated in place"))
    return out


def check_decode_ladder(device=None) -> list[Violation]:
    from repro_torch.configs.base import get_config
    from repro_torch.core.spec import DecodeSpec
    from repro_torch.models import model as M
    from repro_torch.serve.decode import DecodeEngine, DecodeRequest

    out = []
    cfg = get_config("tinyllama-1.1b").reduced()
    params = M.init_params(cfg, 1, device=device)
    spec = DecodeSpec(slots=2, max_seq=24)
    eng = DecodeEngine(cfg, params, spec, device=device)
    # one prompt per prefill bucket, so the whole ladder compiles
    for i, b in enumerate(spec.buckets()):
        plen = min(b, spec.max_seq - 2)
        eng.submit(DecodeRequest(user_id=i, prompt=tuple(range(1, plen + 1)),
                                 max_new=2))
    eng.drain()
    bound = len(spec.buckets()) + 1
    total = sum(eng.program_counts.values())
    if total > bound:
        out.append(Violation(
            "TRC005", "decode",
            f"{total} compiled programs ({eng.program_counts}) after "
            f"driving every prefill bucket; static bound is "
            f"len(buckets)+1={bound}"))
    return out


# ---------------------------------------------------------------------------
# running every check
# ---------------------------------------------------------------------------

def _tiny_setup():
    from repro_torch.core.approaches import DistGANConfig
    from repro_torch.core.gan import MLPGanConfig, make_mlp_pair

    pair = make_mlp_pair(MLPGanConfig(data_dim=2, z_dim=4, g_hidden=8,
                                      d_hidden=8))
    fcfg = DistGANConfig(num_users=2, selection="topk", upload_frac=0.5)
    return pair, fcfg


_EF_TAG = " [topk_int8+EF]"


def _ef(fcfg):
    return dataclasses.replace(fcfg, codec="topk_int8", error_feedback=True)


def spmd_check(mesh, names: tuple) -> dict:
    """The SPMD leg on this rank: every ``spmd_trace_specimens`` specimen
    (plain, and approach 1 under ``topk_int8`` + EF) checked with the
    census alone (gloo stages CUDA tensors through host memory and
    synchronizes in its own threads, which the sync debug mode would
    report as the round's), with the collectives of the second call
    priced by ``roofline.collective_bytes``.  Module-level, so
    ``spawn_users`` can run it."""
    from repro_torch.core.collectives import record_collectives
    from repro_torch.core.spmd import spmd_trace_specimens
    from repro_torch.roofline import collective_bytes

    pair, fcfg = _tiny_setup()
    specs = [(sp, "") for sp in spmd_trace_specimens(pair, fcfg, mesh,
                                                     approaches=names)]
    if "approach1" in names:
        specs += [(sp, _EF_TAG) for sp in spmd_trace_specimens(
            pair, _ef(fcfg), mesh, approaches=("approach1",))]
    violations, record, comm = [], {}, {}
    for sp, tag in specs:
        with record_collectives() as recs:
            violations += check_specimen(sp, sync_watch=False, record=record,
                                         tag=tag)
        # each specimen is called twice: half the bytes are one call's
        comm[sp.name + tag] = collective_bytes(recs)["total"] / 2
    return {"violations": [v.to_dict() for v in violations],
            "names": [sp.name for sp, _ in specs], "calls": record,
            "collective_bytes": comm}


def _spmd_leg(ranks: int, names: tuple, device) -> list[dict]:
    """``spmd_check`` on ``ranks`` gloo ranks: in this process at world size
    1 (a group of its own unless one is initialized), else in spawned
    processes sharing ``device``."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_users_mesh, spawn_users

    if ranks > 1:
        # repro: allow(RPR002): a torch.distributed backend, no registry key
        return spawn_users(spmd_check, ranks, backend="gloo",
                           device=str(device), args=(names,))
    if dist.is_initialized():
        return [spmd_check(make_users_mesh(1, device=device), names)]
    with tempfile.TemporaryDirectory(prefix="tracecheck_") as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv",
                                rank=0, world_size=1)
        try:
            return [spmd_check(make_users_mesh(1, device=device), names)]
        finally:
            dist.destroy_process_group()


def run_tracecheck(*, approaches=None, spmd=None, decode: bool = True,
                   device=None):
    """Run every trace contract on ``device`` (CUDA unless ``"cpu"``);
    returns ``(violations, checked)``.

    ``spmd`` is the SPMD leg's rank count: None runs 2 gloo ranks (the
    CLI's leg, spawned, sharing the device), 1 runs it in this process at
    world size 1, 0 leaves it out.  ``checked`` counts the programs and
    reports each specimen's kernel calls (``trace_kernel_calls``: launches
    on the card, plain-version calls on the CPU, for one call of
    ``rounds`` rounds) and each SPMD specimen's collective bytes a call."""
    from repro_torch.core.engine import trace_specimens
    from repro_torch.core.spec import registry_snapshot
    from repro_torch.device import resolve_device
    from repro_torch.multihost.backend import multihost_trace_specimens

    dev = resolve_device(device)
    ranks = 2 if spmd is None else int(spmd)
    pair, fcfg = _tiny_setup()
    names = tuple(approaches) if approaches else \
        registry_snapshot()["approach"]

    violations: list[Violation] = []
    checked_programs, calls, seconds = [], {}, {}
    t0 = time.perf_counter()
    specs = [(sp, "") for sp in trace_specimens(pair, fcfg,
                                                approaches=names, device=dev)]
    if "approach1" in names:
        specs += [(sp, _EF_TAG) for sp in trace_specimens(
            pair, _ef(fcfg), approaches=("approach1",), device=dev)]
        specs += [(sp, "") for sp in multihost_trace_specimens(
            pair, fcfg, device=dev)]
        specs += [(sp, "") for sp in multihost_trace_specimens(
            pair, _ef(fcfg), device=dev)]
    for sp, tag in specs:
        violations += check_specimen(sp, record=calls, tag=tag)
        checked_programs.append(sp.name)
    seconds["specimens"] = time.perf_counter() - t0

    comm = {}
    t0 = time.perf_counter()
    if ranks:
        results = _spmd_leg(ranks, names, dev)
        for r, res in enumerate(results):
            for v in res["violations"]:
                violations.append(Violation(v["rule"], v["where"],
                                            f"[rank {r}] {v['message']}"))
        checked_programs += results[0]["names"]
        calls.update({f"{k} (rank 0)": v
                      for k, v in results[0]["calls"].items()})
        comm = results[0]["collective_bytes"]
    seconds["spmd"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    violations += check_serve_ladder(pair, dev)
    checked_programs.append("serve/ladder")
    if decode:
        violations += check_decode_ladder(dev)
        checked_programs.append("decode/ladder")
    seconds["ladders"] = time.perf_counter() - t0

    backends = "device+host+multihost" + (
        f"+spmd ({ranks} gloo rank{'s' if ranks > 1 else ''})" if ranks
        else " (spmd skipped)")
    checked = {
        "trace_programs": len(checked_programs),
        "trace_backends": backends,
        "trace_approaches": ",".join(names),
        "trace_device": str(dev),
        "trace_kernel_calls": {k: v for k, v in calls.items()
                               if v["calls"]},
        "spmd_collective_bytes": comm,
        "trace_seconds": {k: round(v, 2) for k, v in seconds.items()},
    }
    return violations, checked
