"""Pass 2 — repo-invariant AST lint over the port (port of the reference's
``analysis/lint.py``).

Named rules, each a bug class the reference shipped or designs against,
restated for torch where the class depends on the framework:

* **RPR001** ``torch.from_numpy`` / ``torch.as_tensor`` / ``torch.asarray``
  on a buffer reachable from ``self`` with no copy: the tensor shares
  memory with the live buffer, so a snapshot of a host store is silently
  changed by later in-place scatters (the reference's ``jnp.asarray``
  aliasing bug).  Copy (``.clone()``, ``np.array``, ``copy=True``) or
  waive with a justification.
* **RPR002** registry-key drift: a string key passed to a
  ``resolve_*``/registry lookup (or an ``approach=``/``scheduler=``/
  ``combiner=``/``backend=`` keyword / manifest dict entry) that no
  ``register_*`` call in the linted corpus registers — and the reverse,
  a registered key that appears nowhere else (dead registration).
* **RPR003** read after replay: a value returned by a call of a graph
  engine (``DONATING_FACTORIES``: its metrics or its carry) read after a
  later call of the same engine.  The engine binds its carry and returns
  a CUDA graph's static outputs, so the next call overwrites both
  (``core/engine.py``); clone what must outlive it before that call.
* **RPR004** unseeded ``np.random`` module-level calls (legacy global
  PRNG), everywhere; inside ``src/repro_torch/`` also a torch random draw
  (``torch.rand``, ``Tensor.normal_``, ...) without an explicit
  ``generator=``: every draw goes through a seeded generator or the run is
  unreproducible.
* **RPR005** a spec dataclass field that ``__post_init__`` never
  references (unvalidated manifest input), or a Spec-typed field of a
  ``from_dict`` class missing from its coercion table (silently
  un-round-trippable manifest section).
* **RPR006** a hand-written kernel without a plain version: every wrapper
  in ``kernels/*.py`` that launches a kernel built from ``csrc/`` (it
  bumps a ``*launches`` count) must be named in its module's
  ``PLAIN_VERSIONS`` table, and the ``*_ref`` function named there must
  exist in ``kernels/ref.py``.

Waive a finding with a trailing comment on the flagged line (or the
line above): ``# repro: allow(RPR001): one-line justification``.
"""

from __future__ import annotations

import ast
import glob
import os
import re

from repro_torch.analysis import Violation

_WAIVER_RE = re.compile(
    r"#\s*repro:\s*allow\(\s*(RPR\d{3})\s*\)\s*(?::\s*(\S.*))?")

# the factories whose engines bind their carry and return a CUDA graph's
# static outputs (core/engine.py): RPR003 holds every value their engines
# return to one call
DONATING_FACTORIES = frozenset({"make_engine", "make_fused_store_engine",
                                "make_cohort_engine",
                                "make_cohort_rows_engine",
                                "make_superbatch_engine"})

# np.random.<fn> that are fine: explicit generator/seed constructors
_NP_RANDOM_OK = {"default_rng", "Generator", "SeedSequence", "PCG64",
                 "Philox", "MT19937", "RandomState", "BitGenerator"}
# torch draws that take a generator=, as functions and as in-place methods
_TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "rand_like",
                "randn_like", "randint_like", "normal", "bernoulli",
                "multinomial", "poisson"}
_TENSOR_DRAWS = {"uniform_", "normal_", "bernoulli_", "random_",
                 "exponential_", "geometric_", "cauchy_", "log_normal_"}
# torch functions that may share memory with their argument
_ALIASING = {"from_numpy", "as_tensor", "asarray"}
# calls whose result is a fresh copy of their argument or receiver
_COPIES = {"clone", "copy", "array", "deepcopy"}

_REGISTER_FNS = {"register_approach": "approach",
                 "register_scheduler": "scheduler",
                 "register_combiner": "combiner",
                 "register_backend": "backend"}
_RESOLVE_FNS = {"resolve_approach": "approach",
                "resolve_scheduler": "scheduler",
                "resolve_combiner": "combiner",
                "resolve_backend": "backend"}
_REGISTRY_ATTRS = {"APPROACH_REGISTRY": "approach",
                   "SCHEDULER_REGISTRY": "scheduler",
                   "COMBINER_REGISTRY": "combiner",
                   "BACKEND_REGISTRY": "backend"}
# built with a comprehension so the linter's own table is not parsed as
# a manifest dict literal by RPR002
_KEY_KWARGS = {k: k for k in ("approach", "scheduler", "combiner",
                              "backend")}


def _is_str(node) -> bool:
    return isinstance(node, ast.Constant) and isinstance(node.value, str)


def _contains_self(node) -> bool:
    return any(isinstance(n, ast.Name) and n.id == "self"
               for n in ast.walk(node))


class _ParsedFile:
    def __init__(self, path: str, rel: str):
        self.path = path
        self.rel = rel
        with open(path, encoding="utf-8") as fh:
            self.src = fh.read()
        self.tree = ast.parse(self.src, filename=path)
        self.lines = self.src.splitlines()
        self.parents = {child: node for node in ast.walk(self.tree)
                        for child in ast.iter_child_nodes(node)}
        # waivers: {line -> set of waived rules}; a waiver covers its own
        # line and the line below (comment-above style)
        self.waivers: dict[int, set] = {}
        for i, line in enumerate(self.lines, start=1):
            m = _WAIVER_RE.search(line)
            if m:
                self.waivers.setdefault(i, set()).add(m.group(1))
                self.waivers.setdefault(i + 1, set()).add(m.group(1))

    def in_port(self) -> bool:
        return "repro_torch" in self.rel.replace(os.sep, "/").split("/")

    def waived(self, rule: str, line: int) -> bool:
        return rule in self.waivers.get(line, ())


# ---------------------------------------------------------------------------
# per-file rules
# ---------------------------------------------------------------------------

def _callee_name(call: ast.Call):
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def _is_copy_call(node) -> bool:
    return isinstance(node, ast.Call) and _callee_name(node) in _COPIES


def _rule_001_shared_memory(pf: _ParsedFile):
    for node in ast.walk(pf.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _ALIASING
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "torch" and node.args):
            continue
        if not _contains_self(node.args[0]) or _is_copy_call(node.args[0]):
            continue
        if any(kw.arg == "copy" and isinstance(kw.value, ast.Constant)
               and kw.value.value is True for kw in node.keywords):
            continue
        up = pf.parents.get(node)
        if (isinstance(up, ast.Attribute) and up.attr in _COPIES
                and isinstance(pf.parents.get(up), ast.Call)):
            continue
        yield Violation(
            "RPR001", f"{pf.rel}:{node.lineno}",
            f"torch.{node.func.attr} on a buffer reachable from self "
            f"shares its memory with a live store (the reference's "
            f"asarray aliasing bug class); copy (.clone(), np.array, "
            f"copy=True) or waive")


def _rule_004_unseeded_draws(pf: _ParsedFile):
    port = pf.in_port()
    for node in ast.walk(pf.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            continue
        f = node.func
        if (isinstance(f.value, ast.Attribute) and f.value.attr == "random"
                and isinstance(f.value.value, ast.Name)
                and f.value.value.id in ("np", "numpy")
                and f.attr not in _NP_RANDOM_OK):
            yield Violation(
                "RPR004", f"{pf.rel}:{node.lineno}",
                f"np.random.{f.attr} draws from the unseeded global "
                f"PRNG; use a seeded np.random.default_rng")
            continue
        if not port or any(kw.arg == "generator" for kw in node.keywords):
            continue
        torch_fn = (isinstance(f.value, ast.Name) and f.value.id == "torch"
                    and f.attr in _TORCH_DRAWS)
        if torch_fn or f.attr in _TENSOR_DRAWS:
            what = f"torch.{f.attr}" if torch_fn else f".{f.attr}"
            yield Violation(
                "RPR004", f"{pf.rel}:{node.lineno}",
                f"{what} without generator= draws from torch's global "
                f"PRNG; pass a seeded torch.Generator")


def _assign_targets(stmt):
    names = set()
    tgts = []
    if isinstance(stmt, ast.Assign):
        tgts = stmt.targets
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)) and stmt.value:
        tgts = [stmt.target]
    for t in tgts:
        for n in ast.walk(t):
            if isinstance(n, ast.Name):
                names.add(n.id)
    return names


def _rule_003_read_after_replay(pf: _ParsedFile):
    for fn in ast.walk(pf.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        # graph engines bound in this function
        engines = set()
        for stmt in ast.walk(fn):
            if (isinstance(stmt, ast.Assign)
                    and isinstance(stmt.value, ast.Call)
                    and _callee_name(stmt.value) in DONATING_FACTORIES):
                engines.update(t.id for t in stmt.targets
                               if isinstance(t, ast.Name))
        if not engines:
            continue

        # line-ordered simple statements (a lint heuristic, not a CFG:
        # code that calls an engine and reads its results is
        # linear in practice)
        stmts = sorted(
            (s for s in ast.walk(fn)
             if isinstance(s, (ast.Assign, ast.AugAssign, ast.AnnAssign,
                               ast.Expr, ast.Return))),
            key=lambda s: s.lineno)
        returned: dict[str, set] = {e: set() for e in engines}
        stale: dict[str, tuple] = {}   # name -> (engine, line overwritten)
        for stmt in stmts:
            targets = _assign_targets(stmt)
            # 1) stale reads: a name returned by an earlier call, loaded
            # after a later call of the same engine
            for n in ast.walk(stmt):
                if (isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)
                        and n.id in stale and n.lineno > stale[n.id][1]):
                    eng, line = stale.pop(n.id)
                    yield Violation(
                        "RPR003", f"{pf.rel}:{n.lineno}",
                        f"'{n.id}' was returned by an earlier call of "
                        f"graph engine '{eng}', whose call on line {line} "
                        f"overwrote it (a bound carry or a graph's static "
                        f"outputs); clone it before that call")
            # 2) rebinding clears the poison
            for t in targets:
                stale.pop(t, None)
                for names in returned.values():
                    names.discard(t)
            # 3) an engine call overwrites what its earlier calls returned
            for call in ast.walk(stmt):
                if not (isinstance(call, ast.Call)
                        and isinstance(call.func, ast.Name)
                        and call.func.id in engines):
                    continue
                eng = call.func.id
                for nm in returned[eng]:
                    stale[nm] = (eng, call.lineno)
                returned[eng] = (set(targets) if getattr(stmt, "value", None)
                                 is call else set())


def _decorated_dataclass(cls: ast.ClassDef) -> bool:
    for d in cls.decorator_list:
        node = d.func if isinstance(d, ast.Call) else d
        if isinstance(node, ast.Name) and node.id == "dataclass":
            return True
        if isinstance(node, ast.Attribute) and node.attr == "dataclass":
            return True
    return False


def _rule_005_spec_validation(pf: _ParsedFile):
    for cls in ast.walk(pf.tree):
        if not isinstance(cls, ast.ClassDef) or not _decorated_dataclass(cls):
            continue
        # scope: manifest/API boundary types (``*Spec``, ``*Request``) —
        # internal config dataclasses validate on use, not construction
        if not cls.name.endswith(("Spec", "Request")):
            continue
        post = next((m for m in cls.body
                     if isinstance(m, ast.FunctionDef)
                     and m.name == "__post_init__"), None)
        if post is None:
            continue
        fields = [(s.target.id, s) for s in cls.body
                  if isinstance(s, ast.AnnAssign)
                  and isinstance(s.target, ast.Name)
                  and "ClassVar" not in ast.dump(s.annotation)]
        touched = {n.attr for n in ast.walk(post)
                   if isinstance(n, ast.Attribute)
                   and isinstance(n.value, ast.Name)
                   and n.value.id == "self"}
        for name, s in fields:
            if name not in touched:
                yield Violation(
                    "RPR005", f"{pf.rel}:{s.lineno}",
                    f"{cls.name}.{name} is never referenced in "
                    f"__post_init__ — manifest input reaches the run "
                    f"unvalidated")
        from_dict = next((m for m in cls.body
                          if isinstance(m, ast.FunctionDef)
                          and m.name == "from_dict"), None)
        if from_dict is None:
            continue
        fd_strings = {n.value for n in ast.walk(from_dict)
                      if _is_str(n)}
        for name, s in fields:
            ann = ast.dump(s.annotation)
            if "Spec" in ann and name not in fd_strings:
                yield Violation(
                    "RPR005", f"{pf.rel}:{s.lineno}",
                    f"{cls.name}.{name} is a Spec-typed section missing "
                    f"from the from_dict coercion table — the manifest "
                    f"round-trip drops its type")


# ---------------------------------------------------------------------------
# corpus rules
# ---------------------------------------------------------------------------

def _rule_002_registry_keys(files):
    registered = {}   # kind -> {key -> (rel, line)}
    referenced = {}   # kind -> {key -> (rel, line)}
    literals = {}     # value -> set of (rel, line)
    for pf in files:
        for node in ast.walk(pf.tree):
            if _is_str(node):
                literals.setdefault(node.value, set()).add(
                    (pf.rel, node.lineno))
            if not isinstance(node, ast.Call):
                continue
            callee = _callee_name(node)
            if callee in _REGISTER_FNS and node.args and _is_str(
                    node.args[0]):
                registered.setdefault(_REGISTER_FNS[callee], {}).setdefault(
                    node.args[0].value, (pf.rel, node.lineno))
            elif callee in _RESOLVE_FNS and node.args and _is_str(
                    node.args[0]):
                referenced.setdefault(_RESOLVE_FNS[callee], {}).setdefault(
                    node.args[0].value, (pf.rel, node.lineno))
            elif (callee == "get" and isinstance(node.func, ast.Attribute)
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id in _REGISTRY_ATTRS
                    and node.args and _is_str(node.args[0])):
                referenced.setdefault(
                    _REGISTRY_ATTRS[node.func.value.id], {}).setdefault(
                    node.args[0].value, (pf.rel, node.lineno))
            for kw in node.keywords:
                if kw.arg in _KEY_KWARGS and _is_str(kw.value):
                    referenced.setdefault(
                        _KEY_KWARGS[kw.arg], {}).setdefault(
                        kw.value.value, (pf.rel, kw.value.lineno))
        # manifest dict literals: {"approach": "approach1", ...}
        for node in ast.walk(pf.tree):
            if not isinstance(node, ast.Dict):
                continue
            for k, v in zip(node.keys, node.values):
                if (k is not None and _is_str(k) and k.value in _KEY_KWARGS
                        and _is_str(v)):
                    referenced.setdefault(
                        _KEY_KWARGS[k.value], {}).setdefault(
                        v.value, (pf.rel, v.lineno))

    if not registered and not referenced:
        return
    for kind, refs in referenced.items():
        known = registered.get(kind, {})
        for key, (rel, line) in sorted(refs.items()):
            if key not in known:
                yield Violation(
                    "RPR002", f"{rel}:{line}",
                    f"{kind} key {key!r} is referenced but never "
                    f"registered in the linted corpus")
    for kind, regs in registered.items():
        for key, (rel, line) in sorted(regs.items()):
            uses = literals.get(key, set()) - {(rel, line)}
            if not uses:
                yield Violation(
                    "RPR002", f"{rel}:{line}",
                    f"{kind} key {key!r} is registered but the literal "
                    f"appears nowhere else (dead registration)")


def _counts_launch(fn: ast.FunctionDef) -> bool:
    """Whether ``fn`` bumps a ``*launches`` count (a wrapper's mark where
    it launches its kernel)."""
    for n in ast.walk(fn):
        if not isinstance(n, ast.AugAssign):
            continue
        t = n.target.value if isinstance(n.target, ast.Subscript) \
            else n.target
        if isinstance(t, ast.Name) and t.id.endswith("launches"):
            return True
    return False


def _plain_table(tree) -> dict | None:
    for node in tree.body:
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "PLAIN_VERSIONS"
                        for t in node.targets)):
            return {k.value: (v.value, v.lineno)
                    for k, v in zip(node.value.keys, node.value.values)
                    if _is_str(k) and _is_str(v)}
    return None


def _rule_006_plain_versions(files):
    ref_names = set()
    wrappers = []   # (fn name, table, rel, line)
    for pf in files:
        base = os.path.basename(pf.path)
        in_kernels = (os.sep + "kernels" + os.sep) in pf.path or \
            pf.rel.startswith("kernels/")
        if not in_kernels:
            continue
        if base == "ref.py":
            ref_names.update(n.name for n in ast.walk(pf.tree)
                             if isinstance(n, ast.FunctionDef))
            continue
        if base in ("ops.py", "__init__.py"):
            continue
        table = _plain_table(pf.tree) or {}
        wrappers += [(fn.name, table, pf.rel, fn.lineno)
                     for fn in pf.tree.body
                     if isinstance(fn, ast.FunctionDef)
                     and _counts_launch(fn)]
    for fn_name, table, rel, line in wrappers:
        if fn_name not in table:
            yield Violation(
                "RPR006", f"{rel}:{line}",
                f"kernel wrapper {fn_name} names no plain version in its "
                f"module's PLAIN_VERSIONS — nothing to hold the kernel to")
            continue
        ref, ref_line = table[fn_name]
        if ref not in ref_names:
            yield Violation(
                "RPR006", f"{rel}:{ref_line}",
                f"kernel wrapper {fn_name}'s plain version {ref} is not "
                f"defined in kernels/ref.py")


# ---------------------------------------------------------------------------
# running every check
# ---------------------------------------------------------------------------

_PER_FILE_RULES = (_rule_001_shared_memory, _rule_003_read_after_replay,
                   _rule_004_unseeded_draws, _rule_005_spec_validation)

DEFAULT_TARGETS = ("src/repro_torch", "chip_smoke.py", "tests/test_torch_*.py")


def _collect(root: str, targets) -> list[str]:
    out = []
    for t in targets:
        p = t if os.path.isabs(t) else os.path.join(root, t)
        for q in (sorted(glob.glob(p)) if glob.has_magic(p) else [p]):
            if os.path.isfile(q) and q.endswith(".py"):
                out.append(q)
            elif os.path.isdir(q):
                for dirpath, dirnames, filenames in os.walk(q):
                    # "fixtures" holds known-bad rule exemplars — linted
                    # explicitly by tests, never by the default sweep
                    dirnames[:] = [d for d in dirnames
                                   if d not in ("__pycache__", ".git",
                                                "fixtures")]
                    out.extend(os.path.join(dirpath, f)
                               for f in sorted(filenames)
                               if f.endswith(".py"))
    return sorted(set(out))


def repo_root() -> str:
    return os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", "..", ".."))


def run_lint(paths=None, root: str | None = None):
    """Run all lint rules; returns ``(violations, checked)``.

    ``paths`` — explicit files/directories/globs (default: the port's
    tree, ``chip_smoke.py`` and the port's tests).  Corpus rules
    (RPR002/RPR006) see exactly the linted file set, so a fixture file
    linted alone must be self-contained."""
    root = root or repo_root()
    files = []
    for path in _collect(root, paths or DEFAULT_TARGETS):
        rel = os.path.relpath(path, root)
        files.append(_ParsedFile(path, rel))

    raw: list[Violation] = []
    for pf in files:
        for rule in _PER_FILE_RULES:
            raw.extend(rule(pf))
    raw.extend(_rule_002_registry_keys(files))
    raw.extend(_rule_006_plain_versions(files))

    by_rel = {pf.rel: pf for pf in files}
    violations, waived = [], 0
    for v in raw:
        rel, _, line = v.where.rpartition(":")
        pf = by_rel.get(rel)
        if pf is not None and line.isdigit() and pf.waived(v.rule,
                                                          int(line)):
            waived += 1
            continue
        violations.append(v)

    checked = {"lint_files": len(files),
               "lint_rules": "RPR001-RPR006",
               "lint_waived": waived}
    return violations, checked
