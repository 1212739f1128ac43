"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``build/repro_torch_kernels/<name>-<hash>.so`` at the repository root
(a directory ``.gitignore`` lists).  The hash covers the source, every
header under ``csrc/`` (``*.cuh``) and the flags, so an edited kernel or
header is rebuilt and an unchanged one is reused.
Nothing is built when a module is imported: the first launch builds, or
:func:`build_all` builds every source at once, one ``nvcc`` process each,
all started together (``build_seconds`` keeps each one's wall time).
:func:`load_variant` builds another version of one kernel (a copy of its
source, or extra flags) beside the package's own, for the profilers.

Flags: ``sm_90a`` (Hopper), ``-O3``, no fast math, and per source what its
contract needs (:func:`nvcc_flags`): the int8 codec is held bitwise to a
plain version that rounds each operation separately, so ``quantize.cu``
builds with ``-fmad=false``; the attention and SSD kernels are held at a
tolerance and let nvcc contract multiply-adds into FMAs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")
SOURCE_FLAGS = {"quantize": ("-fmad=false",)}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}     # name -> nvcc/ptxas output of the build
build_seconds: dict[str, float] = {}  # name -> wall seconds of its nvcc run


def sources() -> list[str]:
    """Kernel source names (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc_flags(name: str) -> tuple[str, ...]:
    """The nvcc flags of ``csrc/<name>.cu``: the common ones and its own."""
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH):"
                           " the port's CUDA kernels cannot be built")
    return found


def nvcc_command(name: str, out: Path, extra: tuple[str, ...] = (),
                 source: Path | None = None) -> list[str]:
    """The nvcc command that builds ``source`` (``csrc/<name>.cu`` by
    default) with ``name``'s flags and ``extra`` into ``out``."""
    return [_nvcc(), *nvcc_flags(name), *extra, "-o", str(out),
            str(source or CSRC / f"{name}.cu")]


def _target(name: str) -> Path:
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(nvcc_flags(name)).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library is already built;
    returns (target, (process, temporary path, start time) or None)."""
    target = _target(name)
    if target.exists():
        return target, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(nvcc_command(name, tmp), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, (proc, tmp, time.perf_counter())


def _finish(name: str, target: Path, started) -> None:
    if started is None:
        return
    proc, tmp, t0 = started
    out, _ = proc.communicate()
    build_seconds[name] = time.perf_counter() - t0
    build_logs[name] = out
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, target)


def build_all() -> float:
    """Build every kernel source in parallel; returns the wall seconds."""
    t0 = time.perf_counter()
    with _lock:
        started = {n: _start(n) for n in sources()}
        waiters = [threading.Thread(target=_finish, args=(n, target, st))
                   for n, (target, st) in started.items()]
        for w in waiters:
            w.start()
        for w in waiters:
            w.join()
        failed = [n for n, (target, _) in started.items()
                  if not target.exists()]
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(
                build_logs.get(n, "") for n in failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            target, st = _start(name)
            _finish(name, target, st)
            lib = ctypes.CDLL(str(target))
            _libs[name] = lib
        return lib


def load_variant(name: str, tag: str, extra: tuple[str, ...] = (),
                 source: Path | None = None) -> ctypes.CDLL:
    """``source`` (a copy of ``csrc/<name>.cu``; the package's own by
    default) built with ``name``'s flags and ``extra`` into
    ``<name>-<tag>.so`` and loaded, beside the package's build of it."""
    out = BUILD_DIR / f"{name}-{tag}.so"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(nvcc_command(name, out, extra, source),
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source or name} {extra}:\n"
                           f"{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(out))


def check(rc: int, what: str) -> None:
    """Raise on a non-zero CUDA error code returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
