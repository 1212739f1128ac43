"""The benchmark loads neither JAX nor the JAX package (``repro``), each
top-level module name compared whole (``repro_torch`` begins with
``repro``), and its plain reference loads nothing of the program."""

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]

CODE = f"""
import sys
sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]
import importlib, pathlib
top = lambda: {{m.split('.')[0] for m in sys.modules}}
import bench.federation.reference as ref
for p in pathlib.Path({str(ROOT / 'bench' / 'configs')!r}).glob("*.py"):
    ref.load_model(p.stem)
assert "repro_torch" not in top(), "the reference loaded the program"
import bench.harness, bench.federation.cell, bench.federation.calibrate
for p in pathlib.Path({str(ROOT / 'bench' / 'metrics')!r}).glob("*.py"):
    importlib.import_module("bench.metrics." + p.stem)
bad = sorted(top() & {{"jax", "jaxlib", "flax", "repro"}})
print(bad)
sys.exit(1 if bad else 0)
"""


def test_no_jax_in_the_benchmark_process():
    proc = subprocess.run([sys.executable, "-c", CODE], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
