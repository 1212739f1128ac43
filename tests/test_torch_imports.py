"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor anything of ``repro``, and entry points refuse to run
on the CPU unless asked to."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
_FORBIDDEN = re.compile(r"^\s*(?:from|import)\s+(jax|repro)(?:\.|\s|$)",
                        re.MULTILINE)


def test_import_leaves_jax_out_of_the_process():
    """A fresh interpreter (this one already holds jax via conftest)."""
    code = ("import sys, repro_torch, repro_torch.core.session, "
            "repro_torch.core.engine, repro_torch.core.federated, "
            "repro_torch.core.protocol, repro_torch.convert, "
            "repro_torch.kernels.ops, repro_torch.checkpoint, "
            "repro_torch.checkpoint.msgpack_codec, repro_torch.core.gan, "
            "repro_torch.core.losses, repro_torch.optim.schedule, "
            "repro_torch.examples.distgan_mnist, repro_torch.core.spmd, "
            "repro_torch.launch.mesh, repro_torch.core.collectives, "
            "repro_torch.examples.distgan_spmd_multiuser; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py"], ids=lambda p: str(p.relative_to(ROOT)))
def test_static_scan_finds_no_jax_or_reference_import(path):
    hits = _FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path} imports {hits}"


def test_entry_points_refuse_the_cpu_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.core.approaches import DistGANConfig
    from repro_torch.core.gan import MLPGanConfig, make_mlp_pair
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.core.protocol import (measure_component_times,
                                           run_distgan)
    from repro_torch.core.session import FederationSession
    from repro_torch.core.spec import FederationSpec
    from repro_torch.data import federated_split
    from repro_torch.device import resolve_device

    pair = make_mlp_pair(MLPGanConfig(data_dim=4, z_dim=2, g_hidden=4,
                                      d_hidden=4))
    data = np.random.default_rng(0).normal(size=(20, 4)).astype(np.float32)
    ds = federated_split(data, np.arange(20) % 2, [[0], [1]])
    fcfg = DistGANConfig(num_users=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FederationSession(pair, fcfg, ds, FederationSpec("approach1"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_distgan(pair, fcfg, ds, "approach1", steps=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        measure_component_times(pair, fcfg, ds, 4, iters=1)
    save_checkpoint(str(tmp_path / "t"), 0, {"w": torch.ones(2)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        restore_checkpoint(str(tmp_path / "t"), 0, {"w": torch.ones(2)})
    sess = FederationSession(pair, fcfg, ds, FederationSpec(
        "approach1", batch_size=4, eval_samples=0), device="cpu")
    sess.run(1)
    sess.save(str(tmp_path / "s"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FederationSession.restore(str(tmp_path / "s"), pair, fcfg, ds)
    res = run_distgan(pair, fcfg, ds, "approach1", steps=2, batch_size=4,
                      eval_samples=0, device="cpu")
    assert res.extra["device"] == "cpu"
