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
    """A fresh interpreter (this one already holds jax via conftest); the
    mesh and dry-run modules initialize no process group on import."""
    code = ("import sys, repro_torch, repro_torch.core.session, "
            "repro_torch.core.engine, repro_torch.core.federated, "
            "repro_torch.core.protocol, repro_torch.convert, "
            "repro_torch.kernels.ops, repro_torch.checkpoint, "
            "repro_torch.checkpoint.msgpack_codec, repro_torch.core.gan, "
            "repro_torch.core.losses, repro_torch.optim.schedule, "
            "repro_torch.examples.distgan_mnist, repro_torch.core.spmd, "
            "repro_torch.launch.mesh, repro_torch.core.collectives, "
            "repro_torch.examples.distgan_spmd_multiuser, "
            "repro_torch.multihost.wire, repro_torch.multihost.rpc, "
            "repro_torch.multihost.worker, repro_torch.multihost.launch, "
            "repro_torch.multihost.backend, repro_torch.prng, "
            "repro_torch.serve, repro_torch.serve.sampler, "
            "repro_torch.serve.scheduler, repro_torch.serve.service, "
            "repro_torch.serve.decode, repro_torch.serve.program, "
            "repro_torch.models.cache, repro_torch.models.model, "
            "repro_torch.models.moe, repro_torch.models.rglru, "
            "repro_torch.data.synthetic, repro_torch.launch.serve, "
            "repro_torch.profile_serve, repro_torch.launch.steps, "
            "repro_torch.launch.train, repro_torch.core.distgan_lm, "
            "repro_torch.analysis, repro_torch.analysis.lint, "
            "repro_torch.analysis.tracecheck, repro_torch.analysis.__main__, "
            "repro_torch.roofline, repro_torch.roofline.analysis, "
            "repro_torch.sharding, repro_torch.sharding.rules, "
            "repro_torch.launch.dryrun, repro_torch.examples.quickstart, "
            "repro_torch.examples.distgan_cohort, "
            "repro_torch.examples.distgan_stream, "
            "repro_torch.examples.distgan_fused_store, "
            "repro_torch.examples.distgan_compress, "
            "repro_torch.examples.distgan_multihost, "
            "repro_torch.examples.distgan_serve, "
            "repro_torch.examples.serve_batched; "
            "import torch.distributed as dist; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "bad += ['a process group'] if dist.is_initialized() else []; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_multihost_worker_imports_neither_torch_nor_jax():
    """The multihost worker process (``python -m
    repro_torch.multihost.worker``) runs on numpy and the port's codec: the
    package re-exports are lazy, so a fleet starts without torch (or
    jax)."""
    code = ("import runpy, sys; sys.argv = ['worker', '--help']\n"
            "try:\n"
            "    runpy.run_module('repro_torch.multihost.worker',"
            " run_name='__main__')\n"
            "except SystemExit:\n"
            "    pass\n"
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('torch', 'jax', 'jaxlib', 'repro')))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]", proc.stdout


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


def test_train_launcher_refuses_the_cpu_unless_asked(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.launch.train import main
    args = ["--arch", "tinyllama-1.1b", "--reduced", "--steps", "1",
            "--batch", "1", "--seq", "8"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(args)
    main(args + ["--device", "cpu"])
    assert "[train] step 0: loss=" in capsys.readouterr().out


# each example twin at a small size: main raises before it trains or spawns
# anything when no card is there and --device is not given
_TWINS = {
    "quickstart": ["--steps", "1"],
    "distgan_cohort": ["--users", "4", "--cohort", "2", "--steps", "1"],
    "distgan_stream": ["--users", "4", "--cohort", "2", "--steps", "1"],
    "distgan_fused_store": ["--users", "4", "--cohort", "2", "--steps", "1"],
    "distgan_compress": ["--users", "4", "--cohort", "2", "--steps", "1"],
    "distgan_multihost": ["--users", "4", "--workers", "2", "--cohort", "2",
                          "--steps", "1"],
    "distgan_serve": ["--quick"],
    "serve_batched": [],
    "distgan_mnist": ["--steps", "1"],
    "distgan_spmd_multiuser": ["--steps", "1"],
}


@pytest.mark.parametrize("name", sorted(_TWINS))
def test_example_twins_refuse_the_cpu_unless_asked(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    import importlib
    twin = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        twin.main(_TWINS[name])
