"""The port's roofline (``repro_torch.roofline``) held to the reference's
(``repro.roofline``) on the CPU: the analytic parameter and model-FLOP
counts for every config and input shape, the three-term report, the
collective-byte pricing against the reference's HLO parser, and the op
counts of ``cost_analysis``."""

import pytest
import torch

from repro.configs import base as ref_base
from repro.roofline import analysis as ref_roofline
from repro_torch.configs import base
from repro_torch.roofline import analysis as roofline


@pytest.mark.parametrize("arch", list(base.ARCH_IDS))
def test_param_count_and_model_flops_equal_reference(arch):
    assert tuple(base.ARCH_IDS) == tuple(ref_base.ARCH_IDS)
    assert sorted(base.INPUT_SHAPES) == sorted(ref_base.INPUT_SHAPES)
    cfg, ref_cfg = base.get_config(arch), ref_base.get_config(arch)
    for active in (False, True):
        n = roofline.param_count(cfg, active_only=active)
        assert n == ref_roofline.param_count(ref_cfg, active_only=active)
        assert n > 0
    for name, shape in base.INPUT_SHAPES.items():
        assert roofline.model_flops(cfg, shape) == ref_roofline.model_flops(
            ref_cfg, ref_base.INPUT_SHAPES[name])


def test_roofline_terms_equal_reference_at_its_constants(monkeypatch):
    kw = dict(arch="tinyllama-1.1b", shape="train_4k", mesh_name="1x1",
              chips=1, cost={"flops": 3.1e15, "bytes accessed": 7.5e12},
              collective={"all-reduce": 4e9, "total": 4e9}, model_fl=2.9e15,
              bytes_per_device=2.2e10)
    # the H100's rates, from timing.py's one source
    h100 = roofline.roofline_terms(**kw)
    assert h100.compute_s == 3.1e15 / 989e12
    assert h100.memory_s == 7.5e12 / 3.35e12
    assert h100.collective_s == 4e9 / 450e9
    assert h100.dominant == "compute"
    for ours, theirs in (("PEAK_FLOPS", "PEAK_FLOPS"), ("HBM_BW", "HBM_BW"),
                         ("NVLINK_BW", "ICI_LINK_BW"),
                         ("NVLINK_LINKS", "ICI_LINKS")):
        monkeypatch.setattr(roofline, ours, getattr(ref_roofline, theirs))
    assert roofline.roofline_terms(**kw).to_dict() == \
        ref_roofline.roofline_terms(**kw).to_dict()


def test_collective_bytes_equal_the_reference_hlo_parser():
    ops = [("all-reduce", (4, 8), "f32"), ("all-gather", (2, 16), "s32"),
           ("all-reduce", (1024,), "s32"), ("all-gather", (3, 5, 7), "s8"),
           ("reduce-scatter", (8,), "bf16"), ("all-to-all", (2, 2), "f16")]
    hlo = "\n".join(
        f"  %op.{i} = {dt}[{','.join(map(str, shape))}]{{0}} {kind}(%p.{i})"
        for i, (kind, shape, dt) in enumerate(ops))
    assert roofline.collective_bytes(ops) == \
        ref_roofline.collective_bytes_from_hlo(hlo)
    assert roofline.collective_bytes([]) == {"total": 0}


def test_collectives_recorder_notes_result_shapes():
    """``record_collectives`` sees what each collective returns, in the
    parser's kinds and dtype names (one rank, in this process)."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.core.collectives import (all_gather, pmax, psum,
                                              record_collectives)
    from repro_torch.launch.mesh import make_users_mesh

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv",
                                rank=0, world_size=1)
        try:
            mesh = make_users_mesh(1, device="cpu")
            with record_collectives() as recs:
                psum(torch.ones(3, 4), mesh)
                pmax(torch.ones(5), mesh)
                all_gather(torch.zeros(2, 3, dtype=torch.int8), mesh)
        finally:
            dist.destroy_process_group()
    assert recs == [("all-reduce", (3, 4), "f32"),
                    ("all-reduce", (5,), "s32"),
                    ("all-gather", (6,), "s8")]
    assert roofline.collective_bytes(recs) == {
        "all-reduce": 2.0 * (48 + 20), "all-gather": 6.0,
        "total": 2.0 * (48 + 20) + 6.0}


@pytest.mark.parametrize("m,k,n", [(8, 16, 4), (33, 7, 5)])
def test_cost_analysis_counts_a_matmul(m, k, n):
    a, b = torch.ones(m, k), torch.ones(k, n)
    cost = roofline.cost_analysis(torch.matmul, a, b)
    assert cost["flops"] == 2 * m * n * k
    assert cost["bytes accessed"] == 4 * (m * k + k * n + m * n)


def test_cost_analysis_counts_a_backward_and_skips_views():
    w = torch.ones(6, 3, requires_grad=True)
    x = torch.ones(4, 6)

    def step():
        loss = (x @ w).sum()
        loss.backward()

    cost = roofline.cost_analysis(step)
    # the forward matmul, and the weight gradient x^T @ dy
    assert cost["flops"] == 2 * (2 * 4 * 6 * 3)
    assert cost["bytes accessed"] > 0
    view = roofline.cost_analysis(lambda t: t.view(-1).t(), torch.ones(8, 8))
    assert view == {"flops": 0.0, "bytes accessed": 0.0}
