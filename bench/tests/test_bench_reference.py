"""The plain reference and the comparison that decides ``correct``, on the
CPU at tiny widths: the program (``repro_torch`` on ``device="cpu"``)
agrees with the reference through a whole harness run; the control (the
reference in TF32, emulated here) and a broken program come out not
correct against each cell's limits; the FLOP count of a round is
``FlopCounterMode``'s over the reference's round.  On the card the control
runs with cuBLAS's TF32 switched on."""

import json
import pathlib
import sys
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from bench import harness  # noqa: E402
from bench.federation import calibrate, reference  # noqa: E402
from bench.federation import data as bdata  # noqa: E402

CELLS = [w["name"] for w in harness.manifest()["workloads"]]
STORE_CELLS = [c for c in CELLS
               if harness.load_json("workloads", f"{c}.json")["cohort"]]
SEED = 2**31 + 17


def tiny(cell: str) -> tuple[dict, dict]:
    """The cell's workload and configuration at widths a test can hold,
    with the cell's own limits: 20 rounds a call, so that the call runs a
    whole chunk and part of another."""
    w = harness.load_json("workloads", f"{cell}.json")
    c = harness.load_json("configs", f"{w['config']}.json")
    c.update(data_dim=16, image_size=4, z_dim=4, g_hidden=8, d_hidden=8)
    w.update(batch=4, rounds_per_call=20, data={"images": 40, "alpha": 0.5})
    if w["cohort"] is None:
        w["users"] = 3
    else:
        w["users"], w["cohort"] = 12, 3
    return w, c


def run_cell(cell: str) -> dict:
    w, c = tiny(cell)
    result, lines = harness.execute(cell, SEED, 0.05, False,
                                    time.perf_counter(), device="cpu",
                                    workload=w, config=c)
    assert len(lines) == 1 + len(result["checks"])
    json.dumps(result)
    return result


@pytest.mark.parametrize("cell", CELLS)
def test_program_agrees_with_the_reference(cell):
    result = run_cell(cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 20 and result["failed"] == 0
    assert list(result)[-1] == "checks"


def _unchanged(monkeypatch):
    # every parameter update dropped: each step returns its state unchanged
    monkeypatch.setattr("repro_torch.core.approaches.apply_updates",
                        lambda params, updates: None)


def _half_batch(monkeypatch):
    # half of every batch left out, each loss the mean over the rest
    from repro_torch.core import losses
    d_loss, g_loss = losses.d_loss, losses.g_loss_nonsat
    half = lambda t: t[..., :t.shape[-1] // 2]  # noqa: E731
    monkeypatch.setattr(losses, "d_loss",
                        lambda r, f: d_loss(half(r), half(f)))
    monkeypatch.setattr(losses, "g_loss_nonsat", lambda f: g_loss(half(f)))


def _chunk_batch(monkeypatch):
    # every round of a chunk trained on the batches staged for its first
    from repro_torch.core.session import _Stager
    get = _Stager.get

    def first(self, start, k):
        reals = get(self, start, k)
        return reals[:1].expand_as(reals)

    monkeypatch.setattr(_Stager, "get", first)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _chunk_batch],
                         ids=["unchanged", "half_batch", "chunk_batch"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_program_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    assert not run_cell(cell)["correct"]


@pytest.mark.parametrize("cell", STORE_CELLS)
def test_a_wrong_store_gather_is_not_correct(cell, monkeypatch):
    # each round gathers the next user's stored rows in place of its own
    from repro_torch.core import engine
    gather = engine.cohort_gather

    def shifted(store, idx, *layouts):
        if len(idx) < store.num_users:
            idx = (idx + 1) % store.num_users
        return gather(store, idx, *layouts)

    monkeypatch.setattr(engine, "cohort_gather", shifted)
    result = run_cell(cell)
    assert not result["correct"] and result["checks"]["step_gap"]["value"]


def _control_fails(cell: str, device) -> None:
    w, c = tiny(cell)
    gaps = calibrate.planted_readings(c, w, SEED, device)["control"]
    assert any(v > w["limits"][k] for k, v in gaps.items()), gaps


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    _control_fails(cell, torch.device("cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_on_the_card(cell):
    if not torch.cuda.is_available():           # decided here, not at import
        pytest.skip("needs a CUDA device")
    _control_fails(cell, torch.device("cuda", 0))


@pytest.mark.parametrize("cell", CELLS)
def test_round_flops_match_the_flop_counter(cell):
    w, c = tiny(cell)
    images, labels = bdata.images(SEED, 40, c["image_size"], c["channels"])
    with FlopCounterMode(display=False) as counter:
        reference.run(c, w, SEED, images, labels, 2, "cpu")
    members = w["cohort"] or w["users"]
    flops = reference.load_model(w["config"]).round_flops(c, members,
                                                          w["batch"])
    assert counter.get_total_flops() == 2 * flops["total"]
