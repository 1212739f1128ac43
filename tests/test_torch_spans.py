"""The federation call's spans (``repro_torch.spans``) on the CPU.

* With no profiler running, ``span`` returns the one shared no-op, builds
  no record, and lets an exception pass.
* Under ``torch.profiler.profile`` it records ``distgan.<name>`` as a
  function-scope event, not a user annotation (which the profiler would
  draw again on the device's timeline).
* A device-backend session records one ``session.stage`` per call (and one
  per chunk staged when the window is staged chunk by chunk) and one
  ``session.finish`` per call, fused and cohort, and its losses and state
  are bitwise those of the same run with no profiler.
* ``_ChunkGraphs`` (with the stand-in for ``torch.cuda``'s graph of
  ``test_torch_engine_graph.py``) records one ``engine.noise``,
  ``engine.load`` and ``engine.replay`` per chunk and one
  ``engine.capture`` per new chunk length, none on a length it has.
* No ``distgan.`` event lies inside another.
"""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.core import approaches as tapp
from repro_torch.core import engine as teng
from repro_torch.core import session as tsess
from repro_torch.core.session import FederationSession
from repro_torch.core.spec import (EngineSpec, FederationSpec,
                                   ParticipationSpec, resolve_approach)
from repro_torch.data import digits_like_mixture, dirichlet_partition

from test_torch_engine_graph import (_assert_states_equal, _fcfg, _pair,
                                     _Rehearsal, _reals, _state,
                                     stand_in_cuda)  # noqa: F401

USERS, BATCH, RPJ = 4, 8, 2


def _events(prof) -> list:
    return [ev for ev in prof.events() if ev.name.startswith(spans.PREFIX)]


def _counts(prof) -> collections.Counter:
    return collections.Counter(ev.name[len(spans.PREFIX):]
                               for ev in _events(prof))


def _assert_flat(prof) -> None:
    for ev in _events(prof):
        parent = ev.cpu_parent
        while parent is not None:
            assert not parent.name.startswith(spans.PREFIX), (ev.name,
                                                              parent.name)
            parent = parent.cpu_parent


def test_no_profiler_gives_the_shared_no_op(monkeypatch):
    def no_record(name):
        raise AssertionError(f"a record was built for {name}")

    monkeypatch.setattr(spans, "_RecordFunctionFast", no_record)
    assert spans.span("session.stage") is spans.OFF
    assert spans.span("engine.replay") is spans.OFF
    with spans.span("engine.noise") as entered:
        assert entered is None
    with pytest.raises(KeyError):
        with spans.span("engine.load"):
            raise KeyError("passes through")


def test_profiler_records_function_scope_events():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("session.stage"):
            torch.ones(3).sum()
        with spans.span("session.finish"):
            pass
    assert spans.span("session.stage") is spans.OFF
    got = _events(prof)
    assert [ev.name for ev in got] == ["distgan.session.stage",
                                       "distgan.session.finish"]
    assert not any(ev.is_user_annotation for ev in got)
    _assert_flat(prof)


def _session(cohort: bool) -> FederationSession:
    rng = np.random.default_rng(0)
    _, sample = digits_like_mixture(list(range(10)), size=8)
    data = sample(rng, 160).reshape(160, -1)
    dataset = dirichlet_partition(data, rng.integers(0, 10, 160), USERS, 0.5)
    participation = (ParticipationSpec("uniform", cohort_size=2) if cohort
                     else ParticipationSpec())
    spec = FederationSpec("approach1", batch_size=BATCH, eval_samples=0,
                          engine=EngineSpec(rounds_per_jit=RPJ),
                          participation=participation)
    return FederationSession(_pair(), tapp.DistGANConfig(num_users=USERS),
                             dataset, spec, device="cpu")


@pytest.mark.parametrize("cohort", [False, True], ids=["fused", "cohort"])
@pytest.mark.parametrize("staging", ["whole", "by_chunk"])
def test_session_spans_a_call_and_runs_the_same_rounds(monkeypatch, cohort,
                                                       staging):
    if staging == "by_chunk":
        monkeypatch.setattr(tsess, "_STAGE_CAP_BYTES", 1)
    plain = _session(cohort)
    want = [plain.run(5), plain.run(3)]
    traced = _session(cohort)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = [traced.run(5), traced.run(3)]
    chunks = 3 + 2                       # 5 and 3 rounds in chunks of 2
    stages = 2 + (chunks if staging == "by_chunk" else 0)
    assert _counts(prof) == {"session.stage": stages, "session.finish": 2}
    _assert_flat(prof)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.g_losses, b.g_losses)
        np.testing.assert_array_equal(a.d_losses, b.d_losses)
        _assert_states_equal(a.state, b.state)


def test_chunk_graphs_span_each_chunk(stand_in_cuda):  # noqa: F811
    fcfg = _fcfg(codec="topk_int8")
    pair = _pair()
    eager = teng.make_eager_engine(pair, fcfg, "approach1")
    graphs = _Rehearsal(
        lambda st, inp, noise: eager(st, inp["reals"], noise)[1],
        resolve_approach("approach1").noise_factory(pair, fcfg),
        lambda st, inp: (st.clone(), {"reals": inp["reals"][:1]}))
    graphs.captured = []
    reals = _reals("approach1", 11, seed=4)
    state = _state("approach1", fcfg)
    lengths = ((0, 4), (4, 1), (5, 4), (9, 2))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for start, k in lengths:
            state, _ = graphs(state, {"reals": reals[start:start + k]})
    assert graphs.captured == [4, 1, 2]
    n = len(lengths)
    assert _counts(prof) == {"engine.noise": n, "engine.load": n,
                             "engine.replay": n, "engine.capture": 3}
    names = [ev.name[len(spans.PREFIX):] for ev in sorted(
        _events(prof), key=lambda ev: ev.time_range.start)]
    new = ["engine.noise", "engine.load", "engine.capture", "engine.replay"]
    again = ["engine.noise", "engine.load", "engine.replay"]
    assert names == new + new + again + new
    _assert_flat(prof)
