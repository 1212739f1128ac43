"""The round noise drawn ahead of a chunk, and the CUDA-graph engines' host
side, on the CPU.

* Each approach's registered noise function consumes the state's host
  generator exactly as its body drew inline before the draws moved into it
  (z1, z2, the stochastic-rounding seed, the ``random`` selection's
  uniforms; approach 3 member by member), bitwise.
* A chunk run on noise drawn ahead of it (as the graph engines do), packed
  through ``NoiseBuffers`` into one buffer and handed to the bodies as
  views, equals the same chunk drawing inline, bitwise: approach 1 with
  codecs ``none``, ``topk_int8`` and stochastic rounding under ``topk`` and
  ``random`` selection, approaches 2, 3, the baseline, ``download_first``,
  and both cohort engines with error feedback and adaptive weights.
* A one-element seed tensor gives the plain codec the codes of the same int
  seed.
* ``_ChunkGraphs`` itself, with a stand-in for ``torch.cuda``'s graph,
  stream and event (capture records the chunk, replay runs it again on the
  static buffers): windows of 4 + 1 and 4 + 2 rounds through graphs of
  lengths 4, 1 and 2 equal 11 eager rounds bitwise, and a carry it did not
  return is copied in and left as it was.  The card tests
  (``tests/test_torch_cuda.py``) hold real graphs to the eager chunk.
"""

import contextlib
import gc

import numpy as np
import pytest
import torch

from repro_torch.core import approaches as tapp
from repro_torch.core import engine as teng
from repro_torch.core import federated as tfed
from repro_torch.core.gan import MLPGanConfig, make_mlp_pair
from repro_torch.core.spec import resolve_approach
from repro_torch.kernels import ref

SMALL = dict(data_dim=64, z_dim=16, g_hidden=32, d_hidden=32)
U, B, K = 3, 8, 3

FUSED = {
    "approach1-none": ("approach1", dict(codec="none")),
    "approach1-topk_int8": ("approach1", dict(codec="topk_int8")),
    "approach1-topk_int8-sr": ("approach1", dict(codec="topk_int8",
                                                 codec_stochastic=True)),
    "approach1-random-int8-sr": ("approach1", dict(
        selection="random", codec="int8", codec_stochastic=True)),
    "approach1-random": ("approach1", dict(selection="random")),
    "approach2": ("approach2", {}),
    "approach3": ("approach3", {}),
    "baseline": ("baseline", {}),
    "download_first-sr": ("download_first", dict(codec="topk_int8",
                                                 codec_stochastic=True)),
}


def _pair():
    return make_mlp_pair(MLPGanConfig(**SMALL))


def _fcfg(**kw):
    return tapp.DistGANConfig(num_users=U, error_feedback=False, **kw)


def _reals(approach, rounds, seed=0, users=U):
    shape = ((rounds, B, SMALL["data_dim"]) if approach == "baseline"
             else (rounds, users, B, SMALL["data_dim"]))
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        -1, 1, shape).astype(np.float32))


def _state(approach, fcfg, seed=0):
    return tapp.init_state(_pair(), fcfg, seed, "cpu",
                           sync_ds=resolve_approach(approach).sync_ds)


def _assert_states_equal(a, b):
    ta, tb = teng.carry_tensors(a), teng.carry_tensors(b)
    assert len(ta) == len(tb)
    for x, y in zip(ta, tb):
        assert torch.equal(x, y)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def _assert_metrics_equal(a, b):
    assert a.keys() == b.keys()
    for key in a:
        assert torch.equal(a[key], b[key]), key


def _before(approach, fcfg, gen, real_shape):
    """What the bodies drew inline before their draws moved into the noise
    functions, in their order."""
    pair = _pair()
    if approach == "approach3":
        out = []
        for _ in range(real_shape[0]):
            out += [pair.sample_z(gen, B), pair.sample_z(gen, B)]
        return {"z1": torch.stack(out[0::2]), "z2": torch.stack(out[1::2])}
    out = {"z1": pair.sample_z(gen, B), "z2": pair.sample_z(gen, B)}
    if fcfg.codec != "none" and fcfg.codec_stochastic:
        out["seed"] = int(torch.randint(0, 2**31 - 1, (), generator=gen))
    if fcfg.selection == "random":
        n = tapp.d_flat_layout(pair).n
        out["uniforms"] = torch.rand((real_shape[0], n), generator=gen,
                                     dtype=torch.float32)
    return out


@pytest.mark.parametrize("case", list(FUSED))
def test_noise_function_consumes_the_generator_as_the_body_did(case):
    approach, kw = FUSED[case]
    fcfg = _fcfg(**kw)
    draw = resolve_approach(approach).noise_factory(_pair(), fcfg)
    real_shape = tuple(_reals(approach, 1).shape[1:])
    g1, g2 = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    for _ in range(2):
        got, want = draw(g1, real_shape), _before(approach, fcfg, g2,
                                                  real_shape)
        assert got.keys() == want.keys()
        for key in want:
            if key == "seed":
                assert got[key].dtype == torch.int32 and \
                    got[key].shape == (1,)
                assert int(got[key]) == want[key]
            else:
                assert torch.equal(got[key], want[key]), key
    assert torch.equal(g1.get_state(), g2.get_state())
    # what a caller gives is passed through and not drawn
    given = draw(torch.Generator().manual_seed(8), real_shape)
    g3 = torch.Generator().manual_seed(9)
    again = draw(g3, real_shape, **given)
    assert all(again[k] is given[k] for k in given)
    assert torch.equal(g3.get_state(),
                       torch.Generator().manual_seed(9).get_state())


def _packed(draws, rounds):
    """The draws through one ``NoiseBuffers`` (one buffer, per-key views),
    as the graph engines hand them to the bodies."""
    buf = teng.NoiseBuffers(draws[0], rounds, "cpu")
    buf.load(draws)
    return buf.round_views()


@pytest.mark.parametrize("case", list(FUSED))
def test_predrawn_noise_equals_inline_draws(case):
    approach, kw = FUSED[case]
    fcfg = _fcfg(**kw)
    pair = _pair()
    chunk = teng.make_eager_engine(pair, fcfg, approach)
    draw = resolve_approach(approach).noise_factory(pair, fcfg)
    reals = _reals(approach, K)
    inline, m_inline = chunk(_state(approach, fcfg), reals)
    ahead = _state(approach, fcfg)
    draws = [draw(ahead.generator, tuple(reals.shape[1:])) for _ in range(K)]
    ahead, m_ahead = chunk(ahead, reals, _packed(draws, K))
    _assert_states_equal(inline, ahead)
    _assert_metrics_equal(m_inline, m_ahead)
    # make_engine on a CPU carry is the eager chunk
    again, m_again = teng.make_engine(pair, fcfg, approach)(
        _state(approach, fcfg), reals)
    _assert_states_equal(inline, again)
    _assert_metrics_equal(m_inline, m_again)


COHORT = {
    "approach1-int8-sr-ef-adaptive": ("approach1", dict(
        codec="topk_int8", codec_stochastic=True, error_feedback=True,
        combiner="staleness_max_abs"), True),
    "approach1-none": ("approach1", dict(codec="none"), False),
    "download_first-int8-ef": ("download_first", dict(
        codec="topk_int8", error_feedback=True), True),
    "approach2": ("approach2", {}, False),
    "approach3": ("approach3", {}, False),
}


def _cohort_inputs(rounds, users, C, adaptive, seed=0):
    rng = np.random.default_rng(seed)
    sched = tfed.make_schedule("uniform", users, C, rounds, rng)
    wts = (torch.from_numpy(tfed.participation_weights(sched, users))
           if adaptive else None)
    return (_reals("approach1", rounds, seed, users=C),
            torch.from_numpy(sched.astype(np.int64)), wts)


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("case", list(COHORT))
def test_predrawn_noise_equals_inline_draws_cohort(case, fuse):
    approach, kw, adaptive = COHORT[case]
    users, C = 6, 3
    fcfg = tapp.DistGANConfig(num_users=users,
                              **{"error_feedback": False, **kw})
    pair = _pair()
    sync = resolve_approach(approach).sync_ds
    chunk = teng.make_eager_cohort_engine(pair, fcfg, approach, adaptive,
                                          copy_carry=not fuse)
    draw = resolve_approach(approach).noise_factory(pair, fcfg)
    reals, idx, wts = _cohort_inputs(K, users, C, adaptive)
    given = teng.init_cohort_state(pair, fcfg, 0, "cpu", sync_ds=sync)
    inline, m_inline = chunk(given, reals, idx, wts)
    ahead = teng.init_cohort_state(pair, fcfg, 0, "cpu", sync_ds=sync)
    draws = [draw(ahead.generator, tuple(reals.shape[1:])) for _ in range(K)]
    ahead, m_ahead = chunk(ahead, reals, idx, wts, _packed(draws, K))
    _assert_states_equal(inline, ahead)
    _assert_metrics_equal(m_inline, m_ahead)
    if not fuse:      # the plain engine left the carry it was given as is
        _assert_states_equal(given, teng.init_cohort_state(
            pair, fcfg, 0, "cpu", sync_ds=sync))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.uint32])
@pytest.mark.parametrize("seed", [0, 5, 2**31 - 2])
def test_tensor_seed_equals_int_seed_in_the_plain_codec(seed, dtype):
    x = torch.from_numpy(np.random.default_rng(seed % 97).normal(
        scale=0.1, size=(5, 3001)).astype(np.float32))
    want = ref.quantize_rows_ref(x, stochastic=True, seed=seed)
    got = ref.quantize_rows_ref(x, stochastic=True,
                                seed=torch.tensor([seed], dtype=dtype))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    rows = torch.arange(5)[:, None].expand(5, 3001)
    cols = torch.arange(3001)[None].expand(5, 3001)
    assert torch.equal(ref.hash_u01(rows, cols, torch.tensor(seed,
                                                             dtype=dtype)),
                       ref.hash_u01(rows, cols, seed))


def test_noise_buffers_pack_every_key_into_one_buffer():
    draws = [{"z1": torch.randn(4, 3), "seed": torch.tensor([r], dtype=torch.int32),
              "uniforms": torch.rand(2, 5), "int_seed": 2**31 - 2 - r}
             for r in range(3)]
    buf = teng.NoiseBuffers(draws[0], 3, "cpu")
    buf.load(draws)
    views = buf.round_views()
    for r, d in enumerate(draws):
        for key in ("z1", "seed", "uniforms"):
            assert torch.equal(views[r][key], d[key])
        assert views[r]["int_seed"].tolist() == [d["int_seed"]]
        for v in views[r].values():
            assert v.untyped_storage().data_ptr() == \
                buf.dev.untyped_storage().data_ptr()
            assert v.data_ptr() % 4 == 0


# ---------------------------------------------------------------------------
# _ChunkGraphs with a stand-in for the CUDA graph
# ---------------------------------------------------------------------------

class _Stream:
    def wait_stream(self, other):
        pass


class _Graph:
    def replay(self):
        self.fn()


@contextlib.contextmanager
def _capturing(graph, stream=None, capture_error_mode="global"):
    # no collection may destroy another graph while this one captures
    assert not gc.isenabled()
    yield


class _Rehearsal(teng._ChunkGraphs):
    """Capture records the chunk (the carry is put back: a real capture
    runs nothing); replay runs it on the graph's static buffers and writes
    the static metrics."""

    def _capture(self, carry, g):
        saved = [t.clone() for t in teng.carry_tensors(carry)]
        g = super()._capture(carry, g)
        for t, s in zip(teng.carry_tensors(carry), saved):
            t.copy_(s)
        noise = g.noise.round_views()

        def fn():
            for key, v in self.rounds_fn(carry, g.inputs, noise).items():
                g.metrics[key].copy_(v)

        g.graph.fn = fn
        self.captured.append(g.noise.rounds)
        return g


@pytest.fixture
def stand_in_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a, **k: _Stream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a, **k: _Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph", _capturing)


def test_chunk_graphs_windows_equal_eager_rounds(stand_in_cuda):
    fcfg = _fcfg(codec="topk_int8", codec_stochastic=True,
                 selection="random")
    pair = _pair()
    eager = teng.make_eager_engine(pair, fcfg, "approach1")
    graphs = _Rehearsal(
        lambda st, inp, noise: eager(st, inp["reals"], noise)[1],
        resolve_approach("approach1").noise_factory(pair, fcfg),
        lambda st, inp: (st.clone(), {"reals": inp["reals"][:1]}))
    graphs.captured = []
    assert gc.isenabled()
    reals = _reals("approach1", 11, seed=4)
    want, m_want = eager(_state("approach1", fcfg), reals)
    state = _state("approach1", fcfg)
    got = []
    for start, k in ((0, 4), (4, 1), (5, 4), (9, 2)):
        state, m = graphs(state, {"reals": reals[start:start + k]})
        got.append({key: v.clone() for key, v in m.items()})
    assert graphs.captured == [4, 1, 2] and gc.isenabled()
    _assert_states_equal(state, want)
    for key in m_want:
        assert torch.equal(torch.cat([m[key] for m in got]), m_want[key])
    # a carry the engine did not return is copied in and left as it was
    other = _state("approach1", fcfg, seed=1)
    fresh = _state("approach1", fcfg, seed=1)
    out, _ = graphs(other, {"reals": reals[:4]})
    assert out is state
    _assert_states_equal(other, fresh)
    ref_state, _ = eager(fresh, reals[:4])
    _assert_states_equal(out, ref_state)


@pytest.mark.parametrize("fuse", [False, True])
def test_cohort_chunk_graphs_equal_eager_rounds(stand_in_cuda, fuse):
    users, C = 6, 3
    fcfg = tapp.DistGANConfig(num_users=users, codec="topk_int8",
                              codec_stochastic=True, error_feedback=True,
                              combiner="staleness_max_abs")
    pair = _pair()
    in_place = teng.make_eager_cohort_engine(pair, fcfg, "approach1", True,
                                             copy_carry=False)
    graphs = _Rehearsal(
        lambda st, inp, noise: in_place(st, inp["reals"], inp["idx"],
                                        inp.get("wts"), noise)[1],
        resolve_approach("approach1").noise_factory(pair, fcfg),
        teng._cohort_scratch, copy_carry=not fuse)
    graphs.captured = []
    reals, idx, wts = _cohort_inputs(7, users, C, True, seed=2)
    want, m_want = in_place(teng.init_cohort_state(pair, fcfg, 0, "cpu",
                                                   sync_ds=True),
                            reals, idx, wts)
    given = teng.init_cohort_state(pair, fcfg, 0, "cpu", sync_ds=True)
    state, got = given, []
    for start, k in ((0, 4), (4, 3)):
        sl = slice(start, start + k)
        state, m = graphs(state, {"reals": reals[sl], "idx": idx[sl],
                                  "wts": wts[sl]})
        got.append({key: v.clone() for key, v in m.items()})
    assert graphs.captured == [4, 3]
    assert (state is given) == fuse
    _assert_states_equal(state, want)
    for key in m_want:
        assert torch.equal(torch.cat([m[key] for m in got]), m_want[key])
    if not fuse:
        _assert_states_equal(given, teng.init_cohort_state(
            pair, fcfg, 0, "cpu", sync_ds=True))


def test_session_stages_long_windows_chunk_by_chunk(monkeypatch):
    """A window over the staging cap goes chunk by chunk and gives the same
    rounds as one staged whole."""
    from repro_torch.core import session as tsess
    from repro_torch.core.session import FederationSession
    from repro_torch.core.spec import EngineSpec, FederationSpec
    from repro_torch.data import digits_like_mixture, dirichlet_partition
    rng = np.random.default_rng(0)
    _, sample = digits_like_mixture(list(range(10)), size=8)
    data = sample(rng, 200).reshape(200, -1)
    dataset = dirichlet_partition(data, rng.integers(0, 10, 200), U, 0.5)

    def run():
        spec = FederationSpec("approach1", batch_size=B, eval_samples=0,
                              engine=EngineSpec(rounds_per_jit=2))
        return FederationSession(_pair(), tapp.DistGANConfig(num_users=U),
                                 dataset, spec, device="cpu").run(5)

    whole = run()
    monkeypatch.setattr(tsess, "_STAGE_CAP_BYTES", 1)
    chunked = run()
    _assert_states_equal(whole.state, chunked.state)
    np.testing.assert_array_equal(whole.g_losses, chunked.g_losses)


def test_cohort_store_stamp_is_the_index_fill_it_replaced():
    store = tfed.CohortStore(torch.zeros(6, 4), torch.zeros(6, 2),
                             torch.arange(6, dtype=torch.int32) * 3)
    want = store.last_round.clone().index_fill_(0, torch.tensor([4, 1]), 9)
    tfed.cohort_scatter(store, torch.tensor([4, 1]),
                        {"w": torch.ones(2, 4)}, {"m": torch.ones(2, 2)},
                        torch.tensor(9),
                        tfed.make_flat_layout({"w": torch.ones(4)}),
                        tfed.make_flat_layout({"m": torch.ones(2)}))
    assert torch.equal(store.last_round, want)
