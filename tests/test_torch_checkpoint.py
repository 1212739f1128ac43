"""Checkpoints of the port held to the reference's format and to the
session's resume contract.

* The port's MessagePack codec writes ``msgpack.packb(...,
  use_bin_type=True)``'s bytes and reads them back; leaves of every dtype
  a session holds (bf16 as its uint16 view) round-trip bitwise.
* ``latest_step``, the atomic write and the reference's shape and
  leaf-count errors.
* ``run(5); save; restore; run(5)`` equals ``run(10)`` BITWISE: fused and
  per-step engines under full participation, the uniform-cohort fused
  store and plain cohort engines with ``topk_int8`` + error feedback +
  stochastic rounding, and the conv pair under W-GAN (batch-norm scales,
  a clipped critic).  Ports of ``tests/test_spec.py``'s autosave and
  mid-window tests.
* Across packages: a checkpoint the JAX session wrote on the CPU restores
  into the port with every array but the PRNG key bitwise and the numpy
  streams, counts and round equal; the port's files decode leaf by leaf
  with the reference's ``_decode_leaf`` and restore through the
  reference's ``restore_checkpoint``.
"""

import json
import os

import jax
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import msgpack_ckpt as jckpt
from repro.core.approaches import DistGANConfig as JaxFcfg
from repro.core.gan import MLPGanConfig as JaxMLPCfg
from repro.core.gan import make_mlp_pair as jax_make_mlp_pair
from repro.core.session import FederationSession as JaxSession
from repro.core.spec import CombineSpec as JCombine
from repro.core.spec import CompressionSpec as JCompression
from repro.core.spec import EngineSpec as JEngine
from repro.core.spec import FederationSpec as JSpec
from repro.core.spec import ParticipationSpec as JParticipation
from repro.data.federated import FederatedDataset as JaxDataset
from repro_torch.checkpoint import (latest_step, read_leaves,
                                    restore_checkpoint, save_checkpoint,
                                    tree_flatten)
from repro_torch.checkpoint.msgpack_codec import pack, unpackb
from repro_torch.core import session as tsession
from repro_torch.core.approaches import DistGANConfig
from repro_torch.core.engine import carry_tensors
from repro_torch.core.gan import (ConvGanConfig, MLPGanConfig,
                                  make_conv_pair, make_mlp_pair)
from repro_torch.core.session import FederationSession
from repro_torch.core.spec import (CombineSpec, CompressionSpec, EngineSpec,
                                   FederationSpec, ParticipationSpec)
from repro_torch.data import FederatedDataset, make_user_domains

PAIR = make_mlp_pair(MLPGanConfig(data_dim=2, z_dim=8, g_hidden=32,
                                  d_hidden=32))


def _ds(num_users, cls=FederatedDataset):
    users, union = make_user_domains(num_users, 2, 1.0)
    return cls([u.sample for u in users], union.sample,
               {"shard_sizes": [100 * (u + 1) for u in range(num_users)]})


# ---------------------------------------------------------------------------
# The codec and the checkpoint files
# ---------------------------------------------------------------------------

CODEC_OBJECTS = {
    "scalars": [None, True, False, 0.25, -1.5e300, "", "é" * 40],
    "ints": [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
             -1, -32, -33, -128, -129, -2**15 - 1, -2**31 - 1, -2**63],
    "lengths": ["s" * 31, "s" * 32, "s" * 256, b"", b"b" * 256,
                b"b" * 70000, list(range(16)), {str(i): i for i in range(16)}],
    "payload": {"treedef": "[*]", "leaves": [
        {"dtype": "float32", "shape": [2, 3],
         "data": np.arange(6, dtype=np.float32).tobytes()}]},
}


@pytest.mark.parametrize("case", list(CODEC_OBJECTS))
def test_codec_writes_msgpack_bytes_and_reads_them(case):
    obj = CODEC_OBJECTS[case]
    want = msgpack.packb(obj, use_bin_type=True)
    parts = []
    pack(obj, parts.append)
    assert b"".join(bytes(p) for p in parts) == want
    assert unpackb(want) == msgpack.unpackb(want, raw=False)


LEAVES = {
    "float32": torch.randn(3, 4, generator=torch.Generator().manual_seed(0)),
    "int32": torch.arange(-5, 7, dtype=torch.int32).reshape(3, 4),
    "uint8": torch.Generator().manual_seed(5).get_state(),
    "int8": torch.arange(-128, 128, dtype=torch.int8),
    "bfloat16": (torch.randn(5, 2, generator=torch.Generator().manual_seed(1))
                 .to(torch.bfloat16)),
    "scalar": torch.tensor(7, dtype=torch.int32),
}


@pytest.mark.parametrize("dtype", list(LEAVES))
def test_leaf_round_trips_bitwise(tmp_path, dtype):
    x = LEAVES[dtype]
    tree = {"b": [x, None], "a": x * 0}
    save_checkpoint(str(tmp_path), 3, tree)
    got = restore_checkpoint(str(tmp_path), 3, tree, device="cpu")
    assert got["b"][1] is None
    for g, w in ((got["b"][0], x), (got["a"], x * 0)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.view(torch.uint8) if g.ndim else g,
                           w.view(torch.uint8) if w.ndim else w)


def test_leaf_order_is_the_reference_tree_order(tmp_path):
    """Dict keys sorted, sequences in order, None no leaf: the order
    ``jax.tree.leaves`` gives the same tree."""
    tree = {"z": [np.ones(1), None, (np.zeros(2), np.full(3, 2.0))],
            "a": {"y": np.arange(4.0), "b": np.arange(5.0)}}
    got = [a.shape for a in tree_flatten(tree)]
    assert got == [np.shape(a) for a in jax.tree.leaves(tree)]


def test_latest_step_atomic_write_and_errors(tmp_path):
    d = str(tmp_path / "ck")
    assert latest_step(d) is None
    tree = {"w": torch.ones(2, 3), "step": torch.tensor(1, dtype=torch.int32)}
    for step in (5, 12, 7):
        path = save_checkpoint(d, step, tree)
        assert os.path.basename(path) == f"step_{step:08d}.msgpack"
    open(os.path.join(d, "step_00000099.msgpack.tmp"), "wb").close()
    assert latest_step(d) == 12
    assert sorted(os.listdir(d)) == ["step_00000005.msgpack",
                                     "step_00000007.msgpack",
                                     "step_00000012.msgpack",
                                     "step_00000099.msgpack.tmp"]
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(d, 12, {"w": torch.ones(3, 2),
                                   "step": torch.tensor(0)}, device="cpu")
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(d, 12, {"w": torch.ones(2, 3)}, device="cpu")
    got = restore_checkpoint(d, 12, {"w": torch.zeros(2, 3, dtype=torch.float64),
                                     "step": torch.tensor(0)}, device="cpu")
    assert got["w"].dtype == torch.float64          # cast to the target's


def test_port_file_decodes_with_the_reference(tmp_path):
    """Each stored leaf, read with msgpack and the reference's
    ``_decode_leaf``, is the port's array; the reference's
    ``restore_checkpoint`` reads a port file into its own tree."""
    tree = {name: x for name, x in LEAVES.items()}
    save_checkpoint(str(tmp_path), 1, tree)
    with open(tmp_path / "step_00000001.msgpack", "rb") as f:
        payload = msgpack.unpackb(f.read(), raw=False)
    for d, (name, x) in zip(payload["leaves"], sorted(tree.items())):
        got = np.asarray(jckpt._decode_leaf(d))
        want = x.float() if x.dtype == torch.bfloat16 else x
        np.testing.assert_array_equal(got.astype(np.float64),
                                      want.numpy().astype(np.float64))
    target = jax.tree.map(lambda x: np.zeros(x.shape, np.float32),
                          {k: v for k, v in tree.items() if k != "bfloat16"})
    save_checkpoint(str(tmp_path / "f"), 2, {
        k: v for k, v in tree.items() if k != "bfloat16"})
    back = jckpt.restore_checkpoint(str(tmp_path / "f"), 2, target)
    for k, v in back.items():
        np.testing.assert_array_equal(np.asarray(v),
                                      tree[k].numpy().astype(np.float32))


# ---------------------------------------------------------------------------
# Session save / restore / autosave
# ---------------------------------------------------------------------------

def _spec(kind):
    if kind.startswith("cohort"):
        return FederationSpec(
            "approach1", batch_size=8, seed=3, eval_samples=0,
            engine=EngineSpec(rounds_per_jit=4,
                              fuse_store_rounds=kind == "cohort_fused_store"),
            participation=ParticipationSpec("uniform", cohort_size=2),
            combine=CombineSpec("staleness_max_abs", compression=
                                CompressionSpec("topk_int8",
                                                error_feedback=True,
                                                stochastic=True)))
    approach = "approach2" if kind == "per_step" else "approach1"
    return FederationSpec(approach, batch_size=8, seed=3, eval_samples=0,
                          engine=EngineSpec(kind=kind, rounds_per_jit=4))


def _same_state(a, b):
    ta, tb = carry_tensors(a._driver.state), carry_tensors(b._driver.state)
    return len(ta) == len(tb) and all(torch.equal(x, y)
                                      for x, y in zip(ta, tb)) and \
        torch.equal(a._driver.state.generator.get_state(),
                    b._driver.state.generator.get_state())


@pytest.mark.parametrize("kind", ["fused", "per_step", "cohort_fused_store",
                                  "cohort_plain"])
def test_save_restore_resumes_bitwise(tmp_path, kind):
    U = 4
    fcfg = DistGANConfig(num_users=U, upload_frac=0.3)
    full = FederationSession(PAIR, fcfg, _ds(U), _spec(kind), device="cpu")
    want = full.run(10)
    s1 = FederationSession(PAIR, fcfg, _ds(U), _spec(kind), device="cpu")
    w1 = s1.run(5)
    s1.save(str(tmp_path))
    meta = json.loads((tmp_path / "session.json").read_text())
    assert sorted(meta) == ["data_rng", "format", "num_users", "part_counts",
                            "round", "sched_rng", "spec"]
    s2 = FederationSession.restore(str(tmp_path), PAIR, fcfg, _ds(U),
                                   device="cpu")
    assert s2.round == 5 and s2.spec == s1.spec
    w2 = s2.run(5)
    np.testing.assert_array_equal(np.concatenate([w1.g_losses, w2.g_losses]),
                                  want.g_losses)
    np.testing.assert_array_equal(np.concatenate([w1.d_losses, w2.d_losses]),
                                  want.d_losses)
    if kind.startswith("cohort"):
        np.testing.assert_array_equal(
            np.concatenate([w1.extra["schedule"], w2.extra["schedule"]]),
            want.extra["schedule"])
        np.testing.assert_array_equal(w2.extra["staleness"],
                                      want.extra["staleness"])
    assert _same_state(s2, full)


def test_conv_wgan_session_resumes_bitwise(tmp_path):
    """The conv pair's batch-norm scales and a clipped W-GAN critic
    round-trip with the rest of the state (approach 3, so every critic
    trains)."""
    pair = make_conv_pair(ConvGanConfig(image_size=8, channels=1, z_dim=4,
                                        base_filters=2))
    rng = np.random.default_rng(0)
    imgs = [rng.uniform(-1, 1, (40, 8, 8, 1)).astype(np.float32)
            for _ in range(2)]
    ds = FederatedDataset(
        [lambda r, n, x=x: x[r.integers(0, len(x), n)] for x in imgs],
        lambda r, n: imgs[0][r.integers(0, 40, n)], {})
    fcfg = DistGANConfig(num_users=2, loss_type="wgan", d_lr=5e-4,
                         g_lr=1e-4, b1=0.0)
    spec = FederationSpec("approach3", batch_size=4, eval_samples=0,
                          engine=EngineSpec(rounds_per_jit=2))
    full = FederationSession(pair, fcfg, ds, spec, device="cpu")
    want = full.run(4)
    s1 = FederationSession(pair, fcfg, ds, spec, device="cpu")
    w1 = s1.run(2)
    s1.save(str(tmp_path))
    s2 = FederationSession.restore(str(tmp_path), pair, fcfg, ds,
                                   device="cpu")
    w2 = s2.run(2)
    np.testing.assert_array_equal(np.concatenate([w1.g_losses, w2.g_losses]),
                                  want.g_losses)
    assert _same_state(s2, full)
    assert all(float(t.abs().max()) <= np.float32(0.05)
               for t in tree_flatten(s2._driver.state.ds))


def test_restore_skips_fresh_state_init(tmp_path, monkeypatch):
    """restore() builds the state once, from the restored arrays: no fresh
    initial state (no (U, N) store) is drawn first."""
    fcfg = DistGANConfig(num_users=4, upload_frac=0.3)
    sess = FederationSession(PAIR, fcfg, _ds(4), _spec("cohort_fused_store"),
                             device="cpu")
    sess.run(4)
    sess.save(str(tmp_path))

    def boom(*a, **k):
        raise AssertionError("restore drew a fresh initial state")
    monkeypatch.setattr(tsession, "init_cohort_state", boom)
    monkeypatch.setattr(tsession, "init_state", boom)
    restored = FederationSession.restore(str(tmp_path), PAIR, fcfg, _ds(4),
                                         device="cpu")
    assert np.all(np.isfinite(restored.run(4).g_losses))


def test_autosave_killed_run_resumes_from_last_autosave(tmp_path):
    """Port of the reference's autosave test: autosave is neutral, and a
    run killed mid-way restores from its last autosave onto the
    uninterrupted trajectory."""
    U, C = 4, 2
    fcfg = DistGANConfig(num_users=U, selection="topk", upload_frac=0.3)
    spec = FederationSpec(
        approach="approach1", batch_size=8, seed=0, eval_samples=0,
        engine=EngineSpec(rounds_per_jit=4),
        participation=ParticipationSpec("uniform", cohort_size=C))
    full = FederationSession(PAIR, fcfg, _ds(U), spec, device="cpu").run(10)

    path_ok = str(tmp_path / "ok")
    s_ok = FederationSession(PAIR, fcfg, _ds(U), spec, device="cpu")
    r_ok = s_ok.run(10, autosave_every=3, autosave_path=path_ok)
    np.testing.assert_array_equal(r_ok.g_losses, full.g_losses)
    np.testing.assert_array_equal(r_ok.extra["schedule"],
                                  full.extra["schedule"])
    assert r_ok.extra["participation_counts"].sum() == 10 * C
    assert latest_step(path_ok) == 10
    assert FederationSession.restore(path_ok, PAIR, fcfg, _ds(U),
                                     device="cpu").round == 10

    # the data source dies in the third window (rounds 6-8): the probe
    # draws 2 batches, each window 3 x 2
    healthy = _ds(U)
    calls = {"n": 0}

    def flaky_user(u):
        def sample(rng, n):
            calls["n"] += 1
            if calls["n"] > 16:
                raise ConnectionError("data source died")
            return healthy.samplers[u](rng, n)
        return sample

    flaky_ds = FederatedDataset([flaky_user(u) for u in range(U)],
                                healthy.union_sampler, healthy.meta)
    path = str(tmp_path / "killed")
    s_kill = FederationSession(PAIR, fcfg, flaky_ds, spec, device="cpu")
    with pytest.raises(ConnectionError):
        s_kill.run(10, autosave_every=3, autosave_path=path)
    with pytest.raises(RuntimeError, match="mid-window"):
        s_kill.save(str(tmp_path / "bad"))

    restored = FederationSession.restore(path, PAIR, fcfg, _ds(U),
                                         device="cpu")
    assert restored.round == 6
    got = restored.run(4)
    np.testing.assert_array_equal(got.g_losses, full.g_losses[6:])
    np.testing.assert_array_equal(got.d_losses, full.d_losses[6:])
    np.testing.assert_array_equal(got.extra["schedule"],
                                  full.extra["schedule"][6:])


def test_save_refuses_after_mid_window_failure(tmp_path):
    """Port of the reference's test: a run() that dies mid-window leaves
    the streams and carry past the round counter, so save() refuses; a
    clean window re-arms it."""
    calls = {"n": 0}

    def flaky(rng, n):
        calls["n"] += 1
        if calls["n"] > 8:
            raise ConnectionError("data source died")
        return np.zeros((n, 2), np.float32)

    ds = FederatedDataset([flaky] * 4, flaky, {"shard_sizes": [1] * 4})
    fcfg = DistGANConfig(num_users=4, selection="topk", upload_frac=0.3)
    spec = FederationSpec(
        approach="approach1", batch_size=8, eval_samples=0,
        engine=EngineSpec(rounds_per_jit=2),
        participation=ParticipationSpec("round_robin", cohort_size=2))
    sess = FederationSession(PAIR, fcfg, ds, spec, device="cpu")
    with pytest.raises(ConnectionError):
        sess.run(10)
    with pytest.raises(RuntimeError, match="mid-window"):
        sess.save(str(tmp_path / "bad"))
    calls["n"] = -10_000
    sess2 = FederationSession(PAIR, fcfg, ds, spec, device="cpu")
    sess2.run(2)
    sess2.save(str(tmp_path / "good"))
    assert latest_step(str(tmp_path / "good")) == 2


def test_restore_checks_users_and_autosave_arguments(tmp_path):
    sess = FederationSession(PAIR, DistGANConfig(num_users=3), _ds(3),
                             _spec("fused"), device="cpu")
    sess.run(1)
    sess.save(str(tmp_path))
    with pytest.raises(ValueError, match="num_users"):
        FederationSession.restore(str(tmp_path), PAIR,
                                  DistGANConfig(num_users=4), _ds(4),
                                  device="cpu")
    with pytest.raises(ValueError, match="autosave_path"):
        sess.run(2, autosave_every=1)
    with pytest.raises(ValueError, match="positive int"):
        sess.run(2, autosave_every=0, autosave_path=str(tmp_path))


# ---------------------------------------------------------------------------
# Across packages
# ---------------------------------------------------------------------------

JPAIR = jax_make_mlp_pair(JaxMLPCfg(data_dim=2, z_dim=8, g_hidden=32,
                                    d_hidden=32))


@pytest.mark.parametrize("kind", ["fused", "cohort_fused_store"])
def test_reference_checkpoint_restores_into_the_port(tmp_path, kind):
    """The JAX session's checkpoint (on the CPU) restores into the port:
    every array but the PRNG key bitwise, the numpy streams, counts and
    round equal; the port's generator is seeded from the spec's seed and
    the round, and the session runs on."""
    U = 4
    port_spec = _spec(kind)
    jspec = JSpec.from_dict(port_spec.to_dict())
    assert isinstance(jspec.engine, JEngine) and \
        isinstance(jspec.participation, JParticipation) and \
        isinstance(jspec.combine, JCombine) and \
        isinstance(jspec.combine.compression, JCompression)
    jsess = JaxSession(JPAIR, JaxFcfg(num_users=U, upload_frac=0.3),
                       _ds(U, JaxDataset), jspec)
    jsess.run(3)
    jsess.save(str(tmp_path))
    want = jax.tree.leaves(jsess._driver.arrays())

    sess = FederationSession.restore(str(tmp_path), PAIR,
                                     DistGANConfig(num_users=U,
                                                   upload_frac=0.3),
                                     _ds(U), device="cpu")
    got = tree_flatten(sess._driver.arrays())
    assert len(got) == len(want)
    for g, w in zip(got[:-1], want[:-1]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert str(g.numpy().dtype) == str(np.asarray(w).dtype)
    assert sess.round == jsess.round == 3
    assert sess.data_rng.bit_generator.state == \
        jsess.data_rng.bit_generator.state
    assert sess.sched_rng.bit_generator.state == \
        jsess.sched_rng.bit_generator.state
    seeded = torch.Generator().manual_seed(
        tsession.resume_generator_seed(port_spec.seed, 3))
    assert torch.equal(sess._driver.state.generator.get_state(),
                       seeded.get_state())
    res = sess.run(2)
    assert np.all(np.isfinite(res.g_losses)) and sess.round == 5


def test_reference_step_file_leaves_line_up_with_the_port(tmp_path):
    """The reference's file and the port's, for the same spec, hold the
    same number of leaves with the same shapes and dtypes, the key slot
    aside (jax key data there, the generator state here)."""
    U = 3
    spec = _spec("cohort_fused_store")
    jsess = JaxSession(JPAIR, JaxFcfg(num_users=U, upload_frac=0.3),
                       _ds(U, JaxDataset), JSpec.from_dict(spec.to_dict()))
    jsess.run(1)
    jsess.save(str(tmp_path / "j"))
    sess = FederationSession(PAIR, DistGANConfig(num_users=U,
                                                 upload_frac=0.3),
                             _ds(U), spec, device="cpu")
    sess.run(1)
    sess.save(str(tmp_path / "t"))
    jl, tl = (read_leaves(str(tmp_path / d), 1) for d in ("j", "t"))
    assert len(jl) == len(tl)
    for a, b in list(zip(jl, tl))[:-1]:
        assert (a.shape, a.dtype) == (b.shape, b.dtype)
    assert jl[-1].dtype == torch.uint32 and tl[-1].dtype == torch.uint8
