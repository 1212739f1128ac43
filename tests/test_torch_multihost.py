"""The port's multihost backend (``repro_torch.multihost``) held to the JAX
reference's (``repro.multihost``) on the CPU, on the reference test's toy
pair (MLP 2 -> 16 -> 16, z 8, U 16, a uniform cohort of 4, 2 workers).

* Frames and files: the port's ``send_frame`` bytes are the reference's
  ``msgpack`` frames for gather, scatter, push, meta, ping and error
  objects, and each side decodes the other's; shard files are byte
  identical.  The failure paths are the reference's: torn header or
  payload, oversized frame, clean close, one dropped call retried,
  retries exhausted, a killed worker raising ``WorkerDied`` in budget.
* ``partition_users`` and ``wire`` (the numpy codec, pack / unpack, the
  ``priced_*`` composition) equal the reference's.
* Across processes: the port's ``MultihostStateBackend`` drives a fleet of
  the reference's workers, the reference's ``RpcClient`` a port worker.
* Sessions: the port's multihost session against the reference's on the
  f32 and the int8 wire, from the reference's initial state with its
  draws: losses per round and the final store within ATOL = 1e-5 (the
  tolerance of ``tests/test_torch_stream.py``), ``last_round`` and ages
  bitwise.  Inside the port, multihost equals the host backend bitwise on
  the f32 wire; on the int8 wire the device codec's product scale is not
  a fixed point of the wire's quotient codec, so the two are held within
  tolerance and a test shows the moved scales.  Save at 2 workers,
  restore at 3 and at 1, each continuing bitwise; a checkpoint the
  reference wrote restores at 3 workers and tracks the reference's own
  continuation.

The reference's sessions run once for the module (their jit compiles
dominate the file), its workers and the port's in one fleet each.
"""

import os
import socket
import struct
import threading
import time

import jax
import msgpack
import numpy as np
import pytest
import torch

from repro.core.approaches import DistGANConfig as JConfig
from repro.core.gan import MLPGanConfig as JMLPConfig
from repro.core.gan import make_mlp_pair as jax_make_mlp_pair
from repro.core.session import FederationSession as JSession
from repro.core.spec import FederationSpec as JSpec
from repro.data.federated import FederatedDataset as JDataset
from repro.multihost import launch as jlaunch
from repro.multihost import rpc as jrpc
from repro.multihost import wire as jwire
from repro_torch.convert import shared_from_numpy
from repro_torch.core import session as tsess
from repro_torch.core.approaches import (DistGANConfig, d_flat_layout,
                                         d_opt_flat_layout)
from repro_torch.core.federated import HostStateBackend
from repro_torch.core.gan import MLPGanConfig, make_mlp_pair
from repro_torch.core.session import FederationSession
from repro_torch.core.spec import (BackendSpec, CombineSpec, CompressionSpec,
                                   FederationSpec, ParticipationSpec)
from repro_torch.data import FederatedDataset, make_user_domains
from repro_torch.kernels import ops as kops
from repro_torch.models.common import tree_leaves
from repro_torch.multihost import wire
from repro_torch.multihost.backend import MultihostStateBackend
from repro_torch.multihost.launch import launch_local_workers, partition_users
from repro_torch.multihost.rpc import (RpcClient, RpcError, RpcTimeout,
                                       TornFrame, WorkerDied, recv_frame,
                                       send_frame)
from repro_torch.multihost.worker import shard_filename

SMALL = dict(data_dim=2, z_dim=8, g_hidden=16, d_hidden=16)
PAIR = make_mlp_pair(MLPGanConfig(**SMALL))
JPAIR = jax_make_mlp_pair(JMLPConfig(**SMALL))
U, C, B, ROUNDS, HALF = 16, 4, 16, 6, 3
ATOL = 1e-5
WIRES = {"f32_wire": False, "int8_wire": True}


def _ds():
    users, union = make_user_domains(U, 2, 1.0)
    return FederatedDataset([u.sample for u in users], union.sample,
                            {"shard_sizes": [100] * U})


def _jds():
    ds = _ds()
    return JDataset(ds.samplers, ds.union_sampler, ds.meta)


def _fcfg(pkg=DistGANConfig):
    return pkg(num_users=U, selection="topk", upload_frac=0.5)


def _spec(kind, compressed=False, **backend_kw):
    comb = CombineSpec()
    if compressed:
        comb = CombineSpec(compression=CompressionSpec(
            codec="topk_int8", error_feedback=True, stage_rows=True))
    return FederationSpec(
        approach="approach1", batch_size=B, seed=3, eval_samples=0,
        participation=ParticipationSpec(scheduler="uniform", cohort_size=C),
        backend=BackendSpec(kind=kind, **backend_kw), combine=comb)


def _session(kind, compressed, **backend_kw):
    return FederationSession(PAIR, _fcfg(), _ds(),
                             _spec(kind, compressed, **backend_kw),
                             device="cpu")


def _store(be) -> dict:
    snap = be.snapshot()
    return {name: None if getattr(snap, name) is None
            else np.array(getattr(snap, name))
            for name in ("d_flat", "opt_flat", "last_round", "residual")}


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               rtol=0)


# ---------------------------------------------------------------------------
# The reference's sessions, once for the module
# ---------------------------------------------------------------------------

def _draws(key, steps, lossy):
    """The z draws the reference's rows engine takes from carry key
    ``key`` over ``steps`` rounds (approach 1, deterministic rounding), as
    the port's rows engine takes them (``tests/test_torch_stream.py``)."""
    out = []
    for _ in range(steps):
        keys = jax.random.split(key, 5 if lossy else 4)
        out.append({
            "z1": torch.from_numpy(np.array(JPAIR.sample_z(keys[1], B))),
            "z2": torch.from_numpy(np.array(JPAIR.sample_z(keys[2], B))),
            "seed": None})
        key = keys[0]
    return out


def _injecting(eng, draws):
    it = iter(draws)
    return lambda *args: eng(*args, noise=next(it))


def _shared_np(sh) -> dict:
    return {"g": jax.tree.map(np.asarray, sh.g),
            "g_opt": jax.tree.map(np.asarray, sh.g_opt),
            "server_d": jax.tree.map(np.asarray, sh.server_d),
            "step": np.asarray(sh.step)}


def _ref_window(js, rounds) -> dict:
    r = js.run(rounds)
    return {"g": r.g_losses, "d": r.d_losses, "age": r.extra["mean_age"],
            "kept": r.extra["kept_frac"]}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's multihost sessions: each wire from its start (the
    initial shared state, store and key recorded), 6 rounds; the int8
    wire saved after 3 and restored at 3 workers for 3 more."""
    ckpt = str(tmp_path_factory.mktemp("ref_multihost") / "ckpt")
    out = {}
    for wname, compressed in WIRES.items():
        jspec = JSpec.from_json(_spec("multihost", compressed,
                                      workers=2).to_json())
        js = JSession(JPAIR, _fcfg(JConfig), _jds(), jspec)
        try:
            drv = js._driver
            run = {"shared": _shared_np(drv.shared), "key": drv.shared.key,
                   "store": _store(drv.backend)}
            if compressed:
                first = _ref_window(js, HALF)
                js.save(ckpt)
                second = _ref_window(js, HALF)
                run["windows"] = {k: np.concatenate([first[k], second[k]])
                                  if k != "kept" else second[k]
                                  for k in first}
            else:
                run["windows"] = _ref_window(js, ROUNDS)
            run["final"] = _store(drv.backend)
        finally:
            js.close()
        out[wname] = run
    back = JSession.restore(ckpt, JPAIR, _fcfg(JConfig), _jds(), workers=3)
    try:
        out["restored"] = {"key": back._driver.shared.key,
                           "windows": _ref_window(back, HALF),
                           "final": _store(back._driver.backend)}
    finally:
        back.close()
    out["ckpt"] = ckpt
    return out


def _port_from_reference(run, compressed, rounds):
    """A port multihost session started from the reference's initial
    shared state and store, fed its draws."""
    sess = _session("multihost", compressed, workers=2)
    drv = sess._driver
    drv.shared = shared_from_numpy(run["shared"], "cpu")
    s = run["store"]
    drv.backend.push_store(HostStateBackend(s["d_flat"], s["opt_flat"],
                                            s["last_round"], s["residual"]))
    drv.eng = _injecting(drv.eng, _draws(run["key"], rounds, compressed))
    return sess


def _held_to(res, store, want_windows, want_store):
    w = want_windows
    _close(res.g_losses, w["g"])
    _close(res.d_losses, w["d"])
    np.testing.assert_array_equal(res.extra["mean_age"], w["age"])
    for name in ("d_flat", "opt_flat", "residual"):
        if want_store[name] is None:
            assert store[name] is None
        else:
            _close(store[name], want_store[name])
    np.testing.assert_array_equal(store["last_round"],
                                  want_store["last_round"])


@pytest.mark.parametrize("wname", list(WIRES))
def test_multihost_session_tracks_the_references(ref, wname):
    """Six rounds of the port's multihost session against the reference's
    on the same wire, from its initial state with its draws: losses and
    ages per round, kept fractions, the final store; measured payload
    bytes equal the priced bytes every round."""
    compressed = WIRES[wname]
    run = ref[wname]
    sess = _port_from_reference(run, compressed, ROUNDS)
    try:
        if compressed:
            res = sess.run(HALF)
            res2 = sess.run(HALF)
            res.g_losses = np.concatenate([res.g_losses, res2.g_losses])
            res.d_losses = np.concatenate([res.d_losses, res2.d_losses])
            res.extra["mean_age"] = np.concatenate(
                [res.extra["mean_age"], res2.extra["mean_age"]])
        else:
            res = sess.run(ROUNDS)
        be = sess._driver.backend
        _held_to(res, _store(be), run["windows"], run["final"])
        np.testing.assert_allclose(res.extra["kept_frac"] if not compressed
                                   else res2.extra["kept_frac"],
                                   run["windows"]["kept"], atol=1e-6, rtol=0)
        nd, no = d_flat_layout(PAIR).n, d_opt_flat_layout(PAIR, _fcfg()).n
        assert be.round_payload_bytes == ROUNDS * wire.priced_round_nbytes(
            C, nd, no, stage_codec="int8" if compressed else "none",
            has_residual=compressed)
        assert be.socket_bytes > be.round_payload_bytes
    finally:
        sess.close()


@pytest.mark.parametrize("wname", list(WIRES))
def test_multihost_matches_host_backend(wname):
    """The same spec and seed on the port's host backend: bitwise on the
    f32 wire (losses, the whole store); on the int8 wire within ATOL (a
    moved scale puts a row a code step off; none moves in these rows)."""
    compressed = WIRES[wname]
    rh = _session("host", compressed).run(ROUNDS)
    sess = _session("multihost", compressed, workers=2)
    try:
        rm = sess.run(ROUNDS)
        assert rm.extra["state_backend"] == "multihost"
        assert not rm.extra["fused_store"]
        assert rm.extra["compression"]["stage_rows"] == compressed
        want, got = _store(rh.extra["host_backend"]), _store(
            rm.extra["host_backend"])
        if compressed:
            _close(rm.g_losses, rh.g_losses)
            _close(rm.d_losses, rh.d_losses)
            for name in ("d_flat", "opt_flat", "residual"):
                _close(got[name], want[name])
            np.testing.assert_array_equal(got["last_round"],
                                          want["last_round"])
        else:
            np.testing.assert_array_equal(rm.g_losses, rh.g_losses)
            np.testing.assert_array_equal(rm.d_losses, rh.d_losses)
            for name in ("d_flat", "opt_flat", "last_round"):
                np.testing.assert_array_equal(got[name], want[name])
        for a, b in zip(tree_leaves(rm.state.ds), tree_leaves(rh.state.ds)):
            _close(a.numpy(), b.numpy())
    finally:
        sess.close()


def test_int8_wire_is_not_a_fixed_point_of_the_device_codec():
    """Why the int8 wire is held within tolerance: B2 (the reference's
    jitted codec) scales by ``max|x| * f32(1/127)``; the host dequantizes
    its codes and the wire quantizes the rows again with the numpy
    quotient ``max / 127``, which moves the scale of some rows (and so
    every code step of the row).  Rows the wire codec itself dequantized
    come back unchanged."""
    x = np.random.default_rng(7).normal(size=(4000, 64)).astype(np.float32)
    q, s = kops.quantize_rows(torch.from_numpy(x))
    rows = tsess._np_dequantize_rows(q.numpy(), s.numpy())
    wq, ws = wire.np_quantize_rows(rows)
    moved = ws != s.numpy()
    assert moved.sum() == 30                      # 0.75 % of the rows
    # a row comes back other than it went exactly where its scale moved
    back = wire.np_dequantize_rows(wq, ws)
    np.testing.assert_array_equal(np.any(back != rows, axis=1), moved)
    again = wire.np_quantize_rows(wire.np_dequantize_rows(wq, ws))
    np.testing.assert_array_equal(again[0], wq)
    np.testing.assert_array_equal(again[1], ws)


def test_save_restore_across_worker_count_change(tmp_path):
    """Save at W = 2 after 3 rounds of the int8 wire, restore at W = 3 and
    at W = 1: each continuation equals the uninterrupted run bitwise
    (losses, store, residual, ages)."""
    path = str(tmp_path / "ckpt")
    sess = _session("multihost", True, workers=2)
    try:
        sess.run(HALF)
        sess.save(path)
        whole = sess.run(HALF)
        want = _store(sess._driver.backend)
    finally:
        sess.close()
    files = sorted(os.listdir(os.path.join(path, f"shards_{HALF:08d}")))
    assert files == [shard_filename(0, 8), shard_filename(8, 16),
                     "shards.json"]
    for w in (3, 1):
        back = FederationSession.restore(path, PAIR, _fcfg(), _ds(),
                                         device="cpu", workers=w)
        try:
            assert len(back._driver._fleet.workers) == w
            r = back.run(HALF)
            np.testing.assert_array_equal(r.g_losses, whole.g_losses)
            np.testing.assert_array_equal(r.d_losses, whole.d_losses)
            np.testing.assert_array_equal(r.extra["mean_age"],
                                          whole.extra["mean_age"])
            got = _store(back._driver.backend)
            for name in want:
                np.testing.assert_array_equal(got[name], want[name])
        finally:
            back.close()


def test_restores_a_reference_multihost_checkpoint(ref):
    """The reference's int8-wire checkpoint (saved at W = 2, round 3)
    restores into the port at W = 3; fed the reference's draws from its
    restored key, the next 3 rounds track the reference's own W = 3
    continuation."""
    sess = FederationSession.restore(ref["ckpt"], PAIR, _fcfg(), _ds(),
                                     device="cpu", workers=3)
    try:
        assert sess.round == HALF
        drv = sess._driver
        drv.eng = _injecting(drv.eng, _draws(ref["restored"]["key"], HALF,
                                             True))
        res = sess.run(HALF)
        _held_to(res, _store(drv.backend), ref["restored"]["windows"],
                 ref["restored"]["final"])
    finally:
        sess.close()


def test_restore_workers_override_rejected_for_host(tmp_path):
    path = str(tmp_path / "ckpt")
    sess = _session("host", False)
    sess.run(2)
    sess.save(path)
    with pytest.raises(ValueError, match="multihost"):
        FederationSession.restore(path, PAIR, _fcfg(), _ds(), device="cpu",
                                  workers=2)


def test_backend_spec_worker_field_validation():
    """The reference's checks, and its manifests read as they are."""
    with pytest.raises(ValueError, match="workers"):
        BackendSpec(kind="multihost")
    with pytest.raises(ValueError, match="workers"):
        BackendSpec(kind="multihost", workers=0)
    with pytest.raises(ValueError, match="one process"):
        BackendSpec(kind="host", workers=2)
    with pytest.raises(ValueError, match="rpc_timeout_s"):
        BackendSpec(kind="multihost", workers=2, rpc_timeout_s=0)
    with pytest.raises(ValueError, match="rpc_retries"):
        BackendSpec(kind="multihost", workers=2, rpc_retries=-1)
    with pytest.raises(ValueError, match="empty shard"):
        _spec("multihost", workers=U + 1).validate_against(U)
    sp = _spec("multihost", workers=2, rpc_timeout_s=5.0, rpc_retries=1)
    assert FederationSpec.from_json(JSpec.from_json(
        sp.to_json()).to_json()) == sp
    assert FederationSpec.from_dict(sp.to_dict()).backend.rpc_retries == 1


# ---------------------------------------------------------------------------
# Frames, byte for byte
# ---------------------------------------------------------------------------

class _Sink:
    def __init__(self):
        self.data = b""

    def sendall(self, b):
        self.data += bytes(b)


def _frames() -> dict:
    rng = np.random.default_rng(0)
    rows = rng.normal(size=(20, 1000)).astype(np.float32)   # 80 kB: bin32
    idx = np.arange(4, dtype=np.int32).tobytes()
    return {
        "gather": {"method": "gather", "idx": idx, "codec": "none"},
        "gather_ret": {"ret": {"d": jwire.pack_rows(rows, "int8"),
                               "opt": jwire.pack_rows(rows[:3], "none"),
                               "last": idx}},
        "scatter": {"method": "scatter", "idx": idx,
                    "d": jwire.pack_rows(rows, "int8"),
                    "opt": jwire.pack_rows(rows, "none"), "round_idx": 70000,
                    "res": jwire.pack_rows(rows[:2], "none")},
        "push": {"method": "push_rows", "off": 0,
                 "d": jwire.pack_rows(rows[:1], "none"),
                 "opt": jwire.pack_rows(rows[:1], "none"), "last": idx},
        "meta": {"ret": {"last": idx}},
        "ping": {"ret": {"lo": 0, "hi": 8, "rows": 8, "ready": True}},
        "restore": {"method": "restore_shard", "dir": "/tmp/x",
                    "files": ["shard_00000000_00000008.msgpack"]},
        "none": {"ret": None},
        "err": {"err": "IndexError: shard-local idx out of range [0, 8)"},
    }


@pytest.mark.parametrize("name", sorted(_frames()))
def test_frames_are_the_references_bytes_and_decode_both_ways(name):
    obj = _frames()[name]
    sink = _Sink()
    n = send_frame(sink, obj)
    payload = msgpack.packb(obj, use_bin_type=True)
    assert sink.data == struct.pack(">I", len(payload)) + payload
    assert n == len(sink.data)
    a, b = socket.socketpair()
    try:
        t = threading.Thread(target=jrpc.send_frame, args=(a, obj))
        t.start()
        got, nbytes = recv_frame(b)
        t.join(timeout=10)
        assert not t.is_alive() and got == obj and nbytes == n
        t = threading.Thread(target=send_frame, args=(a, obj))
        t.start()
        back, _ = jrpc.recv_frame(b)
        t.join(timeout=10)
        assert not t.is_alive() and back == obj
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# Failure paths (the reference's)
# ---------------------------------------------------------------------------

def test_torn_frame_payload_rejected():
    a, b = socket.socketpair()
    b.sendall(struct.pack(">I", 100) + b"only-a-few-bytes")
    b.close()
    with pytest.raises(TornFrame, match="truncated"):
        recv_frame(a)
    a.close()


def test_torn_frame_header_rejected():
    a, b = socket.socketpair()
    b.sendall(b"\x00\x00")          # 2 of 4 header bytes
    b.close()
    with pytest.raises(TornFrame, match="header truncated"):
        recv_frame(a)
    a.close()


def test_undecodable_payload_is_torn_and_clean_close_is_worker_died():
    a, b = socket.socketpair()
    b.sendall(struct.pack(">I", 2) + b"\xc1\x00")   # 0xc1: never used
    with pytest.raises(TornFrame, match="undecodable"):
        recv_frame(a)
    b.close()
    with pytest.raises(WorkerDied):
        recv_frame(a)
    a.close()


def test_oversized_frame_rejected():
    a, b = socket.socketpair()
    b.sendall(struct.pack(">I", (1 << 30) + 1))
    with pytest.raises(TornFrame, match="cap"):
        recv_frame(a)
    a.close()
    b.close()


def test_retry_succeeds_after_one_dropped_call():
    """The first connection is dropped after the request (no reply); the
    bounded retry reconnects and the second attempt is served."""
    srv = socket.create_server(("127.0.0.1", 0))
    port = srv.getsockname()[1]
    attempts = []

    def server():
        conn, _ = srv.accept()
        recv_frame(conn)
        attempts.append("dropped")
        conn.close()
        conn, _ = srv.accept()
        req, _ = recv_frame(conn)
        attempts.append("served")
        send_frame(conn, {"ret": {"echo": req["x"]}})
        conn.close()

    t = threading.Thread(target=server, daemon=True)
    t.start()
    client = RpcClient("127.0.0.1", port, timeout_s=5.0, retries=2)
    assert client.call("echo", x=41) == {"echo": 41}
    assert attempts == ["dropped", "served"]
    t.join(timeout=5)
    assert not t.is_alive()
    client.close()
    srv.close()


def test_retries_exhausted_raises_named_error():
    srv = socket.create_server(("127.0.0.1", 0))
    srv.settimeout(0.2)
    port = srv.getsockname()[1]
    stop = threading.Event()

    def server():
        while not stop.is_set():
            try:
                conn, _ = srv.accept()
            except (TimeoutError, OSError):
                continue
            try:
                recv_frame(conn)
            except RpcError:
                pass
            conn.close()

    t = threading.Thread(target=server, daemon=True)
    t.start()
    client = RpcClient("127.0.0.1", port, timeout_s=5.0, retries=1)
    with pytest.raises(WorkerDied, match="2 attempt"):
        client.call("echo", x=1)
    stop.set()
    t.join(timeout=2.0)
    assert not t.is_alive()
    client.close()
    srv.close()


def test_worker_killed_mid_run_raises_within_timeout():
    """SIGKILL a live port worker, then gather: the named error surfaces
    within the (retries + 1) * timeout budget; the worker itself never
    imported torch or jax."""
    timeout_s, retries = 2.0, 1
    fleet = launch_local_workers(8, 1, timeout_s=timeout_s, retries=retries)
    try:
        h = fleet.workers[0]
        h.client.call("config", nd=4, no=4, has_residual=False)
        h.proc.kill()
        h.proc.wait()
        t0 = time.monotonic()
        with pytest.raises((WorkerDied, RpcTimeout), match="worker0"):
            h.client.call("gather",
                          idx=np.arange(2, dtype=np.int32).tobytes())
        assert time.monotonic() - t0 < (retries + 1) * timeout_s + 2.0
    finally:
        fleet.shutdown()


# ---------------------------------------------------------------------------
# partitioning and the wire codec
# ---------------------------------------------------------------------------

def test_partition_users_is_the_references():
    for users, workers in [(10, 3), (16, 2), (7, 7), (4096, 5), (256, 3)]:
        assert partition_users(users, workers) == \
            jlaunch.partition_users(users, workers)
    for users, workers in [(2, 3), (8, 0), (8, 1.0)]:
        with pytest.raises(ValueError):
            partition_users(users, workers)
        with pytest.raises(ValueError):
            jlaunch.partition_users(users, workers)


def test_wire_codec_and_pricing_are_the_references():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(8, 33)).astype(np.float32)
    x[2] = 0.0                                   # all-zero row
    x[3] *= np.float32(1e-39)                    # subnormal: numpy keeps it
    for got, want in zip(wire.np_quantize_rows(x), jwire.np_quantize_rows(x)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(wire.np_quantize_rows(x),
                         tsess._np_quantize_rows(x)):
        np.testing.assert_array_equal(got, want)
    for codec in wire.WIRE_CODECS:
        p, jp = wire.pack_rows(x, codec), jwire.pack_rows(x, codec)
        assert msgpack.packb(p, use_bin_type=True) == \
            msgpack.packb(jp, use_bin_type=True)
        np.testing.assert_array_equal(wire.unpack_rows(jp),
                                      jwire.unpack_rows(p))
        assert wire.payload_nbytes(p) == wire.priced_rows_nbytes(8, 33, codec)
    with pytest.raises(ValueError, match="codec"):
        wire.pack_rows(x, "bf16")
    for rows, nd, no in [(4, 337, 675), (8, 267009, 534019), (1, 1, 3)]:
        for codec in wire.WIRE_CODECS:
            assert wire.priced_rows_nbytes(rows, nd, codec) == \
                jwire.priced_rows_nbytes(rows, nd, codec)
            assert wire.priced_gather_nbytes(rows, nd, no,
                                             stage_codec=codec) == \
                jwire.priced_gather_nbytes(rows, nd, no, stage_codec=codec)
            for res in (False, True):
                assert wire.priced_round_nbytes(
                    rows, nd, no, stage_codec=codec, has_residual=res) == \
                    jwire.priced_round_nbytes(rows, nd, no, stage_codec=codec,
                                              has_residual=res)
        assert wire.priced_residual_nbytes(rows, nd) == \
            jwire.priced_residual_nbytes(rows, nd)


# ---------------------------------------------------------------------------
# across processes: the port's coordinator on the reference's workers, the
# reference's client on the port's workers, shard files
# ---------------------------------------------------------------------------

NDX, NOX = 37, 75     # row widths of the fleets below


@pytest.fixture(scope="module")
def fleets():
    """A reference fleet and a port fleet over U = 16 users, 2 workers
    each, configured alike (int8 stage codec, residual rows)."""
    pair = {"reference": jlaunch.launch_local_workers(U, 2),
            "port": launch_local_workers(U, 2)}
    try:
        for fleet in pair.values():
            for h in fleet.workers:
                h.client.call("config", nd=NDX, no=NOX, has_residual=True,
                              stage_codec="int8")
        yield pair
    finally:
        for fleet in pair.values():
            fleet.shutdown()


def _random_store(seed):
    rng = np.random.default_rng(seed)
    return HostStateBackend(
        rng.normal(size=(U, NDX)).astype(np.float32),
        rng.normal(size=(U, NOX)).astype(np.float32),
        rng.integers(0, 9, U).astype(np.int32),
        rng.normal(size=(U, NDX)).astype(np.float32))


@pytest.mark.parametrize("which", ["reference", "port"])
def test_port_backend_drives_either_fleet(fleets, which):
    """The port's ``MultihostStateBackend`` over the reference's workers
    (and the port's): the pushed store, int8 D gathers (the wire codec of
    the stored rows), exact opt / residual gathers into ``out=`` buffers,
    a cross-shard scatter with its stamp, and the exact snapshot equal the
    in-process host store's, with payload bytes as priced."""
    local = _random_store(11)
    mh = MultihostStateBackend(fleets[which], U, NDX, NOX, has_residual=True,
                               stage_codec="int8")
    mh.push_store(local)
    idx = np.array([13, 2, 9, 7], np.int32)          # both shards, mixed
    out = (torch.empty(4, NDX), torch.empty(4, NOX))
    d, o, last = mh.gather_rows(idx, out=out)
    assert d is out[0] and o is out[1]
    ld, lo_, llast = local.gather_rows(idx)
    np.testing.assert_array_equal(
        d.numpy(), wire.np_dequantize_rows(*wire.np_quantize_rows(ld)))
    np.testing.assert_array_equal(o.numpy(), lo_.numpy())
    np.testing.assert_array_equal(last.numpy(), llast.numpy())
    res = mh.gather_residual(idx, out=torch.empty(4, NDX))
    np.testing.assert_array_equal(res.numpy(),
                                  local.gather_residual(idx).numpy())
    new_d = torch.from_numpy(wire.np_dequantize_rows(
        *wire.np_quantize_rows(ld.numpy() + 1.0)))
    mh.scatter_rows(idx, new_d, lo_ * 2, 5, residual=res - 1)
    local.scatter_rows(idx, new_d, lo_ * 2, 5, residual=res - 1)
    want, got = _store(local), _store(mh)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])
    np.testing.assert_array_equal(mh.last_round.numpy(),
                                  local.last_round.numpy())
    assert mh.round_payload_bytes == (
        wire.priced_gather_nbytes(4, NDX, NOX, stage_codec="int8")
        + wire.priced_residual_nbytes(4, NDX)
        + wire.priced_scatter_nbytes(4, NDX, NOX, stage_codec="int8",
                                     has_residual=True))


def test_reference_client_drives_a_port_worker_and_files_match(fleets,
                                                               tmp_path):
    """The reference's ``RpcClient`` calls a port worker; after the same
    pushes both fleets write byte-identical shard files, and each fleet
    restores the other's files (at its own partition)."""
    local = _random_store(12)
    for fleet in fleets.values():
        MultihostStateBackend(fleet, U, NDX, NOX, has_residual=True,
                              stage_codec="int8").push_store(local)
    h = fleets["port"].workers[1]
    client = jrpc.RpcClient("127.0.0.1", h.client.addr[1], name="port1")
    try:
        assert client.call("ping") == {"lo": 8, "hi": 16, "rows": 8,
                                       "ready": True}
        lidx = np.array([3, 0], np.int32).tobytes()
        assert client.call("gather", idx=lidx) == h.client.call(
            "gather", idx=lidx)
        with pytest.raises(jrpc.RemoteError, match="out of range"):
            client.call("gather", idx=np.array([8], np.int32).tobytes())
    finally:
        client.close()
    dirs = {}
    for which, fleet in fleets.items():
        dirs[which] = str(tmp_path / which)
        os.makedirs(dirs[which])
        names = [w.client.call("save_shard", dir=dirs[which])
                 for w in fleet.workers]
        assert names == [shard_filename(0, 8), shard_filename(8, 16)]
    for name in names:
        with open(os.path.join(dirs["port"], name), "rb") as f, \
                open(os.path.join(dirs["reference"], name), "rb") as g:
            assert f.read() == g.read()
    for which, other in (("port", "reference"), ("reference", "port")):
        fleet = fleets[which]
        for w in fleet.workers:
            w.client.call("config", nd=NDX, no=NOX, has_residual=True,
                          stage_codec="int8")
            w.client.call("restore_shard", dir=dirs[other], files=names)
        got = _store(MultihostStateBackend(fleet, U, NDX, NOX,
                                           has_residual=True))
        for key, want in _store(local).items():
            np.testing.assert_array_equal(got[key], want)


def test_run_distgan_multihost_needs_workers():
    from repro_torch.core.protocol import run_distgan
    with pytest.raises(ValueError, match="workers"):
        run_distgan(PAIR, _fcfg(), _ds(), "approach1", steps=2,
                    batch_size=B, eval_samples=0, participation="uniform",
                    cohort_size=C, state_backend="multihost", device="cpu")
