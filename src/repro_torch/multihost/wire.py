"""Packed row payloads for the coordinator <-> worker wire (port of the
reference's ``multihost/wire.py``, the same payloads byte for byte).

numpy only: workers import this module and the frame codec and nothing
of torch, so a worker process serves RPCs within a fraction of a second.
The pricing helpers import ``upload_bytes_flat`` lazily; only the
coordinator calls them.

A payload is a MessagePack-ready dict, raw row-major buffers plus shape,
one dict per row leg:

    {"codec": "none", "shape": [r, n], "data": <r*n*4 bytes f32>}
    {"codec": "int8", "shape": [r, n], "q": <r*n bytes int8>,
                                       "scale": <r*4 bytes f32>}

The int8 codec is the reference's numpy codec: ``scale = max|x| / 127``
by IEEE division, unflushed, the same as the host stream's
``core.session._np_quantize_rows``.  Re-quantizing rows that this codec
dequantized gives back the same ``(q, scale)``.  Rows that the device
codec dequantized do not always: B2 (as the reference's jitted codec)
takes ``scale = max|x| * f32(1/127)``, and on some rows the quotient of
the dequantized absmax is another float (``tests/test_torch_multihost.py``
shows it), so the int8 wire is not a fixed point of the device's round.
"""

from __future__ import annotations

import numpy as np

WIRE_CODECS = ("none", "int8")


def np_quantize_rows(x: np.ndarray):
    """Per-row absmax int8, the reference's numpy codec bit for bit
    (``core.session._np_quantize_rows``; a copy, so workers never import
    torch)."""
    x = np.asarray(x, np.float32)
    scale = (np.abs(x).max(axis=1) / np.float32(127.0)).astype(np.float32)
    # where() drops the 1 / 0 of a zero row and the inf of a subnormal one
    with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
        inv = np.where(scale > 0, np.float32(1.0) / scale,
                       np.float32(0.0)).astype(np.float32)
        q = np.clip(np.rint(x * inv[:, None]), -127, 127).astype(np.int8)
    return q, scale


def np_dequantize_rows(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    return q.astype(np.float32) * scale[:, None].astype(np.float32)


def pack_rows(rows: np.ndarray, codec: str = "none") -> dict:
    """(r, n) f32 rows -> one wire payload dict."""
    rows = np.ascontiguousarray(rows, np.float32)
    assert rows.ndim == 2, rows.shape
    if codec == "none":
        return {"codec": "none", "shape": list(rows.shape),
                "data": rows.tobytes()}
    if codec == "int8":
        q, scale = np_quantize_rows(rows)
        return {"codec": "int8", "shape": list(rows.shape),
                "q": q.tobytes(), "scale": scale.tobytes()}
    raise ValueError(f"unknown wire codec {codec!r}; one of {WIRE_CODECS}")


def unpack_rows(payload: dict) -> np.ndarray:
    """Wire payload dict -> (r, n) f32 rows (dequantized for int8)."""
    r, n = payload["shape"]
    if payload["codec"] == "none":
        return np.frombuffer(payload["data"], np.float32).reshape(r, n)
    if payload["codec"] == "int8":
        q = np.frombuffer(payload["q"], np.int8).reshape(r, n)
        scale = np.frombuffer(payload["scale"], np.float32)
        return np_dequantize_rows(q, scale)
    raise ValueError(f"unknown wire codec {payload['codec']!r}")


def payload_nbytes(payload: dict) -> int:
    """Raw row-buffer bytes in one payload, the priced quantity (the
    envelope and key overhead is counted apart, as socket bytes, by the
    RPC client)."""
    if payload["codec"] == "none":
        return len(payload["data"])
    return len(payload["q"]) + len(payload["scale"])


# ---------------------------------------------------------------------------
# Pricing: composed from the one table (core.federated.upload_bytes_flat)
# ---------------------------------------------------------------------------

def priced_rows_nbytes(rows: int, n: int, codec: str = "none") -> int:
    """Priced bytes for ``rows`` dense state rows of flat width ``n``
    under a wire codec: ``upload_bytes_flat(n, "none", codec=...)`` per
    row (state rows ship whole; selection policies apply to the uploaded
    delta, not to the store transport)."""
    from repro_torch.core.federated import upload_bytes_flat
    return rows * upload_bytes_flat(n, "none", codec=codec)


def priced_gather_nbytes(rows: int, nd: int, no: int, *,
                         stage_codec: str = "none") -> int:
    """Priced payload bytes of one gather call touching ``rows`` rows:
    int32 idx up + (D rows under the stage codec, opt rows exact f32,
    int32 last_round) down."""
    return (rows * 4                                     # idx (int32)
            + priced_rows_nbytes(rows, nd, stage_codec)  # D rows
            + priced_rows_nbytes(rows, no, "none")       # opt rows (exact)
            + rows * 4)                                  # last_round (int32)


def priced_scatter_nbytes(rows: int, nd: int, no: int, *,
                          stage_codec: str = "none",
                          has_residual: bool = False) -> int:
    """Priced payload bytes of one scatter call touching ``rows`` rows:
    int32 idx + D rows under the stage codec + exact f32 opt rows
    (+ exact f32 residual rows: the EF ledger is never quantized)."""
    return (rows * 4
            + priced_rows_nbytes(rows, nd, stage_codec)
            + priced_rows_nbytes(rows, no, "none")
            + (priced_rows_nbytes(rows, nd, "none") if has_residual else 0))


def priced_residual_nbytes(rows: int, nd: int) -> int:
    """Priced payload bytes of one gather_residual call: int32 idx up +
    exact f32 residual rows down."""
    return rows * 4 + priced_rows_nbytes(rows, nd, "none")


def priced_round_nbytes(cohort: int, nd: int, no: int, *,
                        stage_codec: str = "none",
                        has_residual: bool = False) -> int:
    """Priced payload bytes one synchronous round moves over the wire: a
    gather, a residual gather when the EF ledger exists, and a scatter,
    whatever the number of workers the cohort's rows are split across
    (routing splits rows, never duplicates them)."""
    total = priced_gather_nbytes(cohort, nd, no, stage_codec=stage_codec)
    if has_residual:
        total += priced_residual_nbytes(cohort, nd)
    total += priced_scatter_nbytes(cohort, nd, no, stage_codec=stage_codec,
                                   has_residual=has_residual)
    return total
