"""Typed run description for Distributed-GAN federation runs (port of the
reference's ``core/spec.py``).

A :class:`FederationSpec` splits the run configuration (engine,
participation, backend, combine/compression) from the model
configuration (``DistGANConfig``).  Every sub-spec validates at
construction and the whole spec round-trips through ``to_dict`` /
``from_dict`` / JSON with the same keys as the reference, so one manifest
describes a run of either package.

The registries hold only what the port has; an unknown name raises
``KeyError`` as in the reference.  The ``serve`` and ``decode`` sections
describe how a trained generator and an LM are served
(``repro_torch.serve``); a checkpoint's manifest carries them.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable

DEFAULT_ROUNDS_PER_JIT = 16

_ENGINE_KINDS = ("fused", "per_step")

# ---------------------------------------------------------------------------
# Registries
# ---------------------------------------------------------------------------

_builtins_state = "unloaded"     # -> "loading" -> "loaded"


def _load_builtins() -> None:
    """Import the modules that register the built-in implementations (lazy,
    so this module sits at the bottom of the import graph); a failed import
    resets the state so the real ImportError resurfaces next lookup."""
    global _builtins_state
    if _builtins_state != "unloaded":
        return
    _builtins_state = "loading"
    try:
        import repro_torch.core.approaches  # noqa: F401  (approaches)
        import repro_torch.core.federated   # noqa: F401  (combiners etc.)
        import repro_torch.core.session     # noqa: F401  (backends)
        import repro_torch.core.spmd        # noqa: F401  (spmd backend)
        import repro_torch.multihost.backend  # noqa: F401  (multihost)
    except BaseException:
        _builtins_state = "unloaded"
        raise
    _builtins_state = "loaded"


class Registry:
    """String-keyed implementation registry: duplicate registration and
    unknown lookup both raise."""

    def __init__(self, kind: str):
        self.kind = kind
        self.entries: dict[str, Any] = {}

    def register(self, name: str, value):
        if not isinstance(name, str) or not name:
            raise ValueError(f"{self.kind} key must be a non-empty string, "
                             f"got {name!r}")
        if name in self.entries:
            raise ValueError(f"duplicate {self.kind} {name!r} "
                             f"(already registered)")
        self.entries[name] = value
        return value

    def get(self, name: str):
        _load_builtins()
        try:
            return self.entries[name]
        except KeyError:
            raise KeyError(
                f"unknown {self.kind} {name!r}; registered: "
                f"{sorted(self.entries)}") from None

    def names(self) -> list[str]:
        _load_builtins()
        return sorted(self.entries)

    def __contains__(self, name: str) -> bool:
        _load_builtins()
        return name in self.entries


APPROACH_REGISTRY = Registry("approach")
SCHEDULER_REGISTRY = Registry("scheduler")
COMBINER_REGISTRY = Registry("combiner")
BACKEND_REGISTRY = Registry("backend")


@dataclasses.dataclass(frozen=True)
class ApproachDef:
    """A registered training approach.  ``body_factory(pair, fcfg)`` builds
    the round function; ``noise_factory(pair, fcfg)`` builds
    ``draw(generator, real_shape, **given) -> dict``, the round's host
    draws in the order the body consumes them (the body calls it for what
    it was not given); ``sync_ds`` — local Ds start at the server
    weights; ``user_axis`` — the approach has a per-user axis;
    ``uploads`` — parameter deltas cross the privacy boundary."""

    name: str
    body_factory: Callable
    noise_factory: Callable
    sync_ds: bool = False
    user_axis: bool = True
    uploads: bool = False


def register_approach(name: str, body_factory: Callable,
                      noise_factory: Callable, *, sync_ds: bool = False,
                      user_axis: bool = True,
                      uploads: bool = False) -> ApproachDef:
    return APPROACH_REGISTRY.register(
        name, ApproachDef(name, body_factory, noise_factory,
                          sync_ds=sync_ds, user_axis=user_axis,
                          uploads=uploads))


def register_scheduler(name: str, fn: Callable) -> Callable:
    """``fn(rng, num_users, cohort, rounds, shard_sizes=None, start=0)
    -> (rounds, cohort) int32``; ``start`` is the global index of the
    window's first round."""
    return SCHEDULER_REGISTRY.register(name, fn)


def register_combiner(name: str, fn: Callable) -> Callable:
    """Server fold over stacked ``(C, ...)`` delta rows; combiners that
    consume participation ages carry ``fn.needs_ages = True``."""
    return COMBINER_REGISTRY.register(name, fn)


@dataclasses.dataclass(frozen=True)
class _BackendDef:
    name: str
    driver_cls: Any
    streams: bool


def register_backend(name: str, driver_cls, *, streams: bool = False):
    return BACKEND_REGISTRY.register(
        name, _BackendDef(name, driver_cls, streams))


def registry_snapshot() -> dict[str, tuple[str, ...]]:
    """Every registered key per registry, builtins loaded: what
    ``repro_torch.analysis`` enumerates, so the contract checker covers an
    implementation the moment it registers (the reference's
    ``core/spec.py:185``)."""
    _load_builtins()
    return {
        "approach": tuple(sorted(APPROACH_REGISTRY.entries)),
        "scheduler": tuple(sorted(SCHEDULER_REGISTRY.entries)),
        "combiner": tuple(sorted(COMBINER_REGISTRY.entries)),
        "backend": tuple(sorted(BACKEND_REGISTRY.entries)),
    }


def resolve_approach(name: str) -> ApproachDef:
    return APPROACH_REGISTRY.get(name)


def resolve_scheduler(name: str) -> Callable:
    return SCHEDULER_REGISTRY.get(name)


def resolve_combiner(name: str) -> Callable:
    return COMBINER_REGISTRY.get(name)


def resolve_backend(name: str) -> _BackendDef:
    return BACKEND_REGISTRY.get(name)


# ---------------------------------------------------------------------------
# Spec layer
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """``fused`` runs ``rounds_per_jit`` rounds per chunk over a pre-staged
    data stack and fetches metrics once per chunk; ``per_step`` stages,
    runs and fetches round by round.  ``fuse_store_rounds`` makes the
    cohort engine update the resident (U, N) store in place across a
    window instead of working on a copy; as in the reference, it does
    nothing under full participation without a cohort."""

    kind: str = "fused"
    rounds_per_jit: int = DEFAULT_ROUNDS_PER_JIT
    fuse_store_rounds: bool = False

    def __post_init__(self):
        if self.kind not in _ENGINE_KINDS:
            raise ValueError(f"unknown engine kind {self.kind!r}; "
                             f"choose from {_ENGINE_KINDS}")
        if not isinstance(self.rounds_per_jit, int) or self.rounds_per_jit < 1:
            raise ValueError(
                f"rounds_per_jit must be a positive int, got "
                f"{self.rounds_per_jit!r}")
        if self.fuse_store_rounds and self.kind != "fused":
            raise ValueError(
                "fuse_store_rounds needs the fused engine (kind='fused')")


@dataclasses.dataclass(frozen=True)
class ParticipationSpec:
    """Which logical users train each round: a registered ``scheduler``
    draws a cohort of ``cohort_size`` members per round (``None`` means
    all ``num_users``)."""

    scheduler: str = "full"
    cohort_size: int | None = None

    def __post_init__(self):
        resolve_scheduler(self.scheduler)  # raises on unknown
        if self.cohort_size is not None and (
                not isinstance(self.cohort_size, int)
                or self.cohort_size < 1):
            raise ValueError(f"cohort_size must be a positive int or None, "
                             f"got {self.cohort_size!r}")


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """Where the per-user rows live: ``device`` keeps the (U, N) store on
    the accelerator; ``host`` keeps it in host memory and streams the
    scheduled cohort's C rows per round (U bounded by host RAM), with
    ``async_rounds`` bounded-staleness rounds in flight, ``prefetch``
    (stage round k+1's data under round k's compute) and
    ``materialize_state=False`` (skip the final (U, N) unpack onto the
    device); ``spmd`` streams the same way with the cohort mapped onto the
    users axis of a mesh, one member per rank (``core/spmd.py``).

    ``multihost`` partitions the host store across ``workers`` local
    worker processes reached over RPC (``repro_torch.multihost``);
    ``workers`` is required for it and illegal elsewhere.
    ``rpc_timeout_s`` / ``rpc_retries`` bound every RPC: a dead worker
    fails the round with a named error inside ``(rpc_retries + 1) *
    rpc_timeout_s`` instead of hanging."""

    kind: str = "device"
    async_rounds: int = 0
    prefetch: bool = True
    materialize_state: bool = True
    workers: int | None = None
    rpc_timeout_s: float = 10.0
    rpc_retries: int = 2

    def __post_init__(self):
        backend = resolve_backend(self.kind)  # raises on unknown
        if not isinstance(self.async_rounds, int) or self.async_rounds < 0:
            raise ValueError(f"async_rounds must be an int >= 0, got "
                             f"{self.async_rounds!r}")
        if self.kind == "multihost":
            if not isinstance(self.workers, int) or self.workers < 1:
                raise ValueError(
                    f"BackendSpec(kind='multihost') partitions the (U, N) "
                    f"store across worker processes — set workers to an "
                    f"int >= 1, got {self.workers!r}")
        elif self.workers is not None:
            raise ValueError(
                f"workers partitions the multihost store; the "
                f"{self.kind!r} backend runs in one process")
        if (not isinstance(self.rpc_timeout_s, (int, float))
                or isinstance(self.rpc_timeout_s, bool)
                or self.rpc_timeout_s <= 0):
            raise ValueError(f"rpc_timeout_s must be a number > 0, got "
                             f"{self.rpc_timeout_s!r}")
        if not isinstance(self.rpc_retries, int) or self.rpc_retries < 0:
            raise ValueError(f"rpc_retries must be an int >= 0, got "
                             f"{self.rpc_retries!r}")
        if not backend.streams:
            if self.async_rounds:
                raise ValueError(
                    f"async_rounds needs a streaming backend (the "
                    f"{self.kind!r} path is synchronous by construction)")
            if not self.materialize_state:
                raise ValueError(
                    f"materialize_state=False is a streaming-backend knob "
                    f"(the {self.kind!r} backend's store is already "
                    f"device-resident)")
            if not self.prefetch:
                raise ValueError(
                    f"prefetch is a streaming-backend knob; the "
                    f"{self.kind!r} backend pre-stages whole chunks")


CODECS = ("none", "bf16", "int8", "topk_int8")
_INT8_CODECS = ("int8", "topk_int8")


@dataclasses.dataclass(frozen=True)
class CompressionSpec:
    """Wire encoding of the uploaded delta rows, applied after selection:
    ``none`` (f32), ``bf16``, ``int8`` (per-row absmax scale) or
    ``topk_int8`` (int8 values of a sparse selection).  ``error_feedback``
    keeps a per-user residual of what compression dropped (it lives in the
    cohort store, so it needs a cohort-virtualized run);
    ``stochastic`` selects counter-hash stochastic rounding;
    ``stage_rows`` also moves the host backend's D rows as int8 plus a
    per-row scale each way (a lossy store transport)."""

    codec: str = "none"
    error_feedback: bool = True
    stochastic: bool = False
    stage_rows: bool = False

    def __post_init__(self):
        if self.codec not in CODECS:
            raise ValueError(f"unknown codec {self.codec!r}; choose from "
                             f"{CODECS}")
        if not isinstance(self.error_feedback, bool):
            raise ValueError(f"error_feedback must be a bool, got "
                             f"{self.error_feedback!r}")
        if self.stochastic and self.codec not in _INT8_CODECS:
            raise ValueError(
                f"stochastic rounding is an int8-codec knob (codec is "
                f"{self.codec!r})")
        if self.stage_rows and self.codec not in _INT8_CODECS:
            raise ValueError(
                f"stage_rows moves state rows as int8+scale and therefore "
                f"needs an int8 codec (codec is {self.codec!r})")

    @property
    def lossy(self) -> bool:
        return self.codec != "none"


@dataclasses.dataclass(frozen=True)
class CombineSpec:
    """The server fold: a registered ``combiner`` (argmax-|.|, mean,
    masked mean, or the staleness-aware variants), participation-adaptive
    weights (cohort runs only) and the upload ``compression``."""

    combiner: str = "max_abs"
    staleness_decay: float = 0.5
    adaptive_server_scale: bool = False
    compression: CompressionSpec = dataclasses.field(
        default_factory=CompressionSpec)

    def __post_init__(self):
        resolve_combiner(self.combiner)  # raises on unknown
        if not (0.0 < float(self.staleness_decay) <= 1.0):
            raise ValueError(f"staleness_decay must be in (0, 1], got "
                             f"{self.staleness_decay!r}")
        if not isinstance(self.adaptive_server_scale, bool):
            raise ValueError(f"adaptive_server_scale must be a bool, got "
                             f"{self.adaptive_server_scale!r}")
        if isinstance(self.compression, dict):
            object.__setattr__(
                self, "compression",
                _sub_spec(CompressionSpec, self.compression,
                          "combine.compression"))
        if not isinstance(self.compression, CompressionSpec):
            raise ValueError(
                f"compression must be a CompressionSpec or manifest dict, "
                f"got {self.compression!r}")


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """How a trained generator is served (repro_torch.serve): requests of any
    size run through a small set of padded power-of-two batch buckets —
    the service builds O(log max_batch) programs (CUDA graphs on the
    card), never one per request size.

    ``max_batch``   — the largest bucket (must be a power of two when
                      ``bucket_sizes`` is not given; buckets are then
                      1, 2, 4, ..., max_batch);
    ``bucket_sizes``— explicit ascending bucket widths (overrides the
                      power-of-two derivation; need not be powers of 2);
    ``flush_ms``    — micro-batcher deadline: a partial bucket is
                      dispatched once its oldest request has waited this
                      long (milliseconds);
    ``oversample``  — candidate factor for the per-user discriminator-
                      scored rejection filter (k*n candidates keep n);
    ``rate_limit``  — per-tenant admission control: at most this many
                      requests (sample AND decode, they share the
                      window) per ``rate_window_s`` sliding window;
                      ``None`` disables it.  Over-limit submissions
                      raise ``repro_torch.serve.service.RateLimitExceeded``
                      and count in the tenant's ``rejected`` accounting
                      row."""

    max_batch: int = 64
    bucket_sizes: tuple | None = None
    flush_ms: float = 2.0
    oversample: int = 4
    rate_limit: int | None = None
    rate_window_s: float = 1.0

    def __post_init__(self):
        if self.bucket_sizes is not None:
            # JSON round-trips tuples as lists; normalize on the way in
            object.__setattr__(self, "bucket_sizes",
                               tuple(self.bucket_sizes))
            bs = self.bucket_sizes
            if not bs or any(not isinstance(b, int) or b < 1 for b in bs) \
                    or list(bs) != sorted(set(bs)):
                raise ValueError(
                    f"bucket_sizes must be strictly ascending positive "
                    f"ints, got {self.bucket_sizes!r}")
            object.__setattr__(self, "max_batch", bs[-1])
        if not isinstance(self.max_batch, int) or self.max_batch < 1:
            raise ValueError(f"max_batch must be a positive int, got "
                             f"{self.max_batch!r}")
        if self.bucket_sizes is None and self.max_batch & (
                self.max_batch - 1):
            raise ValueError(
                f"max_batch must be a power of two when bucket_sizes is "
                f"not given (got {self.max_batch}); pass explicit "
                f"bucket_sizes for other ladders")
        if not (float(self.flush_ms) >= 0.0):
            raise ValueError(f"flush_ms must be >= 0, got "
                             f"{self.flush_ms!r}")
        if not isinstance(self.oversample, int) or self.oversample < 1:
            raise ValueError(f"oversample must be a positive int, got "
                             f"{self.oversample!r}")
        if self.rate_limit is not None and (
                not isinstance(self.rate_limit, int) or self.rate_limit < 1):
            raise ValueError(f"rate_limit must be a positive int or None, "
                             f"got {self.rate_limit!r}")
        if not (float(self.rate_window_s) > 0.0):
            raise ValueError(f"rate_window_s must be > 0, got "
                             f"{self.rate_window_s!r}")

    def buckets(self) -> tuple:
        """The bucket ladder, ascending."""
        if self.bucket_sizes is not None:
            return self.bucket_sizes
        out, b = [], 1
        while b <= self.max_batch:
            out.append(b)
            b *= 2
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class DecodeSpec:
    """How LM decode traffic is served (repro_torch.serve.decode): a fixed pool
    of ``slots`` decode slots shares one pre-allocated KV/state cache
    sized ``(slots, max_seq)`` (priced by ``models.cache.cache_nbytes``);
    each step advances every occupied slot one token and freed slots
    admit queued requests at the next step boundary.

    ``slots``          — pool width (the decode step's batch);
    ``max_seq``        — per-slot sequence capacity: a request needs
                         ``prompt_len + max_new <= max_seq``;
    ``prefill_buckets``— ascending prompt-length ladder: a prefill
                         dispatch pads its prompts to the smallest bucket
                         >= the longest admitted prompt and runs that
                         many steps (powers of two from 8 to ``max_seq``
                         when not given);
    ``flush_ms``       — admission deadline (the MicroBatcher
                         size-or-deadline policy applied to prompt
                         ingestion): a partial prefill batch dispatches
                         once its oldest queued request has waited this
                         long;
    ``admit_min``      — re-admission batching: while the pool is busy,
                         wait until at least this many slots are free
                         before paying a prefill dispatch (each prefill
                         scans a whole bucket at pool width, so admitting
                         one slot at a time wastes most of the scan).
                         Admission never waits when the pool is idle or
                         the whole queue fits the free slots, so progress
                         is unconditional.  0 (default) = auto:
                         ``max(1, slots // 4)``;
    ``eos_id``         — optional stop token: a slot emitting it frees at
                         the next step boundary;
    ``temperature``    — 0.0 = greedy argmax; > 0 samples each token with
                         a key folded from (seed, request_id, position),
                         so sampled tokens stay a pure function of the
                         request identity, never of batch-mates."""

    slots: int = 8
    max_seq: int = 128
    prefill_buckets: tuple | None = None
    flush_ms: float = 2.0
    admit_min: int = 0
    eos_id: int | None = None
    temperature: float = 0.0

    def __post_init__(self):
        if not isinstance(self.slots, int) or self.slots < 1:
            raise ValueError(f"slots must be a positive int, got "
                             f"{self.slots!r}")
        if not isinstance(self.max_seq, int) or self.max_seq < 2:
            raise ValueError(f"max_seq must be an int >= 2, got "
                             f"{self.max_seq!r}")
        if self.prefill_buckets is not None:
            object.__setattr__(self, "prefill_buckets",
                               tuple(self.prefill_buckets))
            bs = self.prefill_buckets
            if not bs or any(not isinstance(b, int) or b < 1 for b in bs) \
                    or list(bs) != sorted(set(bs)) or bs[-1] > self.max_seq:
                raise ValueError(
                    f"prefill_buckets must be strictly ascending positive "
                    f"ints <= max_seq, got {self.prefill_buckets!r}")
        if not (float(self.flush_ms) >= 0.0):
            raise ValueError(f"flush_ms must be >= 0, got "
                             f"{self.flush_ms!r}")
        if not isinstance(self.admit_min, int) or not (
                0 <= self.admit_min <= self.slots):
            raise ValueError(f"admit_min must be an int in [0, slots], "
                             f"got {self.admit_min!r}")
        if self.eos_id is not None and (
                not isinstance(self.eos_id, int) or self.eos_id < 0):
            raise ValueError(f"eos_id must be an int >= 0 or None, got "
                             f"{self.eos_id!r}")
        if not (float(self.temperature) >= 0.0):
            raise ValueError(f"temperature must be >= 0, got "
                             f"{self.temperature!r}")

    def buckets(self) -> tuple:
        """The prompt-length ladder, ascending (largest covers max_seq so
        any admissible prompt fits some bucket)."""
        if self.prefill_buckets is not None:
            return self.prefill_buckets
        out, b = [], 8
        while b < self.max_seq:
            out.append(b)
            b *= 2
        out.append(self.max_seq)
        return tuple(out)


def _sub_spec(cls, d: dict, section: str):
    """Build a sub-spec from a manifest dict, rejecting unknown keys."""
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(d) - fields)
    if unknown:
        raise ValueError(
            f"unknown key(s) {unknown} in {section!r} spec section; "
            f"valid keys: {sorted(fields)}")
    return cls(**d)


@dataclasses.dataclass(frozen=True)
class FederationSpec:
    """Complete declarative description of one federation run (minus the
    model pair, the DistGANConfig and the dataset).  ``serve`` (``None``:
    serving defaults) says how the trained generator is served
    (``GenerationService`` reads it from a restored session's manifest);
    ``decode`` says how the continuous-batching LM decode engine runs."""

    approach: str
    batch_size: int = 64
    seed: int = 0
    eval_samples: int = 2048
    engine: EngineSpec = dataclasses.field(default_factory=EngineSpec)
    participation: ParticipationSpec = dataclasses.field(
        default_factory=ParticipationSpec)
    backend: BackendSpec = dataclasses.field(default_factory=BackendSpec)
    combine: CombineSpec = dataclasses.field(default_factory=CombineSpec)
    serve: ServeSpec | None = None
    decode: DecodeSpec | None = None

    def __post_init__(self):
        approach = resolve_approach(self.approach)  # raises on unknown
        if not isinstance(self.batch_size, int) or self.batch_size < 1:
            raise ValueError(f"batch_size must be a positive int, got "
                             f"{self.batch_size!r}")
        if not isinstance(self.seed, int) or isinstance(self.seed, bool):
            raise ValueError(f"seed must be an int, got {self.seed!r}")
        if not isinstance(self.eval_samples, int) or self.eval_samples < 0:
            raise ValueError(f"eval_samples must be an int >= 0, got "
                             f"{self.eval_samples!r}")
        if not isinstance(self.participation, ParticipationSpec):
            raise ValueError(f"participation must be a ParticipationSpec, "
                             f"got {self.participation!r}")
        if self.serve is not None and not isinstance(self.serve, ServeSpec):
            raise ValueError(f"serve must be a ServeSpec or None, got "
                             f"{self.serve!r}")
        if self.decode is not None and not isinstance(self.decode,
                                                      DecodeSpec):
            raise ValueError(f"decode must be a DecodeSpec or None, got "
                             f"{self.decode!r}")
        if not approach.user_axis and self.cohort_virtual:
            raise ValueError(
                f"approach {self.approach!r} has no user axis to "
                f"virtualize (cohort scheduling / streaming backends "
                f"need one)")
        if self.cohort_virtual and self.engine.kind != "fused":
            raise ValueError(
                "cohort virtualization needs the fused engine (the "
                "per_step loop runs the full-participation layout)")
        if self.combine.adaptive_server_scale and not (
                approach.uploads and self.cohort_virtual):
            raise ValueError(
                "adaptive_server_scale is a combiner option for "
                "delta-uploading approaches under cohort scheduling")
        comp = self.combine.compression
        if comp.codec != "none":
            if not approach.uploads:
                raise ValueError(
                    f"compression codecs encode uploaded delta rows; "
                    f"approach {self.approach!r} uploads nothing")
            if comp.error_feedback and not self.cohort_virtual:
                raise ValueError(
                    "error feedback keeps a per-user residual row in the "
                    "cohort store; run a cohort-virtualized configuration "
                    "or set compression.error_feedback=False")
        if comp.stage_rows and self.backend.kind not in ("host", "spmd",
                                                         "multihost"):
            raise ValueError(
                f"stage_rows compresses the host<->device / cross-mesh "
                f"row movement; the {self.backend.kind!r} backend's store "
                f"never leaves the device")

    @property
    def cohort_virtual(self) -> bool:
        """Whether the run needs the cohort-virtualized path."""
        return (self.participation.cohort_size is not None
                or self.participation.scheduler != "full"
                or self.backend.kind != "device")

    def cohort_size_for(self, num_users: int) -> int:
        return (self.participation.cohort_size
                if self.participation.cohort_size is not None else num_users)

    def validate_against(self, num_users: int) -> None:
        """Cross-checks that need the model config's user count."""
        c = self.cohort_size_for(num_users)
        if c > num_users:
            raise ValueError(f"cohort_size {c} exceeds num_users "
                             f"{num_users}")
        if self.participation.scheduler == "full" and c != num_users:
            raise ValueError(
                f"'full' participation needs cohort_size == num_users "
                f"(got C={c}, U={num_users}); pick a partial scheduler "
                f"for C < U")
        if (self.backend.kind == "multihost"
                and self.backend.workers > num_users):
            raise ValueError(
                f"cannot partition num_users={num_users} over "
                f"workers={self.backend.workers} (empty shard)")

    # -- serialization -----------------------------------------------------

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "FederationSpec":
        d = dict(d)
        for key, sub in (("engine", EngineSpec),
                         ("participation", ParticipationSpec),
                         ("backend", BackendSpec), ("combine", CombineSpec),
                         ("serve", ServeSpec), ("decode", DecodeSpec)):
            if key in d and isinstance(d[key], dict):
                d[key] = _sub_spec(sub, d[key], key)
        return cls(**d)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "FederationSpec":
        return cls.from_dict(json.loads(s))
