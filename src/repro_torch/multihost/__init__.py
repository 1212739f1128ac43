"""Multi-process federation control plane (port of the reference's
``multihost/``; the MD-GAN topology).

One coordinator process owns the generator / server-D carry and drives
rounds on its device; N worker processes each hold a contiguous
partition of the ``(U, N)`` host store (D rows, optimizer rows, EF
residual rows).  Per round the coordinator resolves the scheduled
cohort, gathers the owning workers' rows over a length-prefixed
MessagePack-over-TCP RPC layer, runs the cohort rows engine, and scatters
the updated rows back, the D-row legs packed as the ``stage_rows`` int8
codec packs them (int8 + per-row f32 scale), priced by
``upload_bytes_flat`` and asserted equal to the measured payload bytes on
every call.  Frames and shard files are byte for byte the reference's,
so either package's coordinator drives either package's workers.

Modules:

* ``wire``    — packed row payloads + the pricing composition (numpy)
* ``rpc``     — frame codec, RpcServer/RpcClient, the named failure
  errors (``WorkerDied`` / ``RpcTimeout`` / ``TornFrame``)
* ``worker``  — the shard-holder process (``python -m
  repro_torch.multihost.worker``), which imports neither torch nor jax
* ``launch``  — spawn → health-check → run → collect → teardown
* ``backend`` — ``MultihostStateBackend`` + the registered
  ``multihost`` streaming driver
"""
