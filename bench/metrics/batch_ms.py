"""``batch_ms``: host ms a round that the session spends drawing the users'
batches (``FederationSession._batch_full`` / ``_batch_cohort``, clocked by
the benchmark's wrapper) over the window and the traced calls."""


def read(ctx):
    return ctx["batch_s"] * 1e3 or None
