"""Spans of a federation call, recorded while a ``torch.profiler`` records.

``span(name)`` marks a block of the device backend's call as
``distgan.<name>`` in the profiler's trace, on the clock that the trace's
device operations share.  With no profiler running it returns one shared
no-op context, so a span site costs a flag check.  There is nothing to
switch on: an operator gets the spans by profiling, for instance

    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        session.run(rounds)
    prof.export_chrome_trace("round.json")

The names, each at the boundary where its work happens:

* ``distgan.session.stage``: a window's inputs before its first chunk (the
  cohort schedule and weights and their upload; a window under the staging
  cap drawn and copied whole), and each chunk's batches when a window is
  staged chunk by chunk;
* ``distgan.engine.noise``: a chunk's host noise draws;
* ``distgan.engine.load``: copying a chunk's reals, schedule, weights and
  packed noise into its graph's static buffers;
* ``distgan.engine.capture``: the warm-up and capture of a new chunk length;
* ``distgan.engine.replay``: the graph's ``replay()``;
* ``distgan.session.finish``: the call's tail after the chunk loop's closing
  sync: the result (in a cohort, the store gathered into the stacked
  state), eval samples and accounting.

Two rules make the spans readable against the device's timeline:

* A span is a function-scope record (``_RecordFunctionFast``), not a user
  annotation (``record_function``): the profiler draws a user annotation
  again on the device's timeline over the kernels it launched, and there it
  would count as device time.
* Spans are flat: none encloses another, so the spans tile the call's host
  time and a gap in the device's work overlaps the span of the host work
  that held it up, not an enclosing one.  A span's call and chunk follow
  from time order.
"""

from __future__ import annotations

import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast

PREFIX = "distgan."


class _Off:
    """The no-op context of a span while no profiler records."""

    __slots__ = ()
    # object.__init__ bound to the empty tuple: a C call that takes any
    # arguments and returns None, so entering and leaving run no Python
    # frame, and None lets an exception pass
    __enter__ = __exit__ = ().__init__


OFF = _Off()


def span(name: str):
    """A context that records ``distgan.<name>`` while a profiler records,
    else the shared no-op ``OFF``."""
    if _profiler._is_profiler_enabled:
        return _RecordFunctionFast(PREFIX + name)
    return OFF
