"""Named ranges at the port's layer boundaries, for the profiler.

``span(name)`` is a context manager. While ``torch.profiler`` (or
``torch.autograd.profiler.emit_nvtx``) records, it is a profiler range
named ``PREFIX + name`` on the calling thread, on the profiler's clock,
which is also the clock of the device activity CUPTI records; under
``emit_nvtx`` it is an NVTX range too. Otherwise it is one shared no-op
context: the cost is one query of the profiler's state.

The range is an operator-scope ``RecordFunction`` (``_RecordFunctionFast``),
not a ``record_function`` user annotation: a user annotation also gets a
copy on the device's timeline, which a reader that sums device activity
would count as device work.

The spans of a train step, nested on the calling thread:

- ``step``: every train step ``launch/train.py``'s ``build_train_setup``
  returns;
- ``input``: the DP step's ``to_device`` and fused input transform;
- ``forward``: the parameters' cast to the compute dtype and the loss;
- ``backward``: ``torch.autograd.grad`` and the gradients' cast to f32
  (the kernels it launches come from autograd's device thread while
  this thread sits in the span);
- ``sync``: the DP step's whole gradient sync, holding ``sync.pack``,
  one ``sync.all_reduce`` per bucket and ``sync.unpack``
  (``distributed/bucketing.py``);
- ``update``: the metrics' all-reduce, the optimizer's update and the
  gradient norm;
- ``feed``: ``DataPipeline.__next__``, holding ``feed.wait`` (the block
  for a host batch) and ``feed.stage`` (the device stage ``put``).
"""
from __future__ import annotations

import contextlib

import torch

PREFIX = "repro_torch."

_OFF = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


def span(name: str):
    """The range ``PREFIX + name`` while a profiler records, else a
    no-op context."""
    if _recording():
        return torch._C._profiler._RecordFunctionFast(PREFIX + name)
    return _OFF
