"""Spans at the port's layer boundaries, for ``torch.profiler``.

``span(name)`` returns a context manager.  While no profiler is recording
it returns one shared no-op context, so a span costs one read of the flag
that ``torch.autograd.profiler`` sets while a profiler records (its
``profile``, which ``torch.profiler.profile`` drives, ``emit_nvtx`` and
``emit_itt``), and nothing else.  While one records, it returns a
function-scope profiler range named ``name``: the profiler keeps it among
the host's ops, on the device trace's clock, and exports it with them
(``export_chrome_trace``).  This module keeps no buffer and no state: the
profiler holds the spans.

A span never touches the device: it launches nothing, records no event and
waits on nothing.  It is a function-scope range, as the ATen ops are, and
not a ``torch.profiler.record_function`` range (user scope): the profiler
mirrors a user-scope range on the device as a CUDA event of the same name,
which a reader of the device trace would count as a device operation.

The spans, by name (readers find them by name):

  index.search              ``Index.search``: params, the view, the engine
  pipeline.query            ``core/pipeline.fused_query``: one pipeline run
  pipeline.descend          the descent's preparation and kernel A's dispatch
  pipeline.slice            the CSR leaf slice (``gather_candidates*``)
  pipeline.dedup            the validity mask, the duplicate sort, the where
  pipeline.rerank           the candidate chunks and merges around kernel B
  kernel.forest_traverse    ``kernels/ops.traverse``: kernel A or its plain
                            version
  kernel.fused_gather_topk  ``kernels/ops.fused_rerank``: kernel B or its
                            plain version
  build.forest              ``core/forest.build_forest``: one build
  build.level               one iteration of the builder's level loop
  build.draws               the level's random draws
  build.sync                one blocking read of the level loop: whether a
                            leaf is overfull, and ``torch.bincount`` (on the
                            card it reads its input's range back to size
                            its output)
"""
from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

_Range = torch._C._profiler._RecordFunctionFast
OFF = contextlib.nullcontext()


def span(name: str):
    """A function-scope profiler range named ``name`` while a profiler is
    recording, else the shared no-op context ``OFF``."""
    if not _profiler._is_profiler_enabled:
        return OFF
    return _Range(name)
