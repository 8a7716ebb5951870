"""CUDA graphs of a state-passing step: capture its device chain once, then
replay it with one launch.

A step is ``fn(state) -> (new_state, outputs)``, trees (NamedTuples) of
device tensors, whose other inputs live in a static device buffer that the
caller fills before each call (``StepGraph.inputs``: the pipeline's upload
lands in it). ``StepGraphs`` keeps one graph a key, the key being whatever
changes the step's launch sequence (frame shape and layout, static flags).
A key's first ``WARMUP`` calls run eagerly: they fill the lazy caches (color
tables, the kernel library, TMA descriptors, the resample's workspaces), so
one-shot callers never capture. The next call captures the step and replays
it, and every later call replays it.

Around a replay:

- in: the caller's state leaves are copied into the graph's input state in
  one batched copy (a state of other shapes, dtypes or device runs eagerly
  instead).
- out: inside the graph the new state and the outputs are packed into one
  static buffer; the call clones it (one copy) and returns views of the
  clone. The caller's state is never written, and a returned tensor is
  never written by a later call.

A graph reads every tensor at the address it had at the capture. The step's
inputs and outputs are the graph's own; whatever else it reads must live as
long as the graph: the step's constants (the pipeline holds them) and the
module caches the warm-up filled, which therefore never evict.

A replay launches the very kernels the capture recorded, so its outputs are
bit-equal to the eager step's. The kernel wrappers' launch counts
(``kernels.launch_counters``) grow on each replay by what the capture
launched. The counters ``pipeline.graph_captures`` and
``pipeline.graph_replays`` of utils/profiling.py count captures and replays.

A ``StepGraphs``' graphs belong to one device: they are captured on a stream
of that device and replayed with it current, whichever device the caller
has current. They share one memory pool. That is safe because a call copies
in, replays and copies out in order on the device's current stream, and
calls take ``StepGraphs.lock``: one call at a time. The capture runs in
torch's ``thread_local`` mode, so CUDA work of other threads cannot void it.
"""

from __future__ import annotations

import threading
from contextlib import nullcontext
from typing import Hashable, List, Optional, Tuple

import torch

from chessboard_vision_tpu_torch.kernels import launch_counters
from chessboard_vision_tpu_torch.utils.checkpoint import tree_fill, tree_leaves, tree_map
from chessboard_vision_tpu_torch.utils.profiling import count

WARMUP = 2  # eager calls of a key before its capture
_ALIGN = 16  # bytes: every leaf of a packed buffer starts on this boundary

Spec = List[Tuple[int, int, torch.dtype, Tuple[int, ...]]]  # (offset, bytes, dtype, shape)


def layout(tensors) -> Tuple[Spec, int]:
    """Where each tensor goes in one byte buffer, in order, each on an
    ``_ALIGN``-byte boundary: (spec, the buffer's bytes)."""
    spec, at = [], 0
    for x in tensors:
        at = -(-at // _ALIGN) * _ALIGN
        n = x.numel() * x.element_size()
        spec.append((at, n, x.dtype, tuple(x.shape)))
        at += n
    return spec, -(-at // _ALIGN) * _ALIGN


def views(buf: torch.Tensor, spec: Spec) -> list:
    """The tensors of ``spec`` as views of the u8 buffer ``buf``."""
    return [buf[at:at + n].view(dtype).view(shape) for at, n, dtype, shape in spec]


def _captured(body, graphs: "StepGraphs"):
    """``body()`` captured in a CUDA graph on a stream of ``graphs``' device,
    its allocations from ``graphs``' pool."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=graphs.pool(), stream=graphs.stream(),
                          capture_error_mode="thread_local"):
        body()
        with torch.cuda.device(graphs.device):
            if not torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"the step's stream on {graphs.device} was not captured")
    return graph


class StepGraph:
    """One key's graph. ``inputs`` is its static input buffer (u8), which
    the caller fills before each ``run``."""

    def __init__(self, graphs: "StepGraphs", nbytes: int):
        self._graphs = graphs
        self.inputs = torch.empty(nbytes, dtype=torch.uint8, device=graphs.device)
        self._graph = None
        self._state_in = None  # the input state's leaves
        self._out = None  # the new state and outputs, packed by the graph

    def _copy_in(self, state) -> bool:
        """Copy ``state`` into the input state, shaped as the first state
        taken; False for a state on other devices or of other dtypes or
        shapes."""
        given = tree_leaves(state)
        meta = [(x.device, x.dtype, tuple(x.shape)) for x in given]
        if self._state_in is None:
            if any(device != self.inputs.device for device, _, _ in meta):
                return False
            self._meta = meta
            self._state_in = [torch.empty_like(x) for x in given]
            self._state_template = tree_map(lambda _: 0, state)
        if meta != self._meta:
            return False
        torch._foreach_copy_(self._state_in, given)
        return True

    def _capture(self, fn) -> None:
        state_in = tree_fill(self._state_template, iter(self._state_in))

        def body():
            result = fn(state_in)
            out = tree_leaves(result)
            if self._out is None:  # the capture: allocated from the graph's pool
                self._out_spec, n = layout(out)
                self._out = torch.empty(n, dtype=torch.uint8, device=self.inputs.device)
                self._template = tree_map(lambda _: 0, result)
            for v, x in zip(views(self._out, self._out_spec), out):
                v.copy_(x)

        counters = launch_counters().values()
        before = [c.launches for c in counters]
        self._graph = _captured(body, self._graphs)
        # The capture launched nothing: its counts go to the replays.
        self._launches = [(c, c.launches - b) for c, b in zip(counters, before) if c.launches > b]
        for c, b in zip(counters, before):
            c.launches = b
        count("pipeline.graph_captures", 1)

    def run(self, state, fn):
        """``fn(state)`` on the graph, captured on the first run; eagerly
        for a state the graph cannot take. ``fn`` reads its other inputs
        from ``inputs``."""
        with self._graphs.on_device():
            if not self._copy_in(state):
                return fn(state)
            if self._graph is None:
                self._capture(fn)
            self._graph.replay()
            count("pipeline.graph_replays", 1)
            for c, n in self._launches:
                c.launches += n
            out = self._out.clone()
        return tree_fill(self._template, iter(views(out, self._out_spec)))


class StepGraphs:
    """The CUDA graphs of one step on one device, a graph a key, sharing
    one memory pool. Take ``lock`` around ``get``, the filling of the
    graph's ``inputs`` and its ``run``."""

    def __init__(self, device: torch.device):
        self.device = device
        self.lock = threading.Lock()
        self._eager = {}  # key -> its calls so far, while fewer than WARMUP
        self._graphs = {}
        self._pool = None
        self._stream = None

    def pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def stream(self) -> torch.cuda.Stream:
        """The stream the graphs are captured on, of their device."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def on_device(self):
        """A context with the graphs' device current (none on the CPU)."""
        return torch.cuda.device(self.device) if self.device.type == "cuda" else nullcontext()

    def get(self, key: Hashable, nbytes: int) -> Optional[StepGraph]:
        """The graph of ``key`` with an input buffer of ``nbytes``, or None
        for a call that runs eagerly (the key's first WARMUP calls)."""
        graph = self._graphs.get(key)
        if graph is None:
            seen = self._eager.get(key, 0)
            if seen < WARMUP:
                self._eager[key] = seen + 1
                return None
            graph = self._graphs[key] = StepGraph(self, nbytes)
            del self._eager[key]
        return graph
