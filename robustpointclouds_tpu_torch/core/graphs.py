"""CUDA graphs of fixed-shape stages: capture once per input signature, then replay.

A stage that is a pure function of its input tensors, whose outputs have
sizes fixed by the inputs' shapes and static settings, and that makes no
host sync, can be captured whole with `torch.cuda.graph` and replayed with
one launch. On the inline path the plan is such a stage: some 2700 small
launches whose host dispatch costs the card far more time than their
device work (PERF.md §5).

`GraphCache(capacity)` keeps at most `capacity` captured calls, least
recently used out, each keyed by what the caller says the graph depends on
(device, shapes, static settings). A call copies the caller's inputs into
the entry's static buffers, replays the graph and hands out fresh copies
of the captured outputs, so a result the caller keeps never changes under
it on a later call. `calls` counts "capture" (a new key: warm-up, capture,
one replay), "replay" and, where the caller takes its eager path, "eager".

`replayable(*tensors)` says whether a call may go through a graph: only on
card tensors, never while torch.compile or torch.export traces (an export
holds plain operators), never while the current stream is itself being
captured (a larger graph then captures the stage's operators directly),
and never where autograd would record through the stage.
"""
from __future__ import annotations

import collections
import threading
from typing import Any, Callable, Hashable, List, Sequence

import torch
from torch.utils import _pytree


def replayable(*tensors: torch.Tensor) -> bool:
    """Whether a call on `tensors` may replay a captured graph (module
    docstring); else the caller runs its eager body."""
    if torch.compiler.is_compiling() or not all(t.is_cuda for t in tensors):
        return False
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return False
    return not torch.cuda.is_current_stream_capturing()


def fresh_copies(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """New tensors equal to `tensors`, in one multi-tensor copy per dtype."""
    out = [torch.empty_like(t) for t in tensors]
    groups = collections.defaultdict(list)
    for i, t in enumerate(tensors):
        groups[t.dtype].append(i)
    for idx in groups.values():
        torch._foreach_copy_([out[i] for i in idx], [tensors[i] for i in idx])
    return out


class CapturedCall:
    """One captured call of `fn` on inputs of the shapes and dtypes of
    `inputs`: the static input buffers, the graph and its output tensors.

    The capture follows one eager warm-up on a side stream, so that lazy
    state the body fills on first use (cached device constants, library
    workspaces) exists before capture, where a host-to-device copy or an
    allocation outside the graph's pool would fail."""

    def __init__(self, fn: Callable[..., Any], inputs: Sequence[torch.Tensor]):
        dev = inputs[0].device
        with torch.cuda.device(dev), torch.no_grad(), torch.inference_mode(False):
            self.inputs = [x.clone() for x in inputs]
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                fn(*self.inputs)
            torch.cuda.current_stream(dev).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
                out = fn(*self.inputs)
        self.outputs, self.spec = _pytree.tree_flatten(out)
        # the last replay's copies out: a replay on another stream waits for them
        self.done = torch.cuda.Event()
        self.done.record(torch.cuda.current_stream(dev))

    def __call__(self, inputs: Sequence[torch.Tensor]) -> Any:
        stream = torch.cuda.current_stream(self.inputs[0].device)
        stream.wait_event(self.done)
        with torch.no_grad():
            for dst, src in zip(self.inputs, inputs):
                dst.copy_(src)
            self.graph.replay()
            out = fresh_copies(self.outputs)
        self.done.record(stream)
        return _pytree.tree_unflatten(out, self.spec)


class GraphCache:
    """Captured calls by key, at most `capacity`, least recently used out
    (module docstring). `entry` makes an entry from (fn, inputs); the CPU
    tests give a stand-in."""

    def __init__(self, capacity: int, entry: Callable[..., Any] = CapturedCall):
        self.capacity = capacity
        self.entry = entry
        self.entries: "collections.OrderedDict[Hashable, Any]" = collections.OrderedDict()
        self.calls: collections.Counter = collections.Counter()
        self._lock = threading.Lock()

    def __call__(self, key: Hashable, fn: Callable[..., Any],
                 inputs: Sequence[torch.Tensor]) -> Any:
        """`fn(*inputs)`'s result through the graph captured under `key`,
        captured now if there is none. `fn` must be the same function of
        the inputs for every call under one key."""
        with self._lock:
            got = self.entries.get(key)
            if got is None:
                got = self.entries[key] = self.entry(fn, inputs)
                while len(self.entries) > self.capacity:
                    self.entries.popitem(last=False)
                self.calls["capture"] += 1
            else:
                self.entries.move_to_end(key)
                self.calls["replay"] += 1
            return got(inputs)
