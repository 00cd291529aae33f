"""Stage spans of the train step and the serve path.

`span(name)` marks a stage of the work for torch.profiler: while a profiler
records, it is `torch.profiler.record_function(name)`, so the stage lands in
the Chrome trace beside the operators and the kernels they launch, on the
clock Kineto aligns with the device's. Otherwise it is a shared null
context and costs one check of the profiler's flag (a bare
`record_function` costs microseconds even with no profiler running). While
torch.compile or torch.export traces it is the null context too, so an
exported graph holds no profiler operation.

The spans, outermost first:

  rpc.train_step  Trainer.train_step, the whole step (root)
  rpc.serve       export_serving's `serve`, the whole request (root)
  rpc.plan        the model's plan: the inline build and the sparse grid
  rpc.adversary   the voxel adversary
  rpc.encoder     the VFE and the sparse encoder (K1, K2); PointPillars'
                  pillar feature net (K2) and BEV scatter
  rpc.dense       backbone, neck and head
  rpc.loss        the detection loss (with the inline anchor assignment),
                  the adversary's own terms and the NaN guard
  rpc.backward    the backward and the gradients' NaN sanitation
  rpc.optimizer   the optimizer half of the step
  rpc.decode      the serving decode and NMS
  rpc.targets     CenterPoint's inline heatmap and regression targets,
                  inside the train step's root
  rpc.head        CenterPoint's CenterHead, inside rpc.dense

Readers: tools/parse_trace.stages and the benchmark's stage metrics
(benchmark/spans.py) put each device operation down to the innermost span
whose own time holds its launch.
"""
from __future__ import annotations

import contextlib
from typing import Iterable, List

import torch
from torch.autograd import profiler as _profiler

STAGES = ("rpc.train_step", "rpc.serve", "rpc.plan", "rpc.adversary", "rpc.encoder",
          "rpc.dense", "rpc.loss", "rpc.backward", "rpc.optimizer", "rpc.decode",
          "rpc.targets", "rpc.head")

_OFF = contextlib.nullcontext()


def span(name: str):
    """The context of stage `name`: a profiler annotation while a profiler
    records outside tracing, else the shared null context."""
    if not _profiler._is_profiler_enabled or torch.compiler.is_compiling():
        return _OFF
    return torch.profiler.record_function(name)


def device_entries(events: Iterable) -> List:
    """The device entries of a profile (`prof.key_averages()` or
    `prof.events()`) without the spans: on the card each span also shows on
    the device's timeline, as an annotation over the kernels launched inside
    it, which a count of launches or a sum of device time leaves out."""
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in STAGES]
