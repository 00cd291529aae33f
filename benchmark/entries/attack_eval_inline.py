"""Evaluation under the learned attack on the inline path: the serving
function's `serve(points, mask, None, attack=True)` (the plan built on the
device, the adversary at its evaluation bounds, forward, decode and NMS),
one batch after another, each read back before the next is sent.

A sample of the window's batches, drawn from the seed before the window
opens, keeps what the timed call produced: the head's outputs (a forward
hook on the head module) and the detections."""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

WARM_BATCHES = 3


class Entry:
    kind = "eval"

    def __init__(self, ctx):
        self.ctx = ctx
        prog = ctx.program
        self.frames_per_step = int(ctx.traffic["batch"])
        self.serve, head = prog.server(ctx.cfg, ctx.device, ctx.weights)
        self.capture = False
        self.captured: List[Dict[str, torch.Tensor]] = []
        self._hook = head.register_forward_hook(self._on_head)
        rng = np.random.default_rng(np.random.SeedSequence([int(ctx.seed), 0xE7A1]))
        k = int(ctx.traffic["sampled_batches"])
        # drawn from the window's first `sample_from` batches
        self.sample = sorted(int(i) for i in rng.choice(int(ctx.traffic["sample_from"]), k,
                                                        replace=False))
        self.kept: List[tuple] = []
        for i in range(WARM_BATCHES):
            self._call(ctx.pool[i])
        self.first = WARM_BATCHES

    def _on_head(self, module, args, output):
        if self.capture:
            self.captured.append(self.ctx.program.heads(output))

    def _call(self, b):
        out = self.serve(b["points"], b["points_mask"], None, attack=True)
        self.ctx.sync()
        return out

    def pool_index(self, n: int) -> int:
        return (self.first + n) % len(self.ctx.pool)

    def step(self, n: int):
        return self._call(self.ctx.pool[self.pool_index(n)])

    def window(self, seconds: float, sync) -> Dict:
        """Batches back to back until `seconds` have passed; each batch's
        latency is host clock from the call to its detections on hand."""
        lat = []
        n = 0
        sample = set(self.sample)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.capture = n in sample
            ts = time.perf_counter()
            dets = self.step(n)
            lat.append(time.perf_counter() - ts)
            if self.capture:
                self.kept.append((self.pool_index(n), self.captured.pop(), dets))
                self.capture = False
            n += 1
        sync()
        return {"steps": n, "seconds": time.perf_counter() - t0, "latencies": lat}

    def release(self) -> None:
        self._hook.remove()
        del self.serve

    def check(self, ref) -> Dict[str, float]:
        """The reference's head outputs on each sampled batch (head_gap), and
        the reference's decode of the program's own head outputs against the
        program's detections (decode_gap). A sampled batch the window never
        reached fails the check."""
        from .. import check

        ref.model.load_state_dict(self.ctx.weights)
        ref.model.eval()
        if len(self.kept) < len(self.sample):
            return {"head_gap": check.MISMATCH, "decode_gap": check.MISMATCH}
        hg = dg = 0.0
        for idx, heads, dets in self.kept:
            got = ref.eval_heads(self.ctx.pool[idx])
            hg = max(hg, check.head_gap(heads, got))
            dg = max(dg, check.decode_gap(dets, ref.decode(heads)))
        return {"head_gap": hg, "decode_gap": dg}
