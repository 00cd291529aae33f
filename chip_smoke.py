#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, probe and evaluation paths on one NVIDIA card and check them.

    python3 chip_smoke.py [--seed N] [--requests N]

Phases (any failure exits non-zero and prints no result):
  1. the card's name and power limit; the kernels' build time (the CUDA
     sparse convs -- the bf16 tensor-core kernels and the float32 CUDA-core
     ones --, the gather probes and the masked statistics / fused
     MaskedBatchNorm with nvcc into build/torch_kernels/, one nvcc per
     source, started together); the count of bf16 HMMA instructions in the
     tensor-core library's SASS (cuobjdump), which must not be 0;
  2. kernels: the sparse-conv gather-GEMM on the inputs of each of the 12
     encoder convs of a full-width B=6 KITTI forward; its dgrad and wgrad on
     the inputs (feats, g, idx, backward index) of the 12 convs captured
     from one full-width B=6 train step; the masked statistics at
     [480000, 4] and [96000, 64]; the fused MaskedBatchNorm forward and
     backward at the shapes of a train step's 17 BNs (bf16, train mode; the
     perturber's ReLU, the encoder's ReLU + row mask) and in eval mode at
     [480000, 128]; the statistics' VJP at [480000, 4], [480000, 128] and
     [96000, 64] (f32 and bf16). Each against its plain PyTorch version on
     the card, bit-identical on a repeat call where it reduces, with times,
     bounds and a one-call PyTorch yardstick; each bf16 sparse-conv kernel
     also beside the float32 route's CUDA-core kernel on the same bf16
     inputs (prev_ms), and the float32 route on the same convs cast to
     float32 against its plain version; each masked-statistics kernel beside
     the first design's Triton kernels and eager ops on the same inputs
     (prev_ms, timed in turns), its inputs cycled over copies that exceed the
     L2 cache;
  3. serving: the full-width SECOND VoxelNetConfig (bf16, random weights from
     the seed) answers requests of 6 synthetic frames of 20000 points each,
     clean and with attack=True, through cli/export.export_serving; the
     launch counters are zeroed just before and read just after; outputs are
     checked for shape and finiteness, and a float32 forward on a small grid
     and its decode + rotated NMS are held against the same on the CPU;
  4. training: train/loop.Trainer on the same full-width config at B=6 with
     20000-point synthetic frames carrying GT boxes, the host plan (native
     plan + anchor assignment, train/loop.HostPlanBuilder) built in the
     prefetch thread by run_training's own pipeline (cli/common.with_plans
     behind prefetch_iterator); one warm-up step, then TRAIN_STEPS timed
     steps at epoch 3 (adversary on) with the launch counters zeroed before
     and read after; the steps after the PREFETCHED_STEPS whose plans were
     built ahead give the steady-state frames/s. Checks finite losses,
     positives, moved detector and adversary weights and the per-step
     launch counts; prints ms per step, frames/s and each plan build's
     native-plan and anchor-assignment ms. A
     float32 train step's gradients on a small grid are held against the
     same step on the CPU; every sparse-conv launch of the bf16 main path
     must take the tensor-core kernels, every one of the float32 small-grid
     forward and train step the CUDA-core kernels;
  5. the gather probes: tools/probe_gather's main checks the four gather
     kernels against their plain versions at the probe's small shape
     (exact) and times them there, and the row, element and row-loop
     gathers at the sparse conv's table size, against the bound, the plain
     version and index_select, each with its device time and its host cost
     per call split into the wrapper's pieces. The one-hot kernel's library
     must hold HMMA instructions (phase 1);
  6. evaluation: phase 4's trained state is saved by the port's
     CheckpointManager; cli/evaluate_kitti_3class's entry restores it and
     scores the full-width model at B=6, clean, on synthetic 20000-point
     frames and on tests/fixtures/kitti_mini through kitti_val_loader
     (calib and 2D boxes give the 2d/aos metrics; padding rows are not
     scored); evaluate_kitti_adversarial_attack's entry scores one
     synthetic batch clean and under --method learned, and clean and under
     --method pgd (10 steps). The launch counters are zeroed before each
     entry and read after (per batch: clean 12 sparse-conv forwards and 12
     BN forwards; the learned attack adds 12 + 17 of them and 2 masked
     statistics; PGD-K adds 12*(K+1) of each and 12*K input gradients of
     each, no weight gradient and no bwd_reduce); each
     batch's host plan, device and metric ms are printed, and the device's
     idle share over one batch of each path under torch.profiler.
The last two lines are the kernels JSON and {"ok": true, "device": ...}.
Needs one card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# published peaks of one H100 SXM (NVIDIA data sheet, dense): the bound of
# each kernel is the larger of bytes / memory rate and operations / peak
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16_tensor": 989e12, "f32": 67e12}
L2_BYTES = 50_000_000  # an H100's L2 cache

# bf16 outputs round once to 8 significant bits (2^-8 relative) after a
# float32 sum in another order: hold errors to 1e-2 of the output's scale
SPARSE_CONV_RTOL = 1e-2
# the float32 route's forward and dgrad vs the plain float32 matmul (TF32
# off): summation order only
F32_CONV_RTOL = 1e-5
# float32 statistics, one pass with Chan's merge vs two passes: 1e-4 of scale
MASKED_STATS_RTOL = 1e-4
# float32 forward on the card (TF32 off) vs the CPU: summation order only
E2E_F32_RTOL = 1e-3
# wgrad: float32 sums of the same bf16 products in another order
WGRAD_RTOL = 1e-4
# masked-stats VJP: the same float32 formula; bf16 outputs round once (2^-8)
STATS_BWD_RTOL = {"float32": 1e-5, "bfloat16": 1e-2}
# fused MaskedBatchNorm, bf16 in and out: y and dx round once to bf16 (2^-8)
# after float32 arithmetic whose statistics and sums run in another order
BN_RTOL = 1e-2
# its d gamma / d beta: float32 sums of the same gated products in another order
BN_PARAM_GRAD_RTOL = 1e-4
# float32 train-step gradients, card vs CPU: summation order through the
# whole step (the CPU parity tests measure 1e-4 of each tensor's largest
# entry against JAX); tensors whose true gradient is 0 are held to 1e-6 of
# the largest gradient of the model
TRAIN_GRAD_RTOL = 1e-3
TRAIN_GRAD_FLOOR = 1e-6

# kernel launches per train step, derived from the code: each of the 12
# encoder convs runs the forward, the dgrad (every conv's input needs a
# gradient: the adversary's delta reaches conv_input's features) and the
# wgrad once; the masked statistics run under the perturber's std
# normalisation (input without gradient: forward only) and
# perturbation_losses (forward and VJP); the 17 train-mode MaskedBatchNorms
# (the perturber's 5 and the encoder's 12) run the fused forward and
# backward, each backward with bwd_reduce (their parameters train)
TRAIN_LAUNCHES = {"sparse_conv": 12, "sparse_conv_dgrad": 12, "sparse_conv_wgrad": 12,
                  "masked_stats": 2, "masked_stats_bwd": 1, "masked_batch_norm": 17,
                  "masked_batch_norm_bwd": 17, "bwd_reduce": 17}
# MaskedBatchNorms of a forward: the encoder's 12, plus the perturber's 5 under attack
BN_CLEAN, BN_ATTACK = 12, 17

# timed train steps; the prefetch queue (depth 2) and the plan its producer
# holds are full when the timing starts, so the first PREFETCHED_STEPS steps
# find their plans built and the rest show the steady state
TRAIN_STEPS = 8
PREFETCHED_STEPS = 3

# evaluation: synthetic frames per clean entry and per attack entry (B=6)
EVAL_CLEAN_FRAMES = 12
EVAL_ATTACK_FRAMES = 6
PGD_STEPS = 10  # evaluate_kitti_adversarial_attack's default


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, by_kernel: dict = None) -> float:
    """Device time per call: the kernels' own time under torch.profiler,
    without the host's launch gaps that cuda_ms sees when a call's host work
    outlasts its kernels; `by_kernel` receives each kernel's share (ms a call)."""
    import re
    import torch

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a profile that recorded no kernel at all is taken again
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            break
    if by_kernel is not None:
        for e in kernels:
            name = re.search(r"(\w+_kernel)\b", e.key)
            key = name.group(1) if name else e.key[:40]
            by_kernel[key] = by_kernel.get(key, 0.0) + e.self_device_time_total / 1e3 / iters
    return sum(e.self_device_time_total for e in kernels) / 1e3 / iters


def bound_ms(nbytes: float, ops: float, peak: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[peak]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def abba_ms(fn, prev, iters: int = 10):
    """Two designs of one function on the same inputs, timed in turns (new,
    prev, prev, new): (new ms, prev ms)."""
    a = cuda_ms(fn, iters)
    b = cuda_ms(prev, iters)
    c = cuda_ms(prev, iters)
    d = cuda_ms(fn, iters)
    return (a + d) / 2, (b + c) / 2


def _new_total():
    return {"ms": 0.0, "prev_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
            "bytes_ms": 0.0, "ops_ms": 0.0, "err": 0.0}


def _add(acc, row, nbytes, ops, peak):
    for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
        acc[key] += row[key]
    acc["prev_ms"] += row.get("prev_ms") or 0.0
    acc["bytes_ms"] += nbytes / HBM_BYTES_PER_S * 1e3
    acc["ops_ms"] += ops / PEAK_OPS[peak] * 1e3
    acc["err"] = max(acc["err"], row["max_abs_err"])


def _finish(tot):
    for v in tot.values():
        v["bound_by"] = "bytes" if v["bytes_ms"] >= v["ops_ms"] else "operations"
    return tot


def check_sparse_conv(captured, torch, f32: bool = False):
    """K1 forward on each captured (feats, kernel, idx) of the main path vs
    its plain version: the bf16 tensor-core kernel, timed beside the
    CUDA-core kernel on the same inputs (prev_ms); with f32, the float32
    route on the same convs cast to float32."""
    from robustpointclouds_tpu_torch.kernels.sparse_conv import (
        sparse_conv, sparse_conv_cuda_cores, sparse_conv_ref)

    rows, tot = [], _new_total()
    rtol, peak = (F32_CONV_RTOL, "f32") if f32 else (SPARSE_CONV_RTOL, "bf16_tensor")
    for name, feats, kernel, idx in captured:
        if f32:
            feats, kernel = feats.float(), kernel.float()
        n, cin = feats.shape
        m, k = idx.shape
        cout = kernel.shape[1]
        out = sparse_conv(feats, kernel, idx)
        ref = sparse_conv_ref(feats, kernel, idx)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        scale = max(ref.float().abs().max().item(), 1e-6)
        if not (err <= rtol * scale) or not torch.isfinite(out).all():
            raise RuntimeError(f"sparse_conv {feats.dtype} {name}: max error {err} over scale {scale}")
        feats_pad = torch.cat([feats, feats.new_zeros(1, cin)], 0)
        flat = idx.reshape(-1).long()
        if f32:
            t, t_prev = cuda_ms(lambda: sparse_conv(feats, kernel, idx), iters=5), None
        else:
            t, t_prev = abba_ms(lambda: sparse_conv(feats, kernel, idx),
                                lambda: sparse_conv_cuda_cores(feats, kernel, idx))
        t_plain = cuda_ms(lambda: sparse_conv_ref(feats, kernel, idx), iters=5)
        t_lib = cuda_ms(lambda: torch.matmul(
            torch.index_select(feats_pad, 0, flat).view(m, k * cin), kernel), iters=5)
        hits = int((idx < n).sum().item())
        eb = feats.element_size()
        nbytes = idx.numel() * 4 + n * cin * eb + kernel.numel() * eb + m * cout * eb
        ops = 2.0 * hits * cin * cout
        b_ms, by = bound_ms(nbytes, ops, peak)
        row = dict(conv=name, n=n, m=m, k=k, cin=cin, cout=cout, hits=hits, ms=t,
                   prev_ms=t_prev, plain_ms=t_plain, library_ms=t_lib, bound_ms=b_ms,
                   bound_by=by, max_abs_err=err)
        rows.append(row)
        _add(tot, row, nbytes, ops, peak)
    return rows, _finish({"fwd": tot})["fwd"]


def l2_cold(torch, tensors):
    """Copies of `tensors` to take in turn, enough to exceed the card's L2
    twice, so that back-to-back timed calls read their inputs from device
    memory, as the main path does, and not from L2."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    k = max(1, min(16, -(-2 * L2_BYTES // nbytes)))
    return [tuple(tensors)] + [tuple(t.clone() for t in tensors) for _ in range(k - 1)]


def in_turn(fn, sets):
    """A call of fn on each set of arguments in turn."""
    state = {"i": 0}

    def call():
        args = sets[state["i"] % len(sets)]
        state["i"] += 1
        return fn(*args)
    return call


def make_prev(torch):
    """The first design of K2 on the card, kept as the yardstick `prev`: the
    statistics and their VJP as the two Triton passes and the fused Triton VJP
    (kernels/masked_stats_triton.py), and MaskedBatchNorm as those statistics
    followed by the eager torch ops (nn/layers.py, ReLU, torch.where)."""
    from robustpointclouds_tpu_torch.kernels import masked_stats_triton as tri

    def stats(x, mask):
        n, c = x.shape
        out = torch.empty(2 * c + 1, dtype=torch.float32, device=x.device)
        tri.launch(x, mask.view(torch.uint8), out[:c], out[c:2 * c], out[2 * c:], n, c)
        return out[:c], out[c:2 * c], out[2 * c]

    def stats_bwd(x, mask, mean, cnt, g_mean, g_var):
        dx = torch.empty_like(x)
        tri.launch_bwd(x, mask.view(torch.uint8), mean, cnt.reshape(1), g_mean, g_var, dx,
                       x.shape[0], x.shape[1])
        return dx

    class Stats(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, mask):
            mean, var, cnt = stats(x, mask)
            ctx.save_for_backward(x, mask, mean, cnt)
            ctx.mark_non_differentiable(cnt)
            return mean, var, cnt

        @staticmethod
        def backward(ctx, g_mean, g_var, _):
            x, mask, mean, cnt = ctx.saved_tensors
            return stats_bwd(x, mask, mean, cnt, g_mean.contiguous(), g_var.contiguous()), None

    def bn(x, mask, w, b, rm, rv, train, relu, row_mask, out_dtype):
        if train:
            mu, var, _ = Stats.apply(x, mask) if x.requires_grad else stats(x, mask)
            with torch.no_grad():
                rm.mul_(0.9).add_(0.1 * mu)
                rv.mul_(0.9).add_(0.1 * var)
        else:
            mu, var = rm, rv
        y = ((x.float() - mu) * torch.rsqrt(var + 1e-3) * w + b).to(out_dtype)
        if relu:
            y = torch.relu(y)
        if row_mask:
            y = torch.where(mask[:, None], y, torch.zeros_like(y))
        return y
    return stats, stats_bwd, bn


def check_masked_stats(torch, shapes, seed, prev):
    from robustpointclouds_tpu_torch.kernels.masked_stats import (
        _stats, masked_stats, masked_stats_ref)

    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for n, c, dtype in shapes:
        x = (torch.randn(n, c, device="cuda", generator=g) * 3 + 1).to(dtype)
        mask = torch.rand(n, device="cuda", generator=g) > 0.75  # ~ the padded-slot fill
        mean, var, cnt = masked_stats(x, mask)
        rmean, rvar, rcnt = masked_stats_ref(x, mask)
        torch.cuda.synchronize()
        err = max((mean - rmean).abs().max().item(), (var - rvar).abs().max().item())
        scale = max(rvar.abs().max().item(), rmean.abs().max().item(), 1e-6)
        if not (err <= MASKED_STATS_RTOL * scale) or cnt.item() != rcnt.item():
            raise RuntimeError(f"masked_stats [{n},{c}]: max error {err} over {scale}, "
                               f"count {cnt.item()} vs {rcnt.item()}")
        again = masked_stats(x, mask)
        if not all(torch.equal(a, b) for a, b in zip(again, (mean, var, cnt))):
            raise RuntimeError(f"masked_stats [{n},{c}]: a repeat call is not bit-identical")
        # inputs in turn over copies that exceed L2. ms: the public call as
        # serving makes it (no gradient: the launch itself), timed in turns
        # with the Triton pair (prev_ms); raw_ms: that launch (_stats)
        # alone; autograd_ms: the public call on an input that needs a
        # gradient (the autograd Function); device_ms: the kernels' device time
        sets = l2_cold(torch, (x, mask))
        t, t_prev = abba_ms(in_turn(masked_stats, sets), in_turn(prev, sets))
        t_raw = cuda_ms(in_turn(_stats, sets))
        xg = x.detach().requires_grad_(True)
        t_fn = cuda_ms(lambda: masked_stats(xg, mask))
        split = {}
        t_dev = device_ms(in_turn(_stats, sets), by_kernel=split)
        t_prev_dev = device_ms(in_turn(prev, sets))
        t_plain = cuda_ms(in_turn(masked_stats_ref, sets), iters=5)
        t_lib = cuda_ms(in_turn(lambda a, m: torch.var_mean(a[m].float(), dim=0, unbiased=False),
                                sets), iters=5)
        # the bytes this data needs: the mask, x on the rows it keeps, the outputs
        nbytes = int(rcnt.item()) * c * x.element_size() + n + (2 * c + 1) * 4
        b_ms, by = bound_ms(nbytes, 5.0 * n * c, "f32")
        rows.append(dict(n=n, c=c, dtype=str(dtype).replace("torch.", ""), ms=t, prev_ms=t_prev,
                         raw_ms=t_raw, autograd_ms=t_fn, device_ms=t_dev,
                         prev_device_ms=t_prev_dev, plain_ms=t_plain, library_ms=t_lib,
                         bound_ms=b_ms, bound_by=by, max_abs_err=err, device_kernels=split))
    return rows


def check_sparse_conv_bwd(captured, torch, f32: bool = False):
    """K1 dgrad and wgrad on the (feats, weight, idx, bwd_idx, mirror, g) of
    the 12 convs of one train step, each against its plain version, as
    check_sparse_conv does for the forward."""
    from robustpointclouds_tpu_torch.kernels.sparse_conv import (
        backward_kernel, sparse_conv_cuda_cores, sparse_conv_dgrad, sparse_conv_ref,
        sparse_conv_wgrad, sparse_conv_wgrad_cuda_cores, sparse_conv_wgrad_ref)

    rows = []
    tot = {key: _new_total() for key in ("dgrad", "wgrad")}
    rtol, peak = (F32_CONV_RTOL, "f32") if f32 else (SPARSE_CONV_RTOL, "bf16_tensor")
    for name, feats, kernel, idx, bwd_idx, mirror, g in captured:
        if f32:
            feats, kernel, g = feats.float(), kernel.float(), g.float()
        n, cin = feats.shape
        m, k = idx.shape
        cout = kernel.shape[1]
        eb = feats.element_size()
        w_bwd = backward_kernel(kernel, k, mirror)
        # dgrad: the forward's kernel on (g, w_bwd, bwd_idx)
        out = sparse_conv_dgrad(g, w_bwd, bwd_idx)
        ref = sparse_conv_ref(g, w_bwd, bwd_idx)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        scale = max(ref.float().abs().max().item(), 1e-6)
        if not (err <= rtol * scale) or not torch.isfinite(out).all():
            raise RuntimeError(f"sparse_conv_dgrad {g.dtype} {name}: max error {err} over scale "
                               f"{scale}")
        g_pad = torch.cat([g, g.new_zeros(1, cout)], 0)
        bflat = bwd_idx.reshape(-1).long()
        if f32:
            t, t_prev = cuda_ms(lambda: sparse_conv_dgrad(g, w_bwd, bwd_idx), iters=5), None
        else:
            t, t_prev = abba_ms(lambda: sparse_conv_dgrad(g, w_bwd, bwd_idx),
                                lambda: sparse_conv_cuda_cores(g, w_bwd, bwd_idx))
        t_plain = cuda_ms(lambda: sparse_conv_ref(g, w_bwd, bwd_idx), iters=5)
        t_lib = cuda_ms(lambda: torch.matmul(
            torch.index_select(g_pad, 0, bflat).view(n, k * cout), w_bwd), iters=5)
        hits = int((bwd_idx < m).sum().item())
        nbytes = bwd_idx.numel() * 4 + m * cout * eb + w_bwd.numel() * eb + n * cin * eb
        ops = 2.0 * hits * cin * cout
        b_ms, by = bound_ms(nbytes, ops, peak)
        row = dict(kernel="dgrad", conv=name, n=n, m=m, k=k, cin=cin, cout=cout, hits=hits,
                   ms=t, prev_ms=t_prev, plain_ms=t_plain, library_ms=t_lib, bound_ms=b_ms,
                   bound_by=by, max_abs_err=err)
        rows.append(row)
        _add(tot["dgrad"], row, nbytes, ops, peak)
        # wgrad: dW [K*Cin, Cout] float32 over the forward index, bit-identical
        # from call to call
        dw = sparse_conv_wgrad(feats, g, idx)
        ref = sparse_conv_wgrad_ref(feats, g, idx)
        torch.cuda.synchronize()
        err = (dw - ref).abs().max().item()
        scale = max(ref.abs().max().item(), 1e-6)
        if not (err <= WGRAD_RTOL * scale) or not torch.isfinite(dw).all():
            raise RuntimeError(f"sparse_conv_wgrad {feats.dtype} {name}: max error {err} over "
                               f"scale {scale}")
        if not torch.equal(dw, sparse_conv_wgrad(feats, g, idx)):
            raise RuntimeError(f"sparse_conv_wgrad {feats.dtype} {name}: not deterministic")
        feats_pad = torch.cat([feats, feats.new_zeros(1, cin)], 0)
        flat = idx.reshape(-1).long()
        if f32:
            t, t_prev = cuda_ms(lambda: sparse_conv_wgrad(feats, g, idx), iters=5), None
        else:
            t, t_prev = abba_ms(lambda: sparse_conv_wgrad(feats, g, idx),
                                lambda: sparse_conv_wgrad_cuda_cores(feats, g, idx))
        t_plain = cuda_ms(lambda: sparse_conv_wgrad_ref(feats, g, idx), iters=5)
        t_lib = cuda_ms(lambda: torch.matmul(
            torch.index_select(feats_pad, 0, flat).view(m, k * cin).t(), g), iters=5)
        hits = int((idx < n).sum().item())
        nbytes = idx.numel() * 4 + n * cin * eb + m * cout * eb + k * cin * cout * 4
        ops = 2.0 * hits * cin * cout
        b_ms, by = bound_ms(nbytes, ops, peak)
        row = dict(kernel="wgrad", conv=name, n=n, m=m, k=k, cin=cin, cout=cout, hits=hits,
                   ms=t, prev_ms=t_prev, plain_ms=t_plain, library_ms=t_lib, bound_ms=b_ms,
                   bound_by=by, max_abs_err=err)
        rows.append(row)
        _add(tot["wgrad"], row, nbytes, ops, peak)
    return rows, _finish(tot)


def check_masked_stats_bwd(torch, shapes, seed, prev_bwd):
    """K2's VJP against its plain version; no single PyTorch call computes it."""
    from robustpointclouds_tpu_torch.kernels.masked_stats import (
        masked_stats, masked_stats_bwd, masked_stats_bwd_ref)

    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for n, c, dtype in shapes:
        x = (torch.randn(n, c, device="cuda", generator=g) * 3 + 1).to(dtype)
        mask = torch.rand(n, device="cuda", generator=g) > 0.75
        gm = torch.randn(c, device="cuda", generator=g)
        gv = torch.randn(c, device="cuda", generator=g)
        mean, _, cnt = masked_stats(x, mask)
        dx = masked_stats_bwd(x, mask, mean, cnt, gm, gv)
        ref = masked_stats_bwd_ref(x, mask, mean, cnt, gm, gv)
        torch.cuda.synchronize()
        err = (dx.float() - ref.float()).abs().max().item()
        scale = max(ref.float().abs().max().item(), 1e-6)
        dname = str(dtype).replace("torch.", "")
        if not err <= STATS_BWD_RTOL[dname] * scale:
            raise RuntimeError(f"masked_stats_bwd [{n},{c}] {dname}: max error {err} over {scale}")
        if not torch.equal(dx, masked_stats_bwd(x, mask, mean, cnt, gm, gv)):
            raise RuntimeError(f"masked_stats_bwd [{n},{c}]: a repeat call is not bit-identical")
        sets = l2_cold(torch, (x, mask))
        new = in_turn(lambda a, m: masked_stats_bwd(a, m, mean, cnt, gm, gv), sets)
        old = in_turn(lambda a, m: prev_bwd(a, m, mean, cnt, gm, gv), sets)
        t, t_prev = abba_ms(new, old)
        t_dev = device_ms(new)
        t_prev_dev = device_ms(old)
        t_plain = cuda_ms(in_turn(lambda a, m: masked_stats_bwd_ref(a, m, mean, cnt, gm, gv),
                                  sets), iters=5)
        # the mask and x on the rows it keeps read once (dx is 0 elsewhere
        # whatever x holds), dx written once
        nbytes = (int(cnt.item()) + n) * c * x.element_size() + n + (3 * c + 1) * 4
        b_ms, by = bound_ms(nbytes, 5.0 * n * c, "f32")
        rows.append(dict(n=n, c=c, dtype=dname, ms=t, prev_ms=t_prev, device_ms=t_dev,
                         prev_device_ms=t_prev_dev, plain_ms=t_plain, library_ms=None,
                         bound_ms=b_ms, bound_by=by, max_abs_err=err))
    return rows


# every MaskedBatchNorm of one full-width train step, (name, N, C, count):
# the perturber's five over the 480000 point slots (ReLU), the encoder's
# twelve (ReLU + row mask), all bf16 in and out
BN_TRAIN_SHAPES = [("perturber", 480000, 64, 3), ("perturber", 480000, 128, 2),
                   ("encoder", 96000, 16, 2), ("encoder", 96000, 32, 3),
                   ("encoder", 72000, 64, 3), ("encoder", 48000, 64, 3),
                   ("encoder", 48000, 128, 1)]


def check_masked_batch_norm(torch, seed, prev_bn):
    """The fused MaskedBatchNorm forward and backward at the main path's
    shapes, train mode (and the attack's eval mode at [480000, 128]), against
    the plain versions, bit-identical on a repeat call, timed in turns with
    the Triton statistics + eager ops (prev_ms) on the same inputs. Forward
    ms: the call without gradient (serving); backward ms: the wrapper;
    autograd_ms: the backward through autograd, the like of prev_ms. Bounds:
    the bytes this data needs (each input read once, each output written
    once) and the two-pass one (the forward reads x twice, the backward x and
    g twice)."""
    from robustpointclouds_tpu_torch.kernels.masked_stats import (
        _bn_forward, _bn_ref, masked_batch_norm, masked_batch_norm_bwd,
        masked_batch_norm_bwd_ref)

    gen = torch.Generator(device="cuda").manual_seed(seed)
    dt = torch.bfloat16
    cases = [(name, n, c, count, True) for name, n, c, count in BN_TRAIN_SHAPES]
    cases.append(("perturber eval", 480000, 128, 0, False))
    rows = []
    for name, n, c, count, train in cases:
        relu, row_mask = True, name == "encoder"
        x = (torch.randn(n, c, device="cuda", generator=gen) * 3 + 1).to(dt)
        mask = torch.rand(n, device="cuda", generator=gen) > 0.75
        w = 0.5 + torch.rand(c, device="cuda", generator=gen)
        b = torch.randn(c, device="cuda", generator=gen)
        rm = torch.randn(c, device="cuda", generator=gen)
        rv = 0.5 + torch.rand(c, device="cuda", generator=gen)
        gout = torch.randn(n, c, device="cuda", generator=gen).to(dt)
        flags = (train, 0.1, 1e-3, relu, row_mask, dt)
        y, mean, var, cnt = _bn_forward(x, mask, w, b, rm.clone(), rv.clone(), *flags)
        ref = _bn_ref(x, mask, w, b, rm.clone(), rv.clone(), *flags)[0]
        err = (y.float() - ref.float()).abs().max().item()
        if not err <= BN_RTOL * ref.float().abs().max().item():
            raise RuntimeError(f"masked_batch_norm {name} [{n},{c}]: max error {err}")
        grads = masked_batch_norm_bwd(gout, x, mask, w, b, mean, var, cnt, 1e-3, train, relu,
                                      row_mask, need_params=train)
        refs = masked_batch_norm_bwd_ref(gout, x, mask, w, b, mean, var, cnt, 1e-3, train, relu,
                                         row_mask)
        bwd_err = 0.0
        for got, r, tol in zip(grads, refs, (BN_RTOL, BN_PARAM_GRAD_RTOL, BN_PARAM_GRAD_RTOL)):
            if got is None:
                continue
            e = (got.float() - r.float()).abs().max().item()
            if not e <= tol * max(r.float().abs().max().item(), 1e-6):
                raise RuntimeError(f"masked_batch_norm_bwd {name} [{n},{c}]: max error {e}")
            bwd_err = max(bwd_err, e)
        y2 = _bn_forward(x, mask, w, b, rm.clone(), rv.clone(), *flags)[0]
        again = masked_batch_norm_bwd(gout, x, mask, w, b, mean, var, cnt, 1e-3, train, relu,
                                      row_mask, need_params=train)
        if not (torch.equal(y, y2) and all(p is None or torch.equal(p, q)
                                           for p, q in zip(grads, again))):
            raise RuntimeError(f"masked_batch_norm {name} [{n},{c}]: a repeat is not bit-identical")

        sets = l2_cold(torch, (x, mask, gout, rm.clone(), rv.clone()))
        new_f = in_turn(lambda a, m, _g, r1, r2: masked_batch_norm(
            a, m, w, b, r1, r2, train, relu=relu, row_mask=row_mask, out_dtype=dt), sets)
        old_f = in_turn(lambda a, m, _g, r1, r2: prev_bn(a, m, w, b, r1, r2, train, relu,
                                                         row_mask, dt), sets)
        t, t_prev = abba_ms(new_f, old_f)
        split_f, split_b = {}, {}
        t_dev, t_prev_dev = device_ms(new_f, by_kernel=split_f), device_ms(old_f)
        t_plain = cuda_ms(in_turn(lambda a, m, _g, r1, r2: _bn_ref(a, m, w, b, r1, r2, *flags)[0],
                                  sets), iters=5)
        # the backward, through autograd (new and prev) and the wrapper alone
        wg, bg = w.clone().requires_grad_(train), b.clone().requires_grad_(train)
        graphs_new, graphs_old, wrapped = [], [], []
        for a, m, gg, r1, r2 in sets:
            xg = a.detach().requires_grad_(True)
            leaves = (xg, wg, bg) if train else (xg,)
            yn = masked_batch_norm(xg, m, wg, bg, r1, r2, train, relu=relu, row_mask=row_mask,
                                   out_dtype=dt)
            yo = prev_bn(xg, m, wg, bg, r1, r2, train, relu, row_mask, dt)
            graphs_new.append((yn, leaves, gg))
            graphs_old.append((yo, leaves, gg))
            _, mn, vr, cn = _bn_forward(a, m, w, b, r1.clone(), r2.clone(), *flags)
            wrapped.append((gg, a, m, mn, vr, cn))

        def backward(yy, leaves, gg):
            return torch.autograd.grad(yy, leaves, gg, retain_graph=True)
        bnew, bold = in_turn(backward, graphs_new), in_turn(backward, graphs_old)
        tb_fn, tb_prev = abba_ms(bnew, bold)
        wrap = in_turn(lambda gg, a, m, mn, vr, cn: masked_batch_norm_bwd(
            gg, a, m, w, b, mn, vr, cn, 1e-3, train, relu, row_mask, need_params=train), wrapped)
        tb = cuda_ms(wrap)
        tb_dev, tb_prev_dev = device_ms(wrap, by_kernel=split_b), device_ms(bold)
        tb_plain = cuda_ms(in_turn(lambda gg, a, m, mn, vr, cn: masked_batch_norm_bwd_ref(
            gg, a, m, w, b, mn, vr, cn, 1e-3, train, relu, row_mask), wrapped), iters=5)
        del graphs_new, graphs_old, wrapped, sets

        # bound_ms counts the bytes this data needs: x (and g) on
        # every row, or with the row mask only on the rows it keeps (the
        # statistics read no others), y or dx written once, the mask once;
        # the two-pass bound reads x (and g) twice in train mode
        eb, small = x.element_size(), 6 * c * 4
        passes = 2 if train else 1
        rows_in = int(mask.sum().item()) if row_mask else n
        f_one = (rows_in + n) * c * eb + n + small
        f_two = (passes + 1) * n * c * eb + passes * n + small
        b_one = (2 * rows_in + n) * c * eb + n + small
        b_two = (2 * passes + 1) * n * c * eb + passes * n + small
        fb, fby = bound_ms(f_one, 8.0 * n * c, "f32")
        bb, bby = bound_ms(b_one, 12.0 * n * c, "f32")
        common = dict(name=name, n=n, c=c, count=count, train=train, relu=relu,
                      row_mask=row_mask)
        rows.append(dict(common, kernel="masked_batch_norm", ms=t, prev_ms=t_prev,
                         device_ms=t_dev, prev_device_ms=t_prev_dev, plain_ms=t_plain,
                         library_ms=None, bound_ms=fb, bound_by=fby,
                         bound_two_pass_ms=f_two / HBM_BYTES_PER_S * 1e3, max_abs_err=err,
                         device_kernels=split_f))
        rows.append(dict(common, kernel="masked_batch_norm_bwd", ms=tb, autograd_ms=tb_fn,
                         prev_ms=tb_prev, device_ms=tb_dev, prev_device_ms=tb_prev_dev,
                         plain_ms=tb_plain, library_ms=None, bound_ms=bb, bound_by=bby,
                         bound_two_pass_ms=b_two / HBM_BYTES_PER_S * 1e3, max_abs_err=bwd_err,
                         device_kernels=split_b))
    return rows


def bn_step_total(rows, kernel):
    """One train step's sum over its 17 MaskedBatchNorms (count x each shape)."""
    tot = {k: 0.0 for k in ("ms", "prev_ms", "device_ms", "prev_device_ms", "plain_ms",
                            "bound_ms", "bound_two_pass_ms")}
    err = 0.0
    for r in rows:
        if r["kernel"] == kernel and r["train"]:
            for k in tot:
                tot[k] += r["count"] * r[k]
            err = max(err, r["max_abs_err"])
    return dict(tot, max_abs_err=err)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=3, help="clean and attack requests each")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "robustpointclouds_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import numpy as np

    from robustpointclouds_tpu_torch.cli import evaluate_kitti_3class as eval_cli
    from robustpointclouds_tpu_torch.cli import evaluate_kitti_adversarial_attack as attack_cli
    from robustpointclouds_tpu_torch.cli.common import (
        prefetch_iterator, run_evaluation, synthetic_loader, with_plans)
    from robustpointclouds_tpu_torch.cli.export import export_serving
    from robustpointclouds_tpu_torch.data.native_plan import build_plan_native
    from robustpointclouds_tpu_torch.data.synthetic import synthetic_kitti_batch
    from robustpointclouds_tpu_torch.kernels import _build
    from robustpointclouds_tpu_torch.kernels.gather import (
        gather_elems, gather_onehot, gather_row_loop, gather_rows)
    from robustpointclouds_tpu_torch.kernels.masked_stats import (
        masked_batch_norm, masked_batch_norm_bwd, masked_stats, masked_stats_bwd)
    from robustpointclouds_tpu_torch.kernels.sparse_conv import (
        sparse_conv, sparse_conv_dgrad, sparse_conv_wgrad)
    from robustpointclouds_tpu_torch.models.detection import anchor_head_predict
    from robustpointclouds_tpu_torch.models.voxelnet import (
        AdversarialVoxelNet, VoxelNetConfig, init_weights, plan_to_device)
    from robustpointclouds_tpu_torch.nn.sparse_encoder import SparseConv3d
    from robustpointclouds_tpu_torch.ops.voxelize import VoxelizerConfig
    from robustpointclouds_tpu_torch.tools import probe_gather
    from robustpointclouds_tpu_torch.train.checkpoint import CheckpointManager
    from robustpointclouds_tpu_torch.train.loop import TrainConfig, Trainer

    counters = {"sparse_conv": sparse_conv, "sparse_conv_dgrad": sparse_conv_dgrad,
                "sparse_conv_wgrad": sparse_conv_wgrad, "masked_stats": masked_stats,
                "masked_stats_bwd": masked_stats_bwd, "masked_batch_norm": masked_batch_norm,
                "masked_batch_norm_bwd": masked_batch_norm_bwd}
    gather_counters = {"gather_rows": gather_rows, "gather_elems": gather_elems,
                       "gather_row_loop": gather_row_loop, "gather_onehot": gather_onehot}

    conv_counters = {k: counters[k]
                     for k in ("sparse_conv", "sparse_conv_dgrad", "sparse_conv_wgrad")}

    def zero_counts():
        for fn in (*counters.values(), *gather_counters.values()):
            fn.launches = 0
        for fn in conv_counters.values():
            fn.cuda_core_launches = 0
        masked_batch_norm_bwd.reduce_launches = 0

    def read_counts():
        """Launches per wrapper; bwd_reduce: the BN backward calls that ran it."""
        return {**{k: fn.launches for k, fn in counters.items()},
                "bwd_reduce": masked_batch_norm_bwd.reduce_launches}

    def read_core_counts():
        """The sparse-conv launches that took the float32 route's CUDA-core kernels."""
        return {k: fn.cuda_core_launches for k, fn in conv_counters.items()}

    def expect_tensor_cores(path):
        core = read_core_counts()
        if any(core.values()):
            raise RuntimeError(f"the bf16 {path} path reached the CUDA-core kernels: {core}")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- phase 1: card and build
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    t0 = time.time()
    sources = ("sparse_conv_tc", "sparse_conv", "gather_probe", "masked_stats")
    handles = [(n, *_build.start_build(n)) for n in sources]  # one nvcc per source
    for _, handle, so in handles:
        _build.finish_build(handle, so)
    for n in sources:
        _build.load_library(n)
    nvcc_s = time.time() - t0
    # the tensor-core kernels must have compiled to bf16 tensor-core products
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", _build.library_path("sparse_conv_tc")],
                          capture_output=True, text=True, timeout=120, check=True).stdout
    hmma = sum(1 for line in sass.splitlines() if "HMMA" in line and "BF16" in line)
    if hmma == 0:
        raise RuntimeError("no bf16 HMMA instruction in the tensor-core sparse-conv library")
    # and the one-hot gather probe to fp16 tensor-core products
    sass = subprocess.run([cuobjdump, "--dump-sass", _build.library_path("gather_probe")],
                          capture_output=True, text=True, timeout=120, check=True).stdout
    hmma_probe = sum(1 for line in sass.splitlines() if "HMMA" in line)
    if hmma_probe == 0:
        raise RuntimeError("no HMMA instruction in the gather probe library")
    print(f"build: {' + '.join(sources)} nvcc in parallel {nvcc_s:.1f} s", flush=True)
    print(f"sass: {hmma} bf16 HMMA instructions in "
          f"{os.path.basename(_build.library_path('sparse_conv_tc'))}, {hmma_probe} HMMA in "
          f"{os.path.basename(_build.library_path('gather_probe'))}", flush=True)

    # ---- the full-width model and a B=6 request stream
    cfg = VoxelNetConfig()
    model = AdversarialVoxelNet(cfg)
    init_weights(model, torch.Generator().manual_seed(args.seed))
    anchors, _ = cfg.make_anchors()
    serve = export_serving(model, None, anchors, cfg.head)
    rng = np.random.RandomState(args.seed)

    def request_batch():
        b = synthetic_kitti_batch(rng, batch_size=6, num_points=20000, max_gt=20,
                                  num_objects=8, point_range=cfg.voxelizer.point_cloud_range)
        return b.points, b.points_mask

    pts, msk = request_batch()
    plan = build_plan_native(pts, msk, cfg.voxelizer, 4)
    n_vox = int(plan["voxel_mask"].sum())
    print(f"plan: B=6, {n_vox} voxels, {int(plan['point_mask'].sum())} points in slots "
          f"of {plan['point_mask'].size}", flush=True)

    # ---- phase 2: kernels on the main path's own inputs
    captured = []
    hooks = [mod.register_forward_pre_hook(
        lambda mod, a, name=name: captured.append(
            (name, a[0].contiguous(), mod.img2col_kernel(a[0].dtype), a[1])))
        for name, mod in model.named_modules() if isinstance(mod, SparseConv3d)]
    serve(pts, msk, plan, attack=True)
    for h in hooks:
        h.remove()
    if len(captured) != 12:
        raise RuntimeError(f"expected 12 sparse convs on the path, saw {len(captured)}")
    conv_rows, conv_tot = check_sparse_conv(captured, torch)
    f32_conv_rows, f32_conv_tot = check_sparse_conv(captured, torch, f32=True)
    del captured
    for r in conv_rows:
        print("sparse_conv " + json.dumps(r), flush=True)
    for r in f32_conv_rows:
        print("sparse_conv float32 " + json.dumps(r), flush=True)
    t0 = time.time()
    prev_stats, prev_stats_bwd, prev_bn = make_prev(torch)
    stats_rows = check_masked_stats(
        torch, [(480000, 4, torch.float32), (96000, 64, torch.float32),
                (96000, 64, torch.bfloat16)], args.seed, prev_stats)
    for r in stats_rows:
        print("masked_stats " + json.dumps(r), flush=True)
    bn_rows = check_masked_batch_norm(torch, args.seed, prev_bn)
    for r in bn_rows:
        print("masked_batch_norm " + json.dumps(r), flush=True)
    bn_tot = {k: bn_step_total(bn_rows, k) for k in ("masked_batch_norm",
                                                      "masked_batch_norm_bwd")}
    for k, tot in bn_tot.items():
        print(f"{k} over the 17 BNs of a train step: {tot['ms']:.4f} ms (device "
              f"{tot['device_ms']:.4f}), Triton statistics + eager ops on the same inputs "
              f"{tot['prev_ms']:.4f} ms (device {tot['prev_device_ms']:.4f}), bound "
              f"{tot['bound_ms']:.4f} ms (two-pass {tot['bound_two_pass_ms']:.4f})", flush=True)
    print(f"K2 checks and timing (Triton yardstick compiled at its first launch): "
          f"{time.time() - t0:.1f} s", flush=True)

    # the trainer (full width, bf16, B=6) and its input pipeline: host plans
    # (native plan + anchor assignment) built in the prefetch thread
    trainer = Trainer(cfg, TrainConfig(), device=dev)
    trainer.init_state(args.seed)
    builder = trainer.make_plan_builder()
    loader = synthetic_loader(6, 1 + TRAIN_STEPS, num_points=20000, seed=args.seed,
                              point_range=cfg.voxelizer.point_cloud_range)
    train_iter = prefetch_iterator(with_plans(builder, loader(0)))

    # warm-up train step, capturing each conv's inputs and output cotangent
    train_captured, grads_out = [], {}

    def capture_inputs(mod, a, name):
        train_captured.append((name, a[0].detach().contiguous(),
                               mod.img2col_kernel(a[0].dtype).detach(), a[1], a[2], a[3]))

    def capture_g(mod, a, out, name):
        out.register_hook(lambda g: grads_out.__setitem__(name, g.contiguous()))

    convs = [(n, m) for n, m in trainer.model.named_modules() if isinstance(m, SparseConv3d)]
    hooks = [m.register_forward_pre_hook(lambda mod, a, name=n: capture_inputs(mod, a, name))
             for n, m in convs]
    hooks += [m.register_forward_hook(lambda mod, a, out, name=n: capture_g(mod, a, out, name))
              for n, m in convs]
    batch, tplan = next(train_iter)
    t0 = time.perf_counter()
    warm_logs = trainer.train_step(batch, epoch=3, plan=tplan)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    for h in hooks:
        h.remove()
    if len(train_captured) != 12 or len(grads_out) != 12:
        raise RuntimeError(f"expected 12 sparse convs in the train step, saw "
                           f"{len(train_captured)} inputs and {len(grads_out)} cotangents")
    print(f"train warm-up step: {warm_ms:.1f} ms, loss {float(warm_logs['loss']):.4f}, "
          f"num_pos {float(warm_logs['num_pos']):.0f}", flush=True)
    bwd_inputs = [(*c, grads_out[c[0]]) for c in train_captured]
    bwd_rows, bwd_tot = check_sparse_conv_bwd(bwd_inputs, torch)
    f32_bwd_rows, f32_bwd_tot = check_sparse_conv_bwd(bwd_inputs, torch, f32=True)
    del train_captured, grads_out, bwd_inputs
    for r in bwd_rows:
        print("sparse_conv_bwd " + json.dumps(r), flush=True)
    for r in f32_bwd_rows:
        print("sparse_conv_bwd float32 " + json.dumps(r), flush=True)
    for key, new, tot in (("sparse_conv", "fwd", conv_tot), ("sparse_conv_dgrad", "dgrad",
                                                             bwd_tot["dgrad"]),
                          ("sparse_conv_wgrad", "wgrad", bwd_tot["wgrad"])):
        print(f"{key} over the 12 convs: tensor cores {tot['ms']:.4f} ms, CUDA-core kernel on the "
              f"same bf16 inputs {tot['prev_ms']:.4f} ms ({tot['prev_ms'] / tot['ms']:.2f}x), "
              f"index_select + matmul {tot['library_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms",
              flush=True)
    stats_bwd_rows = check_masked_stats_bwd(
        torch, [(480000, 4, torch.float32), (480000, 128, torch.float32),
                (480000, 128, torch.bfloat16), (96000, 64, torch.float32),
                (96000, 64, torch.bfloat16)], args.seed, prev_stats_bwd)
    for r in stats_bwd_rows:
        print("masked_stats_bwd " + json.dumps(r), flush=True)

    # ---- phase 3: serving
    requests = [(request_batch(), attack) for attack in (False, True)
                for _ in range(args.requests)]
    for (p, m), attack in requests[:1] + requests[args.requests:args.requests + 1]:
        serve(p, m, build_plan_native(p, m, cfg.voxelizer, 4), attack=attack)  # warm-up
    torch.cuda.synchronize()
    zero_counts()
    timings = []
    for (p, m), attack in requests:
        t0 = time.perf_counter()
        rplan = build_plan_native(p, m, cfg.voxelizer, 4)
        t1 = time.perf_counter()
        boxes, scores, labels, valid = serve(p, m, rplan, attack=attack)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if boxes.shape != (6, cfg.head.max_num, 7) or scores.shape != (6, cfg.head.max_num):
            raise RuntimeError(f"unexpected output shapes {boxes.shape} {scores.shape}")
        if not (torch.isfinite(boxes).all() and torch.isfinite(scores).all()):
            raise RuntimeError("non-finite detections")
        if labels.min() < 0 or labels.max() >= cfg.num_classes:
            raise RuntimeError("label out of range")
        timings.append(dict(attack=attack, plan_ms=(t1 - t0) * 1e3, serve_ms=(t2 - t1) * 1e3,
                            valid=int(valid.sum())))
    launches = read_counts()
    expect_tensor_cores("serving")
    n_clean = n_attack = args.requests
    expected = {"sparse_conv": 12 * (n_clean + n_attack), "sparse_conv_dgrad": 0,
                "sparse_conv_wgrad": 0, "masked_stats": 2 * n_attack, "masked_stats_bwd": 0,
                "masked_batch_norm": BN_CLEAN * n_clean + BN_ATTACK * n_attack,
                "masked_batch_norm_bwd": 0, "bwd_reduce": 0}
    if launches != expected:
        raise RuntimeError(f"unexpected kernel launches on the serving path: {launches}")
    for t in timings:
        print("request " + json.dumps(t), flush=True)
    for attack in (False, True):
        sel = [t for t in timings if t["attack"] == attack]
        print(f"serving {'attack' if attack else 'clean'}: mean serve_ms "
              f"{sum(t['serve_ms'] for t in sel) / len(sel):.3f}, mean plan_ms "
              f"{sum(t['plan_ms'] for t in sel) / len(sel):.3f}; per request: sparse_conv 12 "
              f"launches, masked_stats {2 if attack else 0}, masked_batch_norm "
              f"{BN_ATTACK if attack else BN_CLEAN}", flush=True)

    # ---- phase 4: training, timed steps at epoch 3 (adversary on)
    names = ("middle_encoder.conv_input.0.weight", "backbone.blocks.0.0.weight",
             "adversary.mlp_0.weight", "adversary.mlp_out.weight")
    params = dict(trainer.model.named_parameters())
    before = {k: params[k].detach().clone() for k in names}
    torch.cuda.synchronize()
    zero_counts()
    steps = []
    t_all = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        batch, tplan = next(train_iter)
        t1 = time.perf_counter()
        logs = trainer.train_step(batch, epoch=3, plan=tplan)
        logs = {k: float(v) for k, v in logs.items()}  # waits for the step
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if not all(np.isfinite(v) for v in logs.values()):
            raise RuntimeError(f"non-finite train logs: {logs}")
        if logs["num_pos"] <= 0:
            raise RuntimeError("train step without positive anchors")
        steps.append(dict(wait_ms=(t1 - t0) * 1e3, step_ms=(t2 - t1) * 1e3, loss=logs["loss"],
                          num_pos=logs["num_pos"], l2=logs["perturbation_l2_norm"]))
    train_s = time.perf_counter() - t_all
    train_launches = read_counts()
    expect_tensor_cores("training")
    for rest in train_iter:  # drain the prefetch thread
        pass
    expected = {k: v * TRAIN_STEPS for k, v in TRAIN_LAUNCHES.items()}
    if train_launches != expected:
        raise RuntimeError(f"unexpected kernel launches on the training path: {train_launches}, "
                           f"expected {expected}")
    if int(trainer.state.nan_count) != 0:
        raise RuntimeError("NaN steps during the timed training")
    for k in names:
        if torch.equal(before[k], params[k].detach()):
            raise RuntimeError(f"parameter {k} did not move in training")
    for st in steps:
        print("train step " + json.dumps(st), flush=True)
    mean_step = sum(st["step_ms"] for st in steps) / len(steps)
    # in the steady state each step waits for as long as the plan build
    # outlasts a step
    steady = steps[PREFETCHED_STEPS:]
    steady_s = sum(st["wait_ms"] + st["step_ms"] for st in steady) / 1e3
    builds = list(builder.timings)
    for key in ("native_ms", "assign_ms", "plan_ms"):
        print(f"plan build {key} (prefetch thread, {len(builds)} builds): "
              f"{json.dumps([b[key] for b in builds])}", flush=True)
    print(f"training B=6 full width: mean step_ms {mean_step:.3f} (host clock, step to "
          f"synchronise); {6 * len(steps) / train_s:.3f} frames/s over all {len(steps)} "
          f"timed steps; steady state over the last {len(steady)}: "
          f"{6 * len(steady) / steady_s:.3f} frames/s, mean wait for a plan "
          f"{sum(st['wait_ms'] for st in steady) / len(steady):.3f} ms; mean plan build "
          f"{sum(b['plan_ms'] for b in builds) / len(builds):.3f} ms (native plan "
          f"{sum(b['native_ms'] for b in builds) / len(builds):.3f}, anchor assignment "
          f"{sum(b['assign_ms'] for b in builds) / len(builds):.3f}); per step: "
          + ", ".join(f"{k} {v}" for k, v in TRAIN_LAUNCHES.items()), flush=True)

    # phase 6 starts from phase 4's trained state, saved by the port's
    # checkpoint manager into the git-ignored work_dirs/
    ckpt_dir = os.path.join(REPO, "work_dirs", "chip_smoke_eval")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    t0 = time.perf_counter()
    CheckpointManager(ckpt_dir).save(3, trainer)
    print(f"checkpoint: the trained state saved as epoch 3 in "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms", flush=True)
    del trainer, builder, train_iter

    # ---- small-input reference: float32 forward on the card vs on the CPU
    small = cfg._replace(
        voxelizer=VoxelizerConfig((0.0, -8.0, -3.0, 16.0, 8.0, 1.0), (0.5, 0.5, 0.125), 3, 512),
        anchor_ranges=tuple((0, -8.0, -0.6, 16.0, 8.0, -0.6) for _ in range(3)),
        compute_dtype="float32")
    srng = np.random.RandomState(args.seed + 1)
    sb = synthetic_kitti_batch(srng, batch_size=2, num_points=600, max_gt=4, num_objects=3,
                               point_range=small.voxelizer.point_cloud_range)
    splan = build_plan_native(sb.points, sb.points_mask, small.voxelizer, 4)
    smodel = AdversarialVoxelNet(small)
    init_weights(smodel, torch.Generator().manual_seed(args.seed))
    smodel.eval()
    with torch.no_grad():
        ref = smodel(None, None, False, 100, True, -1.0, plan_to_device(splan, torch.device("cpu")))
        zero_counts()  # the float32 route's launches: this forward and the train step below
        got = smodel.to(dev)(None, None, False, 100, True, -1.0, plan_to_device(splan, dev))
    for name in ("cls_scores", "bbox_preds", "dir_preds"):
        r, g = getattr(ref, name), getattr(got, name).cpu()
        err = (r - g).abs().max().item()
        if not err <= E2E_F32_RTOL * max(r.abs().max().item(), 1e-6):
            raise RuntimeError(f"small-grid float32 {name}: card vs CPU max error {err}")
    # decode + rotated NMS on the card vs the CPU, on the same head outputs;
    # score_thr 0 gives the sweep boxes to suppress under random weights
    shead = small.head._replace(score_thr=0.0)
    sanchors = torch.as_tensor(small.make_anchors()[0])
    (cb, cs, cl, cv), (gb, gs, gl, gv) = [
        anchor_head_predict(ref.cls_scores.to(d), ref.bbox_preds.to(d), ref.dir_preds.to(d),
                            sanchors.to(d), shead) for d in (torch.device("cpu"), dev)]
    gb, gs, gl, gv = gb.cpu(), gs.cpu(), gl.cpu(), gv.cpu()
    if not (torch.equal(cv, gv) and torch.equal(cl[cv], gl[gv]) and int(cv.sum()) > 0):
        raise RuntimeError("small-grid decode + NMS: card and CPU keep different detections")
    box_err = (cb[cv] - gb[gv]).abs().max().item()
    score_err = (cs[cv] - gs[gv]).abs().max().item()
    if not (box_err <= E2E_F32_RTOL * cb[cv].abs().max().item() and score_err <= 1e-6):
        raise RuntimeError(f"small-grid decode + NMS: box error {box_err}, score error {score_err}")
    print(f"small-grid float32 forward and decode + NMS ({int(cv.sum())} detections): "
          f"card agrees with the CPU", flush=True)

    # small-grid float32 train step: gradients on the card vs on the CPU
    import robustpointclouds_tpu_torch.nn.perturber as perturber

    perturber.PERT_BF16 = False
    tb = synthetic_kitti_batch(np.random.RandomState(args.seed + 2), batch_size=2, num_points=600,
                               max_gt=8, num_objects=3,
                               point_range=small.voxelizer.point_cloud_range)
    grads = []
    sd = None
    for d in (torch.device("cpu"), dev):
        tr = Trainer(small, TrainConfig(), device=d)
        tr.init_state(args.seed, state_dict=sd)
        sd = sd or {k: v.cpu() for k, v in tr.model.state_dict().items()}
        splan_t = tr.make_plan_builder()(tb.points, tb.points_mask, tb.gt_boxes, tb.gt_labels,
                                         tb.gt_mask)
        gt, splan_d = tr._to_device(tb, splan_t)
        g_d, logs_d, nan_d = tr._grads(gt, 5.0, splan_d)
        if bool(nan_d):
            raise RuntimeError(f"small-grid train step on {d} is a NaN step")
        grads.append(({k: v.cpu() for k, v in g_d.items()}, float(logs_d["loss"])))
    perturber.PERT_BF16 = True
    f32_launches = read_core_counts()
    if f32_launches != {k: read_counts()[k] for k in f32_launches} or not all(
            f32_launches.values()):
        raise RuntimeError(f"float32 small-grid path: CUDA-core launches {f32_launches}, all "
                           f"launches {read_counts()}")
    (gc, lc), (gg, lg) = grads
    gmax = max(v.abs().max().item() for v in gc.values())
    worst = 0.0
    for k, ref in gc.items():
        scale = max(ref.abs().max().item(), TRAIN_GRAD_FLOOR * gmax / TRAIN_GRAD_RTOL)
        err = (gg[k] - ref).abs().max().item()
        worst = max(worst, err / scale)
        if not err <= TRAIN_GRAD_RTOL * scale:
            raise RuntimeError(f"small-grid float32 train gradient {k}: card vs CPU error {err} "
                               f"over scale {scale}")
    if not abs(lc - lg) <= 1e-4 * abs(lc):
        raise RuntimeError(f"small-grid float32 train loss: card {lg} vs CPU {lc}")
    print(f"small-grid float32 train step: {len(gc)} gradients agree card vs CPU "
          f"(worst {worst:.2e} of scale), loss {lg:.6f} vs {lc:.6f}; float32 forward + train "
          f"step on the CUDA-core kernels: {json.dumps(f32_launches)}", flush=True)

    # ---- phase 5: the gather probes through their tool's entry point
    zero_counts()
    probe = probe_gather.main([])
    probe_launches = {k: fn.launches for k, fn in gather_counters.items()}
    wrong = [f"{r['label']} at [{r['n']}, {r['c']}] x {r['m']}"
             for rows in probe.values() for r in rows if r["max_abs_err"] != 0.0]
    if wrong:
        raise RuntimeError(f"gather kernels disagree with their plain versions: {wrong}")
    small = {r["kernel"]: r for r in probe["small"]}
    scale = {r["kernel"]: r for r in probe["scale"]}
    if set(scale) != {"gather_rows", "gather_elems", "gather_row_loop"} or not all(
            probe_launches.values()):
        raise RuntimeError(f"gather probe: timed {sorted(scale)}, launches {probe_launches}")
    print(f"gather probe launches: {json.dumps(probe_launches)}", flush=True)

    # ---- phase 6: evaluation through the CLIs' entry points, from the checkpoint
    classes = cfg.class_names
    lidar_keys = {f"{c}_{m}_{d}" for c in classes for m in ("3d", "bev")
                  for d in ("easy", "moderate", "hard")} | {"mAP_3d_moderate", "num_frames"}
    image_keys = {f"{c}_{m}_{d}" for c in classes for m in ("2d", "aos")
                  for d in ("easy", "moderate", "hard")}

    def expect(batches, fwd_per_batch, dgrad_per_batch=0, stats_per_batch=0, bn_per_batch=12,
               bn_bwd_per_batch=0):
        """Launches of an evaluation entry: eval-mode BNs with frozen
        parameters, so no bwd_reduce and no wgrad."""
        return {"sparse_conv": fwd_per_batch * batches,
                "sparse_conv_dgrad": dgrad_per_batch * batches, "sparse_conv_wgrad": 0,
                "masked_stats": stats_per_batch * batches, "masked_stats_bwd": 0,
                "masked_batch_norm": bn_per_batch * batches,
                "masked_batch_norm_bwd": bn_bwd_per_batch * batches, "bwd_reduce": 0}

    eval_summary = {}

    def eval_entry(name, entry, argv, expected, keys, frames):
        zero_counts()
        timings = {}
        t0 = time.perf_counter()
        res = entry(argv, timings=timings)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        got = read_counts()
        if got != expected:
            raise RuntimeError(f"eval {name}: kernel launches {got}, expected {expected}")
        for run, r in res.items():
            if r is None or set(r) != keys or r["num_frames"] != frames:
                raise RuntimeError(f"eval {name} {run}: {r if r is None else sorted(set(r) ^ keys)}"
                                   f", {None if r is None else r['num_frames']} frames")
            t = timings[run]
            for i, b in enumerate(t["batches"]):
                print(f"eval {name} {run} batch {i}: " + json.dumps(b), flush=True)
            mean = {k: sum(b[k] for b in t["batches"]) / len(t["batches"])
                    for k in ("plan_ms", "device_ms", "metric_ms")}
            mean["ap_ms"] = t["ap_ms"]
            eval_summary[f"{name} {run}"] = mean
            print(f"eval {name} {run} (B=6, full width, {len(t['batches'])} batches): mean per "
                  f"batch " + ", ".join(f"{k} {v:.3f}" for k, v in mean.items())
                  + f"; mAP_3d_moderate {r['mAP_3d_moderate']:.3f}", flush=True)
        print(f"eval {name}: {wall_s:.2f} s through the entry point; launches {json.dumps(got)}",
              flush=True)

    kitti_mini = os.path.join(REPO, "tests", "fixtures", "kitti_mini")
    n_clean = EVAL_CLEAN_FRAMES // 6
    n_attack = EVAL_ATTACK_FRAMES // 6
    eval_entry("clean synthetic", eval_cli.main,
               ["--mode", "clean", "--checkpoint", ckpt_dir, "--synthetic", "--limit",
                str(EVAL_CLEAN_FRAMES)], expect(n_clean, 12), lidar_keys, EVAL_CLEAN_FRAMES)
    # the fixture's val split lists one frame: one batch of 1 frame + 5 padding rows
    eval_entry("clean kitti_mini", eval_cli.main,
               ["--mode", "clean", "--checkpoint", ckpt_dir, "--data-root", kitti_mini],
               expect(1, 12), lidar_keys | image_keys, 1)
    eval_entry("learned", attack_cli.main,
               ["--checkpoint", ckpt_dir, "--synthetic", "--limit", str(EVAL_ATTACK_FRAMES),
                "--method", "learned"],
               expect(n_attack, 12 + 12, 0, 2, BN_CLEAN + BN_ATTACK), lidar_keys,
               EVAL_ATTACK_FRAMES)
    eval_entry("pgd", attack_cli.main,
               ["--checkpoint", ckpt_dir, "--synthetic", "--limit", str(EVAL_ATTACK_FRAMES),
                "--method", "pgd", "--pgd-steps", str(PGD_STEPS)],
               expect(n_attack, 12 + 12 * (PGD_STEPS + 1), 12 * PGD_STEPS, 0,
                      BN_CLEAN * (PGD_STEPS + 2), BN_CLEAN * PGD_STEPS), lidar_keys,
               EVAL_ATTACK_FRAMES)

    # the device's idle share over one synthetic batch of each path
    etr = Trainer(cfg, TrainConfig(), device=dev)
    etr.init_state(args.seed)
    CheckpointManager(ckpt_dir).restore(etr)
    ebatch = next(iter(synthetic_loader(6, 1, num_points=20000, seed=999,
                                        point_range=cfg.voxelizer.point_cloud_range)(0)))
    for name, kw in (("clean", {}), ("learned", dict(attack=True)),
                     ("pgd", dict(attack=True, attack_method="pgd", attack_steps=PGD_STEPS))):
        run_evaluation(etr, [ebatch], **kw)  # warm-up
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_evaluation(etr, [ebatch], **kw)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        print(f"eval {name} under torch.profiler (one B=6 batch): device busy {busy_ms:.3f} ms "
              f"of {wall_ms:.3f} ms, idle share {1.0 - busy_ms / wall_ms:.3f}", flush=True)
    del etr

    k2 = stats_rows[0]
    conv_src = "robustpointclouds_tpu_torch/csrc/sparse_conv_tc.cu"
    core_src = "robustpointclouds_tpu_torch/csrc/sparse_conv.cu"
    mp_gather = "robustpointclouds_tpu/kernels/mp_gather.py:192"

    def conv_row(name, src, n_launches, tot, prev=True):
        row = {"name": name, "route": "cuda", "source": src, "replaces": mp_gather,
               "launches": n_launches, "max_abs_err": tot["err"], "ms": tot["ms"],
               "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
               "bound_by": tot["bound_by"], "library_ms": tot["library_ms"]}
        if prev:  # the CUDA-core kernel on the same bf16 inputs
            row["prev_ms"] = tot["prev_ms"]
        return row

    k2_src = "robustpointclouds_tpu_torch/csrc/masked_stats.cu"
    k2_tpu = "robustpointclouds_tpu/kernels/masked_stats.py"

    def k2_row(name, line, n_launches, row, bound_by="bytes"):
        return {"name": name, "route": "cuda", "source": k2_src, "replaces": f"{k2_tpu}:{line}",
                "launches": n_launches, "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "prev_ms": row["prev_ms"], "device_ms": row["device_ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row.get("bound_by", bound_by), "library_ms": row["library_ms"]}

    kernels = [
        conv_row("sparse_conv", conv_src, launches["sparse_conv"], conv_tot),
        k2_row("masked_stats", 113, launches["masked_stats"], k2),
        # one train step's 17 BNs, summed; launches over the timed train steps
        dict(k2_row("masked_batch_norm", 63, train_launches["masked_batch_norm"],
                    dict(bn_tot["masked_batch_norm"], library_ms=None)),
             bound_two_pass_ms=bn_tot["masked_batch_norm"]["bound_two_pass_ms"]),
        dict(k2_row("masked_batch_norm_bwd", 102, train_launches["masked_batch_norm_bwd"],
                    dict(bn_tot["masked_batch_norm_bwd"], library_ms=None)),
             bound_two_pass_ms=bn_tot["masked_batch_norm_bwd"]["bound_two_pass_ms"]),
    ]
    for key in ("dgrad", "wgrad"):
        kernels.append(conv_row(f"sparse_conv_{key}", conv_src,
                                train_launches[f"sparse_conv_{key}"], bwd_tot[key]))
    # the float32 route: launches from the small-grid float32 forward + train step
    for key, tot in (("", f32_conv_tot), ("_dgrad", f32_bwd_tot["dgrad"]),
                     ("_wgrad", f32_bwd_tot["wgrad"])):
        kernels.append(conv_row(f"sparse_conv{key}_f32", core_src,
                                f32_launches[f"sparse_conv{key}"], tot, prev=False))
    kernels.append(k2_row("masked_stats_bwd", 102, train_launches["masked_stats_bwd"],
                          stats_bwd_rows[0]))
    probe_src = "robustpointclouds_tpu_torch/csrc/gather_probe.cu"
    probe_tpu = "robustpointclouds_tpu/tools/probe_mosaic_gather.py"
    for name, row, line in (("gather_rows", scale["gather_rows"], 118),
                            ("gather_elems", scale["gather_elems"], 65),
                            ("gather_row_loop", small["gather_row_loop"], 65),
                            ("gather_onehot", small["gather_onehot"], 65)):
        entry = {"name": name, "route": "cuda", "source": probe_src,
                 "replaces": f"{probe_tpu}:{line}", "launches": probe_launches[name],
                 "max_abs_err": max(small[name]["max_abs_err"], row["max_abs_err"]),
                 **{k: row[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                        "library_ms")},
                 "host_us": row["host"], "shape": [row["n"], row["c"], row["m"], row["dtype"]]}
        if name == "gather_row_loop":  # also at the sparse conv's table size
            entry["scale"] = {k: scale[name][k] for k in (
                "n", "c", "m", "dtype", "ms", "device_ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by")}
        kernels.append(entry)
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
