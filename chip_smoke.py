#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, probe, evaluation, KITTI training, CenterPoint, PointPillars, strong-family, inline (plan=None), serving-export, zoo warm-start, data-parallel, convergence and env-gated variant paths and the measurement tools on one NVIDIA card and check them.

    python3 chip_smoke.py [--seed N] [--requests N]

Phases (any failure exits non-zero and prints no result):
  1. the card's name and power limit; the kernels' build time (the CUDA
     sparse convs -- the bf16 tensor-core kernels, the float32 3xTF32
     tensor-core kernels and the first design's CUDA-core ones, kept as a
     yardstick --, the gather probes and the masked statistics / fused
     MaskedBatchNorm, the greedy NMS keep-mask and the deformable conv with nvcc into
     build/torch_kernels/, one nvcc per
     source, started together); the count of bf16 HMMA instructions in the
     bf16 library's SASS and of TF32 HMMA instructions in the float32
     library's (cuobjdump), neither of which may be 0;
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
     device times (device_ms: only the named kernels' records under
     torch.profiler, exactly one set a call, else "not measured"), bounds
     and a one-call PyTorch yardstick; each sparse-conv kernel in bf16 and
     on the float32 route on the same convs cast to float32; each
     masked-statistics kernel with its inputs cycled over copies that exceed
     the L2 cache;
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
     same step on the CPU; no sparse-conv launch of the bf16 main path may
     take the float32 kernels, and every one of the float32 small-grid
     forward and train step must take them (the 3xTF32 kernels);
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
     idle share over one batch of each path under torch.profiler;
  7. KITTI training: a KITTI-layout dataset is written under the
     git-ignored work_dirs/ (24 train and 6 val frames of 120000 velodyne
     points, most of them around the sensor outside the front range, 8 Car
     / Pedestrian / Cyclist boxes of 900 points each, labels in the camera
     frame through the fixture's calibration) and
     tools/create_kitti_dbinfos seeds GT-paste from it; the training loader
     (native IO + global augmentation, GT-paste and object noise) is timed
     alone on this thread; then cli/train_kitti_3class_adversarial's main
     runs from the default config file at full width and B=6: (a) 2 epochs
     of 6 steps validating every epoch (a finite AP dict, best.pt written),
     (b) --resume to 3 epochs (starts at epoch 2), (c) --freeze-detector
     for 3 steps (every detector parameter bit-equal to its initial value
     on the card, the adversary's moved), then (d) PGD adversarial
     training at pgd_adversary.steps=2 and (e) plain training, in turns
     (e, d, d, e) of 5 steps each. Every step's kernel launches are checked
     (TRAIN_LAUNCHES; PGD_TRAIN_LAUNCHES for (d)); each run prints its step,
     plan and steady frames/s, and the median steady PGD-AT step is set
     against the median steady plain step of the same run shape, beside the
     card's name and power limit;
  8. CenterPoint on NuScenes at full width (CenterPointConfig: the residual
     encoder's 21 sparse convs, 5 point features, B=4 synthetic frames of
     30000 points, bf16, random weights): (a) K1 forward, dgrad and wgrad on
     the inputs of the 21 convs captured from one train step, bf16 and the
     float32 route, each against its plain version and timed beside
     index_select + matmul; (b) K2's statistics and VJP at
     the adversary's [B*60000*10, 5] float32, L2-cold (the VJP is off this
     path: CenterPoint's objective leaves out the terms it serves); (c)
     serving through
     export_serving, 3 clean and 3 attack B=4 requests with their launches
     checked, and a small-grid float32 forward with its decode + circle NMS
     held card vs CPU; (d) train_nuscenes_adversarial.run(synthetic=True) at
     B=4 for CP_EPOCHS epochs of CP_STEPS_PER_EPOCH steps (the adversary
     from epoch 3), every step timed and its launches checked
     (CP_TRAIN_LAUNCHES), the plan builds' native and target ms, the peak
     memory, and a small-grid float32 step's gradients card vs CPU;
     (e) (d)'s checkpoint scored through evaluate_nuscenes_adversarial
     (clean and adversarial on synthetic frames, clean on
     tests/fixtures/nuscenes_mini's multi-sweep frames) and
     evaluate_adversarial_checkpoint, each batch's plan, device and metric
     ms printed and the launches per batch checked; (f) the generic entry
     point cli/train.main on the CenterPoint config file (its dispatch to
     train_nuscenes_adversarial.run(cfg=...)), --synthetic, CP_GENERIC_STEPS
     steps at B=4 with the adversary on from epoch 0, every step's launches
     checked (CP_TRAIN_LAUNCHES) and timed;
  9. PointPillars at full width (PointPillarsConfig: 0.16 m pillars, grid
     432 x 496, 16000 pillars x 32 points, BEV 248 x 216, 321408 anchors,
     B=6 synthetic frames of 20000 points, bf16, adversary (64, 128, 64),
     random weights): (a) K2 on the inputs of one train step at the
     3072000 point slots, each against its plain version (the PFN's fused
     BN at [3072000, 64] bf16 and the adversary's at [3072000, 64 / 128]
     bf16, forward and backward; the statistics and their VJP at
     [3072000, 4] float32), L2-cold, with device times; (d) PP_TRAIN_STEPS
     train steps at epoch 3 fed by with_plans through PillarPlanBuilder,
     every step's launches checked (PP_TRAIN_LAUNCHES), the native-plan
     and assignment ms a build, frames/s and peak memory; (f) run_evaluation
     clean, learned and PGD-10 on two B=6 batches from (d)'s state, launches
     per batch checked; (b) 3 clean and 3 attack B=6 requests through
     export_serving on the native pillar plan; (c) a small-grid float32
     forward and its decode + rotated NMS card vs CPU; (e) the generic
     entry point cli/train.main on the pillar config file with --validate
     --steps-per-epoch 2 on phase 7's KITTI layout (a checkpoint and a
     validation result). No path of (b), (d) and (f) may reach a plain
     version of K2 (PlainVersionCalls) or a float32 sparse-conv kernel;
 10. the strong family at full width (StrongVoxelNetConfig on the SECOND
     base: grid [41, 1600, 1408], 16000 voxels x 5 points, adversary (64,
     128, 256, 128) with dropout 0.1 on the post-VFE features, bf16, random
     weights, synthetic 20000-point frames with GT boxes), at the recipe's
     B=1 and at B=6: (a) K2 on the inputs of one train step: the two
     256-wide fused BNs (enc_bn_2, dec_bn_1) forward and backward and the
     statistics at [B*16000, 256] bf16, each against its plain version,
     bit-identical on a repeat, L2-cold, with device times and byte bounds,
     and the adversary's 64 / 128-wide BNs checked alone; (b)
     ST_TRAIN_STEPS StrongTrainer steps fed by with_plans, every step's
     launches checked (ST_TRAIN_LAUNCHES by wrapper, ST_C256_LAUNCHES by
     K2 kernel at C = 256), the momentum carry, the dynamic
     scale and moved weights checked, step / plan ms, frames/s and peak
     memory printed; (c) run_evaluation from (b)'s B=6 state, clean and
     under the learned attack, launches per batch checked; (d)
     cli/train_kitti_adversarial_strong.main on phase 7's KITTI layout with
     --validate --epochs 2 --steps-per-epoch 2 at B=1 (a checkpoint,
     val_history.json and the dashboard's verdict); (e) a small-grid float32
     strong train step at the adversary's full widths, card vs CPU, its
     sparse convs on the 3xTF32 kernels. (b) and (c) may reach no plain
     version of K2 and no float32 sparse-conv kernel;
 11. the inline (plan=None) path, the plan built on the card in torch ops
     (run_inline): (a) each family's plan from the points on the card,
     every array bit-equal to the native host plan of the same frames
     (SECOND B=6 and PointPillars B=6 on 20000-point frames with the
     anchor assignment on the card, CenterPoint B=4 on 30000-point frames
     with its targets, and a B=6 batch of phase 7's 120000-point
     KITTI-layout frames), timed in turns beside the host builds (median
     of IN_TIMED, host clock and CUDA events) with the device operations
     one build launches (torch.profiler); an assignment that differs is
     reported anchor by anchor and accepted only as a rounding tie; (b)
     SECOND served self-contained, serve(points, mask), 3 clean + 3 attack
     B=6 requests, each bit-equal to the plan-fed request on the same
     frames with the same kernel launches; (c) the inline
     Trainer.train_step at B=6 and epoch 3: one step's losses equal to the
     plan-fed step's from the same state and frames, then IN_TRAIN_STEPS
     timed steps (launches, finite losses, positives, moved weights, ms,
     frames/s, peak memory); (d) CenterPoint B=4, PointPillars B=6 and the
     strong forward_eval B=6 inline, clean and attack, each bit-equal to
     its plan-fed output with the same launches. No inline path may call
     a host builder (HostPlanCalls), a plain version of K1 or K2, or a
     float32 sparse-conv kernel; the sparse plan is a replay of its CUDA
     graph (models/voxelnet.PLAN_GRAPH_CALLS, printed beside (a)'s
     lines): a timed request or step of (b) - (d) whose plan ran eager,
     or did not replay, fails;
 12. the serving export (run_export, cli/export.py): K1's forward and K2's
     apply are the operators rpc::sparse_conv_fwd / rpc::masked_bn_apply,
     so torch.export records them and the loaded program launches the
     kernels. (a) SECOND (VoxelNetConfig, bf16) at B=6 on 20000-point
     frames: a trainer's seeded weights saved by CheckpointManager and
     exported by the CLI's main from that work dir, one request bit-equal
     to the eager serve; then through export_program with the head's
     score_thr at 0, as every artifact below, so that random weights leave
     detections to compare (a request with none fails); (b) its plan-fed
     artifact on the native host plan; (c) PointPillars B=6 and CenterPoint
     B=4 on 30000-point frames, seeded random weights. Each export launches
     no kernel; each artifact is saved into a temporary directory, loaded
     back and answers EX_REQUESTS seeded requests (EX_FED_REQUESTS
     plan-fed), each bit-equal to the eager serve on the same frames with
     the same K1 and apply launches (EX_LAUNCHES), timed in turns with it;
     one request each way under torch.profiler gives the device operations
     and the host events where the two differ; a fresh interpreter that
     imports torch and cli/export only loads the SECOND artifact and
     answers a request bit-equal to this process; the host microseconds a
     call of each operator takes against its direct launch (one encoder
     conv, one encoder BN, gradients off, in turns); export / save / load
     seconds, the artifact's MB and the peak memory;
 13. zoo warm starts (run_zoo, tools/convert_torch_checkpoint and
     train/checkpoint.load_pretrained), for SECOND (the 3-class KITTI
     config), PointPillars (its config) and CenterPoint with the DCN head
     (its config, model.use_dcn_head=True) at full width: (a) an
     mmdet3d-keyed state dict of the model's shapes from the seed
     (tests/zoo_checkpoint.py; SECOND's conv_input in spconv1's layout)
     saved as a .pth, its MB printed; (b) load_pretrained on a trainer on
     the card, timed: every loaded tensor bit-equal to the host
     conversion, float32 to float32, every other tensor (the backbone
     convs past each stage's first, the adversary, num_batches_tracked)
     unchanged, and the loaded / skipped counts equal to the same
     conversion on the CPU (SECOND: 86 and 0); (c) one request (B=6 of
     20000-point frames, CenterPoint B=4 of 30000) served self-contained on
     the warm-started model with its K1 / apply launches checked
     (EX_LAUNCHES), then its eval forward with K1's forward and K2's apply
     routed to their plain versions on the card (PlainRoute), the head
     outputs within ZOO_RTOL in norm of the kernels' forward; (d) the
     CLIs on the .pth: train_kitti_3class_adversarial --load-from through
     epoch 3 (the adversary on), cli/train.main on the pillar config,
     train_nuscenes_adversarial --pretrained (the plain head: the 12 DCN
     adaptations skipped), evaluate_kitti_3class --load-from with an empty
     work dir and export --load-from, whose artifact answers a request
     bit-equal to the eager serve of the same warm start; each prints its
     [load-from] line, finite losses or scores, and launches K1 and K2;
     (e) tools/convert_torch_checkpoint's main writes a port checkpoint
     from the SECOND .pth, and a warm start from it equals one from the
     .pth;
 14. data-parallel training (run_data_parallel; train/loop.Trainer.
     compile_sharded through cli/common.run_training(group=...)): two
     ranks spawned on this card over gloo (NCCL refuses two ranks on one
     device), SECOND at global B=6 (3 rows and one host plan a rank, the
     adversary on from epoch 0) for 6 steps and CenterPoint at B=4 for 3;
     after every step rank 1's state (model, Adam moments, counters) is
     held bit for bit to rank 0's and each rank's launches to the one-rank
     step's (TRAIN_LAUNCHES, CP_TRAIN_LAUNCHES); the first step against a
     one-process emulation on this card, run twice; the all-reduce's ms
     (host clock and CUDA events) and bytes, each rank's step and plan ms
     and peak memory, global frames/s per epoch beside one process at
     B=6; then cli/train.py --multihost as a group of one over NCCL (a
     checkpoint) and --devices 2 refused with JAX's message. The kernels
     line's sparse_conv and masked_batch_norm rows carry the launches a
     rank made;
 15. the convergence run, the plain-block CenterPoint encoder and --amp
     (run_convergence): (a) one full-width B=6 inline train step
     (Trainer.train_step with no plan) with K1's forward, dgrad and wgrad
     on its 12 convs and K2's fused BN forward and backward on its 17 BNs
     against their plain versions; then tools/convergence_run's main at
     full width and reduced depth (CONV_ENV: 100 inline steps in chunks of
     50 on the epoch ramp, then a 50-step freeze phase; AP before, clean
     and attack after on 4 held-out scenes), every train step's launches
     read (K1 12 / 12 / 12 and 17 fused BNs forward and backward) and no
     host plan build in any, steps/s, each chunk's peak and end-of-chunk
     GiB, and one chunk of CONV_PROFILE_STEPS steps under torch.profiler:
     at most the one read at its end may copy to the host or wait for the
     card; (b) the plain-block CenterPoint (residual_encoder=False, 13
     sparse convs, 13 + 5 MaskedBatchNorms) at full width, B=4 of 30000
     points: one train step at epoch 3 with its launches checked
     (CP_PLAIN_LAUNCHES), K1 and K2 held against their plain versions on
     its 13 convs and 18 BNs, then one self-contained serve request with
     its launches (13 K1 forwards and 13 BNs); (c) cli/train.py --amp on
     SECOND's config file for AMP_STEPS B=6 steps: torch's float32 matmul
     precision "medium" and cuDNN's TF32 switch on while it trains, both
     restored after, every step's launches TRAIN_LAUNCHES. The kernels
     line's sparse_conv and masked_batch_norm rows carry the launches of a
     convergence step and of the plain-block step and request;
 16. the JAX package's env-gated variants (run_variants): (a) the compact
     adversary (RPC_COMPACT_PERT, models/voxelnet.COMPACT_PERT) for SECOND
     and PointPillars at B=6 of 20000 points and CenterPoint at B=4 of
     30000: a float32 train step and an attack=True forward compact
     against padded from one state (losses, gradients, head outputs, each
     gap beside its tolerance); at bf16, the adversary stage alone (its K2
     launches, the rows its BNs ran at, its ms and device ms) and train
     steps in turns (padded, compact, compact, padded), then the plan-fed
     compact step bit-equal to the inline one (the plan built on the
     card), and one compact train step's K2 launches at the compact rows
     (the kernels line's compact rows count them); K2 at the pillar
     adversary's compact rows against the plain versions; (b) the JAX
     package's gather-form densify (RPC_DENSE_GATHER, and its plan-fed
     pillar default), which the port holds by tests and does not run,
     replayed on SECOND's conv_out rows and the pillar BEV beside the
     port's scatter: bit-equal forward and gradient, device ms of both;
     (c) K2's bfloat16-read mode (RPC_BN_BF16_STATS) forward and backward
     at every bf16 BN shape of a SECOND step and the PFN's [3072000, 64]
     against its plain version at bounds a kernel that ignores the mode
     misses (hold_lowp), timed beside the float32-read mode on the same
     inputs, and a full-width SECOND step in the mode (VR_LOWP_LAUNCHES)
     beside the float32-read step; (d) the JAX package's FPN depth-to-space
     (RPC_FPN_D2S), held by tests too, replayed on the bf16 SECOND neck's
     stride-2 deblock beside the port's ConvTranspose2d, device ms of
     both; (e) tools/diag_centerpoint_nan's main at DIAG_STEPS=3, the
     adversary on and off; then a child process with the four variables
     set in its environment trains full-width SECOND for VR_CHILD_STEPS
     steps on its host plans and answers an attack request (the two gates
     the port reads, each read, its path taken, the launches of the mode);
 17. the port's measurement tools at full width (`run_tools`), in this
     process: tools/bench_step for SECOND with the resident, prefetch (and
     the index plan from the native builder beside the torch builder on
     CPU tensors, whose plan must equal the native one) and inline plans,
     for CenterPoint and for PointPillars; tools/bench_inference at B=1 and B=6, resident and
     inline, clean and attack; tools/profile_components for SECOND; a
     tools/microbench subset at widths 16 and 64; tools/parse_trace's
     breakdown and idle over a torch.profiler trace of 3 SECOND steps whose
     K1 / K2 launches carry CUDA events (the breakdown's K1 + K2 ms within
     10% of the events' sum). Every record's times finite and positive,
     device busy <= the host-clock time, 0 <= idle share <= 1, 0 < mfu < 1,
     the K1 / K2 counters grown in every timed step (the tools raise
     otherwise); the failed checks are raised together;
 18. the greedy NMS keep-mask (run_greedy_nms; rpc::greedy_keep,
     csrc/greedy_nms.cu): one full-width CenterPoint B=4 serve (the six
     tasks' circle NMS at [24, 500, 500]) and one SECOND B=6 serve (rotated
     NMS at [18, 100, 100]), each sweep launching the kernel exactly once;
     on the relations they swept and on random ones (N = 1, 65, 100, 500
     and 2048, whose words go to the global scratch) the kernel's mask
     bit-identical to the plain loop's on the card, each case synchronised,
     with CUDA-event ms, device ms and launches of both; each serve's host
     ms with the sweep on the kernel and on the plain loop, in turns.
 19. the deformable conv (run_deform_conv; rpc::deform_conv2d,
     csrc/deform_conv.cu): the kernel against its plain twin at the DCN
     head's [4, 64, 128, 128], groups 4, with zero (also against cuDNN's
     grouped conv), integer and fractional offsets, and at a ragged map,
     two deform groups with a group wider than a chunk, and 5x5 taps: within
     1e-5 of the twin's scale, one launch a call, bit-identical on a repeat;
     CUDA-event ms, device ms and launches of kernel and twin, the twin's
     einsum alone and the operation bound; a full-width CenterPoint head on
     the kernel route against the twin route; 3 CenterPoint B=4 requests,
     eager and through the loaded `.pt2`, 12 kernel launches each and
     bit-equal outputs; `correct` of the benchmark's CenterPoint cell.
The last two lines are the kernels JSON and {"ok": true, "device": ...}.
Needs one card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# the bound of each kernel is the larger of bytes / memory rate and
# operations / peak: HBM_BYTES_PER_S, PEAK_OPS and L2_BYTES are the port's
# published H100 figures (tools/bench_common), bound in main()

# bf16 outputs round once to 8 significant bits (2^-8 relative) after a
# float32 sum in another order: hold errors to 1e-2 of the output's scale
SPARSE_CONV_RTOL = 1e-2
# the float32 route's forward and dgrad vs the plain float32 matmul (TF32
# off): summation order, and the 3xTF32 split's ~2^-21 of each product
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
# K2's bfloat16-read mode (RPC_BN_BF16_STATS), held so that a kernel which
# ignores the mode in either launch fails (hold_lowp):
#  * the mean within LOWP_MEAN_RTOL of its largest entry and each channel's
#    variance within LOWP_VAR_RTOL of its own (float32 sums of the same
#    terms in another order); the float32-read variance of the same x must
#    miss the mode's by LOWP_VAR_SEP times that (measured on the CPU: about
#    1e-3 of each channel's at these inputs);
#  * the apply on the kernel's statistics bit-equal to the plain version's
#    on all but LOWP_Y_MISMATCH of y's entries, where the float32-read apply
#    differs on at least LOWP_Y_DIFFERS of them (measured on the CPU: 12%
#    with the ReLU, 40% without);
#  * the forward's y within LOWP_Y_STEPS of |x a| + |b| of the plain
#    forward's, entry by entry: a folded scale a or shift b that rounds one
#    bfloat16 step apart, where the statistics' sums round apart, moves an
#    entry by about a step of each term and of the output
LOWP_MEAN_RTOL = 1e-5
LOWP_VAR_RTOL = 2e-5
LOWP_VAR_SEP = 10.0
LOWP_Y_MISMATCH = 1e-3
LOWP_Y_DIFFERS = 2e-2
LOWP_Y_STEPS = 2.0 ** -6
# float32 train-step gradients, card vs CPU: summation order through the
# whole step (the CPU parity tests measure 1e-4 of each tensor's largest
# entry against JAX); tensors whose true gradient is 0 are held to 1e-6 of
# the largest gradient of the model
TRAIN_GRAD_RTOL = 1e-3
TRAIN_GRAD_FLOOR = 1e-6
# a ReLU's input card vs CPU, relative to its largest entry: the band within
# which the two sides may round it to opposite signs of 0 (the ReLU-fused
# BatchNorms of the SECOND small-grid step: at most 2.7e-6 on the H100,
# tests/test_torch_kernels_cuda.py)
BN_OUT_RTOL = 1e-5

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

# phase 7: a KITTI-layout dataset of realistic size (an HDL-64E frame before
# range filtering; the loader subsamples to 20000 points), 8 GT boxes a frame
# of 900 points each (a car a few tens of metres off; real counts range from
# tens far off to a few thousand close by)
KITTI_TRAIN_FRAMES, KITTI_VAL_FRAMES = 24, 6
KITTI_POINTS, KITTI_BOXES, KITTI_OBJECT_POINTS = 120000, 8, 900
LOADER_BATCHES = 6  # batches of the training loader timed alone
KITTI_ROOT = os.path.join(REPO, "work_dirs", "chip_smoke_kitti")
PGD_TRAIN_STEPS = 2  # runs (d): pgd_adversary.steps
# runs (d)/(e): PGD-AT and plain steps in turns (plain, PGD-AT, PGD-AT,
# plain), KITTI_TURN_STEPS each; a run's first step (the attack's build,
# first-call costs) is left out of its steady steps
KITTI_TURN_STEPS = 5
# kernel launches of a PGD-AT train step, derived from the code: each of the
# K attack steps runs the eval-mode forward (12 convs, 12 BNs; no adversary)
# and its input gradient (12 dgrads, 12 BN dx; the weights are frozen, so no
# wgrad and no bwd_reduce), then the train step as TRAIN_LAUNCHES
PGD_TRAIN_LAUNCHES = dict(TRAIN_LAUNCHES, **{
    k: TRAIN_LAUNCHES[k] + 12 * PGD_TRAIN_STEPS
    for k in ("sparse_conv", "sparse_conv_dgrad", "masked_batch_norm", "masked_batch_norm_bwd")})


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


def _fmt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


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
    return {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
            "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0, "err": 0.0}


def _add(acc, row, nbytes, ops, peak):
    for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
        acc[key] += row[key]
    # a conv whose device time was not measured leaves the sum not measured
    acc["device_ms"] = (None if acc["device_ms"] is None or row["device_ms"] is None
                        else acc["device_ms"] + row["device_ms"])
    if "bound_f32_cuda_cores_ms" in row:
        acc["bound_f32_cuda_cores_ms"] = (acc.get("bound_f32_cuda_cores_ms", 0.0)
                                          + row["bound_f32_cuda_cores_ms"])
    acc["bytes_ms"] += nbytes / HBM_BYTES_PER_S * 1e3
    acc["ops_ms"] += ops / PEAK_OPS[peak] * 1e3
    acc["err"] = max(acc["err"], row["max_abs_err"])


def _finish(tot):
    for v in tot.values():
        v["bound_by"] = "bytes" if v["bytes_ms"] >= v["ops_ms"] else "operations"
    return tot


# the kernels one call of each K1 route launches, by name, for device_ms
K1_KERNELS = {
    (False, "gemm"): {"sparse_conv_tc_fwd_kernel": 1},
    (False, "wgrad"): {"sparse_conv_tc_wgrad_kernel": 1, "sparse_conv_tc_wgrad_reduce_kernel": 1},
    (True, "gemm"): {"sparse_conv_tf32_fwd_kernel": 1},
    (True, "wgrad"): {"sparse_conv_tf32_wgrad_kernel": 1,
                      "sparse_conv_tf32_wgrad_reduce_kernel": 1},
}


def _time_conv(tot, f32, kind, fn, plain, lib, nbytes, hits, cin, cout, row):
    """Time one K1 call of a captured conv and add it to `tot`: the kernel
    (ms), its device time, the plain version and the library call.
    The bound counts 2*hits*Cin*Cout products: on the bf16 tensor cores, or
    three tf32 ones each (the float32 route's 3xTF32 split), beside which a
    float32 row keeps the bound of the same products on the CUDA cores."""
    from robustpointclouds_tpu_torch.tools.probe_gather import device_ms

    row["ms"] = cuda_ms(fn, 10)
    row["device_ms"] = device_ms(fn, 10, kernels=K1_KERNELS[(f32, kind)])
    row["plain_ms"] = cuda_ms(plain, iters=5)
    row["library_ms"] = cuda_ms(lib, iters=5)
    ops = 2.0 * hits * cin * cout
    if f32:
        ops, peak = 3 * ops, "tf32_tensor"
        row["bound_f32_cuda_cores_ms"] = bound_ms(nbytes, ops / 3, "f32")[0]
    else:
        peak = "bf16_tensor"
    row["bound_ms"], row["bound_by"] = bound_ms(nbytes, ops, peak)
    # no time can read below the bound: a CUDA-event time that does is a
    # fault of the run, a profiler record that does is not a measurement
    if row["ms"] < row["bound_ms"]:
        raise RuntimeError(f"K1 {kind} {row}: {row['ms']} ms is below its bound")
    if row["device_ms"] is not None and row["device_ms"] < row["bound_ms"]:
        print(f"K1 {kind} {row['conv']}: device time {row['device_ms']} ms below the bound "
              f"{row['bound_ms']}: not measured", flush=True)
        row["device_ms"] = None
    _add(tot, row, nbytes, ops, peak)
    return row


def check_sparse_conv(captured, torch, f32: bool = False):
    """K1 forward on each captured (feats, kernel, idx) of the main path vs
    its plain version: the bf16 tensor-core kernel or, with f32, the float32
    route's 3xTF32 kernel on the same convs cast to float32; each timed."""
    from robustpointclouds_tpu_torch.kernels.sparse_conv import sparse_conv, sparse_conv_ref

    rows, tot = [], _new_total()
    rtol = F32_CONV_RTOL if f32 else SPARSE_CONV_RTOL
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
        hits = int((idx < n).sum().item())
        eb = feats.element_size()
        nbytes = idx.numel() * 4 + n * cin * eb + kernel.numel() * eb + m * cout * eb
        rows.append(_time_conv(
            tot, f32, "gemm", lambda: sparse_conv(feats, kernel, idx),
            lambda: sparse_conv_ref(feats, kernel, idx),
            lambda: torch.matmul(torch.index_select(feats_pad, 0, flat).view(m, k * cin), kernel),
            nbytes, hits, cin, cout,
            dict(conv=name, n=n, m=m, k=k, cin=cin, cout=cout, hits=hits, max_abs_err=err)))
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


def check_masked_stats(torch, shapes, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for n, c, dtype in shapes:
        x = (torch.randn(n, c, device="cuda", generator=g) * 3 + 1).to(dtype)
        mask = torch.rand(n, device="cuda", generator=g) > 0.75  # ~ the padded-slot fill
        rows.append(stats_case(torch, x, mask))
    return rows


def stats_case(torch, x, mask):
    """K2's statistics on (x, mask) against the plain version: the checks,
    the times (L2-cold inputs), the bound and var_mean of x[mask]."""
    from robustpointclouds_tpu_torch.kernels.masked_stats import (
        _stats, masked_stats, masked_stats_ref)
    from robustpointclouds_tpu_torch.tools.probe_gather import device_ms

    n, c = x.shape
    dtype = x.dtype
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
    # serving makes it (no gradient: the launch itself); raw_ms: that
    # launch (_stats) alone; autograd_ms: the public call on an input that
    # needs a gradient (the autograd Function); device_ms: the kernels'
    # device time
    sets = l2_cold(torch, (x, mask))
    t = cuda_ms(in_turn(masked_stats, sets))
    t_raw = cuda_ms(in_turn(_stats, sets))
    xg = x.detach().requires_grad_(True)
    t_fn = cuda_ms(lambda: masked_stats(xg, mask))
    split = {}
    t_dev = device_ms(in_turn(_stats, sets), 20, kernels={"stats_kernel": 1}, by_kernel=split)
    t_plain = cuda_ms(in_turn(masked_stats_ref, sets), iters=5)
    t_lib = cuda_ms(in_turn(lambda a, m: torch.var_mean(a[m].float(), dim=0, unbiased=False),
                            sets), iters=5)
    # the bytes this data needs: the mask, x on the rows it keeps, the outputs
    nbytes = int(rcnt.item()) * c * x.element_size() + n + (2 * c + 1) * 4
    b_ms, by = bound_ms(nbytes, 5.0 * n * c, "f32")
    return dict(n=n, c=c, dtype=str(dtype).replace("torch.", ""), ms=t,
                raw_ms=t_raw, autograd_ms=t_fn, device_ms=t_dev, plain_ms=t_plain,
                library_ms=t_lib,
                bound_ms=b_ms, bound_by=by, max_abs_err=err, device_kernels=split)


def check_sparse_conv_bwd(captured, torch, f32: bool = False):
    """K1 dgrad and wgrad on the (feats, weight, idx, bwd_idx, mirror, g) of
    the convs of one train step, each against its plain version, as
    check_sparse_conv does for the forward."""
    from robustpointclouds_tpu_torch.kernels.sparse_conv import (
        backward_kernel, sparse_conv_dgrad, sparse_conv_ref, sparse_conv_wgrad,
        sparse_conv_wgrad_ref)

    rows = []
    tot = {key: _new_total() for key in ("dgrad", "wgrad")}
    rtol = F32_CONV_RTOL if f32 else SPARSE_CONV_RTOL
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
        hits = int((bwd_idx < m).sum().item())
        nbytes = bwd_idx.numel() * 4 + m * cout * eb + w_bwd.numel() * eb + n * cin * eb
        rows.append(_time_conv(
            tot["dgrad"], f32, "gemm", lambda: sparse_conv_dgrad(g, w_bwd, bwd_idx),
            lambda: sparse_conv_ref(g, w_bwd, bwd_idx),
            lambda: torch.matmul(torch.index_select(g_pad, 0, bflat).view(n, k * cout), w_bwd),
            nbytes, hits, cin, cout,
            dict(kernel="dgrad", conv=name, n=n, m=m, k=k, cin=cin, cout=cout, hits=hits,
                 max_abs_err=err)))
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
        hits = int((idx < n).sum().item())
        nbytes = idx.numel() * 4 + n * cin * eb + m * cout * eb + k * cin * cout * 4
        rows.append(_time_conv(
            tot["wgrad"], f32, "wgrad", lambda: sparse_conv_wgrad(feats, g, idx),
            lambda: sparse_conv_wgrad_ref(feats, g, idx),
            lambda: torch.matmul(torch.index_select(feats_pad, 0, flat).view(m, k * cin).t(), g),
            nbytes, hits, cin, cout,
            dict(kernel="wgrad", conv=name, n=n, m=m, k=k, cin=cin, cout=cout, hits=hits,
                 max_abs_err=err)))
    return rows, _finish(tot)


def check_masked_stats_bwd(torch, shapes, seed):
    """K2's VJP against its plain version; no single PyTorch call computes it."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for n, c, dtype in shapes:
        x = (torch.randn(n, c, device="cuda", generator=g) * 3 + 1).to(dtype)
        mask = torch.rand(n, device="cuda", generator=g) > 0.75
        gm = torch.randn(c, device="cuda", generator=g)
        gv = torch.randn(c, device="cuda", generator=g)
        rows.append(stats_bwd_case(torch, x, mask, gm, gv))
    return rows


def stats_bwd_case(torch, x, mask, gm, gv):
    """K2's VJP at (x, mask) for the cotangents (gm, gv) against its plain
    version: the checks, the times (L2-cold inputs) and the bound."""
    from robustpointclouds_tpu_torch.kernels.masked_stats import (
        masked_stats, masked_stats_bwd, masked_stats_bwd_ref)
    from robustpointclouds_tpu_torch.tools.probe_gather import device_ms

    n, c = x.shape
    dtype = x.dtype
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
    t = cuda_ms(new)
    t_dev = device_ms(new, 20, kernels={"vjp_kernel": 1})
    t_plain = cuda_ms(in_turn(lambda a, m: masked_stats_bwd_ref(a, m, mean, cnt, gm, gv),
                              sets), iters=5)
    # the mask and x on the rows it keeps read once (dx is 0 elsewhere
    # whatever x holds), dx written once
    nbytes = (int(cnt.item()) + n) * c * x.element_size() + n + (3 * c + 1) * 4
    b_ms, by = bound_ms(nbytes, 5.0 * n * c, "f32")
    return dict(n=n, c=c, dtype=dname, ms=t, device_ms=t_dev, plain_ms=t_plain,
                library_ms=None,
                bound_ms=b_ms, bound_by=by, max_abs_err=err)


# every MaskedBatchNorm of one full-width train step, (name, N, C, count):
# the perturber's five over the 480000 point slots (ReLU), the encoder's
# twelve (ReLU + row mask), all bf16 in and out
BN_TRAIN_SHAPES = [("perturber", 480000, 64, 3), ("perturber", 480000, 128, 2),
                   ("encoder", 96000, 16, 2), ("encoder", 96000, 32, 3),
                   ("encoder", 72000, 64, 3), ("encoder", 48000, 64, 3),
                   ("encoder", 48000, 128, 1)]


def check_masked_batch_norm(torch, seed):
    """The fused MaskedBatchNorm forward and backward at the main path's
    shapes, train mode (and the attack's eval mode at [480000, 128]), against
    the plain versions, bit-identical on a repeat call, timed. Forward
    ms: the call without gradient (serving); backward ms: the wrapper;
    autograd_ms: the backward through autograd. Bounds:
    the bytes this data needs (each input read once, each output written
    once) and the two-pass one (the forward reads x twice, the backward x and
    g twice)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dt = torch.bfloat16
    cases = [(name, n, c, count, True) for name, n, c, count in BN_TRAIN_SHAPES]
    cases.append(("perturber eval", 480000, 128, 0, False))
    rows = []
    for name, n, c, count, train in cases:
        x = (torch.randn(n, c, device="cuda", generator=gen) * 3 + 1).to(dt)
        mask = torch.rand(n, device="cuda", generator=gen) > 0.75
        w = 0.5 + torch.rand(c, device="cuda", generator=gen)
        b = torch.randn(c, device="cuda", generator=gen)
        rm = torch.randn(c, device="cuda", generator=gen)
        rv = 0.5 + torch.rand(c, device="cuda", generator=gen)
        gout = torch.randn(n, c, device="cuda", generator=gen).to(dt)
        rows += bn_case(torch, name, count, x, mask, w, b, rm, rv, gout, train, True,
                        name == "encoder", None)
    return rows


def bn_case(torch, name, count, x, mask, w, b, rm, rv, gout, train, relu, row_mask, prev_bn,
            momentum=0.1, lowp=False):
    """The fused MaskedBatchNorm forward and backward on these inputs (y in
    x's type) against the plain versions, bit-identical on a repeat call,
    timed (L2-cold inputs) beside `prev_bn` when given: the forward row and
    the backward row. `lowp`: the bfloat16-read mode (RPC_BN_BF16_STATS),
    whose statistics are two launches of the statistics kernel."""
    from robustpointclouds_tpu_torch.kernels.masked_stats import (
        _bn_forward, _bn_ref, masked_batch_norm, masked_batch_norm_bwd,
        masked_batch_norm_bwd_ref)
    from robustpointclouds_tpu_torch.tools.probe_gather import device_ms

    n, c = x.shape
    dt = x.dtype
    rows = []
    flags = (train, momentum, 1e-3, relu, row_mask, dt, lowp)
    y, mean, var, cnt = _bn_forward(x, mask, w, b, rm.clone(), rv.clone(), *flags)
    ref, rmean, rvar, _ = _bn_ref(x, mask, w, b, rm.clone(), rv.clone(), *flags)
    err = (y.float() - ref.float()).abs().max().item()
    if lowp:
        lowp_gaps = hold_lowp(torch, f"{name} [{n},{c}]", x, mask, w, b, train, relu, row_mask,
                              y, mean, var, ref, rmean, rvar)
    elif not err <= BN_RTOL * ref.float().abs().max().item():
        raise RuntimeError(f"masked_batch_norm {name} [{n},{c}]: max error {err}")
    grads = masked_batch_norm_bwd(gout, x, mask, w, b, mean, var, cnt, 1e-3, train, relu,
                                  row_mask, need_params=train, lowp=lowp)
    refs = masked_batch_norm_bwd_ref(gout, x, mask, w, b, mean, var, cnt, 1e-3, train, relu,
                                     row_mask, lowp)
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
                                  row_mask, need_params=train, lowp=lowp)
    if not (torch.equal(y, y2) and all(p is None or torch.equal(p, q)
                                       for p, q in zip(grads, again))):
        raise RuntimeError(f"masked_batch_norm {name} [{n},{c}]: a repeat is not bit-identical")

    sets = l2_cold(torch, (x, mask, gout, rm.clone(), rv.clone()))
    new_f = in_turn(lambda a, m, _g, r1, r2: masked_batch_norm(
        a, m, w, b, r1, r2, train, momentum, relu=relu, row_mask=row_mask, out_dtype=dt,
        lowp=lowp), sets)
    if prev_bn is None:
        t, t_prev, t_prev_dev = cuda_ms(new_f), None, None
    else:
        old_f = in_turn(lambda a, m, _g, r1, r2: prev_bn(a, m, w, b, r1, r2, train, relu,
                                                         row_mask, dt), sets)
        t, t_prev = abba_ms(new_f, old_f)
        t_prev_dev = device_ms(old_f, 20)
    split_f, split_b = {}, {}
    fwd_kernels = {"stats_kernel": 2 if lowp else 1, "apply_kernel": 1} if train else {
        "apply_kernel": 1}
    t_dev = device_ms(new_f, 20, kernels=fwd_kernels, by_kernel=split_f)
    t_plain = cuda_ms(in_turn(lambda a, m, _g, r1, r2: _bn_ref(a, m, w, b, r1, r2, *flags)[0],
                              sets), iters=5)
    # the backward, through autograd (new and prev) and the wrapper alone
    wg, bg = w.clone().requires_grad_(train), b.clone().requires_grad_(train)
    graphs_new, graphs_old, wrapped = [], [], []
    for a, m, gg, r1, r2 in sets:
        xg = a.detach().requires_grad_(True)
        leaves = (xg, wg, bg) if train else (xg,)
        yn = masked_batch_norm(xg, m, wg, bg, r1, r2, train, momentum, relu=relu,
                               row_mask=row_mask, out_dtype=dt, lowp=lowp)
        graphs_new.append((yn, leaves, gg))
        if prev_bn is not None:
            yo = prev_bn(xg, m, wg, bg, r1, r2, train, relu, row_mask, dt)
            graphs_old.append((yo, leaves, gg))
        _, mn, vr, cn = _bn_forward(a, m, w, b, r1.clone(), r2.clone(), *flags)
        wrapped.append((gg, a, m, mn, vr, cn))

    def backward(yy, leaves, gg):
        return torch.autograd.grad(yy, leaves, gg, retain_graph=True)
    bnew = in_turn(backward, graphs_new)
    if prev_bn is None:
        tb_fn, tb_prev = cuda_ms(bnew), None
    else:
        bold = in_turn(backward, graphs_old)
        tb_fn, tb_prev = abba_ms(bnew, bold)
    wrap = in_turn(lambda gg, a, m, mn, vr, cn: masked_batch_norm_bwd(
        gg, a, m, w, b, mn, vr, cn, 1e-3, train, relu, row_mask, need_params=train, lowp=lowp),
        wrapped)
    tb = cuda_ms(wrap)
    bwd_kernels = {"bwd_reduce_kernel": 1, "dx_kernel": 1} if train else {"dx_kernel": 1}
    tb_dev = device_ms(wrap, 20, kernels=bwd_kernels, by_kernel=split_b)
    tb_prev_dev = None if prev_bn is None else device_ms(bold, 20)
    tb_plain = cuda_ms(in_turn(lambda gg, a, m, mn, vr, cn: masked_batch_norm_bwd_ref(
        gg, a, m, w, b, mn, vr, cn, 1e-3, train, relu, row_mask, lowp), wrapped), iters=5)
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
                     device_kernels=split_f, **({"lowp": lowp_gaps} if lowp else {})))
    rows.append(dict(common, kernel="masked_batch_norm_bwd", ms=tb, autograd_ms=tb_fn,
                     prev_ms=tb_prev, device_ms=tb_dev, prev_device_ms=tb_prev_dev,
                     plain_ms=tb_plain, library_ms=None, bound_ms=bb, bound_by=bby,
                     bound_two_pass_ms=b_two / HBM_BYTES_PER_S * 1e3, max_abs_err=bwd_err,
                     device_kernels=split_b))
    return rows


def hold_lowp(torch, label, x, mask, w, b, train, relu, row_mask, y, mean, var, ref, rmean,
              rvar):
    """K2's bfloat16-read forward (y and the statistics it normalised with)
    against the plain version's (ref, rmean, rvar) at the LOWP_* bounds,
    which the float32-read results on the same x must miss; returns the
    gaps, raises past a bound."""
    from robustpointclouds_tpu_torch.kernels.masked_stats import bn_apply_ref, masked_stats_ref

    eps = 1e-3
    gaps = {}
    if train:
        f32_var = masked_stats_ref(x.float(), mask)[1]
        gaps.update(
            mean=(mean - rmean).abs().max().item() / max(rmean.abs().max().item(), 1e-6),
            var=((var - rvar).abs() / rvar.clamp(min=1e-30)).max().item(),
            f32_read_var=((f32_var - rvar).abs() / rvar.clamp(min=1e-30)).max().item())
    args = (x, mask, mean, var, w, b, eps, relu, row_mask, x.dtype)
    plain = bn_apply_ref(*args, True)
    gaps["y_mismatch"] = (y != plain).float().mean().item()
    gaps["f32_read_y_differs"] = (bn_apply_ref(*args, False) != plain).float().mean().item()
    r = torch.rsqrt(rvar + eps)
    a = (r * w).to(x.dtype).float()
    sh = (b - rmean * r * w).to(x.dtype).float()
    scale = (x.float() * a).abs() + sh.abs()
    gaps["y_steps"] = ((y.float() - ref.float()).abs() / scale.clamp(min=1e-30)).max().item()
    ok = (gaps["y_mismatch"] <= LOWP_Y_MISMATCH and gaps["f32_read_y_differs"] >= LOWP_Y_DIFFERS
          and gaps["y_steps"] <= LOWP_Y_STEPS)
    if train:
        ok = ok and (gaps["mean"] <= LOWP_MEAN_RTOL and gaps["var"] <= LOWP_VAR_RTOL
                     and gaps["f32_read_var"] >= LOWP_VAR_SEP * LOWP_VAR_RTOL)
    if not ok:
        raise RuntimeError(f"masked_batch_norm lowp {label}: {gaps}")
    return gaps


def mean_row(rows):
    """One row for BNs of one shape, each measured on its own inputs: the
    mean of their times and bounds (device ms None if any is), the largest
    error."""
    out = dict(rows[0])
    for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_kept_ms"):
        if k not in out:
            continue
        vals = [r[k] for r in rows]
        out[k] = None if None in vals else sum(vals) / len(vals)
    out["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    return out


def write_kitti_layout(root: str, seed: int, point_range, np):
    """A KITTI-layout dataset under `root`. Each velodyne .bin frame holds
    KITTI_POINTS float32 points: a synthetic scene's KITTI_BOXES Car /
    Pedestrian / Cyclist boxes with KITTI_OBJECT_POINTS points each plus its
    ground (data/synthetic), and ground and clutter all around the sensor,
    most of it outside the front range as in an HDL-64E sweep. label_2
    files carry the boxes in the camera frame (the forward transform of
    tests/fixtures/make_kitti_mini.py, R0 @ Tr_velo_to_cam, through the
    fixture's calib/000000.txt); calib files and ImageSets complete the
    layout. Returns the train and val frame ids."""
    from robustpointclouds_tpu_torch.data.kitti import CLASSES, read_calib
    from robustpointclouds_tpu_torch.data.synthetic import synthetic_kitti_batch

    calib_src = os.path.join(REPO, "tests", "fixtures", "kitti_mini", "training", "calib",
                             "000000.txt")
    calib = read_calib(calib_src)
    tr, r0 = calib["Tr_velo_to_cam"], calib["R0"]
    for sub in ("velodyne", "label_2", "calib"):
        os.makedirs(os.path.join(root, "training", sub), exist_ok=True)
    os.makedirs(os.path.join(root, "ImageSets"), exist_ok=True)
    rng = np.random.RandomState(seed)
    ids = [f"{i:06d}" for i in range(KITTI_TRAIN_FRAMES + KITTI_VAL_FRAMES)]
    # synthetic_kitti_batch puts 60% of its points on the objects
    scene_points = KITTI_OBJECT_POINTS * KITTI_BOXES * 10 // 6
    for fid in ids:
        b = synthetic_kitti_batch(rng, batch_size=1, num_points=scene_points,
                                  max_gt=KITTI_BOXES, num_objects=KITTI_BOXES,
                                  point_range=point_range)
        n_bg = KITTI_POINTS - scene_points
        r = 80.0 * np.sqrt(rng.rand(n_bg))
        phi = rng.uniform(-np.pi, np.pi, n_bg)
        bg = np.stack([r * np.cos(phi), r * np.sin(phi), rng.normal(-1.7, 0.3, n_bg),
                       rng.rand(n_bg)], axis=1).astype(np.float32)
        pts = np.concatenate([b.points[0], bg])
        pts.tofile(os.path.join(root, "training", "velodyne", f"{fid}.bin"))
        lines = []
        for box, label in zip(b.gt_boxes[0][b.gt_mask[0]], b.gt_labels[0][b.gt_mask[0]]):
            x, y, zc, l, w, h, yaw = (float(v) for v in box)
            loc = r0 @ (tr[:, :3] @ np.array([x, y, zc - h / 2.0]) + tr[:, 3])
            rot_y = -yaw - np.pi / 2.0
            lines.append(f"{CLASSES[int(label)]} 0.00 0 {rot_y:.4f} 100.00 100.00 200.00 160.00 "
                         f"{h:.4f} {w:.4f} {l:.4f} {loc[0]:.6f} {loc[1]:.6f} {loc[2]:.6f} "
                         f"{rot_y:.6f}")
        with open(os.path.join(root, "training", "label_2", f"{fid}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        shutil.copyfile(calib_src, os.path.join(root, "training", "calib", f"{fid}.txt"))
    train, val = ids[:KITTI_TRAIN_FRAMES], ids[KITTI_TRAIN_FRAMES:]
    for split, names in (("train", train), ("val", val)):
        with open(os.path.join(root, "ImageSets", f"{split}.txt"), "w") as f:
            f.write("\n".join(names) + "\n")
    return train, val


def run_kitti_training(cfg, dev, card: str, seed: int, read_counts, expect_bf16_kernels,
                       cli_extra=()):
    """Phase 7: a KITTI-layout dataset of realistic size, GT-paste seeded by
    create_kitti_dbinfos, the training loader timed alone, then runs (a)-(d)
    of the training CLI's main(argv) (`cli_extra` appended to each argv):
    (a) 2 epochs of 6 steps validating every epoch, (b) --resume to epoch 3,
    (c) --freeze-detector, (d) PGD-AT from --cfg-options and (e) plain
    training, (d) and (e) in turns. Each step's kernel launches are checked
    against TRAIN_LAUNCHES / PGD_TRAIN_LAUNCHES; each step is timed on the
    host clock up to a synchronise, around Trainer.train_step. Returns each
    run's summary."""
    import numpy as np
    import torch

    from robustpointclouds_tpu_torch.cli import train_kitti_3class_adversarial as train_cli
    from robustpointclouds_tpu_torch.data.kitti import kitti_epoch_loader
    from robustpointclouds_tpu_torch.tools.create_kitti_dbinfos import create_dbinfos
    from robustpointclouds_tpu_torch.train.checkpoint import CheckpointManager
    from robustpointclouds_tpu_torch.train.loop import TrainConfig, Trainer

    kitti_root = KITTI_ROOT
    shutil.rmtree(kitti_root, ignore_errors=True)
    t0 = time.perf_counter()
    train_ids, val_ids = write_kitti_layout(os.path.join(kitti_root, "data"), seed,
                                            cfg.voxelizer.point_cloud_range, np)
    data_root = os.path.join(kitti_root, "data")
    t1 = time.perf_counter()
    dbinfos = create_dbinfos(data_root)
    print(f"kitti layout: {len(train_ids)} train + {len(val_ids)} val frames of {KITTI_POINTS} "
          f"points, {KITTI_BOXES} boxes each, written in {t1 - t0:.1f} s; dbinfos "
          f"{json.dumps({k: len(v) for k, v in dbinfos.items()})} in "
          f"{time.perf_counter() - t1:.1f} s", flush=True)
    # the training loader alone (IO + augmentation + GT-paste), on this thread
    loader_ms = []
    loader_it = kitti_epoch_loader(data_root, 6, cfg, seed=seed,
                                   steps_per_epoch=LOADER_BATCHES)(0)
    for _ in range(LOADER_BATCHES):
        t0 = time.perf_counter()
        lb = next(loader_it)
        loader_ms.append((time.perf_counter() - t0) * 1e3)
        if lb.points.shape != (6, 20000, 4) or not lb.gt_mask.any(axis=1).all():
            raise RuntimeError(f"kitti loader batch {lb.points.shape}, "
                               f"{lb.gt_mask.sum(axis=1).tolist()} boxes a frame")
    del loader_it
    print(f"kitti loader host ms a B=6 batch ({card}): {json.dumps(loader_ms)}, mean "
          f"{sum(loader_ms) / len(loader_ms):.3f}; GT boxes a frame after paste "
          f"{lb.gt_mask.sum(axis=1).tolist()}", flush=True)

    config = os.path.join(REPO, train_cli.DEFAULT_CONFIG)
    steps = []
    plain_step = Trainer.train_step

    def counted_step(self, batch, epoch, plan):
        before = read_counts()
        t0 = time.perf_counter()
        logs = plain_step(self, batch, epoch, plan)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        steps.append({"epoch": epoch, "t0": t0, "t1": t1,
                      "launches": {k: v - before[k] for k, v in read_counts().items()}})
        return logs

    kitti_summary = {}

    def kitti_run(name, work, extra, per_step):
        """One run of the training CLI in `work`; its per-step launches, timings and summary."""
        steps.clear()
        t0 = time.perf_counter()
        Trainer.train_step = counted_step
        try:
            out = train_cli.main(["--config", config, "--data-root", data_root, "--work-dir",
                                  os.path.join(kitti_root, work), "--seed", str(seed),
                                  *extra, *cli_extra])
        finally:
            Trainer.train_step = plain_step
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        expect_bf16_kernels(f"kitti {name}")
        if not steps or any(st["launches"] != per_step for st in steps):
            raise RuntimeError(f"kitti {name}: per-step launches "
                               f"{[st['launches'] for st in steps]}, expected {per_step} each")
        # the host-clock ms of each step up to a synchronise, and waiting for
        # its (batch, plan) since the previous step (the first: since the start)
        timed = [{"epoch": st["epoch"], "wait_ms": (st["t0"] - (steps[i - 1]["t1"] if i else t0))
                  * 1e3, "step_ms": (st["t1"] - st["t0"]) * 1e3} for i, st in enumerate(steps)]
        # each epoch's first PREFETCHED_STEPS steps find their plans built ahead
        firsts = {}
        for i, st in enumerate(timed):
            firsts.setdefault(st["epoch"], i)
        steady = [st for i, st in enumerate(timed) if i - firsts[st["epoch"]] >= PREFETCHED_STEPS]
        plans = out["plans"]
        row = {"steps": len(timed),
               # the run's first step builds the attack and pays first-call costs
               "steady_step_ms": [st["step_ms"] for st in timed[1:]],
               "median_step_ms": statistics.median(st["step_ms"] for st in timed[1:]),
               "first_step_ms": timed[0]["step_ms"],
               "plan_ms": sum(p["plan_ms"] for p in plans) / len(plans),
               "native_ms": sum(p["native_ms"] for p in plans) / len(plans),
               "assign_ms": sum(p["assign_ms"] for p in plans) / len(plans),
               "steady_frames_per_s": (6 * len(steady) / sum(
                   (st["wait_ms"] + st["step_ms"]) / 1e3 for st in steady)) if steady else None,
               "epoch_frames_per_s": [e["frames_per_s"] for e in out["epochs"]],
               "wall_s": wall_s}
        kitti_summary[name] = row
        for i, st in enumerate(timed):
            print(f"kitti {name} step {i} " + json.dumps(st), flush=True)
        print(f"kitti {name} ({card}): " + json.dumps(row) + "; per step: "
              + json.dumps(per_step), flush=True)
        return out

    run_a = ["--epochs", "2", "--steps-per-epoch", "6"]
    out = kitti_run("a_validate", "a", run_a + ["--validate", "--cfg-options", "val_interval=1"],
                    TRAIN_LAUNCHES)
    wd_a = os.path.join(kitti_root, "a")
    for epoch in (0, 1):
        ap = out["history"][f"val_epoch{epoch}"]
        if ap["num_frames"] != len(val_ids) or not all(np.isfinite(v) for v in ap.values()):
            raise RuntimeError(f"kitti validation at epoch {epoch}: {ap}")
    if not os.path.isfile(os.path.join(wd_a, "best.pt")):
        raise RuntimeError("kitti --validate wrote no best checkpoint")
    print(f"kitti validation: mAP_3d_moderate "
          f"{[out['history'][f'val_epoch{e}']['mAP_3d_moderate'] for e in (0, 1)]} over "
          f"{len(val_ids)} frames; best.pt written", flush=True)
    out = kitti_run("b_resume", "a", ["--epochs", "3", "--steps-per-epoch", "6", "--resume"],
                    TRAIN_LAUNCHES)
    if out["start_epoch"] != 2 or out["state"].step != 18:
        raise RuntimeError(f"kitti --resume started at epoch {out['start_epoch']}, step "
                           f"{out['state'].step}")
    print("kitti --resume: restored epoch 1, trained epoch 2 (steps 12-17)", flush=True)
    kitti_run("c_freeze", "c", ["--freeze-detector", "--steps", "3"], TRAIN_LAUNCHES)
    init = Trainer(cfg, TrainConfig(), device=dev)
    init.init_state(seed)
    frozen_tr = Trainer(cfg, TrainConfig(), device=dev)
    frozen_tr.init_state(seed + 1)
    CheckpointManager(os.path.join(kitti_root, "c")).restore(frozen_tr)
    before, after = dict(init.model.named_parameters()), dict(frozen_tr.model.named_parameters())
    moved = [k for k in after if not torch.equal(after[k].detach().view(torch.int32),
                                                 before[k].detach().view(torch.int32))]
    if any(not k.startswith("adversary.") for k in moved) or not moved:
        raise RuntimeError(f"kitti --freeze-detector: parameters that moved {moved}")
    print(f"kitti --freeze-detector: {len(after) - len(moved)} detector parameters bit-equal on "
          f"the card, {len(moved)} adversary parameters moved", flush=True)
    del init, frozen_tr, before, after
    # PGD-AT against plain training in the same run shape, in turns
    turn = ["--steps", str(KITTI_TURN_STEPS)]
    pgd = ["--cfg-options", f"pgd_adversary.steps={PGD_TRAIN_STEPS}"]
    for name, extra, per_step in (("e_plain_1", [], TRAIN_LAUNCHES),
                                  ("d_pgd_1", pgd, PGD_TRAIN_LAUNCHES),
                                  ("d_pgd_2", pgd, PGD_TRAIN_LAUNCHES),
                                  ("e_plain_2", [], TRAIN_LAUNCHES)):
        kitti_run(name, name[0], turn + extra, per_step)
    ks = kitti_summary
    pgd_ms = statistics.median(ks["d_pgd_1"]["steady_step_ms"] + ks["d_pgd_2"]["steady_step_ms"])
    plain_ms = statistics.median(ks["e_plain_1"]["steady_step_ms"]
                                 + ks["e_plain_2"]["steady_step_ms"])
    print(f"kitti PGD-AT (K={PGD_TRAIN_STEPS}) median steady step {pgd_ms:.3f} ms (runs "
          f"{ks['d_pgd_1']['median_step_ms']:.3f} / {ks['d_pgd_2']['median_step_ms']:.3f}) against "
          f"the plain step {plain_ms:.3f} ms (runs {ks['e_plain_1']['median_step_ms']:.3f} / "
          f"{ks['e_plain_2']['median_step_ms']:.3f}), {pgd_ms / plain_ms:.3f}x; "
          f"{2 * (KITTI_TURN_STEPS - 1)} steady steps each, in turns ({card})", flush=True)

    return kitti_summary


# phase 8: CenterPoint at full width (models/centerpoint.CenterPointConfig)
CP_BATCH, CP_POINTS = 4, 30000  # the reference's per-GPU batch; the JAX CLIs' frames
CP_CONVS = 21  # conv_input + 8 basic blocks x 2 + 3 downs + conv_out
# kernel launches of a CenterPoint train step, derived from the code: each of
# the 21 sparse convs runs the forward, the dgrad (every conv's input needs a
# gradient: the adversary's delta is in the graph, gated, from epoch 0) and
# the wgrad; the masked statistics (C = 5) run under the adversary's std
# normalisation and its regulariser, forward only (the regulariser's per-dim
# statistics feed the bias and imbalance terms, which CenterPoint's
# objective leaves out, so no VJP); the 26 train-mode MaskedBatchNorms (the
# encoder's 21, the adversary's 5) run the fused forward and backward with
# bwd_reduce
CP_TRAIN_LAUNCHES = {"sparse_conv": CP_CONVS, "sparse_conv_dgrad": CP_CONVS,
                     "sparse_conv_wgrad": CP_CONVS, "masked_stats": 2, "masked_stats_bwd": 0,
                     "masked_batch_norm": 26, "masked_batch_norm_bwd": 26, "bwd_reduce": 26}
CP_BN_CLEAN, CP_BN_ATTACK = 21, 26
CP_EPOCHS, CP_STEPS_PER_EPOCH = 4, 2  # epoch 3 trains the adversary
CP_GENERIC_STEPS = 2  # (f): cli/train.main on the config file, the adversary from epoch 0
CP_CONFIG = os.path.join(REPO, "configs", "adversarial", "adversarial-centerpoint_nuscenes.py")
CP_EVAL_FRAMES = 8


def _conv_subtotal(rows, keep):
    """Sums of the timed conv rows `keep` selects (ms, device_ms, plain,
    library, bound), the largest error."""
    sel = [r for r in rows if keep(r)]
    tot = {k: sum(r[k] for r in sel) for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    tot["device_ms"] = (None if any(r["device_ms"] is None for r in sel)
                        else sum(r["device_ms"] for r in sel))
    tot["max_abs_err"] = max(r["max_abs_err"] for r in sel)
    tot["convs"] = len(sel)
    return tot


def _centerpoint_small_grads(dev, seed, read_counts, read_f32_counts, zero_counts):
    """The tiny_centerpoint_cfg float32 train step at epoch 5 on the CPU and
    on the card from the same weights and plan: the gradients, with the
    dense body's ReLU gates aligned where the two sides round an input to
    opposite signs (each such input within BN_OUT_RTOL of its BN's scale).
    Returns (worst error over scale, the aligned units, the float32 launches)."""
    import numpy as np
    import torch

    import robustpointclouds_tpu_torch.nn.perturber as perturber
    from robustpointclouds_tpu_torch.cli.train_nuscenes_adversarial import tiny_centerpoint_cfg
    from robustpointclouds_tpu_torch.data.nuscenes import synthetic_nuscenes_batch
    from robustpointclouds_tpu_torch.models.centerpoint import CenterPointConfig
    from robustpointclouds_tpu_torch.models.voxelnet import plan_to_device
    from robustpointclouds_tpu_torch.nn.second import BatchNorm2d
    from robustpointclouds_tpu_torch.train.centerpoint_loop import CenterPointTrainer

    cfg, n_pts = tiny_centerpoint_cfg(CenterPointConfig(compute_dtype="float32"))
    b, vel = synthetic_nuscenes_batch(np.random.RandomState(seed + 3), batch_size=2,
                                      num_points=n_pts, max_gt=cfg.head.max_objs, num_objects=6,
                                      point_range=cfg.voxelizer.point_cloud_range)
    perturber.PERT_BF16 = False
    try:
        trainers = [CenterPointTrainer(cfg, device=d) for d in (torch.device("cpu"), dev)]
        trainers[0].init_state(seed)
        sd = {k: v.cpu() for k, v in trainers[0].model.state_dict().items()}
        plan = trainers[0].make_plan_builder()(b.points, b.points_mask, b.gt_boxes, b.gt_labels,
                                               b.gt_mask, vel)

        def grads(tr, flips=None):
            tr.init_state(seed, state_dict=sd)
            seen, hooks = {}, []
            for name, mod in tr.model.named_modules():
                if isinstance(mod, BatchNorm2d):
                    def hook(m, inp, out, name=name):
                        seen[name] = out.detach().cpu()
                        if flips and name in flips:
                            f = flips[name].to(out.device)
                            return out + torch.where(f, -2 * out, 0 * out).detach()
                    hooks.append(mod.register_forward_hook(hook))
            try:
                g, logs, is_nan = tr._grads(None, 5.0, plan_to_device(plan, tr.device))
            finally:
                for h in hooks:
                    h.remove()
            if bool(is_nan):
                raise RuntimeError(f"CenterPoint small-grid float32 step on {tr.device}: NaN")
            return {k: v.cpu() for k, v in g.items()}, seen

        zero_counts()
        gg, card_bn = grads(trainers[1])
        torch.cuda.synchronize()
        f32 = read_f32_counts()
        if f32 != {k: read_counts()[k] for k in f32} or not all(f32.values()):
            raise RuntimeError(f"CenterPoint float32 step: 3xTF32 launches {f32}, all "
                               f"{read_counts()}")
        gc, cpu_bn = grads(trainers[0])
        flips = {}
        for k, card_out in card_bn.items():
            differ = (card_out > 0) != (cpu_bn[k] > 0)
            if differ.any():
                near = card_out[differ].abs().max().item() / card_out.abs().max().item()
                if near > BN_OUT_RTOL:
                    raise RuntimeError(f"CenterPoint small-grid step: {k} gates differ at "
                                       f"{near} of its scale, not rounding level")
                flips[k] = differ
        if flips:
            gc, _ = grads(trainers[0], flips)
    finally:
        perturber.PERT_BF16 = True
    gmax = max(v.abs().max().item() for v in gc.values())
    worst = 0.0
    for k, ref in gc.items():
        scale = max(ref.abs().max().item(), TRAIN_GRAD_FLOOR * gmax / TRAIN_GRAD_RTOL)
        err = (gg[k] - ref).abs().max().item()
        worst = max(worst, err / scale)
        if not err <= TRAIN_GRAD_RTOL * scale:
            raise RuntimeError(f"CenterPoint small-grid float32 gradient {k}: card vs CPU "
                               f"{err} over scale {scale}")
    return worst, {k: int(v.sum()) for k, v in flips.items()}, f32


def run_centerpoint(dev, card: str, seed: int, zero_counts, read_counts, read_f32_counts,
                    expect_bf16_kernels):
    """Phase 8: CenterPoint on NuScenes at full width, bf16 (random weights
    from the seed, synthetic 30000-point frames of 5 features):
    (a) K1 on the inputs of the 21 convs of one B=4 train step, forward,
        dgrad and wgrad, bf16 and the float32 route, each against its plain
        version, timed beside index_select + matmul;
    (b) K2's statistics and VJP at [B*60000*10, 5] float32, L2-cold;
    (c) serving through export_serving: B=4 requests, clean and attack; a
        small-grid float32 forward and its decode + circle NMS card vs CPU;
    (d) training through train_nuscenes_adversarial.run(synthetic=True) at
        B=4 to epoch 3 (adversary on), every step's launches checked; a
        small-grid float32 step's gradients card vs CPU;
    (e) evaluation of (d)'s checkpoint through evaluate_nuscenes_adversarial
        (clean and adversarial on synthetic frames, clean on
        tests/fixtures/nuscenes_mini) and evaluate_adversarial_checkpoint;
    (f) cli/train.main on the CenterPoint config file (its dispatch to
        run(cfg=...)), --synthetic, CP_GENERIC_STEPS steps at B=4 with the
        adversary on from epoch 0, every step's launches checked.
    Returns the kernels JSON rows; prints a summary line."""
    import numpy as np
    import torch

    from robustpointclouds_tpu_torch.cli import evaluate_adversarial_checkpoint as ckpt_cli
    from robustpointclouds_tpu_torch.cli import evaluate_nuscenes_adversarial as nus_eval_cli
    from robustpointclouds_tpu_torch.cli import train_nuscenes_adversarial as nus_train_cli
    from robustpointclouds_tpu_torch.cli.export import export_serving
    from robustpointclouds_tpu_torch.cli.train_nuscenes_adversarial import tiny_centerpoint_cfg
    from robustpointclouds_tpu_torch.data.nuscenes import synthetic_nuscenes_batch
    from robustpointclouds_tpu_torch.models.center_detection import centerpoint_decode
    from robustpointclouds_tpu_torch.data.native_plan import build_plan_native
    from robustpointclouds_tpu_torch.models.centerpoint import (AdversarialCenterPoint,
                                                                CenterPointConfig)
    from robustpointclouds_tpu_torch.models.voxelnet import init_weights, plan_to_device
    from robustpointclouds_tpu_torch.nn.layers import MaskedBatchNorm
    from robustpointclouds_tpu_torch.nn.sparse_encoder import SparseConv3d
    from robustpointclouds_tpu_torch.train.centerpoint_loop import CenterPointTrainer

    t_phase = time.time()
    cfg = CenterPointConfig()
    pcr = cfg.voxelizer.point_cloud_range
    rng = np.random.RandomState(seed + 8)

    def frames():
        return synthetic_nuscenes_batch(rng, batch_size=CP_BATCH, num_points=CP_POINTS,
                                        max_gt=cfg.head.max_objs, point_range=pcr)

    # (a) K1 on the inputs of one full-width B=4 train step's 21 convs
    trainer = CenterPointTrainer(cfg, device=dev)
    trainer.init_state(seed)
    # the launch counts above, from the module structure: its sparse convs and
    # MaskedBatchNorms (each of which a train step launches once)
    structure = (sum(isinstance(m, SparseConv3d) for m in trainer.model.modules()),
                 sum(isinstance(m, MaskedBatchNorm) for m in trainer.model.modules()))
    if structure != (CP_CONVS, CP_TRAIN_LAUNCHES["masked_batch_norm"]):
        raise RuntimeError(f"CenterPoint: {structure} sparse convs and MaskedBatchNorms, expected "
                           f"{CP_CONVS} and {CP_TRAIN_LAUNCHES['masked_batch_norm']}")
    b, vel = frames()
    plan = trainer.make_plan_builder()(b.points, b.points_mask, b.gt_boxes, b.gt_labels,
                                       b.gt_mask, vel)
    captured, grads_out = [], {}
    convs = [(n, m) for n, m in trainer.model.named_modules() if isinstance(m, SparseConv3d)]
    hooks = [m.register_forward_pre_hook(lambda mod, a, name=n: captured.append(
        (name, a[0].detach().contiguous(), mod.img2col_kernel(a[0].dtype).detach(), a[1], a[2],
         a[3]))) for n, m in convs]
    def capture_g(out, name):  # a forward hook that returns nothing keeps the output
        out.register_hook(lambda g: grads_out.__setitem__(name, g.contiguous()))

    hooks += [m.register_forward_hook(lambda mod, a, out, name=n: capture_g(out, name))
              for n, m in convs]
    trainer.train_step(b, 3, plan)
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    del trainer
    if len(captured) != CP_CONVS or len(grads_out) != CP_CONVS:
        raise RuntimeError(f"CenterPoint: expected {CP_CONVS} sparse convs in the train step, "
                           f"saw {len(captured)} inputs and {len(grads_out)} cotangents")
    widths = sorted({(c[1].shape[1], c[2].shape[1], c[3].shape[1]) for c in captured})
    print(f"phase 8: {CP_CONVS} convs of a B={CP_BATCH} train step, (Cin, Cout, K) {widths}; "
          f"{int(plan['voxel_mask'].sum())} voxels [{card}]", flush=True)
    t0 = time.time()
    fwd_in = [c[:4] for c in captured]
    bwd_in = [(*c, grads_out[c[0]]) for c in captured]
    k1 = {}
    for route, f32 in (("bf16", False), ("float32", True)):
        rows, tot = check_sparse_conv(fwd_in, torch, f32=f32)
        brows, btot = check_sparse_conv_bwd(bwd_in, torch, f32=f32)
        k1[route] = {"sparse_conv": (rows, tot), "sparse_conv_dgrad": (
            [r for r in brows if r["kernel"] == "dgrad"], btot["dgrad"]),
            "sparse_conv_wgrad": ([r for r in brows if r["kernel"] == "wgrad"], btot["wgrad"])}
    del captured, grads_out, fwd_in, bwd_in
    for route, kinds in k1.items():
        for key, (rows, tot) in kinds.items():
            parts = {"all 21": lambda r: True,
                     "conv_input (Cin 5, padded to 8)": lambda r: r["conv"].endswith(
                         "conv_input.0"),
                     "128 -> 128": lambda r: r["cin"] == 128 and r["cout"] == 128}
            for label, keep in parts.items():
                sub = _conv_subtotal(rows, keep)
                print(f"phase 8 {key} {route} {label} ({sub['convs']} convs): {sub['ms']:.4f} ms "
                      f"(device {_fmt(sub['device_ms'])}), bound {sub['bound_ms']:.4f}, plain "
                      f"{sub['plain_ms']:.4f}, index_select + matmul {sub['library_ms']:.4f}, "
                      f"max error {sub['max_abs_err']:.3e} [{card}]", flush=True)
    print(f"phase 8 (a) K1 checks and timing: {time.time() - t0:.1f} s [{card}]", flush=True)

    # (b) K2 at the adversary's [B*V*T, 5] float32
    n_slots = CP_BATCH * cfg.voxelizer.max_voxels * cfg.voxelizer.max_points_per_voxel
    stats_c5 = check_masked_stats(torch, [(n_slots, 5, torch.float32)], seed)[0]
    vjp_c5 = check_masked_stats_bwd(torch, [(n_slots, 5, torch.float32)], seed)[0]
    for name, r in (("masked_stats", stats_c5), ("masked_stats_bwd", vjp_c5)):
        print(f"phase 8 {name} [{n_slots}, 5] float32: " + json.dumps(r) + f" [{card}]",
              flush=True)

    # (c) serving: B=4 requests, clean and attack=True
    model = AdversarialCenterPoint(cfg)
    init_weights(model, torch.Generator().manual_seed(seed))
    serve = export_serving(model, None, None, cfg.head)
    requests = [(frames()[0], attack) for attack in (False, True) for _ in range(3)]
    for rb, attack in requests[:1] + requests[3:4]:  # warm-up
        serve(rb.points, rb.points_mask,
              build_plan_native(rb.points, rb.points_mask, cfg.voxelizer, 5), attack=attack)
    torch.cuda.synchronize()
    zero_counts()
    served = []
    k_out = len(cfg.tasks) * min(cfg.head.max_per_task, cfg.head.nms_pre)
    for rb, attack in requests:
        t0 = time.perf_counter()
        rplan = build_plan_native(rb.points, rb.points_mask, cfg.voxelizer, 5)
        t1 = time.perf_counter()
        boxes, scores, labels, valid = serve(rb.points, rb.points_mask, rplan, attack=attack)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if boxes.shape != (CP_BATCH, k_out, 9) or scores.shape != (CP_BATCH, k_out):
            raise RuntimeError(f"CenterPoint serving: shapes {boxes.shape} {scores.shape}")
        if not (torch.isfinite(boxes).all() and torch.isfinite(scores).all()):
            raise RuntimeError("CenterPoint serving: non-finite detections")
        if labels.min() < 0 or labels.max() >= cfg.head.num_classes:
            raise RuntimeError("CenterPoint serving: label out of range")
        served.append(dict(attack=attack, plan_ms=(t1 - t0) * 1e3, serve_ms=(t2 - t1) * 1e3,
                           valid=int(valid.sum())))
    got = read_counts()
    expect_bf16_kernels("CenterPoint serving")
    want = {"sparse_conv": CP_CONVS * 6, "sparse_conv_dgrad": 0, "sparse_conv_wgrad": 0,
            "masked_stats": 2 * 3, "masked_stats_bwd": 0,
            "masked_batch_norm": (CP_BN_CLEAN + CP_BN_ATTACK) * 3, "masked_batch_norm_bwd": 0,
            "bwd_reduce": 0}
    if got != want:
        raise RuntimeError(f"CenterPoint serving launches {got}, expected {want}")
    serve_summary = {}
    for attack in (False, True):
        sel = [t for t in served if t["attack"] == attack]
        key = "attack" if attack else "clean"
        serve_summary[key] = {k: sum(t[k] for t in sel) / len(sel) for k in ("plan_ms",
                                                                            "serve_ms")}
        print(f"phase 8 serving {key} B={CP_BATCH}: " + json.dumps(sel) + f"; mean serve_ms "
              f"{serve_summary[key]['serve_ms']:.3f}, plan_ms {serve_summary[key]['plan_ms']:.3f}"
              f" [{card}]", flush=True)
    del model, serve
    # a small-grid float32 forward and its decode + circle NMS, card vs CPU
    small, n_pts = tiny_centerpoint_cfg(CenterPointConfig(compute_dtype="float32"))
    sb, _ = synthetic_nuscenes_batch(np.random.RandomState(seed + 1), batch_size=2,
                                     num_points=n_pts, max_gt=8, num_objects=4,
                                     point_range=small.voxelizer.point_cloud_range)
    splan = build_plan_native(sb.points, sb.points_mask, small.voxelizer, 5)
    smodel = AdversarialCenterPoint(small)
    init_weights(smodel, torch.Generator().manual_seed(seed))
    smodel.eval()
    with torch.no_grad():
        ref = smodel(None, None, False, 100, True, -1.0, plan_to_device(splan, torch.device("cpu")))
        out = smodel.to(dev)(None, None, False, 100, True, -1.0, plan_to_device(splan, dev))
    for t, (r, g) in enumerate(zip(ref.task_preds, out.task_preds)):
        for k in r:
            err = (r[k] - g[k].cpu()).abs().max().item()
            if not err <= E2E_F32_RTOL * max(r[k].abs().max().item(), 1e-6):
                raise RuntimeError(f"CenterPoint small-grid float32 task {t} {k}: card vs CPU "
                                   f"{err}")
    shead = small.head._replace(score_thr=0.0)  # every candidate enters the NMS sweep
    (cb, cs, cl, cv), (gb, gs, gl, gv) = [
        centerpoint_decode([{k: v.to(d) for k, v in p.items()} for p in ref.task_preds], shead)
        for d in (torch.device("cpu"), dev)]
    gb, gs, gl, gv = gb.cpu(), gs.cpu(), gl.cpu(), gv.cpu()
    if not (torch.equal(cv, gv) and torch.equal(cl[cv], gl[gv]) and int(cv.sum()) > 0):
        raise RuntimeError("CenterPoint small-grid decode + circle NMS: card and CPU keep "
                           "different detections")
    box_err = (cb[cv] - gb[gv]).abs().max().item()
    if not (box_err <= E2E_F32_RTOL * cb[cv].abs().max().item()
            and (cs[cv] - gs[gv]).abs().max().item() <= 1e-6):
        raise RuntimeError(f"CenterPoint small-grid decode + circle NMS: box error {box_err}")
    print(f"phase 8 small-grid float32 forward and decode + circle NMS ({int(cv.sum())} "
          f"detections): card agrees with the CPU [{card}]", flush=True)

    # (d) training through the CLI's run() at B=4, to epoch 3 (adversary on)
    steps, seen = [], {}
    orig_step = CenterPointTrainer.train_step
    watch = ("pts_middle_encoder.conv_input.0.weight",
             "pts_bbox_head.task_heads.0.heatmap.1.weight", "adversary.mlp_out.weight")

    def timed_step(self, batch, epoch, plan):
        if not seen:
            seen.update({k: v.detach().clone() for k, v in self.model.named_parameters()
                         if k in watch})
            seen["_trainer"] = self
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        logs = orig_step(self, batch, epoch, plan)
        logs = {k: float(v) for k, v in logs.items()}  # waits for the step
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = read_counts()
        if got != CP_TRAIN_LAUNCHES:
            raise RuntimeError(f"CenterPoint train step launches {got}, expected "
                               f"{CP_TRAIN_LAUNCHES}")
        expect_bf16_kernels("CenterPoint training")
        if not all(np.isfinite(v) for v in logs.values()):
            raise RuntimeError(f"CenterPoint train step: non-finite logs {logs}")
        steps.append(dict(epoch=epoch, step_ms=ms, loss=logs["loss"],
                          l2=logs["perturbation_l2_norm"]))
        return logs

    work_dir = os.path.join(REPO, "work_dirs", "chip_smoke_centerpoint")
    shutil.rmtree(work_dir, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats(dev)
    CenterPointTrainer.train_step = timed_step
    try:
        res = nus_train_cli.run(work_dir=work_dir, batch_size=CP_BATCH, max_epochs=CP_EPOCHS,
                                steps_per_epoch=CP_STEPS_PER_EPOCH, synthetic=True, seed=seed,
                                device=dev)
    finally:
        CenterPointTrainer.train_step = orig_step
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    if len(steps) != CP_EPOCHS * CP_STEPS_PER_EPOCH:
        raise RuntimeError(f"CenterPoint training ran {len(steps)} steps")
    if not all(s["l2"] > 0 for s in steps if s["epoch"] >= 3):
        raise RuntimeError("CenterPoint training: the adversary did not perturb at epoch 3")
    params = dict(seen["_trainer"].model.named_parameters())
    for k in watch:
        if torch.equal(seen[k], params[k].detach()):
            raise RuntimeError(f"CenterPoint training: {k} did not move")
    del seen["_trainer"]
    plans = res["plans"]
    for st in steps:
        print("phase 8 train step " + json.dumps(st) + f" [{card}]", flush=True)
    for key in ("native_ms", "targets_ms", "plan_ms"):
        print(f"phase 8 plan build {key} ({len(plans)} builds): "
              f"{json.dumps([round(p[key], 3) for p in plans])} [{card}]", flush=True)
    steady = [e for e in res["epochs"] if e["epoch"] >= 1]
    train_summary = dict(
        step_ms=statistics.median(s["step_ms"] for s in steps[1:]),
        frames_per_s=[round(e["frames_per_s"], 3) for e in res["epochs"]],
        steady_frames_per_s=sum(e["frames"] for e in steady) / sum(e["s"] for e in steady),
        native_ms=statistics.mean(p["native_ms"] for p in plans),
        targets_ms=statistics.mean(p["targets_ms"] for p in plans),
        peak_gib=peak_gb)
    print(f"phase 8 training B={CP_BATCH} full width (train_nuscenes_adversarial.run): median "
          f"step_ms {train_summary['step_ms']:.1f} (host clock, the first step left out), "
          f"frames/s per epoch {train_summary['frames_per_s']}, steady "
          f"{train_summary['steady_frames_per_s']:.3f}; plan build native "
          f"{train_summary['native_ms']:.1f} ms + targets {train_summary['targets_ms']:.1f} ms; "
          f"max_memory_allocated {peak_gb:.2f} GiB; per step "
          + ", ".join(f"{k} {v}" for k, v in CP_TRAIN_LAUNCHES.items()) + f" [{card}]",
          flush=True)
    worst, aligned, f32_launches = _centerpoint_small_grads(dev, seed, read_counts,
                                                            read_f32_counts, zero_counts)
    print(f"phase 8 small-grid float32 train step: gradients card vs CPU within {worst:.2e} of "
          f"scale (ReLU gates aligned at rounding level: {aligned}); 3xTF32 launches "
          f"{json.dumps(f32_launches)} [{card}]", flush=True)

    # (e) evaluation of (d)'s checkpoint through the CLIs' entry points
    mini = os.path.join(REPO, "tests", "fixtures", "nuscenes_mini")
    eval_summary = {}
    for name, entry, argv, fwd_bn, stats in (
            ("clean synthetic", nus_eval_cli.main,
             ["--mode", "clean", "--checkpoint", work_dir, "--synthetic", "--frames",
              str(CP_EVAL_FRAMES), "--batch-size", str(CP_BATCH)], CP_BN_CLEAN, 0),
            ("adversarial synthetic", nus_eval_cli.main,
             ["--mode", "adversarial", "--checkpoint", work_dir, "--synthetic", "--frames",
              str(CP_EVAL_FRAMES), "--batch-size", str(CP_BATCH)], CP_BN_ATTACK, 2),
            ("clean nuscenes_mini", nus_eval_cli.main,
             ["--mode", "clean", "--checkpoint", work_dir, "--data-root", mini, "--batch-size",
              str(CP_BATCH)], CP_BN_CLEAN, 0),
            ("checkpoint synthetic", ckpt_cli.main,
             ["--work-dir", work_dir, "--synthetic", "--frames", str(CP_BATCH), "--batch-size",
              str(CP_BATCH)], CP_BN_CLEAN, 0)):
        zero_counts()
        timings = {}
        out = entry(argv, timings=timings)
        torch.cuda.synchronize()
        got = read_counts()
        runs = {"checkpoint": out} if entry is ckpt_cli.main else out
        batches = (timings["batches"] if entry is ckpt_cli.main
                   else [bt for t in timings.values() for bt in t["batches"]])
        nb = len(batches)
        want = {"sparse_conv": CP_CONVS * nb, "sparse_conv_dgrad": 0, "sparse_conv_wgrad": 0,
                "masked_stats": stats * nb, "masked_stats_bwd": 0,
                "masked_batch_norm": fwd_bn * nb, "masked_batch_norm_bwd": 0, "bwd_reduce": 0}
        if got != want:
            raise RuntimeError(f"CenterPoint eval {name}: launches {got}, expected {want}")
        for run, r in runs.items():
            pre = "SYNTHETIC_" if "synthetic" in name else ""
            if r is None or not all(np.isfinite(r[pre + k]) for k in ("mAP", "NDS", "mATE")):
                raise RuntimeError(f"CenterPoint eval {name} {run}: {r}")
        for i, bt in enumerate(batches):
            print(f"phase 8 eval {name} batch {i}: " + json.dumps(bt) + f" [{card}]", flush=True)
        eval_summary[name] = {k: statistics.mean(bt[k] for bt in batches)
                              for k in ("plan_ms", "device_ms", "metric_ms")}
        print(f"phase 8 eval {name} (B={CP_BATCH}, {nb} batches): mean per batch "
              + ", ".join(f"{k} {v:.3f}" for k, v in eval_summary[name].items())
              + f"; launches {json.dumps(got)} [{card}]", flush=True)

    # (f) the generic entry point on the config file: cli/train dispatches to run(cfg=...)
    from robustpointclouds_tpu_torch.cli import train as generic_cli

    steps.clear()
    seen.clear()
    generic_dir = os.path.join(REPO, "work_dirs", "chip_smoke_centerpoint_generic")
    shutil.rmtree(generic_dir, ignore_errors=True)
    CenterPointTrainer.train_step = timed_step
    try:
        res = generic_cli.main([CP_CONFIG, "--synthetic", "--steps-per-epoch",
                                str(CP_GENERIC_STEPS), "--work-dir", generic_dir, "--cfg-options",
                                f"batch_size={CP_BATCH}", "max_epochs=1",
                                "model.adversary_start_epoch=0"])
    finally:
        CenterPointTrainer.train_step = orig_step
    if len(steps) != CP_GENERIC_STEPS or not all(s["l2"] > 0 for s in steps):
        raise RuntimeError(f"phase 8 (f): cli/train ran {steps}")
    if type(seen.pop("_trainer").model_cfg).__name__ != "CenterPointConfig":
        raise RuntimeError("phase 8 (f): cli/train did not dispatch to the CenterPoint trainer")
    if not os.path.isfile(os.path.join(generic_dir, "epoch_0.pt")):
        raise RuntimeError("phase 8 (f): no checkpoint written")
    generic = dict(step_ms=[round(s["step_ms"], 3) for s in steps],
                   loss=[round(s["loss"], 4) for s in steps],
                   frames_per_s=[round(e["frames_per_s"], 3) for e in res["epochs"]])
    print(f"phase 8 (f) cli/train.main on {os.path.relpath(CP_CONFIG, REPO)} --synthetic, "
          f"B={CP_BATCH}, {CP_GENERIC_STEPS} steps with the adversary on: "
          + json.dumps(generic) + "; per step " + json.dumps(CP_TRAIN_LAUNCHES)
          + f" [{card}]", flush=True)
    print(f"phase 8: {time.time() - t_phase:.1f} s [{card}]", flush=True)

    conv_src = "robustpointclouds_tpu_torch/csrc/sparse_conv_tc.cu"
    tf32_src = "robustpointclouds_tpu_torch/csrc/sparse_conv_tf32.cu"
    rows = []
    for route, src, suffix in (("bf16", conv_src, ""), ("float32", tf32_src, "_f32")):
        for key, (_, tot) in k1[route].items():
            launches = (CP_TRAIN_LAUNCHES[key] * len(steps) if route == "bf16"
                        else f32_launches[key])
            rows.append({"name": f"{key}{suffix}_centerpoint", "route": "cuda", "source": src,
                         "replaces": "robustpointclouds_tpu/kernels/mp_gather.py:192",
                         "launches": launches, "max_abs_err": tot["err"], "ms": tot["ms"],
                         "device_ms": tot["device_ms"],
                         "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
                         "bound_by": tot["bound_by"], "library_ms": tot["library_ms"]})
    # the statistics at C = 5 run on this path; their VJP (held and timed in
    # (b)) does not, so it keeps its row from phase 4's path alone
    rows.append({"name": "masked_stats_c5", "route": "cuda",
                 "source": "robustpointclouds_tpu_torch/csrc/masked_stats.cu",
                 "replaces": "robustpointclouds_tpu/kernels/masked_stats.py:113",
                 "launches": CP_TRAIN_LAUNCHES["masked_stats"] * len(steps),
                 **{k: stats_c5[k] for k in ("max_abs_err", "ms", "device_ms",
                                             "plain_ms", "bound_ms", "bound_by", "library_ms")}})
    print("phase 8 summary " + json.dumps(dict(
        serving=serve_summary, training=train_summary, evaluation=eval_summary, generic=generic,
        small_grid_grad_worst=worst, aligned_gates=aligned)) + f" [{card}]", flush=True)
    return rows


# phase 9: PointPillars at full width (models/pointpillars.PointPillarsConfig:
# 0.16 m pillars over [0, 69.12] x [-39.68, 39.68], grid 432 x 496 x 1, 16000
# pillars x 32 points, BEV 248 x 216, 321408 anchors, adversary (64, 128, 64))
PP_BATCH, PP_POINTS = 6, 20000  # the config's batch_size; the KITTI loader's frames
# kernel launches of a pillar train step, derived from the code: no sparse
# conv; the masked statistics under the adversary's std normalisation
# (forward only) and perturbation_losses (forward and VJP: the bias and
# imbalance terms take the per-dim statistics); 6 train-mode
# MaskedBatchNorms (the PFN's and the adversary's 5), each with the fused
# forward and backward and bwd_reduce (their parameters train)
PP_TRAIN_LAUNCHES = {"sparse_conv": 0, "sparse_conv_dgrad": 0, "sparse_conv_wgrad": 0,
                     "masked_stats": 2, "masked_stats_bwd": 1, "masked_batch_norm": 6,
                     "masked_batch_norm_bwd": 6, "bwd_reduce": 6}
# MaskedBatchNorms of an eval forward: the PFN's, plus the adversary's 5 under attack
PP_BN_CLEAN, PP_BN_ATTACK = 1, 6
PP_TRAIN_STEPS = 6  # timed steps at epoch 3 after one warm-up step
PP_EVAL_BATCHES = 2


def _launches(**per):
    """A launch-count dict with every wrapper, 0 where `per` does not say."""
    out = {k: 0 for k in PP_TRAIN_LAUNCHES}
    out.update(per)
    return out


class PlainVersionCalls:
    """Counts the calls of K2's plain versions (kernels/masked_stats.py's
    *_ref) and, with `k1`, K1's (kernels/sparse_conv.py's), which a wrapper
    takes only for a tensor on the CPU; the main path on the card must make
    none."""

    NAMES = ("masked_stats_ref", "masked_stats_bwd_ref", "_bn_ref", "_bn_stats_ref",
             "bn_apply_ref", "masked_batch_norm_bwd_ref", "masked_stats_lowp_ref")
    K1_NAMES = ("sparse_conv_ref", "sparse_conv_wgrad_ref")

    def __init__(self, k1: bool = False):
        self.k1 = k1

    def __enter__(self):
        import robustpointclouds_tpu_torch.kernels.masked_stats as ms
        import robustpointclouds_tpu_torch.kernels.sparse_conv as sc

        self.calls = 0
        self.saved = [(ms, n, getattr(ms, n)) for n in self.NAMES]
        if self.k1:
            self.saved += [(sc, n, getattr(sc, n)) for n in self.K1_NAMES]

        def counted(fn):
            def call(*a, **kw):
                self.calls += 1
                return fn(*a, **kw)
            return call
        for mod, n, fn in self.saved:
            setattr(mod, n, counted(fn))
        return self

    def __exit__(self, *exc):
        for mod, n, fn in self.saved:
            setattr(mod, n, fn)


def run_pointpillars(dev, card: str, seed: int, zero_counts, read_counts, expect_bf16_kernels,
                     data_root: str, work_root: str):
    """Phase 9: the PointPillars family at full width, bf16 (random weights
    from the seed, 20000-point synthetic frames in the pillar range):
    (a) K2 at the pillar shapes on the inputs of one B=6 train step (the
        PFN's BN at [3072000, 64] bf16, the adversary's 5 BNs at [3072000,
        64 / 128] bf16, forward and backward; its statistics and their VJP
        at [3072000, 4] float32), each against its plain version;
    (b) serving through export_serving: 3 clean and 3 attack B=6 requests
        on the native pillar plan, launches checked, no plain version;
    (c) a small-grid float32 forward with decode + rotated NMS, card vs CPU;
    (d) training at epoch 3 fed by with_plans through PillarPlanBuilder,
        every step's launches checked;
    (e) the generic entry point cli/train.main on the config file with
        --validate --steps-per-epoch 2 on phase 7's KITTI-layout dataset;
    (f) run_evaluation clean, learned and PGD-10 on two B=6 batches from
        (d)'s state.
    Returns the kernels JSON rows; prints a summary line."""
    import numpy as np
    import torch

    import robustpointclouds_tpu_torch.nn.perturber as perturber
    from robustpointclouds_tpu_torch.cli import train as generic_cli
    from robustpointclouds_tpu_torch.cli.common import (
        prefetch_iterator, run_evaluation, synthetic_loader, tiny_pointpillars_cfg, with_plans)
    from robustpointclouds_tpu_torch.cli.export import export_serving
    from robustpointclouds_tpu_torch.data.synthetic import synthetic_kitti_batch
    from robustpointclouds_tpu_torch.models.detection import anchor_head_predict
    from robustpointclouds_tpu_torch.data.native_plan import build_pillar_plan_native
    from robustpointclouds_tpu_torch.models.pointpillars import (AdversarialPointPillars,
                                                                 PointPillarsConfig)
    from robustpointclouds_tpu_torch.models.voxelnet import init_weights, plan_to_device
    from robustpointclouds_tpu_torch.nn.layers import MaskedBatchNorm
    from robustpointclouds_tpu_torch.nn.perturber import VoxelPerturber
    from robustpointclouds_tpu_torch.train.checkpoint import CheckpointManager
    from robustpointclouds_tpu_torch.train.loop import PillarPlanBuilder, TrainConfig, Trainer

    t_phase = time.time()
    cfg = PointPillarsConfig()
    pcr = cfg.voxelizer.point_cloud_range
    vz = cfg.voxelizer
    n_slots = PP_BATCH * vz.max_voxels * vz.max_points_per_voxel
    rng = np.random.RandomState(seed + 9)

    def frames():
        return synthetic_kitti_batch(rng, batch_size=PP_BATCH, num_points=PP_POINTS, max_gt=20,
                                     num_objects=8, point_range=pcr)

    # the trainer (full width, bf16) and its input pipeline: pillar plans
    # (native plan + anchor assignment) built in the prefetch thread
    trainer = Trainer(cfg, TrainConfig(), device=dev)
    trainer.init_state(seed)
    structure = sum(isinstance(m, MaskedBatchNorm) for m in trainer.model.modules())
    if structure != PP_TRAIN_LAUNCHES["masked_batch_norm"] or structure != PP_BN_ATTACK:
        raise RuntimeError(f"PointPillars: {structure} MaskedBatchNorms, expected "
                           f"{PP_TRAIN_LAUNCHES['masked_batch_norm']}")
    builder = trainer.make_plan_builder()
    if not isinstance(builder, PillarPlanBuilder):
        raise RuntimeError(f"PointPillars trainer built a {type(builder).__name__}")
    loader = synthetic_loader(PP_BATCH, 1 + PP_TRAIN_STEPS, num_points=PP_POINTS, seed=seed,
                              point_range=pcr)
    train_iter = prefetch_iterator(with_plans(builder, loader(0)))

    # warm-up step at epoch 3, capturing each MaskedBatchNorm's (x, mask) and
    # output cotangent and the adversary's input rows
    bn_in, bn_g, adv_in, hooks = {}, {}, {}, []

    def capture_g(out, name):  # a forward hook that returns nothing keeps the output
        out.register_hook(lambda g: bn_g.__setitem__(name, g.contiguous()))

    for name, mod in trainer.model.named_modules():
        if isinstance(mod, MaskedBatchNorm):
            hooks.append(mod.register_forward_pre_hook(
                lambda m, a, name=name: bn_in.__setitem__(name, (a[0].detach(), a[1]))))
            hooks.append(mod.register_forward_hook(
                lambda m, a, out, name=name: capture_g(out, name)))
        elif isinstance(mod, VoxelPerturber):
            hooks.append(mod.register_forward_pre_hook(
                lambda m, a: adv_in.update(x=a[0].detach(), mask=a[1])))
    batch, tplan = next(train_iter)
    warm_logs = trainer.train_step(batch, epoch=3, plan=tplan)
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    if len(bn_in) != structure or len(bn_g) != structure or adv_in["x"].shape != (n_slots, 4):
        raise RuntimeError(f"PointPillars warm-up captured {len(bn_in)} BN inputs, {len(bn_g)} "
                           f"cotangents, adversary rows {tuple(adv_in['x'].shape)}")
    kept = int(tplan["point_mask"].sum())
    print(f"phase 9: B={PP_BATCH} train warm-up loss {float(warm_logs['loss']):.4f}, num_pos "
          f"{float(warm_logs['num_pos']):.0f}; {int(tplan['voxel_mask'].sum())} pillars, {kept} "
          f"of {n_slots} point slots kept ({kept / n_slots:.4f}) [{card}]", flush=True)

    # (a) K2 at the pillar shapes, on the warm-up step's own inputs
    t0 = time.time()
    mods = dict(trainer.model.named_modules())
    cases = {"pfn": ["voxel_encoder.pfn_layers.0.norm"]}
    for name in sorted(n for n in bn_in if n.startswith("adversary.")):
        cases.setdefault(f"perturber {bn_in[name][0].shape[1]}", []).append(name)
    bn_rows = {}  # label -> [(fwd, bwd)], one pair for each BN of the label
    for label, names in cases.items():
        for name in names:
            mod = mods[name]
            x, mask = bn_in[name]
            if x.shape[0] != n_slots or x.dtype != torch.bfloat16:
                raise RuntimeError(f"PointPillars {name}: x {tuple(x.shape)} {x.dtype}")
            with torch.no_grad():
                w, b = mod.weight.detach().clone(), mod.bias.detach().clone()
                rm, rv = mod.running_mean.clone(), mod.running_var.clone()
            fwd, bwd = bn_case(torch, name, 1, x.contiguous(), mask.contiguous(), w, b, rm, rv,
                               bn_g[name], True, True, False, None, momentum=mod.momentum)
            # the bytes the model needs of this BN: x (and g) read and y (or
            # dx) written on the kept slots only, the mask once; the function
            # as called (bound_ms) writes every slot, ~97% of them padding
            n_kept, small = int(mask.sum().item()), 6 * x.shape[1] * 4 + x.shape[0]
            row_bytes = x.shape[1] * x.element_size()
            fwd["bound_kept_ms"] = (2 * n_kept * row_bytes + small) / HBM_BYTES_PER_S * 1e3
            bwd["bound_kept_ms"] = (3 * n_kept * row_bytes + small) / HBM_BYTES_PER_S * 1e3
            bn_rows.setdefault(label, []).append((fwd, bwd))
            for r in (fwd, bwd):
                print(f"phase 9 {r['kernel']} {label}: {name} [{r['n']}, {r['c']}] bf16: "
                      + json.dumps(r) + f" [{card}]", flush=True)
    del bn_in, bn_g
    ax, am = adv_in["x"].contiguous(), adv_in["mask"].contiguous()
    stats_row = stats_case(torch, ax, am)
    g = torch.Generator(device=dev).manual_seed(seed)
    vjp_row = stats_bwd_case(torch, ax, am, torch.randn(4, device=dev, generator=g),
                             torch.randn(4, device=dev, generator=g))
    del adv_in, ax, am
    for name, r in (("masked_stats", stats_row), ("masked_stats_bwd", vjp_row)):
        print(f"phase 9 {name} [{n_slots}, 4] float32: " + json.dumps(r) + f" [{card}]",
              flush=True)
    step_bn = {}
    for i, kernel in enumerate(("masked_batch_norm", "masked_batch_norm_bwd")):
        rows = [pair[i] for pairs in bn_rows.values() for pair in pairs]
        tot = {k: sum(r[k] for r in rows)
               for k in ("ms", "plain_ms", "bound_ms", "bound_kept_ms")}
        tot["device_ms"] = (None if any(r["device_ms"] is None for r in rows)
                            else sum(r["device_ms"] for r in rows))
        tot["max_abs_err"] = max(r["max_abs_err"] for r in rows)
        step_bn[kernel] = tot
        print(f"phase 9 {kernel} summed over the {len(rows)} BNs of a train step, each "
              f"measured on its own inputs: "
              f"{tot['ms']:.4f} ms (device {_fmt(tot['device_ms'])}), bound {tot['bound_ms']:.4f} "
              f"(kept slots only {tot['bound_kept_ms']:.4f}), plain {tot['plain_ms']:.4f} "
              f"[{card}]", flush=True)
    print(f"phase 9 (a) K2 checks and timing: {time.time() - t0:.1f} s [{card}]", flush=True)

    # (d) training: timed steps at epoch 3 (adversary on), every step's launches checked
    params = dict(trainer.model.named_parameters())
    watch = ("voxel_encoder.pfn_layers.0.linear.weight", "backbone.blocks.0.0.weight",
             "adversary.mlp_0.weight")
    before = {k: params[k].detach().clone() for k in watch}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    steps = []
    with PlainVersionCalls() as plain:
        for _ in range(PP_TRAIN_STEPS):
            t0 = time.perf_counter()
            batch, tplan = next(train_iter)
            t1 = time.perf_counter()
            zero_counts()
            logs = trainer.train_step(batch, epoch=3, plan=tplan)
            logs = {k: float(v) for k, v in logs.items()}  # waits for the step
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            got = read_counts()
            if got != PP_TRAIN_LAUNCHES:
                raise RuntimeError(f"PointPillars train step launches {got}, expected "
                                   f"{PP_TRAIN_LAUNCHES}")
            if not all(np.isfinite(v) for v in logs.values()) or logs["num_pos"] <= 0:
                raise RuntimeError(f"PointPillars train step logs {logs}")
            steps.append(dict(wait_ms=(t1 - t0) * 1e3, step_ms=(t2 - t1) * 1e3,
                              loss=logs["loss"], num_pos=logs["num_pos"],
                              l2=logs["perturbation_l2_norm"]))
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    for rest in train_iter:  # drain the prefetch thread
        pass
    expect_bf16_kernels("PointPillars training")
    if plain.calls:
        raise RuntimeError(f"PointPillars training reached a plain version {plain.calls} times")
    if int(trainer.state.nan_count) != 0 or not all(st["l2"] > 0 for st in steps):
        raise RuntimeError("PointPillars training: NaN steps or no perturbation at epoch 3")
    for k in watch:
        if torch.equal(before[k], params[k].detach()):
            raise RuntimeError(f"PointPillars training: {k} did not move")
    for st in steps:
        print("phase 9 train step " + json.dumps(st) + f" [{card}]", flush=True)
    builds = list(builder.timings)
    for key in ("native_ms", "assign_ms", "plan_ms"):
        print(f"phase 9 plan build {key} ({len(builds)} builds): "
              f"{json.dumps([round(b[key], 3) for b in builds])} [{card}]", flush=True)
    steady = steps[PREFETCHED_STEPS:]
    train_summary = dict(
        median_step_ms=statistics.median(st["step_ms"] for st in steps),
        steady_frames_per_s=PP_BATCH * len(steady) / sum(
            (st["wait_ms"] + st["step_ms"]) / 1e3 for st in steady),
        native_ms=statistics.mean(b["native_ms"] for b in builds),
        assign_ms=statistics.mean(b["assign_ms"] for b in builds), peak_gib=peak_gib)
    print(f"phase 9 training B={PP_BATCH} full width: median step_ms "
          f"{train_summary['median_step_ms']:.1f} (host clock, step to synchronise), steady "
          f"{train_summary['steady_frames_per_s']:.3f} frames/s over the last {len(steady)} "
          f"steps; plan build native {train_summary['native_ms']:.1f} ms + assignment "
          f"{train_summary['assign_ms']:.1f} ms ({len(cfg.make_anchors()[0])} anchors); "
          f"max_memory_allocated {peak_gib:.2f} GiB; per step "
          + json.dumps(PP_TRAIN_LAUNCHES) + f" [{card}]", flush=True)

    # (f) evaluation from (d)'s state: clean, learned and PGD-10 on two batches
    eval_batches = [frames() for _ in range(PP_EVAL_BATCHES)]
    eval_summary = {}
    for name, kw, want in (
            ("clean", {}, _launches(masked_batch_norm=PP_BN_CLEAN)),
            ("learned", dict(attack=True),
             _launches(masked_stats=2, masked_batch_norm=PP_BN_ATTACK)),
            ("pgd", dict(attack=True, attack_method="pgd", attack_steps=PGD_STEPS),
             _launches(masked_batch_norm=PP_BN_CLEAN * (PGD_STEPS + 1),
                       masked_batch_norm_bwd=PP_BN_CLEAN * PGD_STEPS))):
        torch.cuda.synchronize()
        zero_counts()
        timings = {}
        with PlainVersionCalls() as plain:
            res = run_evaluation(trainer, eval_batches, timings=timings, **kw)
            torch.cuda.synchronize()
        got = read_counts()
        want = {k: v * PP_EVAL_BATCHES for k, v in want.items()}
        if got != want or plain.calls:
            raise RuntimeError(f"PointPillars eval {name}: launches {got}, expected {want}; "
                               f"{plain.calls} plain-version calls")
        if res["num_frames"] != PP_BATCH * PP_EVAL_BATCHES or not np.isfinite(
                res["mAP_3d_moderate"]):
            raise RuntimeError(f"PointPillars eval {name}: {res}")
        for i, bt in enumerate(timings["batches"]):
            print(f"phase 9 eval {name} batch {i}: " + json.dumps(bt) + f" [{card}]", flush=True)
        eval_summary[name] = {k: statistics.mean(bt[k] for bt in timings["batches"])
                              for k in ("plan_ms", "device_ms", "metric_ms")}
        print(f"phase 9 eval {name} (B={PP_BATCH}, {PP_EVAL_BATCHES} batches): mean per batch "
              + ", ".join(f"{k} {v:.3f}" for k, v in eval_summary[name].items())
              + f"; launches {json.dumps(got)} [{card}]", flush=True)
    expect_bf16_kernels("PointPillars evaluation")
    del trainer, builder, train_iter

    # (b) serving: B=6 requests, clean and attack=True, on the native pillar plan
    model = AdversarialPointPillars(cfg)
    init_weights(model, torch.Generator().manual_seed(seed))
    anchors, _ = cfg.make_anchors()
    serve = export_serving(model, None, anchors, cfg.head)
    requests = [(frames(), attack) for attack in (False, True) for _ in range(3)]
    for rb, attack in requests[:1] + requests[3:4]:  # warm-up
        serve(rb.points, rb.points_mask,
              build_pillar_plan_native(rb.points, rb.points_mask, cfg.voxelizer, 4),
              attack=attack)
    torch.cuda.synchronize()
    zero_counts()
    served = []
    with PlainVersionCalls() as plain:
        for rb, attack in requests:
            t0 = time.perf_counter()
            rplan = build_pillar_plan_native(rb.points, rb.points_mask, cfg.voxelizer, 4)
            t1 = time.perf_counter()
            boxes, scores, labels, valid = serve(rb.points, rb.points_mask, rplan, attack=attack)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if boxes.shape != (PP_BATCH, cfg.head.max_num, 7) or not (
                    torch.isfinite(boxes).all() and torch.isfinite(scores).all()):
                raise RuntimeError(f"PointPillars serving: {tuple(boxes.shape)} or non-finite")
            if labels.min() < 0 or labels.max() >= cfg.num_classes:
                raise RuntimeError("PointPillars serving: label out of range")
            served.append(dict(attack=attack, plan_ms=(t1 - t0) * 1e3, serve_ms=(t2 - t1) * 1e3,
                               valid=int(valid.sum())))
    got = read_counts()
    expect_bf16_kernels("PointPillars serving")
    want = _launches(masked_stats=2 * 3, masked_batch_norm=(PP_BN_CLEAN + PP_BN_ATTACK) * 3)
    if got != want or plain.calls:
        raise RuntimeError(f"PointPillars serving launches {got}, expected {want}; "
                           f"{plain.calls} plain-version calls")
    serve_summary = {}
    for attack in (False, True):
        sel = [t for t in served if t["attack"] == attack]
        key = "attack" if attack else "clean"
        serve_summary[key] = {k: statistics.mean(t[k] for t in sel)
                              for k in ("plan_ms", "serve_ms")}
        print(f"phase 9 serving {key} B={PP_BATCH}: " + json.dumps(sel) + f"; mean serve_ms "
              f"{serve_summary[key]['serve_ms']:.3f}, plan_ms {serve_summary[key]['plan_ms']:.3f};"
              f" per request masked_batch_norm {PP_BN_ATTACK if attack else PP_BN_CLEAN}, "
              f"masked_stats {2 if attack else 0} [{card}]", flush=True)
    del model, serve

    # (c) a small-grid float32 forward and its decode + rotated NMS, card vs CPU
    small = tiny_pointpillars_cfg()._replace(compute_dtype="float32")
    sb = synthetic_kitti_batch(np.random.RandomState(seed + 1), batch_size=2, num_points=600,
                               max_gt=4, num_objects=3,
                               point_range=small.voxelizer.point_cloud_range)
    splan = build_pillar_plan_native(sb.points, sb.points_mask, small.voxelizer, 4)
    smodel = AdversarialPointPillars(small)
    init_weights(smodel, torch.Generator().manual_seed(seed))
    smodel.eval()
    perturber.PERT_BF16 = False
    try:
        with torch.no_grad():
            ref = smodel(None, None, False, 100, True, -1.0,
                         plan_to_device(splan, torch.device("cpu")))
            out = smodel.to(dev)(None, None, False, 100, True, -1.0, plan_to_device(splan, dev))
    finally:
        perturber.PERT_BF16 = True
    for name in ("cls_scores", "bbox_preds", "dir_preds"):
        r, o = getattr(ref, name), getattr(out, name).cpu()
        err = (r - o).abs().max().item()
        if not err <= E2E_F32_RTOL * max(r.abs().max().item(), 1e-6):
            raise RuntimeError(f"PointPillars small-grid float32 {name}: card vs CPU {err}")
    shead = small.head._replace(score_thr=0.0)  # every candidate enters the NMS sweep
    sanchors = torch.as_tensor(small.make_anchors()[0])
    (cb, cs, cl, cv), (gb, gs, gl, gv) = [
        anchor_head_predict(ref.cls_scores.to(d), ref.bbox_preds.to(d), ref.dir_preds.to(d),
                            sanchors.to(d), shead) for d in (torch.device("cpu"), dev)]
    gb, gs, gl, gv = gb.cpu(), gs.cpu(), gl.cpu(), gv.cpu()
    if not (torch.equal(cv, gv) and torch.equal(cl[cv], gl[gv]) and int(cv.sum()) > 0):
        raise RuntimeError("PointPillars small-grid decode + NMS: card and CPU keep different "
                           "detections")
    box_err = (cb[cv] - gb[gv]).abs().max().item()
    if not (box_err <= E2E_F32_RTOL * cb[cv].abs().max().item()
            and (cs[cv] - gs[gv]).abs().max().item() <= 1e-6):
        raise RuntimeError(f"PointPillars small-grid decode + NMS: box error {box_err}")
    print(f"phase 9 small-grid float32 forward and decode + rotated NMS ({int(cv.sum())} "
          f"detections): card agrees with the CPU [{card}]", flush=True)

    # (e) the generic entry point on the config file, phase 7's KITTI layout
    config = os.path.join(REPO, "configs", "adversarial",
                          "adversarial-pointpillars_kitti-3d-3class.py")
    work = os.path.join(work_root, "pointpillars")
    shutil.rmtree(work, ignore_errors=True)
    cli_steps = []
    plain_step = Trainer.train_step

    def counted_step(self, batch, epoch, plan):
        zero_counts()
        t0 = time.perf_counter()
        logs = plain_step(self, batch, epoch, plan)
        torch.cuda.synchronize()
        cli_steps.append({"step_ms": (time.perf_counter() - t0) * 1e3, "launches": read_counts()})
        return logs

    t0 = time.perf_counter()
    Trainer.train_step = counted_step
    try:
        out = generic_cli.main([config, "--validate", "--steps-per-epoch", "2", "--work-dir", work,
                                "--seed", str(seed), "--cfg-options", f"data_root={data_root}",
                                "max_epochs=1", "val_interval=1"])
    finally:
        Trainer.train_step = plain_step
    cli_s = time.perf_counter() - t0
    expect_bf16_kernels("PointPillars generic CLI")
    if len(cli_steps) != 2 or any(st["launches"] != PP_TRAIN_LAUNCHES for st in cli_steps):
        raise RuntimeError(f"generic CLI steps {cli_steps}")
    ap = out["history"].get("val_epoch0", {})
    if CheckpointManager(work).latest_epoch() != 0 or not ap or not all(
            np.isfinite(v) for v in ap.values()) or not os.path.isfile(
            os.path.join(work, "best_metric.json")):
        raise RuntimeError(f"generic CLI: checkpoint {CheckpointManager(work).latest_epoch()}, "
                           f"validation {ap}")
    print(f"phase 9 generic CLI (cli/train.main, the config file, KITTI layout, 2 steps + "
          f"validation on {ap['num_frames']} frames): {cli_s:.1f} s; steps "
          f"{json.dumps([round(st['step_ms'], 1) for st in cli_steps])} ms; plans "
          f"{json.dumps([round(p['plan_ms'], 1) for p in out['plans']])} ms; mAP_3d_moderate "
          f"{ap['mAP_3d_moderate']:.3f}; epoch_0.pt and best_metric.json written [{card}]",
          flush=True)
    print(f"phase 9: {time.time() - t_phase:.1f} s [{card}]", flush=True)

    src = "robustpointclouds_tpu_torch/csrc/masked_stats.cu"
    tpu = "robustpointclouds_tpu/kernels/masked_stats.py"
    keys = ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    rows = []
    for label, names in cases.items():
        suffix, per_step = ("pfn" if label == "pfn" else "pillar_" + label.replace(" ", "_"),
                            len(names))
        for i, (kernel, line) in enumerate((("masked_batch_norm", 63),
                                            ("masked_batch_norm_bwd", 102))):
            r = mean_row([pair[i] for pair in bn_rows[label]])
            rows.append({"name": f"{kernel}_{suffix}", "route": "cuda", "source": src,
                         "replaces": f"{tpu}:{line}", "launches": per_step * len(steps),
                         "shape": [r["n"], r["c"], "bfloat16"], "count_a_step": per_step,
                         "bound_kept_ms": r["bound_kept_ms"], **{k: r[k] for k in keys}})
    for name, line, r in (("masked_stats_pillars", 113, stats_row),
                          ("masked_stats_bwd_pillars", 102, vjp_row)):
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": f"{tpu}:{line}",
                     "launches": PP_TRAIN_LAUNCHES[name.rsplit("_", 1)[0]] * len(steps),
                     "shape": [n_slots, 4, "float32"], **{k: r[k] for k in keys}})
    print("phase 9 summary " + json.dumps(dict(
        training=train_summary, serving=serve_summary, evaluation=eval_summary,
        k2_step=step_bn, generic_cli_s=cli_s)) + f" [{card}]", flush=True)
    return rows


# phase 10: the strong family at full width (models/strong.StrongVoxelNetConfig:
# the SECOND base, adversary (64, 128, 256, 128), dropout 0.1)
ST_BATCHES = (1, 6)  # the recipe's batch (adversarial-second_strong.py) and SECOND's
ST_TRAIN_STEPS = 6  # timed steps at each batch, after one warm-up step
ST_EVAL_BATCHES = 2
ST_BN_ADVERSARY = 8  # enc_bn_0..3, bottleneck_bn, dec_bn_0..2
# kernel launches of a strong train step, derived from the code: the 12
# encoder convs' forward, dgrad (the perturbation delta reaches conv_input's
# features) and wgrad; the masked statistics under the adversary's std
# normalisation (its input needs no gradient) and perturbation_losses (no
# VJP: the strong objective takes none of those terms with a gradient); 20
# train-mode MaskedBatchNorms (the adversary's 8, the encoder's 12), each
# with the fused forward and backward and bwd_reduce (their parameters train)
ST_TRAIN_LAUNCHES = {"sparse_conv": 12, "sparse_conv_dgrad": 12, "sparse_conv_wgrad": 12,
                     "masked_stats": 2, "masked_stats_bwd": 0, "masked_batch_norm": 20,
                     "masked_batch_norm_bwd": 20, "bwd_reduce": 20}
# of those, the K2 kernels that run at C = 256 (KERNEL_LAUNCHES): the fused
# forward (statistics + apply) and backward (bwd_reduce + dx) of enc_bn_2
# and dec_bn_1
ST_C256_LAUNCHES = {"stats_kernel": 2, "apply_kernel": 2, "bwd_reduce_kernel": 2,
                    "dx_kernel": 2}


def _bn_check(torch, name, x, mask, mod, gout, relu=True, row_mask=False, out_dtype=None):
    """One captured train-mode BN (the strong adversary's: ReLU, no row
    mask; or as the call's flags say) against the plain versions,
    bit-identical on a repeat: the max errors."""
    from robustpointclouds_tpu_torch.kernels.masked_stats import (
        _bn_forward, _bn_ref, masked_batch_norm_bwd, masked_batch_norm_bwd_ref)

    w, b = mod.weight.detach(), mod.bias.detach()
    rm, rv = mod.running_mean.clone(), mod.running_var.clone()
    flags = (True, mod.momentum, mod.eps, relu, row_mask, out_dtype or x.dtype)
    y, mean, var, cnt = _bn_forward(x, mask, w, b, rm.clone(), rv.clone(), *flags)
    ref = _bn_ref(x, mask, w, b, rm.clone(), rv.clone(), *flags)[0]
    grads = masked_batch_norm_bwd(gout, x, mask, w, b, mean, var, cnt, mod.eps, True, relu,
                                  row_mask)
    refs = masked_batch_norm_bwd_ref(gout, x, mask, w, b, mean, var, cnt, mod.eps, True, relu,
                                     row_mask)
    errs = [(y.float() - ref.float()).abs().max().item()]
    for got, r, tol in zip((y, *grads), (ref, *refs),
                           (BN_RTOL, BN_RTOL, BN_PARAM_GRAD_RTOL, BN_PARAM_GRAD_RTOL)):
        e = (got.float() - r.float()).abs().max().item()
        if not e <= tol * max(r.float().abs().max().item(), 1e-6):
            raise RuntimeError(f"BN {name} [{x.shape[0]}, {x.shape[1]}]: max error {e}")
        errs.append(e)
    y2 = _bn_forward(x, mask, w, b, rm.clone(), rv.clone(), *flags)[0]
    again = masked_batch_norm_bwd(gout, x, mask, w, b, mean, var, cnt, mod.eps, True, relu,
                                  row_mask)
    if not (torch.equal(y, y2) and all(torch.equal(p, q) for p, q in zip(grads, again))):
        raise RuntimeError(f"BN {name}: a repeat is not bit-identical")
    return max(errs)


def _strong_small_grads(dev, seed, small, read_counts, read_f32_counts, zero_counts):
    """The float32 strong train step of config `small` (dropout 0, the
    anti-adaptation flag fixed) on the card and on the CPU from the same
    weights and plan: the gradients, with every ReLU gate of the CPU's step
    set to the card's (the ReLU-fused MaskedBatchNorms run unfused there and
    take the card's gate; the dense body's BatchNorm2d outputs flip sign
    where the two sides disagree). Each unit whose gate differs must have
    its input within BN_OUT_RTOL of its layer's scale (a rounding-level
    kink, tests/test_torch_kernels_cuda.py's PGD case). Returns (worst error
    over scale, the units aligned by layer, the float32 launches, (CPU loss,
    card loss))."""
    import numpy as np
    import torch

    import robustpointclouds_tpu_torch.nn.perturber as perturber
    from robustpointclouds_tpu_torch.data.synthetic import synthetic_kitti_batch
    from robustpointclouds_tpu_torch.nn.layers import MaskedBatchNorm
    from robustpointclouds_tpu_torch.nn.second import BatchNorm2d
    from robustpointclouds_tpu_torch.train.loop import TrainConfig
    from robustpointclouds_tpu_torch.train.strong_loop import StrongTrainer

    tb = synthetic_kitti_batch(np.random.RandomState(seed + 3), batch_size=2, num_points=600,
                               max_gt=8, num_objects=3,
                               point_range=small.base.voxelizer.point_cloud_range)
    card_out, names, aligned = {}, {}, {}
    cpu_side = [False]
    forward = MaskedBatchNorm.forward

    def check_band(name, pre, card, rows=None):
        """The units whose gates differ; `rows`: the valid rows, to count
        the aligned units on them apart from the padding rows'."""
        band = BN_OUT_RTOL * max(card.abs().max().item(), 1e-12)
        flipped = (pre > 0) != (card > 0)
        if flipped.any() and not (pre[flipped].abs() <= band).all():
            raise RuntimeError(f"strong small grid: {name} gates differ card vs CPU past the "
                               f"rounding band ({pre[flipped].abs().max().item()} > {band})")
        if flipped.any():
            aligned[name] = {"units": int(flipped.sum())}
            if rows is not None:
                aligned[name]["on_valid_rows"] = int(flipped[rows].sum())
        return flipped

    def gated(self, x, mask, relu=False, row_mask=False, out_dtype=None):
        name = names[id(self)]
        if relu and cpu_side[0]:  # the ReLU's input times the card's gate
            y = forward(self, x, mask, relu=False, row_mask=row_mask, out_dtype=out_dtype)
            card = card_out[name]
            pre = y.detach()
            if (pre.clamp(min=0) - card).abs().max().item() > BN_OUT_RTOL * max(
                    card.abs().max().item(), 1e-12):
                raise RuntimeError(f"strong small grid: {name} output card vs CPU past "
                                   f"{BN_OUT_RTOL}")
            check_band(name, pre, card, mask.cpu())
            return y * (card > 0)
        out = forward(self, x, mask, relu=relu, row_mask=row_mask, out_dtype=out_dtype)
        if relu:
            card_out[name] = out.detach().cpu()
        return out

    def bn2d_hook(mod, inp, out):
        name = names[id(mod)]
        if not cpu_side[0]:
            card_out[name] = out.detach().cpu()
            return None
        flipped = check_band(name, out.detach(), card_out[name])
        return out + torch.where(flipped, -2 * out, torch.zeros_like(out)).detach()

    perturber.PERT_BF16 = False
    MaskedBatchNorm.forward = gated
    results, sd, hooks = [], None, []
    try:
        for d in (dev, torch.device("cpu")):
            cpu_side[0] = d.type == "cpu"
            tr = StrongTrainer(small, TrainConfig(), device=d)
            tr.init_state(seed, state_dict=sd, batch_size=2)
            sd = sd or {k: v.cpu() for k, v in tr.model.state_dict().items()}
            for name, mod in tr.model.named_modules():
                names[id(mod)] = name
                if isinstance(mod, BatchNorm2d):
                    hooks.append(mod.register_forward_hook(bn2d_hook))
            splan = tr.make_plan_builder()(tb.points, tb.points_mask, tb.gt_boxes, tb.gt_labels,
                                           tb.gt_mask)
            gt, splan_d = tr._to_device(tb, splan)
            if not cpu_side[0]:
                zero_counts()
            g_d, logs_d, nan_d = tr._grads(gt, 0.0, splan_d)
            if bool(nan_d):
                raise RuntimeError(f"strong small-grid train step on {d} is a NaN step")
            if not cpu_side[0]:
                torch.cuda.synchronize()
                f32 = read_f32_counts()
                if f32 != {k: read_counts()[k] for k in f32} or not all(f32.values()):
                    raise RuntimeError(f"strong float32 small grid: 3xTF32 launches {f32}, all "
                                       f"launches {read_counts()}")
            results.append(({k: v.cpu() for k, v in g_d.items()}, float(logs_d["loss"])))
            for h in hooks:
                h.remove()
            hooks = []
    finally:
        MaskedBatchNorm.forward = forward
        perturber.PERT_BF16 = True
    (gg, lg), (gc, lc) = results
    gmax = max(v.abs().max().item() for v in gc.values())
    worst = 0.0
    for k, ref in gc.items():
        scale = max(ref.abs().max().item(), TRAIN_GRAD_FLOOR * gmax / TRAIN_GRAD_RTOL)
        err = (gg[k] - ref).abs().max().item()
        worst = max(worst, err / scale)
        if not err <= TRAIN_GRAD_RTOL * scale:
            raise RuntimeError(f"strong small-grid float32 gradient {k}: card vs CPU error {err} "
                               f"over scale {scale}")
    if not abs(lc - lg) <= 1e-4 * abs(lc):
        raise RuntimeError(f"strong small-grid float32 loss: card {lg} vs CPU {lc}")
    return worst, aligned, f32, (lc, lg)


def run_strong(dev, card: str, seed: int, zero_counts, read_counts, read_f32_counts,
               expect_bf16_kernels, data_root: str, work_root: str):
    """Phase 10: the strong family at full width (module docstring). Returns
    the kernels JSON rows of K2 at C = 256; prints a summary line."""
    import numpy as np
    import torch

    from robustpointclouds_tpu_torch.cli import train_kitti_adversarial_strong as strong_cli
    from robustpointclouds_tpu_torch.cli.common import (
        prefetch_iterator, run_evaluation, synthetic_loader, tiny_voxelnet_cfg, with_plans)
    from robustpointclouds_tpu_torch.data.synthetic import synthetic_kitti_batch
    from robustpointclouds_tpu_torch.kernels.masked_stats import KERNEL_LAUNCHES
    from robustpointclouds_tpu_torch.models.strong import StrongVoxelNetConfig
    from robustpointclouds_tpu_torch.models.voxelnet import VoxelNetConfig
    from robustpointclouds_tpu_torch.nn.layers import MaskedBatchNorm
    from robustpointclouds_tpu_torch.train.checkpoint import CheckpointManager
    from robustpointclouds_tpu_torch.train.loop import TrainConfig
    from robustpointclouds_tpu_torch.train.strong_loop import StrongTrainer

    t_phase = time.time()
    cfg = StrongVoxelNetConfig(base=VoxelNetConfig(adversary=None))
    pcr = cfg.base.voxelizer.point_cloud_range
    max_voxels = cfg.base.voxelizer.max_voxels
    wide = ("adversary.enc_bn_2", "adversary.dec_bn_1")
    k2, train_summary, eval_summary = {}, {}, {}
    for bsz in ST_BATCHES:
        n_rows = bsz * max_voxels
        trainer = StrongTrainer(cfg, TrainConfig(), device=dev)
        trainer.init_state(seed, batch_size=bsz)
        mods = dict(trainer.model.named_modules())
        adv_bns = [n for n, m in mods.items() if n.startswith("adversary.")
                   and isinstance(m, MaskedBatchNorm)]
        n_bn = sum(isinstance(m, MaskedBatchNorm) for m in mods.values())
        if len(adv_bns) != ST_BN_ADVERSARY or n_bn != ST_TRAIN_LAUNCHES["masked_batch_norm"] or [
                mods[n].num_features for n in wide] != [256, 256]:
            raise RuntimeError(f"strong model: BNs {adv_bns} of {n_bn}")
        builder = trainer.make_plan_builder()
        loader = synthetic_loader(bsz, 1 + ST_TRAIN_STEPS, num_points=20000, seed=seed + bsz,
                                  point_range=pcr)
        train_iter = prefetch_iterator(with_plans(builder, loader(0)))

        # the warm-up step, capturing the adversary's BN inputs, their output
        # cotangents and the adversary's input rows
        bn_in, bn_g, adv_in, hooks = {}, {}, {}, []

        def capture_g(out, name):  # a forward hook that returns nothing keeps the output
            out.register_hook(lambda g: bn_g.__setitem__(name, g.contiguous()))

        for name in adv_bns:
            hooks.append(mods[name].register_forward_pre_hook(
                lambda m, a, name=name: bn_in.__setitem__(name, (a[0].detach(), a[1]))))
            hooks.append(mods[name].register_forward_hook(
                lambda m, a, out, name=name: capture_g(out, name)))
        hooks.append(trainer.model.adversary.register_forward_pre_hook(
            lambda m, a: adv_in.update(x=a[0].detach(), mask=a[1])))
        batch, tplan = next(train_iter)
        warm = trainer.train_step(batch, 0, tplan)
        torch.cuda.synchronize()
        for h in hooks:
            h.remove()
        if len(bn_in) != ST_BN_ADVERSARY or len(bn_g) != ST_BN_ADVERSARY or adv_in[
                "x"].shape != (n_rows, 4):
            raise RuntimeError(f"strong B={bsz} warm-up captured {len(bn_in)} BN inputs, "
                               f"{len(bn_g)} cotangents, adversary rows {tuple(adv_in['x'].shape)}")
        if not float(trainer.state.momentum.abs().max()) > 0:
            raise RuntimeError(f"strong B={bsz}: the momentum carry is zero after a step")
        print(f"phase 10: B={bsz} train warm-up loss {float(warm['loss']):.4f}, "
              f"{int(tplan['voxel_mask'].sum())} voxels of {n_rows} rows; momentum carried "
              f"[{card}]", flush=True)

        # (a) K2 on the warm-up step's own inputs: the 256-wide BNs and the
        # statistics at C = 256 timed, the 64 / 128-wide BNs checked
        t0 = time.time()
        rows = {}
        for name in adv_bns:
            x, mask = bn_in[name]
            if x.dtype != torch.bfloat16 or x.shape[0] != n_rows:
                raise RuntimeError(f"strong {name}: x {tuple(x.shape)} {x.dtype}")
            if name not in wide:
                err = _bn_check(torch, name, x.contiguous(), mask.contiguous(), mods[name],
                                bn_g[name])
                print(f"phase 10 B={bsz} {name} [{n_rows}, {x.shape[1]}] bf16: fused forward and "
                      f"backward agree with the plain versions (max error {err:.3g}), repeats "
                      f"bit-identical [{card}]", flush=True)
                continue
            mod = mods[name]
            with torch.no_grad():
                w, b = mod.weight.detach().clone(), mod.bias.detach().clone()
                rm, rv = mod.running_mean.clone(), mod.running_var.clone()
            fwd, bwd = bn_case(torch, name, 1, x.contiguous(), mask.contiguous(), w, b, rm, rv,
                               bn_g[name], True, True, False, None, momentum=mod.momentum)
            rows.setdefault("masked_batch_norm", []).append(fwd)
            rows.setdefault("masked_batch_norm_bwd", []).append(bwd)
            for r in (fwd, bwd):
                print(f"phase 10 B={bsz} {r['kernel']} {name} [{r['n']}, {r['c']}] bf16: "
                      + json.dumps(r) + f" [{card}]", flush=True)
        x, mask = bn_in[wide[0]]
        rows["masked_stats"] = [stats_case(torch, x.contiguous(), mask.contiguous())]
        print(f"phase 10 B={bsz} masked_stats {wide[0]} input [{n_rows}, 256] bf16: "
              + json.dumps(rows["masked_stats"][0]) + f" [{card}]", flush=True)
        ax, am = adv_in["x"].contiguous(), adv_in["mask"].contiguous()
        adv_stats = stats_case(torch, ax, am)
        print(f"phase 10 B={bsz} masked_stats adversary input [{n_rows}, 4] float32: "
              + json.dumps(adv_stats) + f" [{card}]", flush=True)
        k2[bsz] = {k: mean_row(v) for k, v in rows.items()}
        del bn_in, bn_g, adv_in, ax, am, x, mask
        print(f"phase 10 B={bsz} (a) K2 checks and timing: {time.time() - t0:.1f} s [{card}]",
              flush=True)

        # (b) timed steps, every step's launches checked; the dynamic scale
        # updated from each step's logs, as the CLI does at its log steps
        params = dict(trainer.model.named_parameters())
        watch = ("middle_encoder.conv_input.0.weight", "backbone.blocks.0.0.weight",
                 "adversary.enc_2.weight", "adversary.out.weight")
        before = {k: params[k].detach().clone() for k in watch}
        trainer.update_dynamic_scaling(trainer.state, 1)
        scale0 = float(trainer.state.scale_factor)
        if scale0 == 1.0:
            raise RuntimeError("strong: update_dynamic_scaling left the scale at 1")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        steps, c256 = [], dict.fromkeys(ST_C256_LAUNCHES, 0)
        with PlainVersionCalls() as plain:
            for _ in range(ST_TRAIN_STEPS):
                t0 = time.perf_counter()
                batch, tplan = next(train_iter)
                t1 = time.perf_counter()
                zero_counts()
                # the scale the step must apply: the dynamic one x the curriculum
                scale = min(float(trainer.state.scale_factor)
                            * min(1.0 + trainer.state.step / 1e4, 2.0), cfg.max_scaling)
                logs = trainer.train_step(batch, 1, tplan)
                logs = {k: float(v) for k, v in logs.items()}  # waits for the step
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                got = read_counts()
                wide_got = {k: n for (k, c), n in KERNEL_LAUNCHES.items() if c == 256}
                if got != ST_TRAIN_LAUNCHES or wide_got != ST_C256_LAUNCHES:
                    raise RuntimeError(f"strong B={bsz} train step launches {got}, at C = 256 "
                                       f"{wide_got}; expected {ST_TRAIN_LAUNCHES}, "
                                       f"{ST_C256_LAUNCHES}")
                for k, n in wide_got.items():
                    c256[k] += n
                if not all(np.isfinite(v) for v in logs.values()) or not (
                        logs["perturbation_l2_norm"] > 0):
                    raise RuntimeError(f"strong B={bsz} train step logs {logs}")
                if abs(logs["attack_scale"] - scale) > 1e-5 * scale:
                    raise RuntimeError(f"strong: attack_scale {logs['attack_scale']} from the "
                                       f"dynamic scale {scale}")
                trainer.update_dynamic_scaling(trainer.state, 1, logs)
                steps.append(dict(wait_ms=(t1 - t0) * 1e3, step_ms=(t2 - t1) * 1e3,
                                  loss=logs["loss"], anti=logs["anti_adaptation"],
                                  scale=logs["attack_scale"], l2=logs["perturbation_l2_norm"]))
        peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        for _ in train_iter:  # drain the prefetch thread
            pass
        expect_bf16_kernels(f"strong B={bsz} training")
        if plain.calls:
            raise RuntimeError(f"strong training reached a plain version {plain.calls} times")
        if int(trainer.state.nan_count) != 0:
            raise RuntimeError(f"strong B={bsz}: NaN steps")
        for k in watch:
            if torch.equal(before[k], params[k].detach()):
                raise RuntimeError(f"strong B={bsz}: {k} did not move")
        for st in steps:
            print(f"phase 10 B={bsz} train step " + json.dumps(st) + f" [{card}]", flush=True)
        builds = list(builder.timings)
        for key in ("native_ms", "assign_ms", "plan_ms"):
            print(f"phase 10 B={bsz} plan build {key} ({len(builds)} builds): "
                  f"{json.dumps([round(b[key], 3) for b in builds])} [{card}]", flush=True)
        steady = steps[PREFETCHED_STEPS:]
        train_summary[bsz] = dict(
            median_step_ms=statistics.median(st["step_ms"] for st in steps),
            steady_frames_per_s=bsz * len(steady) / sum(
                (st["wait_ms"] + st["step_ms"]) / 1e3 for st in steady),
            plan_ms=statistics.mean(b["plan_ms"] for b in builds),
            native_ms=statistics.mean(b["native_ms"] for b in builds),
            assign_ms=statistics.mean(b["assign_ms"] for b in builds), peak_gib=peak_gib)
        print(f"phase 10 training B={bsz} full width: median step_ms "
              f"{train_summary[bsz]['median_step_ms']:.1f} (host clock, step to synchronise), "
              f"steady {train_summary[bsz]['steady_frames_per_s']:.3f} frames/s over the last "
              f"{len(steady)} steps; plan build {train_summary[bsz]['plan_ms']:.1f} ms (native "
              f"{train_summary[bsz]['native_ms']:.1f} + assignment "
              f"{train_summary[bsz]['assign_ms']:.1f}); max_memory_allocated {peak_gib:.2f} GiB; "
              f"per step " + json.dumps(ST_TRAIN_LAUNCHES) + f", K2 at C = 256 over the "
              f"{len(steps)} steps " + json.dumps(c256) + f" [{card}]", flush=True)
        k2[bsz]["launches"] = c256

        # (c) evaluation from the B=6 state, clean and under the learned attack
        if bsz == 6:
            rng = np.random.RandomState(seed + 10)
            eval_batches = [synthetic_kitti_batch(rng, batch_size=6, num_points=20000, max_gt=20,
                                                  num_objects=8, point_range=pcr)
                            for _ in range(ST_EVAL_BATCHES)]
            clean = dict.fromkeys(ST_TRAIN_LAUNCHES, 0)
            clean.update(sparse_conv=12, masked_batch_norm=12)
            for name, kw, want in (("clean", {}, clean),
                                   ("learned", dict(attack=True),
                                    dict(clean, masked_stats=2,
                                         masked_batch_norm=12 + ST_BN_ADVERSARY))):
                torch.cuda.synchronize()
                zero_counts()
                timings = {}
                with PlainVersionCalls() as plain:
                    res = run_evaluation(trainer, eval_batches, timings=timings, **kw)
                    torch.cuda.synchronize()
                got = read_counts()
                want = {k: v * ST_EVAL_BATCHES for k, v in want.items()}
                if got != want or plain.calls:
                    raise RuntimeError(f"strong eval {name}: launches {got}, expected {want}; "
                                       f"{plain.calls} plain-version calls")
                if res["num_frames"] != 6 * ST_EVAL_BATCHES or not np.isfinite(
                        res["mAP_3d_moderate"]):
                    raise RuntimeError(f"strong eval {name}: {res}")
                eval_summary[name] = {k: statistics.mean(bt[k] for bt in timings["batches"])
                                      for k in ("plan_ms", "device_ms", "metric_ms")}
                print(f"phase 10 eval {name} (B=6, {ST_EVAL_BATCHES} batches): mean per batch "
                      + ", ".join(f"{k} {v:.3f}" for k, v in eval_summary[name].items())
                      + f"; launches {json.dumps(got)} [{card}]", flush=True)
            expect_bf16_kernels("strong evaluation")
        del trainer, builder, train_iter, params, before

    # (d) the strong CLI on phase 7's KITTI layout, B=1, validating every 2 epochs
    work = os.path.join(work_root, "strong")
    shutil.rmtree(work, ignore_errors=True)
    cli_steps = []
    plain_step = StrongTrainer.train_step

    def counted_step(self, batch, epoch=0, plan=None):
        zero_counts()
        t0 = time.perf_counter()
        logs = plain_step(self, batch, epoch, plan)
        torch.cuda.synchronize()
        cli_steps.append({"step_ms": (time.perf_counter() - t0) * 1e3, "launches": read_counts()})
        return logs

    t0 = time.perf_counter()
    StrongTrainer.train_step = counted_step
    try:
        out = strong_cli.main(["--data-root", data_root, "--validate", "--epochs", "2",
                               "--steps-per-epoch", "2", "--work-dir", work, "--seed", str(seed)])
    finally:
        StrongTrainer.train_step = plain_step
    cli_s = time.perf_counter() - t0
    expect_bf16_kernels("strong CLI")
    if len(cli_steps) != 4 or any(st["launches"] != ST_TRAIN_LAUNCHES for st in cli_steps):
        raise RuntimeError(f"strong CLI steps {cli_steps}")
    ap = out["history"].get("val_epoch1", {})
    if CheckpointManager(work).latest_epoch() != 1 or not ap or not all(
            np.isfinite(v) for v in ap.values()) or not os.path.isfile(
            os.path.join(work, "val_history.json")) or not os.path.isfile(
            os.path.join(work, "adversarial_progress.json")):
        raise RuntimeError(f"strong CLI: checkpoint {CheckpointManager(work).latest_epoch()}, "
                           f"validation {ap}")
    print(f"phase 10 strong CLI (KITTI layout, B=1, 2 epochs x 2 steps + validation on "
          f"{ap['num_frames']} frames): {cli_s:.1f} s; steps "
          f"{json.dumps([round(st['step_ms'], 1) for st in cli_steps])} ms; plans "
          f"{json.dumps([round(p['plan_ms'], 1) for p in out['plans']])} ms; mAP_3d_moderate "
          f"{ap['mAP_3d_moderate']:.3f}; epoch_1.pt, val_history.json written; dashboard: "
          f"{out['monitor'].verdict()} [{card}]", flush=True)

    # (e) a small-grid float32 strong train step at the adversary's full
    # widths (its 256-wide BNs in float32), card vs CPU
    small = cfg._replace(
        base=tiny_voxelnet_cfg()._replace(adversary=None, compute_dtype="float32"),
        perturber={**cfg.perturber, "dropout_rate": 0.0}, anti_adaptation_prob=0.0)
    worst, aligned, f32_launches, (lc, lg) = _strong_small_grads(
        dev, seed, small, read_counts, read_f32_counts, zero_counts)
    print(f"phase 10 small-grid float32 strong train step (adversary "
          f"{cfg.perturber['hidden_channels']}): gradients agree card vs CPU (worst "
          f"{worst:.2e} of scale) with the CPU's ReLU gates set to the card's where the two "
          f"round an input within {BN_OUT_RTOL} of its scale to opposite signs "
          f"({json.dumps(aligned)}), loss {lg:.6f} vs {lc:.6f}; 3xTF32 launches "
          f"{json.dumps(f32_launches)} [{card}]", flush=True)
    print(f"phase 10: {time.time() - t_phase:.1f} s [{card}]", flush=True)

    src = "robustpointclouds_tpu_torch/csrc/masked_stats.cu"
    tpu = "robustpointclouds_tpu/kernels/masked_stats.py"
    keys = ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    out_rows = []
    for bsz, per in k2.items():
        # launches: the C = 256 launches that (b)'s timed steps counted of the
        # row's kernel (the fused forward's apply_kernel, the backward's
        # dx_kernel); the statistics row is the stats_kernel that the fused
        # forward launches, timed here alone through masked_stats
        for name, kernel, line, counted in (
                ("masked_batch_norm", "masked_batch_norm", 63, "apply_kernel"),
                ("masked_batch_norm_bwd", "masked_batch_norm_bwd", 102, "dx_kernel"),
                ("stats_kernel_in_masked_batch_norm", "masked_stats", 113, "stats_kernel")):
            r = per[kernel]
            out_rows.append({"name": f"{name}_strong_c256_b{bsz}", "route": "cuda",
                             "source": src, "replaces": f"{tpu}:{line}",
                             "launches": per["launches"][counted], "counted": counted,
                             "shape": [r["n"], r["c"], "bfloat16"],
                             **{k: r[k] for k in keys}})
    print("phase 10 summary " + json.dumps(dict(
        training=train_summary, evaluation=eval_summary, strong_cli_s=cli_s,
        small_grid_worst=worst)) + f" [{card}]", flush=True)
    return out_rows


# phase 11: the inline (plan=None) path -- the plan built on the card in
# torch ops (models/voxelnet.build_plan, pointpillars.build_pillar_plan,
# centerpoint.build_centerpoint_plan), held bit-equal to the native host
# plan of the same frames
IN_BATCH, IN_POINTS = 6, 20000  # SECOND / PointPillars / strong; CenterPoint: CP_BATCH, CP_POINTS
IN_TIMED = 5  # builds timed per builder, card and host in turns (median)
IN_TRAIN_STEPS = 5  # timed inline train steps after the equality step
# one rounding-level difference of an anchor's IoU (card vs host) may flip
# a tied assignment; a flip is accepted only where the two IoU rows differ
# by no more than this
ASSIGN_IOU_ATOL = 1e-6
CP_TARGET_ATOL = 1e-6  # the targets' heatmaps / rows: exp, log, sin, cos of two libraries


class HostPlanCalls:
    """Counts the calls of the host plan builders (the native plans and the
    host anchor assignment; CenterPoint's host targets come only with its
    native plan) through the names the trainers' plan builders call them
    by; a path whose points are on the card must make none."""

    SITES = (("robustpointclouds_tpu_torch.data.native_plan",
              ("build_plan_native", "build_pillar_plan_native")),
             ("robustpointclouds_tpu_torch.train.loop",
              ("build_plan_native", "build_pillar_plan_native", "anchor_assign_plan")),
             ("robustpointclouds_tpu_torch.train.centerpoint_loop", ("build_plan_native",)))

    def __enter__(self):
        import importlib

        self.calls, self.saved = 0, []

        def counted(fn):
            def call(*a, **kw):
                self.calls += 1
                return fn(*a, **kw)
            return call
        for mod_name, names in self.SITES:
            mod = importlib.import_module(mod_name)
            for n in names:
                self.saved.append((mod, n, getattr(mod, n)))
                setattr(mod, n, counted(getattr(mod, n)))
        return self

    def __exit__(self, *exc):
        for mod, n, fn in self.saved:
            setattr(mod, n, fn)


def plan_diff(dev_plan, host_plan, path=""):
    """Where the card's plan differs from the host's: [(path, what)] over
    every array (keys, dtypes, shapes and values)."""
    import numpy as np
    import torch

    if isinstance(host_plan, dict):
        if sorted(host_plan) != sorted(dev_plan):
            return [(path, f"keys {sorted(dev_plan)} vs {sorted(host_plan)}")]
        return [d for k in host_plan for d in plan_diff(dev_plan[k], host_plan[k], f"{path}/{k}")]
    if isinstance(host_plan, (list, tuple)):
        return [d for i, (a, b) in enumerate(zip(dev_plan, host_plan))
                for d in plan_diff(a, b, f"{path}/{i}")]
    h = torch.from_numpy(np.ascontiguousarray(host_plan))
    d = dev_plan.detach().cpu()
    if d.dtype != h.dtype or d.shape != h.shape:
        return [(path, f"{d.dtype} {tuple(d.shape)} vs {h.dtype} {tuple(h.shape)}")]
    if not torch.equal(d, h):
        return [(path, f"{int((d != h).sum())} entries differ")]
    return []


def outputs_equal(a, b) -> bool:
    """Bit-equality of two nested outputs (tensors, tuples, dicts)."""
    import torch

    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(outputs_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(outputs_equal(x, y) for x, y in zip(a, b))
    return a == b


def _timed(fn, card: bool):
    """(result, host-clock ms, CUDA-event ms or None) of one call, to a synchronise."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    return out, host_ms, (start.elapsed_time(end) if card else None)


def profile_launches(fn):
    """(device operations launched, their device ms) of one call under
    torch.profiler: kernels, copies and memsets on the card."""
    import torch

    from robustpointclouds_tpu_torch.core.spans import device_entries

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = device_entries(prof.key_averages())
    n = sum(e.count for e in ev)
    return (n, sum(e.self_device_time_total for e in ev) / 1e3) if n else (None, None)


def expect_plan_replays(tag: str, before: dict, calls: int) -> None:
    """Raises where the card's inline plan ran eager since `before` (a copy
    of models/voxelnet.PLAN_GRAPH_CALLS), or replayed its CUDA graph fewer
    than `calls` times: every timed inline step or request on the card
    replays one graph."""
    from robustpointclouds_tpu_torch.models.voxelnet import PLAN_GRAPH_CALLS

    eager = PLAN_GRAPH_CALLS["eager"] - before.get("eager", 0)
    replays = PLAN_GRAPH_CALLS["replay"] - before.get("replay", 0)
    if eager or replays < calls:
        raise RuntimeError(f"phase 11 {tag}: the plan ran eager {eager} times and replayed "
                           f"{replays} times in {calls} timed calls on the card")


def profile_host(fn):
    """One call under torch.profiler: (device operations, their device ms,
    {host event: [count, self host ms]}); host events are the operators
    (aten::, rpc::) and the CUDA runtime calls (cudaLaunchKernel, ...)."""
    import torch

    from robustpointclouds_tpu_torch.core.spans import device_entries

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev_ev, host = device_entries(prof.key_averages()), {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            host[e.key] = [e.count, e.self_cpu_time_total / 1e3]
    n = sum(e.count for e in dev_ev)
    return n, sum(e.self_device_time_total for e in dev_ev) / 1e3, host


def host_difference(eager, artifact, top: int):
    """The host events of two profiled calls: totals (all, the aten
    operators, the CUDA runtime), the runtime's calls, and the `top` events
    whose self host ms differ most."""
    keys = set(eager) | set(artifact)

    def get(d, k):
        return d.get(k, [0, 0.0])

    def total(d, pick):
        return [sum(v[0] for k, v in d.items() if pick(k)),
                sum(v[1] for k, v in d.items() if pick(k))]

    diff = sorted(keys, key=lambda k: -abs(get(artifact, k)[1] - get(eager, k)[1]))[:top]
    runtime = sorted(k for k in keys if k.startswith("cuda"))
    groups = {"all": lambda k: True, "aten": lambda k: k.startswith("aten::"),
              "runtime": lambda k: k.startswith("cuda")}
    return {
        "events": {g: {"eager": total(eager, pick), "artifact": total(artifact, pick)}
                   for g, pick in groups.items()},
        "runtime": {k: {"eager": get(eager, k), "artifact": get(artifact, k)} for k in runtime},
        "largest_differences": {k: {"eager": get(eager, k), "artifact": get(artifact, k)}
                                for k in diff},
    }


def assign_flips(card_res, host_res, anchors, gt_boxes, gt_labels, gt_mask):
    """The anchors whose assignment differs card vs host, each with the
    largest difference of its IoU row (card vs host IoU of the same boxes).
    A flip is a tie broken by rounding only when that difference is within
    ASSIGN_IOU_ATOL."""
    import torch

    from robustpointclouds_tpu_torch.ops import boxes as box_ops

    host = {k: torch.from_numpy(v) for k, v in host_res.items()}
    card = {k: v.cpu() for k, v in card_res.items()}
    diff = ((card["labels"] != host["labels"]) | (card["pos_mask"] != host["pos_mask"])
            | (card["neg_mask"] != host["neg_mask"])
            | (card["pos_mask"] & (card["matched_gt"] != host["matched_gt"])))
    flips = []
    for b, a in diff.nonzero().tolist():
        box = anchors[a:a + 1]
        gts = torch.as_tensor(gt_boxes[b], dtype=torch.float32)
        iou_cpu = box_ops.nearest_bev_iou(box.cpu()[None], gts[None])[0, 0]
        iou_card = box_ops.nearest_bev_iou(box[None], gts.to(box.device)[None])[0, 0].cpu()
        flips.append(dict(batch=b, anchor=a, card=[int(card["labels"][b, a]),
                                                   int(card["matched_gt"][b, a])],
                          host=[int(host["labels"][b, a]), int(host["matched_gt"][b, a])],
                          iou_row_max_diff=float((iou_card - iou_cpu).abs().max()),
                          iou_top2=sorted(iou_cpu.tolist())[-2:]))
    return flips


def run_inline(dev, card: str, seed: int, zero_counts, read_counts, expect_bf16_kernels,
               kitti_root: str):
    """Phase 11: the inline (plan=None) path (module docstring). Prints a
    summary line; returns nothing (no kernel is new on this path)."""
    import numpy as np
    import torch

    from robustpointclouds_tpu_torch.cli.export import export_serving
    from robustpointclouds_tpu_torch.data.native_plan import (build_pillar_plan_native,
                                                              build_plan_native)
    from robustpointclouds_tpu_torch.data.nuscenes import synthetic_nuscenes_batch
    from robustpointclouds_tpu_torch.data.synthetic import PointCloudBatch, synthetic_kitti_batch
    from robustpointclouds_tpu_torch.models import centerpoint as mcp
    from robustpointclouds_tpu_torch.models import pointpillars as mpp
    from robustpointclouds_tpu_torch.models import voxelnet as mvn
    from robustpointclouds_tpu_torch.models.center_detection import centerpoint_targets
    from robustpointclouds_tpu_torch.models.strong import StrongVoxelNetConfig
    from robustpointclouds_tpu_torch.ops import assigner
    from robustpointclouds_tpu_torch.train.loop import HostPlanBuilder, TrainConfig, Trainer
    from robustpointclouds_tpu_torch.train.strong_loop import StrongTrainer

    t_phase = time.time()
    rng = np.random.RandomState(seed + 11)
    second = mvn.VoxelNetConfig()
    pillars = mpp.PointPillarsConfig()
    cpcfg = mcp.CenterPointConfig()

    def kitti_frames(cfg):
        b = synthetic_kitti_batch(rng, batch_size=IN_BATCH, num_points=IN_POINTS, max_gt=20,
                                  num_objects=8, point_range=cfg.voxelizer.point_cloud_range)
        return PointCloudBatch(*(np.asarray(x) for x in b))

    def on_card(*arrays):
        return [torch.as_tensor(x, device=dev) for x in arrays]

    def assign_fns(cfg, b):
        a, c = cfg.make_anchors()
        cpu_anchors = (torch.from_numpy(a), torch.from_numpy(c))
        card_anchors = (cpu_anchors[0].to(dev), cpu_anchors[1].to(dev))
        gt = on_card(b.gt_boxes.astype(np.float32), b.gt_labels.astype(np.int32),
                     b.gt_mask.astype(bool))
        head = cfg.head

        def card_fn():
            return assigner.assign(*card_anchors, *gt, head.pos_iou_thr, head.neg_iou_thr,
                                   head.min_pos_iou)

        def host_fn():
            return mvn.anchor_assign_plan(b.gt_boxes, b.gt_labels, b.gt_mask, cfg,
                                          anchors=cpu_anchors)
        return card_fn, host_fn, card_anchors[0]

    # (a) each family's plan on the card vs the native host plan of the same frames
    sb, pb = kitti_frames(second), kitti_frames(pillars)
    cb, cvel = synthetic_nuscenes_batch(rng, batch_size=CP_BATCH, num_points=CP_POINTS,
                                        max_gt=cpcfg.head.max_objs,
                                        point_range=cpcfg.voxelizer.point_cloud_range)
    cb = PointCloudBatch(*(np.asarray(x) for x in cb))
    # one B=6 batch of phase 7's KITTI-layout frames, as the velodyne files hold them
    velo = os.path.join(kitti_root, "training", "velodyne")
    raw = [np.fromfile(os.path.join(velo, f), np.float32).reshape(-1, 4)
           for f in sorted(os.listdir(velo))[:IN_BATCH]]
    kp = np.zeros((IN_BATCH, max(len(r) for r in raw), 4), np.float32)
    km = np.zeros(kp.shape[:2], bool)
    for i, r in enumerate(raw):
        kp[i, :len(r)], km[i, :len(r)] = r, True

    def second_build(p, m):
        return mvn.build_plan(p, m, second)

    def second_native(p, m):
        return build_plan_native(p, m, second.voxelizer, 4)

    # name: (the card's builder, the native host builder, points, mask)
    families = {
        "second": (second_build, second_native, sb.points, sb.points_mask),
        "centerpoint": (lambda p, m: mcp.build_centerpoint_plan(p, m, cpcfg),
                        lambda p, m: build_plan_native(p, m, cpcfg.voxelizer, 5), cb.points,
                        cb.points_mask),
        "pointpillars": (lambda p, m: mpp.build_pillar_plan(p, m, pillars),
                         lambda p, m: build_pillar_plan_native(p, m, pillars.voxelizer, 4),
                         pb.points, pb.points_mask),
        "kitti_layout": (second_build, second_native, kp, km),
    }
    flips_all, summary = {}, {}
    for name, (build, build_host, pts, msk) in families.items():
        pts_t, msk_t = on_card(pts, msk)
        fns = {"card_plan": (lambda: build(pts_t, msk_t), True),
               "host_plan": (lambda: build_host(pts, msk), False)}
        if name in ("second", "pointpillars"):
            cfg, b = (second, sb) if name == "second" else (pillars, pb)
            card_assign, host_assign, card_anchor_t = assign_fns(cfg, b)
            fns["card_assign"] = (card_assign, True)
            fns["host_assign"] = (host_assign, False)
        if name == "centerpoint":
            gt = on_card(cb.gt_boxes, cb.gt_labels, cb.gt_mask, cvel)
            fns["card_targets"] = (lambda: centerpoint_targets(
                *gt, cpcfg.bev_feature_size, cpcfg.head), True)
            fns["host_targets"] = (lambda: centerpoint_targets(
                cb.gt_boxes, cb.gt_labels, cb.gt_mask, cvel, cpcfg.bev_feature_size,
                cpcfg.head), False)
        for fn, _ in fns.values():  # warm-up (the card's first calls, the native library)
            fn()
        times = {k: [] for k in fns}
        outs = {}
        with HostPlanCalls() as hp:
            for _ in range(IN_TIMED):
                for k, (fn, is_card) in fns.items():
                    if is_card:
                        outs[k], host_ms, ev_ms = _timed(fn, True)
                        times[k].append((host_ms, ev_ms))
                    else:
                        hp_before = hp.calls
                        outs[k], host_ms, _ = _timed(fn, False)
                        hp.calls = hp_before  # the host builds are the yardstick
                        times[k].append((host_ms, None))
            card_host_calls = hp.calls
        if card_host_calls:
            raise RuntimeError(f"phase 11 {name}: the card build called a host builder "
                               f"{card_host_calls} times")
        n_launch, launch_dev_ms = profile_launches(fns["card_plan"][0])
        # the host plan as the model reads it: plan_to_device decodes its x-window levels
        bad = plan_diff(outs["card_plan"], mvn.plan_to_device(outs["host_plan"],
                                                              torch.device("cpu")))
        if bad:
            raise RuntimeError(f"phase 11 {name}: the card's plan differs from the native "
                               f"host plan: {bad[:8]}")
        row = {"frames": int(pts.shape[0]), "points": int(pts.shape[1]),
               "voxels": int(outs["host_plan"]["voxel_mask"].sum()), "launches": n_launch,
               "launches_device_ms": launch_dev_ms}
        for k, vals in times.items():
            row[f"{k}_host_ms"] = statistics.median(v[0] for v in vals)
            if fns[k][1]:
                row[f"{k}_event_ms"] = statistics.median(v[1] for v in vals)
            row[f"{k}_host_ms_all"] = [round(v[0], 3) for v in vals]
        if "card_assign" in outs:
            cres = outs["card_assign"]
            card_a = {"labels": cres.labels, "matched_gt": cres.matched_gt,
                      "pos_mask": cres.pos_mask, "neg_mask": cres.neg_mask}
            flips = assign_flips(card_a, outs["host_assign"], card_anchor_t, b.gt_boxes,
                                 b.gt_labels, b.gt_mask)
            if any(f["iou_row_max_diff"] > ASSIGN_IOU_ATOL for f in flips):
                raise RuntimeError(f"phase 11 {name}: the card's assignment differs beyond a "
                                   f"rounding tie: {flips[:8]}")
            flips_all[name] = flips
            row["num_pos"] = int(card_a["pos_mask"].sum())
            row["assign_flips"] = len(flips)
        if "card_targets" in outs:
            worst = 0.0
            for ct, ht in zip(outs["card_targets"], outs["host_targets"]):
                for k in ("pos", "mask"):
                    if not torch.equal(ct[k].cpu(), ht[k]):
                        raise RuntimeError(f"phase 11 centerpoint: card targets' {k} differ")
                for k in ("heatmap", "anno"):
                    worst = max(worst, float((ct[k].cpu() - ht[k]).abs().max()))
            if worst > CP_TARGET_ATOL:
                raise RuntimeError(f"phase 11 centerpoint: card targets off by {worst}")
            row["targets_max_abs_diff"] = worst
        summary[name] = row
        print(f"phase 11 (a) plan {name}: bit-equal to the native host plan; "
              + json.dumps(row) + f"; PLAN_GRAPH_CALLS {json.dumps(dict(mvn.PLAN_GRAPH_CALLS))}"
              f" [{card}]", flush=True)
        del outs
    for name, flips in flips_all.items():
        print(f"phase 11 (a) assignment {name}: {len(flips)} anchors differ card vs host"
              + (": " + json.dumps(flips[:8]) if flips else "") + f" [{card}]", flush=True)

    # (b) SECOND served self-contained: serve(points, mask), no plan
    model = mvn.AdversarialVoxelNet(second)
    mvn.init_weights(model, torch.Generator().manual_seed(seed))
    serve = export_serving(model, None, second.make_anchors()[0], second.head)
    requests = [(kitti_frames(second), attack) for attack in (False, True) for _ in range(3)]
    for b, attack in requests[:1] + requests[3:4]:  # warm-up
        serve(b.points, b.points_mask, attack=attack)
    serving = []
    graph_calls = dict(mvn.PLAN_GRAPH_CALLS)
    with HostPlanCalls() as hp, PlainVersionCalls(k1=True) as plain:
        for b, attack in requests:
            zero_counts()
            out_in, in_ms, _ = _timed(lambda: serve(b.points, b.points_mask, attack=attack),
                                      False)
            n_in = read_counts()
            calls = (hp.calls, plain.calls)
            t0 = time.perf_counter()
            rplan = build_plan_native(b.points, b.points_mask, second.voxelizer, 4)
            plan_ms = (time.perf_counter() - t0) * 1e3
            zero_counts()
            out_fed, fed_ms, _ = _timed(lambda: serve(b.points, b.points_mask, rplan,
                                                      attack=attack), False)
            n_fed = read_counts()
            hp.calls = calls[0]  # the host plan above is the plan-fed side's
            if calls != (0, 0):
                raise RuntimeError(f"phase 11 serving: the inline request called {calls[0]} "
                                   f"host builders and {calls[1]} plain versions")
            if not outputs_equal(tuple(out_in), tuple(out_fed)):
                raise RuntimeError("phase 11 serving: inline outputs differ from the plan-fed "
                                   "ones")
            if n_in != n_fed or n_in["sparse_conv"] != 12 or n_in["masked_batch_norm"] != (
                    BN_ATTACK if attack else BN_CLEAN):
                raise RuntimeError(f"phase 11 serving launches: inline {n_in}, plan-fed {n_fed}")
            serving.append(dict(attack=attack, inline_serve_ms=in_ms, fed_serve_ms=fed_ms,
                                host_plan_ms=plan_ms, valid=int(out_in[3].sum())))
    expect_bf16_kernels("inline serving")
    expect_plan_replays("serving", graph_calls, len(requests))
    for r in serving:
        print("phase 11 (b) request " + json.dumps(r) + f" [{card}]", flush=True)
    del model, serve

    # (c) the inline SECOND train step, B=6, epoch 3
    trainers = [Trainer(second, TrainConfig(), device=dev) for _ in range(2)]
    for tr in trainers:
        tr.init_state(seed)
    fed_plan = HostPlanBuilder(second)(sb.points, sb.points_mask, sb.gt_boxes, sb.gt_labels,
                                       sb.gt_mask)
    logs_fed = {k: float(v) for k, v in trainers[0].train_step(sb, 3, fed_plan).items()}
    zero_counts()
    logs_in = {k: float(v) for k, v in trainers[1].train_step(sb, 3, None).items()}
    if read_counts() != TRAIN_LAUNCHES:
        raise RuntimeError(f"phase 11 inline step launches {read_counts()}")
    if logs_in != logs_fed and not flips_all.get("second"):
        raise RuntimeError(f"phase 11: the inline step's losses {logs_in} differ from the "
                           f"plan-fed step's {logs_fed} with no assignment flip")
    print(f"phase 11 (c) inline vs plan-fed step on the same state and frames: losses "
          f"{'equal' if logs_in == logs_fed else 'differ (assignment flip)'}: "
          + json.dumps({k: [logs_in[k], logs_fed[k]] for k in ("loss", "loss_cls", "loss_bbox",
                                                              "num_pos")}) + f" [{card}]",
          flush=True)
    trainer = trainers[1]
    del trainers, fed_plan
    names = ("middle_encoder.conv_input.0.weight", "adversary.mlp_out.weight")
    params = dict(trainer.model.named_parameters())
    before = {k: params[k].detach().clone() for k in names}
    batches = [kitti_frames(second) for _ in range(IN_TRAIN_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    graph_calls = dict(mvn.PLAN_GRAPH_CALLS)
    with HostPlanCalls() as hp, PlainVersionCalls(k1=True) as plain:
        t_all = time.perf_counter()
        for b in batches:
            zero_counts()
            logs, step_ms, _ = _timed(lambda: {k: float(v) for k, v in trainer.train_step(
                b, 3, None).items()}, False)
            n = read_counts()
            if n != TRAIN_LAUNCHES:
                raise RuntimeError(f"phase 11 inline step launches {n}")
            if not all(np.isfinite(v) for v in logs.values()) or logs["num_pos"] <= 0:
                raise RuntimeError(f"phase 11 inline step logs {logs}")
            steps.append(dict(step_ms=step_ms, loss=logs["loss"], num_pos=logs["num_pos"]))
        train_s = time.perf_counter() - t_all
    if hp.calls or plain.calls:
        raise RuntimeError(f"phase 11 inline training called {hp.calls} host builders and "
                           f"{plain.calls} plain versions")
    expect_bf16_kernels("inline training")
    expect_plan_replays("training", graph_calls, len(batches))
    for k in names:
        if torch.equal(before[k], params[k].detach()):
            raise RuntimeError(f"phase 11: {k} did not move in inline training")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    med = statistics.median(s["step_ms"] for s in steps)
    print(f"phase 11 (c) inline train steps B={IN_BATCH} epoch 3: " + json.dumps(steps)
          + f"; median step_ms {med:.3f}, {IN_BATCH * len(steps) / train_s:.3f} frames/s, peak "
          f"{peak:.2f} GiB; per step: " + ", ".join(f"{k} {v}" for k, v in TRAIN_LAUNCHES.items())
          + f" [{card}]", flush=True)
    summary["train"] = dict(median_step_ms=med, frames_per_s=IN_BATCH * len(steps) / train_s,
                            peak_gib=peak)
    del trainer, params, before
    torch.cuda.empty_cache()

    # (d) CenterPoint, PointPillars and the strong forward_eval inline, clean and attack
    def serve_pair(tag, model, anchors, head, b, host_build):
        mvn.init_weights(model, torch.Generator().manual_seed(seed))
        srv = export_serving(model, None, anchors, head)
        for attack in (False, True):
            srv(b.points, b.points_mask, attack=attack)  # warm-up
            zero_counts()
            graph_calls = dict(mvn.PLAN_GRAPH_CALLS)
            with HostPlanCalls() as hp, PlainVersionCalls(k1=True) as plain:
                out_in = srv(b.points, b.points_mask, attack=attack)
                torch.cuda.synchronize()
            n_in = read_counts()
            expect_plan_replays(f"{tag} attack={attack}", graph_calls, 1)
            if hp.calls or plain.calls:
                raise RuntimeError(f"phase 11 {tag}: {hp.calls} host builds, {plain.calls} "
                                   f"plain versions")
            zero_counts()
            out_fed = srv(b.points, b.points_mask, host_build(b), attack=attack)
            if n_in != read_counts() or not outputs_equal(tuple(out_in), tuple(out_fed)):
                raise RuntimeError(f"phase 11 {tag} attack={attack}: inline {n_in} vs plan-fed "
                                   f"{read_counts()}, outputs equal "
                                   f"{outputs_equal(tuple(out_in), tuple(out_fed))}")
            print(f"phase 11 (d) {tag} attack={attack}: inline serve bit-equal to plan-fed, "
                  f"launches {json.dumps(n_in)} [{card}]", flush=True)

    serve_pair("centerpoint B=4", mcp.AdversarialCenterPoint(cpcfg), None, cpcfg.head, cb,
               lambda b: build_plan_native(b.points, b.points_mask, cpcfg.voxelizer, 5))
    serve_pair("pointpillars B=6", mpp.AdversarialPointPillars(pillars),
               pillars.make_anchors()[0], pillars.head, pb,
               lambda b: build_pillar_plan_native(b.points, b.points_mask, pillars.voxelizer,
                                                  4))
    expect_bf16_kernels("inline CenterPoint / PointPillars serving")
    torch.cuda.empty_cache()
    st = StrongTrainer(StrongVoxelNetConfig(base=mvn.VoxelNetConfig(adversary=None)),
                       TrainConfig(), device=dev)
    st.init_state(seed, batch_size=IN_BATCH)
    splan = HostPlanBuilder(st.model_cfg.base)(sb.points, sb.points_mask)
    for attack in (False, True):
        st.forward_eval(None, attack, batch=sb)  # warm-up
        zero_counts()
        graph_calls = dict(mvn.PLAN_GRAPH_CALLS)
        with HostPlanCalls() as hp, PlainVersionCalls(k1=True) as plain:
            out_in = st.forward_eval(None, attack, batch=sb)
            torch.cuda.synchronize()
        n_in = read_counts()
        expect_plan_replays(f"strong forward_eval attack={attack}", graph_calls, 1)
        zero_counts()
        out_fed = st.forward_eval(splan, attack)
        if hp.calls or plain.calls or n_in != read_counts() or not outputs_equal(
                tuple(out_in), tuple(out_fed)):
            raise RuntimeError(f"phase 11 strong forward_eval attack={attack}: inline {n_in} "
                               f"vs plan-fed {read_counts()}, {hp.calls} host builds")
        print(f"phase 11 (d) strong forward_eval B=6 attack={attack}: inline bit-equal to "
              f"plan-fed, launches {json.dumps(n_in)} [{card}]", flush=True)
    expect_bf16_kernels("inline strong forward_eval")
    del st
    torch.cuda.empty_cache()
    summary["seconds"] = time.time() - t_phase
    print(f"phase 11: {summary['seconds']:.1f} s [{card}]", flush=True)
    print("phase 11 summary " + json.dumps(summary), flush=True)


# phase 12: the serving export (cli/export.py), each family at full width
EX_REQUESTS = 15  # seeded requests per artifact, each also through the eager serve
EX_FED_REQUESTS = 6  # SECOND's plan-fed artifact
EX_TOP_HOST = 12  # host operations listed where the artifact's and the eager serve's differ
EX_HOST_CALLS = 200  # calls per turn when the operators' host cost is timed
# (K1 forward, apply kernel) launches of one clean request, derived from the
# models: every sparse conv, and every MaskedBatchNorm outside the adversary
EX_LAUNCHES = {"second": (12, 12), "pointpillars": (0, 1), "centerpoint": (21, 21)}

# a fresh interpreter that imports torch and the port's cli/export only,
# loads an artifact and answers one request saved by the parent
_EX_CHILD = r"""
import json, sys
import torch
sys.path.insert(0, sys.argv[1])
from robustpointclouds_tpu_torch.cli.export import load_exported
call, meta = load_exported(sys.argv[2])
req = torch.load(sys.argv[3])
out = call(req["points"].to(sys.argv[5]), req["mask"].to(sys.argv[5]))
torch.save([t.cpu() for t in out], sys.argv[4])
from robustpointclouds_tpu_torch.kernels.masked_stats import masked_batch_norm
from robustpointclouds_tpu_torch.kernels.sparse_conv import sparse_conv
print(json.dumps({"sparse_conv": sparse_conv.launches,
                  "masked_batch_norm": masked_batch_norm.launches,
                  "foreign": sorted(k for k in sys.modules if k.split(".")[0] in
                                    ("jax", "robustpointclouds_tpu"))}))
"""


def _host_us(fn, calls: int) -> float:
    """Host-clock microseconds a call of `fn` takes to return (the enqueue:
    checks, allocation and the launch), over `calls` calls, then a synchronise."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def run_export(dev, card: str, seed: int, zero_counts, read_counts, expect_bf16_kernels):
    """Phase 12: the serving export at full width (module docstring). Prints
    a summary line; returns nothing (no kernel is new on this path)."""
    import tempfile

    import numpy as np
    import torch

    from robustpointclouds_tpu_torch.cli import export
    from robustpointclouds_tpu_torch.data.nuscenes import synthetic_nuscenes_batch
    from robustpointclouds_tpu_torch.data.synthetic import synthetic_kitti_batch
    from robustpointclouds_tpu_torch.kernels import masked_stats as ms
    from robustpointclouds_tpu_torch.kernels import sparse_conv as sc
    from robustpointclouds_tpu_torch.models import centerpoint as mcp
    from robustpointclouds_tpu_torch.models import pointpillars as mpp
    from robustpointclouds_tpu_torch.models import voxelnet as mvn
    from robustpointclouds_tpu_torch.nn.layers import MaskedBatchNorm
    from robustpointclouds_tpu_torch.nn.sparse_encoder import SparseConv3d
    from robustpointclouds_tpu_torch.train.checkpoint import CheckpointManager
    from robustpointclouds_tpu_torch.train.loop import TrainConfig, Trainer

    t_phase = time.time()
    rng = np.random.RandomState(seed + 12)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_export_")
    summary = {}

    def k1_apply():
        n = read_counts()
        return n["sparse_conv"], n["masked_batch_norm"]

    def frames(name, cfg, batch):
        if name == "centerpoint":
            b, _ = synthetic_nuscenes_batch(rng, batch_size=batch, num_points=CP_POINTS,
                                            max_gt=cfg.head.max_objs,
                                            point_range=cfg.voxelizer.point_cloud_range)
        else:
            b = synthetic_kitti_batch(rng, batch_size=batch, num_points=IN_POINTS, max_gt=20,
                                      num_objects=8, point_range=cfg.voxelizer.point_cloud_range)
        return (torch.from_numpy(np.asarray(b.points)).to(dev),
                torch.from_numpy(np.asarray(b.points_mask)).to(dev))

    def counted(fn):
        """(output, (K1, apply) launches, host ms, CUDA-event ms) of one request."""
        torch.cuda.synchronize()
        zero_counts()
        out, host_ms, ev_ms = _timed(fn, True)
        return out, k1_apply(), host_ms, ev_ms

    def check_family(name, eager, call, req_frames, expect, fed=None):
        """Each request through the eager serve and the artifact in turns:
        bit-equal outputs, equal launches, (K1, apply) as `expect`, and
        detections in every request (the heads' score_thr is 0)."""
        rows = []
        for i, (pts, msk) in enumerate(req_frames):
            extra = () if fed is None else (fed(pts, msk),)
            order = ("eager", "artifact") if i % 2 == 0 else ("artifact", "eager")
            res = {}
            for which in order:
                fn = (lambda: eager(pts, msk, *extra)) if which == "eager" else (
                    lambda: call(pts, msk, *extra))
                res[which] = counted(fn)
            (out_e, n_e, ms_e, ev_e), (out_a, n_a, ms_a, ev_a) = res["eager"], res["artifact"]
            if not outputs_equal(tuple(out_a), tuple(out_e)):
                raise RuntimeError(f"phase 12 {name} request {i}: the artifact's outputs differ "
                                   f"from the eager serve's")
            if n_a != n_e or n_e != expect:
                raise RuntimeError(f"phase 12 {name} request {i}: (K1, apply) launches artifact "
                                   f"{n_a}, eager {n_e}, expected {expect}")
            rows.append(dict(eager_ms=ms_e, artifact_ms=ms_a, eager_event_ms=ev_e,
                             artifact_event_ms=ev_a, valid=int(out_a[3].sum())))
            if rows[-1]["valid"] == 0:
                raise RuntimeError(f"phase 12 {name} request {i}: no detection to compare")
        # device operations, their device ms and the host events of one
        # request each way
        pts, msk = req_frames[0]
        extra = () if fed is None else (fed(pts, msk),)
        prof = {"eager": profile_host(lambda: eager(pts, msk, *extra)),
                "artifact": profile_host(lambda: call(pts, msk, *extra))}
        ops = {k: v[:2] for k, v in prof.items()}
        print(f"phase 12 {name} request 0 under torch.profiler, (device operations, device "
              f"ms): " + json.dumps(ops) + f" [{card}]", flush=True)
        print(f"phase 12 {name} request 0 host events ([count, self host ms], under "
              f"torch.profiler): " + json.dumps(host_difference(
                  prof["eager"][2], prof["artifact"][2], EX_TOP_HOST)) + f" [{card}]",
              flush=True)
        return rows

    def report(name, rows, times, mb, peak_gib):
        med = {k: statistics.median(r[k] for r in rows)
               for k in ("eager_ms", "artifact_ms", "eager_event_ms", "artifact_event_ms")}
        summary[name] = dict(times, artifact_mb=mb, peak_gib=peak_gib, **med, requests=len(rows))
        slower = sum(r["artifact_ms"] > r["eager_ms"] for r in rows)
        summary[name]["artifact_slower_requests"] = slower
        if "aten_calls" in times:  # what the overload dispatch adds to a request
            d = summary["dispatch_us"]
            summary[name]["overload_dispatch_ms"] = (
                times["aten_calls"] * (d["overload"] - d["binding"]) / 1e3)
        print(f"phase 12 {name}: {json.dumps(times)}, artifact {mb:.1f} MB; {len(rows)} "
              f"requests bit-equal to the eager serve, (K1, apply) launches each "
              f"{EX_LAUNCHES.get(name.split()[0], '')}; median request ms artifact "
              f"{med['artifact_ms']:.3f} vs eager {med['eager_ms']:.3f} (host clock; CUDA events "
              f"{med['artifact_event_ms']:.3f} vs {med['eager_event_ms']:.3f}), in turns, the "
              f"artifact slower in {slower} of {len(rows)}; peak memory {peak_gib:.2f} GiB "
              f"[{card}]", flush=True)
        if "overload_dispatch_ms" in summary[name]:
            print(f"phase 12 {name}: {times['aten_calls']} aten calls in the graph x (overload - "
                  f"binding) us = {summary[name]['overload_dispatch_ms']:.3f} ms of host time a "
                  f"request [{card}]", flush=True)
        print(f"phase 12 {name} requests [eager ms, artifact ms, valid]: " + json.dumps(
            [[round(r["eager_ms"], 3), round(r["artifact_ms"], 3), r["valid"]] for r in rows]),
            flush=True)

    def roundtrip(name, write):
        """(loaded callable, timings, MB, path): `write(path)` exports and
        saves, with no kernel launch counted; then the artifact is loaded."""
        torch.cuda.synchronize()
        zero_counts()
        path = os.path.join(tmp, f"{name.replace(' ', '_')}.pt2")
        times = write(path)
        if any(read_counts().values()):
            raise RuntimeError(f"phase 12 {name}: kernels launched while exporting: "
                               f"{read_counts()}")
        t0 = time.perf_counter()
        call, meta = export.load_exported(path)
        times["load_s"] = time.perf_counter() - t0
        if meta["platforms"] != [dev.type]:
            raise RuntimeError(f"phase 12 {name}: meta {meta}")
        return call, times, os.path.getsize(path) / 1e6, path

    def program(*args, **kw):
        """The writer of export_program's artifact: export and save timed apart."""
        def write(path):
            t0 = time.perf_counter()
            ep, meta = export.export_program(*args, **kw)
            t1 = time.perf_counter()
            export.save_exported(ep, meta, path)
            return dict(export_s=t1 - t0, save_s=time.perf_counter() - t1,
                        aten_calls=sum(n.op == "call_function" and str(n.target).startswith("aten.")
                                       for n in ep.graph.nodes))
        return write

    # (a) SECOND B=6: a trainer's seeded weights saved as a checkpoint, then
    # exported by the CLI's main from the work dir (the user's flow), at the
    # head's own score threshold: one request bit-equal to the eager serve
    second = mvn.VoxelNetConfig()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(second, TrainConfig(), device=dev)
    trainer.init_state(seed)
    work = os.path.join(tmp, "second_run")
    CheckpointManager(work).save(0, trainer)
    eager = export.export_serving(trainer.model, None, trainer.anchors, second.head)

    def write_main(path):
        t0 = time.perf_counter()
        export.main([path, "--work-dir", work, "--batch-size", str(IN_BATCH),
                     "--num-points", str(IN_POINTS)])
        return dict(main_s=time.perf_counter() - t0)  # restore + export + save

    call, main_times, _, _ = roundtrip("second main", write_main)
    req = [frames("second", second, IN_BATCH) for _ in range(EX_REQUESTS)]
    out_e, n_e, _, _ = counted(lambda: eager(*req[0]))
    out_a, n_a, _, _ = counted(lambda: call(*req[0]))
    if not outputs_equal(tuple(out_a), tuple(out_e)) or not n_a == n_e == EX_LAUNCHES["second"]:
        raise RuntimeError(f"phase 12 second main: the artifact differs from the eager serve "
                           f"(launches {n_a} vs {n_e})")
    summary["second main"] = dict(main_times, valid=int(out_a[3].sum()))
    print(f"phase 12 second main (restore + export + save from a CheckpointManager work dir, "
          f"the head's score_thr {second.head.score_thr}): " + json.dumps(main_times)
          + f", request 0 bit-equal to the eager serve, {int(out_a[3].sum())} detections "
          f"[{card}]", flush=True)
    del call

    # the requests compared from here on keep every candidate (score_thr 0),
    # so that random weights leave detections to compare
    head0 = second.head._replace(score_thr=0.0)
    eager = export.export_serving(trainer.model, None, trainer.anchors, head0)
    call, times, mb, path_second = roundtrip("second", program(
        trainer.model, trainer.anchors, head0, IN_BATCH, IN_POINTS))
    eager(*req[0])
    call(*req[0])  # warm-up
    rows = check_family("second", eager, call, req, EX_LAUNCHES["second"])
    expect_bf16_kernels("exported SECOND serving")

    # the operators' host cost per call against their direct launches, on
    # the inputs of one encoder conv and one encoder BN of this request
    grabbed = {}
    convs = [m for m in trainer.model.modules() if isinstance(m, SparseConv3d)]
    bns = [m for n, m in trainer.model.named_modules()
           if isinstance(m, MaskedBatchNorm) and not n.startswith("adversary.")]

    def grab_conv(mod, a):  # a pre-hook that returns nothing keeps the inputs
        grabbed["conv"] = (a[0].contiguous(), mod.img2col_kernel(a[0].dtype), a[1])

    def grab_bn(mod, a):  # SparseConvBlock's BN: ReLU and row mask, in the module's dtype
        grabbed["bn"] = (a[0], a[1], mod.running_mean, mod.running_var, mod.weight, mod.bias,
                         mod.eps, True, True, mod.dtype)

    hooks = [convs[5].register_forward_pre_hook(grab_conv),
             bns[5].register_forward_pre_hook(grab_bn)]
    eager(*req[0])
    for h in hooks:
        h.remove()
    host = {}
    for key, op, direct in (("sparse_conv_fwd", sc.sparse_conv_fwd, sc._sparse_conv_fwd_cuda),
                            ("masked_bn_apply", ms.masked_bn_apply, ms._masked_bn_apply_cuda)):
        args = grabbed["conv" if key == "sparse_conv_fwd" else "bn"]
        turns = [("op", op), ("direct", direct), ("direct", direct), ("op", op)]
        got = {"op": [], "direct": []}
        with torch.no_grad():  # as the model calls them (serving, an autograd Function)
            if not torch.equal(op(*args), direct(*args)):
                raise RuntimeError(f"phase 12: {key} differs from its direct launch")
            for which, fn in turns:
                got[which].append(_host_us(lambda: fn(*args), EX_HOST_CALLS))
        host[key] = {k: sum(v) / len(v) for k, v in got.items()}
        host[key]["shape"] = list(args[0].shape)
    summary["host_us"] = host
    # the artifact's generated code calls each aten operator through its
    # OpOverload (torch.ops.aten.add.Tensor), eager code through the Python
    # binding (torch.add): the host us of a call each way, in turns
    xa, xb = (torch.ones(4, device=dev) for _ in range(2))
    overload = torch.ops.aten.add.Tensor
    ways = {"overload": lambda: overload(xa, xb), "binding": lambda: torch.add(xa, xb)}
    got = {"overload": [], "binding": []}
    with torch.no_grad():
        for which in ("overload", "binding", "binding", "overload"):
            got[which].append(_host_us(ways[which], EX_HOST_CALLS * 10))
    summary["dispatch_us"] = {k: sum(v) / len(v) for k, v in got.items()}
    print(f"phase 12 host us per call (conv 5 and BN 5 of the SECOND encoder, gradients off, "
          f"{EX_HOST_CALLS} calls a turn, op/direct/direct/op): " + json.dumps(host) + f"; "
          f"aten add of two 4-element tensors through its OpOverload vs the Python binding "
          f"({EX_HOST_CALLS * 10} calls a turn, in turns): " + json.dumps(summary["dispatch_us"])
          + f" [{card}]", flush=True)
    report("second", rows, times, mb, torch.cuda.max_memory_allocated() / 2 ** 30)

    # a fresh process loads the SECOND artifact and answers request 0
    req_file, out_file = os.path.join(tmp, "request.pt"), os.path.join(tmp, "child_out.pt")
    torch.save({"points": req[0][0].cpu(), "mask": req[0][1].cpu()}, req_file)
    t0 = time.perf_counter()
    child = subprocess.run([sys.executable, "-c", _EX_CHILD, REPO, path_second, req_file,
                            out_file, dev.type], capture_output=True, text=True, timeout=600)
    child_s = time.perf_counter() - t0
    if child.returncode != 0:
        raise RuntimeError(f"phase 12 fresh-process load failed:\n{child.stderr[-4000:]}")
    child_counts = json.loads(child.stdout.strip().splitlines()[-1])
    mine = [t.cpu() for t in call(*req[0])]
    k1, apply = EX_LAUNCHES["second"]
    if not outputs_equal(tuple(torch.load(out_file)), tuple(mine)) or child_counts != {
            "sparse_conv": k1, "masked_batch_norm": apply, "foreign": []}:
        raise RuntimeError(f"phase 12 fresh process: outputs equal "
                           f"{outputs_equal(tuple(torch.load(out_file)), tuple(mine))}, "
                           f"{child_counts}")
    summary["fresh_process_s"] = child_s
    print(f"phase 12 fresh process (torch + cli/export only): loaded the SECOND artifact and "
          f"answered request 0 bit-equal to this process in {child_s:.1f} s (process start "
          f"included), launches {json.dumps(child_counts)} [{card}]", flush=True)

    # (b) SECOND's plan-fed artifact on the native host plan
    call_fed, fed_times, fed_mb, _ = roundtrip("second plan-fed", program(
        trainer.model, trainer.anchors, head0, IN_BATCH, IN_POINTS, use_plan=True))

    def host_plan(pts, msk):
        return mvn.plan_to_device(export.native_plan(trainer.model, pts.cpu().numpy(),
                                                     msk.cpu().numpy()), dev)

    rows = check_family("second plan-fed", eager, call_fed, req[:EX_FED_REQUESTS],
                        EX_LAUNCHES["second"], fed=host_plan)
    report("second plan-fed", rows, fed_times, fed_mb,
           torch.cuda.max_memory_allocated() / 2 ** 30)
    del trainer, eager, call, call_fed
    torch.cuda.empty_cache()

    # (c) PointPillars B=6 and CenterPoint B=4, seeded random weights
    for name, cfg, cls, batch in (
            ("pointpillars", mpp.PointPillarsConfig(), mpp.AdversarialPointPillars, IN_BATCH),
            ("centerpoint", mcp.CenterPointConfig(), mcp.AdversarialCenterPoint, CP_BATCH)):
        torch.cuda.reset_peak_memory_stats()
        model = cls(cfg)
        mvn.init_weights(model, torch.Generator().manual_seed(seed))
        anchors = None if name == "centerpoint" else cfg.make_anchors()[0]
        head0 = cfg.head._replace(score_thr=0.0)
        eager = export.export_serving(model, None, anchors, head0)
        npts = CP_POINTS if name == "centerpoint" else IN_POINTS
        call, times, mb, _ = roundtrip(name, program(model, anchors, head0, batch, npts))
        req = [frames(name, cfg, batch) for _ in range(EX_REQUESTS)]
        eager(*req[0])
        call(*req[0])  # warm-up
        rows = check_family(name, eager, call, req, EX_LAUNCHES[name])
        expect_bf16_kernels(f"exported {name} serving")
        report(name, rows, times, mb, torch.cuda.max_memory_allocated() / 2 ** 30)
        del model, eager, call
        torch.cuda.empty_cache()
    shutil.rmtree(tmp, ignore_errors=True)
    summary["seconds"] = time.time() - t_phase
    print(f"phase 12: {summary['seconds']:.1f} s [{card}]", flush=True)
    print("phase 12 summary " + json.dumps(summary), flush=True)


# phase 13: zoo warm starts (tools/convert_torch_checkpoint, train/checkpoint.load_pretrained)
# kernels vs plain versions through a whole bf16 forward: ||kernels - plain|| /
# ||plain|| per head output. Both round each conv's and BN's output to bf16 at
# the same points and differ only where a summation order flips a rounding;
# after 12-21 layers such flips move single elements by 1.0-1.6% of the
# output's scale (full width on an H100), so the gate is on the norm and the
# largest element is printed beside it
ZOO_RTOL = SPARSE_CONV_RTOL
ZOO_SEED = 13  # the fake zoo files' weights: seed + ZOO_SEED
ZOO_CONFIGS = {
    "second": os.path.join(REPO, "configs", "adversarial", "adversarial-second_kitti-3d-3class.py"),
    "pointpillars": os.path.join(REPO, "configs", "adversarial",
                                 "adversarial-pointpillars_kitti-3d-3class.py"),
    "centerpoint": CP_CONFIG,
}
ZOO_SECOND_LOADED = 86  # 60 encoder, 10 backbone, 10 neck, 6 head (JAX's units)
ZOO_CLI_STEPS = 4  # train_kitti_3class_adversarial: epochs 0-3 of one step, the adversary on at 3


class PlainRoute(PlainVersionCalls):
    """PlainVersionCalls(k1=True) that also routes the serving path's two
    operators on card tensors to their plain versions: K1's forward to
    sparse_conv_ref and K2's apply to bn_apply_ref, each call counted; no
    kernel launches inside."""

    def __init__(self):
        super().__init__(k1=True)

    def __enter__(self):
        import robustpointclouds_tpu_torch.kernels.masked_stats as ms
        import robustpointclouds_tpu_torch.kernels.sparse_conv as sc

        super().__enter__()
        self.ops = [(sc, "sparse_conv_fwd", sc.sparse_conv_fwd),
                    (ms, "masked_bn_apply", ms.masked_bn_apply)]
        sc.sparse_conv_fwd = lambda feats, kernel, idx: sc.sparse_conv_ref(feats, kernel, idx)
        ms.masked_bn_apply = lambda *a: ms.bn_apply_ref(*a)
        return self

    def __exit__(self, *exc):
        for mod, n, fn in self.ops:
            setattr(mod, n, fn)
        super().__exit__(*exc)


class Tee:
    """Standard output copied into a buffer while it still prints."""

    def __enter__(self):
        import io

        self.buf, self.out = io.StringIO(), sys.stdout
        sys.stdout = self
        return self

    def write(self, s):
        self.buf.write(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()

    def __exit__(self, *exc):
        sys.stdout = self.out

    def text(self):
        return self.buf.getvalue()


def _load_line(text: str, path: str):
    """(layout, loaded, skipped) of load_pretrained's line for `path`."""
    import re

    m = re.search(re.escape(f"[load-from] {path} (") + r"(\w+)\): loaded (\d+) tensors, "
                  r"skipped (\d+)", text)
    if m is None:
        raise RuntimeError(f"phase 13: no [load-from] line for {path}")
    return m.group(1), int(m.group(2)), int(m.group(3))


def _finite_losses(work_dir: str, n_rows: int):
    """The losses of run_training's train_log.jsonl, checked finite."""
    import math

    with open(os.path.join(work_dir, "train_log.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    if len(rows) != n_rows or not all(math.isfinite(v) for r in rows for v in r.values()):
        raise RuntimeError(f"phase 13: {work_dir} logged {rows}")
    return rows


def run_zoo(dev, card: str, seed: int, zero_counts, read_counts, expect_bf16_kernels):
    """Phase 13: zoo warm starts at full width (module docstring). Prints a
    summary line and returns it (no kernel is new on this path)."""
    import tempfile

    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from zoo_checkpoint import fake_zoo_state_dict, save_pth

    from robustpointclouds_tpu_torch.cli import evaluate_kitti_3class, export
    from robustpointclouds_tpu_torch.cli import train as generic_cli
    from robustpointclouds_tpu_torch.cli import train_kitti_3class_adversarial as kitti_cli
    from robustpointclouds_tpu_torch.cli import train_nuscenes_adversarial as nus_cli
    from robustpointclouds_tpu_torch.core.builders import build_model_config
    from robustpointclouds_tpu_torch.core.config import Config
    from robustpointclouds_tpu_torch.data.nuscenes import synthetic_nuscenes_batch
    from robustpointclouds_tpu_torch.data.synthetic import synthetic_kitti_batch
    from robustpointclouds_tpu_torch.models.voxelnet import VoxelNetConfig
    from robustpointclouds_tpu_torch.tools import convert_torch_checkpoint as cvt
    from robustpointclouds_tpu_torch.train.centerpoint_loop import CenterPointTrainer
    from robustpointclouds_tpu_torch.train.checkpoint import load_pretrained
    from robustpointclouds_tpu_torch.train.loop import TrainConfig, Trainer

    t_phase = time.time()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_zoo_")
    rng = np.random.RandomState(seed + ZOO_SEED)
    summary, pth = {}, {}

    def trainer_of(name):
        cfg = Config.fromfile(ZOO_CONFIGS[name])
        if name == "centerpoint":
            cfg.merge_from_cli(["model.use_dcn_head=True"])
            return CenterPointTrainer(build_model_config(cfg), device=dev)
        return Trainer(build_model_config(cfg), TrainConfig(), device=dev)

    def head_outputs(outs):
        if hasattr(outs, "task_preds"):
            return [v for t in outs.task_preds for _, v in sorted(t.items())]
        return [outs.cls_scores, outs.bbox_preds, outs.dir_preds]

    for name in ("second", "pointpillars", "centerpoint"):
        # (a) the family's zoo file from the seed
        tr = trainer_of(name)
        tr.init_state(seed)
        spconv1 = ["middle_encoder.conv_input.0.weight"] if name == "second" else []
        zoo = fake_zoo_state_dict(tr.model.state_dict(), seed + ZOO_SEED, spconv1=spconv1)
        pth[name] = save_pth(zoo, os.path.join(tmp, f"{name}.pth"))
        mb = os.path.getsize(pth[name]) / 1e6
        n_det = sum(p.numel() for k, p in tr.model.named_parameters()
                    if not k.startswith("adversary."))

        # (b) the warm start on the card against the host conversion
        layout = cvt.detect_state_dict_layout(zoo)
        convert = {"second": cvt.convert_second_state_dict,
                   "pointpillars": cvt.convert_pointpillars_state_dict,
                   "centerpoint": lambda sd: cvt.convert_centerpoint_state_dict(sd, True)}[name]
        host = convert(cvt.load_torch_checkpoint(pth[name]))
        cpu_model = type(tr.model)(tr.model_cfg)
        want_loaded, want_skipped = cvt.merge_into_state_dict(cpu_model, host)
        before = {k: v.detach().clone() for k, v in tr.model.state_dict().items()}
        torch.cuda.synchronize()
        with Tee() as tee:
            t0 = time.perf_counter()
            load_pretrained(tr, pth[name])
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
        counts = _load_line(tee.text(), pth[name])
        if counts != (layout, len(want_loaded), len(want_skipped)):
            raise RuntimeError(f"phase 13 {name}: counts {counts}, the CPU conversion gives "
                               f"{len(want_loaded)} / {len(want_skipped)}")
        if name == "second" and counts[1:] != (ZOO_SECOND_LOADED, 0):
            raise RuntimeError(f"phase 13 second: {counts}, expected {ZOO_SECOND_LOADED} / 0")
        after = tr.model.state_dict()
        loaded = set(want_loaded)
        for k, v in after.items():
            if k in loaded:
                want = torch.from_numpy(host[k])
                if not (host[k].dtype == np.float32 and v.dtype == torch.float32
                        and v.device.type == "cuda" and torch.equal(v.cpu(), want)):
                    raise RuntimeError(f"phase 13 {name}: {k} differs from the host conversion")
            elif not torch.equal(v, before[k]):
                raise RuntimeError(f"phase 13 {name}: {k}, which the file does not map, moved")
        unmapped = len(after) - len(loaded)
        print(f"phase 13 {name} (a)+(b): {mb:.2f} MB .pth ({n_det} detector parameters); "
              f"load_pretrained {load_s:.3f} s on the card; loaded {counts[1]} skipped "
              f"{counts[2]}, each bit-equal to the host conversion (float32); {unmapped} "
              f"other tensors unchanged [{card}]", flush=True)

        # (c) one request served on the warm start, then its forward with K1 / K2 plain
        if name == "centerpoint":
            b, _ = synthetic_nuscenes_batch(rng, batch_size=CP_BATCH, num_points=CP_POINTS,
                                            max_gt=tr.model_cfg.head.max_objs,
                                            point_range=tr.model_cfg.voxelizer.point_cloud_range)
        else:
            b = synthetic_kitti_batch(rng, batch_size=IN_BATCH, num_points=IN_POINTS, max_gt=20,
                                      num_objects=8,
                                      point_range=tr.model_cfg.voxelizer.point_cloud_range)
        pts = torch.from_numpy(np.asarray(b.points)).to(dev)
        msk = torch.from_numpy(np.asarray(b.points_mask)).to(dev)
        serve = export.export_serving(tr.model, None, getattr(tr, "anchors", None),
                                      tr.model_cfg.head)
        serve(pts, msk)  # warm-up
        torch.cuda.synchronize()
        zero_counts()
        out, host_ms, ev_ms = _timed(lambda: serve(pts, msk), True)
        n_serve = read_counts()
        expect_bf16_kernels(f"phase 13 {name} serving")
        k1, apply = EX_LAUNCHES[name]
        want = dict({k: 0 for k in n_serve}, sparse_conv=k1, masked_batch_norm=apply)
        if n_serve != want or not all(bool(torch.isfinite(t.float()).all()) for t in out):
            raise RuntimeError(f"phase 13 {name} serving: launches {n_serve}, expected {want}, "
                               "or non-finite detections")
        model = tr.model.eval()
        with torch.no_grad():
            kern = head_outputs(model(pts, msk, False, 100, False, -1.0, None))
            zero_counts()
            with PlainRoute() as plain:
                ref = head_outputs(model(pts, msk, False, 100, False, -1.0, None))
            torch.cuda.synchronize()
        n_plain = read_counts()
        if any(n_plain.values()) or plain.calls != k1 + apply:
            raise RuntimeError(f"phase 13 {name}: the plain forward launched {n_plain} and made "
                               f"{plain.calls} plain calls, expected {k1 + apply}")
        worst = peak = 0.0
        for g, r in zip(kern, ref):
            d, r = (g.float() - r.float()), r.float()
            worst = max(worst, d.norm().item() / max(r.norm().item(), 1e-12))
            peak = max(peak, d.abs().max().item() / max(r.abs().max().item(), 1e-12))
        if not worst <= ZOO_RTOL:
            raise RuntimeError(f"phase 13 {name}: kernels vs plain versions {worst:.3e} in "
                               f"norm > {ZOO_RTOL}")
        summary[name] = dict(pth_mb=mb, load_s=load_s, loaded=counts[1], skipped=counts[2],
                             serve_host_ms=host_ms, serve_event_ms=ev_ms,
                             valid=int(out[3].sum()), launches=[k1, apply],
                             plain_calls=plain.calls, kernels_vs_plain=worst,
                             kernels_vs_plain_peak=peak)
        print(f"phase 13 {name} (c) B={pts.shape[0]} request on the warm start: serve "
              f"{host_ms:.3f} ms host / {ev_ms:.3f} ms CUDA events, {int(out[3].sum())} "
              f"detections, launches K1 {k1} apply {apply}; eval forward with K1 / K2 routed "
              f"to their plain versions ({plain.calls} plain calls, 0 launches): head outputs "
              f"within {worst:.3e} in norm (tolerance {ZOO_RTOL}), largest element "
              f"{peak:.3e} of scale [{card}]",
              flush=True)
        del tr, cpu_model, model, serve

    # (d) the CLIs on the .pth files, on the card at full width
    def cli_run(label, fn, path, want_layout, n_rows=None, work=None, launches=True):
        """One CLI run on `path`: its [load-from] line, its K1 / K2 launches
        (none for an export, which traces), finite logged losses."""
        torch.cuda.synchronize()
        zero_counts()
        with Tee() as tee:
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        got = read_counts()
        counts = _load_line(tee.text(), path)
        ran = got["sparse_conv"] + got["masked_batch_norm"]
        if counts[0] != want_layout or bool(ran) != launches or (not launches and any(
                got.values())):
            raise RuntimeError(f"phase 13 {label}: {counts}, launches {got}")
        row = dict(wall_s=wall_s, loaded=counts[1], skipped=counts[2], launches=got)
        if n_rows is not None:
            losses = _finite_losses(work, n_rows)
            row["loss"] = [round(r["loss"], 4) for r in losses]
            row["l2"] = [round(r.get("perturbation_l2_norm", 0.0), 5) for r in losses]
        summary[label] = row
        print(f"phase 13 (d) {label}: " + json.dumps(row) + f" [{card}]", flush=True)
        return res

    wd = {k: os.path.join(tmp, k) for k in ("kitti", "generic", "nuscenes", "export")}
    cli_run("train_kitti_3class_adversarial", lambda: kitti_cli.main(
        ["--config", ZOO_CONFIGS["second"], "--synthetic", "--load-from", pth["second"],
         "--epochs", str(ZOO_CLI_STEPS), "--steps-per-epoch", "1", "--seed", str(seed),
         "--work-dir", wd["kitti"]]), pth["second"], "second", ZOO_CLI_STEPS, wd["kitti"])
    if not summary["train_kitti_3class_adversarial"]["l2"][-1] > 0:
        raise RuntimeError("phase 13: the adversary did not perturb at epoch 3")
    cli_run("cli/train pointpillars", lambda: generic_cli.main(
        [ZOO_CONFIGS["pointpillars"], "--synthetic", "--load-from", pth["pointpillars"],
         "--steps-per-epoch", "2", "--work-dir", wd["generic"], "--cfg-options",
         "max_epochs=1"]), pth["pointpillars"], "pointpillars", 1, wd["generic"])
    cli_run("train_nuscenes_adversarial", lambda: nus_cli.main(
        ["--synthetic", "--pretrained", pth["centerpoint"], "--batch-size", str(CP_BATCH),
         "--steps", "2", "--work-dir", wd["nuscenes"]]), pth["centerpoint"], "centerpoint", 2,
        wd["nuscenes"])
    if summary["train_nuscenes_adversarial"]["skipped"] != 12:  # the plain head: 2 x 6 tasks
        raise RuntimeError("phase 13: the CLI's plain head skipped "
                           f"{summary['train_nuscenes_adversarial']['skipped']}, expected 12")
    res = cli_run("evaluate_kitti_3class", lambda: evaluate_kitti_3class.main(
        ["--mode", "clean", "--checkpoint", os.path.join(tmp, "empty"), "--load-from",
         pth["second"], "--synthetic", "--limit", str(IN_BATCH)]), pth["second"], "second")
    if res["clean"] is None or not np.isfinite(res["clean"]["mAP_3d_moderate"]):
        raise RuntimeError(f"phase 13 evaluate_kitti_3class: {res}")
    os.makedirs(wd["export"], exist_ok=True)
    art = os.path.join(wd["export"], "second.pt2")
    cli_run("export", lambda: export.main(
        [art, "--load-from", pth["second"], "--batch-size", str(IN_BATCH), "--num-points",
         str(IN_POINTS)]), pth["second"], "second", launches=False)
    call, _ = export.load_exported(art)
    ref_tr = Trainer(VoxelNetConfig(), TrainConfig(), device=dev)
    ref_tr.init_state(0)  # export's own init before the warm start
    with Tee():
        load_pretrained(ref_tr, pth["second"])
    b = synthetic_kitti_batch(rng, batch_size=IN_BATCH, num_points=IN_POINTS, max_gt=20,
                              num_objects=8, point_range=ref_tr.model_cfg.voxelizer.point_cloud_range)
    pts = torch.from_numpy(np.asarray(b.points)).to(dev)
    msk = torch.from_numpy(np.asarray(b.points_mask)).to(dev)
    eager = export.export_serving(ref_tr.model, None, ref_tr.anchors, ref_tr.model_cfg.head)
    zero_counts()
    out_a = call(pts, msk)
    n_a = read_counts()
    zero_counts()
    out_e = eager(pts, msk)
    n_e = read_counts()
    if not outputs_equal(tuple(out_a), tuple(out_e)) or n_a != n_e or (
            n_a["sparse_conv"], n_a["masked_batch_norm"]) != EX_LAUNCHES["second"]:
        raise RuntimeError(f"phase 13 export: the warm-started artifact differs from the eager "
                           f"serve (launches {n_a} vs {n_e})")
    print(f"phase 13 (d) export: the artifact of the warm start answers a B={IN_BATCH} request "
          f"bit-equal to the eager serve ({int(out_a[3].sum())} detections, launches "
          f"{n_a['sparse_conv']} / {n_a['masked_batch_norm']}) [{card}]", flush=True)

    # (e) the converter's CLI writes a port checkpoint equal to the warm start
    conv_dir = os.path.join(tmp, "converted")
    with Tee() as tee:
        t0 = time.perf_counter()
        loaded, skipped = cvt.main([pth["second"], "--out", conv_dir])
        conv_s = time.perf_counter() - t0
    other = Trainer(VoxelNetConfig(), TrainConfig(), device=dev)
    other.init_state(seed + 1)
    with Tee():
        load_pretrained(other, conv_dir)
    for k, v in ref_tr.model.state_dict().items():
        if not torch.equal(other.model.state_dict()[k], v):
            raise RuntimeError(f"phase 13 (e): {k} differs between --load-from the converted "
                               "directory and --load-from the .pth")
    if (len(loaded), len(skipped)) != (ZOO_SECOND_LOADED, 0):
        raise RuntimeError(f"phase 13 (e): converter loaded {len(loaded)}, skipped {skipped}")
    summary["convert_cli_s"] = conv_s
    print(f"phase 13 (e) tools.convert_torch_checkpoint {os.path.basename(pth['second'])} --out "
          f"DIR: {conv_s:.2f} s, loaded {len(loaded)}; --load-from DIR equals --load-from the "
          f".pth on every key [{card}]", flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    summary["seconds"] = time.time() - t_phase
    print(f"phase 13: {summary['seconds']:.1f} s [{card}]", flush=True)
    print("phase 13 summary " + json.dumps(summary), flush=True)
    return summary


# phase 14: data-parallel training (M10): two ranks on the one card over gloo
# (NCCL refuses two ranks on one device), each on its own rows with its own
# host plans; the all-reduce of gradients, BatchNorm statistics and logs
DP_WORLD = 2
DP_SECOND_BATCH, DP_SECOND_EPOCHS, DP_SECOND_STEPS = 6, 2, 3  # 3 rows a rank, 6 steps
DP_CP_BATCH, DP_CP_EPOCHS, DP_CP_STEPS = 4, 1, 3  # 2 rows a rank, 3 steps
DP_ROOT = os.path.join(REPO, "work_dirs", "chip_smoke_dp")
SECOND_CONFIG = os.path.join(REPO, "configs", "adversarial",
                             "adversarial-second_kitti-3d-3class.py")


def free_port() -> int:
    """A TCP port on the loopback interface that nothing listens on now."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dp_family(family: str, seed: int):
    """(make_trainer(device), epoch loader, epochs, launches a step) of a
    phase 14 family: SECOND with the adversary on from epoch 0, or
    CenterPoint, at full width on synthetic frames."""
    from robustpointclouds_tpu_torch.cli.common import synthetic_loader
    from robustpointclouds_tpu_torch.cli.train_nuscenes_adversarial import (
        synthetic_nuscenes_loader)
    from robustpointclouds_tpu_torch.models.centerpoint import CenterPointConfig
    from robustpointclouds_tpu_torch.models.voxelnet import VoxelNetConfig
    from robustpointclouds_tpu_torch.train.centerpoint_loop import CenterPointTrainer
    from robustpointclouds_tpu_torch.train.loop import TrainConfig, Trainer

    if family == "second":
        cfg = VoxelNetConfig()._replace(adversary_start_epoch=0)
        loader = synthetic_loader(DP_SECOND_BATCH, DP_SECOND_STEPS, num_points=20000, seed=seed,
                                  point_range=cfg.voxelizer.point_cloud_range)
        return (lambda dev: Trainer(cfg, TrainConfig(), device=dev)), loader, \
            DP_SECOND_EPOCHS, TRAIN_LAUNCHES
    cfg = CenterPointConfig()
    loader = synthetic_nuscenes_loader(DP_CP_BATCH, DP_CP_STEPS, CP_POINTS, cfg.head.max_objs,
                                       cfg.voxelizer.point_cloud_range, seed)
    return (lambda dev: CenterPointTrainer(cfg, device=dev)), loader, DP_CP_EPOCHS, \
        CP_TRAIN_LAUNCHES


def _named_state(trainer):
    """The model's state_dict, the Adam moments and the train state's
    counters, on the host, by name."""
    import torch

    st = trainer.state
    out = {f"model.{k}": v.detach().cpu() for k, v in trainer.model.state_dict().items()}
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        if isinstance(v, dict):
            out.update({f"{f.name}.{k}": v[k].detach().cpu() for k in sorted(v)})
        else:
            out[f.name] = v.detach().cpu() if isinstance(v, torch.Tensor) else torch.tensor(v)
    return out


def _state_bytes(named):
    """Every tensor's bytes, concatenated: two states are equal bit for bit
    when these are."""
    import torch

    return torch.cat([t.contiguous().reshape(-1).view(torch.uint8) for t in named.values()])


def dp_rank(rank: int, world: int, seed: int, device: str):
    """One rank of phase 14 (parallel/multihost.launch_local): each family
    through cli/common.run_training(group=...) on `device`, every step timed
    to a synchronise with its launches read and checked, the state compared
    with rank 0's bit for bit after it, the all-reduce timed (host clock
    between synchronises, and CUDA events) with its bytes; rank 0 saves the
    state after the first step for the emulation."""
    import torch
    import torch.distributed as dist

    from robustpointclouds_tpu_torch.cli.common import run_training
    from robustpointclouds_tpu_torch.kernels.masked_stats import (
        masked_batch_norm, masked_batch_norm_bwd, masked_stats, masked_stats_bwd)
    from robustpointclouds_tpu_torch.kernels.sparse_conv import (
        sparse_conv, sparse_conv_dgrad, sparse_conv_wgrad)
    from robustpointclouds_tpu_torch.parallel import mesh

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
    torch.cuda.set_device(dev)
    group = dist.group.WORLD
    counters = {"sparse_conv": sparse_conv, "sparse_conv_dgrad": sparse_conv_dgrad,
                "sparse_conv_wgrad": sparse_conv_wgrad, "masked_stats": masked_stats,
                "masked_stats_bwd": masked_stats_bwd, "masked_batch_norm": masked_batch_norm,
                "masked_batch_norm_bwd": masked_batch_norm_bwd}
    convs = (sparse_conv, sparse_conv_dgrad, sparse_conv_wgrad)

    def zero_counts():
        for fn in counters.values():
            fn.launches = 0
        for fn in convs:
            fn.tf32_launches = 0
        masked_batch_norm_bwd.reduce_launches = 0

    def read_counts():
        return {**{k: fn.launches for k, fn in counters.items()},
                "bwd_reduce": masked_batch_norm_bwd.reduce_launches}

    reduces = []
    orig_average = mesh.average_step

    def timed_average(tensors, is_nan, grp):
        torch.cuda.synchronize(dev)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        out = orig_average(tensors, is_nan, grp)
        e1.record()
        torch.cuda.synchronize(dev)
        reduces.append({"host_ms": (time.perf_counter() - t0) * 1e3,
                        "event_ms": e0.elapsed_time(e1),
                        "bytes": 4 * (sum(t.numel() for t in tensors) + 1)})
        return out

    mesh.average_step = timed_average
    results = {}
    for family in ("second", "centerpoint"):
        make, loader, epochs, expected = _dp_family(family, seed)
        trainer = make(dev)
        orig_step = type(trainer).train_step
        steps = []

        def step(batch, epoch, plan=None, trainer=trainer, orig_step=orig_step, steps=steps,
                 expected=expected, family=family):
            torch.cuda.synchronize(dev)
            zero_counts()
            t0 = time.perf_counter()
            logs = orig_step(trainer, batch, epoch, plan)
            logs = {k: float(v) for k, v in logs.items()}  # waits for the step
            torch.cuda.synchronize(dev)
            step_ms = (time.perf_counter() - t0) * 1e3
            launches = read_counts()
            if launches != expected or any(fn.tf32_launches for fn in convs):
                raise RuntimeError(f"phase 14 {family} rank {rank}: launches {launches}, "
                                   f"expected {expected} on the bf16 kernels")
            t1 = time.perf_counter()
            named = _named_state(trainer)
            mine = _state_bytes(named)
            if rank == 0:
                for src in range(1, world):
                    other = torch.empty_like(mine)
                    dist.recv(other, src=src, group=group)
                    if not torch.equal(mine, other):
                        raise RuntimeError(f"phase 14 {family}: rank {src}'s state differs from "
                                           f"rank 0's after step {len(steps) + 1}")
                if not steps:
                    torch.save(named, os.path.join(DP_ROOT, f"first_step_{family}.pt"))
            else:
                dist.send(mine, dst=0, group=group)
            steps.append({"epoch": epoch, "step_ms": step_ms, "launches": launches,
                          "check_ms": (time.perf_counter() - t1) * 1e3, "loss": logs["loss"],
                          "num_pos": logs.get("num_pos"), "l2": logs["perturbation_l2_norm"],
                          "state_bytes": int(mine.numel())})
            return logs

        trainer.train_step = step
        reduces.clear()
        torch.cuda.reset_peak_memory_stats(dev)
        res = run_training(trainer, loader, work_dir=os.path.join(DP_ROOT, family),
                           max_epochs=epochs, checkpoint_interval=1, seed=seed, group=group)
        results[family] = {"steps": steps, "reduces": list(reduces), "plans": res["plans"],
                           "epochs": res["epochs"], "sha256": res["state_sha256"],
                           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
        del trainer
        torch.cuda.empty_cache()
    mesh.average_step = orig_average
    return results


def _dp_cli(card: str) -> float:
    """Phase 14 (c): cli/train.py on SECOND's config file as a --multihost
    group of one over NCCL (exit 0, one checkpoint), and --devices 2 refused
    on this card with JAX's message; returns the CLI run's seconds."""
    import torch

    from robustpointclouds_tpu_torch.cli import train as train_cli
    from robustpointclouds_tpu_torch.train.checkpoint import CheckpointManager

    port = free_port()
    cli_dir = os.path.join(DP_ROOT, "cli")
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "robustpointclouds_tpu_torch.cli.train", SECOND_CONFIG,
         "--multihost", "--num-processes", "1", "--process-id", "0",
         "--coordinator", f"127.0.0.1:{port}", "--synthetic", "--steps-per-epoch", "2",
         "--work-dir", cli_dir, "--cfg-options", "max_epochs=1"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    cli_s = time.time() - t0
    if proc.returncode != 0 or "[multihost] process 0/1, nccl" not in proc.stdout:
        raise RuntimeError(f"phase 14 (c): cli/train --multihost exited {proc.returncode}:\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    if CheckpointManager(cli_dir).epochs() != [0]:
        raise RuntimeError(f"phase 14 (c): checkpoints {os.listdir(cli_dir)}")
    try:
        train_cli.main([SECOND_CONFIG, "--devices", "2", "--synthetic",
                        "--work-dir", os.path.join(DP_ROOT, "refused")])
        raise RuntimeError("phase 14 (c): --devices 2 ran on one card")
    except SystemExit as e:
        refusal = str(e)
    if refusal != f"--devices 2 but only {torch.cuda.device_count()} attached":
        raise RuntimeError(f"phase 14 (c): --devices 2 refused with {refusal!r}")
    print(f"phase 14 (c) cli/train --multihost, a group of one over NCCL: exit 0 in {cli_s:.1f} "
          f"s, one checkpoint; --devices 2: {refusal!r} [{card}]", flush=True)
    return cli_s


def run_data_parallel(dev, card: str, seed: int):
    """Phase 14: data-parallel training (cli/common.run_training(group=...),
    train/loop.Trainer.compile_sharded) at full width:
    (a) SECOND, global B=6 over 2 gloo ranks on this card (3 rows and one
        host plan a rank), DP_SECOND_EPOCHS x DP_SECOND_STEPS steps, the
        adversary on from epoch 0; CenterPoint, global B=4, DP_CP_STEPS
        steps (dp_rank): after every step both ranks' states are equal bit
        for bit and each rank's launches are the one-rank step's;
    (b) the first step of each against a one-process emulation on this card
        (tests/torch_dp_ranks.emulate_step: each sub-batch's gradients from
        the same state, summed and halved as the all-reduce does, then the
        optimizer), run twice: bit-equal, or within twice the spread of the
        two emulation runs (max over tensors of |difference| / the tensor's
        largest entry; three draws of the same atomics-ordered sums, so one
        spread would fail by chance half the time); one process at SECOND
        B=6 through run_training for the frames/s beside the two ranks';
    (c) cli/train.py --multihost as a group of one over NCCL (a checkpoint),
        and --devices 2 refused on this one card with JAX's message.
    A rank that fails fails the phase. Returns the summary (launches a rank)."""
    import numpy as np
    import torch

    from robustpointclouds_tpu_torch.cli.common import run_training
    from robustpointclouds_tpu_torch.parallel.mesh import shard_batch
    from robustpointclouds_tpu_torch.parallel.multihost import launch_local

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_dp_ranks import emulate_step

    t_phase = time.time()
    shutil.rmtree(DP_ROOT, ignore_errors=True)
    os.makedirs(DP_ROOT)
    torch.cuda.synchronize()
    # (a) the two ranks
    t0 = time.time()
    ranks = launch_local(dp_rank, DP_WORLD, (seed, str(dev)), backend="gloo",
                         init_file=os.path.join(DP_ROOT, "rendezvous"))
    ranks_s = time.time() - t0
    summary = {"ranks_s": ranks_s}
    for family, batch in (("second", DP_SECOND_BATCH), ("centerpoint", DP_CP_BATCH)):
        rs = [r[family] for r in ranks]
        if len({r["sha256"] for r in rs}) != 1:
            raise RuntimeError(f"phase 14 {family}: final digests {[r['sha256'] for r in rs]}")
        for r, res in enumerate(rs):
            for i, st in enumerate(res["steps"]):
                print(f"phase 14 {family} rank {r} step {i + 1}: " + json.dumps(
                    {k: v for k, v in st.items() if k != "launches"}) + f" [{card}]", flush=True)
            red = res["reduces"]
            print(f"phase 14 {family} rank {r} all-reduce ({len(red)} steps, "
                  f"{red[0]['bytes']} bytes each): host ms "
                  f"{[round(x['host_ms'], 3) for x in red]}, CUDA events ms "
                  f"{[round(x['event_ms'], 3) for x in red]} [{card}]", flush=True)
            print(f"phase 14 {family} rank {r} plan ms "
                  f"{[round(p['plan_ms'], 1) for p in res['plans']]}; peak "
                  f"{res['peak_gib']:.2f} GiB [{card}]", flush=True)
        r0 = rs[0]
        # rank 0's epochs with the time of its replica checks taken out
        checks = {e["epoch"]: sum(st["check_ms"] for st in r0["steps"]
                                  if st["epoch"] == e["epoch"]) / 1e3 for e in r0["epochs"]}
        summary[family] = {
            "steps": len(r0["steps"]), "launches_a_rank_a_step": r0["steps"][0]["launches"],
            "launches_a_rank": {k: sum(st["launches"][k] for st in r0["steps"])
                                for k in r0["steps"][0]["launches"]},
            "step_ms": [statistics.median(st["step_ms"] for st in r["steps"][1:]) for r in rs],
            "allreduce_host_ms": statistics.median(x["host_ms"] for r in rs
                                                   for x in r["reduces"][1:]),
            "allreduce_event_ms": statistics.median(x["event_ms"] for r in rs
                                                    for x in r["reduces"][1:]),
            "allreduce_bytes": r0["reduces"][0]["bytes"],
            "plan_ms": [statistics.mean(p["plan_ms"] for p in r["plans"]) for r in rs],
            "peak_gib": [r["peak_gib"] for r in rs],
            "frames_per_s": [e["frames_per_s"] for e in r0["epochs"]],
            "frames_per_s_without_checks": [e["frames"] / (e["s"] - checks[e["epoch"]])
                                            for e in r0["epochs"]],
            "global_batch": batch}
    # (b) the first step against the one-process emulation, twice
    for family in ("second", "centerpoint"):
        make, loader, _, _ = _dp_family(family, seed)
        item = next(iter(loader(0)))
        batch = item if family == "second" else item[0]
        emus = []
        for _ in range(2):
            tr = make(dev)
            tr.init_state(seed)
            builder = tr.make_plan_builder()
            plans = []
            for r in range(DP_WORLD):
                sub = shard_batch(item, r, DP_WORLD)
                b, extra = (sub, ()) if family == "second" else (sub[0], sub[1:])
                plans.append(builder(b.points, b.points_mask, b.gt_boxes, b.gt_labels,
                                     b.gt_mask, *extra))
            emulate_step(tr, batch, plans, 0, DP_WORLD)
            torch.cuda.synchronize()
            emus.append(_named_state(tr))
            del tr
        rank0 = torch.load(os.path.join(DP_ROOT, f"first_step_{family}.pt"), weights_only=True)

        def worst(a, b):
            w = 0.0
            for k, x in a.items():
                x, y = x.double(), b[k].double()
                w = max(w, float((x - y).abs().max()) / max(float(x.abs().max()), 1e-30))
            return w

        equal = [torch.equal(_state_bytes(rank0), _state_bytes(e)) for e in emus]
        spread, diff = worst(emus[0], emus[1]), worst(emus[0], rank0)
        if not (any(equal) or diff <= 2 * spread):
            raise RuntimeError(f"phase 14 {family}: the first step differs from the emulation "
                               f"by {diff:.3e} of scale, beyond twice the emulation runs' "
                               f"spread {spread:.3e}")
        summary[family].update(first_step_bit_equal=equal, first_step_diff=diff,
                               emulation_spread=spread)
        print(f"phase 14 {family} first step vs the one-process emulation: bit-equal to run 1 / "
              f"2: {equal}; worst |difference| / scale {diff:.3e}, two emulation runs' spread "
              f"{spread:.3e} [{card}]", flush=True)
    # one process at SECOND B=6 through the same loop, for the frames/s
    make, loader, epochs, _ = _dp_family("second", seed)
    tr = make(dev)
    res = run_training(tr, loader, work_dir=os.path.join(DP_ROOT, "one_rank"), max_epochs=epochs,
                       checkpoint_interval=1, seed=seed)
    summary["second"]["one_process_frames_per_s"] = [e["frames_per_s"] for e in res["epochs"]]
    summary["second"]["one_process_plan_ms"] = statistics.mean(p["plan_ms"] for p in res["plans"])
    del tr
    # (c) the CLI: --multihost as a group of one over NCCL, --devices 2 refused
    summary["cli_s"] = _dp_cli(card)
    shutil.rmtree(DP_ROOT, ignore_errors=True)
    summary["seconds"] = time.time() - t_phase
    for family in ("second", "centerpoint"):
        s = summary[family]
        print(f"phase 14 {family} global B={s['global_batch']} over {DP_WORLD} ranks on one card: "
              f"median step_ms {s['step_ms']} (host clock, the first step left out), all-reduce "
              f"{s['allreduce_bytes']} bytes in {s['allreduce_host_ms']:.3f} ms host / "
              f"{s['allreduce_event_ms']:.3f} ms CUDA events (median), plan {s['plan_ms']} ms a "
              f"rank, frames/s per epoch {[round(f, 3) for f in s['frames_per_s']]} "
              f"({[round(f, 3) for f in s['frames_per_s_without_checks']]} without the "
              f"replica checks), peak "
              f"{[round(g, 2) for g in s['peak_gib']]} GiB; launches a rank a step "
              f"{json.dumps(s['launches_a_rank_a_step'])} [{card}]", flush=True)
    print(f"phase 14 SECOND one process B=6: frames/s per epoch "
          f"{[round(f, 3) for f in summary['second']['one_process_frames_per_s']]}, plan "
          f"{summary['second']['one_process_plan_ms']:.1f} ms [{card}]", flush=True)
    print(f"phase 14: {summary['seconds']:.1f} s (the ranks {ranks_s:.1f} s) [{card}]",
          flush=True)
    print("phase 14 summary " + json.dumps(summary), flush=True)
    return summary


# phase 15: the convergence run (tools/convergence_run.py), the plain-block
# CenterPoint encoder (model.residual_encoder=False) and cli/train.py --amp
CONV_ENV = {"CONV_STEPS": "100", "CONV_SCAN_LEN": "50", "CONV_FREEZE_STEPS": "50"}
CONV_ROOT = os.path.join(REPO, "work_dirs", "chip_smoke_convergence")
CONV_PROFILE_STEPS = 5  # inline steps of the chunk traced for host syncs
# a sync is a host wait on the device inside the traced work: a stream
# synchronisation (a blocking copy either way makes one) or a scalar read;
# the device synchronisations are the tracing harness's own
SYNC_EVENTS = ("cudaStreamSynchronize", "aten::_local_scalar_dense", "aten::nonzero")
CP_PLAIN_CONVS = 13  # conv_input + 3 + 3 + 3 + 2 stage convs + conv_out
# a plain-block CenterPoint train step: CP_TRAIN_LAUNCHES with 13 convs and
# 13 + 5 MaskedBatchNorms (the encoder's and the adversary's)
CP_PLAIN_LAUNCHES = dict(CP_TRAIN_LAUNCHES, sparse_conv=13, sparse_conv_dgrad=13,
                         sparse_conv_wgrad=13, masked_batch_norm=18, masked_batch_norm_bwd=18,
                         bwd_reduce=18)
AMP_STEPS = 2


class StepLaunches:
    """Wraps a trainer class's train_step: per step, the launch counts it
    made (read_counts before and after, host counters only: no sync), the
    host plan builds it called (HostPlanCalls) and its loss, left on the
    device."""

    def __init__(self, cls, read_counts, host_calls=None):
        self.cls, self.read, self.host = cls, read_counts, host_calls
        self.steps = []

    def __enter__(self):
        self.orig = self.cls.train_step
        outer = self

        def train_step(trainer, *a, **kw):
            before = outer.read()
            h0 = outer.host.calls if outer.host is not None else 0
            logs = outer.orig(trainer, *a, **kw)
            after = outer.read()
            outer.steps.append({"launches": {k: after[k] - before[k] for k in after},
                                "host_builds": (outer.host.calls if outer.host is not None
                                                else 0) - h0,
                                "loss": logs["loss"]})
            return logs
        self.cls.train_step = train_step
        return self

    def __exit__(self, *exc):
        self.cls.train_step = self.orig


def hold_k1(torch, name, feats, kernel, idx, bwd_idx, mirror, g):
    """K1's forward, dgrad and wgrad on one captured conv of a train step
    against their plain versions -> the errors relative to each reference's
    largest entry; raises beyond SPARSE_CONV_RTOL / WGRAD_RTOL."""
    from robustpointclouds_tpu_torch.kernels.sparse_conv import (
        backward_kernel, sparse_conv, sparse_conv_dgrad, sparse_conv_ref, sparse_conv_wgrad,
        sparse_conv_wgrad_ref)

    w_bwd = backward_kernel(kernel, idx.shape[1], mirror)
    errs = {}
    for key, got, ref, tol in (
            ("fwd", sparse_conv(feats, kernel, idx), sparse_conv_ref(feats, kernel, idx),
             SPARSE_CONV_RTOL),
            ("dgrad", sparse_conv_dgrad(g, w_bwd, bwd_idx), sparse_conv_ref(g, w_bwd, bwd_idx),
             SPARSE_CONV_RTOL),
            ("wgrad", sparse_conv_wgrad(feats, g, idx), sparse_conv_wgrad_ref(feats, g, idx),
             WGRAD_RTOL)):
        scale = max(ref.float().abs().max().item(), 1e-6)
        err = (got.float() - ref.float()).abs().max().item() / scale
        if not (err <= tol and torch.isfinite(got).all()):
            raise RuntimeError(f"K1 {key} {name} [{feats.shape[0]}, {feats.shape[1]}] -> "
                               f"{kernel.shape[1]}: error {err} of scale")
        errs[key] = err
    return errs


def capture_step(torch, model, step):
    """Run `step()` (one train step) with hooks on `model`'s sparse convs and
    MaskedBatchNorms -> (conv inputs with their output cotangents, BN inputs
    with their call flags and output cotangents), each in call order."""
    from robustpointclouds_tpu_torch.nn.layers import MaskedBatchNorm
    from robustpointclouds_tpu_torch.nn.sparse_encoder import SparseConv3d

    convs, bns, grads, hooks = [], [], {}, []

    def capture_g(out, key):  # a forward hook that returns nothing keeps the output
        out.register_hook(lambda g: grads.__setitem__(key, g.contiguous()))

    for n, m in model.named_modules():
        if isinstance(m, SparseConv3d):
            hooks.append(m.register_forward_pre_hook(lambda mod, a, name=n: convs.append(
                (name, a[0].detach().contiguous(), mod.img2col_kernel(a[0].dtype).detach(),
                 a[1], a[2], a[3]))))
        elif isinstance(m, MaskedBatchNorm):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, a, kw, name=n: bns.append((name, a[0].detach(), a[1], mod, dict(kw))),
                with_kwargs=True))
        else:
            continue
        hooks.append(m.register_forward_hook(lambda mod, a, out, name=n: capture_g(out, name)))
    logs = step()
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    return ([(*c, grads[c[0]]) for c in convs], [(*b, grads[b[0]]) for b in bns], logs)


def hold_step(torch, convs, bns):
    """hold_k1 on every captured conv (errors of scale) and _bn_check on
    every captured BN (max errors, repeats bit-identical) -> the worst
    errors {fwd, dgrad, wgrad, bn} and the (Cin, Cout, K) widths."""
    worst = {"fwd": 0.0, "dgrad": 0.0, "wgrad": 0.0, "bn": 0.0}
    for name, feats, kernel, idx, bwd_idx, mirror, g in convs:
        for k, e in hold_k1(torch, name, feats, kernel, idx, bwd_idx, mirror, g).items():
            worst[k] = max(worst[k], e)
    for name, x, mask, mod, kw, g in bns:
        worst["bn"] = max(worst["bn"], _bn_check(
            torch, name, x.contiguous(), mask.contiguous(), mod, g, bool(kw.get("relu")),
            bool(kw.get("row_mask")), kw.get("out_dtype") or mod.dtype))
    widths = sorted({(c[1].shape[1], c[2].shape[1], c[3].shape[1]) for c in convs})
    return worst, widths


def count_syncs(torch, fn):
    """fn() under torch.profiler -> (its host-sync events by name, its
    device-to-host copies, each sync's chain of enclosing operations with
    its count)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA],
                                with_stack=True) as prof:
        fn()
        torch.cuda.synchronize()
    syncs, dtoh, where = {}, 0, {}
    for e in prof.events():
        if e.name in SYNC_EVENTS:
            syncs[e.name] = syncs.get(e.name, 0) + 1
            chain, p, top = [], e.cpu_parent, e
            while p is not None:
                chain.append(p.name)
                top, p = p, p.cpu_parent
            frames = [f for f in (top.stack or []) if "robustpointclouds_tpu_torch" in f][:2]
            key = " < ".join([e.name] + chain[:4] + frames)
            where[key] = where.get(key, 0) + 1
        if "DtoH" in e.name or "Device -> Host" in e.name:
            dtoh += 1
    return syncs, dtoh, where


def run_convergence(dev, card: str, seed: int, zero_counts, read_counts, expect_bf16_kernels):
    """Phase 15: (a) the convergence tool at full width and reduced depth,
    (b) a plain-block CenterPoint B=4 train step and serve, (c) cli/train.py
    --amp (module docstring). Returns the launches for the kernels line."""
    import numpy as np
    import torch

    from robustpointclouds_tpu_torch.cli import common
    from robustpointclouds_tpu_torch.cli import train as train_cli
    from robustpointclouds_tpu_torch.cli.export import export_serving
    from robustpointclouds_tpu_torch.data.nuscenes import synthetic_nuscenes_batch
    from robustpointclouds_tpu_torch.models.centerpoint import CenterPointConfig
    from robustpointclouds_tpu_torch.models.voxelnet import VoxelNetConfig
    from robustpointclouds_tpu_torch.tools import convergence_run as conv
    from robustpointclouds_tpu_torch.train.centerpoint_loop import CenterPointTrainer
    from robustpointclouds_tpu_torch.train.checkpoint import CheckpointManager
    from robustpointclouds_tpu_torch.train.loop import TrainConfig, Trainer

    t_phase = time.time()
    out = {}
    # (a) one inline step's K1 / K2 held against their plain versions
    tr = Trainer(VoxelNetConfig(), TrainConfig(), device=dev)
    tr.init_state(seed)
    scene = conv.to_device(conv.make_scenes(tr.model_cfg, 6, 20000, [100])[0], dev)
    convs, bns, logs = capture_step(torch, tr.model, lambda: tr.train_step(scene, 3.0))
    if len(convs) != 12 or len(bns) != 17:
        raise RuntimeError(f"phase 15 (a): the inline step ran {len(convs)} convs, {len(bns)} BNs")
    worst, _ = hold_step(torch, convs, bns)
    del convs, bns, tr
    print(f"phase 15 (a) inline train step B=6 full width, loss {float(logs['loss']):.4f}: K1 "
          f"fwd / dgrad / wgrad (errors of scale) and the 17 fused BNs (max errors, repeats "
          f"bit-identical) against their plain versions, worst {json.dumps(worst)} [{card}]",
          flush=True)

    # the tool through its entry point, every train step's launches read
    shutil.rmtree(CONV_ROOT, ignore_errors=True)
    saved_env = {k: os.environ.get(k) for k in CONV_ENV}
    os.environ.update(CONV_ENV)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.time()
    try:
        with HostPlanCalls() as hp, StepLaunches(Trainer, read_counts, hp) as sl:
            res = conv.main(["--work-dir", CONV_ROOT])
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    tool_s = time.time() - t0
    launches = read_counts()
    expect_bf16_kernels("convergence")
    n_steps = int(CONV_ENV["CONV_STEPS"]) + int(CONV_ENV["CONV_FREEZE_STEPS"])
    if len(sl.steps) != n_steps:
        raise RuntimeError(f"phase 15 (a): {len(sl.steps)} train steps, expected {n_steps}")
    kinds = {}
    for st in sl.steps:
        key = json.dumps(st["launches"], sort_keys=True)
        kinds[key] = kinds.get(key, 0) + 1
        if any(st["launches"][k] != TRAIN_LAUNCHES[k] for k in (
                "sparse_conv", "sparse_conv_dgrad", "sparse_conv_wgrad", "masked_batch_norm",
                "masked_batch_norm_bwd")) or st["host_builds"]:
            raise RuntimeError(f"phase 15 (a): a train step launched {st['launches']} with "
                               f"{st['host_builds']} host plan builds")
    summary, recs, drecs = res["summary"], res["records"], res["device"]
    for k in ("sparse_conv", "masked_batch_norm", "masked_stats"):
        if not launches[k]:
            raise RuntimeError(f"phase 15 (a): {k} never launched: {launches}")
    if not all(np.isfinite(r["loss"]) and r["nan_steps"] == 0 for r in recs) or \
            summary["final_train_step"] != int(CONV_ENV["CONV_FREEZE_STEPS"]):
        raise RuntimeError(f"phase 15 (a): records {recs}, summary {summary}")
    with open(os.path.join(CONV_ROOT, "summary.json")) as f:
        if json.load(f) != summary:
            raise RuntimeError("phase 15 (a): summary.json differs from the returned summary")
    steps_per_s = int(CONV_ENV["CONV_STEPS"]) / summary["wall_s"]
    print(f"phase 15 (a) convergence_run {json.dumps(CONV_ENV)} B=6 full width: {tool_s:.1f} s "
          f"through main; phase 1 {summary['wall_s']} s, {steps_per_s:.3f} steps/s, "
          f"{summary['frames_per_sec']} frames/s; chunk losses "
          f"{[r['loss'] for r in recs]}; per chunk peak / end GiB "
          f"{[(round(d['peak_gib'], 3), round(d['alloc_gib'], 3)) for d in drecs]}; "
          f"mean AP clean {summary['mean_ap_clean']} attack {summary['mean_ap_attack']} "
          f"(before {summary['ap_before_3d_moderate']}) [{card}]", flush=True)
    print(f"phase 15 (a) launches a train step over {n_steps} inline steps (phase 1 and the "
          f"freeze phase), no host plan build in any: "
          + "; ".join(f"{n} steps {k}" for k, n in kinds.items()) + f"; all launches of the run, "
          f"evaluations included: {json.dumps(launches)}", flush=True)
    # one chunk of the loop traced: the one read at its end is the only sync
    trainer, scenes = res["trainer"], res["scenes"]
    torch.cuda.synchronize()
    with HostPlanCalls() as hp:
        syncs, dtoh, where = count_syncs(torch, lambda: conv.run_chunk(
            trainer, scenes, conv.FREEZE_EPOCH, 0, CONV_PROFILE_STEPS))
    n_sync = sum(syncs.values())
    print(f"phase 15 (a) one chunk of {CONV_PROFILE_STEPS} inline steps under torch.profiler: "
          f"host syncs {json.dumps(syncs)} ({json.dumps(where)}), device-to-host copies "
          f"{dtoh}, host plan builds {hp.calls} [{card}]", flush=True)
    if hp.calls or dtoh > 1 or n_sync > 1:
        raise RuntimeError(f"phase 15 (a): the train loop syncs {syncs}, copies {dtoh} to the "
                           f"host and builds {hp.calls} host plans a chunk")
    out["convergence"] = dict(sl.steps[-1]["launches"], steps=n_steps,
                              steps_per_s=steps_per_s, syncs=syncs, dtoh=dtoh)
    del res, trainer, scenes
    shutil.rmtree(CONV_ROOT, ignore_errors=True)

    # (b) the plain-block CenterPoint encoder at full width, B=4
    cfg = CenterPointConfig(residual_encoder=False)
    pcr = cfg.voxelizer.point_cloud_range
    b, vel = synthetic_nuscenes_batch(np.random.RandomState(seed + 15), batch_size=CP_BATCH,
                                      num_points=CP_POINTS, max_gt=cfg.head.max_objs,
                                      point_range=pcr)
    cpt = CenterPointTrainer(cfg, device=dev)
    cpt.init_state(seed)
    plan = cpt.make_plan_builder()(b.points, b.points_mask, b.gt_boxes, b.gt_labels, b.gt_mask,
                                   vel)
    torch.cuda.synchronize()
    zero_counts()
    convs, bns, logs = capture_step(torch, cpt.model, lambda: cpt.train_step(b, 3, plan,
                                                                            gt_vel=vel))
    cp_launches = read_counts()
    expect_bf16_kernels("plain-block CenterPoint training")
    if cp_launches != CP_PLAIN_LAUNCHES or len(convs) != CP_PLAIN_CONVS:
        raise RuntimeError(f"phase 15 (b): plain-block step launches {cp_launches}, "
                           f"{len(convs)} convs; expected {CP_PLAIN_LAUNCHES}")
    if not all(np.isfinite(float(v)) for v in logs.values()):
        raise RuntimeError(f"phase 15 (b): non-finite logs {logs}")
    worst, widths = hold_step(torch, convs, bns)
    del convs, bns
    print(f"phase 15 (b) plain-block CenterPoint B={CP_BATCH} train step, loss "
          f"{float(logs['loss']):.4f}, {int(plan['voxel_mask'].sum())} voxels: launches "
          f"{json.dumps(cp_launches)}; (Cin, Cout, K) {widths}; K1 fwd / dgrad / wgrad and "
          f"the 18 fused BNs against their plain versions, worst errors (K1 of scale, BN "
          f"max) {json.dumps(worst)}; peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB "
          f"[{card}]", flush=True)
    serve = export_serving(cpt.model, None, None, cfg.head, device=dev)
    pts, msk = b.points, b.points_mask
    serve(pts, msk)  # warm-up
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    boxes, scores, labels, valid = serve(pts, msk)
    torch.cuda.synchronize()
    serve_ms = (time.perf_counter() - t0) * 1e3
    serve_launches = read_counts()
    if serve_launches["sparse_conv"] != CP_PLAIN_CONVS or serve_launches[
            "masked_batch_norm"] != CP_PLAIN_CONVS or not (
            torch.isfinite(boxes).all() and torch.isfinite(scores).all()) or boxes.shape[-1] != 9:
        raise RuntimeError(f"phase 15 (b): serve launches {serve_launches}, boxes "
                           f"{tuple(boxes.shape)}")
    print(f"phase 15 (b) plain-block CenterPoint serve B={CP_BATCH} (plan built on the card): "
          f"{serve_ms:.1f} ms, {int(valid.sum())} detections, launches "
          f"{json.dumps(serve_launches)} [{card}]", flush=True)
    out["centerpoint_plain"] = {"train_step": cp_launches, "serve": serve_launches}
    del cpt, serve

    # (c) cli/train.py --amp: the precision set while it trains, restored after
    amp_dir = os.path.join(REPO, "work_dirs", "chip_smoke_amp")
    shutil.rmtree(amp_dir, ignore_errors=True)
    before = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    precision = []
    real_run = common.run_training

    def recording(*a, **kw):
        precision.append((torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32))
        return real_run(*a, **kw)

    common.run_training = recording
    zero_counts()
    t0 = time.time()
    try:
        with StepLaunches(Trainer, read_counts) as sl:
            res = train_cli.main([SECOND_CONFIG, "--amp", "--synthetic", "--steps-per-epoch",
                                  str(AMP_STEPS), "--work-dir", amp_dir, "--cfg-options",
                                  "max_epochs=1"])
    finally:
        common.run_training = real_run
    amp_s = time.time() - t0
    after = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    losses = [float(st["loss"]) for st in sl.steps]
    if precision != [("medium", True)] or after != before or len(sl.steps) != AMP_STEPS or any(
            st["launches"] != TRAIN_LAUNCHES for st in sl.steps) or not np.isfinite(
            losses).all() or CheckpointManager(res["work_dir"]).epochs() != [0]:
        raise RuntimeError(f"phase 15 (c): precision during {precision}, before {before}, after "
                           f"{after}; steps {sl.steps}; {os.listdir(amp_dir)}")
    print(f"phase 15 (c) cli/train.py --amp, {AMP_STEPS} steps B=6: {amp_s:.1f} s, precision "
          f"{precision[0]} while it ran, {after} after; launches a step "
          f"{json.dumps(sl.steps[0]['launches'])}; losses {losses} [{card}]", flush=True)
    shutil.rmtree(amp_dir, ignore_errors=True)
    print(f"phase 15: {time.time() - t_phase:.1f} s [{card}]", flush=True)
    return out


# ---- phase 16: the JAX package's env-gated variants (run_variants)

VR_EPOCH = 3  # every family's adversary is on from epoch 3
VR_TURN_STEPS = 2  # bf16 steps a turn when the two adversary forms are timed (p, c, c, p)
VR_STAGE_ITERS = 10  # calls a profile of the adversary stage
VR_DIAG_STEPS = 3  # tools/diag_centerpoint_nan's DIAG_STEPS here
VR_CHILD_STEPS = 2  # train steps of the child process that sets the gates in its environment
# compact vs padded in float32 at full width (compute_dtype float32, the
# adversary float32): the same multiset of rows summed in another order.
# Losses within VR_LOG_RTOL (the CPU test's bounds from the JAX package's
# own compact test: 1e-4 / 2e-4); head outputs of the attack forward within
# E2E_F32_RTOL of their largest; each gradient tensor's largest entry gap
# within VR_GRAD_RTOL of its largest entry and its difference's norm within
# VR_GRAD_RTOL of its norm (TRAIN_GRAD_FLOOR of the model's largest where
# smaller). The worst tensors are BatchNorm biases, sums of a cotangent
# that nearly cancels over 10^5-10^6 positions, where the reordered rows'
# float32 rounding shows most (measured on the H100: 6.3e-3 of the largest
# entry, 4.5e-3 in norm; losses 6.9e-7, head outputs 0 to 4.4e-6)
VR_LOG_RTOL = 2e-4
VR_GRAD_RTOL = 1e-2
# the full-width bf16 SECOND step in the bfloat16-read mode beside the
# float32-read step from one state and plan: other roundings in 17 BNs,
# grown through the depth (tests/test_torch_bf16_parity.py: a module
# group's bf16 gradient keeps a cosine of 0.53-0.96 with its float32 one).
# Losses within VR_LOWP_LOSS_RTOL (measured 8.5e-3), the whole gradient's
# cosine with the float32-read one at least VR_LOWP_COS
VR_LOWP_LOSS_RTOL = 5e-2
VR_LOWP_COS = 0.5
# the env child: the four gates set in the environment, as a user sets them;
# the port reads two (RPC_DENSE_GATHER and RPC_FPN_D2S are held by tests)
VR_CHILD_ENV = {"RPC_COMPACT_PERT": "1", "RPC_DENSE_GATHER": "1", "RPC_BN_BF16_STATS": "1",
                "RPC_FPN_D2S": "1"}
# K2 launches of a full-width bf16 SECOND train step in the bfloat16-read
# mode, by kernel: its 17 bf16 BNs (the adversary's 5, the encoder's 12)
# take the mode (2 statistics launches and 1 apply each); the perturber's
# float32 statistics (std normalisation, regulariser) do not
VR_LOWP_LAUNCHES = {"stats_kernel_lowp": 34, "apply_kernel_lowp": 17, "stats_kernel": 2,
                    "apply_kernel": 0, "bwd_reduce_kernel": 17, "dx_kernel": 17,
                    "vjp_kernel": 1}

_VR_CHILD = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from robustpointclouds_tpu_torch.data.synthetic import synthetic_kitti_batch
from robustpointclouds_tpu_torch.kernels import masked_stats as ms
from robustpointclouds_tpu_torch.models import voxelnet as vx
from robustpointclouds_tpu_torch.nn import layers
from robustpointclouds_tpu_torch.train.loop import TrainConfig, Trainer

seed, steps = int(sys.argv[2]), int(sys.argv[3])
gates = {"RPC_COMPACT_PERT": vx.COMPACT_PERT, "RPC_BN_BF16_STATS": layers.BN_BF16_STATS}
calls = {"adversary_rows": []}
cfg = vx.VoxelNetConfig()
tr = Trainer(cfg, TrainConfig(), device="cuda")
tr.init_state(seed)
tr.model.adversary.register_forward_pre_hook(
    lambda m, a: calls["adversary_rows"].append(int(a[0].shape[0])))
rng = np.random.RandomState(seed + 160)
builder = tr.make_plan_builder()
out = []
for i in range(steps):
    b = synthetic_kitti_batch(rng, batch_size=6, num_points=20000, max_gt=20, num_objects=8,
                              point_range=cfg.voxelizer.point_cloud_range)
    plan = builder(b.points, b.points_mask, b.gt_boxes, b.gt_labels, b.gt_mask)
    ms.KERNEL_LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logs = {k: float(v) for k, v in tr.train_step(b, 3, plan).items()}
    torch.cuda.synchronize()
    launches = {}
    for (k, c), n in ms.KERNEL_LAUNCHES.items():
        launches[k] = launches.get(k, 0) + n
    out.append({"step_ms": (time.perf_counter() - t0) * 1e3, "loss": logs["loss"],
                "l2": logs["perturbation_l2_norm"], "finite": bool(np.isfinite(
                    list(logs.values())).all()), "launches": launches})
att = tr.forward_eval(plan, attack=True, batch=b)
print(json.dumps({"gates": gates, "calls": calls, "steps": out,
                  "attack_finite": bool(torch.isfinite(att.cls_scores).all())}))
"""


def _grad_gap(got, ref, top: int = 3):
    """How far two gradient dicts are apart, each tensor against its own
    reference: the largest entry's gap over the tensor's largest entry
    (TRAIN_GRAD_FLOOR of the model's largest where smaller), and the norm of
    the difference over the tensor's norm (the same floor); each with the
    `top` worst tensors. A NaN gap is the worst."""
    gmax = max(v.abs().max().item() for v in ref.values())
    nmax = max(v.float().norm().item() for v in ref.values())
    entry, norm = [], []
    for k, r in ref.items():
        d = got[k].float() - r.float()
        scale = max(r.abs().max().item(), TRAIN_GRAD_FLOOR * gmax / TRAIN_GRAD_RTOL)
        nscale = max(r.float().norm().item(), TRAIN_GRAD_FLOOR * nmax / TRAIN_GRAD_RTOL)
        entry.append((d.abs().max().item() / scale, k))
        norm.append((d.norm().item() / nscale, k))

    def worst(v):
        v.sort(key=lambda t: -t[0] if t[0] == t[0] else -float("inf"))
        nan = [t for t in v if t[0] != t[0]]
        return nan + [t for t in v if t[0] == t[0]]
    entry, norm = worst(entry)[:top], worst(norm)[:top]
    return {"entry": entry[0][0], "entry_worst": entry, "norm": norm[0][0], "norm_worst": norm}


def _out_gap(a, b):
    """The largest gap of two head outputs over the reference's largest entry."""
    import torch

    ta = [t for t in (a if isinstance(a, (list, tuple)) else [a]) if isinstance(t, torch.Tensor)]
    tb = [t for t in (b if isinstance(b, (list, tuple)) else [b]) if isinstance(t, torch.Tensor)]
    return max((x.float() - y.float()).abs().max().item() / max(y.float().abs().max().item(),
                                                                 1e-6) for x, y in zip(ta, tb))


def _heads(out):
    """The head tensors of a family's outputs (anchor heads: cls, bbox, dir;
    CenterPoint: every task's maps)."""
    if hasattr(out, "task_preds"):
        return [t for task in out.task_preds for t in task.values()]
    return list(out[:3])


def run_variants(dev, card: str, seed: int, zero_counts, read_counts, expect_bf16_kernels):
    """Phase 16: the JAX package's env-gated variants on the card (module
    docstring). Returns the kernels line's rows of this phase."""
    import numpy as np
    import torch

    import robustpointclouds_tpu_torch.nn.perturber as perturber
    from robustpointclouds_tpu_torch.data.nuscenes import synthetic_nuscenes_batch
    from robustpointclouds_tpu_torch.data.synthetic import PointCloudBatch, synthetic_kitti_batch
    from robustpointclouds_tpu_torch.kernels.masked_stats import (
        KERNEL_LAUNCHES, KERNEL_ROW_LAUNCHES, masked_batch_norm)
    from robustpointclouds_tpu_torch.models import centerpoint as mcp
    from robustpointclouds_tpu_torch.models import pointpillars as mpp
    from robustpointclouds_tpu_torch.models import voxelnet as mvn
    from robustpointclouds_tpu_torch.nn import layers, sparse_encoder
    from robustpointclouds_tpu_torch.nn.layers import MaskedBatchNorm
    from robustpointclouds_tpu_torch.ops import sparse
    from robustpointclouds_tpu_torch.tools import diag_centerpoint_nan
    from robustpointclouds_tpu_torch.tools.probe_gather import device_ms
    from robustpointclouds_tpu_torch.train.centerpoint_loop import CenterPointTrainer
    from robustpointclouds_tpu_torch.train.loop import TrainConfig, Trainer

    t_phase = time.time()
    rng = np.random.RandomState(seed + 16)
    rows = []
    problems = []  # every failed check, raised together at the end of the phase

    def kitti(cfg):
        b = synthetic_kitti_batch(rng, batch_size=IN_BATCH, num_points=IN_POINTS, max_gt=20,
                                  num_objects=8, point_range=cfg.voxelizer.point_cloud_range)
        return PointCloudBatch(*(np.asarray(x) for x in b)), None

    def nus(cfg):
        b, vel = synthetic_nuscenes_batch(rng, batch_size=CP_BATCH, num_points=CP_POINTS,
                                          max_gt=cfg.head.max_objs,
                                          point_range=cfg.voxelizer.point_cloud_range)
        return PointCloudBatch(*(np.asarray(x) for x in b)), np.asarray(vel)

    def trainer_of(cfg):
        if isinstance(cfg, mcp.CenterPointConfig):
            return CenterPointTrainer(cfg, device=dev)
        return Trainer(cfg, TrainConfig(), device=dev)

    def host_plan(tr, b, vel):
        args = (b.points, b.points_mask, b.gt_boxes, b.gt_labels, b.gt_mask)
        return tr.make_plan_builder()(*args, *(() if vel is None else (vel,)))

    def card_plan(cfg, b, vel):
        """The plan the inline step builds, on the card (the anchor
        assignment left to the loss, as the inline step leaves it)."""
        p, m = torch.as_tensor(b.points, device=dev), torch.as_tensor(b.points_mask, device=dev)
        if isinstance(cfg, mcp.CenterPointConfig):
            return mcp.build_centerpoint_plan(p, m, cfg, b.gt_boxes, b.gt_labels, b.gt_mask, vel)
        if isinstance(cfg, mpp.PointPillarsConfig):
            return mpp.build_pillar_plan(p, m, cfg)
        return mvn.build_plan(p, m, cfg.voxelizer)

    def step(tr, b, vel, plan):
        return tr.train_step(b, VR_EPOCH, plan, **({} if vel is None else {"gt_vel": vel}))

    def grads_of(tr):
        return {k: p.grad.detach().clone() for k, p in tr.model.named_parameters()}

    families = {"second": (mvn.VoxelNetConfig(), kitti),
                "pointpillars": (mpp.PointPillarsConfig(), kitti),
                "centerpoint": (mcp.CenterPointConfig(), nus)}

    # (a) the compact adversary, each family
    compact = {}
    for fam, (cfg, frames) in families.items():
        b, vel = frames(cfg)
        res = compact[fam] = {"points": int(b.points_mask.sum()),
                              "rows_compact": b.points.shape[0] * b.points.shape[1]}
        # float32: compact vs padded from one state on one host plan
        cfg32 = cfg._replace(compute_dtype="float32")
        perturber.PERT_BF16 = False
        tr = trainer_of(cfg32)
        tr.init_state(seed)
        sd = {k: v.clone() for k, v in tr.model.state_dict().items()}
        plan = host_plan(tr, b, vel)
        res["rows_padded"] = int(np.prod(plan["point_mask"].shape))
        res["kept"] = int(plan["point_mask"].sum())
        got = {}
        for form in (False, True):
            mvn.COMPACT_PERT = form
            tr.init_state(state_dict=sd)
            logs = {k: float(v) for k, v in step(tr, b, vel, plan).items()}
            g = grads_of(tr)
            tr.model.load_state_dict(sd)
            out = _heads(tr.forward_eval(plan, attack=True, batch=b))
            got[form] = (logs, g, out)
        mvn.COMPACT_PERT = False
        perturber.PERT_BF16 = True
        (l0, g0, o0), (l1, g1, o1) = got[False], got[True]
        log_gap = max(abs(l1[k] - l0[k]) / max(abs(l0[k]), 1e-6) for k in l0)
        grad_gap = _grad_gap(g1, g0)
        out_gap = max(_out_gap(x, y) for x, y in zip(o1, o0))
        res.update(float32_log_gap=log_gap, log_tol=VR_LOG_RTOL, float32_grad_gap=grad_gap,
                   grad_tol=VR_GRAD_RTOL,
                   float32_attack_out_gap=out_gap, out_tol=E2E_F32_RTOL)
        if not (log_gap <= VR_LOG_RTOL and grad_gap["entry"] <= VR_GRAD_RTOL
                and grad_gap["norm"] <= VR_GRAD_RTOL
                and out_gap <= E2E_F32_RTOL) or l1["perturbation_l2_norm"] <= 0:
            problems.append(f"phase 16 (a) {fam}: compact vs padded in float32: {res}")
        del tr, got, g0, g1

        # bf16, the main path: the adversary stage alone, then steps in turns
        tr = trainer_of(cfg)
        tr.init_state(seed)
        sd = {k: v.clone() for k, v in tr.model.state_dict().items()}
        plan_t = mvn.plan_to_device(host_plan(tr, b, vel), dev)
        pts = torch.as_tensor(b.points, dtype=torch.float32, device=dev)
        adv = tr.model.adversary
        tr.model.train()
        bn_rows = []
        hooks = [m.register_forward_pre_hook(lambda m, a: bn_rows.append(int(a[0].shape[0])))
                 for m in adv.modules() if isinstance(m, MaskedBatchNorm)]
        gout = torch.randn(plan_t["voxels"].shape, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(seed))
        params = [p for p in adv.parameters()]

        def stage():
            out, aux = mvn.apply_voxel_adversary(adv, pts, plan_t["voxels"], plan_t, False,
                                                 VR_EPOCH, cfg.adversary_start_epoch, -1.0)
            loss = (out * gout).sum() + sum(aux.values())
            return torch.autograd.grad(loss, params, allow_unused=True)

        for form in (False, True):
            mvn.COMPACT_PERT = form
            tag = "compact" if form else "padded"
            zero_counts()
            bn_rows.clear()
            stage()
            torch.cuda.synchronize()
            k2 = {}
            for (k, c), n in KERNEL_LAUNCHES.items():
                k2[f"{k}@{c}"] = n
            res[f"{tag}_stage_k2_launches"] = k2
            res[f"{tag}_stage_bn_rows"] = sorted(set(bn_rows))
            res[f"{tag}_stage_ms"] = cuda_ms(stage, iters=VR_STAGE_ITERS, warmup=1)
            res[f"{tag}_stage_device_ms"] = device_ms(stage, VR_STAGE_ITERS)
        for h in hooks:
            h.remove()
        rows_want = {False: res["rows_padded"], True: res["rows_compact"]}
        for form, tag in ((False, "padded"), (True, "compact")):
            if res[f"{tag}_stage_bn_rows"] != [rows_want[form]]:
                problems.append(f"phase 16 (a) {fam} {tag}: the adversary's BNs ran at rows "
                                   f"{res[f'{tag}_stage_bn_rows']}, expected {rows_want[form]}")
        # train steps in turns: padded, compact, compact, padded
        times = {False: [], True: []}
        for form in (False, True, True, False):
            mvn.COMPACT_PERT = form
            for _ in range(VR_TURN_STEPS):
                _, ms_, _ = _timed(lambda: {k: float(v) for k, v in step(tr, b, vel, plan_t)
                                            .items()}, False)
                times[form].append(ms_)
        res["padded_step_ms"] = statistics.median(times[False])
        res["compact_step_ms"] = statistics.median(times[True])
        # one compact train step's K2 launches at the compact row count: the
        # adversary stage's, where no other BN of the family runs at those rows
        mvn.COMPACT_PERT = True
        zero_counts()
        step(tr, b, vel, plan_t)
        torch.cuda.synchronize()
        at_rows = {}
        for (k, c, n), cnt in KERNEL_ROW_LAUNCHES.items():
            if n == res["rows_compact"]:
                at_rows[f"{k}@{c}"] = cnt
        mvn.COMPACT_PERT = False
        res["compact_step_k2_launches_at_rows"] = at_rows
        if fam == "pointpillars" and at_rows != res["compact_stage_k2_launches"]:
            problems.append(f"phase 16 (a) {fam}: the compact step's K2 launches at "
                            f"{res['rows_compact']} rows {at_rows} are not the adversary "
                            f"stage's {res['compact_stage_k2_launches']}")
        # plan-fed compact vs inline compact from one state: bit for bit
        mvn.COMPACT_PERT = True
        cplan = card_plan(cfg, b, vel)
        out = []
        for plan_in in (cplan, None, None):
            tr.init_state(state_dict=sd)
            logs = step(tr, b, vel, plan_in)
            out.append((logs, grads_of(tr), {k: v.clone() for k, v in
                                             tr.model.state_dict().items()}))
        mvn.COMPACT_PERT = False
        res["inline_repeat_bitwise"] = outputs_equal(out[1], out[2])
        res["plan_fed_vs_inline_bitwise"] = outputs_equal(out[0], out[1])
        if not res["plan_fed_vs_inline_bitwise"]:
            problems.append(f"phase 16 (a) {fam}: the plan-fed compact step is not bit-equal "
                               f"to the inline compact step (inline repeat bit-equal: "
                               f"{res['inline_repeat_bitwise']})")
        expect_bf16_kernels(f"phase 16 {fam} compact")
        print(f"phase 16 (a) {fam} compact adversary: " + json.dumps(res) + f" [{card}]",
              flush=True)
        del tr, out, plan_t, cplan

    # the pillar adversary's K2 at the compact rows (a real kept-point count)
    pp_cfg = families["pointpillars"][0]
    n_c = compact["pointpillars"]["rows_compact"]
    gen = torch.Generator(device=dev).manual_seed(seed + 16)
    x4 = torch.randn(n_c, 4, device=dev, generator=gen) * 3 + 1
    keep = torch.rand(n_c, device=dev, generator=gen) < (
        compact["pointpillars"]["kept"] / n_c)
    pp_stats = stats_case(torch, x4, keep)
    widths = list(pp_cfg.adversary["hidden_channels"])
    widths = widths + widths[-2::-1]
    pp_bn = []
    for c in sorted(set(widths)):
        x = (torch.randn(n_c, c, device=dev, generator=gen) * 3 + 1).to(torch.bfloat16)
        w = 0.5 + torch.rand(c, device=dev, generator=gen)
        bb = torch.randn(c, device=dev, generator=gen)
        rm = torch.randn(c, device=dev, generator=gen)
        rv = 0.5 + torch.rand(c, device=dev, generator=gen)
        g = torch.randn(n_c, c, device=dev, generator=gen).to(torch.bfloat16)
        pp_bn += bn_case(torch, "pillar adversary compact", widths.count(c), x, keep, w, bb, rm,
                         rv, g, True, True, False, None)
    for r in (pp_stats, *pp_bn):
        print("phase 16 (a) pointpillars compact K2 " + json.dumps(r) + f" [{card}]", flush=True)

    # (b) the JAX package's gather-form densify, which the port holds by
    # tests and does not run (ops/sparse.py): SECOND's conv_out rows
    # (RPC_DENSE_GATHER) and the pillar BEV (JAX's plan-fed default),
    # replayed here beside the port's scatter on the same rows
    second_cfg = families["second"][0]
    sb, _ = kitti(second_cfg)
    pb, _ = kitti(pp_cfg)
    st = card_plan(second_cfg, sb, None)["enc"]["out"]
    shape = (IN_BATCH,) + tuple(second_cfg.voxelizer.sparse_shape)
    for i in range(1, 4):
        shape = sparse_encoder._down_shape(shape, *sparse_encoder._down_geom(4, i))
    shape = sparse_encoder._down_shape(shape, *sparse_encoder._OUT_GEOM)
    pplan = card_plan(pp_cfg, pb, None)
    nx, ny, _ = pp_cfg.voxelizer.grid_size
    dens = {}
    for name, grid, c in (
            ("second conv_out", sparse.SparseGrid(st["ids"], st["coords"], st["mask"], shape), 128),
            ("pillar BEV", sparse.SparseGrid(pplan["grid_ids"], pplan["grid_coords"],
                                             pplan["grid_mask"], (IN_BATCH, ny, nx)),
             pp_cfg.pfn_channels)):
        n = grid.flat_ids.shape[0]
        size = int(np.prod(grid.spatial_shape))
        # JAX's dense_gather_map: each cell's row (n where empty); each row's cell
        pos = torch.where(grid.mask, grid.flat_ids.long(), torch.full_like(grid.flat_ids.long(),
                                                                           size))
        dmap = torch.full((size + 1,), n, dtype=torch.long, device=dev)
        dmap[pos] = torch.arange(n, device=dev)
        dmap = dmap[:size]
        f = torch.randn(n, c, device=dev, generator=gen).to(torch.bfloat16)
        g = torch.randn(grid.spatial_shape + (c,), device=dev, generator=gen).to(torch.bfloat16)
        zero = f.new_zeros((1, c))

        def gather_fwd(x):
            return torch.cat([x, zero]).index_select(0, dmap).reshape(g.shape)

        def gather_bwd(gg):
            return torch.cat([gg.reshape(size, c), zero]).index_select(0, pos)

        def scatter_fwd_bwd():
            xx = f.detach().requires_grad_(True)
            return torch.autograd.grad(sparse.scatter_to_dense(xx, grid), xx, g)

        y_s = sparse.scatter_to_dense(f, grid)
        (dx_s,) = scatter_fwd_bwd()
        ok = torch.equal(y_s, gather_fwd(f)) and torch.equal(dx_s, gather_bwd(g))
        dens[name] = {"rows": n, "c": c, "cells": size, "bitwise": ok,
                      "scatter_fwd_device_ms": device_ms(lambda: sparse.scatter_to_dense(f, grid),
                                                         10),
                      "gather_fwd_device_ms": device_ms(lambda: gather_fwd(f), 10),
                      "scatter_fwd_bwd_device_ms": device_ms(scatter_fwd_bwd, 10),
                      "gather_fwd_bwd_device_ms": device_ms(lambda: (gather_fwd(f), gather_bwd(g)),
                                                            10)}
        if not ok:
            problems.append(f"phase 16 (b) {name}: the gather form differs from the scatter")
        print(f"phase 16 (b) densify {name}, the port's scatter vs JAX's gather form: "
              + json.dumps(dens[name]) + f" [{card}]", flush=True)
        del dmap, pos, f, g, y_s, dx_s

    # (c) K2's bfloat16-read mode at every bf16 BN shape of a SECOND step and the PFN's
    def f32_read(a, m, w, b_, r1, r2, train, relu, row_mask, dt):
        return masked_batch_norm(a, m, w, b_, r1, r2, train, 0.1, relu=relu, row_mask=row_mask,
                                 out_dtype=dt)
    lowp_rows = []
    for name, n, c, count in BN_TRAIN_SHAPES + [("pfn", PP_BATCH * 16000 * 32, 64, 1)]:
        x = (torch.randn(n, c, device=dev, generator=gen) * 3 + 1).to(torch.bfloat16)
        mask = torch.rand(n, device=dev, generator=gen) > 0.75
        w = 0.5 + torch.rand(c, device=dev, generator=gen)
        bb = torch.randn(c, device=dev, generator=gen)
        rm = torch.randn(c, device=dev, generator=gen)
        rv = 0.5 + torch.rand(c, device=dev, generator=gen)
        g = torch.randn(n, c, device=dev, generator=gen).to(torch.bfloat16)
        lowp_rows += bn_case(torch, name, count if name != "pfn" else 0, x, mask, w, bb, rm, rv,
                             g, True, True, name == "encoder", f32_read,
                             momentum=0.01 if name == "pfn" else 0.1, lowp=True)
        del x, mask, g
    for r in lowp_rows:
        print("phase 16 (c) masked_batch_norm lowp " + json.dumps(r) + f" [{card}]", flush=True)
    lowp_tot = {k: bn_step_total(lowp_rows, k) for k in ("masked_batch_norm",
                                                          "masked_batch_norm_bwd")}
    for k, tot in lowp_tot.items():
        print(f"phase 16 (c) {k} lowp over the 17 BNs of a train step: {tot['ms']:.4f} ms "
              f"(device {_fmt(tot['device_ms'])}), the float32-read mode on the same inputs "
              f"{tot['prev_ms']:.4f} ms (device {_fmt(tot['prev_device_ms'])}), bound "
              f"{tot['bound_ms']:.4f} ms [{card}]", flush=True)
    # a full-width SECOND step with the mode on against the float32-read step
    tr = Trainer(second_cfg, TrainConfig(), device=dev)
    tr.init_state(seed)
    sd = {k: v.clone() for k, v in tr.model.state_dict().items()}
    splan_h = host_plan(tr, sb, None)
    got = {}
    for mode in (False, True):
        layers.BN_BF16_STATS = mode
        tr.init_state(state_dict=sd)
        zero_counts()
        logs = {k: float(v) for k, v in step(tr, sb, None, splan_h).items()}
        launches = {}
        for (k, c), n in KERNEL_LAUNCHES.items():
            launches[k] = launches.get(k, 0) + n
        got[mode] = (logs, grads_of(tr), launches)
    layers.BN_BF16_STATS = False
    (l0, g0, _), (l1, g1, lowp_launches) = got[False], got[True]
    want = {k: v for k, v in VR_LOWP_LAUNCHES.items() if v}
    if lowp_launches != want:
        problems.append(f"phase 16 (c) lowp step K2 launches {lowp_launches}, expected {want}")
    flat0 = torch.cat([v.float().reshape(-1) for v in g0.values()])
    flat1 = torch.cat([g1[k].float().reshape(-1) for k in g0])
    lowp_gap = {"loss_gap": abs(l1["loss"] - l0["loss"]) / abs(l0["loss"]),
                "loss_tol": VR_LOWP_LOSS_RTOL,
                "log_gap": max(abs(l1[k] - l0[k]) / max(abs(l0[k]), 1e-6) for k in l0),
                "grad_cos": float(torch.nn.functional.cosine_similarity(flat0, flat1, dim=0)),
                "grad_cos_min": VR_LOWP_COS,
                "grad_norm_ratio": float(flat1.norm() / flat0.norm()),
                "grad_gap": _grad_gap(g1, g0),
                "finite": bool(np.isfinite(list(l1.values())).all()),
                "loss": [l1["loss"], l0["loss"]], "launches": lowp_launches}
    if not (lowp_gap["finite"] and lowp_gap["loss_gap"] <= VR_LOWP_LOSS_RTOL
            and lowp_gap["grad_cos"] >= VR_LOWP_COS):
        problems.append(f"phase 16 (c) lowp step: {lowp_gap}")
    print("phase 16 (c) full-width SECOND step, bfloat16-read mode vs float32 read (same state "
          "and plan): " + json.dumps(lowp_gap) + f" [{card}]", flush=True)
    del got, g0, g1

    # (d) the JAX package's FPN depth-to-space (RPC_FPN_D2S), which the port
    # holds by tests and does not run (nn/second.py): its stride-2 deblock
    # replayed beside the port's ConvTranspose2d on the bf16 SECOND neck's input
    tr.init_state(state_dict=sd)
    tr.model.eval()
    plan_t = mvn.plan_to_device(splan_h, dev)
    feats = {}
    neck_in = tr.model.neck.register_forward_pre_hook(
        lambda m, a: feats.__setitem__("x", tuple(t.detach() for t in a[0])))
    with torch.no_grad():
        tr.model(None, None, False, 100, False, -1.0, plan_t)
        neck_in.remove()
        deblock = tr.model.neck.deblocks[1][0]
        s_ = deblock.stride[0]
        x2 = feats["x"][1].to(tr.model.neck.dtype)
        w2 = deblock.weight.to(x2.dtype)

        def d2s():  # JAX's _DeconvD2S on the port's weight layout (no flip)
            b_, cin, h, w_ = x2.shape
            cout = w2.shape[1]
            k2 = w2.permute(0, 2, 3, 1).reshape(cin, s_ * s_ * cout)
            y = torch.matmul(x2.permute(0, 2, 3, 1), k2).reshape(b_, h, w_, s_, s_, cout)
            return y.permute(0, 5, 1, 3, 2, 4).reshape(b_, cout, h * s_, w_ * s_)

        ref = deblock(x2)
        d2s_gap = (d2s().float() - ref.float()).abs().max().item() / ref.float().abs().max().item()
        d2s_res = {"deblock_in": list(x2.shape), "out_gap": d2s_gap, "tol": SPARSE_CONV_RTOL,
                   "deblock_device_ms_conv_transpose": device_ms(lambda: deblock(x2), 10),
                   "deblock_device_ms_d2s": device_ms(d2s, 10),
                   "neck_device_ms": device_ms(lambda: tr.model.neck(feats["x"]), 10)}
    if not d2s_gap <= SPARSE_CONV_RTOL:
        problems.append(f"phase 16 (d) FPN D2S: {d2s_res}")
    print("phase 16 (d) SECOND bf16 stride-2 deblock, the port's ConvTranspose2d vs JAX's "
          "depth-to-space: " + json.dumps(d2s_res) + f" [{card}]", flush=True)
    del tr, plan_t, feats, x2

    # (e) tools/diag_centerpoint_nan through its entry point, adversary on and off
    diag = {}
    for noadv in ("0", "1"):
        os.environ.update(DIAG_STEPS=str(VR_DIAG_STEPS), DIAG_NOADV=noadv)
        try:
            recs = diag_centerpoint_nan.main([])
        finally:
            for k in ("DIAG_STEPS", "DIAG_NOADV"):
                os.environ.pop(k, None)
        if len(recs) != VR_DIAG_STEPS or any(set(r) != {
                "step", "loss", "nonfinite_grad_leaves", "n_nonfinite", "is_nan_flag",
                "top_grad_mag"} for r in recs):
            problems.append(f"phase 16 (e) diag_centerpoint_nan DIAG_NOADV={noadv}: {recs}")
        diag[noadv] = [r["n_nonfinite"] for r in recs]
    print(f"phase 16 (e) diag_centerpoint_nan at DIAG_STEPS={VR_DIAG_STEPS}: non-finite "
          f"gradient leaves a step, adversary on {diag['0']}, off {diag['1']} [{card}]",
          flush=True)

    # the gates through the environment: a child process that sets all four
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-c", _VR_CHILD, REPO, str(seed), str(VR_CHILD_STEPS)],
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, **VR_CHILD_ENV))
    child = None
    if proc.returncode != 0:
        problems.append(f"phase 16 env child failed:\n{proc.stdout[-3000:]}\n"
                        f"{proc.stderr[-3000:]}")
    else:
        child = json.loads(proc.stdout.strip().splitlines()[-1])
    n_fwd = VR_CHILD_STEPS + 1  # the steps' forwards and the attack request
    ok = child is not None and (
        all(child["gates"].values()) and child["attack_finite"]
        and child["calls"]["adversary_rows"] == [IN_BATCH * IN_POINTS] * n_fwd
        and all(s["finite"] and s["launches"] == {k: v for k, v in VR_LOWP_LAUNCHES.items() if v}
                for s in child["steps"]))
    if not ok:
        problems.append(f"phase 16 env child: {child}")
    print(f"phase 16 env child ({' '.join(f'{k}={v}' for k, v in VR_CHILD_ENV.items())}): "
          + json.dumps(child) + f", {time.time() - t0:.1f} s [{card}]", flush=True)
    print(f"phase 16: {time.time() - t_phase:.1f} s [{card}]", flush=True)
    if problems:
        raise RuntimeError("phase 16 failed: " + " | ".join(problems))

    k2_src = "robustpointclouds_tpu_torch/csrc/masked_stats.cu"
    k2_tpu = "robustpointclouds_tpu/kernels/masked_stats.py"

    def row(name, line, n_launches, r, prev_is):
        out = {"name": name, "route": "cuda", "source": k2_src, "replaces": f"{k2_tpu}:{line}",
               "launches": n_launches, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
               "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
               "bound_ms": r["bound_ms"], "bound_by": r.get("bound_by", "bytes"),
               "library_ms": r.get("library_ms")}
        if r.get("prev_ms") is not None:
            out.update(prev_ms=r["prev_ms"], prev_device_ms=r["prev_device_ms"], prev=prev_is)
        return out
    f32_read_prev = "the float32-read mode on the same inputs"
    # launches from one compact PointPillars train step, at the compact rows
    pp_step = compact["pointpillars"]["compact_step_k2_launches_at_rows"]
    rows += [
        row("masked_batch_norm_lowp", 63, lowp_launches["apply_kernel_lowp"],
            lowp_tot["masked_batch_norm"], f32_read_prev),
        row("masked_batch_norm_bwd_lowp", 102, lowp_launches["dx_kernel"],
            lowp_tot["masked_batch_norm_bwd"], f32_read_prev),
        dict(row("masked_stats_compact_pillars", 113, pp_step.get("stats_kernel@4", 0),
                 pp_stats, None), shape=[n_c, 4]),
        dict(row("masked_batch_norm_compact_pillars", 63,
                 sum(v for k, v in pp_step.items() if k.startswith("apply_kernel")),
                 bn_step_total(pp_bn, "masked_batch_norm"), None), rows=n_c),
        dict(row("masked_batch_norm_bwd_compact_pillars", 102,
                 sum(v for k, v in pp_step.items() if k.startswith("dx_kernel")),
                 bn_step_total(pp_bn, "masked_batch_norm_bwd"), None), rows=n_c),
    ]
    return rows


# phase 17: the JAX package's measurement tools as the port's own
# (tools/bench_step, bench_inference, profile_components, microbench,
# parse_trace), each at full width on the card, in this process
TL_REPEATS = 5  # timed steps / requests / calls a measurement (the tools' minimum)
TL_WARMUP = 1
TL_TRACE_STEPS = 3  # SECOND steps of the traced window that parse_trace reads
TL_BREAKDOWN_RTOL = 0.10  # the trace's K1 + K2 ms against their CUDA events' sum
TL_MICRO_WIDTHS = (16, 64)
TL_SPIN_CYCLES = 200_000  # a spin (~0.1 ms) queued before each timed launch of the traced window
TL_CAL_PAIRS = 64  # event pairs around an empty spin: the pairs' own cost in that window
TL_RECORDS = os.path.join(REPO, "chiprun_out", "phase17_records.jsonl")
TL_FAMILY_K1 = {"second": 12, "centerpoint": 21, "pointpillars": 0}


class KernelEvents:
    """A pair of CUDA events around every K1 / K2 launch (their ctypes entry
    points: kernels/sparse_conv's `_tc_lib` / `_tf32_lib` functions,
    kernels/masked_stats' `_fn`) while active; `ms()` their summed time by
    kernel family. A short spin is queued before each start event: the card
    is busy when the host records it, so the kernel follows the event with
    no wait for the host between them (without it the events of a
    host-bound step also time the launch's host cost: 33% more in a first
    card run). The pair still adds the card's own latency from the start
    event to the kernel and from the kernel to the end event (~4.5 us, 9.5%
    of a SECOND step's K1 + K2 in a second card run): `calibrate` measures
    it on pairs around an empty spin kernel in the same window, whose trace
    duration is subtracted."""

    def __init__(self, torch):
        self.torch = torch
        self.pairs = {"K1": [], "K2": [], "cal": []}

    def _wrap(self, fn, family):
        torch = self.torch

        def call(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(TL_SPIN_CYCLES)
            start.record()
            rc = fn(*args)
            end.record()
            self.pairs[family].append((start, end))
            return rc
        return call

    def __enter__(self):
        from robustpointclouds_tpu_torch.kernels import masked_stats as ms
        from robustpointclouds_tpu_torch.kernels import sparse_conv as sc

        outer = self

        class Lib:
            def __init__(self, lib):
                self.lib = lib

            def __getattr__(self, name):
                return outer._wrap(getattr(self.lib, name), "K1")

        self.saved = (sc, sc._tc_lib, sc._tf32_lib, ms, ms._fn)
        tc, tf32, fn = sc._tc_lib, sc._tf32_lib, ms._fn
        sc._tc_lib = lambda: Lib(tc())
        sc._tf32_lib = lambda: Lib(tf32())
        ms._fn = lambda name: self._wrap(fn(name), "K2")
        return self

    def calibrate(self, n: int):
        """`n` pairs around an empty spin kernel (`torch.cuda._sleep(0)`)."""
        empty = self._wrap(lambda: self.torch.cuda._sleep(0), "cal")
        for _ in range(n):
            empty()

    def __exit__(self, *exc):
        sc, tc, tf32, ms, fn = self.saved
        sc._tc_lib, sc._tf32_lib, ms._fn = tc, tf32, fn
        return False

    def ms(self):
        self.torch.cuda.synchronize()
        return {k: sum(s.elapsed_time(e) for s, e in v) for k, v in self.pairs.items()}


def _record_problems(rec, where):
    """The phase's checks of one tool record: every *_ms number finite and
    positive (gap_ms finite), device busy <= the host-clock time, the idle
    share in [0, 1], 0 < mfu < 1."""
    import math

    out = []
    for k, v in rec.items():
        if isinstance(v, (int, float)) and not isinstance(v, bool) and k.endswith("_ms"):
            if not math.isfinite(v) or (k != "gap_ms" and v <= 0):
                out.append(f"{where}: {k} = {v}")
    host = rec.get("step_ms", rec.get("latency_ms_per_batch"))
    if host is not None:
        busy = rec.get("device_busy_ms")
        if busy is not None and not busy <= host:
            out.append(f"{where}: device_busy_ms {busy} > host-clock {host}")
        if "idle_share" in rec and rec["idle_share"] is not None \
                and not 0.0 <= rec["idle_share"] <= 1.0:
            out.append(f"{where}: idle_share {rec['idle_share']}")
        if busy is None and "device_busy_ms" in rec:
            out.append(f"{where}: device_busy_ms not measured")
    if "mfu" in rec and rec.get("flops") and not (rec["mfu"] is not None and 0 < rec["mfu"] < 1):
        out.append(f"{where}: mfu {rec['mfu']}")
    return out


def run_tools(dev, card: str, seed: int):
    """Phase 17 (see the module docstring); returns the summary the kernels
    line reads (launches a step of each family's train step)."""
    import torch

    from robustpointclouds_tpu_torch.tools import (bench_inference, bench_step, microbench,
                                                   parse_trace, profile_components)

    t_phase = time.time()
    problems, records = [], []
    os.makedirs(os.path.dirname(TL_RECORDS), exist_ok=True)
    out = open(TL_RECORDS, "w")

    def keep(tool, recs):
        for r in recs:
            where = f"phase 17 {tool} " + " ".join(
                f"{k}={r[k]}" for k in ("family", "plan", "B",
                                        "attack", "component", "section", "name", "C", "dtype")
                if k in r)
            problems.extend(_record_problems(r, where))
            records.append((tool, r))
            line = json.dumps(dict(r, tool=tool, seconds_into_phase=time.time() - t_phase))
            out.write(line + "\n")
            out.flush()
            print(f"phase 17 {tool} " + json.dumps(r), flush=True)

    # (a) bench_step: SECOND with the three plans, CenterPoint, PointPillars
    t0 = time.time()
    launches = {}
    second = bench_step.make_family("second", dev, seed=seed)
    trace_b = os.path.join(REPO, "chiprun_out", "traces", "phase17_second_resident.json.gz")
    for plan in bench_step.PLANS:
        recs = bench_step.measure(second, plan, "host", TL_REPEATS, TL_WARMUP,
                                  trace=trace_b if plan == "resident" else None)
        keep("bench_step", recs)
        for r in recs:
            if "builders" in r and r["plans_equal"] is not True:
                problems.append(f"phase 17 bench_step prefetch: the torch builder's plan "
                                f"differs from the native plan: {r['plans_equal']}")
    launches["second"] = recs[0]["launches_a_step"]
    cp = bench_step.make_family("centerpoint", dev, seed=seed)
    (r,) = bench_step.measure(cp, "resident", "host", TL_REPEATS, TL_WARMUP)
    keep("bench_step", [r])
    launches["centerpoint"] = r["launches_a_step"]
    del cp
    pp = bench_step.make_family("pointpillars", dev, seed=seed)
    (r,) = bench_step.measure(pp, "resident", "host", TL_REPEATS, TL_WARMUP)
    keep("bench_step", [r])
    launches["pointpillars"] = r["launches_a_step"]
    del pp
    for fam, per in launches.items():
        if per["k1_fwd"] != TL_FAMILY_K1[fam] or not per["k2_bn"]:
            problems.append(f"phase 17 bench_step {fam}: launches a step {per}")
    torch.cuda.empty_cache()
    bench_s = time.time() - t0

    # (b) bench_inference: B=1 and B=6, resident and inline, clean and attack
    t0 = time.time()
    server = bench_inference.Server(dev, seed=seed)
    for b in (1, 6):
        for plan in ("resident", "inline"):
            for attack in (False, True):
                keep("bench_inference", [bench_inference.measure(
                    server, b, plan, attack, TL_REPEATS, TL_WARMUP)])
    del server
    infer_s = time.time() - t0

    # (c) profile_components for SECOND
    t0 = time.time()
    comps = profile_components.profile(second, TL_REPEATS, TL_WARMUP)
    keep("profile_components", comps)
    comp_s = time.time() - t0

    # (d) a microbench subset at widths 16 and 64
    t0 = time.time()
    keep("microbench", microbench.run(dev, widths=TL_MICRO_WIDTHS, emit=False, seed=seed))
    micro_s = time.time() - t0

    # (e) parse_trace over a traced window of 3 SECOND steps whose every K1 /
    # K2 launch sits between CUDA events (KernelEvents)
    t0 = time.time()
    step, _ = bench_step.make_step(second, "resident", "host")
    step()
    torch.cuda.synchronize()
    trace_a = os.path.join(REPO, "chiprun_out", "traces", "phase17_second_3_steps.json.gz")
    os.makedirs(os.path.dirname(trace_a), exist_ok=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        with KernelEvents(torch) as ev:
            for _ in range(TL_TRACE_STEPS):
                step()
            ev.calibrate(TL_CAL_PAIRS)
        torch.cuda.synchronize()
    prof.export_chrome_trace(trace_a)
    event_ms = ev.ms()
    bd = parse_trace.breakdown(trace_a, TL_TRACE_STEPS)
    trace_ms = {k: bd["buckets"].get(k, {"ms": 0.0})["ms"] for k in ("K1", "K2")}
    # the empty spins of the calibration: the window's spins far shorter than TL_SPIN_CYCLES'
    empty_us = sorted(e["dur"] for e in parse_trace.load_trace(trace_a)["traceEvents"]
                      if e.get("cat") == "kernel" and "spin_kernel" in e.get("name", ""))
    empty_us = empty_us[:TL_CAL_PAIRS]
    pair_ms = (event_ms["cal"] - sum(empty_us) / 1e3) / TL_CAL_PAIRS
    n_ev = {k: len(ev.pairs[k]) / TL_TRACE_STEPS for k in ("K1", "K2")}
    ev_step = {k: event_ms[k] / TL_TRACE_STEPS for k in ("K1", "K2")}
    got, raw = trace_ms["K1"] + trace_ms["K2"], ev_step["K1"] + ev_step["K2"]
    want = raw - pair_ms * (n_ev["K1"] + n_ev["K2"])
    gap = abs(got - want) / want if want > 0 else float("inf")
    if not gap <= TL_BREAKDOWN_RTOL:
        problems.append(f"phase 17 parse_trace: the breakdown's K1 + K2 {got:.4f} ms a step vs "
                        f"the CUDA events' {want:.4f} (raw {raw:.4f}, a pair's own "
                        f"{pair_ms * 1e3:.2f} us; gap {gap:.3f} > {TL_BREAKDOWN_RTOL})")
    bd_rec = {"steps": TL_TRACE_STEPS, "trace_ms_a_step": trace_ms, "event_ms_a_step": ev_step,
              "event_launches_a_step": n_ev, "event_pair_us": pair_ms * 1e3,
              "empty_spin_us": [min(empty_us), max(empty_us)] if empty_us else None,
              "event_ms_a_step_less_pairs": want, "gap": gap,
              "gap_raw": abs(got - raw) / raw if raw else None, "tol": TL_BREAKDOWN_RTOL,
              "buckets": bd["buckets"], "top_kernels": bd["kernels"][:8]}
    out.write(json.dumps(dict(bd_rec, tool="parse_trace.breakdown")) + "\n")
    print("phase 17 parse_trace.breakdown (3 SECOND steps, a spin before each K1 / K2 launch) "
          + json.dumps(bd_rec)
          + f" [{card}]", flush=True)
    idle = parse_trace.idle(trace_b, top=8)
    if idle is None or not 0.0 <= idle["idle_share"] <= 1.0:
        problems.append(f"phase 17 parse_trace.idle: {idle}")
    out.write(json.dumps(dict(idle or {}, tool="parse_trace.idle")) + "\n")
    out.close()
    print("phase 17 parse_trace.idle (bench_step's profiled SECOND window, 2 steps) "
          + json.dumps(idle) + f" [{card}]", flush=True)
    trace_s = time.time() - t0
    del second, step

    seconds = time.time() - t_phase
    print(f"phase 17: {seconds:.1f} s (bench_step {bench_s:.1f}, bench_inference {infer_s:.1f}, "
          f"profile_components {comp_s:.1f}, microbench {micro_s:.1f}, parse_trace "
          f"{trace_s:.1f}) [{card}]", flush=True)
    if problems:
        raise RuntimeError("phase 17:\n  " + "\n  ".join(problems))
    return {"seconds": seconds, "launches_a_step": launches, "records": len(records),
            "breakdown_gap": gap}


def bn_step_total(rows, kernel):
    """One train step's sum over its 17 MaskedBatchNorms (count x each
    shape); a device time that one shape did not measure leaves the sum not
    measured (None)."""
    tot = {k: 0.0 for k in ("ms", "prev_ms", "device_ms", "prev_device_ms", "plain_ms",
                            "bound_ms", "bound_two_pass_ms")}
    err = 0.0
    for r in rows:
        if r["kernel"] == kernel and r["train"]:
            for k in tot:
                tot[k] = None if tot[k] is None or r[k] is None else tot[k] + r["count"] * r[k]
            err = max(err, r["max_abs_err"])
    return dict(tot, max_abs_err=err)


# phase 18: the greedy NMS keep-mask (rpc::greedy_keep, csrc/greedy_nms.cu)
# random relations (rows, N): the two serving shapes, one box, one word and a
# bit, and 2048 boxes, whose words go to the global scratch (N > 612)
GN_RANDOM = ((24, 500), (18, 100), (4, 1), (4, 65), (2, 2048))
GN_SUPPRESSORS = 8.0  # boxes that suppress a given box in a random relation, on average
GN_SERVES = 5  # serves a route in each turn of the serve timing
# mmdet3d's per-task circle-NMS radii (min_radius, on the squared distance),
# as the benchmark's CenterPoint configuration has them
GN_CP_RADII = (4.0, 12.0, 10.0, 1.0, 0.85, 0.175)


def run_greedy_nms(dev, card: str, seed: int):
    """Phase 18: the keep-mask kernel against the plain loop on the card.
    (a) One CenterPoint B=4 serve (30000-point frames, the six tasks at
    nms_pre 500, per-task radii) and one SECOND B=6 serve (20000-point
    frames, 3 classes at nms_pre 100), seeded random weights, score_thr 0:
    each `ops/nms._greedy_keep` call launches the kernel exactly once and
    never the plain loop, and the relation it swept is kept; (b) on those
    relations and on random ones (GN_RANDOM, symmetric and not, a third of
    the rows all invalid), the kernel's mask bit-identical to the plain
    loop's, with CUDA-event ms of both, the device operations and device ms
    of one call each (torch.profiler), and the byte bound; (c) each serve's
    host-clock ms with the sweep on the kernel and on the plain loop, in
    turns, the detections equal. Returns the kernels line's rows."""
    import numpy as np
    import torch

    from robustpointclouds_tpu_torch.cli import export
    from robustpointclouds_tpu_torch.data.nuscenes import synthetic_nuscenes_batch
    from robustpointclouds_tpu_torch.data.synthetic import synthetic_kitti_batch
    from robustpointclouds_tpu_torch.kernels import greedy_nms as gn
    from robustpointclouds_tpu_torch.models import centerpoint as mcp
    from robustpointclouds_tpu_torch.models import voxelnet as mvn
    from robustpointclouds_tpu_torch.ops import nms as nms_ops

    t_phase = time.time()
    rng = np.random.RandomState(seed + 18)
    gen = torch.Generator(device=dev).manual_seed(seed + 18)
    fn_keep, fn_sweep = nms_ops.greedy_keep, nms_ops._greedy_keep
    seen = {"sweeps": 0, "relations": []}

    def capture(over, valid):
        seen["relations"].append((over.clone(), valid.clone()))
        return fn_keep(over, valid)

    def counted_sweep(over, valid):
        seen["sweeps"] += 1
        return fn_sweep(over, valid)

    cases, serve_ms = [], {}
    families = (("centerpoint", mcp.CenterPointConfig(), mcp.AdversarialCenterPoint, CP_BATCH,
                 CP_POINTS),
                ("second", mvn.VoxelNetConfig(), mvn.AdversarialVoxelNet, IN_BATCH, IN_POINTS))
    try:
        for name, cfg, cls, batch, npts in families:
            model = cls(cfg)
            mvn.init_weights(model, torch.Generator().manual_seed(seed))
            # one sweep of every (sample, task) or (sample, class) row at nms_pre:
            # [24, 500] and [18, 100] at full width
            if name == "centerpoint":
                shape = (batch * len(cfg.head.tasks), cfg.head.nms_pre)
                anchors, head = None, cfg.head._replace(score_thr=0.0, circle_radius=GN_CP_RADII)
                b, _ = synthetic_nuscenes_batch(rng, batch_size=batch, num_points=npts,
                                                max_gt=cfg.head.max_objs,
                                                point_range=cfg.voxelizer.point_cloud_range)
            else:
                anchors, head = cfg.make_anchors()[0], cfg.head._replace(score_thr=0.0)
                shape = (batch * cfg.head.num_classes, min(cfg.head.nms_pre, len(anchors)))
                b = synthetic_kitti_batch(rng, batch_size=batch, num_points=npts, max_gt=20,
                                          num_objects=8,
                                          point_range=cfg.voxelizer.point_cloud_range)
            pts = torch.from_numpy(np.asarray(b.points)).to(dev)
            msk = torch.from_numpy(np.asarray(b.points_mask)).to(dev)
            serve = export.export_serving(model, None, anchors, head)
            serve(pts, msk)  # warm-up: the kernels' builds, the plan's graph
            torch.cuda.synchronize()
            gn.KERNEL_LAUNCHES.clear()
            seen["sweeps"], seen["relations"] = 0, []
            nms_ops.greedy_keep, nms_ops._greedy_keep = capture, counted_sweep
            try:
                want = serve(pts, msk)
                torch.cuda.synchronize()
            finally:
                nms_ops.greedy_keep, nms_ops._greedy_keep = fn_keep, fn_sweep
            launches = dict(gn.KERNEL_LAUNCHES)
            if (seen["sweeps"] != 1 or launches != {"kernel": seen["sweeps"]}
                    or len(seen["relations"]) != 1):
                raise RuntimeError(f"phase 18 {name} serve: {seen['sweeps']} sweeps launched "
                                   f"{launches}; every sweep must launch the kernel once")
            over, valid = seen["relations"][0]
            if tuple(valid.shape) != shape:
                raise RuntimeError(f"phase 18 {name} serve swept {tuple(over.shape)}, "
                                   f"not {shape}")
            cases.append((f"{name} serve", over, valid))
            # (c) the serve with the sweep on the kernel and on the plain loop, in turns
            ms = {"kernel": [], "plain": []}
            for which in ("kernel", "plain", "plain", "kernel"):
                nms_ops.greedy_keep = fn_keep if which == "kernel" else gn.greedy_keep_ref
                try:
                    for _ in range(GN_SERVES):
                        got, host_ms, _ = _timed(lambda: serve(pts, msk), False)
                        ms[which].append(host_ms)
                        if not all(torch.equal(g, w) for g, w in zip(got, want)):
                            raise RuntimeError(f"phase 18 {name} serve on the {which} "
                                               "route differs from the first serve")
                finally:
                    nms_ops.greedy_keep = fn_keep
            serve_ms[name] = {k: statistics.median(v) for k, v in ms.items()}
            serve_ms[name]["valid"] = int(valid.sum())
            serve_ms[name]["kept"] = int(gn.greedy_keep(over, valid).sum())
            print(f"phase 18 {name} B={batch} serve: sweep {tuple(over.shape)}, "
                  f"{serve_ms[name]['valid']} valid, {serve_ms[name]['kept']} kept; host ms "
                  f"(median of {2 * GN_SERVES}) kernel {serve_ms[name]['kernel']:.3f}, plain loop "
                  f"{serve_ms[name]['plain']:.3f} [{card}]", flush=True)
            del model, serve, want
            torch.cuda.empty_cache()
    finally:
        nms_ops.greedy_keep, nms_ops._greedy_keep = fn_keep, fn_sweep

    for rows, n in GN_RANDOM:
        for symmetric in (True, False):
            over = torch.rand(rows, n, n, device=dev, generator=gen) < GN_SUPPRESSORS / n
            if symmetric:
                over = over | over.transpose(1, 2)
            valid = torch.rand(rows, n, device=dev, generator=gen) < 0.8
            valid[1::3] = False
            cases.append((f"random {'symmetric' if symmetric else 'asymmetric'}", over, valid))

    out = []
    for tag, over, valid in cases:
        rows, n = valid.shape
        before = gn.KERNEL_LAUNCHES["kernel"]
        keep = gn.greedy_keep(over, valid)
        torch.cuda.synchronize()
        ref = gn.greedy_keep_ref(over, valid)
        torch.cuda.synchronize()
        if gn.KERNEL_LAUNCHES["kernel"] != before + 1 or not torch.equal(keep, ref):
            raise RuntimeError(f"phase 18 {tag} [{rows}, {n}, {n}]: the kernel's mask differs "
                               f"from the plain loop's in {int((keep != ref).sum())} boxes")
        kernel_ms = cuda_ms(lambda: gn.greedy_keep(over, valid), iters=50)
        plain_ms = cuda_ms(lambda: gn.greedy_keep_ref(over, valid), iters=3, warmup=1)
        k_ops, k_dev = profile_launches(lambda: gn.greedy_keep(over, valid))
        p_ops, p_dev = profile_launches(lambda: gn.greedy_keep_ref(over, valid))
        torch.cuda.synchronize()
        nbytes = rows * n * n + 2 * rows * n  # the relation and valid read, keep written
        b_ms, bound_by = bound_ms(nbytes, 0, "f32")
        row = {"name": "greedy_keep", "route": "cuda",
               "source": "robustpointclouds_tpu_torch/csrc/greedy_nms.cu",
               "replaces": "none (robustpointclouds_tpu/ops/nms.py:36, lax.fori_loop)",
               "case": tag, "shape": [rows, n, n], "valid": int(valid.sum()),
               "kept": int(keep.sum()), "mismatch": 0, "ms": kernel_ms, "device_ms": k_dev,
               "device_ops": k_ops, "plain_ms": plain_ms, "plain_device_ms": p_dev,
               "plain_device_ops": p_ops, "bound_ms": b_ms, "bound_by": bound_by,
               "library_ms": None}
        print(f"phase 18 greedy_keep {tag} [{rows}, {n}, {n}]: bit-identical, "
              f"{row['valid']} valid, {row['kept']} kept; kernel {_fmt(kernel_ms)} ms "
              f"[device {_fmt(k_dev)}, {k_ops} ops], plain loop {_fmt(plain_ms)} ms "
              f"[device {_fmt(p_dev)}, {p_ops} ops], bound {b_ms:.5f} ms ({bound_by}) "
              f"[{card}]", flush=True)
        out.append(row)
    out[0]["serve_host_ms"] = serve_ms
    print(f"phase 18: {time.time() - t_phase:.1f} s [{card}]", flush=True)
    return out


# phase 19: the deformable conv (rpc::deform_conv2d, csrc/deform_conv.cu)
# CenterPoint's DCN head at B=4: 64 channels on the 128 x 128 map, groups 4
DC_SHAPE, DC_GROUPS = (CP_BATCH, 64, 128, 128), 4
# more shapes (B, C, H, W, Cout, k, groups, deform_groups): a map that is no
# multiple of the 128-pixel tile, a group wider than a contraction chunk with
# two deform groups, 5x5 taps
DC_OTHERS = ((2, 64, 37, 53, 64, 3, 4, 1), (1, 96, 20, 30, 32, 3, 1, 2),
             (2, 16, 33, 17, 24, 5, 2, 2))
# float32 sums of the same products in another order, with bilinear weights
# rounded apart: within 1e-5 of the output's scale; the head's maps after
# BN, ReLU and two float32 convs within 1e-4 of each map's scale
DC_RTOL, DC_HEAD_RTOL = 1e-5, 1e-4
DC_ADAPTATIONS = 12  # the head's: feature_adapt_cls and _reg of six tasks
DC_SERVES = 3  # CenterPoint requests, eager and through the artifact each


def _dc_offsets(torch, dev, gen, shape, kind, k=3, deform_groups=1):
    """Offsets [B, dg * 2 * k * k, H, W]: zero, whole cells (-2 .. 2), or
    fractional, a tenth of them thrown past the map's borders."""
    b, _, h, w = shape
    oshape = (b, deform_groups * 2 * k * k, h, w)
    if kind == "zero":
        return torch.zeros(oshape, device=dev)
    if kind == "integer":
        return torch.randint(-2, 3, oshape, device=dev, generator=gen).float()
    off = torch.randn(oshape, device=dev, generator=gen) * 1.5
    far = torch.rand(oshape, device=dev, generator=gen) < 0.1
    return torch.where(far, off * max(h, w), off)


def run_deform_conv(dev, card: str, seed: int):
    """Phase 19: the DCN kernel against its plain twin on the card.
    (a) At the head's shape with zero, integer and fractional offsets, and at
    DC_OTHERS: within DC_RTOL of the twin's scale (zero offsets: of cuDNN's
    grouped conv too, TF32 off), one kernel launch a call and none of the
    twin's operator, bit-identical on a repeat call; (b) CUDA-event ms of the
    kernel, the twin, the twin's einsum alone on its col (the library
    yardstick) and cuDNN's grouped conv at zero offsets, the device
    operations and ms of one call each, and the operation bound; (c) a
    full-width CenterPoint B=4 head (random weights, offset convs
    randomised) on the kernel route against the twin's, map by map; (d)
    DC_SERVES CenterPoint requests, eager and through the loaded `.pt2`
    (phase 12's export_program on the card), DC_ADAPTATIONS kernel launches
    each, the outputs bit-equal; (e) `correct` of the benchmark's CenterPoint
    cell (benchmark/run.py, a 10 s window). Returns the kernels line's rows."""
    import tempfile

    import numpy as np
    import torch
    import torch.nn.functional as F

    from robustpointclouds_tpu_torch.cli import export
    from robustpointclouds_tpu_torch.data.nuscenes import synthetic_nuscenes_batch
    from robustpointclouds_tpu_torch.kernels import deform_conv as kdc
    from robustpointclouds_tpu_torch.models import centerpoint as mcp
    from robustpointclouds_tpu_torch.models import voxelnet as mvn
    from robustpointclouds_tpu_torch.nn import deform_conv as ndc

    t_phase = time.time()
    gen = torch.Generator(device=dev).manual_seed(seed + 19)

    def rel(a, b):
        return float((a.double() - b.double()).abs().max() / b.double().abs().max().clamp_min(1e-12))

    def check(tag, x, off, wt, groups, dg):
        before = dict(kdc.KERNEL_LAUNCHES)
        got = kdc.deform_conv2d(x, off, wt, groups, dg)
        torch.cuda.synchronize()
        again = kdc.deform_conv2d(x, off, wt, groups, dg)
        ref = kdc.deform_conv2d_ref(x, off, wt, groups, dg)
        torch.cuda.synchronize()
        if (kdc.KERNEL_LAUNCHES["kernel"] != before.get("kernel", 0) + 2
                or kdc.KERNEL_LAUNCHES["plain"] != before.get("plain", 0)):
            raise RuntimeError(f"phase 19 {tag}: launches {dict(kdc.KERNEL_LAUNCHES)} after "
                               f"{before}; each call must launch the kernel once")
        err = rel(got, ref)
        if not (err <= DC_RTOL and torch.equal(got, again) and got.is_contiguous()):
            raise RuntimeError(f"phase 19 {tag}: kernel vs twin {err:.3e} (limit {DC_RTOL}), "
                               f"repeat equal {torch.equal(got, again)}")
        return got, ref, err

    # (a) + (b) at the head's shape
    b, c, h, w = DC_SHAPE
    x = torch.randn(DC_SHAPE, device=dev, generator=gen)
    wt = torch.randn(c, c // DC_GROUPS, 3, 3, device=dev, generator=gen) / 12.0
    out = []
    for kind in ("zero", "integer", "fractional"):
        off = _dc_offsets(torch, dev, gen, DC_SHAPE, kind)
        got, _, err = check(f"{list(DC_SHAPE)} {kind}", x, off, wt, DC_GROUPS, 1)
        extra = {}
        if kind == "zero":
            conv = F.conv2d(x, wt, padding=1, groups=DC_GROUPS)
            extra["vs_cudnn_grouped_conv"] = rel(got, conv)
            if extra["vs_cudnn_grouped_conv"] > DC_RTOL:
                raise RuntimeError(f"phase 19 zero offsets: kernel vs cuDNN's grouped conv "
                                   f"{extra['vs_cudnn_grouped_conv']:.3e}")
            extra["cudnn_grouped_conv_ms"] = cuda_ms(
                lambda: F.conv2d(x, wt, padding=1, groups=DC_GROUPS), iters=20)
        kernel_ms = cuda_ms(lambda: kdc.deform_conv2d(x, off, wt, DC_GROUPS, 1), iters=50)
        plain_ms = cuda_ms(lambda: kdc.deform_conv2d_ref(x, off, wt, DC_GROUPS, 1), iters=5,
                           warmup=1)
        k_ops, k_dev = profile_launches(lambda: kdc.deform_conv2d(x, off, wt, DC_GROUPS, 1))
        p_ops, p_dev = profile_launches(lambda: kdc.deform_conv2d_ref(x, off, wt, DC_GROUPS, 1))
        # the library yardstick: the twin's product alone, one einsum on its col
        col = torch.randn(b * h * w, 9, DC_GROUPS, c // DC_GROUPS, device=dev, generator=gen)
        wg = wt.reshape(DC_GROUPS, c // DC_GROUPS, c // DC_GROUPS, 9)
        lib_ms = cuda_ms(lambda: torch.einsum("nkgc,gock->ngo", col, wg), iters=10)
        del col
        flops = 2.0 * b * h * w * c * (c // DC_GROUPS) * 9
        nbytes = 4.0 * (x.numel() + off.numel() + wt.numel() + got.numel())
        b_ms, bound_by = bound_ms(nbytes, flops, "f32")
        row = {"name": "deform_conv2d", "route": "cuda",
               "source": "robustpointclouds_tpu_torch/csrc/deform_conv.cu",
               "replaces": "none (robustpointclouds_tpu/nn/deform_conv.py, plain XLA)",
               "case": f"offsets {kind}", "shape": [*DC_SHAPE, DC_GROUPS], "max_rel_err": err,
               "ms": kernel_ms, "device_ms": k_dev, "device_ops": k_ops, "plain_ms": plain_ms,
               "plain_device_ms": p_dev, "plain_device_ops": p_ops, "bound_ms": b_ms,
               "bound_by": bound_by, "library_ms": lib_ms, **extra}
        print(f"phase 19 deform_conv2d {list(DC_SHAPE)} groups {DC_GROUPS} offsets {kind}: "
              f"vs twin {err:.2e}; kernel {_fmt(kernel_ms)} ms [device {_fmt(k_dev)}, {k_ops} "
              f"ops], twin {_fmt(plain_ms)} ms [device {_fmt(p_dev)}, {p_ops} ops], einsum "
              f"{_fmt(lib_ms)} ms, bound {b_ms:.5f} ms ({bound_by})"
              + (f", cuDNN grouped conv {_fmt(extra['cudnn_grouped_conv_ms'])} ms"
                 if extra else "") + f" [{card}]", flush=True)
        out.append(row)
    for bb, cc, hh, ww, cout, k, groups, dg in DC_OTHERS:
        xs = torch.randn(bb, cc, hh, ww, device=dev, generator=gen)
        off = _dc_offsets(torch, dev, gen, (bb, cc, hh, ww), "fractional", k, dg)
        ws = torch.randn(cout, cc // groups, k, k, device=dev, generator=gen)
        _, _, err = check(f"[{bb}, {cc}, {hh}, {ww}] -> {cout} k {k} groups {groups} dg {dg}",
                          xs, off, ws, groups, dg)
        print(f"phase 19 deform_conv2d [{bb}, {cc}, {hh}, {ww}] -> {cout}, k {k}, groups "
              f"{groups}, deform groups {dg}: vs twin {err:.2e} [{card}]", flush=True)
        out[-1].setdefault("other_shapes_max_rel_err", 0.0)
        out[-1]["other_shapes_max_rel_err"] = max(out[-1]["other_shapes_max_rel_err"], err)
    del x, off
    torch.cuda.empty_cache()

    # (c) a full-width CenterPoint head, kernel route against the twin's
    cfg = mcp.CenterPointConfig(use_dcn_head=True)
    model = mcp.AdversarialCenterPoint(cfg)
    mvn.init_weights(model, torch.Generator().manual_seed(seed))
    cpu_gen = torch.Generator().manual_seed(seed + 19)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, ndc.DeformConv2d):
                m.conv_offset.weight.copy_(torch.randn(m.conv_offset.weight.shape,
                                                       generator=cpu_gen) * 0.02)
                m.conv_offset.bias.copy_(torch.randn(m.conv_offset.bias.shape, generator=cpu_gen))
    model.to(dev).eval()
    head = model.pts_bbox_head
    neck = torch.randn(CP_BATCH, head.shared_conv.conv.weight.shape[1], 128, 128, device=dev,
                       generator=gen)
    kdc.KERNEL_LAUNCHES.clear()
    with torch.no_grad():
        fused = head(neck)
        n_head = dict(kdc.KERNEL_LAUNCHES)
        ndc.deform_conv2d, fn = (lambda *a: kdc.deform_conv2d_ref(*a)), ndc.deform_conv2d
        try:
            twin = head(neck)
        finally:
            ndc.deform_conv2d = fn
    torch.cuda.synchronize()
    if n_head != {"kernel": DC_ADAPTATIONS}:
        raise RuntimeError(f"phase 19 head: launches {n_head}, not {DC_ADAPTATIONS} kernel ones")
    head_err = max(rel(f[key], t[key]) for f, t in zip(fused, twin) for key in t)
    if head_err > DC_HEAD_RTOL:
        raise RuntimeError(f"phase 19 head: kernel route vs twin route {head_err:.3e}")
    with torch.no_grad():
        head_ms = {"kernel": cuda_ms(lambda: head(neck), iters=5, warmup=1)}
        ndc.deform_conv2d = lambda *a: kdc.deform_conv2d_ref(*a)
        try:
            head_ms["twin"] = cuda_ms(lambda: head(neck), iters=5, warmup=1)
        finally:
            ndc.deform_conv2d = fn
    print(f"phase 19 CenterPoint head B={CP_BATCH} (twelve DCNs): kernel route vs twin route "
          f"{head_err:.2e} of each map's scale; head ms kernel {head_ms['kernel']:.3f}, twin "
          f"{head_ms['twin']:.3f} [{card}]", flush=True)
    del neck, fused, twin
    torch.cuda.empty_cache()

    # (d) CenterPoint requests, eager and through the loaded artifact
    head_cfg = cfg.head._replace(score_thr=0.0)
    serve = export.export_serving(model, None, None, head_cfg)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dcn_")
    path = os.path.join(tmp, "centerpoint_dcn.pt2")
    kdc.KERNEL_LAUNCHES.clear()
    ep, meta = export.export_program(model, None, head_cfg, CP_BATCH, CP_POINTS)
    export.save_exported(ep, meta, path)
    n_nodes = sum(str(n.target) == "rpc.deform_conv2d.default" for n in ep.graph.nodes)
    if n_nodes != DC_ADAPTATIONS or kdc.KERNEL_LAUNCHES:
        raise RuntimeError(f"phase 19 export: {n_nodes} rpc.deform_conv2d nodes, launches "
                           f"{dict(kdc.KERNEL_LAUNCHES)} while exporting")
    del ep
    call, _ = export.load_exported(path)
    rng = np.random.RandomState(seed + 19)
    serve_launches = []
    for i in range(DC_SERVES):
        fr, _ = synthetic_nuscenes_batch(rng, batch_size=CP_BATCH, num_points=CP_POINTS,
                                         max_gt=cfg.head.max_objs,
                                         point_range=cfg.voxelizer.point_cloud_range)
        pts = torch.from_numpy(np.asarray(fr.points)).to(dev)
        msk = torch.from_numpy(np.asarray(fr.points_mask)).to(dev)
        res = {}
        for which, fn_ in (("eager", serve), ("artifact", call)):
            kdc.KERNEL_LAUNCHES.clear()
            res[which] = fn_(pts, msk)
            torch.cuda.synchronize()
            res[which + "_launches"] = dict(kdc.KERNEL_LAUNCHES)
        launches = (res["eager_launches"], res["artifact_launches"])
        if launches != ({"kernel": DC_ADAPTATIONS},) * 2:
            raise RuntimeError(f"phase 19 request {i}: launches eager / artifact {launches}")
        if not outputs_equal(tuple(res["artifact"]), tuple(res["eager"])):
            raise RuntimeError(f"phase 19 request {i}: the artifact differs from the eager serve")
        if int(res["eager"][3].sum()) == 0:
            raise RuntimeError(f"phase 19 request {i}: no detection to compare")
        serve_launches.append(launches[0]["kernel"])
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 19 CenterPoint B={CP_BATCH} requests: kernel launches a request eager "
          f"{serve_launches}, through the loaded .pt2 the same, outputs bit-equal [{card}]",
          flush=True)
    del model, serve, call
    torch.cuda.empty_cache()

    # (e) the benchmark's CenterPoint cell
    t0 = time.time()
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "centerpoint-nuscenes.attack-eval-inline", "--seed", str(seed + 19),
                          "--seconds", "10", "--trace", "0"], cwd=REPO, capture_output=True,
                         text=True, timeout=600)
    lines = res.stdout.strip().splitlines()
    line = json.loads(lines[-1]) if res.returncode == 0 and lines else {}
    if line.get("correct") is not True:
        raise RuntimeError(f"phase 19 benchmark cell: rc {res.returncode}, correct "
                           f"{line.get('correct')}\n{res.stderr[-3000:]}")
    checks = [ln for ln in res.stderr.splitlines() if ln.startswith("check ")]
    print(f"phase 19 benchmark centerpoint-nuscenes.attack-eval-inline: correct, eval_fps "
          f"{line.get('eval_fps')}, {'; '.join(checks)} ({time.time() - t0:.1f} s) [{card}]",
          flush=True)
    out[0]["request_launches"] = {"eager": serve_launches[0], "artifact": serve_launches[0]}
    out[0]["head_ms"] = head_ms
    out[0]["head_max_rel_err"] = head_err
    print(f"phase 19: {time.time() - t_phase:.1f} s [{card}]", flush=True)
    return out


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

    global HBM_BYTES_PER_S, L2_BYTES, PEAK_OPS
    from robustpointclouds_tpu_torch.tools.bench_common import HBM_BYTES_PER_S, L2_BYTES, PEAK_OPS
    from robustpointclouds_tpu_torch.cli import evaluate_kitti_3class as eval_cli
    from robustpointclouds_tpu_torch.cli import evaluate_kitti_adversarial_attack as attack_cli
    from robustpointclouds_tpu_torch.cli.common import (
        prefetch_iterator, run_evaluation, synthetic_loader, with_plans)
    from robustpointclouds_tpu_torch.cli.export import export_serving
    from robustpointclouds_tpu_torch.core.spans import device_entries
    from robustpointclouds_tpu_torch.data.native_plan import build_plan_native
    from robustpointclouds_tpu_torch.data.synthetic import synthetic_kitti_batch
    from robustpointclouds_tpu_torch.kernels import _build
    from robustpointclouds_tpu_torch.kernels.gather import (
        gather_elems, gather_onehot, gather_row_loop, gather_rows)
    from robustpointclouds_tpu_torch.kernels.masked_stats import (
        KERNEL_LAUNCHES, KERNEL_ROW_LAUNCHES, masked_batch_norm, masked_batch_norm_bwd, masked_stats,
        masked_stats_bwd)
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
        KERNEL_LAUNCHES.clear()
        KERNEL_ROW_LAUNCHES.clear()
        for fn in conv_counters.values():
            fn.tf32_launches = 0
        masked_batch_norm_bwd.reduce_launches = 0

    def read_counts():
        """Launches per wrapper; bwd_reduce: the BN backward calls that ran it."""
        return {**{k: fn.launches for k, fn in counters.items()},
                "bwd_reduce": masked_batch_norm_bwd.reduce_launches}

    def read_f32_counts():
        """The sparse-conv launches that took the float32 route's 3xTF32 kernels."""
        return {k: fn.tf32_launches for k, fn in conv_counters.items()}

    def expect_bf16_kernels(path):
        f32 = read_f32_counts()
        if any(f32.values()):
            raise RuntimeError(f"the bf16 {path} path reached the float32 kernels: {f32}")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- phase 1: card and build
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    t0 = time.time()
    sources = ("sparse_conv_tc", "sparse_conv_tf32", "gather_probe", "masked_stats",
               "greedy_nms", "deform_conv")
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
    # and the float32 route to tf32 tensor-core products
    sass = subprocess.run([cuobjdump, "--dump-sass", _build.library_path("sparse_conv_tf32")],
                          capture_output=True, text=True, timeout=120, check=True).stdout
    hmma_tf32 = sum(1 for line in sass.splitlines() if "HMMA" in line and "TF32" in line)
    if hmma_tf32 == 0:
        raise RuntimeError("no TF32 HMMA instruction in the float32 sparse-conv library")
    print(f"build: {' + '.join(sources)} nvcc in parallel {nvcc_s:.1f} s", flush=True)
    print(f"sass: {hmma} bf16 HMMA instructions in "
          f"{os.path.basename(_build.library_path('sparse_conv_tc'))}, {hmma_tf32} TF32 HMMA in "
          f"{os.path.basename(_build.library_path('sparse_conv_tf32'))}, {hmma_probe} HMMA in "
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
    stats_rows = check_masked_stats(
        torch, [(480000, 4, torch.float32), (96000, 64, torch.float32),
                (96000, 64, torch.bfloat16)], args.seed)
    for r in stats_rows:
        print("masked_stats " + json.dumps(r), flush=True)
    bn_rows = check_masked_batch_norm(torch, args.seed)
    for r in bn_rows:
        print("masked_batch_norm " + json.dumps(r), flush=True)
    bn_tot = {k: bn_step_total(bn_rows, k) for k in ("masked_batch_norm",
                                                      "masked_batch_norm_bwd")}
    for k, tot in bn_tot.items():
        print(f"{k} over the 17 BNs of a train step: {tot['ms']:.4f} ms (device "
              f"{_fmt(tot['device_ms'])}), bound {tot['bound_ms']:.4f} ms (two-pass "
              f"{tot['bound_two_pass_ms']:.4f})", flush=True)
    print(f"K2 checks and timing: {time.time() - t0:.1f} s", flush=True)

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
    for route, totals in (("bf16", (conv_tot, bwd_tot["dgrad"], bwd_tot["wgrad"])),
                          ("float32", (f32_conv_tot, f32_bwd_tot["dgrad"], f32_bwd_tot["wgrad"]))):
        for key, tot in zip(("sparse_conv", "sparse_conv_dgrad", "sparse_conv_wgrad"), totals):
            old_bound = (f" (the same products on the CUDA cores "
                         f"{tot['bound_f32_cuda_cores_ms']:.4f})"
                         if "bound_f32_cuda_cores_ms" in tot else "")
            print(f"{key} {route} over the 12 convs: tensor cores {tot['ms']:.4f} ms (device "
                  f"{_fmt(tot['device_ms'])}), index_select + matmul "
                  f"{tot['library_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms by "
                  f"{tot['bound_by']}{old_bound}", flush=True)
    stats_bwd_rows = check_masked_stats_bwd(
        torch, [(480000, 4, torch.float32), (480000, 128, torch.float32),
                (480000, 128, torch.bfloat16), (96000, 64, torch.float32),
                (96000, 64, torch.bfloat16)], args.seed)
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
    expect_bf16_kernels("serving")
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
    expect_bf16_kernels("training")
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
    # every sparse-conv launch of the float32 path took the 3xTF32 kernels
    f32_launches = read_f32_counts()
    if f32_launches != {k: read_counts()[k] for k in f32_launches} or not all(
            f32_launches.values()):
        raise RuntimeError(f"float32 small-grid path: 3xTF32 launches {f32_launches}, all "
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
          f"step on the 3xTF32 kernels: {json.dumps(f32_launches)}", flush=True)

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
        busy_ms = sum(e.self_device_time_total
                      for e in device_entries(prof.key_averages())) / 1e3
        print(f"eval {name} under torch.profiler (one B=6 batch): device busy {busy_ms:.3f} ms "
              f"of {wall_ms:.3f} ms, idle share {1.0 - busy_ms / wall_ms:.3f}", flush=True)
    del etr

    # ---- phase 7: KITTI training through the training CLI's entry point
    zero_counts()
    kitti_summary = run_kitti_training(cfg, dev, card, args.seed, read_counts, expect_bf16_kernels)

    # ---- phase 8: CenterPoint on NuScenes at full width
    cp_rows = run_centerpoint(dev, card, args.seed, zero_counts, read_counts, read_f32_counts,
                              expect_bf16_kernels)

    # ---- phase 9: PointPillars at full width, and the generic training entry point
    pp_rows = run_pointpillars(dev, card, args.seed, zero_counts, read_counts,
                               expect_bf16_kernels, os.path.join(KITTI_ROOT, "data"), KITTI_ROOT)

    # ---- phase 10: the strong family at full width, and its training entry point
    st_rows = run_strong(dev, card, args.seed, zero_counts, read_counts, read_f32_counts,
                         expect_bf16_kernels, os.path.join(KITTI_ROOT, "data"), KITTI_ROOT)

    # ---- phase 11: the inline (plan=None) path, the plan built on the card
    run_inline(dev, card, args.seed, zero_counts, read_counts, expect_bf16_kernels,
               os.path.join(KITTI_ROOT, "data"))
    shutil.rmtree(KITTI_ROOT, ignore_errors=True)

    # ---- phase 12: the serving export, each family's artifact on the card
    run_export(dev, card, args.seed, zero_counts, read_counts, expect_bf16_kernels)

    # ---- phase 13: zoo warm starts of the three families, and their entry points
    zoo = run_zoo(dev, card, args.seed, zero_counts, read_counts, expect_bf16_kernels)

    # ---- phase 14: data-parallel training, two ranks on the card, and the CLI over NCCL
    dp = run_data_parallel(dev, card, args.seed)
    dp_launches = {f: dp[f]["launches_a_rank"] for f in ("second", "centerpoint")}

    # ---- phase 15: the convergence run, the plain-block CenterPoint encoder, --amp
    p15 = run_convergence(dev, card, args.seed, zero_counts, read_counts, expect_bf16_kernels)

    # ---- phase 16: the JAX package's env-gated variants
    vr_rows = run_variants(dev, card, args.seed, zero_counts, read_counts, expect_bf16_kernels)

    # ---- phase 17: the port's measurement tools, at full width
    tools = run_tools(dev, card, args.seed)
    tl = tools["launches_a_step"]

    # ---- phase 18: the greedy NMS keep-mask
    gn_rows = run_greedy_nms(dev, card, args.seed)

    # ---- phase 19: the deformable conv
    dc_rows = run_deform_conv(dev, card, args.seed)

    k2 = stats_rows[0]
    conv_src = "robustpointclouds_tpu_torch/csrc/sparse_conv_tc.cu"
    tf32_src = "robustpointclouds_tpu_torch/csrc/sparse_conv_tf32.cu"
    mp_gather = "robustpointclouds_tpu/kernels/mp_gather.py:192"

    def conv_row(name, src, n_launches, tot):
        row = {"name": name, "route": "cuda", "source": src, "replaces": mp_gather,
               "launches": n_launches, "max_abs_err": tot["err"], "ms": tot["ms"],
               "device_ms": tot["device_ms"],
               "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
               "bound_by": tot["bound_by"], "library_ms": tot["library_ms"]}
        if "bound_f32_cuda_cores_ms" in tot:  # the same products on the CUDA cores
            row["bound_f32_cuda_cores_ms"] = tot["bound_f32_cuda_cores_ms"]
        return row

    k2_src = "robustpointclouds_tpu_torch/csrc/masked_stats.cu"
    k2_tpu = "robustpointclouds_tpu/kernels/masked_stats.py"

    def k2_row(name, line, n_launches, row, bound_by="bytes"):
        return {"name": name, "route": "cuda", "source": k2_src, "replaces": f"{k2_tpu}:{line}",
                "launches": n_launches, "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "device_ms": row["device_ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row.get("bound_by", bound_by), "library_ms": row["library_ms"]}

    # phase 13's serving launches on the three warm-started families
    zoo_launches = {k: zoo[k]["launches"] for k in ("second", "pointpillars", "centerpoint")}
    kernels = [
        dict(conv_row("sparse_conv", conv_src, launches["sparse_conv"], conv_tot),
             warm_start_launches={k: v[0] for k, v in zoo_launches.items()},
             data_parallel_launches_a_rank={k: v["sparse_conv"]
                                            for k, v in dp_launches.items()},
             convergence_launches_a_step=p15["convergence"]["sparse_conv"],
             plain_centerpoint_launches={k: v["sparse_conv"]
                                         for k, v in p15["centerpoint_plain"].items()},
             tools_launches_a_step={k: v["k1_fwd"] for k, v in tl.items()}),
        dict(k2_row("masked_stats", 113, launches["masked_stats"], k2),
             tools_launches_a_step={k: v["k2_stats"] for k, v in tl.items()}),
        # one train step's 17 BNs, summed; launches over the timed train steps
        dict(k2_row("masked_batch_norm", 63, train_launches["masked_batch_norm"],
                    dict(bn_tot["masked_batch_norm"], library_ms=None)),
             bound_two_pass_ms=bn_tot["masked_batch_norm"]["bound_two_pass_ms"],
             warm_start_launches={k: v[1] for k, v in zoo_launches.items()},
             data_parallel_launches_a_rank={k: v["masked_batch_norm"]
                                            for k, v in dp_launches.items()},
             convergence_launches_a_step=p15["convergence"]["masked_batch_norm"],
             plain_centerpoint_launches={k: v["masked_batch_norm"]
                                         for k, v in p15["centerpoint_plain"].items()},
             tools_launches_a_step={k: v["k2_bn"] for k, v in tl.items()}),
        dict(k2_row("masked_batch_norm_bwd", 102, train_launches["masked_batch_norm_bwd"],
                    dict(bn_tot["masked_batch_norm_bwd"], library_ms=None)),
             bound_two_pass_ms=bn_tot["masked_batch_norm_bwd"]["bound_two_pass_ms"],
             tools_launches_a_step={k: v["k2_bn_bwd"] for k, v in tl.items()}),
    ]
    for key in ("dgrad", "wgrad"):
        kernels.append(dict(conv_row(f"sparse_conv_{key}", conv_src,
                                     train_launches[f"sparse_conv_{key}"], bwd_tot[key]),
                            tools_launches_a_step={k: v[f"k1_{key}"] for k, v in tl.items()}))
    # the float32 route: launches from the small-grid float32 forward + train step
    for key, tot in (("", f32_conv_tot), ("_dgrad", f32_bwd_tot["dgrad"]),
                     ("_wgrad", f32_bwd_tot["wgrad"])):
        kernels.append(conv_row(f"sparse_conv{key}_f32", tf32_src,
                                f32_launches[f"sparse_conv{key}"], tot))
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
    kernels.extend(cp_rows)
    kernels.extend(pp_rows)
    kernels.extend(st_rows)
    kernels.extend(vr_rows)
    kernels.extend(gn_rows)
    kernels.extend(dc_rows)
    for row in (*kernels, *(r["scale"] for r in kernels if "scale" in r)):
        for key in ("device_ms", "prev_device_ms"):
            if key in row and row[key] is None:  # the profiles did not hold their set
                row[key] = "not measured"
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
