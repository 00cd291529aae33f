"""Min-max adversarial training: one backward, two optimizers (counterpart of robustpointclouds_tpu/train/loop.py).

One train step: the plan-fed anchor-head model's forward in train mode
(AdversarialVoxelNet, or AdversarialPointPillars for a PointPillarsConfig;
the adversary's perturbation delta behind the gradient-reversal layer) ->
anchor_head_loss + adversary_direct_terms -> one backward -> the two
optimizer chains of the JAX package, written out because two torch.optim
optimizers over disjoint parameter groups do not reproduce them:

  * both optax chains see the *whole* gradient tree and the adversary mask
    is applied after (loop.py:410-418), so the detector's global-norm clip
    counts the adversary's gradients too, and the adversary's chain runs
    zero_nans -> per-element clip -> global-norm clip over the whole tree;
  * Adam (b1, b2, eps outside the sqrt) -> + weight_decay * p on every
    parameter (BatchNorm scale and bias included) -> x schedule(count)
    (x adversary_lr_mult for the adversary) -> x -1;
  * count is the number of previous updates, so step 0 uses the warm-up's
    first value; it and the Adam moments advance on a NaN step too (on the
    sanitised gradients), while the update is multiplied by
    lr_scale * (1 - is_nan) and the BatchNorm running stats are restored.
Adam is elementwise, so each parameter keeps only the moments of its own
chain; the global norms are taken over every gradient, as in JAX.

The NaN counters, the ladder's LR multiplier and the adversary kill switch
live on the device (TrainState) and are read by the host only at logging
boundaries (train/hooks.NaNLadder).

Freeze-detector mode (TrainConfig.freeze_detector) multiplies the detector
chain's schedule by 0, as the JAX `make_optimizers` does: its Adam moments
and the count advance, its parameters stay bit-unchanged, and its BatchNorm
running statistics still move in train mode. PGD adversarial training
(TrainConfig.pgd_steps > 0, `_maybe_pgd`) rewrites the plan's voxels with a
K-step white-box attack at the current weights (eval/attacks.PlanAttack)
before the gradient half of the step; the attack is a constant of the
step's backward. The host plan comes from HostPlanBuilder (SECOND) or
PillarPlanBuilder (the pillar family), as `make_plan_builder` picks. With
`plan=None` the step is inline, as JAX's: the model builds the plan from
the batch's points on the device and the loss assigns the anchors there
(anchor_head_loss with no "assign").

Data parallel (`compile_sharded(group)`, JAX's `_sharded_step_impl`): each
rank of a torch.distributed process group runs the step on its own rows
with its own host plan (PGD-AT attacks that plan), computes and sanitises
its gradients, then ONE all-reduce over one flat buffer averages the
gradients, the BatchNorm running statistics (written back into the modules
before the optimizer half, so a global NaN step restores every rank's old
ones) and the logs, and sums the NaN flags: a NaN on any rank is a NaN
step on every rank. Each forward normalises with its rank's own batch
statistics, as non-synchronised DDP does. Not torch's
DistributedDataParallel: its hooks average during backward, before the
sanitation, it copies rank 0's BatchNorm buffers instead of averaging
them, and it does not average the logs.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..core.device import resolve_device
from ..core.spans import span
from ..data.native_plan import build_pillar_plan_native, build_plan_native
from ..models.detection import anchor_head_loss
from ..models.pointpillars import AdversarialPointPillars, PointPillarsConfig
from ..models.voxelnet import (AdversarialVoxelNet, VoxelNetConfig, adversary_direct_terms,
                               anchor_assign_plan, init_weights, plan_to_device)
from ..parallel import mesh as dp
from .hooks import device_nan_ladder


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimisation schedule (reference recipe, the JAX TrainConfig's defaults)."""

    learning_rate: float = 1e-4
    adversary_lr_mult: float = 2.0
    weight_decay: float = 1e-3
    betas: Tuple[float, float] = (0.9, 0.999)
    grad_clip_norm: float = 0.5
    adversary_grad_clip_value: float = 0.1
    warmup_iters: int = 2000
    warmup_start_factor: float = 0.1
    max_epochs: int = 30
    steps_per_epoch: int = 1000
    eta_min_factor: float = 0.01
    adversarial_loss_weight: float = 1.0
    regularization_weight: float = 0.02
    # the reference's --freeze-detector mode: detector learning off
    freeze_detector: bool = False
    # PGD adversarial training: > 0 attacks the plan's voxels with a
    # pgd_steps-step PGD (step rel_step * clamp / steps) inside the train step
    pgd_steps: int = 0
    pgd_rel_step: float = 2.5


def make_lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """Linear warm-up (factor 0.1 over warmup_iters) then cosine to eta_min
    over the rest of training: optax's linear_schedule joined to
    cosine_decay_schedule at warmup_iters, as a function of the update count."""
    total = cfg.max_epochs * cfg.steps_per_epoch
    lr = cfg.learning_rate
    start = lr * cfg.warmup_start_factor
    decay_steps = max(total - cfg.warmup_iters, 1)

    def schedule(count: int) -> float:
        if count < cfg.warmup_iters:
            frac = 1.0 - min(max(count, 0), cfg.warmup_iters) / cfg.warmup_iters
            return (start - lr) * frac + lr
        t = min(count - cfg.warmup_iters, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))
        return lr * ((1.0 - cfg.eta_min_factor) * cosine + cfg.eta_min_factor)

    return schedule


class AdamChain:
    """One optax chain: [per-element clip] -> global-norm clip (the norm over
    the whole gradient tree, given by the caller) -> Adam -> weight decay ->
    x schedule(count) * lr_mult -> x -1. State: the Adam moments of the
    chain's own parameters; the shared update count lives in TrainState."""

    def __init__(self, schedule: Callable[[int], float], lr_mult: float, max_norm: float,
                 betas: Tuple[float, float], weight_decay: float,
                 clip_value: Optional[float] = None, eps: float = 1e-8):
        self.schedule = schedule
        self.lr_mult = lr_mult
        self.max_norm = max_norm
        self.b1, self.b2 = betas
        self.weight_decay = weight_decay
        self.clip_value = clip_value
        self.eps = eps

    def preclip(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """zero_nans (a no-op on the trainer's sanitised gradients) and the
        per-element clip, applied to every gradient before the global norm."""
        if self.clip_value is None:
            return grads
        return [g.clamp(-self.clip_value, self.clip_value) for g in grads]

    def update(self, grads: List[torch.Tensor], params: List[torch.Tensor],
               mu: List[torch.Tensor], nu: List[torch.Tensor], norm: torch.Tensor,
               count: int) -> List[torch.Tensor]:
        """Updates of `params` from their (pre-clipped) gradients; advances mu
        and nu in place. `norm`: the global norm of the whole pre-clipped tree."""
        if not params:
            return []
        factor = torch.where(norm < self.max_norm, torch.ones_like(norm), self.max_norm / norm)
        g = torch._foreach_mul(grads, factor)
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
        n = count + 1
        den = torch._foreach_div(nu, 1.0 - self.b2 ** n)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(mu, 1.0 - self.b1 ** n)
        torch._foreach_div_(upd, den)
        torch._foreach_add_(upd, params, alpha=self.weight_decay)
        torch._foreach_mul_(upd, -self.schedule(count) * self.lr_mult)
        return upd


def make_optimizers(cfg: TrainConfig) -> Tuple[AdamChain, AdamChain]:
    """(detector chain, adversary chain), as train/loop.make_optimizers; in
    freeze-detector mode the detector chain's schedule is multiplied by 0."""
    sched = make_lr_schedule(cfg)
    det = AdamChain(sched, 0.0 if cfg.freeze_detector else 1.0, cfg.grad_clip_norm, cfg.betas,
                    cfg.weight_decay)
    adv = AdamChain(sched, cfg.adversary_lr_mult, cfg.grad_clip_norm, cfg.betas,
                    cfg.weight_decay, clip_value=cfg.adversary_grad_clip_value)
    return det, adv


@dataclasses.dataclass
class TrainState:
    """What the JAX TrainState holds besides the parameters (which live in
    the model): the step, the shared update count of both chains, the Adam
    moments by parameter name and the device-side NaN ladder."""

    step: int
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    nan_count: torch.Tensor          # int32, total NaN steps
    consecutive_nan: torch.Tensor    # int32
    lr_scale: torch.Tensor           # float32, reduced by the NaN ladder
    adversary_enabled: torch.Tensor  # float32 kill switch (1.0 / 0.0)


def _global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class HostPlanBuilder:
    """The host plan of one batch: the native index plan (data/native_plan.py)
    plus, given GTs, the anchor assignment (models/voxelnet.anchor_assign_plan,
    CPU torch). Runs in the input pipeline's prefetch thread; both parts
    release the interpreter lock in native code. Returns numpy arrays.
    Subclasses change `_native` (the index plan of their family).

    `timings` keeps, per call and in call order, the host-clock ms of the two
    parts ({"native_ms", "assign_ms", "plan_ms"}; assign_ms is 0 without GTs),
    the newest `_TIMINGS_KEPT` of them."""

    _TIMINGS_KEPT = 1024

    def __init__(self, model_cfg: VoxelNetConfig):
        self._cfg = model_cfg
        a, c = model_cfg.make_anchors()
        self._anchors = (torch.from_numpy(a), torch.from_numpy(c))
        self.timings: collections.deque = collections.deque(maxlen=self._TIMINGS_KEPT)

    def _native(self, points: np.ndarray, points_mask: np.ndarray) -> Dict[str, Any]:
        return build_plan_native(points, points_mask, self._cfg.voxelizer, 4)

    def __call__(self, points, points_mask, gt_boxes=None, gt_labels=None, gt_mask=None):
        t0 = time.perf_counter()
        plan = self._native(np.asarray(points), np.asarray(points_mask))
        t1 = time.perf_counter()
        if gt_boxes is not None:
            plan["assign"] = anchor_assign_plan(gt_boxes, gt_labels, gt_mask, self._cfg,
                                                anchors=self._anchors)
        t2 = time.perf_counter()
        self.timings.append({"native_ms": (t1 - t0) * 1e3, "assign_ms": (t2 - t1) * 1e3,
                             "plan_ms": (t2 - t0) * 1e3})
        return plan


class PillarPlanBuilder(HostPlanBuilder):
    """The pillar family's host plan: the native pillar plan (voxels, the
    merged BEV grid and its dense-cell map; data/native_plan.py) plus the
    anchor assignment, with HostPlanBuilder's `timings` split."""

    def _native(self, points: np.ndarray, points_mask: np.ndarray) -> Dict[str, Any]:
        return build_pillar_plan_native(points, points_mask, self._cfg.voxelizer, 4)


class Trainer:
    """Owns the model, the two optimizer chains and the train state: an
    AdversarialVoxelNet for a VoxelNetConfig, an AdversarialPointPillars
    for a PointPillarsConfig (the same call and loss contract).

    Runs on the card unless `device` asks for another (core/device)."""

    state_cls = TrainState  # what a checkpoint's train state is read back as
    group = None  # the data-parallel step's process group (compile_sharded)
    # called as grad_probe(grads, is_nan) with the step's gradients before
    # the NaN sanitation (tools/diag_centerpoint_nan reads them there)
    grad_probe: Optional[Callable[[Dict[str, torch.Tensor], torch.Tensor], None]] = None

    def __init__(self, model_cfg: Union[VoxelNetConfig, PointPillarsConfig] = VoxelNetConfig(),
                 train_cfg: TrainConfig = TrainConfig(),
                 device: Optional[Union[str, torch.device]] = None):
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        self.device = resolve_device(device)
        self.model = self._make_model(model_cfg).to(self.device)
        # a strong config wraps its detector's under .base
        anchors, anchor_cls = getattr(model_cfg, "base", model_cfg).make_anchors()
        self.anchors = torch.as_tensor(anchors, device=self.device)
        self.anchor_cls = torch.as_tensor(anchor_cls, device=self.device)
        self.det_tx, self.adv_tx = make_optimizers(train_cfg)
        self.state: Optional[TrainState] = None
        self._pgd = None

    @staticmethod
    def _make_model(model_cfg) -> nn.Module:
        if isinstance(model_cfg, PointPillarsConfig):
            return AdversarialPointPillars(model_cfg)
        if isinstance(model_cfg, VoxelNetConfig):
            return AdversarialVoxelNet(model_cfg)
        raise TypeError(f"Trainer takes a VoxelNetConfig or a PointPillarsConfig, not "
                        f"{type(model_cfg).__name__}")

    # -- initialisation -----------------------------------------------------
    def init_state(self, seed: int = 0,
                   state_dict: Optional[Dict[str, torch.Tensor]] = None) -> TrainState:
        """Random weights from `seed` (or `state_dict`), zero Adam moments,
        cleared counters."""
        if state_dict is None:
            init_weights(self.model, torch.Generator().manual_seed(seed))
        else:
            self.model.load_state_dict(state_dict)
        dev = self.device
        params = dict(self.model.named_parameters())
        self.state = TrainState(
            step=0, count=0,
            mu={k: torch.zeros_like(p) for k, p in params.items()},
            nu={k: torch.zeros_like(p) for k, p in params.items()},
            nan_count=torch.zeros((), dtype=torch.int32, device=dev),
            consecutive_nan=torch.zeros((), dtype=torch.int32, device=dev),
            lr_scale=torch.ones((), dtype=torch.float32, device=dev),
            adversary_enabled=torch.ones((), dtype=torch.float32, device=dev),
        )
        return self.state

    # -- data parallel ----------------------------------------------------------
    def compile_sharded(self, group) -> "Trainer":
        """Make train_step the data-parallel step over the torch.distributed
        process `group` (see the module docstring); returns self."""
        self.group = group
        return self

    def replicate(self, group) -> None:
        """Rank 0's model (parameters and buffers) and train state on every
        rank of `group`: after init, a warm start or a resume on rank 0."""
        dp.replicate(self.model, group)
        st = self.state
        fields = [f.name for f in dataclasses.fields(st)]
        tensors, ints = [], []
        for name in fields:
            v = getattr(st, name)
            if isinstance(v, dict):
                tensors += [v[k] for k in sorted(v)]
            elif isinstance(v, torch.Tensor):
                tensors.append(v)
            else:
                ints.append(name)
        dp.replicate(tensors, group)
        for name, v in zip(ints, dp.broadcast_ints([getattr(st, n) for n in ints], group)):
            setattr(st, name, v)

    def _average(self, grads: Dict[str, torch.Tensor], logs: Dict[str, torch.Tensor],
                 is_nan: torch.Tensor):
        """The data-parallel step's reduction (JAX's pmean of grads, batch
        stats and logs, psum of is_nan > 0), in one all-reduce; the averaged
        BatchNorm running statistics go back into the modules."""
        bn = self._bn_buffers()
        out, any_nan = dp.average_step([*grads.values(), *bn, *logs.values()], is_nan,
                                       self.group)
        n, m = len(grads), len(grads) + len(bn)
        with torch.no_grad():
            for b, v in zip(bn, out[n:m]):
                b.copy_(v)
        return dict(zip(grads, out[:n])), dict(zip(logs, out[m:])), any_nan

    @staticmethod
    def is_adversary(name: str) -> bool:
        return name.startswith("adversary.")

    def _bn_buffers(self) -> List[torch.Tensor]:
        return [b for m in self.model.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)
                for b in (m.running_mean, m.running_var)]

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x,
                               device=self.device)

    def _to_device(self, batch, plan):
        t = self._tensor
        gt = (t(batch.gt_boxes).float(), t(batch.gt_labels).to(torch.int32), t(batch.gt_mask).bool())
        return gt, None if plan is None else plan_to_device(plan, self.device)

    def _points(self, batch, plan) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """The batch's points and mask on the device for the inline path
        (plan None) and for a model that reads them beside its plan
        (`reads_points`: the compact voxel adversary, which raises if a call
        that runs it gets none); else (None, None): a plan-fed call reads
        only the plan."""
        if plan is not None and (batch is None or not getattr(self.model, "reads_points", False)):
            return None, None
        if batch is None:
            raise ValueError("plan=None (the inline path) needs the batch's points")
        return self._tensor(batch.points).float(), self._tensor(batch.points_mask).bool()

    # -- the step -------------------------------------------------------------
    def _loss_fn(self, gt, epoch: float, plan: Optional[Dict[str, Any]], points=(None, None)):
        """Forward + losses -> (total scalar, logs, is_nan), as the JAX _loss_fn;
        with no plan the forward builds it from `points` (points, mask) and
        the loss assigns the anchors."""
        adv_enabled = self.state.adversary_enabled
        outs = self.model(*points, True, epoch, False,
                          -self.train_cfg.adversarial_loss_weight * adv_enabled, plan)
        with span("rpc.loss"):
            gt_boxes, gt_labels, gt_mask = gt
            det = anchor_head_loss(outs.cls_scores, outs.bbox_preds, outs.dir_preds,
                                   self.anchors, self.anchor_cls, gt_boxes, gt_labels, gt_mask,
                                   self.model_cfg.head,
                                   assign=None if plan is None else plan.get("assign"))
            det_total = det["loss_cls"] + det["loss_bbox"] + det["loss_dir"]
            adv_total, adv_logs = adversary_direct_terms(det, outs.adv_aux, epoch,
                                                         self.train_cfg.regularization_weight)
            total = det_total + adv_enabled * adv_total
            is_nan = ~torch.isfinite(total)
            total = torch.where(is_nan, torch.zeros_like(total), total)
            logs = {"loss": det_total.detach(), "loss_cls": det["loss_cls"].detach(),
                    "loss_bbox": det["loss_bbox"].detach(), "loss_dir": det["loss_dir"].detach(),
                    "num_pos": det["num_pos"].detach(),
                    **{k: v.detach() for k, v in adv_logs.items()}}
        return total, logs, is_nan

    def _grads(self, gt, epoch: float, plan: Optional[Dict[str, Any]], points=(None, None)):
        """Backward + NaN sanitation -> (grads by parameter name, logs, is_nan).
        A non-finite gradient element anywhere is replaced by 0 and makes the
        step a NaN step."""
        self.model.train()
        for p in self.model.parameters():
            p.grad = None
        total, logs, is_nan = self._loss_fn(gt, epoch, plan, points)
        with span("rpc.backward"):
            total.backward()
            grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                     for k, p in self.model.named_parameters()}
            if self.grad_probe is not None:
                self.grad_probe(grads, is_nan)
            finite = torch.stack([torch.isfinite(g).all() for g in grads.values()]).all()
            for g in grads.values():
                torch.nan_to_num_(g, nan=0.0, posinf=0.0, neginf=0.0)
            return grads, logs, is_nan | ~finite

    @torch.no_grad()
    def _apply(self, grads: Dict[str, torch.Tensor], is_nan: torch.Tensor,
               old_stats: List[torch.Tensor]) -> None:
        """Optimizer half of the step, as the JAX _apply."""
        st = self.state
        params = dict(self.model.named_parameters())
        names = list(params)
        g_all = [grads[k] for k in names]
        g_adv_all = self.adv_tx.preclip(g_all)
        norm_det, norm_adv = _global_norm(g_all), _global_norm(g_adv_all)
        updates = {}
        for tx, norm, g_list, sel in ((self.det_tx, norm_det, g_all, False),
                                      (self.adv_tx, norm_adv, g_adv_all, True)):
            keys = [k for k in names if self.is_adversary(k) == sel]
            gs = [g for k, g in zip(names, g_list) if self.is_adversary(k) == sel]
            upd = tx.update(gs, [params[k] for k in keys], [st.mu[k] for k in keys],
                            [st.nu[k] for k in keys], norm, st.count)
            updates.update(zip(keys, upd))
        # a NaN forward also taints the BN running stats: keep the old ones
        for new, old in zip(self._bn_buffers(), old_stats):
            new.copy_(torch.where(is_nan, old, new))
        scale = st.lr_scale * (1.0 - is_nan.to(torch.float32))
        for k in names:
            u = torch.nan_to_num_(updates[k], nan=0.0, posinf=0.0, neginf=0.0)
            params[k].add_(u * scale)
        nan_i = is_nan.to(torch.int32)
        st.nan_count, st.lr_scale, st.adversary_enabled = device_nan_ladder(
            st.nan_count, nan_i, st.lr_scale, st.adversary_enabled)
        st.consecutive_nan = (st.consecutive_nan + nan_i) * nan_i
        st.step += 1
        st.count += 1

    def train_step(self, batch, epoch: float,
                   plan: Optional[Dict[str, Any]] = None) -> Dict[str, torch.Tensor]:
        """One step on `batch` (a PointCloudBatch; its GTs are read) with its
        host plan (HostPlanBuilder, with "assign"), or inline with plan=None
        (the plan and the assignment built on the device from the batch's
        points). Returns the logs as device scalars; reading them waits for
        the step. Data parallel (compile_sharded): `batch` and `plan` are this
        rank's rows and their plan, the logs the ranks' average."""
        return self._step(batch, epoch, plan, self._to_device)

    def _step(self, batch, epoch: float, plan: Optional[Dict[str, Any]],
              inputs: Callable) -> Dict[str, torch.Tensor]:
        """The step under its spans; `inputs(batch, plan)` -> (the loss's
        GTs, the plan on the device), the family's own."""
        if self.state is None:
            raise RuntimeError("call init_state() first")
        with span("rpc.train_step"):
            gt, plan_t = inputs(batch, plan)
            plan_t = self._maybe_pgd(batch, plan_t)
            old_stats = [b.clone() for b in self._bn_buffers()]
            grads, logs, is_nan = self._grads(gt, float(epoch), plan_t,
                                              self._points(batch, plan_t))
            if self.group is not None:
                grads, logs, is_nan = self._average(grads, logs, is_nan)
            with span("rpc.optimizer"):
                self._apply(grads, is_nan, old_stats)
            return logs

    def _maybe_pgd(self, batch, plan: Optional[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
        """PGD adversarial training: `plan` with its voxels attacked by a
        pgd_steps-step PGD at the current weights (eval-mode forward, weights
        frozen; BatchNorm running stats and `requires_grad` left as found)."""
        if not self.train_cfg.pgd_steps:
            return plan
        if plan is None:
            raise ValueError("pgd_steps > 0 needs the plan-fed path: PGD-AT perturbs the "
                             "plan's raw voxels, as the JAX package's does, so the inline "
                             "step (plan=None) has nothing to attack; feed train_step a "
                             "host plan")
        if self._pgd is None:
            from ..eval.attacks import make_plan_attack

            self._pgd = make_plan_attack(self, steps=self.train_cfg.pgd_steps,
                                         rel_step=self.train_cfg.pgd_rel_step)
        return self._pgd(batch, plan)

    def make_plan_builder(self) -> HostPlanBuilder:
        """Host-side plan builder of the model's family for the input pipeline."""
        if isinstance(self.model_cfg, PointPillarsConfig):
            return PillarPlanBuilder(self.model_cfg)
        return HostPlanBuilder(self.model_cfg)

    # -- eval ---------------------------------------------------------------
    @torch.no_grad()
    def forward_eval(self, plan: Optional[Dict[str, Any]] = None, attack: bool = False,
                     batch=None):
        """Inference forward on a host plan, or inline (plan=None) on the
        points of `batch`, the plan built on the device (eval-mode BN;
        `attack` applies the learned adversary with the evaluation-attack
        bounds). With a host plan, `batch` gives the compact adversary
        (COMPACT_PERT) its points."""
        self.model.eval()
        plan_t = None if plan is None else plan_to_device(plan, self.device)
        return self.model(*self._points(batch, plan_t), False, 100, attack, -1.0, plan_t)
