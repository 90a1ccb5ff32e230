"""Learner: the unrolled MuZero loss, Adam or SGD with the exponential lr
schedule, and the fused multi-step call (port of trainer.py).

Counterparts in the JAX package's trainer.py:
- `scale_gradient` :40, `cross_entropy` :45, `lr_schedule` :50 and
  `make_optimizer` :58-73 keep their names. Adam is
  add_decayed_weights -> scale_by_adam(eps=1e-8), which is torch Adam with
  its L2 `weight_decay` (not AdamW); SGD is add_decayed_weights ->
  trace(momentum), torch SGD without dampening or Nesterov. The schedule,
  lr_init * rate ** (step / decay_steps) with no staircase, is a LambdaLR
  stepped after every update.
- `loss_fn` is loss_fn :110-206: step 0 runs representation then
  prediction with no reward loss; steps 1..U unroll dynamics and prediction
  in a Python loop (JAX's lax.scan), the normalized hidden state's gradient
  scaled by 0.5 (:150; the reward head branches off before the
  normalization) and each step's losses by 1 / max(gradient_scale, 1)
  (:154-157); priorities |decoded value - target| ** PER_alpha [B, U+1].
- `Learner.train_step` is make_train_step's train_step :208-217 and
  `Learner.train_steps` make_fused_train_steps :226-250 (a Python loop over
  the M stacked batches, the last step's metrics, priorities [M, B, U+1]).
  TrainState :33 becomes the learner's own train-mode module (params and
  batch-norm running statistics), its optimizer and schedule, and
  `training_step`.
- `remat_unroll` :168-175 runs each unroll step under
  torch.utils.checkpoint. Batch norm in train mode updates its running
  statistics at every inference, in forward order, as flax's mutable
  batch_stats do (:100-108); the recomputed forward leaves them as they are
  (models/common.py BatchNorm.update_stats), so remat changes nothing but
  memory.

On a mesh (parallel/mesh.py shard_train_state) the learner is one rank of
the JAX package's sharded step (make_sharded_train_step): its batch is the
rank's rows of the global batch, its loss the rank's share of the global
mean (the per-sample losses summed and divided by the global batch, not
averaged over the shard), and after the backward one all_reduce over the
dp group sums the flattened gradients with the four loss metrics. The
optimizer and schedule then run replicated, so the replicated parameters
stay bit-identical across ranks. The priorities are the rank's own rows.

A step runs inside one FullPrecision (models/common.py): the forward, the
backward and the optimizer step, so cuDNN's backward convolutions do not
fall back to TF32 on the card. At compute_dtype "bfloat16" the products
run in bfloat16 (Dense, Conv), while the parameters and the optimizer
state stay float32, as in the JAX package.
"""

import contextlib
from functools import partial

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from muzero_general_tpu_torch import tracing
from muzero_general_tpu_torch.device import resolve_device
from muzero_general_tpu_torch.models import MuZeroNetwork
from muzero_general_tpu_torch.models.common import BatchNorm, FullPrecision
from muzero_general_tpu_torch.ops.support import scalar_to_support, support_to_scalar
from muzero_general_tpu_torch.parallel.mesh import all_reduce_flat, gather_sharded

LOSS_KEYS = ("total_loss", "value_loss", "reward_loss", "policy_loss")


def scale_gradient(x, scale):
    """Forward-identity, gradient scaled by `scale` (may be per sample)."""
    return x * scale + (x * (1.0 - scale)).detach()


def cross_entropy(logits, target_probs):
    """(-target * log_softmax(logits)).sum(-1) (reference trainer.py:285-300)."""
    return -(target_probs * F.log_softmax(logits, dim=-1)).sum(-1)


def lr_schedule(config):
    """step -> lr_init * lr_decay_rate ** (step / lr_decay_steps)."""

    def schedule(step):
        return config.lr_init * config.lr_decay_rate ** (step / config.lr_decay_steps)

    return schedule


def make_optimizer(config, params) -> torch.optim.Optimizer:
    """torch-equivalent Adam/SGD (reference trainer.py:37-53); the lr comes
    from `make_schedule`."""
    if config.optimizer == "Adam":
        return torch.optim.Adam(params, lr=config.lr_init, eps=1e-8,
                                weight_decay=config.weight_decay)
    if config.optimizer == "SGD":
        return torch.optim.SGD(params, lr=config.lr_init, momentum=config.momentum,
                               dampening=0, nesterov=False,
                               weight_decay=config.weight_decay)
    raise NotImplementedError(f"{config.optimizer} is not implemented.")


def make_schedule(optimizer, config, count: int = 0):
    """The LambdaLR of `lr_schedule`, with `count` updates already made: the
    next update uses lr_schedule(config)(count)."""
    rate, steps = config.lr_decay_rate, config.lr_decay_steps
    for group in optimizer.param_groups:
        group["initial_lr"] = config.lr_init
    return torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda step: rate ** (step / steps), last_epoch=count - 1
    )


def _priority(value_logits, target_value, support_size, alpha):
    return torch.abs(
        support_to_scalar(value_logits.detach(), support_size) - target_value
    ) ** alpha


def _unroll_step(network, support_size, alpha, hidden, action, tv_support,
                 target_value, tr_support, target_policy, inv_scale):
    """One dynamics + prediction step of the unroll (JAX unroll_body :141)."""
    hidden, reward_logits = network.dynamics(hidden, action)
    # x0.5 total-gradient hook at the normalized hidden state (reference
    # trainer.py:178): the prediction heads and the next dynamics input.
    hidden = scale_gradient(hidden, 0.5)
    policy_logits, value_logits = network.prediction(hidden)
    vl = scale_gradient(cross_entropy(value_logits, tv_support), inv_scale)
    rl = scale_gradient(cross_entropy(reward_logits, tr_support), inv_scale)
    pl = scale_gradient(cross_entropy(policy_logits, target_policy), inv_scale)
    return hidden, vl, rl, pl, _priority(value_logits, target_value, support_size, alpha)


def loss_fn(network, batch, config, recompute_context=None, global_batch=None):
    """The MuZero loss of a train-mode network on one batch of tensors.

    `recompute_context`: None runs the unroll plainly; else each unroll step
    runs under torch.utils.checkpoint, its recomputation inside the context
    this callable returns. `global_batch`: on a mesh, the rows of the whole
    dp batch; the loss and metrics are then this batch's sums over it (its
    share of the global mean). Returns (loss, metrics of 0-d tensors,
    priorities [B, U+1]), the metrics and priorities detached.
    """
    S, alpha = config.support_size, config.PER_alpha
    target_value = batch["target_value"]  # [B, U+1] scalar
    target_policy = batch["target_policy"]  # [B, U+1, A]
    actions = batch["action"]  # [B, U+1]
    tv_support = scalar_to_support(target_value, S)  # [B, U+1, bins]
    tr_support = scalar_to_support(batch["target_reward"], S)
    inv_scale = 1.0 / torch.clamp(batch["gradient_scale"], min=1.0)

    # ---- step 0: initial inference; reward loss ignored ------------------
    hidden = network.representation(batch["observation"])
    policy_logits, value_logits = network.prediction(hidden)
    value_loss = cross_entropy(value_logits, tv_support[:, 0])
    policy_loss = cross_entropy(policy_logits, target_policy[:, 0])
    reward_loss = torch.zeros_like(value_loss)
    priorities = [_priority(value_logits, target_value[:, 0], S, alpha)]

    # ---- steps 1..U: the dynamics unroll ---------------------------------
    step = partial(_unroll_step, network, S, alpha)
    losses = []
    for u in range(1, actions.shape[1]):
        args = (hidden, actions[:, u], tv_support[:, u], target_value[:, u],
                tr_support[:, u], target_policy[:, u], inv_scale[:, u])
        if recompute_context is None:
            hidden, *out = step(*args)
        else:
            hidden, *out = checkpoint(
                step, *args, use_reentrant=False, preserve_rng_state=False,
                context_fn=lambda: (contextlib.nullcontext(), recompute_context()),
            )
        losses.append(out[:3])
        priorities.append(out[3])
    if losses:
        vls, rls, pls = (torch.stack(parts).sum(0) for parts in zip(*losses))
        value_loss = value_loss + vls
        reward_loss = reward_loss + rls
        policy_loss = policy_loss + pls

    loss = value_loss * config.value_loss_weight + reward_loss + policy_loss
    if config.PER:
        # IS-weight PER bias correction (reference trainer.py:254-256)
        loss = loss * batch["weight"]
    def mean(x):
        return x.mean() if global_batch is None else x.sum() / global_batch

    loss = mean(loss)
    metrics = {
        "total_loss": loss.detach(),
        "value_loss": mean(value_loss.detach()),
        "reward_loss": mean(reward_loss.detach()),
        "policy_loss": mean(policy_loss.detach()),
    }
    return loss, metrics, torch.stack(priorities, dim=1)


class Learner:
    """The training state and its steps on one device (device=None: the
    card).

    `network` is the learner's own module, in train mode, built from
    config (weights drawn from `seed`, default config.seed); load weights
    into it with load_state_dict (or checkpoint.restore_learner). After a
    round of steps, hand them to self-play with
    `SelfPlayDriver.load_weights(learner.full_state_dict())`.

    `mesh`: None until parallel.shard_train_state puts the learner on a
    mesh (see the module docstring).
    """

    def __init__(self, config, device=None, seed=None):
        self.config = config
        self.device = resolve_device(device)
        self.network = MuZeroNetwork(config, self.device, seed).train()
        self.optimizer = make_optimizer(config, self.network.parameters())
        self.scheduler = make_schedule(self.optimizer, config)
        self.training_step = 0
        self.metrics = None  # the last step's, with "lr"
        self.mesh = None
        self.sharded_names = set()  # mp-sharded parameter names on a mesh
        self._norms = [m for m in self.network.modules() if isinstance(m, BatchNorm)]
        self._recompute = (
            self._frozen_batch_stats if getattr(config, "remat_unroll", True) else None
        )

    @contextlib.contextmanager
    def _frozen_batch_stats(self):
        for norm in self._norms:
            norm.update_stats = False
        try:
            yield
        finally:
            for norm in self._norms:
                norm.update_stats = True

    def set_schedule_count(self, count: int):
        """Resume the schedule after `count` updates."""
        self.scheduler = make_schedule(self.optimizer, self.config, count)

    def lr(self) -> float:
        """The lr of the next update."""
        return self.scheduler.get_last_lr()[0]

    def _on_device(self, batch):
        t = tracing.begin()
        batch = {key: torch.as_tensor(value).to(self.device) for key, value in batch.items()}
        tracing.end(t, "train.to_device")
        return batch

    def full_state_dict(self):
        """The network's state dict with the mp-sharded layers' slices
        gathered into full arrays (collective over the mp group on a mesh
        with mp > 1; every rank must call it)."""
        return gather_sharded(self.network.state_dict(), self)

    def _global_batch(self, batch):
        if self.mesh is None:
            return None
        return batch["action"].shape[0] * self.mesh.shape["dp"]

    def _reduce_over_dp(self, metrics):
        """One all_reduce over the dp group of the flattened gradients and
        the loss metrics (each rank's share of the global mean)."""
        params = list(self.network.parameters())
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        keys = list(LOSS_KEYS)
        stacked = torch.stack([metrics[k] for k in keys]).to(params[0].grad.dtype)
        *grads, summed = all_reduce_flat([p.grad for p in params] + [stacked],
                                         self.mesh.dp_group)
        for p, g in zip(params, grads):
            p.grad.copy_(g)
        return dict(zip(keys, summed.unbind()))

    def _step(self, batch):
        lr = self.lr()
        t = tracing.begin()
        loss, metrics, priorities = loss_fn(self.network, batch, self.config,
                                            self._recompute, self._global_batch(batch))
        t = tracing.end(t, "train.forward")
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        t = tracing.end(t, "train.backward")
        if self.mesh is not None and self.mesh.dp_group is not None:
            metrics = self._reduce_over_dp(metrics)
            t = tracing.end(t, "train.allreduce")
        self.optimizer.step()
        t = tracing.end(t, "train.optimizer")
        self.scheduler.step()
        self.training_step += 1
        metrics["lr"] = lr  # the schedule before the update (JAX :215)
        self.metrics = metrics
        tracing.end(t, "train.schedule")
        return metrics, priorities

    def train_step(self, batch):
        """One step on a batch (replay.get_batch's dict of arrays or
        tensors). Returns (metrics, priorities [B, U+1] on the device)."""
        batch = self._on_device(batch)
        with FullPrecision():
            return self._step(batch)

    def train_steps(self, batches):
        """M steps on `batches`, a dict of arrays stacked on a leading axis
        M, moved to the device in one copy a key. Returns (the last step's
        metrics, priorities [M, B, U+1] on the device)."""
        batches = self._on_device(batches)
        num = next(iter(batches.values())).shape[0]
        priorities = []
        with FullPrecision():
            for m in range(num):
                metrics, pr = self._step({key: value[m] for key, value in batches.items()})
                priorities.append(pr)
        return metrics, torch.stack(priorities)
