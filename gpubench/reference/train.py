"""Plain PyTorch reference of MuZero's training step (muzero-general
trainer.py): the unrolled loss over the residual reference network in
train mode, its gradient by autograd, and SGD with momentum and L2 weight
decay under the exponential learning-rate schedule.

The loss: step 0 runs representation and prediction (value and policy
losses, no reward loss); steps 1..U run dynamics and prediction, the hidden
state's gradient scaled by 0.5 and each step's losses by
1 / max(gradient_scale, 1); value targets and rewards are encoded as
two-hot distributions over the support after h(x) = sign(x)(sqrt(|x|+1)-1)
+ 0.001x; the total is value * value_loss_weight + reward + policy, times
the PER weight, averaged over the batch.
"""

import torch
import torch.nn.functional as F

from gpubench.reference.resnet import FullFloat32, ResNetReference, layer_specs


def scalar_to_support(x, support_size):
    x = torch.sign(x) * (torch.sqrt(torch.abs(x) + 1.0) - 1.0) + 0.001 * x
    x = torch.clamp(x, -support_size, support_size)
    floor = torch.floor(x)
    prob = x - floor
    low = (floor + support_size).long()
    high = low + 1
    bins = 2 * support_size + 1
    over = high > bins - 1  # mass past the top bin is dropped
    prob = torch.where(over, 0.0, prob)
    high = torch.where(over, 0, high)
    return (F.one_hot(low, bins) * (1.0 - prob)[..., None]
            + F.one_hot(high, bins) * prob[..., None])


def cross_entropy(logits, target):
    return -(target * F.log_softmax(logits, dim=-1)).sum(-1)


def scale_gradient(x, scale):
    return x * scale + (x * (1.0 - scale)).detach()


def loss(net: ResNetReference, batch, cfg):
    S = cfg["support_size"]
    tv = scalar_to_support(batch["target_value"], S)
    tr = scalar_to_support(batch["target_reward"], S)
    tp = batch["target_policy"]
    inv = 1.0 / torch.clamp(batch["gradient_scale"], min=1.0)
    hidden = net.representation(batch["observation"])
    policy, value = net.prediction(hidden)
    value_loss = cross_entropy(value, tv[:, 0])
    policy_loss = cross_entropy(policy, tp[:, 0])
    reward_loss = torch.zeros_like(value_loss)
    for u in range(1, batch["action"].shape[1]):
        hidden, reward = net.dynamics(hidden, batch["action"][:, u])
        hidden = scale_gradient(hidden, 0.5)
        policy, value = net.prediction(hidden)
        value_loss = value_loss + scale_gradient(cross_entropy(value, tv[:, u]), inv[:, u])
        reward_loss = reward_loss + scale_gradient(cross_entropy(reward, tr[:, u]), inv[:, u])
        policy_loss = policy_loss + scale_gradient(cross_entropy(policy, tp[:, u]), inv[:, u])
    total = value_loss * cfg["value_loss_weight"] + reward_loss + policy_loss
    if cfg["PER"]:
        total = total * batch["weight"]
    return total.mean()


def trainable(cfg):
    """Names of the tensors SGD updates (not the batch norms' statistics)."""
    return [name for name, kind, _ in layer_specs(cfg)
            if kind in ("conv", "dense", "bn_weight", "bn_bias") or kind.startswith("bias:")]


def sgd_steps(cfg, params, batches, precision="float32"):
    """len(batches) SGD steps from `params` (not modified). Returns
    (losses, the first step's gradient as the optimizer takes it, g + wd * p,
    the first step's bare gradient, and each leaf's change after the last
    step), the last three as {name: tensor}."""
    names = trainable(cfg)
    p = {k: v.detach().clone() for k, v in params.items()}
    buf, losses, first, bare = {}, [], None, None
    for step, batch in enumerate(batches):
        lr = cfg["lr_init"] * cfg["lr_decay_rate"] ** (step / cfg["lr_decay_steps"])
        leaves = [p[n].requires_grad_(True) for n in names]
        net = ResNetReference(cfg, p, precision, train=True, checkpoint_blocks=True)
        with FullFloat32():
            value = loss(net, batch, cfg)
            grads = torch.autograd.grad(value, leaves)
        losses.append(float(value.detach()))
        with torch.no_grad():
            for n, leaf, g in zip(names, leaves, grads):
                d = g + cfg["weight_decay"] * leaf
                buf[n] = d if step == 0 else cfg["momentum"] * buf[n] + d
                p[n] = (leaf - lr * buf[n]).detach()
            if step == 0:
                first = {n: buf[n].clone() for n in names}
                bare = {n: g.detach() for n, g in zip(names, grads)}
    change = {n: p[n] - params[n] for n in names}
    return losses, first, bare, change
