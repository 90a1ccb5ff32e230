"""The collectives of the mesh's layers, as autograd Functions.

Column-parallel (mp) layers, as Megatron-LM writes them:
- `mp_input`: identity forward, all_reduce backward, on the layer's input
  (each mp rank's slice of the output contributes to the input's gradient);
- `mp_output`: all_gather forward along the feature axis, the rank's slice
  of the gradient backward (the layers after it run replicated on every mp
  rank, so each holds the whole output gradient).
torch.distributed.nn.functional.all_gather is not used: its backward is a
reduce_scatter, which gloo lacks.

`group_gather`: all_gather forward (the ranks' tensors stacked in rank
order), all_reduce then the rank's row backward. The global batch norm
gathers its per-channel statistics over the dp group with it: every rank's
loss depends on every rank's statistics, so each rank's share of their
gradient is the sum of all ranks' gradients.

With gloo on CUDA tensors the collectives stage through the host; the
arithmetic stays on the device.
"""

import torch
import torch.distributed as dist


def _all_gather(x, group):
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts


class _MPInput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _MPOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.dim, ctx.size = dim, x.shape[dim]
        ctx.index = dist.get_rank(group)
        return torch.cat(_all_gather(x, group), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.index * ctx.size, ctx.size).contiguous(), None, None


class _GroupGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.index = group, dist.get_rank(group)
        return torch.stack(_all_gather(x, group))

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad[ctx.index], None


def mp_input(x, group):
    return _MPInput.apply(x, group)


def mp_output(x, group, dim):
    return _MPOutput.apply(x, group, dim)


def group_gather(x, group):
    return _GroupGather.apply(x, group)


def gather_cat(x, group, dim=0):
    """The mp slices of a parameter (or its optimizer moment) joined along
    `dim`, on every rank of the group; no gradient."""
    return torch.cat(_all_gather(x.detach(), group), dim=dim)
