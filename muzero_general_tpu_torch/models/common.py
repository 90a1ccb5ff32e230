"""Shared model building blocks (port of models/common.py).

`nn.Linear`'s and `nn.Conv2d`'s default inits, U(+-1/sqrt(fan_in)) for weight
and bias, are the JAX package's `TorchDense` and `TorchConv` inits;
`reset_parameters` redraws them from an explicit generator. Submodules are
named like the flax layers (`TorchDense_<i>`, `TorchConv_<i>`,
`BatchNorm_<i>`), so a JAX parameter tree maps onto the state dict by name
(models/network.py `params_from_jax`). Convolutions are NCHW, PyTorch's
layout; the JAX package's are NHWC.

Mixed precision follows the JAX package's TorchDense and TorchConv: a layer
of compute `dtype` casts its input and its float32 parameters to `dtype` at
use, its product comes out in `dtype` and is then cast to `out_dtype`, and
the bias is added in `out_dtype`. Parameters stay float32 in the module, so
the weight carry and the checkpoint loader see float32 only.

On a mesh (parallel/mesh.py), a Dense or Conv layer whose output features
JAX's rule shards is column-parallel: `mp_group` is set, the layer holds its
slice of the output features, and its input and output pass through
parallel/collectives.py's mp_input and mp_output (an all_gather along the
feature axis rebuilds the whole activation). The gather follows the layer
itself, not the batch norm and ReLU after a conv: JAX's rule leaves batch
norms replicated (their scale, bias and running statistics whole on every
rank, as in JAX's sharded state and the checkpoint), so each module stays
whole at its boundary. The price is that each mp rank repeats the batch
norm and ReLU on all channels, elementwise work small beside the conv's.
A BatchNorm with `dp_group` set normalises in train mode with the whole dp
batch's statistics.
"""

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from muzero_general_tpu_torch import tracing
from muzero_general_tpu_torch.ops import conv3x3 as conv3x3_op
from muzero_general_tpu_torch.parallel.collectives import group_gather, mp_input, mp_output


def _all_float32(x, *dtypes):
    return x.dtype == torch.float32 and all(d == torch.float32 for d in dtypes)


class Dense(nn.Linear):
    """nn.Linear with the JAX package's TorchDense precision (see the module
    docstring): `dtype` for the product, `out_dtype` for the output and the
    bias add. All-float32 runs nn.Linear's own fused product and bias.
    `mp_group`: the column-parallel layer's group (see the module
    docstring)."""

    mp_group = None

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32,
                 out_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype
        self.out_dtype = out_dtype

    def forward(self, x):
        if self.mp_group is not None:
            return mp_output(self._local(mp_input(x, self.mp_group)), self.mp_group, -1)
        return self._local(x)

    def _local(self, x):
        if _all_float32(x, self.compute_dtype, self.out_dtype):
            return super().forward(x)
        y = F.linear(x.to(self.compute_dtype), self.weight.to(self.compute_dtype))
        return y.to(self.out_dtype) + self.bias.to(self.out_dtype)


class MLP(nn.Module):
    """ELU MLP with identity output (reference models.py:630-642 `mlp`);
    each layer computes in `dtype` and emits float32, as in the JAX
    package."""

    def __init__(self, input_size: int, layer_sizes: Sequence[int],
                 output_size: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        sizes = [input_size] + list(layer_sizes) + [output_size]
        self.num_layers = len(sizes) - 1
        for i in range(self.num_layers):
            self.add_module(f"TorchDense_{i}", Dense(sizes[i], sizes[i + 1], dtype))

    def dense_layers(self):
        return [getattr(self, f"TorchDense_{i}") for i in range(self.num_layers)]

    def forward(self, x):
        layers = self.dense_layers()
        for layer in layers[:-1]:
            x = F.elu(layer(x))
        return layers[-1](x)


class FullPrecision:
    """Context in which the network's products keep the JAX package's
    precision.

    cuDNN's default runs float32 convolutions in TF32 (about three decimal
    digits), which would move the ResNet away from the float32 reference;
    and cuBLAS may reduce a bfloat16 product's partial sums in bfloat16,
    where the JAX package accumulates bfloat16 products in float32. The
    networks' forward passes enter this context, which turns both off,
    instead of relying on global flags. (Float32 matmuls already default to
    full float32.)
    """

    def __enter__(self):
        matmul = torch.backends.cuda.matmul
        self._prev = (torch.backends.cudnn.allow_tf32,
                      matmul.allow_bf16_reduced_precision_reduction)
        torch.backends.cudnn.allow_tf32 = False
        matmul.allow_bf16_reduced_precision_reduction = False

    def __exit__(self, *exc):
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction) = self._prev


class Conv(nn.Conv2d):
    """The JAX package's TorchConv: its init, U(+-1/sqrt(fan_in)) for kernel
    and bias, is nn.Conv2d's default, and its precision is Dense's (`dtype`
    for the product, `out_dtype` for the output and the bias add). Padding
    is symmetric, `padding` cells a side (default SAME at stride 1).
    `mp_group`: the column-parallel layer's group (see the module
    docstring, which says why the channels are gathered right after the
    conv). `packed_weight`: the weight in ops/conv3x3.py's layout, kept by
    `pack` (models/network.py fold_bn) for the fused 3x3 kernel."""

    mp_group = None
    packed_weight = None

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 bias: bool, dtype: torch.dtype = torch.float32,
                 out_dtype: torch.dtype = torch.float32, stride: int = 1,
                 padding: Optional[int] = None):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=kernel_size // 2 if padding is None else padding,
                         bias=bias)
        self.compute_dtype = dtype
        self.out_dtype = out_dtype

    def forward(self, x):
        if self.mp_group is not None:
            return mp_output(self._local(mp_input(x, self.mp_group)), self.mp_group, 1)
        return self._local(x)

    def _local(self, x):
        if _all_float32(x, self.compute_dtype, self.out_dtype):
            return super().forward(x)
        y = self._conv_forward(x.to(self.compute_dtype),
                               self.weight.to(self.compute_dtype), None)
        y = y.to(self.out_dtype)
        return y if self.bias is None else y + self.bias.to(self.out_dtype)[:, None, None]

    def pack(self):
        """Keep the weight packed for the fused 3x3 kernel if the routing
        rule could send this conv there (models/network.py fold_bn, once a
        fold; the twin's weights do not change after it)."""
        if conv3x3_op.takes_kernel(torch.float32, self.compute_dtype, self.out_dtype,
                                   self.kernel_size, self.stride, self.padding, self.mp_group,
                                   None):
            self.packed_weight = conv3x3_op.pack_weight(self.weight)
            self._routes = {}  # (input dtype, input shape) -> takes_kernel, per call

    def conv_relu(self, x, skip=None):
        """A folded twin's conv and ReLU, relu(self(x) [+ skip]): the fused
        kernel (ops/conv3x3.py; its plain version on the CPU) where the
        weight is packed and the routing rule takes the input's dtype and
        shape, else PyTorch's conv, then the skip add and ReLU. Counted by
        tracing as `conv3x3` at site "kernel", "plain" or "library"."""
        takes = False
        if self.packed_weight is not None:
            key = (x.dtype, x.shape)
            takes = self._routes.get(key)
            if takes is None:
                n, _, h, w = x.shape
                takes = self._routes[key] = conv3x3_op.takes_kernel(
                    x.dtype, self.compute_dtype, self.out_dtype, self.kernel_size, self.stride,
                    self.padding, self.mp_group, (n, self.in_channels, self.out_channels, h, w))
        if takes:
            tracing.count("conv3x3", site="kernel" if x.is_cuda else "plain")
            return conv3x3_op.conv3x3(x.contiguous(), self.weight, self.bias,
                                      None if skip is None else skip.contiguous(),
                                      self.packed_weight)
        tracing.count("conv3x3", site="library")
        y = self(x)
        return F.relu(y if skip is None else y + skip)


def conv(in_channels: int, out_channels: int, kernel_size: int, bias: bool,
         dtype: torch.dtype = torch.float32,
         out_dtype: torch.dtype = torch.float32, stride: int = 1,
         padding: Optional[int] = None) -> Conv:
    return Conv(in_channels, out_channels, kernel_size, bias, dtype, out_dtype, stride,
                padding)


def conv3x3(in_channels: int, out_channels: int, bias: bool = False,
            dtype: torch.dtype = torch.float32,
            out_dtype: torch.dtype = torch.float32) -> Conv:
    """3x3 conv, pad 1, no bias (reference models.py:206-209); the folded
    variant carries the folded batch norm as its bias."""
    return conv(in_channels, out_channels, 3, bias, dtype, out_dtype)


@torch.no_grad()
def reset_parameters(module: nn.Module, generator: Optional[torch.Generator] = None):
    """Redraw every conv and dense layer's TorchConv/TorchDense init,
    U(+-1/sqrt(fan_in)) for weight and bias, from `generator`, in module
    order; batch norms go back to identity with fresh running stats."""
    for layer in module.modules():
        if isinstance(layer, (nn.Conv2d, nn.Linear)):
            fan_in = layer.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            layer.weight.uniform_(-bound, bound, generator=generator)
            if layer.bias is not None:
                layer.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(layer, nn.BatchNorm2d):
            layer.reset_parameters()


class BatchNorm(nn.BatchNorm2d):
    """flax nn.BatchNorm(momentum=0.9), eps 1e-5, on NCHW activations.

    Eval mode is nn.BatchNorm2d's (running statistics). Train mode
    normalises with the batch's biased statistics, as both frameworks do,
    and updates the running statistics as flax does:
    ra = 0.9 * ra + 0.1 * batch, with the biased variance. (nn.BatchNorm2d
    would update running_var with the unbiased one, n / (n - 1) larger.)

    `update_stats` False keeps the running statistics as they are in train
    mode: the learner clears it while a rematerialized unroll step runs its
    forward a second time (trainer.py), so each inference updates them once,
    as flax's carried `batch_stats` do.

    `dp_group` (set on a mesh, parallel/mesh.py shard_train_state): train
    mode normalises with the statistics of the whole dp batch, as JAX's
    sharded step does. Each rank's count, per-channel mean and two-pass sum
    of squared deviations (M2) are gathered over the group in one collective
    (collectives.group_gather, whose backward sums the gradients too) and
    merged as Chan et al.'s parallel variance does. That stays as exact as
    one rank's two-pass variance where a channel's mean dwarfs its spread,
    where flax's E[x^2] - E[x]^2 cancels; flax's clamp of the variance at 0
    is kept. The running statistics move with the global ones. Every rank
    of the group must run the same forwards: the learner's rematerialized
    rerun repeats the collective on every rank, in the same order.
    """

    update_stats = True
    dp_group = None

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if self.dp_group is not None:
            return self._global_batch_norm(x)
        if self.update_stats:
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
                self.num_batches_tracked.add_(1)
        # No running statistics passed: normalise by the batch's own.
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)

    def _global_batch_norm(self, x):
        c = x.shape[1]
        count = x.new_full((1,), x.shape[0] * x.shape[2] * x.shape[3])
        var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        ranks = group_gather(torch.cat([count, mean, var * count]), self.dp_group)
        counts, means, m2 = ranks[:, :1], ranks[:, 1:c + 1], ranks[:, c + 1:]
        total = counts.sum()
        mean = (counts * means).sum(0) / total
        m2 = m2.sum(0) + (counts * (means - mean) ** 2).sum(0)
        var = (m2 / total).clamp_min(0.0)
        if self.update_stats:
            with torch.no_grad():
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
                self.num_batches_tracked.add_(1)
        scale = self.weight * torch.rsqrt(var + self.eps)
        return ((x - mean[None, :, None, None]) * scale[None, :, None, None]
                + self.bias[None, :, None, None])


def batch_norm(channels: int) -> BatchNorm:
    """flax nn.BatchNorm(momentum=0.9), eps 1e-5: torch's momentum is the
    weight of the new batch, 1 - 0.9."""
    return BatchNorm(channels, eps=1e-5, momentum=0.1)


class ResidualBlock(nn.Module):
    """conv-bn-relu-conv-bn + skip, relu (reference models.py:213-229), NCHW.

    fold_bn: the inference-only variant with each batch norm folded into its
    conv (models/network.py fold_bn); its conv outputs, biases, ReLUs and
    skip add run in `act_dtype` (JAX models/common.py:113-148). The convs
    compute in `dtype`. Submodules carry the flax names (TorchConv_i,
    BatchNorm_i) so a JAX tree maps on by name.
    """

    def __init__(self, channels: int, fold_bn: bool = False,
                 dtype: torch.dtype = torch.float32,
                 act_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fold_bn = fold_bn
        self.act_dtype = act_dtype
        out_dtype = act_dtype if fold_bn else torch.float32
        self.TorchConv_0 = conv3x3(channels, channels, fold_bn, dtype, out_dtype)
        if not fold_bn:
            self.BatchNorm_0 = batch_norm(channels)
        self.TorchConv_1 = conv3x3(channels, channels, fold_bn, dtype, out_dtype)
        if not fold_bn:
            self.BatchNorm_1 = batch_norm(channels)

    def forward(self, x):
        if self.fold_bn:
            out = self.TorchConv_0.conv_relu(x)
            return self.TorchConv_1.conv_relu(out, x.to(self.act_dtype))
        out = F.relu(self.BatchNorm_0(self.TorchConv_0(x)))
        out = self.BatchNorm_1(self.TorchConv_1(out))
        return F.relu(out + x)


def normalize_hidden_fc(h: torch.Tensor) -> torch.Tensor:
    """Min-max normalize the hidden state to [0, 1] per sample.

    Parity: reference models.py:137-145, which *adds* 1e-5 to scales below
    1e-5 rather than clamping them.
    """
    h_min = torch.amin(h, dim=-1, keepdim=True)
    h_max = torch.amax(h, dim=-1, keepdim=True)
    scale = h_max - h_min
    scale = torch.where(scale < 1e-5, scale + 1e-5, scale)
    return (h - h_min) / scale


def normalize_hidden_conv(h: torch.Tensor) -> torch.Tensor:
    """Min-max normalize an NCHW hidden state per (sample, channel) over H, W
    (reference models.py:529-553), with normalize_hidden_fc's small-scale
    rule."""
    h_min = torch.amin(h, dim=(-2, -1), keepdim=True)
    h_max = torch.amax(h, dim=(-2, -1), keepdim=True)
    scale = h_max - h_min
    scale = torch.where(scale < 1e-5, scale + 1e-5, scale)
    return (h - h_min) / scale


def log_one_hot_zero_reward(batch: int, full_support_size: int,
                            device=None) -> torch.Tensor:
    """Reward logits fixed to 'log one-hot of scalar 0' for initial inference.

    Parity: reference models.py:176-183, with the JAX package's finite -1e9
    floor in place of -inf (identical under softmax, NaN-safe).
    """
    logits = torch.full((batch, full_support_size), -1e9, device=device)
    logits[:, full_support_size // 2] = 0.0
    return logits
