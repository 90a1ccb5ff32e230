"""Residual MuZero network triplet (port of models/resnet.py), NCHW.

Parity: reference models.py:206-623 (MuZeroResidualNetwork and its
sub-networks): the same structure knobs (blocks, channels, reduced head
channels, head MLP layers), batch norm with running statistics, per-channel
min-max hidden normalization, and the action broadcast as a constant plane
action / A appended as the LAST channel of the dynamics input.

The JAX package keeps activations NHWC; the port keeps PyTorch's NCHW, so a
hidden state here is [B, C, H, W]. The heads flatten their reduced maps in
the JAX package's (h, w, c) order before the first dense layer, so a JAX
checkpoint's head kernels load unchanged (models/network.py
params_from_jax).

Precision follows the JAX package (models/resnet.py:108-345): every conv and
dense layer computes in `dtype` (float32 or bfloat16, config.compute_dtype)
with float32 accumulation (common.FullPrecision); the heads' 1x1 convs and
MLPs emit float32 logits. The unfolded network's activations and batch
norms stay float32. The folded variant runs its conv pipeline, its ReLUs,
skip adds, hidden normalization and hidden states in `act_dtype` (bfloat16
when config.search_bf16_activations is on).

`downsample` is False, "resnet" (DownSampleResnet: strided convs, residual
blocks and average pools, /16) or "CNN" (DownsampleCNN: a strided conv,
max pools, an adaptive average pool); with either, the hidden maps are
ceil(H / 16) x ceil(W / 16) and the heads' flatten sizes follow. The
pyramid's pools and convs are plain PyTorch ops under FullPrecision, as the
JAX package computes them in XLA, not in a Pallas kernel.
"""

import itertools
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from muzero_general_tpu_torch import tracing
from muzero_general_tpu_torch.models.common import (
    FullPrecision,
    MLP,
    ResidualBlock,
    batch_norm,
    conv,
    conv3x3,
    log_one_hot_zero_reward,
    normalize_hidden_conv,
)


def _flatten_hwc(x):
    """[B, C, H, W] -> [B, H*W*C] in the JAX package's NHWC flatten order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def avg_pool(x):
    """flax avg_pool((3, 3), strides (2, 2), padding ((1, 1), (1, 1))) on
    NCHW: the padded cells count in the mean. flax sums a window's nine
    cells in the activations' dtype, one add at a time in window order,
    then divides by 9; so does this. (In bfloat16, F.avg_pool2d sums in
    float and rounds once, which differs from flax in the last bits.)"""
    h, w = (x.shape[2] - 1) // 2 + 1, (x.shape[3] - 1) // 2 + 1
    x = F.pad(x, (1, 1, 1, 1))
    total = None
    for i in range(3):
        for j in range(3):
            cell = x[:, :, i:i + 2 * h - 1:2, j:j + 2 * w - 1:2]
            total = cell if total is None else total + cell
    return total / 9


class DownSampleResnet(nn.Module):
    """Strided conv / residual block / average pool pyramid, /16 spatial
    (reference models.py:233-275; JAX models/resnet.py:43-80). Its two
    stride-2 convs have no bias and no batch norm, so the BN fold leaves
    them as they are; the residual blocks fold."""

    def __init__(self, in_channels: int, out_channels: int, fold_bn: bool = False,
                 dtype=torch.float32, act_dtype=torch.float32):
        super().__init__()
        half = out_channels // 2
        self.TorchConv_0 = conv(in_channels, half, 3, False, dtype, stride=2, padding=1)
        self.TorchConv_1 = conv(half, out_channels, 3, False, dtype, stride=2, padding=1)
        for i in range(8):
            self.add_module(f"ResidualBlock_{i}", ResidualBlock(
                half if i < 2 else out_channels, fold_bn, dtype, act_dtype))

    def forward(self, x):
        blocks = [getattr(self, f"ResidualBlock_{i}") for i in range(8)]
        x = self.TorchConv_0(x)
        for block in blocks[:2]:
            x = block(x)
        x = self.TorchConv_1(x)
        for block in blocks[2:5]:
            x = block(x)
        x = avg_pool(x)
        for block in blocks[5:]:
            x = block(x)
        return avg_pool(x)


class DownsampleCNN(nn.Module):
    """The lighter conv / max pool downsampler (reference models.py:278-297;
    JAX models/resnet.py:83-105): a (2 * h_w[0])-wide stride-4 conv, ReLU,
    a 3x3 stride-2 max pool (no padding), a 5x5 conv, ReLU, the same pool,
    then an adaptive average pool to h_w. It has no batch norm."""

    def __init__(self, in_channels: int, out_channels: int, h_w: Sequence[int],
                 dtype=torch.float32):
        super().__init__()
        mid = (in_channels + out_channels) // 2
        self.h_w = tuple(h_w)
        self.TorchConv_0 = conv(in_channels, mid, self.h_w[0] * 2, True, dtype, stride=4,
                                padding=2)
        self.TorchConv_1 = conv(mid, out_channels, 5, True, dtype, padding=2)

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.TorchConv_0(x)), 3, stride=2)
        x = F.max_pool2d(F.relu(self.TorchConv_1(x)), 3, stride=2)
        # The JAX package's adaptive_avg_pool (models/resnet.py:27-40) takes
        # window i over rows floor(i * h / out_h) to ceil((i + 1) * h / out_h),
        # as torch's adaptive pool does.
        return F.adaptive_avg_pool2d(x, self.h_w)


def hidden_hw(observation_shape, downsample):
    """The hidden maps' (h, w): the observation's, or ceil(/16) of it with a
    downsampler (JAX ResMuZero._hidden_hw)."""
    _, h, w = observation_shape
    if downsample:
        return math.ceil(h / 16), math.ceil(w / 16)
    return h, w


class RepresentationResnet(nn.Module):
    """Reference models.py:300-349: a downsampler (DownSampleResnet_0 or
    DownsampleCNN_0), or a 3x3 conv, batch norm and ReLU; then the residual
    blocks."""

    def __init__(self, in_channels: int, num_blocks: int, num_channels: int,
                 downsample=False, hw=None, fold_bn: bool = False, dtype=torch.float32,
                 act_dtype=torch.float32):
        super().__init__()
        self.fold_bn = fold_bn
        self.downsample = downsample
        if downsample == "resnet":
            self.DownSampleResnet_0 = DownSampleResnet(in_channels, num_channels, fold_bn,
                                                       dtype, act_dtype)
        elif downsample == "CNN":
            self.DownsampleCNN_0 = DownsampleCNN(in_channels, num_channels, hw, dtype)
        elif downsample:
            raise NotImplementedError('downsample should be "resnet" or "CNN".')
        else:
            self.TorchConv_0 = conv3x3(in_channels, num_channels, fold_bn, dtype,
                                       act_dtype if fold_bn else torch.float32)
            if not fold_bn:
                self.BatchNorm_0 = batch_norm(num_channels)
        for i in range(num_blocks):
            self.add_module(f"ResidualBlock_{i}",
                            ResidualBlock(num_channels, fold_bn, dtype, act_dtype))
        self.num_blocks = num_blocks

    def forward(self, x):
        if self.downsample == "resnet":
            x = self.DownSampleResnet_0(x)
        elif self.downsample == "CNN":
            x = self.DownsampleCNN_0(x)
        elif self.fold_bn:
            x = self.TorchConv_0.conv_relu(x)
        else:
            x = F.relu(self.BatchNorm_0(self.TorchConv_0(x)))
        for i in range(self.num_blocks):
            x = getattr(self, f"ResidualBlock_{i}")(x)
        return x


class DynamicsResnet(nn.Module):
    """Reference models.py:352-389: the input carries the +1 action plane."""

    def __init__(self, num_blocks: int, num_channels: int,
                 reduced_channels_reward: int, fc_reward_layers: Sequence[int],
                 full_support_size: int, block_output_size_reward: int,
                 fold_bn: bool = False, dtype=torch.float32, act_dtype=torch.float32):
        super().__init__()
        self.fold_bn = fold_bn
        self.num_blocks = num_blocks
        self.TorchConv_0 = conv3x3(num_channels + 1, num_channels, fold_bn, dtype,
                                   act_dtype if fold_bn else torch.float32)
        if not fold_bn:
            self.BatchNorm_0 = batch_norm(num_channels)
        for i in range(num_blocks):
            self.add_module(f"ResidualBlock_{i}",
                            ResidualBlock(num_channels, fold_bn, dtype, act_dtype))
        self.TorchConv_1 = conv(num_channels, reduced_channels_reward, 1, True, dtype)
        self.MLP_0 = MLP(block_output_size_reward, fc_reward_layers, full_support_size, dtype)

    def forward(self, x):
        if self.fold_bn:
            x = self.TorchConv_0.conv_relu(x)
        else:
            x = F.relu(self.BatchNorm_0(self.TorchConv_0(x)))
        for i in range(self.num_blocks):
            x = getattr(self, f"ResidualBlock_{i}")(x)
        reward = self.MLP_0(_flatten_hwc(self.TorchConv_1(x)))
        return x, reward


class PredictionResnet(nn.Module):
    """Reference models.py:392-433."""

    def __init__(self, action_space_size: int, num_blocks: int, num_channels: int,
                 reduced_channels_value: int, reduced_channels_policy: int,
                 fc_value_layers: Sequence[int], fc_policy_layers: Sequence[int],
                 full_support_size: int, hw: int, fold_bn: bool = False,
                 dtype=torch.float32, act_dtype=torch.float32):
        super().__init__()
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"ResidualBlock_{i}",
                            ResidualBlock(num_channels, fold_bn, dtype, act_dtype))
        self.TorchConv_0 = conv(num_channels, reduced_channels_value, 1, True, dtype)
        self.TorchConv_1 = conv(num_channels, reduced_channels_policy, 1, True, dtype)
        self.MLP_0 = MLP(reduced_channels_value * hw, fc_value_layers, full_support_size, dtype)
        self.MLP_1 = MLP(reduced_channels_policy * hw, fc_policy_layers, action_space_size,
                         dtype)

    def forward(self, x):
        for i in range(self.num_blocks):
            x = getattr(self, f"ResidualBlock_{i}")(x)
        value = self.MLP_0(_flatten_hwc(self.TorchConv_0(x)))
        policy = self.MLP_1(_flatten_hwc(self.TorchConv_1(x)))
        return policy, value


class ResMuZero(nn.Module):
    """Residual MuZero triplet (reference models.py:436-623), NCHW hidden
    states [B, channels, H, W].

    fold_bn: the inference-only variant whose convs carry their batch norms
    folded in; built from a trained module by models/network.py fold_bn.
    dtype: the layers' compute dtype; act_dtype: the folded variant's
    activation dtype (see the module docstring).
    """

    def __init__(self, observation_shape: Sequence[int], stacked_observations: int,
                 action_space_size: int, num_blocks: int, num_channels: int,
                 reduced_channels_reward: int, reduced_channels_value: int,
                 reduced_channels_policy: int, fc_reward_layers: Sequence[int],
                 fc_value_layers: Sequence[int], fc_policy_layers: Sequence[int],
                 support_size: int, downsample=False, fold_bn: bool = False,
                 dtype=torch.float32, act_dtype=torch.float32):
        super().__init__()
        self.hparams = dict(
            observation_shape=tuple(observation_shape),
            stacked_observations=stacked_observations,
            action_space_size=action_space_size, num_blocks=num_blocks,
            num_channels=num_channels,
            reduced_channels_reward=reduced_channels_reward,
            reduced_channels_value=reduced_channels_value,
            reduced_channels_policy=reduced_channels_policy,
            fc_reward_layers=tuple(fc_reward_layers),
            fc_value_layers=tuple(fc_value_layers),
            fc_policy_layers=tuple(fc_policy_layers),
            support_size=support_size, downsample=downsample, dtype=dtype,
        )
        c = observation_shape[0]
        h, w = hidden_hw(observation_shape, downsample)
        n = stacked_observations
        self.action_space_size = action_space_size
        self.support_size = support_size
        self.full_support_size = 2 * support_size + 1
        self.fold_bn = fold_bn
        self.dtype = dtype
        self.representation_network = RepresentationResnet(
            c * (n + 1) + n, num_blocks, num_channels, downsample, (h, w), fold_bn, dtype,
            act_dtype,
        )
        self.dynamics_network = DynamicsResnet(
            num_blocks, num_channels, reduced_channels_reward, fc_reward_layers,
            self.full_support_size, reduced_channels_reward * h * w, fold_bn, dtype,
            act_dtype,
        )
        self.prediction_network = PredictionResnet(
            action_space_size, num_blocks, num_channels, reduced_channels_value,
            reduced_channels_policy, fc_value_layers, fc_policy_layers,
            self.full_support_size, h * w, fold_bn, dtype, act_dtype,
        )

    def folded_twin(self, act_dtype=torch.float32) -> "ResMuZero":
        """An untrained fold_bn=True module of the same shape, compute dtype
        and device, with activations in `act_dtype`."""
        twin = ResMuZero(**self.hparams, fold_bn=True, act_dtype=act_dtype)
        # Built on the host: a copy to the device a tensor (a host sync each).
        tensors = itertools.chain(twin.parameters(), twin.buffers())
        tracing.count("host_sync", sum(t.numel() > 0 for t in tensors), site="selfplay.fold")
        return twin.to(next(self.parameters()).device).eval()

    def representation(self, observation):
        """observation [B, C', H, W] -> hidden [B, channels, h, w] (hidden_hw)."""
        return normalize_hidden_conv(self.representation_network(observation))

    def dynamics(self, hidden, action):
        """hidden [B, C, H, W], action [B] -> (next hidden, reward logits).

        The action is broadcast as a constant plane action / A in the hidden
        state's dtype, appended as the last channel (reference
        models.py:555-572)."""
        b, _, h, w = hidden.shape
        plane = (action.to(hidden.dtype) / self.action_space_size)[
            :, None, None, None
        ].expand(b, 1, h, w)
        next_hidden, reward = self.dynamics_network(torch.cat([hidden, plane], dim=1))
        return normalize_hidden_conv(next_hidden), reward

    def prediction(self, hidden):
        return self.prediction_network(hidden)

    def initial_inference(self, observation):
        with FullPrecision():
            hidden = self.representation(observation)
            policy_logits, value = self.prediction(hidden)
        reward = log_one_hot_zero_reward(
            observation.shape[0], self.full_support_size, observation.device
        )
        return value, reward, policy_logits, hidden

    def recurrent_inference(self, hidden, action):
        with FullPrecision():
            next_hidden, reward = self.dynamics(hidden, action)
            policy_logits, value = self.prediction(next_hidden)
        return value, reward, policy_logits, next_hidden
