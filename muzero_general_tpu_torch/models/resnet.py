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

Only `downsample=False` is ported: "resnet" and "CNN" (the atari-sized
downsamplers) raise NotImplementedError (ROADMAP module item 12).
"""

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

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


class RepresentationResnet(nn.Module):
    """Reference models.py:300-349, downsample=False."""

    def __init__(self, in_channels: int, num_blocks: int, num_channels: int,
                 fold_bn: bool = False, dtype=torch.float32, act_dtype=torch.float32):
        super().__init__()
        self.fold_bn = fold_bn
        self.TorchConv_0 = conv3x3(in_channels, num_channels, fold_bn, dtype,
                                   act_dtype if fold_bn else torch.float32)
        if not fold_bn:
            self.BatchNorm_0 = batch_norm(num_channels)
        for i in range(num_blocks):
            self.add_module(f"ResidualBlock_{i}",
                            ResidualBlock(num_channels, fold_bn, dtype, act_dtype))
        self.num_blocks = num_blocks

    def forward(self, x):
        x = self.TorchConv_0(x)
        if not self.fold_bn:
            x = self.BatchNorm_0(x)
        x = F.relu(x)
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
        x = self.TorchConv_0(x)
        if not self.fold_bn:
            x = self.BatchNorm_0(x)
        x = F.relu(x)
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
        if downsample:
            raise NotImplementedError(
                f"downsample={downsample!r} is not ported yet (ROADMAP module "
                "item 12); the port's ResNet takes downsample=False"
            )
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
            support_size=support_size, dtype=dtype,
        )
        c, h, w = observation_shape
        n = stacked_observations
        self.action_space_size = action_space_size
        self.support_size = support_size
        self.full_support_size = 2 * support_size + 1
        self.fold_bn = fold_bn
        self.dtype = dtype
        self.representation_network = RepresentationResnet(
            c * (n + 1) + n, num_blocks, num_channels, fold_bn, dtype, act_dtype
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
        return twin.to(next(self.parameters()).device).eval()

    def representation(self, observation):
        """observation [B, C', H, W] -> hidden [B, channels, H, W]."""
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
