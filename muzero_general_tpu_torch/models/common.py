"""Shared model building blocks, FC parts (port of models/common.py).

`nn.Linear`'s default init, U(+-1/sqrt(fan_in)) for weight and bias, is the
JAX package's `TorchDense` init, so `MLP` keeps it; `reset_parameters` redraws
it from an explicit generator. Submodules are named `TorchDense_<i>` like the
flax layers, so a JAX parameter tree maps onto the state dict by name
(models/network.py `params_from_jax`).
"""

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


class MLP(nn.Module):
    """ELU MLP with identity output (reference models.py:630-642 `mlp`)."""

    def __init__(self, input_size: int, layer_sizes: Sequence[int],
                 output_size: int):
        super().__init__()
        sizes = [input_size] + list(layer_sizes) + [output_size]
        self.num_layers = len(sizes) - 1
        for i in range(self.num_layers):
            self.add_module(f"TorchDense_{i}", nn.Linear(sizes[i], sizes[i + 1]))

    def dense_layers(self):
        return [getattr(self, f"TorchDense_{i}") for i in range(self.num_layers)]

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for layer in self.dense_layers():
            bound = 1.0 / math.sqrt(layer.in_features)
            layer.weight.uniform_(-bound, bound, generator=generator)
            layer.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x):
        layers = self.dense_layers()
        for layer in layers[:-1]:
            x = F.elu(layer(x))
        return layers[-1](x)


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


def log_one_hot_zero_reward(batch: int, full_support_size: int,
                            device=None) -> torch.Tensor:
    """Reward logits fixed to 'log one-hot of scalar 0' for initial inference.

    Parity: reference models.py:176-183, with the JAX package's finite -1e9
    floor in place of -inf (identical under softmax, NaN-safe).
    """
    logits = torch.full((batch, full_support_size), -1e9, device=device)
    logits[:, full_support_size // 2] = 0.0
    return logits
