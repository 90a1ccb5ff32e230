"""Fully connected MuZero network triplet (port of models/fc.py).

Parity: reference models.py:80-195 (MuZeroFullyConnectedNetwork): ELU MLPs,
per-sample min-max hidden normalization, one-hot action concatenated in
dynamics. The reward head reads the UNNORMALIZED dynamics output.
"""

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from muzero_general_tpu_torch.models.common import (
    MLP,
    log_one_hot_zero_reward,
    normalize_hidden_fc,
)


class FCMuZero(nn.Module):
    def __init__(
        self,
        observation_shape: Sequence[int],  # (C, H, W)
        stacked_observations: int,
        action_space_size: int,
        encoding_size: int,
        fc_reward_layers: Sequence[int],
        fc_value_layers: Sequence[int],
        fc_policy_layers: Sequence[int],
        fc_representation_layers: Sequence[int],
        fc_dynamics_layers: Sequence[int],
        support_size: int,
    ):
        super().__init__()
        c, h, w = observation_shape
        n = stacked_observations
        self.observation_size = (c * (n + 1) + n) * h * w
        self.action_space_size = action_space_size
        self.encoding_size = encoding_size
        self.support_size = support_size
        self.full_support_size = 2 * support_size + 1

        self.representation_network = MLP(
            self.observation_size, fc_representation_layers, encoding_size
        )
        self.dynamics_state_network = MLP(
            encoding_size + action_space_size, fc_dynamics_layers, encoding_size
        )
        self.dynamics_reward_network = MLP(
            encoding_size, fc_reward_layers, self.full_support_size
        )
        self.prediction_policy_network = MLP(
            encoding_size, fc_policy_layers, action_space_size
        )
        self.prediction_value_network = MLP(
            encoding_size, fc_value_layers, self.full_support_size
        )

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for module in self.children():
            module.reset_parameters(generator)

    def representation(self, observation):
        """observation: [B, C', H, W] stacked planes -> hidden [B, E]."""
        x = observation.reshape(observation.shape[0], -1)
        return normalize_hidden_fc(self.representation_network(x))

    def dynamics(self, hidden, action):
        """hidden [B, E], action [B] int -> (next hidden [B, E], reward logits)."""
        action_one_hot = F.one_hot(
            action.long(), self.action_space_size
        ).to(hidden.dtype)
        x = torch.cat([hidden, action_one_hot], dim=-1)
        next_hidden = self.dynamics_state_network(x)
        reward = self.dynamics_reward_network(next_hidden)
        return normalize_hidden_fc(next_hidden), reward

    def prediction(self, hidden):
        return (
            self.prediction_policy_network(hidden),
            self.prediction_value_network(hidden),
        )

    def initial_inference(self, observation):
        hidden = self.representation(observation)
        policy_logits, value = self.prediction(hidden)
        reward = log_one_hot_zero_reward(
            observation.shape[0], self.full_support_size, observation.device
        )
        return value, reward, policy_logits, hidden

    def recurrent_inference(self, hidden, action):
        next_hidden, reward = self.dynamics(hidden, action)
        policy_logits, value = self.prediction(next_hidden)
        return value, reward, policy_logits, next_hidden
