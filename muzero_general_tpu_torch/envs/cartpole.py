"""Batched CartPole-v1 (port of envs/cartpole.py).

Classic Barto-Sutton-Anderson cart-pole physics over [G] tensors, with the
JAX env's constants, termination thresholds, +1-per-step reward, 500-step
truncation and (1, 1, 4) observation layout. Stepping a done state keeps it
done with reward 0.
"""

import math
from typing import NamedTuple, Optional

import torch

from muzero_general_tpu_torch.envs.core import TorchEnv


class CartPoleState(NamedTuple):
    x: torch.Tensor  # [G] cart position
    x_dot: torch.Tensor
    theta: torch.Tensor  # pole angle (rad)
    theta_dot: torch.Tensor
    steps: torch.Tensor  # [G] int32 step counter (500-step truncation)
    done: torch.Tensor  # [G] bool


GRAVITY = 9.8
MASS_CART = 1.0
MASS_POLE = 0.1
TOTAL_MASS = MASS_CART + MASS_POLE
POLE_HALF_LENGTH = 0.5
POLE_MASS_LENGTH = MASS_POLE * POLE_HALF_LENGTH
FORCE_MAG = 10.0
TAU = 0.02
THETA_LIMIT = 12 * 2 * math.pi / 360
X_LIMIT = 2.4
MAX_STEPS = 500


class CartPole(TorchEnv):
    observation_shape = (1, 1, 4)
    num_actions = 2
    num_players = 1

    def reset(self, num_games: int, generator: Optional[torch.Generator] = None,
              start: Optional[torch.Tensor] = None):
        """start: optional [G, 4] (x, x_dot, theta, theta_dot); otherwise
        each is drawn uniformly from [-0.05, 0.05)."""
        if start is None:
            start = torch.rand((num_games, 4), generator=generator,
                               device=self.device) * 0.1 - 0.05
        start = torch.as_tensor(start, dtype=torch.float32, device=self.device)
        if start.shape != (num_games, 4):
            raise ValueError(f"start must be [{num_games}, 4], got {tuple(start.shape)}")
        return CartPoleState(
            x=start[:, 0].clone(),
            x_dot=start[:, 1].clone(),
            theta=start[:, 2].clone(),
            theta_dot=start[:, 3].clone(),
            steps=torch.zeros((num_games,), dtype=torch.int32, device=self.device),
            done=torch.zeros((num_games,), dtype=torch.bool, device=self.device),
        )

    def observation(self, state):
        return torch.stack(
            [state.x, state.x_dot, state.theta, state.theta_dot], dim=-1
        ).reshape(-1, 1, 1, 4)

    def step(self, state, action, generator: Optional[torch.Generator] = None):
        force = torch.where(action == 1, FORCE_MAG, -FORCE_MAG).to(torch.float32)
        cos_t = torch.cos(state.theta)
        sin_t = torch.sin(state.theta)
        temp = (
            force + POLE_MASS_LENGTH * state.theta_dot**2 * sin_t
        ) / TOTAL_MASS
        theta_acc = (GRAVITY * sin_t - cos_t * temp) / (
            POLE_HALF_LENGTH
            * (4.0 / 3.0 - MASS_POLE * cos_t**2 / TOTAL_MASS)
        )
        x_acc = temp - POLE_MASS_LENGTH * theta_acc * cos_t / TOTAL_MASS

        x = state.x + TAU * state.x_dot
        x_dot = state.x_dot + TAU * x_acc
        theta = state.theta + TAU * state.theta_dot
        theta_dot = state.theta_dot + TAU * theta_acc
        steps = state.steps + 1

        terminated = (
            (torch.abs(x) > X_LIMIT)
            | (torch.abs(theta) > THETA_LIMIT)
            | (steps >= MAX_STEPS)
        )
        reward = torch.where(state.done, 0.0, 1.0).to(torch.float32)
        new_state = CartPoleState(
            x=x, x_dot=x_dot, theta=theta, theta_dot=theta_dot,
            steps=steps, done=state.done | terminated,
        )
        return new_state, reward, new_state.done
