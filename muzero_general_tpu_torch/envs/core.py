"""Batched environment protocol for on-device self-play (port of envs/core.py).

Counterpart of the JAX package's `JaxEnv` (itself the reference's
AbstractGame, games/abstract_game.py:4-105): the JAX env works on ONE
instance and the driver vmaps it; here every method works on a batch of G
games held as a NamedTuple of [G]-leading tensors on the env's device, and
randomness comes from an explicit torch.Generator.

The human-facing helpers (`render`, `action_to_string`, `human_to_action`;
JAX envs/core.py:53-69) and the default expert (a uniform legal move) work
on a one-game batch, as the evaluation loop (evaluate.py) holds it.
"""

from typing import Any, NamedTuple, Optional, Tuple

import torch

from muzero_general_tpu_torch.device import resolve_device

EnvState = Any  # NamedTuple of [G, ...] tensors


class TorchEnv:
    """Interface; subclasses implement batched functions of the state."""

    observation_shape: Tuple[int, int, int]  # (C, H, W)
    num_actions: int
    num_players: int = 1

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def reset(self, num_games: int, generator: Optional[torch.Generator] = None,
              start: Optional[torch.Tensor] = None) -> EnvState:
        """Fresh states for `num_games` games, drawn from `generator`, or set
        from the explicit `start` values where the env takes them."""
        raise NotImplementedError

    def observation(self, state) -> torch.Tensor:
        """[G, C, H, W] float32 observations."""
        raise NotImplementedError

    def step(self, state, action, generator: Optional[torch.Generator] = None):
        """Apply `action` [G]; returns (next_state, reward [G], done [G]).

        Must be safe on a done state (the driver auto-resets finished lanes).
        """
        raise NotImplementedError

    def legal_actions_mask(self, state) -> torch.Tensor:
        """[G, num_actions] bool mask of legal actions."""
        g = self.batch_size(state)
        return torch.ones((g, self.num_actions), dtype=torch.bool,
                          device=self.device)

    def to_play(self, state) -> torch.Tensor:
        """[G] int32 current player (default single-player 0)."""
        return torch.zeros((self.batch_size(state),), dtype=torch.int32,
                           device=self.device)

    @staticmethod
    def batch_size(state) -> int:
        return state[0].shape[0]

    def random_legal_action(self, state, generator: Optional[torch.Generator] = None):
        """A uniform draw over the legal actions [G] (over all actions where
        none is legal), as jax.random.categorical over a 0 / -inf mask."""
        legal = self.legal_actions_mask(state)
        u = torch.rand(legal.shape, generator=generator, device=self.device)
        return torch.argmax(torch.where(legal, u, -1.0), dim=1)

    def expert_action(self, state, generator: Optional[torch.Generator] = None):
        """Heuristic opponent [G] (reference expert_agent); default: a
        uniform legal move (JAX envs/core.py:69-75)."""
        return self.random_legal_action(state, generator)

    # ---- human-facing, on a one-game batch (JAX envs/core.py:53-67) -----
    def render(self, state):
        print(self.observation(state)[0].cpu().numpy())

    def action_to_string(self, action) -> str:
        return str(action)

    def human_to_action(self, state) -> int:
        while True:
            try:
                a = int(input(f"Enter action (0-{self.num_actions - 1}): "))
                if 0 <= a < self.num_actions:
                    return a
            except ValueError:
                pass


def where_state(mask: torch.Tensor, a: NamedTuple, b: NamedTuple) -> NamedTuple:
    """Per-game select between two batched states: a where mask [G], else b."""
    return type(a)(*(
        torch.where(mask.reshape((-1,) + (1,) * (x.dim() - 1)), x, y)
        for x, y in zip(a, b)
    ))
