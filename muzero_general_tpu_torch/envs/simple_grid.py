"""Batched 3x3 grid walk (port of envs/simple_grid.py).

Parity with the reference GridEnv (reference games/simple_grid.py:192-229):
Down/Right walk from the top-left cell to the bottom-right goal; reward 10
on arrival (the reference Game wrapper scales reward * 10,
simple_grid.py:144); a move off the border is a no-op (the reference's
step() passes) and masked as illegal. Stepping a done state keeps it done
with reward 0.
"""

from typing import NamedTuple, Optional

import torch

from muzero_general_tpu_torch.envs.core import TorchEnv

SIZE = 3


class SimpleGridState(NamedTuple):
    row: torch.Tensor  # [G] int32
    col: torch.Tensor  # [G] int32
    done: torch.Tensor  # [G] bool


class SimpleGrid(TorchEnv):
    observation_shape = (1, 1, SIZE * SIZE)
    num_actions = 2  # 0 = Down, 1 = Right
    num_players = 1

    def reset(self, num_games: int, generator: Optional[torch.Generator] = None,
              start: Optional[torch.Tensor] = None):
        """Every game starts on the top-left cell (the env draws nothing)."""
        zeros = torch.zeros((num_games,), dtype=torch.int32, device=self.device)
        return SimpleGridState(zeros, zeros.clone(),
                               torch.zeros((num_games,), dtype=torch.bool, device=self.device))

    def observation(self, state):
        flat = torch.zeros((state.row.shape[0], SIZE * SIZE), dtype=torch.float32,
                           device=self.device)
        flat.scatter_(1, (state.row * SIZE + state.col).long()[:, None], 1.0)
        return flat.reshape(-1, 1, 1, SIZE * SIZE)

    def legal_actions_mask(self, state):
        return torch.stack([state.row < SIZE - 1, state.col < SIZE - 1], dim=1)

    def step(self, state, action, generator: Optional[torch.Generator] = None):
        action = action.long()
        move_ok = self.legal_actions_mask(state).gather(1, action[:, None])[:, 0]
        row = torch.where(move_ok & (action == 0), state.row + 1, state.row)
        col = torch.where(move_ok & (action == 1), state.col + 1, state.col)
        at_goal = (row == SIZE - 1) & (col == SIZE - 1)
        reward = torch.where(at_goal & ~state.done, 10.0, 0.0).to(torch.float32)
        done = state.done | at_goal
        return SimpleGridState(row, col, done), reward, done

    def action_to_string(self, action):
        return f"{action}. {['Down', 'Right'][int(action)]}"
