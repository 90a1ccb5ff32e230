"""Batched MiniGrid Empty-Random-6x6 (port of envs/gridworld.py; reference
games/gridworld.py:130-175 wraps gym_minigrid's MiniGrid-Empty-Random-6x6-v0
and ImgObsWrapper).

The minigrid semantics the reference depends on, as the JAX env has them:
- a 6x6 grid with boundary walls, the goal at the inner bottom-right (4, 4);
- the agent starts at a random inner cell other than the goal, facing a
  random direction;
- actions 0 = turn left, 1 = turn right, 2 = forward (walls block);
- reward on reaching the goal: 1 - 0.9 * step_count / 144 (float32), with
  max_steps = 4 * 6 * 6 = 144 ending the episode too;
- observation: the 7x7x3 egocentric image, agent at view cell (3, 6) facing
  up, cells (object, color, state): out of grid (0, 0, 0), floor (1, 0, 0),
  wall (2, 5, 0), goal (8, 1, 0). The view is indexed [vx, vy, channel],
  as minigrid's image is (x first).

Randomness: `reset` draws the start cell and direction from `generator`, or
takes them as `start` [G, 3] (x, y, dir). The step is deterministic.
"""

from typing import NamedTuple, Optional

import torch

from muzero_general_tpu_torch.envs.core import TorchEnv

SIZE = 6
VIEW = 7
MAX_STEPS = 4 * SIZE * SIZE
GOAL = (SIZE - 2, SIZE - 2)  # (x, y) inner bottom-right

# minigrid direction vectors: 0 = right, 1 = down, 2 = left, 3 = up, as (dx, dy)
_DIR = ((1, 0), (0, 1), (-1, 0), (0, -1))


class GridWorldState(NamedTuple):
    x: torch.Tensor  # [G] int32 agent column
    y: torch.Tensor  # [G] int32 agent row
    dir: torch.Tensor  # [G] int32 0..3
    steps: torch.Tensor  # [G] int32
    done: torch.Tensor  # [G] bool


class GridWorld(TorchEnv):
    observation_shape = (7, 7, 3)  # the raw minigrid image layout (reference parity)
    num_actions = 3
    num_players = 1

    def __init__(self, device=None):
        super().__init__(device)
        self._dir = torch.tensor(_DIR, dtype=torch.int32, device=self.device)
        view = torch.arange(VIEW, dtype=torch.int32, device=self.device)
        # right offset r = vx - 3 by view column, forward offset f = 6 - vy by view row
        self._r = (view - VIEW // 2)[:, None]  # [7, 1]
        self._f = (VIEW - 1 - view)[None, :]  # [1, 7]

    def reset(self, num_games: int, generator: Optional[torch.Generator] = None,
              start: Optional[torch.Tensor] = None):
        """start: optional [G, 3] int (x, y, dir); otherwise a uniform inner
        cell other than the goal (a draw over the 15 others, remapped past
        the goal's index, as the JAX env does) and a uniform direction."""
        if start is None:
            idx = torch.randint(0, (SIZE - 2) * (SIZE - 2) - 1, (num_games,),
                                generator=generator, device=self.device)
            goal_idx = (GOAL[1] - 1) * (SIZE - 2) + (GOAL[0] - 1)
            idx = torch.where(idx >= goal_idx, idx + 1, idx)
            d = torch.randint(0, 4, (num_games,), generator=generator, device=self.device)
            start = torch.stack([idx % (SIZE - 2) + 1, idx // (SIZE - 2) + 1, d], dim=1)
        start = torch.as_tensor(start, dtype=torch.int32, device=self.device)
        if start.shape != (num_games, 3):
            raise ValueError(f"start must be [{num_games}, 3], got {tuple(start.shape)}")
        zeros = torch.zeros((num_games,), dtype=torch.int32, device=self.device)
        return GridWorldState(start[:, 0].clone(), start[:, 1].clone(), start[:, 2].clone(),
                              zeros, zeros.to(torch.bool))

    def observation(self, state):
        """[G, 7, 7, 3] egocentric images, indexed [vx, vy, channel]."""
        fwd = self._dir[state.dir.long()]  # [G, 2]
        fx, fy = fwd[:, 0, None, None], fwd[:, 1, None, None]
        # right = (-fwd_y, fwd_x)
        wx = state.x[:, None, None] + self._f * fx - self._r * fy  # [G, 7, 7]
        wy = state.y[:, None, None] + self._f * fy + self._r * fx
        in_grid = (wx >= 0) & (wx < SIZE) & (wy >= 0) & (wy < SIZE)
        is_wall = in_grid & ((wx == 0) | (wx == SIZE - 1) | (wy == 0) | (wy == SIZE - 1))
        is_goal = in_grid & (wx == GOAL[0]) & (wy == GOAL[1])
        obj = torch.where(is_goal, 8, torch.where(is_wall, 2, torch.where(in_grid, 1, 0)))
        color = torch.where(is_goal, 1, torch.where(is_wall, 5, 0))
        return torch.stack([obj, color, torch.zeros_like(obj)], dim=-1).to(torch.float32)

    def step(self, state, action, generator: Optional[torch.Generator] = None):
        # 0 = turn left, 1 = turn right, 2 = forward; % is a floor modulo,
        # as jnp's is.
        d = torch.where(action == 0, (state.dir - 1) % 4,
                        torch.where(action == 1, (state.dir + 1) % 4, state.dir))
        fwd = self._dir[d.long()]
        forward = action == 2
        nx = state.x + torch.where(forward, fwd[:, 0], 0)
        ny = state.y + torch.where(forward, fwd[:, 1], 0)
        # Walls block (the inner area is 1..SIZE-2)
        blocked = (nx < 1) | (nx > SIZE - 2) | (ny < 1) | (ny > SIZE - 2)
        nx = torch.where(blocked, state.x, nx)
        ny = torch.where(blocked, state.y, ny)
        steps = state.steps + 1
        at_goal = (nx == GOAL[0]) & (ny == GOAL[1])
        reward = torch.where(
            at_goal & ~state.done,
            1.0 - 0.9 * steps.to(torch.float32) / MAX_STEPS,
            0.0,
        ).to(torch.float32)
        done_now = at_goal | (steps >= MAX_STEPS)
        new_state = GridWorldState(nx.to(torch.int32), ny.to(torch.int32),
                                   d.to(torch.int32), steps.to(torch.int32),
                                   state.done | done_now)
        return new_state, reward, new_state.done

    def action_to_string(self, action):
        return f"{action}. {['Turn left', 'Turn right', 'Forward'][int(action)]}"
