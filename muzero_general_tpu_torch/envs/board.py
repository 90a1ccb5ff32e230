"""Shared pieces of the batched two-player board games (tictactoe, connect4).

A state holds G boards of +1/-1/0 stones ([G, H, W] int8, row 0 = bottom),
the player to move (+1 or -1, the reference's encoding) and a done flag.
Observation planes, the player index and the random fallback of the expert
are the same for both games (reference games/tictactoe.py, connect4.py).
"""

from typing import NamedTuple, Optional

import torch

from muzero_general_tpu_torch.envs.core import TorchEnv


class BoardState(NamedTuple):
    board: torch.Tensor  # [G, H, W] int8: +1 / -1 / 0
    player: torch.Tensor  # [G] int8: +1 or -1
    done: torch.Tensor  # [G] bool


class BoardEnv(TorchEnv):
    num_players = 2

    def reset(self, num_games: int, generator: Optional[torch.Generator] = None,
              start: Optional[torch.Tensor] = None) -> BoardState:
        """Empty boards, player +1 to move; or the explicit `start` boards
        [G, H, W], with +1 to move where both have as many stones."""
        _, h, w = self.observation_shape
        if start is None:
            board = torch.zeros((num_games, h, w), dtype=torch.int8, device=self.device)
        else:
            board = torch.as_tensor(start, device=self.device).to(torch.int8)
            if board.shape != (num_games, h, w):
                raise ValueError(f"start must be [{num_games}, {h}, {w}], "
                                 f"got {tuple(board.shape)}")
        stones = (board == 1).sum((1, 2)) - (board == -1).sum((1, 2))
        player = torch.where(stones == 0, 1, -1).to(torch.int8)
        done = torch.zeros((num_games,), dtype=torch.bool, device=self.device)
        return BoardState(board, player, done)

    def observation(self, state):
        b = state.board
        plane = state.player.to(torch.float32)[:, None, None].expand(b.shape)
        return torch.stack([(b == 1).to(torch.float32), (b == -1).to(torch.float32),
                            plane], dim=1)

    def to_play(self, state):
        return torch.where(state.player == 1, 0, 1).to(torch.int32)

    def random_legal_action(self, state, generator=None):
        """A uniform draw over the legal actions (over all actions where none
        is legal), as jax.random.categorical over a 0 / -inf mask."""
        legal = self.legal_actions_mask(state)
        u = torch.rand(legal.shape, generator=generator, device=self.device)
        return torch.argmax(torch.where(legal, u, -1.0), dim=1)
