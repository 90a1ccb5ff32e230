"""Batched Tic-Tac-Toe (port of envs/tictactoe.py).

Parity with the reference env (reference games/tictactoe.py TicTacToe
:243-351 and Game.step reward*20 :143): a 3x3 board of +1/-1, win reward 20
from the mover's perspective, observation planes [board==+1, board==-1,
player plane], and the expert heuristic: the first winning line in the
scan order r0, c0, r1, c1, r2, c2, diag, anti, else the last line that
needs blocking, else a random legal move.
"""

from typing import Optional

import torch

from muzero_general_tpu_torch.envs.board import BoardEnv, BoardState

# Cell indices (flat 0..8) of each line in the reference's scan order
_LINE_CELLS = [
    [0, 1, 2], [0, 3, 6],
    [3, 4, 5], [1, 4, 7],
    [6, 7, 8], [2, 5, 8],
    [0, 4, 8], [6, 4, 2],
]


class TicTacToe(BoardEnv):
    observation_shape = (3, 3, 3)
    num_actions = 9

    def __init__(self, device=None):
        super().__init__(device)
        self._lines = torch.tensor(_LINE_CELLS, dtype=torch.long, device=self.device)

    def legal_actions_mask(self, state):
        return (state.board.reshape(-1, 9) == 0) & ~state.done[:, None]

    def _line_sums(self, board):
        return board.reshape(-1, 9).to(torch.int32)[:, self._lines].sum(-1)  # [G, 8]

    def step(self, state, action, generator: Optional[torch.Generator] = None):
        g = torch.arange(state.board.shape[0], device=self.device)
        action = action.long()
        board = state.board.clone()
        board[g, action // 3, action % 3] = state.player
        won = (self._line_sums(board) == 3 * state.player[:, None].to(torch.int32)).any(1)
        full = (board != 0).reshape(-1, 9).all(1)
        reward = torch.where(won & ~state.done, 20.0, 0.0)
        done = state.done | won | full
        return BoardState(board, -state.player, done), reward, done

    def expert_action(self, state, generator: Optional[torch.Generator] = None):
        """Reference tictactoe.py:308-348, over the batch."""
        player = state.player.to(torch.int32)[:, None]
        sums = self._line_sums(state.board)  # [G, 8]
        cells = state.board.reshape(-1, 9)[:, self._lines]  # [G, 8, 3]
        empty_pos = torch.argmax((cells == 0).to(torch.int8), dim=2)  # first empty
        empty_cell = self._lines[torch.arange(8, device=self.device), empty_pos]
        is2 = sums.abs() == 2
        iswin = is2 & (player * sums > 0)
        order = torch.arange(8, device=self.device)
        win_idx = torch.argmin(torch.where(iswin, order, 8), dim=1, keepdim=True)
        block_idx = torch.argmax(torch.where(is2, order, -1), dim=1, keepdim=True)
        random_action = self.random_legal_action(state, generator)
        return torch.where(
            iswin.any(1), empty_cell.gather(1, win_idx)[:, 0],
            torch.where(is2.any(1), empty_cell.gather(1, block_idx)[:, 0], random_action),
        ).to(torch.int32)

    # ---- human-facing (JAX envs/tictactoe.py:122-142) ---------------------
    def action_to_string(self, action):
        row = int(action) // 3 + 1
        col = int(action) % 3 + 1
        return f"Play row {row}, column {col}"

    def human_to_action(self, state):
        legal = self.legal_actions(state)
        while True:
            try:
                row = int(input("Enter the row (1, 2 or 3) to play: "))
                col = int(input("Enter the column (1, 2 or 3) to play: "))
                choice = (row - 1) * 3 + (col - 1)
                if choice in legal and 1 <= row <= 3 and 1 <= col <= 3:
                    return choice
            except (ValueError, EOFError):
                pass
            print("Wrong input, try again")
