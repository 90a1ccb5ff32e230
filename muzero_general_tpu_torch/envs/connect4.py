"""Batched Connect Four (port of envs/connect4.py).

Parity with the reference env (reference games/connect4.py Connect4
:220-346 and Game.step reward*10 :144): a 6x7 board of +1/-1 with gravity,
win reward 10 from the mover's perspective over the 69 length-4 windows,
observation planes [board==+1, board==-1, player plane], and the
reference's sliding-sub-board expert: the first winning candidate in its
exact scan order, else the last blocking candidate (gravity feasibility
checked as the reference does), else a random legal move.
"""

from typing import Optional

import numpy as np
import torch

from muzero_general_tpu_torch.envs.board import BoardEnv, BoardState

ROWS, COLS = 6, 7


def _win_windows():
    """All length-4 windows as [69, 4] flat cell indices (row * COLS + col)."""
    wins = []
    for r in range(ROWS):
        for c in range(COLS - 3):
            wins.append([(r, c + i) for i in range(4)])
    for r in range(ROWS - 3):
        for c in range(COLS):
            wins.append([(r + i, c) for i in range(4)])
    for r in range(ROWS - 3):
        for c in range(COLS - 3):
            wins.append([(r + i, c + i) for i in range(4)])
    for r in range(3, ROWS):
        for c in range(COLS - 3):
            wins.append([(r - i, c + i) for i in range(4)])
    cells = np.array(wins)
    return cells[..., 0] * COLS + cells[..., 1]


def _expert_windows():
    """Candidate windows in the reference's exact scan order
    (connect4.py:307-343): for k in 0..2, l in 0..3 over 4x4 sub-boards,
    4 rows, 4 columns, the diagonal and the anti-diagonal each.

    Returns (cells [M, 4, 2] (row, col), kind [M]: 0 row, 1 column,
    2 diagonal, 3 anti-diagonal)."""
    cells, kinds = [], []
    for k in range(3):
        for l in range(4):
            for i in range(4):
                cells.append([(k + i, l + j) for j in range(4)])
                kinds.append(0)
                cells.append([(k + j, l + i) for j in range(4)])
                kinds.append(1)
            cells.append([(k + j, l + j) for j in range(4)])
            kinds.append(2)
            cells.append([(k + j, l + 3 - j) for j in range(4)])
            kinds.append(3)
    return np.array(cells), np.array(kinds)


class Connect4(BoardEnv):
    observation_shape = (3, ROWS, COLS)
    num_actions = COLS

    def __init__(self, device=None):
        super().__init__(device)
        dev = self.device
        self._windows = torch.as_tensor(_win_windows(), device=dev)  # [69, 4]
        cells, kinds = _expert_windows()
        self._exp_rows = torch.as_tensor(cells[..., 0], device=dev)  # [M, 4]
        self._exp_cols = torch.as_tensor(cells[..., 1], device=dev)
        self._exp_flat = self._exp_rows * COLS + self._exp_cols
        self._exp_is_col = torch.as_tensor(kinds == 1, device=dev)  # [M]

    def legal_actions_mask(self, state):
        return (state.board[:, ROWS - 1] == 0) & ~state.done[:, None]

    def step(self, state, action, generator: Optional[torch.Generator] = None):
        G = state.board.shape[0]
        g = torch.arange(G, device=self.device)
        action = action.long()
        empty = state.board[g, :, action] == 0  # [G, ROWS] the column
        row = torch.argmax(empty.to(torch.int8), dim=1)  # lowest empty row
        board = state.board.clone()
        board[g, row, action] = torch.where(empty.any(1), state.player,
                                            board[g, row, action])
        vals = board.reshape(G, -1).to(torch.int32)[:, self._windows]  # [G, 69, 4]
        won = (vals.sum(-1) == 4 * state.player[:, None].to(torch.int32)).any(1)
        full = (board[:, ROWS - 1] != 0).all(1)
        reward = torch.where(won & ~state.done, 10.0, 0.0)
        done = state.done | won | full
        return BoardState(board, -state.player, done), reward, done

    def expert_action(self, state, generator: Optional[torch.Generator] = None):
        """Reference connect4.py:307-343, over the batch and the 120 windows."""
        G = state.board.shape[0]
        board = state.board.to(torch.int32)
        player = state.player.to(torch.int32)[:, None]
        vals = board.reshape(G, -1)[:, self._exp_flat]  # [G, M, 4]
        sums = vals.sum(-1)  # [G, M]
        is3 = sums.abs() == 3
        # The empty cell of a window (exactly one where |sum| == 3)
        empty_pos = torch.argmax((vals == 0).to(torch.int8), dim=2, keepdim=True)
        M = sums.shape[1]
        empty_row = self._exp_rows.expand(G, M, 4).gather(2, empty_pos)[..., 0]
        empty_col = self._exp_cols.expand(G, M, 4).gather(2, empty_pos)[..., 0]
        col_counts = (board != 0).sum(1)  # stones per column [G, COLS]
        # Columns need no gravity check and play their own column
        # (connect4.py:317-320); the other kinds need the empty cell to be
        # the next free one of its column (:312-315, :327-331, :335-339).
        act = torch.where(self._exp_is_col, self._exp_cols[:, 0], empty_col)
        feasible = self._exp_is_col | (col_counts.gather(1, empty_col) == empty_row)
        candidate = is3 & feasible
        winning = candidate & (player * sums > 0)
        order = torch.arange(M, device=self.device)
        first_win = torch.argmin(torch.where(winning, order, M), dim=1, keepdim=True)
        last_block = torch.argmax(torch.where(candidate, order, -1), dim=1, keepdim=True)
        random_action = self.random_legal_action(state, generator)
        return torch.where(
            winning.any(1), act.gather(1, first_win)[:, 0],
            torch.where(candidate.any(1), act.gather(1, last_block)[:, 0],
                        random_action),
        ).to(torch.int32)
