"""Batched 11x11 Gomoku (port of envs/gomoku.py).

Parity with the reference env (reference games/gomoku.py:220-329): five in a
row over the 252 length-5 windows; reward 1 on ANY episode end, draws
included (a reference quirk kept for parity, gomoku.py:242-244); observation
planes [board==+1, board==-1, player plane]; letter coordinates for actions,
in rendering and human input too (JAX envs/gomoku.py:93-113). The expert is
the default one, a uniform legal move, as in the JAX env.
"""

from typing import Optional

import numpy as np
import torch

from muzero_general_tpu_torch.envs.board import BoardEnv, BoardState

SIZE = 11


def _five_windows():
    """All length-5 windows as [252, 5] flat cell indices (row * SIZE + col),
    in the JAX package's order: rows, columns, diagonals, anti-diagonals."""
    wins = []
    for r in range(SIZE):
        for c in range(SIZE - 4):
            wins.append([(r, c + i) for i in range(5)])
    for r in range(SIZE - 4):
        for c in range(SIZE):
            wins.append([(r + i, c) for i in range(5)])
    for r in range(SIZE - 4):
        for c in range(SIZE - 4):
            wins.append([(r + i, c + i) for i in range(5)])
    for r in range(4, SIZE):
        for c in range(SIZE - 4):
            wins.append([(r - i, c + i) for i in range(5)])
    cells = np.array(wins)
    return cells[..., 0] * SIZE + cells[..., 1]


class Gomoku(BoardEnv):
    observation_shape = (3, SIZE, SIZE)
    num_actions = SIZE * SIZE

    def __init__(self, device=None):
        super().__init__(device)
        self._windows = torch.as_tensor(_five_windows(), device=self.device)  # [252, 5]

    def legal_actions_mask(self, state):
        return (state.board.reshape(-1, SIZE * SIZE) == 0) & ~state.done[:, None]

    def step(self, state, action, generator: Optional[torch.Generator] = None):
        G = state.board.shape[0]
        g = torch.arange(G, device=self.device)
        action = action.long()
        board = state.board.clone()
        # As the JAX env: the stone is placed unconditionally.
        board[g, action // SIZE, action % SIZE] = state.player
        sums = board.reshape(G, -1).to(torch.int32)[:, self._windows].sum(-1)  # [G, 252]
        five = (sums.abs() == 5).any(1)
        full = (board != 0).reshape(G, -1).all(1)
        done_now = five | full
        reward = torch.where(done_now & ~state.done, 1.0, 0.0)
        done = state.done | done_now
        return BoardState(board, -state.player, done), reward, done

    # ---- human-facing (JAX envs/gomoku.py:93-113) -------------------------
    def render(self, state):
        board = state.board[0].cpu().numpy()
        markers = [chr(ord("A") + i) for i in range(SIZE)]
        print("  " + " ".join(markers))
        for row in range(SIZE):
            cells = [".XO"[int(v) if v >= 0 else 2] for v in board[row]]
            print(markers[row] + " " + " ".join(cells))

    @staticmethod
    def action_to_string(action):
        """Row letter then column letter, e.g. 13 -> "BC"."""
        x, y = int(action) // SIZE, int(action) % SIZE
        return chr(x + 65) + chr(y + 65)

    def human_to_action(self, state):
        legal = self.legal_actions(state)
        while True:
            s = input("Enter an action (e.g. AB for row A col B): ").strip().upper()
            if len(s) == 2 and all("A" <= ch < chr(ord("A") + SIZE) for ch in s):
                action = (ord(s[0]) - 65) * SIZE + (ord(s[1]) - 65)
                if action in legal:
                    return action
            print("Wrong input, try again")
