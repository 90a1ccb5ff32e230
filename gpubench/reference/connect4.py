"""Plain numpy reference of Connect Four (muzero-general games/connect4.py):
a 6 x 7 board, row 0 at the bottom, stones +1 / -1 with gravity, reward 10
to the mover for four in a row, done on a win or a full board. The
observation is [board == +1, board == -1, plane of the player to move]."""

import numpy as np

ROWS, COLS = 6, 7


def _windows():
    cells = []
    for r in range(ROWS):
        for c in range(COLS - 3):
            cells.append([(r, c + i) for i in range(4)])
    for r in range(ROWS - 3):
        for c in range(COLS):
            cells.append([(r + i, c) for i in range(4)])
    for r in range(ROWS - 3):
        for c in range(COLS - 3):
            cells.append([(r + i, c + i) for i in range(4)])
    for r in range(3, ROWS):
        for c in range(COLS - 3):
            cells.append([(r - i, c + i) for i in range(4)])
    cells = np.array(cells)
    return cells[..., 0] * COLS + cells[..., 1]  # [69, 4] flat cells


WINDOWS = _windows()


def decode(obs):
    """(board [..., 6, 7] int, player [...] +1/-1, well-formed [...]) of
    observations [..., 3, 6, 7]."""
    p1, p2, plane = obs[..., 0, :, :], obs[..., 1, :, :], obs[..., 2, :, :]
    player = plane[..., 0, 0]
    ok = (np.isin(p1, (0.0, 1.0)).all((-2, -1)) & np.isin(p2, (0.0, 1.0)).all((-2, -1))
          & ((p1 * p2) == 0).all((-2, -1)) & np.isin(player, (-1.0, 1.0))
          & (plane == player[..., None, None]).all((-2, -1)))
    board = p1.astype(np.int64) - p2.astype(np.int64)
    return board, np.where(player > 0, 1, -1), ok


def encode(board, player):
    return np.stack([(board == 1), (board == -1),
                     np.broadcast_to(player[..., None, None], board.shape)], axis=-3
                    ).astype(np.float32)


def legal_mask(board):
    return board[..., ROWS - 1, :] == 0


def step(board, player, action):
    """(next board, reward, done, legal) of dropping `player`'s stone in
    column `action`, over any leading shape."""
    board = board.copy()
    lead = board.shape[:-2]
    col = np.take_along_axis(board, action[..., None, None].repeat(ROWS, -2), -1)[..., 0]
    empty = col == 0
    legal = empty.any(-1)
    row = np.argmax(empty, axis=-1)
    idx = np.indices(lead)
    board[(*idx, row, action)] = np.where(legal, player, board[(*idx, row, action)])
    flat = board.reshape(*lead, ROWS * COLS)
    sums = flat[..., WINDOWS].sum(-1)  # [..., 69]
    won = (sums == 4 * player[..., None]).any(-1)
    full = (board[..., ROWS - 1, :] != 0).all(-1)
    return board, np.where(won, 10.0, 0.0), won | full, legal


def check_transitions(obs, action, reward, done, to_play, to_play_next):
    """Per (move, lane) of consecutive self-play records [T, G, ...]: True
    where the record disagrees with the rules: a malformed observation, the
    wrong player to move, an illegal action, a wrong reward or done flag, or
    a next observation that is not the board after the move (a fresh board,
    +1 to move, after a done). The last move's next observation is not
    known, so only its own fields are checked."""
    board, player, ok = decode(obs)
    bad = ~ok
    bad |= to_play != np.where(player == 1, 0, 1)
    nb, r, d, legal = step(board, player, action.astype(np.int64))
    bad |= ~legal
    bad |= reward != r
    bad |= done != d
    bad |= to_play_next != np.where(-player == 1, 0, 1)
    fresh = encode(np.zeros_like(nb), np.ones_like(player))
    want = np.where(d[..., None, None, None], fresh, encode(nb, -player))
    bad[:-1] |= (obs[1:] != want[:-1]).any((-3, -2, -1))
    return bad


def legal_from_obs(obs):
    """Legal root actions [..., 7] of observations [..., 3, 6, 7]."""
    return legal_mask(decode(obs)[0])
