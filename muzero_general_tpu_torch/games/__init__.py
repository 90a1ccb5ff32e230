"""Per-game plugin modules: each exposes `MuZeroConfig` and `make_env()`.

Counterpart of muzero_general_tpu/games: the same eleven games, in its order
(lunarlander, atari and spiel run host envs, envs/host.py).
"""

AVAILABLE_GAMES = [
    "cartpole",
    "simple_grid",
    "tictactoe",
    "connect4",
    "gomoku",
    "twentyone",
    "gridworld",
    "lunarlander",
    "breakout",
    "atari",
    "spiel",
]
