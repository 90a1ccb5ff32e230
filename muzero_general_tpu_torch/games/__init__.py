"""Per-game plugin modules: each exposes `MuZeroConfig` and `make_env()`.

Counterpart of muzero_general_tpu/games, in its order; only the games whose
envs are ported are listed (atari, lunarlander and spiel run host envs:
ROADMAP queue 1 item 8).
"""

AVAILABLE_GAMES = [
    "cartpole",
    "simple_grid",
    "tictactoe",
    "connect4",
    "gomoku",
    "twentyone",
    "gridworld",
    "breakout",
]
