"""Per-game plugin modules: each exposes `MuZeroConfig` and `make_env()`.

Counterpart of muzero_general_tpu/games; only the games whose envs are
ported are listed (the rest are ROADMAP queue 1 item 4).
"""

AVAILABLE_GAMES = [
    "cartpole",
    "connect4",
    "gomoku",
    "simple_grid",
    "tictactoe",
]
