"""Episode container (port of the GameHistory of replay.py:36+).

Only what self-play produces is ported so far; the PER replay buffer, target
generation and the C++ sampler are ROADMAP module item 8.
"""

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class GameHistory:
    """One completed episode as numpy arrays.

    Layout parity with reference self_play.py:479-494: index 0 of actions/
    rewards/to_play is the pre-game sentinel; observations[i] is the state
    the i-th move was taken from (the post-terminal observation is dropped).
    """

    observations: np.ndarray  # [L, C, H, W] float32
    actions: np.ndarray  # [L+1] int32, actions[0] = 0 sentinel
    rewards: np.ndarray  # [L+1] float32, rewards[0] = 0
    to_play: np.ndarray  # [L+1] int32
    child_visits: np.ndarray  # [L, A] float32
    root_values: np.ndarray  # [L] float32
    reanalysed_predicted_root_values: Optional[np.ndarray] = None  # [L]
    priorities: Optional[np.ndarray] = None  # [L]
    game_priority: Optional[float] = None

    def __len__(self):
        return len(self.root_values)
