"""Host-path environments (port of muzero_general_tpu/envs/host.py): envs
whose backends cannot run on the device (gymnasium, Box2D, ALE, OpenSpiel).

Counterpart of the reference's AbstractGame wrappers around gym envs
(reference games/cartpole.py:131-204, lunarlander.py:131-162, atari.py:109-199).
They are pure numpy and step on the host, one game each; the
HostSelfPlayDriver (hostplay.py) batches N of them and runs the search for
all of them on the device each move. The backends are imported where the
JAX package imports them, inside the constructors (and cv2 inside
AtariBreakout._preprocess), so importing this module needs none of them.
"""

import numpy as np


class HostEnv:
    """Stateful host env with the AbstractGame step contract."""

    observation_shape = None  # (C, H, W)
    num_actions = None
    num_players = 1
    host_env = True

    def reset(self) -> np.ndarray:
        raise NotImplementedError

    def step(self, action):
        """-> (observation [C,H,W], reward, done)"""
        raise NotImplementedError

    def legal_actions_mask(self) -> np.ndarray:
        return np.ones(self.num_actions, bool)

    def to_play(self) -> int:
        return 0

    def close(self):
        pass

    def render(self):
        pass

    def action_to_string(self, action):
        return str(action)

    def expert_action(self, rng):
        legal = np.flatnonzero(self.legal_actions_mask())
        return int(rng.choice(legal))


class _ZeroUniformRNG:
    """np_random stand-in whose uniform() is always 0.

    Swapped in around LunarLander.step() to zero the engine-impulse
    dispersion exactly like the reference's deterministic Box2D fork
    (reference games/lunarlander.py:480: `dispersion = [0 for _ in range(2)]`
    where gymnasium draws uniform(-1, 1)/SCALE). Everything else (reset
    terrain + initial force, reference :399-400) keeps the real RNG.
    """

    def __init__(self, real):
        self._real = real

    def uniform(self, *args, **kwargs):
        return 0.0

    def __getattr__(self, name):
        return getattr(self._real, name)


class LunarLander(HostEnv):
    """gymnasium LunarLander with reward/3 scaling (reference
    games/lunarlander.py:141-149). The reference ships a from-scratch Box2D
    lander with engine dispersion zeroed (lunarlander.py:291-651, :480)
    because a deterministic transition model helps MuZero's learned dynamics;
    `deterministic=True` (the default, matching the reference) reproduces
    that on top of the stock gymnasium physics by zeroing the per-step
    dispersion draws while keeping the random initial conditions.
    """

    observation_shape = (1, 1, 8)
    num_actions = 4

    def __init__(self, seed=None, deterministic=True):
        import gymnasium

        self.env = gymnasium.make("LunarLander-v3")
        self.deterministic = deterministic
        self._seed = seed
        self._rng = np.random.default_rng(seed)

    def reset(self):
        obs, _ = self.env.reset(seed=int(self._rng.integers(0, 2**31 - 1)))
        return np.array([[obs]], np.float32)

    def step(self, action):
        core = self.env.unwrapped
        if self.deterministic:
            real = core._np_random
            core._np_random = _ZeroUniformRNG(real)
            try:
                obs, reward, terminated, truncated, _ = self.env.step(int(action))
            finally:
                core._np_random = real
        else:
            obs, reward, terminated, truncated, _ = self.env.step(int(action))
        return np.array([[obs]], np.float32), float(reward) / 3.0, bool(
            terminated or truncated
        )

    def close(self):
        self.env.close()

    def action_to_string(self, action):
        return f"{action}. " + ["Do nothing", "Fire left engine",
                                "Fire main engine", "Fire right engine"][int(action)]


class AtariBreakout(HostEnv):
    """Breakout with the reference's preprocessing: cv2 resize to 96x96,
    /255, CHW (reference games/atari.py:146-160). Requires ale-py; without
    it construction raises ImportError."""

    observation_shape = (3, 96, 96)
    num_actions = 4

    def __init__(self, seed=None, env=None):
        """env: injectable backend with the gymnasium reset/step surface,
        which lets the preprocessing and the driver run without ale-py
        (tests/test_torch_host_envs.py, chip_smoke.py's phase 16)."""
        if env is not None:
            self.env = env
        else:
            try:
                import ale_py  # noqa: F401
                import gymnasium

                self.env = gymnasium.make("ALE/Breakout-v5")
            except ImportError as e:
                raise ImportError(
                    "The atari/breakout games need ale-py (gymnasium[atari]), "
                    "which is not available in this environment."
                ) from e
        self._rng = np.random.default_rng(seed)

    def _preprocess(self, obs):
        import cv2

        obs = cv2.resize(obs, (96, 96), interpolation=cv2.INTER_AREA)
        return np.moveaxis(obs, -1, 0).astype(np.float32) / 255.0

    def reset(self):
        obs, _ = self.env.reset(seed=int(self._rng.integers(0, 2**31 - 1)))
        return self._preprocess(obs)

    def step(self, action):
        obs, reward, terminated, truncated, _ = self.env.step(int(action))
        return self._preprocess(obs), float(reward), bool(terminated or truncated)

    def close(self):
        self.env.close()


class SpielGame(HostEnv):
    """OpenSpiel wrapper (reference games/spiel.py:240-297). Requires
    pyspiel; without it construction raises ImportError."""

    def __init__(self, game_name="tic_tac_toe", seed=None, game=None):
        """game: injectable pyspiel-like game object (observation_tensor_shape
        / policy_tensor_shape / num_players / new_initial_state surface),
        which lets the wrapper run without open_spiel."""
        if game is not None:
            self.game = game
        else:
            try:
                import pyspiel
            except ImportError as e:
                raise ImportError(
                    "The spiel game needs open_spiel (pyspiel), which is not "
                    "available in this environment."
                ) from e
            self.game = pyspiel.load_game(game_name)
        shape = self.game.observation_tensor_shape()
        self.observation_shape = tuple(shape) if len(shape) == 3 else (
            1, 1, int(np.prod(shape))
        )
        self.num_actions = self.game.policy_tensor_shape()[0]
        self.num_players = self.game.num_players()
        self.state = None

    def reset(self):
        self.state = self.game.new_initial_state()
        return self._obs()

    def _obs(self):
        t = np.asarray(
            self.state.observation_tensor(self.state.current_player()), np.float32
        )
        return t.reshape(self.observation_shape)

    def step(self, action):
        player = self.state.current_player()
        self.state.apply_action(int(action))
        done = self.state.is_terminal()
        reward = self.state.player_return(player) if done else 0.0
        return self._obs() if not done else np.zeros(
            self.observation_shape, np.float32
        ), float(reward), bool(done)

    def to_play(self):
        return max(0, self.state.current_player())

    def legal_actions_mask(self):
        mask = np.zeros(self.num_actions, bool)
        mask[self.state.legal_actions()] = True
        return mask
