"""Replay buffer: game storage, two-level PER, target generation, reanalyse
(port of muzero_general_tpu/replay.py).

Host-side ring of completed games with vectorized numpy batch assembly (the
games themselves come from the batched self-play driver, selfplay.py).
Semantics parity with reference replay_buffer.py:

- buffer keyed by monotonically increasing game_id, FIFO eviction beyond
  replay_buffer_size games (replay_buffer.py:53-61).
- initial priorities |root_value - n_step_target|^PER_alpha at save time,
  game priority = max position priority (replay_buffer.py:39-51).
- two-level prioritized sampling (games by game_priority, positions by
  per-position priority) with IS weights 1/(total_samples*game_prob*pos_prob)
  normalized by the batch max (replay_buffer.py:140-195, :113-118).
- n-step value targets with per-player sign flips, reanalysed-value
  substitution, absorbing-state and game-end boundary handling
  (replay_buffer.py:230-303).
- stale-update guards on evicted games (replay_buffer.py:198-228).

The buffer draws from np.random.default_rng(config.seed) in the JAX
package's order, so both packages assemble the same batches. `get_batch`
assembles on the C++ assembler (native/replay_sampler.cpp, built with g++
at first use) unless asked for the numpy path; the two agree bit for bit,
and a failed build raises.
"""

import bisect
import threading
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from muzero_general_tpu_torch.ops.stacking import stack_observations_np


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


def compute_target_values(gh: GameHistory, indices, td_steps, discount):
    """Vectorized n-step bootstrapped targets for `indices` [K].

    Parity: reference replay_buffer.py:230-262 including sign conventions:
    bootstrap value sign-flipped when the player at the bootstrap step differs
    from the player at `index`; reward i (at history position index+1+i)
    credited positively iff to_play[index+i] == to_play[index].
    Indices >= L return 0 (only used by absorbing positions).
    """
    L = len(gh)
    indices = np.asarray(indices)
    root_values = (
        gh.root_values
        if gh.reanalysed_predicted_root_values is None
        else gh.reanalysed_predicted_root_values
    )
    boot = indices + td_steps
    valid_boot = boot < L
    boot_c = np.clip(boot, 0, max(L - 1, 0))
    idx_c = np.clip(indices, 0, max(L - 1, 0))
    same_player = gh.to_play[boot_c] == gh.to_play[idx_c]
    boot_vals = np.where(same_player, root_values[boot_c], -root_values[boot_c])
    values = np.where(valid_boot, boot_vals * discount**td_steps, 0.0)

    # Discounted signed rewards r_{index+1} .. r_{min(boot, L)} as one
    # [K, td_steps] gather (the reference's per-index loop, vectorized).
    ks = np.arange(td_steps)
    r_idx = indices[:, None] + 1 + ks[None, :]  # [K, T]
    in_range = r_idx <= L
    r_idx_c = np.minimum(r_idx, L)
    p_idx_c = np.minimum(indices[:, None] + ks[None, :], L)
    sign = np.where(gh.to_play[p_idx_c] == gh.to_play[idx_c][:, None], 1.0, -1.0)
    disc = discount ** ks
    values = values + np.sum(
        np.where(in_range, sign * gh.rewards[r_idx_c] * disc[None, :], 0.0),
        axis=1,
    )
    return values.astype(np.float32)


def make_target(gh: GameHistory, pos, num_unroll_steps, td_steps, discount,
                action_space_size, rng: np.random.Generator):
    """Targets for positions pos..pos+U (reference replay_buffer.py:264-303).

    Returns (values [U+1], rewards [U+1], policies [U+1, A], actions [U+1]).
    """
    L = len(gh)
    U = num_unroll_steps
    idx = pos + np.arange(U + 1)
    in_game = idx < L
    boundary = idx == L

    values = np.where(in_game, compute_target_values(gh, idx, td_steps, discount), 0.0)
    idx_r = np.clip(idx, 0, L)
    rewards = np.where(in_game | boundary, gh.rewards[idx_r], 0.0)

    A = action_space_size
    uniform = np.full((A,), 1.0 / A, np.float32)
    idx_p = np.clip(idx, 0, max(L - 1, 0))
    policies = np.where(in_game[:, None], gh.child_visits[idx_p], uniform[None, :])

    actions = np.where(
        in_game | boundary,
        gh.actions[idx_r],
        rng.integers(0, A, size=U + 1),
    ).astype(np.int32)
    return (
        values.astype(np.float32),
        rewards.astype(np.float32),
        policies.astype(np.float32),
        actions,
    )


def _locked(fn):
    """Run the method under self.lock (see ReplayBuffer.lock)."""

    def wrapper(self, *args, **kwargs):
        with self.lock:
            return fn(self, *args, **kwargs)

    wrapper.__name__ = fn.__name__
    wrapper.__doc__ = fn.__doc__
    return wrapper


class ReplayBuffer:
    def __init__(self, config, initial_buffer: Optional[Dict[int, GameHistory]] = None,
                 num_played_games: int = 0, num_played_steps: int = 0):
        self.config = config
        self.buffer: Dict[int, GameHistory] = dict(initial_buffer or {})
        self.num_played_games = num_played_games
        self.num_played_steps = num_played_steps
        self.total_samples = sum(len(gh) for gh in self.buffer.values())
        self.rng = np.random.default_rng(config.seed)
        self._reanalyse_cursor = 0
        # Serializes buffer mutation against the background batch-assembly
        # thread (prefetch.BatchPrefetcher), as the reference's Ray actor
        # model does (one actor, one event loop).
        self.lock = threading.RLock()

    # ------------------------------------------------------------------
    @_locked
    def save_game(self, gh: GameHistory):
        if self.config.PER and gh.priorities is None:
            targets = compute_target_values(
                gh, np.arange(len(gh)), self.config.td_steps, self.config.discount
            )
            gh.priorities = (
                np.abs(gh.root_values - targets) ** self.config.PER_alpha
            ).astype(np.float32)
            gh.game_priority = float(np.max(gh.priorities)) if len(gh) else 0.0

        self.buffer[self.num_played_games] = gh
        self.num_played_games += 1
        self.num_played_steps += len(gh)
        self.total_samples += len(gh)

        if len(self.buffer) > self.config.replay_buffer_size:
            del_id = self.num_played_games - len(self.buffer)
            self.total_samples -= len(self.buffer[del_id])
            del self.buffer[del_id]

    # ------------------------------------------------------------------
    def sample_n_games(self, n, force_uniform=False):
        ids = np.fromiter(self.buffer.keys(), np.int64)
        if self.config.PER and not force_uniform:
            probs = np.array([gh.game_priority for gh in self.buffer.values()], np.float64)
            probs /= probs.sum()
            picks = self.rng.choice(len(ids), n, p=probs)
            return ids[picks], probs[picks]
        picks = self.rng.choice(len(ids), n)
        return ids[picks], np.full(n, np.nan)

    def sample_game(self, force_uniform=False):
        ids, probs = self.sample_n_games(1, force_uniform)
        return int(ids[0]), self.buffer[int(ids[0])], float(probs[0])

    def sample_position(self, gh: GameHistory, force_uniform=False):
        if self.config.PER and not force_uniform:
            cumsum = np.cumsum(gh.priorities, dtype=np.float64)
            total = cumsum[-1]
            pos = int(np.searchsorted(cumsum, self.rng.random() * total))
            pos = min(pos, len(gh) - 1)
            return pos, gh.priorities[pos] / total
        return self.rng.integers(0, len(gh)), np.nan

    # ------------------------------------------------------------------
    @_locked
    def get_batch(self, use_native: bool = True):
        """Assemble one training batch (reference replay_buffer.py:70-138).

        On the C++ assembler (native/replay_sampler.cpp), or on the numpy
        path below with use_native=False; the two give equal batches from
        equal rng states (the assembler's absorbing-state actions are drawn
        game by game, as make_target draws them). A failed build of the
        assembler raises.
        Returns (index_batch [B,2], batch dict of numpy arrays).
        """
        cfg = self.config
        B = cfg.batch_size
        U = cfg.num_unroll_steps
        A = len(cfg.action_space)
        n = cfg.stacked_observations
        c, h, w = cfg.observation_shape

        game_ids, game_probs = self.sample_n_games(B)
        index_batch = np.zeros((B, 2), np.int64)
        actions = np.zeros((B, U + 1), np.int32)
        values = np.zeros((B, U + 1), np.float32)
        rewards = np.zeros((B, U + 1), np.float32)
        policies = np.zeros((B, U + 1, A), np.float32)
        grad_scale = np.zeros((B, U + 1), np.float32)
        weights = np.ones((B,), np.float32)

        sampled = []
        for i, gid in enumerate(game_ids):
            gh = self.buffer[int(gid)]
            pos, pos_prob = self.sample_position(gh)
            index_batch[i] = (gid, pos)
            sampled.append((gh, pos))
            if cfg.PER:
                weights[i] = 1.0 / (self.total_samples * game_probs[i] * pos_prob)

        if use_native:
            from muzero_general_tpu_torch.native import build

            native = build.load_replay_native()
            obs_out = np.zeros((B, c * (n + 1) + n, h, w), np.float32)
            rnd = np.stack([self.rng.integers(0, A, size=U + 1) for _ in range(B)])

            def f32(a):
                return np.ascontiguousarray(a, np.float32)

            def i32(a):
                return np.ascontiguousarray(a, np.int32)

            rv = [
                f32(
                    gh.root_values
                    if gh.reanalysed_predicted_root_values is None
                    else gh.reanalysed_predicted_root_values
                )
                for gh, _ in sampled
            ]
            native.assemble_batch(
                [f32(gh.observations) for gh, _ in sampled],
                [i32(gh.actions) for gh, _ in sampled],
                [f32(gh.rewards) for gh, _ in sampled],
                [i32(gh.to_play) for gh, _ in sampled],
                [f32(gh.child_visits) for gh, _ in sampled],
                rv,
                np.array([p for _, p in sampled], np.int32),
                i32(rnd),
                U, cfg.td_steps, float(cfg.discount**cfg.td_steps),
                np.ascontiguousarray(cfg.discount ** np.arange(cfg.td_steps), np.float64),
                A, n, c, h, w,
                obs_out, actions, values, rewards, policies, grad_scale,
            )
        else:
            obs_batch = []
            for i, (gh, pos) in enumerate(sampled):
                v, r, p, a = make_target(gh, pos, U, cfg.td_steps, cfg.discount, A, self.rng)
                obs_batch.append(stack_observations_np(gh.observations, gh.actions, pos, n, A))
                actions[i], values[i], rewards[i], policies[i] = a, v, r, p
                # len(action_history) - pos (replay_buffer.py:103-111)
                grad_scale[i] = min(U, len(gh) + 1 - pos)
            obs_out = np.stack(obs_batch).astype(np.float32)

        if cfg.PER:
            weights = (weights / weights.max()).astype(np.float32)

        batch = {
            "observation": obs_out,
            "action": actions,
            "target_value": values,
            "target_reward": rewards,
            "target_policy": policies,
            "weight": weights,
            "gradient_scale": grad_scale,
        }
        return index_batch, batch

    # ------------------------------------------------------------------
    @_locked
    def update_priorities(self, priorities: np.ndarray, index_batch: np.ndarray):
        """Write back training-time priorities (replay_buffer.py:205-228)."""
        if not self.buffer:
            return
        oldest = next(iter(self.buffer))
        for i in range(len(index_batch)):
            gid, pos = int(index_batch[i, 0]), int(index_batch[i, 1])
            if gid >= oldest and gid in self.buffer:
                gh = self.buffer[gid]
                pr = priorities[i]
                end = min(pos + len(pr), len(gh.priorities))
                gh.priorities[pos:end] = pr[: end - pos]
                gh.game_priority = float(np.max(gh.priorities))

    @_locked
    def update_reanalysed_values(self, game_id: int, values: np.ndarray):
        """Store fresh root values (reference replay_buffer.py:365-369 + guard :197-203)."""
        if self.buffer and game_id >= next(iter(self.buffer)) and game_id in self.buffer:
            self.buffer[game_id].reanalysed_predicted_root_values = values.astype(np.float32)

    @_locked
    def reanalyse_pick(self, n: int):
        """Up to n (game_id, GameHistory) pairs, round-robin over the buffer.

        The reference's Reanalyse actor samples uniformly as fast as it can
        run (replay_buffer.py:328-373); the scheduled equivalent cycles the
        whole buffer so every game's values are refreshed at ~buffer rate
        instead of resampling lucky games.
        """
        if not self.buffer:
            return []
        ids = sorted(self.buffer.keys())
        i = bisect.bisect_left(ids, self._reanalyse_cursor)
        picks = [ids[(i + j) % len(ids)] for j in range(min(n, len(ids)))]
        self._reanalyse_cursor = picks[-1] + 1
        return [(gid, self.buffer[gid]) for gid in picks]

    def reanalyse_observations(self, gh: GameHistory):
        """Stacked observations for every position of a game [L, C', H, W]."""
        cfg = self.config
        return np.stack(
            [
                stack_observations_np(
                    gh.observations, gh.actions, i, cfg.stacked_observations,
                    len(cfg.action_space),
                )
                for i in range(len(gh))
            ]
        ).astype(np.float32)
