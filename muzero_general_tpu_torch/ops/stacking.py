"""Observation/action history stacking (port of ops/stacking.py:16-50).

Parity: reference GameHistory.get_stacked_observations (self_play.py:513-550):
channel order [obs_t, obs_{t-1}, plane(a_t), obs_{t-2}, plane(a_{t-1}), ...]
where plane(a) = a / action_space_size broadcast over H x W; missing history
is zero for both planes. The driver keeps ring histories, most recent first.
"""

import torch


def stack_observations(obs_hist, act_hist, action_space_size):
    """obs_hist [G, n+1, C, H, W], act_hist [G, n+1] -> [G, C*(n+1)+n, H, W].

    obs_hist[:, 0] is the current observation; act_hist[:, k] is the action
    that led to obs_hist[:, k].
    """
    g, n_plus_1, c, h, w = obs_hist.shape
    parts = [obs_hist[:, 0]]
    for k in range(1, n_plus_1):
        plane = (act_hist[:, k - 1].to(torch.float32) / action_space_size)[
            :, None, None, None
        ].expand(g, 1, h, w)
        parts.append(obs_hist[:, k])
        parts.append(plane)
    return torch.cat(parts, dim=1)


def push_history(obs_hist, act_hist, new_obs, action):
    """Shift the rings: the new observation/action become slot 0."""
    obs_hist = torch.cat([new_obs[:, None], obs_hist[:, :-1]], dim=1)
    act_hist = torch.cat(
        [action[:, None].to(act_hist.dtype), act_hist[:, :-1]], dim=1
    )
    return obs_hist, act_hist


def reset_history(obs_hist, act_hist, obs0, done):
    """Zero the rings for lanes where `done`, seeding slot 0 with obs0."""
    fresh_obs = torch.zeros_like(obs_hist)
    fresh_obs[:, 0] = obs0
    d_obs = done[:, None, None, None, None]
    obs_hist = torch.where(d_obs, fresh_obs, obs_hist)
    act_hist = torch.where(done[:, None], torch.zeros_like(act_hist), act_hist)
    return obs_hist, act_hist
