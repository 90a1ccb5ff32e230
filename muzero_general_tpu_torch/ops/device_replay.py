"""Device-side replay: the game ring on the card, PER and target assembly as
tensor ops (port of ops/device_replay.py; opt-in, `config.device_replay`).

For games with small observations the whole replay path of a train round
(game storage, two-level prioritized sampling, n-step target assembly, IS
weights, priority write-back) runs on the device, so the train phase copies
no batch from the host. Semantics are the host ReplayBuffer's (replay.py),
as in the JAX package:
- a game ring of capacity G, FIFO eviction: game id i goes to slot i % G;
- initial priorities |root_value - n_step_target|^PER_alpha, game priority
  = the game's largest position priority;
- two-level PER (games by game priority, positions by position priority)
  with IS weights 1/(total_samples*game_prob*pos_prob) over the batch's
  largest;
- n-step value targets with per-player sign flips and the absorbing and
  boundary positions;
- priority write-back guarded against stale game ids.

As in JAX, games are stored padded to config.max_moves, the draws are
categorical (torch.multinomial from a torch.Generator on the device) and
the fill actions beyond a game's end come from the device generator. Every
update is in place on the ring's tensors (JAX donates its buffers); the
functions return the same DeviceReplay. `sample_indices` and
`assemble_batch` take injected draws (slots, positions, fill actions), so
tests can hand in the JAX side's.

Where a batch's write-back hits one (slot, position) more than once, the
last write in batch order wins, as in the host buffer's loop (JAX's scatter
keeps one of them).
"""

from typing import NamedTuple

import numpy as np
import torch

from muzero_general_tpu_torch.models.common import FullPrecision


class DeviceReplay(NamedTuple):
    """Game ring of capacity G, every game padded to Lmax positions."""

    observations: torch.Tensor  # [G, Lmax, C, H, W] f32
    actions: torch.Tensor  # [G, Lmax+1] i32 (index 0 = sentinel)
    rewards: torch.Tensor  # [G, Lmax+1] f32
    to_play: torch.Tensor  # [G, Lmax+1] i32
    child_visits: torch.Tensor  # [G, Lmax, A] f32
    root_values: torch.Tensor  # [G, Lmax] f32 (reanalyse overwrites in place)
    priorities: torch.Tensor  # [G, Lmax] f32, 0 beyond the game's length
    game_priority: torch.Tensor  # [G] f32, 0 = empty slot
    game_len: torch.Tensor  # [G] i32, 0 = empty slot
    game_id: torch.Tensor  # [G] i32 (monotonic; -1 = empty)
    num_played_games: torch.Tensor  # 0-d i32 (the id source)
    total_samples: torch.Tensor  # 0-d i32 (sum of live game lengths)


def init_replay(capacity, max_len, obs_shape, num_actions, device) -> DeviceReplay:
    c, h, w = obs_shape
    G, L = capacity, max_len

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return DeviceReplay(
        observations=zeros(G, L, c, h, w),
        actions=zeros(G, L + 1, dtype=torch.int32),
        rewards=zeros(G, L + 1),
        to_play=zeros(G, L + 1, dtype=torch.int32),
        child_visits=zeros(G, L, num_actions),
        root_values=zeros(G, L),
        priorities=zeros(G, L),
        game_priority=zeros(G),
        game_len=zeros(G, dtype=torch.int32),
        game_id=torch.full((G,), -1, dtype=torch.int32, device=device),
        num_played_games=zeros(dtype=torch.int32),
        total_samples=zeros(dtype=torch.int32),
    )


def _take(rows, idx):
    """rows [..., L] gathered at idx [..., *rest] -> [..., *rest]."""
    flat = idx.reshape(idx.shape[: rows.dim() - 1] + (-1,))
    return torch.gather(rows, -1, flat).reshape(idx.shape)


def compute_target_values(root_values, rewards, to_play, length, indices, td_steps,
                          discount):
    """n-step bootstrapped targets at `indices` [..., I] of games given as
    padded rows (root_values [..., Lmax], rewards and to_play [..., Lmax+1],
    length [...]): JAX device_replay.py:70-99, itself the host
    replay.compute_target_values. Returns float32 [..., I]."""
    L = length.long()[..., None]  # [..., 1]
    indices = indices.long()
    boot = indices + td_steps
    valid_boot = boot < L
    Lm1 = torch.clamp(L - 1, min=0)
    boot_c = torch.minimum(torch.clamp(boot, min=0), Lm1)
    idx_c = torch.minimum(torch.clamp(indices, min=0), Lm1)
    tp_idx = _take(to_play, idx_c)
    same_player = _take(to_play, boot_c) == tp_idx
    rv = _take(root_values, boot_c)
    boot_vals = torch.where(same_player, rv, -rv)
    values = torch.where(valid_boot, boot_vals * discount**td_steps, 0.0)

    ks = torch.arange(td_steps, device=indices.device)
    r_idx = indices[..., None] + 1 + ks  # [..., I, T]
    in_range = r_idx <= L[..., None]
    r_idx_c = torch.minimum(r_idx, L[..., None])
    p_idx_c = torch.minimum(indices[..., None] + ks, L[..., None])
    sign = torch.where(_take(to_play, p_idx_c) == tp_idx[..., None], 1.0, -1.0)
    disc = torch.pow(torch.tensor(discount, dtype=torch.float32, device=ks.device),
                     ks.to(torch.float32))
    values = values + torch.sum(
        torch.where(in_range, sign * _take(rewards, r_idx_c) * disc, 0.0), dim=-1)
    return values.to(torch.float32)


def _initial_priorities(root_values, rewards, to_play, length, td_steps, discount,
                        per_alpha):
    """|root_value - n_step_target|^alpha over the games' positions [K,
    Lmax] (replay_buffer.py:39-51), zero beyond each game's length."""
    K, Lmax = root_values.shape
    idx = torch.arange(Lmax, device=root_values.device).expand(K, Lmax)
    targets = compute_target_values(root_values, rewards, to_play, length, idx, td_steps,
                                    discount)
    pr = torch.abs(root_values - targets) ** per_alpha
    return torch.where(idx < length.long()[:, None], pr, 0.0).to(torch.float32)


def save_games(state: DeviceReplay, games, valid, *, td_steps, discount, per_alpha,
               use_per=True) -> DeviceReplay:
    """Insert up to K padded games at the ring cursor, in place.

    games: a dict of tensors on the ring's device, observation [K, Lmax, C,
    H, W], action/reward/to_play [K, Lmax+1], child_visits [K, Lmax, A],
    root_values [K, Lmax], length [K]; valid [K] bool: lanes beyond the
    completed games are skipped (pad_games_np's fixed K). FIFO eviction is
    the ring: the slot written, num_played_games % G, holds the oldest game
    once the ring is full, and total_samples loses its length.
    """
    G = state.game_len.shape[0]
    length = games["length"]
    if use_per:
        prior = _initial_priorities(games["root_values"], games["reward"], games["to_play"],
                                    length, td_steps, discount, per_alpha)
    else:
        # Uniform sampling still tracks lengths; priorities mark validity.
        Lmax = state.root_values.shape[1]
        idx = torch.arange(Lmax, device=length.device)
        prior = (idx[None, :] < length.long()[:, None]).to(torch.float32)
    gpri = torch.amax(prior, dim=1)

    # Two host reads: which lanes hold games, and the cursor.
    ok = (torch.as_tensor(valid, device=length.device) & (length > 0)).tolist()
    cursor = int(state.num_played_games)
    fields = (("observations", "observation"), ("actions", "action"), ("rewards", "reward"),
              ("to_play", "to_play"), ("child_visits", "child_visits"),
              ("root_values", "root_values"))
    for k, keep in enumerate(ok):
        if not keep:
            continue
        slot = cursor % G
        for name, key in fields:
            getattr(state, name)[slot] = games[key][k]
        state.priorities[slot] = prior[k]
        state.game_priority[slot] = gpri[k]
        state.total_samples.add_(length[k] - state.game_len[slot])
        state.game_len[slot] = length[k]
        state.game_id[slot] = cursor
        cursor += 1
    state.num_played_games.fill_(cursor)
    return state


def sample_indices(state: DeviceReplay, generator, batch_size, use_per=True, slots=None,
                   pos=None):
    """Two-level PER draw: (slots [B], positions [B], game_probs [B],
    pos_probs [B]), distributed as JAX's categorical draws (live games with
    priority 0 keep a weight of 1e-30; a game whose position priorities are
    all 0 is drawn from uniformly). `slots` and `pos` inject the draws;
    their probabilities are computed all the same."""
    live = state.game_len > 0
    if use_per:
        gp = torch.where(live, state.game_priority, 0.0)
    else:
        gp = live.to(torch.float32)
    gsum = torch.clamp(torch.sum(gp), min=1e-30)
    if slots is None:
        weights = torch.where(live, torch.clamp(gp, min=1e-30), 0.0)
        slots = torch.multinomial(weights, batch_size, replacement=True, generator=generator)
    slots = slots.long()
    game_probs = gp[slots] / gsum

    pr = state.priorities[slots]  # [B, Lmax]
    Lmax = pr.shape[1]
    lens = state.game_len[slots]
    in_game = (torch.arange(Lmax, device=pr.device)[None, :] < lens[:, None]).to(torch.float32)
    if use_per:
        p = torch.where(torch.sum(pr, dim=1, keepdim=True) > 0, pr, in_game)
    else:
        p = in_game
    if pos is None:
        pos = torch.multinomial(p, 1, generator=generator)[:, 0]
    pos = pos.long()
    pos_probs = torch.gather(
        p / torch.clamp(torch.sum(p, dim=1, keepdim=True), min=1e-30), 1, pos[:, None])[:, 0]
    return slots, pos, game_probs, pos_probs


def _stack_observations(state: DeviceReplay, slots, pos, num_stacked, num_actions):
    """The stacked observations of the games at (slots, pos) [B]: JAX
    device_replay.py:227-241, ops.stacking.stack_observations_np's channel
    order. Returns [B, C*(n+1)+n, H, W]."""
    B = slots.shape[0]
    _, _, c, h, w = state.observations.shape
    parts = [state.observations[slots, pos]]
    for back in range(1, num_stacked + 1):
        past = pos - back
        okp = (past >= 0)[:, None, None, None]
        past_c = torch.clamp(past, min=0)
        parts.append(torch.where(okp, state.observations[slots, past_c], 0.0))
        plane = state.actions[slots, past_c + 1].to(torch.float32) / num_actions
        parts.append(torch.where(okp, plane[:, None, None, None], 0.0).expand(B, 1, h, w))
    return torch.cat(parts, dim=1)


def assemble_batch(state: DeviceReplay, generator, slots, pos, game_probs, pos_probs, *,
                   num_unroll_steps, td_steps, discount, num_actions, num_stacked,
                   use_per=True, fill_actions=None):
    """The training batch of the sampled (slot, pos) pairs: JAX
    device_replay.py:244-317 (replay.make_target + get_batch). The actions
    beyond a game's end (and its boundary) are drawn from `generator`, or
    taken from `fill_actions` [B, U+1]. Returns (index_batch [B, 3] int32 =
    (game_id, pos, slot), batch dict of tensors)."""
    U = num_unroll_steps
    B = slots.shape[0]
    dev = slots.device
    slots, pos = slots.long(), pos.long()
    idx = pos[:, None] + torch.arange(U + 1, device=dev)  # [B, U+1]
    ln = state.game_len[slots].long()[:, None]
    in_game = idx < ln
    boundary = idx == ln
    values = compute_target_values(state.root_values[slots], state.rewards[slots],
                                   state.to_play[slots], ln[:, 0], idx, td_steps, discount)
    values = torch.where(in_game, values, 0.0)
    srow = slots[:, None]
    idx_r = torch.minimum(idx, ln)
    rewards = torch.where(in_game | boundary, state.rewards[srow, idx_r], 0.0)
    idx_p = torch.minimum(idx, torch.clamp(ln - 1, min=0))
    policies = torch.where(in_game[..., None], state.child_visits[srow, idx_p],
                           torch.full((num_actions,), 1.0 / num_actions, device=dev))
    if fill_actions is None:
        fill_actions = torch.randint(0, num_actions, (B, U + 1), generator=generator,
                                     device=dev)
    actions = torch.where(in_game | boundary, state.actions[srow, idx_r],
                          fill_actions.to(dev)).to(torch.int32)
    obs = _stack_observations(state, slots, pos, num_stacked, num_actions)
    # len(action_history) - pos = ln + 1 - pos (replay_buffer.py:103-111)
    grad_scale = torch.clamp(ln + 1 - pos[:, None], max=U).to(torch.float32).expand(B, U + 1)
    if use_per:
        w = 1.0 / (torch.clamp(state.total_samples, min=1).to(torch.float32)
                   * torch.clamp(game_probs, min=1e-30) * torch.clamp(pos_probs, min=1e-30))
        weights = (w / torch.amax(w)).to(torch.float32)
    else:
        weights = torch.ones((B,), device=dev)
    index_batch = torch.stack([state.game_id[slots], pos.to(torch.int32),
                               slots.to(torch.int32)], dim=1)
    batch = {
        "observation": obs,
        "action": actions,
        "target_value": values,
        "target_reward": rewards,
        "target_policy": policies,
        "weight": weights,
        "gradient_scale": grad_scale.contiguous(),
    }
    return index_batch, batch


def get_batch(state: DeviceReplay, generator, batch_size, *, num_unroll_steps, td_steps,
              discount, num_actions, num_stacked, use_per=True, draws=None):
    """sample_indices + assemble_batch. draws: an optional dict of injected
    "slots", "pos" and "fill_actions"."""
    draws = draws or {}
    slots, pos, gprob, pprob = sample_indices(state, generator, batch_size, use_per=use_per,
                                              slots=draws.get("slots"), pos=draws.get("pos"))
    return assemble_batch(
        state, generator, slots, pos, gprob, pprob, num_unroll_steps=num_unroll_steps,
        td_steps=td_steps, discount=discount, num_actions=num_actions,
        num_stacked=num_stacked, use_per=use_per, fill_actions=draws.get("fill_actions"),
    )


def update_priorities(state: DeviceReplay, priorities, index_batch) -> DeviceReplay:
    """Stale-guarded priority write-back (replay_buffer.py:205-228), in
    place: priorities [B, U+1]; index_batch [B, 3] = (game_id, pos, slot).
    An update lands only where the slot still holds the sampled game and
    inside the game's length; of several updates to one position, the last
    in batch order. Game priorities are then every slot's row maximum."""
    B, U1 = priorities.shape
    G, Lmax = state.priorities.shape
    index_batch = index_batch.long()
    gid, pos, slot = index_batch[:, 0], index_batch[:, 1], index_batch[:, 2]
    fresh = state.game_id[slot].long() == gid  # [B]
    cols = pos[:, None] + torch.arange(U1, device=pos.device)  # [B, U+1]
    ln = state.game_len[slot].long()
    ok = fresh[:, None] & (cols < ln[:, None]) & (cols < Lmax)
    cell = slot[:, None] * Lmax + torch.clamp(cols, max=Lmax - 1)  # [B, U+1]
    # The last ok update of each cell, in batch order; every update aimed
    # at a cell (masked ones included) then writes that cell's final value,
    # so repeated targets agree.
    order = torch.arange(B * U1, device=pos.device).reshape(B, U1)
    last = torch.full((G * Lmax,), -1, dtype=torch.long, device=pos.device)
    last.scatter_reduce_(0, cell.reshape(-1), torch.where(ok, order, -1).reshape(-1), "amax")
    flat = state.priorities.view(-1)
    winner = last[cell]
    value = torch.where(winner >= 0,
                        priorities.reshape(-1).to(flat.dtype)[torch.clamp(winner, min=0)],
                        flat[cell])
    flat[cell.reshape(-1)] = value.reshape(-1)
    torch.amax(state.priorities, dim=1, out=state.game_priority)
    return state


def update_reanalysed_values(state: DeviceReplay, slot, game_id, values) -> DeviceReplay:
    """Overwrite a game's root values with fresh ones (reanalyse; reference
    replay_buffer.py:365-369 with the stale guard of :197-203), in place:
    only where `slot` still holds `game_id`."""
    fresh = state.game_id[slot] == game_id
    row = torch.as_tensor(values, dtype=torch.float32, device=state.root_values.device)
    state.root_values[slot] = torch.where(fresh, row, state.root_values[slot])
    return state


def pad_games_np(games, max_len, obs_shape, num_actions, k_pad):
    """Pad a list of host GameHistory objects into fixed-shape [k_pad, ...]
    numpy chunks for save_games. Returns a list of (games_dict, valid)."""
    c, h, w = obs_shape
    chunks = []
    for at in range(0, len(games), k_pad):
        part = games[at: at + k_pad]
        out = {
            "observation": np.zeros((k_pad, max_len, c, h, w), np.float32),
            "action": np.zeros((k_pad, max_len + 1), np.int32),
            "reward": np.zeros((k_pad, max_len + 1), np.float32),
            "to_play": np.zeros((k_pad, max_len + 1), np.int32),
            "child_visits": np.zeros((k_pad, max_len, num_actions), np.float32),
            "root_values": np.zeros((k_pad, max_len), np.float32),
            "length": np.zeros((k_pad,), np.int32),
        }
        valid = np.zeros((k_pad,), bool)
        for k, gh in enumerate(part):
            L = min(len(gh), max_len)
            out["observation"][k, :L] = gh.observations[:L]
            out["action"][k, : L + 1] = gh.actions[: L + 1]
            out["reward"][k, : L + 1] = gh.rewards[: L + 1]
            out["to_play"][k, : L + 1] = gh.to_play[: L + 1]
            out["child_visits"][k, :L] = gh.child_visits[:L]
            rv = (
                gh.root_values
                if gh.reanalysed_predicted_root_values is None
                else gh.reanalysed_predicted_root_values
            )
            out["root_values"][k, :L] = rv[:L]
            out["length"][k] = L
            valid[k] = True
        chunks.append((out, valid))
    return chunks


def make_device_train(learner, config, M):
    """The whole train round on the device: sample M PER batches from the
    ring, run M learner steps, write the M priority sets back (JAX
    device_replay.py:406-437). Returns fn(dev_replay, generator,
    draws=None) -> the last step's metrics; the ring and the learner are
    updated in place. draws: an optional list of M dicts for get_batch.

    All M batches come from the same ring state, then the steps run, then
    the write-backs follow in order (interleaving them would change which
    positions the later batches draw). The steps run in one FullPrecision,
    as Learner.train_steps; the batches are on the device already."""
    cfg = config
    B = cfg.batch_size
    use_per = bool(cfg.PER)
    kw = dict(num_unroll_steps=cfg.num_unroll_steps, td_steps=cfg.td_steps,
              discount=cfg.discount, num_actions=len(cfg.action_space),
              num_stacked=cfg.stacked_observations, use_per=use_per)

    def step(dev: DeviceReplay, generator, draws=None):
        parts = [get_batch(dev, generator, B, draws=draws[m] if draws else None, **kw)
                 for m in range(M)]
        priorities = []
        with FullPrecision():
            for _, batch in parts:
                metrics, pr = learner._step(batch)
                priorities.append(pr)
        if use_per:
            for (index_batch, _), pr in zip(parts, priorities):
                update_priorities(dev, pr, index_batch)
        return metrics

    return step
