"""Single-game evaluation against scripted opponents (port of evaluate.py).

Counterpart of the reference's test path with opponent modes (reference
muzero.py:369-424 test, self_play.py:188-220 select_opponent_action):
"self", "random", "expert", "human". MuZero's turns run the staged batched
search at batch 1 on the network's device; the opponents' turns are host
logic (random, human) or the env's batched expert on a one-game batch.

- `_mcts_policy_fn` is JAX evaluate.py:22-60: `run_mcts` with root noise,
  its spec from `SearchSpec.from_config(config, batch_size=1, device)`. The
  port's copy of the JAX block gate decides the route, as JAX's does: at
  batch 1 no lane block fits, so the search runs on the plain-op route on
  any device (the kernels want >= 8 lanes a block; the stream route wants
  8 lanes).
- `play_against_opponent` is :63-192. The random opponent draws from
  np.random.default_rng(seed) exactly as JAX does, so a random-opponent
  game is comparable move for move; the expert and the env's reset draw
  from a torch.Generator seeded with `seed` (torch cannot replay JAX's
  PRNG). `start` sets the env's start state explicitly, as env.reset takes
  it.
- `manual_game` is :195-221, device-env branch.

Not ported, and refused with NotImplementedError: the Gumbel search
(:25-41; ROADMAP queue 1 item 6) and host envs (:77-97; item 8).
"""

import numpy as np
import torch

from muzero_general_tpu_torch.ops import mcts as mcts_ops
from muzero_general_tpu_torch.ops.stacking import stack_observations_np
from muzero_general_tpu_torch.replay import GameHistory


def _mcts_policy_fn(network, config, device):
    """The batch-1 search: (obs [1, ...], legal [1, A], to_play [1],
    generator) -> MCTSOutput, with root noise on (JAX evaluate.py:49-56)."""
    if getattr(config, "use_gumbel_mcts", False):
        raise NotImplementedError(
            "the Gumbel evaluation search is not ported yet (ROADMAP queue 1 item 6)"
        )
    spec = mcts_ops.SearchSpec.from_config(config, batch_size=1, device=device)

    @torch.no_grad()
    def search(obs, legal, to_play, generator):
        return mcts_ops.run_mcts(
            network.initial_inference, network.recurrent_inference, obs, legal,
            to_play, generator, spec, add_exploration_noise=True,
        )

    search.spec = spec
    return search


def _refuse_host_env(env):
    if getattr(env, "host_env", False):
        raise NotImplementedError(
            "host envs (gymnasium and the like) are not ported yet (ROADMAP queue 1 item 8)"
        )


def play_against_opponent(env, network, config, opponent, muzero_player, seed=0,
                          render=False, start=None):
    """Play one game; MuZero (`network`, in eval mode) moves on its turns,
    `opponent` otherwise.

    Returns a GameHistory (same aggregation contract as reference test()).
    """
    _refuse_host_env(env)
    device = env.device
    np_rng = np.random.default_rng(seed)
    generator = torch.Generator(device=device).manual_seed(seed)
    search = _mcts_policy_fn(network, config, device)
    A = env.num_actions
    n = config.stacked_observations

    if start is not None:
        start = torch.as_tensor(start, device=device)[None]
    state = env.reset(1, generator, start)

    def observation():
        return env.observation(state)[0].cpu().numpy()

    def to_play_now():
        return int(env.to_play(state)[0])

    obs_list = [observation()]
    actions, rewards, to_plays = [0], [0.0], [to_play_now()]
    child_visits, root_values = [], []
    done = False

    if render:
        env.render(state)

    while not done and len(actions) <= config.max_moves:
        observations = np.stack(obs_list)
        stacked = stack_observations_np(
            observations, np.asarray(actions, np.int64), len(obs_list) - 1, n, A
        )[None]
        legal_t = env.legal_actions_mask(state)
        legal = legal_t.cpu().numpy()
        to_play = to_play_now()

        if opponent == "self" or to_play == muzero_player or len(config.players) == 1:
            out = search(
                torch.from_numpy(stacked).to(device), legal_t,
                torch.full((1,), to_play, dtype=torch.int32, device=device), generator,
            )
            visits = out.root_visit_counts[0].cpu().numpy()
            action = int(np.argmax(np.where(legal[0], visits, -1)))
            child_visits.append(visits / max(1, visits.sum()))
            root_value = float(out.root_value[0])
            root_values.append(root_value)
            if render:
                print(f"Tree depth: {int(out.max_tree_depth[0])}")
                print(f"Root value for player {to_play}: {root_value:.2f}")
        else:
            if opponent == "random":
                legal_idx = np.flatnonzero(legal[0])
                action = int(np_rng.choice(legal_idx))
            elif opponent == "expert":
                action = int(env.expert_action(state, generator)[0])
            elif opponent == "human":
                action = int(env.human_to_action(state))
            else:
                raise NotImplementedError(
                    '"opponent" argument should be "self", "human", "expert" or "random"'
                )
            child_visits.append(np.zeros(A, np.float32))
            root_values.append(0.0)

        state, reward, done_t = env.step(
            state, torch.full((1,), action, dtype=torch.long, device=device), generator
        )
        done = bool(done_t[0])
        if render:
            print(f"Played action: {env.action_to_string(action)}")
            env.render(state)

        obs_list.append(observation())
        actions.append(action)
        rewards.append(float(reward[0]))
        to_plays.append(to_play_now())

    return GameHistory(
        observations=np.stack(obs_list[:-1]).astype(np.float32),
        actions=np.asarray(actions, np.int32),
        rewards=np.asarray(rewards, np.float32),
        to_play=np.asarray(to_plays, np.int32),
        child_visits=np.stack(child_visits).astype(np.float32),
        root_values=np.asarray(root_values, np.float32),
    )


def manual_game(env, seed=0):
    """Play the env by hand (reference CLI menu 'Test the game manually')."""
    _refuse_host_env(env)
    generator = torch.Generator(device=env.device).manual_seed(seed)
    total = 0.0
    state = env.reset(1, generator)
    env.render(state)
    done = False
    while not done:
        action = env.human_to_action(state)
        state, reward, done_t = env.step(
            state, torch.full((1,), action, dtype=torch.long, device=env.device), generator
        )
        done = bool(done_t[0])
        total += float(reward[0])
        print(f"Reward: {float(reward[0])}")
        env.render(state)
    print(f"Total reward: {total}")
