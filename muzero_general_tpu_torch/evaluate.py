"""Single-game evaluation against scripted opponents (port of evaluate.py).

Counterpart of the reference's test path with opponent modes (reference
muzero.py:369-424 test, self_play.py:188-220 select_opponent_action):
"self", "random", "expert", "human". MuZero's turns run the staged batched
search at batch 1 on the network's device; the opponents' turns are host
logic (random, human), the env's batched expert on a one-game batch, or a
host env's own expert.

- `_mcts_policy_fn` is JAX evaluate.py:22-60: `run_mcts` with root noise,
  its spec from `SearchSpec.from_config(config, batch_size=1, device)`. The
  port's copy of the JAX block gate decides the route, as JAX's does: at
  batch 1 no lane block fits, so the search runs on the plain-op route on
  any device (the kernels want >= 8 lanes a block; the stream route wants
  8 lanes). Under `use_gumbel_mcts` it is the deterministic greedy Gumbel
  search (ops/gumbel.py, `add_gumbel=False`; JAX :25-41), whose
  `greedy_action` MuZero plays (JAX :147-149).
- `play_against_opponent` is :63-192, over both env protocols as JAX's
  accessors are (:74-120): a device env (a one-game batch on env.device)
  or a host env (envs/host.py; the search on the network's device). The
  random opponent draws from np.random.default_rng(seed) exactly as JAX
  does, so a random-opponent game is comparable move for move; a host
  env's expert draws from the same numpy generator, as in JAX; a device
  env's expert and reset draw from a torch.Generator seeded with `seed`
  (torch cannot replay JAX's PRNG). `start` sets a device env's start
  state explicitly, as env.reset takes it.
- `manual_game` is :195-221, both branches.
"""

import numpy as np
import torch

from muzero_general_tpu_torch.ops import gumbel as gumbel_ops
from muzero_general_tpu_torch.ops import mcts as mcts_ops
from muzero_general_tpu_torch.ops.stacking import stack_observations_np
from muzero_general_tpu_torch.replay import GameHistory


def _mcts_policy_fn(network, config, device):
    """The batch-1 search: (obs [1, ...], legal [1, A], to_play [1],
    generator) -> MCTSOutput, with root noise on (JAX evaluate.py:49-56);
    under use_gumbel_mcts, GumbelMCTSOutput without the Gumbel draw (JAX
    :25-41)."""
    if getattr(config, "use_gumbel_mcts", False):
        gspec = gumbel_ops.GumbelSpec.from_config(config)

        @torch.no_grad()
        def gumbel_search(obs, legal, to_play, generator):
            return gumbel_ops.run_gumbel_mcts(
                network.initial_inference, network.recurrent_inference, obs, legal,
                to_play, generator, gspec, add_gumbel=False,
            )

        gumbel_search.spec = gspec
        return gumbel_search
    spec = mcts_ops.SearchSpec.from_config(config, batch_size=1, device=device)

    @torch.no_grad()
    def search(obs, legal, to_play, generator):
        return mcts_ops.run_mcts(
            network.initial_inference, network.recurrent_inference, obs, legal,
            to_play, generator, spec, add_exploration_noise=True,
        )

    search.spec = spec
    return search


class _DeviceGame:
    """One game of a batched device env, with the accessors the evaluation
    loop uses (JAX evaluate.py:99-120)."""

    def __init__(self, env, generator, start=None):
        self.env, self.generator = env, generator
        if start is not None:
            start = torch.as_tensor(start, device=env.device)[None]
        self.state = env.reset(1, generator, start)

    def observation(self):
        return self.env.observation(self.state)[0].cpu().numpy()

    def legal(self):
        return self.env.legal_actions_mask(self.state)[0].cpu().numpy()

    def to_play(self):
        return int(self.env.to_play(self.state)[0])

    def step(self, action):
        self.state, reward, done = self.env.step(
            self.state, torch.full((1,), action, dtype=torch.long, device=self.env.device),
            self.generator)
        return self.observation(), float(reward[0]), bool(done[0])

    def expert(self, np_rng):
        return int(self.env.expert_action(self.state, self.generator)[0])

    def human(self):
        return int(self.env.human_to_action(self.state))

    def render(self):
        self.env.render(self.state)


class _HostGame:
    """A host env (envs/host.py) behind the same accessors (JAX
    evaluate.py:77-97)."""

    def __init__(self, env):
        self.env = env
        self._obs = env.reset()

    def observation(self):
        return np.asarray(self._obs)

    def legal(self):
        return np.asarray(self.env.legal_actions_mask())

    def to_play(self):
        return int(self.env.to_play())

    def step(self, action):
        self._obs, reward, done = self.env.step(action)
        return self.observation(), float(reward), bool(done)

    def expert(self, np_rng):
        return self.env.expert_action(np_rng)

    def human(self):
        return int(input(f"Enter action (0-{self.env.num_actions - 1}): "))

    def render(self):
        self.env.render()


def play_against_opponent(env, network, config, opponent, muzero_player, seed=0,
                          render=False, start=None):
    """Play one game; MuZero (`network`, in eval mode) moves on its turns,
    `opponent` otherwise.

    Returns a GameHistory (same aggregation contract as reference test()).
    """
    is_host = getattr(env, "host_env", False)
    device = next(network.parameters()).device if is_host else env.device
    np_rng = np.random.default_rng(seed)
    generator = torch.Generator(device=device).manual_seed(seed)
    search = _mcts_policy_fn(network, config, device)
    A = env.num_actions
    n = config.stacked_observations
    game = _HostGame(env) if is_host else _DeviceGame(env, generator, start)

    obs_list = [game.observation()]
    actions, rewards, to_plays = [0], [0.0], [game.to_play()]
    child_visits, root_values = [], []
    done = False

    if render:
        game.render()

    while not done and len(actions) <= config.max_moves:
        observations = np.stack(obs_list)
        stacked = stack_observations_np(
            observations, np.asarray(actions, np.int64), len(obs_list) - 1, n, A
        )[None]
        legal = game.legal()[None]
        legal_t = torch.from_numpy(legal).to(device)
        to_play = game.to_play()

        if opponent == "self" or to_play == muzero_player or len(config.players) == 1:
            out = search(
                torch.from_numpy(stacked).to(device), legal_t,
                torch.full((1,), to_play, dtype=torch.int32, device=device), generator,
            )
            visits = out.root_visit_counts[0].cpu().numpy()
            if isinstance(out, gumbel_ops.GumbelMCTSOutput):
                action = int(out.greedy_action[0])
            else:
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
                action = int(game.expert(np_rng))
            elif opponent == "human":
                action = game.human()
            else:
                raise NotImplementedError(
                    '"opponent" argument should be "self", "human", "expert" or "random"'
                )
            child_visits.append(np.zeros(A, np.float32))
            root_values.append(0.0)

        obs, reward, done = game.step(action)
        if render:
            print(f"Played action: {env.action_to_string(action)}")
            game.render()

        obs_list.append(obs)
        actions.append(action)
        rewards.append(reward)
        to_plays.append(game.to_play())

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
    if getattr(env, "host_env", False):
        game = _HostGame(env)
    else:
        game = _DeviceGame(env, torch.Generator(device=env.device).manual_seed(seed))
    total = 0.0
    game.render()
    done = False
    while not done:
        _, reward, done = game.step(game.human())
        total += reward
        print(f"Reward: {reward}")
        game.render()
    print(f"Total reward: {total}")
