"""lunarlander game module (port of muzero_general_tpu/games/lunarlander.py;
config parity with reference games/lunarlander.py:11-128).

Host-path env: gymnasium LunarLander with reward/3 scaling and, by default,
the reference's deterministic-engine semantics (zero impulse dispersion,
reference lunarlander.py:480) layered on the stock Box2D physics — see
envs/host.py LunarLander for the mechanism.
"""

from muzero_general_tpu_torch import config as config_lib
from muzero_general_tpu_torch.envs.host import LunarLander


class MuZeroConfig(config_lib.MuZeroConfig):
    def __init__(self):
        super().__init__()

        self.seed = 0
        self.observation_shape = (1, 1, 8)
        self.action_space = list(range(4))
        self.players = list(range(1))
        self.stacked_observations = 0
        self.muzero_player = 0
        self.opponent = None

        self.num_workers = 1
        self.max_moves = 700
        self.num_simulations = 50
        self.discount = 0.999
        self.temperature_threshold = None
        self.root_dirichlet_alpha = 0.25
        self.root_exploration_fraction = 0.25
        self.pb_c_base = 19652
        self.pb_c_init = 1.25

        self.network = "fullyconnected"
        self.support_size = 10
        self.encoding_size = 10
        self.fc_representation_layers = []
        self.fc_dynamics_layers = [64]
        self.fc_reward_layers = [64]
        self.fc_value_layers = [64]
        self.fc_policy_layers = [64]

        self.training_steps = 200000
        self.batch_size = 64
        self.checkpoint_interval = 10
        self.value_loss_weight = 1
        self.optimizer = "Adam"
        self.weight_decay = 1e-4
        self.lr_init = 0.005
        self.lr_decay_rate = 1
        self.lr_decay_steps = 1000

        self.replay_buffer_size = 2000
        self.num_unroll_steps = 10
        self.td_steps = 30
        self.PER = True
        self.PER_alpha = 0.5
        self.use_last_model_value = True

        self.self_play_delay = 0
        self.training_delay = 0
        # Reference best-known setting for the deterministic engine: ratio
        # annealed 0.8 -> 0.4 over the first 250 self-played games
        # (reference lunarlander.py:109, done by hand there; the exact
        # scheduler honors the callable directly, muzero.py train loop).
        self.ratio = lambda games: 0.8 - 0.4 * min(games, 250) / 250

        self.parallel_games = 16
        self.selfplay_chunk_moves = 8

    def visit_softmax_temperature_fn(self, trained_steps):
        """Reference games/lunarlander.py:124 (constant 0.35)."""
        return 0.35


def make_env(seed=None, deterministic=True, device=None):
    """deterministic=True matches the reference's zero-dispersion engine
    (games/lunarlander.py:480); pass False for the stock stochastic physics.
    A host env lives on the host: `device` (which MuZero passes every
    game's make_env) is ignored."""
    return LunarLander(seed=seed, deterministic=deterministic)
