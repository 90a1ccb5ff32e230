"""gridworld game module (port of muzero_general_tpu/games/gridworld.py).

Config values are parity with reference games/gridworld.py:11-128; the env
is the batched torch GridWorld (envs/gridworld.py).
"""

from muzero_general_tpu_torch import config as config_lib
from muzero_general_tpu_torch.envs.gridworld import GridWorld


class MuZeroConfig(config_lib.MuZeroConfig):
    def __init__(self):
        super().__init__()

        self.seed = 0
        self.observation_shape = (7, 7, 3)
        self.action_space = list(range(3))
        self.players = list(range(1))
        self.stacked_observations = 0
        self.muzero_player = 0
        self.opponent = None

        self.num_workers = 4
        self.max_moves = 15
        self.num_simulations = 20
        self.discount = 0.997
        self.temperature_threshold = None
        self.root_dirichlet_alpha = 0.25
        self.root_exploration_fraction = 0.25
        self.pb_c_base = 19652
        self.pb_c_init = 1.25

        self.network = "fullyconnected"
        self.support_size = 10
        self.encoding_size = 8
        self.fc_representation_layers = []
        self.fc_dynamics_layers = [16]
        self.fc_reward_layers = [16]
        self.fc_value_layers = [16]
        self.fc_policy_layers = [16]

        self.training_steps = 30000
        self.batch_size = 128
        self.checkpoint_interval = 10
        self.value_loss_weight = 1
        self.optimizer = "Adam"
        self.weight_decay = 1e-4
        self.lr_init = 0.005
        self.lr_decay_rate = 1
        self.lr_decay_steps = 1000

        self.replay_buffer_size = 5000
        self.num_unroll_steps = 10
        self.td_steps = 20
        self.PER = False
        self.PER_alpha = 0.5
        self.use_last_model_value = False

        self.self_play_delay = 0
        self.training_delay = 0
        self.ratio = None

        self.parallel_games = 32
        self.selfplay_chunk_moves = 8

    def visit_softmax_temperature_fn(self, trained_steps):
        """Reference games/gridworld.py:115-128."""
        if trained_steps < 0.5 * self.training_steps:
            return 1.0
        elif trained_steps < 0.75 * self.training_steps:
            return 0.5
        else:
            return 0.25


def make_env(seed=None, device=None):
    return GridWorld(device=device)
