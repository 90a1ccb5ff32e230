"""twentyone game module (port of muzero_general_tpu/games/twentyone.py).

Config values are parity with reference games/twentyone.py:11-128; the env
is the batched torch TwentyOne (envs/twentyone.py).
"""

from muzero_general_tpu_torch import config as config_lib
from muzero_general_tpu_torch.envs.twentyone import TwentyOne


class MuZeroConfig(config_lib.MuZeroConfig):
    def __init__(self):
        super().__init__()

        self.seed = 0
        self.observation_shape = (3, 3, 3)
        self.action_space = list(range(2))
        self.players = list(range(1))
        self.stacked_observations = 0
        self.muzero_player = 0
        self.opponent = None

        self.num_workers = 4
        self.max_moves = 21
        self.num_simulations = 21
        self.discount = 1
        self.temperature_threshold = None
        self.root_dirichlet_alpha = 0.25
        self.root_exploration_fraction = 0.25
        self.pb_c_base = 19652
        self.pb_c_init = 1.25

        self.network = "resnet"
        self.support_size = 10
        self.downsample = False
        self.blocks = 2
        self.channels = 32
        self.reduced_channels_reward = 32
        self.reduced_channels_value = 32
        self.reduced_channels_policy = 32
        self.resnet_fc_reward_layers = [16]
        self.resnet_fc_value_layers = [16]
        self.resnet_fc_policy_layers = [16]
        self.encoding_size = 32
        self.fc_representation_layers = [16]
        self.fc_dynamics_layers = [16]
        self.fc_reward_layers = [16]
        self.fc_value_layers = [16]
        self.fc_policy_layers = [16]

        self.training_steps = 15000
        self.batch_size = 64
        self.checkpoint_interval = 10
        self.value_loss_weight = 0.25
        self.optimizer = "SGD"
        self.weight_decay = 1e-4
        self.momentum = 0.9
        self.lr_init = 0.03
        self.lr_decay_rate = 0.75
        self.lr_decay_steps = 150000

        self.replay_buffer_size = 10000
        self.num_unroll_steps = 20
        self.td_steps = 50
        self.PER = True
        self.PER_alpha = 0.5
        self.use_last_model_value = True

        self.self_play_delay = 0
        self.training_delay = 0
        self.ratio = None

        self.parallel_games = 64
        self.selfplay_chunk_moves = 8

    def visit_softmax_temperature_fn(self, trained_steps):
        """Reference games/twentyone.py:115-128 (absolute-step thresholds)."""
        if trained_steps < 500e3:
            return 1.0
        elif trained_steps < 750e3:
            return 0.5
        else:
            return 0.25


def make_env(seed=None, device=None):
    return TwentyOne(device=device)
