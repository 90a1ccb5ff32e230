"""breakout game module (port of muzero_general_tpu/games/breakout.py; the
budget atari variant, config parity with reference games/breakout.py:11-110).

As the JAX package's, make_env plays ALE Breakout on the host
(envs/host.py AtariBreakout) when ale-py is installed, and the on-device
Breakout (envs/breakout.py) otherwise.
"""

from muzero_general_tpu_torch import config as config_lib
from muzero_general_tpu_torch.envs.breakout import Breakout
from muzero_general_tpu_torch.envs.host import AtariBreakout


class MuZeroConfig(config_lib.MuZeroConfig):
    def __init__(self):
        super().__init__()

        self.seed = 0
        self.observation_shape = (3, 96, 96)
        self.action_space = list(range(4))
        self.players = list(range(1))
        self.stacked_observations = 0
        self.muzero_player = 0
        self.opponent = None

        self.num_workers = 1
        self.max_moves = 2500
        self.num_simulations = 30
        self.discount = 0.997
        self.temperature_threshold = None
        self.root_dirichlet_alpha = 0.25
        self.root_exploration_fraction = 0.25
        self.pb_c_base = 19652
        self.pb_c_init = 1.25

        self.network = "resnet"
        self.support_size = 10
        self.downsample = "resnet"
        self.blocks = 2
        self.channels = 16
        self.reduced_channels_reward = 4
        self.reduced_channels_value = 4
        self.reduced_channels_policy = 4
        self.resnet_fc_reward_layers = [16]
        self.resnet_fc_value_layers = [16]
        self.resnet_fc_policy_layers = [16]
        self.encoding_size = 10
        self.fc_representation_layers = []
        self.fc_dynamics_layers = [16]
        self.fc_reward_layers = [16]
        self.fc_value_layers = []
        self.fc_policy_layers = []

        self.training_steps = int(1000e3)
        self.batch_size = 16
        self.checkpoint_interval = 500
        self.value_loss_weight = 0.25
        self.optimizer = "Adam"
        self.weight_decay = 1e-4
        self.lr_init = 0.005
        self.lr_decay_rate = 1
        self.lr_decay_steps = 350e3

        self.replay_buffer_size = int(1e6)
        self.num_unroll_steps = 5
        self.td_steps = 10
        self.PER = True
        self.PER_alpha = 1
        self.use_last_model_value = False

        self.self_play_delay = 0
        self.training_delay = 0
        self.ratio = None

        self.parallel_games = 8
        self.selfplay_chunk_moves = 8

    def visit_softmax_temperature_fn(self, trained_steps):
        """Reference games/breakout.py (absolute-step thresholds)."""
        if trained_steps < 500e3:
            return 1.0
        elif trained_steps < 750e3:
            return 0.5
        else:
            return 0.25


def make_env(seed=None, device=None):
    """ALE Breakout on the host when ale-py is installed (reference parity;
    `device` unused), else the on-device Breakout on `device`."""
    try:
        return AtariBreakout(seed=seed)
    except ImportError:
        return Breakout(device=device)
