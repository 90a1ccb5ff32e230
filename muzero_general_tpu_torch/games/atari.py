"""atari game module (port of muzero_general_tpu/games/atari.py; paper-scale
Breakout, config parity with reference games/atari.py:11-106). Requires
ale-py (see envs/host.py)."""

from muzero_general_tpu_torch import config as config_lib
from muzero_general_tpu_torch.envs.host import AtariBreakout


class MuZeroConfig(config_lib.MuZeroConfig):
    def __init__(self):
        super().__init__()

        self.seed = 0
        self.observation_shape = (3, 96, 96)
        self.action_space = list(range(4))
        self.players = list(range(1))
        self.stacked_observations = 32
        self.muzero_player = 0
        self.opponent = None

        self.num_workers = 350
        self.max_moves = 27000
        self.num_simulations = 50
        self.discount = 0.997
        self.temperature_threshold = None
        self.root_dirichlet_alpha = 0.25
        self.root_exploration_fraction = 0.25
        self.pb_c_base = 19652
        self.pb_c_init = 1.25

        self.network = "resnet"
        self.support_size = 300
        self.downsample = "resnet"
        self.blocks = 16
        self.channels = 256
        self.reduced_channels_reward = 256
        self.reduced_channels_value = 256
        self.reduced_channels_policy = 256
        self.resnet_fc_reward_layers = [256, 256]
        self.resnet_fc_value_layers = [256, 256]
        self.resnet_fc_policy_layers = [256, 256]
        self.encoding_size = 10
        self.fc_representation_layers = []
        self.fc_dynamics_layers = [16]
        self.fc_reward_layers = [16]
        self.fc_value_layers = []
        self.fc_policy_layers = []

        self.training_steps = int(1000e3)
        self.batch_size = 1024
        self.checkpoint_interval = int(1e3)
        self.value_loss_weight = 0.25
        self.optimizer = "SGD"
        self.weight_decay = 1e-4
        self.momentum = 0.9
        self.lr_init = 0.05
        self.lr_decay_rate = 0.1
        self.lr_decay_steps = 350e3

        self.replay_buffer_size = int(1e6)
        self.num_unroll_steps = 5
        self.td_steps = 10
        self.PER = True
        self.PER_alpha = 1
        self.use_last_model_value = True

        self.self_play_delay = 0
        self.training_delay = 0
        self.ratio = None

        self.parallel_games = 350  # the reference's num_workers as a batch dim
        self.selfplay_chunk_moves = 8
        self.compute_dtype = "bfloat16"  # paper-scale net: bf16 matmuls on MXU

    def visit_softmax_temperature_fn(self, trained_steps):
        """Reference games/atari.py (absolute-step thresholds)."""
        if trained_steps < 500e3:
            return 1.0
        elif trained_steps < 750e3:
            return 0.5
        else:
            return 0.25


def make_env(seed=None, device=None):
    """ALE Breakout on the host (`device` is ignored)."""
    return AtariBreakout(seed=seed)
