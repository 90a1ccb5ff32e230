"""Gomoku game module (port of muzero_general_tpu/games/gomoku.py).

Config values are parity with reference games/gomoku.py:11-128; the env is
the batched torch Gomoku (envs/gomoku.py). At 400 simulations and 121
actions the tree is too big for the planar kernels, so the staged search
takes the streaming route (ops/mcts_stream.py) on the card.
"""

from muzero_general_tpu_torch import config as config_lib
from muzero_general_tpu_torch.envs.gomoku import Gomoku


class MuZeroConfig(config_lib.MuZeroConfig):
    def __init__(self):
        super().__init__()

        self.seed = 0

        ### Game
        self.observation_shape = (3, 11, 11)
        self.action_space = list(range(11 * 11))
        self.players = list(range(2))
        self.stacked_observations = 0
        self.muzero_player = 0
        self.opponent = "random"

        ### Self-Play
        self.num_workers = 2
        self.max_moves = 121
        self.num_simulations = 400
        self.discount = 1
        self.temperature_threshold = None
        self.root_dirichlet_alpha = 0.3
        self.root_exploration_fraction = 0.25
        self.pb_c_base = 19652
        self.pb_c_init = 1.25

        ### Network
        self.network = "resnet"
        self.support_size = 10
        self.downsample = False
        self.blocks = 6
        self.channels = 128
        self.reduced_channels_reward = 2
        self.reduced_channels_value = 2
        self.reduced_channels_policy = 4
        self.resnet_fc_reward_layers = [64]
        self.resnet_fc_value_layers = [64]
        self.resnet_fc_policy_layers = [64]
        self.encoding_size = 32
        self.fc_representation_layers = []
        self.fc_dynamics_layers = [64]
        self.fc_reward_layers = [64]
        self.fc_value_layers = []
        self.fc_policy_layers = []

        ### Training
        self.training_steps = 10000
        self.batch_size = 512
        self.checkpoint_interval = 50
        self.value_loss_weight = 1
        self.optimizer = "Adam"
        self.weight_decay = 1e-4
        self.lr_init = 0.002
        self.lr_decay_rate = 0.9
        self.lr_decay_steps = 10000

        ### Replay Buffer
        self.replay_buffer_size = 10000
        self.num_unroll_steps = 121
        self.td_steps = 121
        self.PER = True
        self.PER_alpha = 0.5
        self.use_last_model_value = False

        ### Ratio
        self.self_play_delay = 0
        self.training_delay = 0
        self.ratio = 1

        ### Accelerator knobs
        self.parallel_games = 32
        self.selfplay_chunk_moves = 8

    def visit_softmax_temperature_fn(self, trained_steps):
        """Reference games/gomoku.py:115-128."""
        if trained_steps < 0.5 * self.training_steps:
            return 1.0
        elif trained_steps < 0.75 * self.training_steps:
            return 0.5
        else:
            return 0.25


def make_env(seed=None, device=None):
    return Gomoku(device=device)
