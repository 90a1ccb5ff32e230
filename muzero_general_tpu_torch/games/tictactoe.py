"""Tic-Tac-Toe game module (port of muzero_general_tpu/games/tictactoe.py).

Config values are parity with reference games/tictactoe.py:11-128; the env is
the batched torch TicTacToe (envs/tictactoe.py).
"""

from muzero_general_tpu_torch import config as config_lib
from muzero_general_tpu_torch.envs.tictactoe import TicTacToe


class MuZeroConfig(config_lib.MuZeroConfig):
    def __init__(self):
        super().__init__()

        self.seed = 0

        ### Game
        self.observation_shape = (3, 3, 3)
        self.action_space = list(range(9))
        self.players = list(range(2))
        self.stacked_observations = 0
        self.muzero_player = 0
        self.opponent = "expert"

        ### Self-Play
        self.num_workers = 1
        self.max_moves = 9
        self.num_simulations = 25
        self.discount = 1
        self.temperature_threshold = None
        self.root_dirichlet_alpha = 0.1
        self.root_exploration_fraction = 0.25
        self.pb_c_base = 19652
        self.pb_c_init = 1.25

        ### Network
        self.network = "resnet"
        self.support_size = 10
        self.downsample = False
        self.blocks = 1
        self.channels = 16
        self.reduced_channels_reward = 16
        self.reduced_channels_value = 16
        self.reduced_channels_policy = 16
        self.resnet_fc_reward_layers = [8]
        self.resnet_fc_value_layers = [8]
        self.resnet_fc_policy_layers = [8]
        self.encoding_size = 32
        self.fc_representation_layers = []
        self.fc_dynamics_layers = [16]
        self.fc_reward_layers = [16]
        self.fc_value_layers = []
        self.fc_policy_layers = []

        ### Training
        self.training_steps = 1000000
        self.batch_size = 64
        self.checkpoint_interval = 10
        self.value_loss_weight = 0.25
        self.optimizer = "Adam"
        self.weight_decay = 1e-4
        self.lr_init = 0.003
        self.lr_decay_rate = 1
        self.lr_decay_steps = 10000

        ### Replay Buffer
        self.replay_buffer_size = 3000
        self.num_unroll_steps = 20
        self.td_steps = 20
        self.PER = True
        self.PER_alpha = 0.5
        self.use_last_model_value = True

        ### Ratio
        self.self_play_delay = 0
        self.training_delay = 0
        self.ratio = None

        ### Accelerator knobs
        self.parallel_games = 64
        self.selfplay_chunk_moves = 9

    def visit_softmax_temperature_fn(self, trained_steps):
        """Reference games/tictactoe.py:114-122."""
        return 1


def make_env(seed=None, device=None):
    return TicTacToe(device=device)
