"""CartPole game module (port of muzero_general_tpu/games/cartpole.py).

Config values are parity with reference games/cartpole.py:11-128; the env is
the batched torch CartPole (envs/cartpole.py).
"""

from muzero_general_tpu_torch import config as config_lib
from muzero_general_tpu_torch.envs.cartpole import CartPole


class MuZeroConfig(config_lib.MuZeroConfig):
    def __init__(self):
        super().__init__()

        self.seed = 0

        ### Game
        self.observation_shape = (1, 1, 4)
        self.action_space = list(range(2))
        self.players = list(range(1))
        self.stacked_observations = 0
        self.muzero_player = 0
        self.opponent = None

        ### Self-Play
        self.num_workers = 1
        self.max_moves = 500
        self.num_simulations = 50
        self.discount = 0.997
        self.temperature_threshold = None
        self.root_dirichlet_alpha = 0.25
        self.root_exploration_fraction = 0.25
        self.pb_c_base = 19652
        self.pb_c_init = 1.25

        ### Network
        self.network = "fullyconnected"
        self.support_size = 10
        self.encoding_size = 8
        self.fc_representation_layers = []
        self.fc_dynamics_layers = [16]
        self.fc_reward_layers = [16]
        self.fc_value_layers = [16]
        self.fc_policy_layers = [16]

        ### Training
        self.training_steps = 10000
        self.batch_size = 128
        self.checkpoint_interval = 10
        self.value_loss_weight = 1
        self.optimizer = "Adam"
        self.weight_decay = 1e-4
        self.lr_init = 0.02
        self.lr_decay_rate = 0.8
        self.lr_decay_steps = 1000

        ### Replay Buffer
        self.replay_buffer_size = 500
        self.num_unroll_steps = 10
        self.td_steps = 50
        self.PER = True
        self.PER_alpha = 0.5
        self.use_last_model_value = True

        ### Ratio
        self.self_play_delay = 0
        self.training_delay = 0
        self.ratio = 1.5

        ### Accelerator knobs
        self.parallel_games = 16
        self.selfplay_chunk_moves = 8

    def visit_softmax_temperature_fn(self, trained_steps):
        """Reference games/cartpole.py:115-128."""
        if trained_steps < 0.5 * self.training_steps:
            return 1.0
        elif trained_steps < 0.75 * self.training_steps:
            return 0.5
        else:
            return 0.25


def make_env(seed=None, device=None):
    return CartPole(device=device)
