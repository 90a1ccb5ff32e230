"""simple_grid game module (port of muzero_general_tpu/games/simple_grid.py).

Config values are parity with reference games/simple_grid.py:11-128; the env
is the batched torch SimpleGrid (envs/simple_grid.py). It is the game of the
CPU-scale learning gate (tests/test_e2e_learning.py).
"""

from muzero_general_tpu_torch import config as config_lib
from muzero_general_tpu_torch.envs.simple_grid import SimpleGrid


class MuZeroConfig(config_lib.MuZeroConfig):
    def __init__(self):
        super().__init__()

        self.seed = 0

        ### Game
        self.observation_shape = (1, 1, 9)
        self.action_space = list(range(2))
        self.players = list(range(1))
        self.stacked_observations = 0
        self.muzero_player = 0
        self.opponent = None

        ### Self-Play
        self.num_workers = 1
        self.max_moves = 6
        self.num_simulations = 10
        self.discount = 0.978
        self.temperature_threshold = None
        self.root_dirichlet_alpha = 0.25
        self.root_exploration_fraction = 0.25
        self.pb_c_base = 19652
        self.pb_c_init = 1.25

        ### Network
        self.network = "fullyconnected"
        self.support_size = 10
        self.encoding_size = 5
        self.fc_representation_layers = [16]
        self.fc_dynamics_layers = [16]
        self.fc_reward_layers = [16]
        self.fc_value_layers = [16]
        self.fc_policy_layers = [16]

        ### Training
        self.training_steps = 30000
        self.batch_size = 32
        self.checkpoint_interval = 10
        self.value_loss_weight = 1
        self.optimizer = "Adam"
        self.weight_decay = 1e-4
        self.lr_init = 0.0064
        self.lr_decay_rate = 1
        self.lr_decay_steps = 1000

        ### Replay Buffer
        self.replay_buffer_size = 5000
        self.num_unroll_steps = 7
        self.td_steps = 7
        self.PER = True
        self.PER_alpha = 0.5
        self.use_last_model_value = True

        ### Ratio
        self.self_play_delay = 0.2
        self.training_delay = 0
        self.ratio = None

        ### Accelerator knobs
        self.parallel_games = 32
        self.selfplay_chunk_moves = 6

    def visit_softmax_temperature_fn(self, trained_steps):
        """Reference games/simple_grid.py:115-128."""
        return 1


def make_env(seed=None, device=None):
    return SimpleGrid(device=device)
