"""spiel game module (port of muzero_general_tpu/games/spiel.py): any
OpenSpiel game (config parity with reference games/spiel.py:17-120, the
config derived from the loaded game object).
Requires pyspiel (see envs/host.py)."""

from muzero_general_tpu_torch import config as config_lib

GAME_NAME = "tic_tac_toe"  # reference games/spiel.py:23 default


def _load_game():
    from muzero_general_tpu_torch.envs.host import SpielGame

    return SpielGame(GAME_NAME)


class MuZeroConfig(config_lib.MuZeroConfig):
    def __init__(self):
        super().__init__()
        self.seed = 0

        # Derive the game group from the pyspiel object when available
        # (reference games/spiel.py:26-45); fall back to tic_tac_toe-like
        # defaults so the module imports without pyspiel.
        try:
            env = _load_game()
            self.observation_shape = env.observation_shape
            self.action_space = list(range(env.num_actions))
            self.players = list(range(env.num_players))
            self.max_moves = env.game.max_game_length()
        except ImportError:
            self.observation_shape = (3, 3, 3)
            self.action_space = list(range(9))
            self.players = list(range(2))
            self.max_moves = 9

        self.stacked_observations = 0
        self.muzero_player = 0
        self.opponent = "random"

        self.num_workers = 1
        self.num_simulations = 25
        self.discount = 1
        self.temperature_threshold = None
        self.root_dirichlet_alpha = 0.1
        self.root_exploration_fraction = 0.25

        self.network = "resnet"
        self.support_size = 10
        self.blocks = 1
        self.channels = 16
        self.reduced_channels_reward = 16
        self.reduced_channels_value = 16
        self.reduced_channels_policy = 16
        self.resnet_fc_reward_layers = [8]
        self.resnet_fc_value_layers = [8]
        self.resnet_fc_policy_layers = [8]

        self.training_steps = 100000
        self.batch_size = 64
        self.checkpoint_interval = 10
        self.value_loss_weight = 0.25
        self.optimizer = "Adam"
        self.weight_decay = 1e-4
        self.lr_init = 0.003
        self.lr_decay_rate = 1
        self.lr_decay_steps = 10000

        self.replay_buffer_size = 3000
        self.num_unroll_steps = 20
        self.td_steps = 20
        self.PER = True
        self.PER_alpha = 0.5
        self.use_last_model_value = True

        self.ratio = None
        self.parallel_games = 16
        self.selfplay_chunk_moves = 8

    def visit_softmax_temperature_fn(self, trained_steps):
        return 1


def make_env(seed=None, device=None):
    """The OpenSpiel game on the host (`device` is ignored)."""
    from muzero_general_tpu_torch.envs.host import SpielGame

    return SpielGame(GAME_NAME, seed=seed)
