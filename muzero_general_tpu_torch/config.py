"""MuZero configuration (port of muzero_general_tpu/config.py).

Same attribute schema as the JAX package (reference games/cartpole.py:11-128,
~40 attributes in 7 groups) so JSON/dict overrides written for either package
apply to both; unknown keys raise AttributeError. The JAX package's
accelerator knobs are all accepted; each carries a note on whether the port
reads it.
"""

import datetime
import importlib
import pathlib


class MuZeroConfig:
    """Base config; per-game modules subclass and override values."""

    def __init__(self):
        self.seed = 0
        self.max_num_gpus = None  # kept for override parity; unused

        ### Game
        self.observation_shape = (1, 1, 4)  # (channels, height, width)
        self.action_space = list(range(2))
        self.players = list(range(1))
        self.stacked_observations = 0

        # Evaluate
        self.muzero_player = 0
        self.opponent = None  # None | "random" | "expert" | "human" | "self"

        ### Self-Play
        self.num_workers = 1  # reference parity; the port uses parallel_games
        self.selfplay_on_gpu = False  # reference parity; unused
        self.max_moves = 500
        self.num_simulations = 50
        self.discount = 0.997
        self.temperature_threshold = None

        # Root prior exploration noise
        self.root_dirichlet_alpha = 0.25
        self.root_exploration_fraction = 0.25

        # UCB formula
        self.pb_c_base = 19652
        self.pb_c_init = 1.25

        ### Network
        self.network = "fullyconnected"  # "resnet" / "fullyconnected"
        self.support_size = 10

        # Residual network (models/resnet.py)
        self.downsample = False  # False | "resnet" | "CNN"
        self.blocks = 1
        self.channels = 2
        self.reduced_channels_reward = 2
        self.reduced_channels_value = 2
        self.reduced_channels_policy = 2
        self.resnet_fc_reward_layers = []
        self.resnet_fc_value_layers = []
        self.resnet_fc_policy_layers = []

        # Fully connected network
        self.encoding_size = 8
        self.fc_representation_layers = []
        self.fc_dynamics_layers = [16]
        self.fc_reward_layers = [16]
        self.fc_value_layers = [16]
        self.fc_policy_layers = [16]

        ### Training
        self.results_path = None
        self.save_model = True
        self.training_steps = 10000
        self.batch_size = 128
        self.checkpoint_interval = 10
        self.value_loss_weight = 1
        self.train_on_gpu = False  # reference parity; unused

        self.optimizer = "Adam"  # "Adam" or "SGD"
        self.weight_decay = 1e-4
        self.momentum = 0.9

        self.lr_init = 0.02
        self.lr_decay_rate = 0.8
        self.lr_decay_steps = 1000

        ### Replay buffer
        self.replay_buffer_size = 500
        self.num_unroll_steps = 10
        self.td_steps = 50
        self.PER = True
        self.PER_alpha = 0.5

        # Reanalyze
        self.use_last_model_value = True
        self.reanalyse_on_gpu = False  # reference parity; unused

        ### Self-play / training ratio: the delays are unused, as in JAX; the
        # training loop enforces `ratio` (a number or a callable of the
        # played games) exactly (muzero.py).
        self.self_play_delay = 0
        self.training_delay = 0
        self.ratio = 1.5

        ### Accelerator knobs of the JAX package (no reference counterpart)
        # Used: games advanced in lockstep by SelfPlayDriver.
        self.parallel_games = 16
        # Used: moves per SelfPlayDriver.play call.
        self.selfplay_chunk_moves = 8
        # Used: loops between evaluation games against a scripted opponent.
        self.eval_interval_loops = 4
        # Used: the dp x mp mesh of MuZero.train (parallel/mesh.py
        # mesh_shape): mesh_dp None gives every device of the group or
        # fleet that mp leaves to dp; above one device, train() runs one
        # rank per device.
        self.mesh_dp = None
        self.mesh_mp = 1
        # Used: the networks' compute dtype, read as the JAX package reads
        # it: "bfloat16" computes every conv and dense layer in bfloat16
        # with float32 accumulation, anything else in float32
        # (models/network.py compute_dtype). Parameters stay float32.
        self.compute_dtype = "float32"
        # Used: the training loop's reanalyse sweeps (muzero.py).
        self.reanalyse_interval = 20
        self.reanalyse_games_per_interval = 32
        self.reanalyse_chunk_positions = 1024
        # Used: a torch.profiler trace of training loops 20-24, exported to
        # this directory.
        self.profile_dir = None
        # Used: M > 1 trains M steps a call (Learner.train_steps); the
        # prefetcher assembles batches on a thread.
        self.fused_train_steps = 8
        self.batch_prefetch = True
        # Used: the staged search's descend/backprop CUDA kernels
        # (ops/mcts_kernels.py) where the tree fits the JAX package's planar
        # kernels; "auto" engages them on a CUDA device, True also on the CPU
        # (through their plain versions), False runs the plain-op route.
        self.use_pallas_mcts = "auto"
        # Used: the fused single-kernel search (ops/mcts_fused.py) for FC
        # networks: "auto" and True run it (on CPU tensors through its plain
        # version), False runs the staged search (ops/mcts.py run_mcts).
        self.use_fused_search = "auto"
        # Accepted, unused: the port's kernel always computes in float32
        # (what "highest" means on the TPU).
        self.fused_net_precision = "highest"
        # Used: the streaming search's CUDA kernels (ops/mcts_stream.py)
        # for trees the planar kernels cannot take, at 8 lanes or more (as
        # in the JAX package); "auto" engages them on a CUDA device, True
        # also on the CPU (through their plain versions) when
        # use_pallas_mcts resolves too.
        self.use_stream_mcts = "auto"
        # Used: K > 1 runs the staged search in multi-leaf rounds of K leaves
        # (ops/mcts.py); it must divide num_simulations. FC nets on the fused
        # search ignore it, as in the JAX package.
        self.search_batch_leaves = 1
        # Used: self-play folds a ResNet's batch norms into its convs once
        # per play_chunk (models/network.py fold_bn).
        self.fold_bn_inference = True
        # Used: True runs the folded ResNet's conv pipeline, hidden
        # normalization and the search's hidden store in bfloat16 (the
        # heads still emit float32), as in the JAX package; only with
        # fold_bn_inference (models/network.py activation_dtype).
        self.search_bf16_activations = False
        # Used: True runs the Gumbel search (ops/gumbel.py) in self-play and
        # evaluation, with these three knobs.
        self.use_gumbel_mcts = False
        self.gumbel_max_considered_actions = 16
        self.gumbel_c_visit = 50.0
        self.gumbel_c_scale = 1.0
        # Used: the host-env driver (hostplay.py) splits its lanes in two
        # halves and searches one on the device while the host steps the
        # other's envs.
        self.host_pipeline = False
        # Used: with fused_train_steps > 1, MuZero.train keeps the replay
        # ring, sampling and priority write-backs on the device
        # (ops/device_replay.py), where the JAX package engages it.
        self.device_replay = False
        # Used: numbered checkpoint snapshots every this many steps.
        self.snapshot_interval = None
        # Used: the learner rematerializes each unroll step.
        self.remat_unroll = True

    def visit_softmax_temperature_fn(self, trained_steps):
        """Temperature schedule (reference games/cartpole.py:115-128)."""
        if trained_steps < 0.5 * self.training_steps:
            return 1.0
        elif trained_steps < 0.75 * self.training_steps:
            return 0.5
        else:
            return 0.25

    # Convenience derived quantities -------------------------------------
    @property
    def action_space_size(self) -> int:
        return len(self.action_space)

    @property
    def num_players(self) -> int:
        return len(self.players)

    @property
    def full_support_size(self) -> int:
        return 2 * self.support_size + 1

    def default_results_path(self, game_name: str) -> pathlib.Path:
        return (
            pathlib.Path(__file__).resolve().parents[1]
            / "results"
            / game_name
            / datetime.datetime.now().strftime("%Y-%m-%d--%H-%M-%S")
        )


def load_game_module(game_name: str):
    """Import `muzero_general_tpu_torch.games.<game_name>`."""
    return importlib.import_module("muzero_general_tpu_torch.games." + game_name)


def apply_overrides(config: MuZeroConfig, overrides: dict) -> MuZeroConfig:
    """Apply a dict of attribute overrides; unknown keys raise AttributeError."""
    for key, value in overrides.items():
        if not hasattr(config, key):
            raise AttributeError(
                f'Config has no attribute "{key}". Check the config file for the complete list.'
            )
        setattr(config, key, value)
    return config
