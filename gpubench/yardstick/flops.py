"""FLOPs of the residual MuZero network, counted from a configuration's
shapes: 2 per multiply-add of every convolution and dense layer (batch
norms, ReLUs, pools and the hidden normalization are left out). The counts
follow the network's published structure (muzero-general models.py
MuZeroResidualNetwork), not any code of the program."""

from gpubench.reference.resnet import hidden_hw, stacked_channels


def conv_flops(c_in, c_out, k, h_out, w_out):
    return 2 * c_in * c_out * k * k * h_out * w_out


def mlp_flops(sizes):
    return sum(2 * a * b for a, b in zip(sizes[:-1], sizes[1:]))


def _strided(n):
    """Output size of a 3x3, stride 2, pad 1 conv or pool."""
    return (n - 1) // 2 + 1


def _tower(channels, blocks, h, w):
    return blocks * 2 * conv_flops(channels, channels, 3, h, w)


def representation_flops(cfg):
    c_in, C = stacked_channels(cfg), cfg["channels"]
    _, h, w = cfg["observation_shape"]
    if cfg["downsample"] == "resnet":
        half = C // 2
        h1, w1 = _strided(h), _strided(w)
        h2, w2 = _strided(h1), _strided(w1)
        h3, w3 = _strided(h2), _strided(w2)  # after the first average pool
        flops = (conv_flops(c_in, half, 3, h1, w1) + _tower(half, 2, h1, w1)
                 + conv_flops(half, C, 3, h2, w2) + _tower(C, 3, h2, w2)
                 + _tower(C, 3, h3, w3))
    elif cfg["downsample"]:
        raise NotImplementedError(f"downsample {cfg['downsample']!r} is not counted")
    else:
        flops = conv_flops(c_in, C, 3, h, w)
    hh, ww = hidden_hw(cfg)
    return flops + _tower(C, cfg["blocks"], hh, ww)


def prediction_flops(cfg):
    C, hh, ww = cfg["channels"], *hidden_hw(cfg)
    rv, rp = cfg["reduced_channels_value"], cfg["reduced_channels_policy"]
    bins = 2 * cfg["support_size"] + 1
    A = len(cfg["action_space"])
    return (_tower(C, cfg["blocks"], hh, ww)
            + conv_flops(C, rv, 1, hh, ww) + conv_flops(C, rp, 1, hh, ww)
            + mlp_flops([rv * hh * ww, *cfg["resnet_fc_value_layers"], bins])
            + mlp_flops([rp * hh * ww, *cfg["resnet_fc_policy_layers"], A]))


def dynamics_flops(cfg):
    C, hh, ww = cfg["channels"], *hidden_hw(cfg)
    rr = cfg["reduced_channels_reward"]
    bins = 2 * cfg["support_size"] + 1
    return (conv_flops(C + 1, C, 3, hh, ww) + _tower(C, cfg["blocks"], hh, ww)
            + conv_flops(C, rr, 1, hh, ww)
            + mlp_flops([rr * hh * ww, *cfg["resnet_fc_reward_layers"], bins]))


def initial_inference_flops(cfg):
    """One sample's initial inference: representation and prediction."""
    return representation_flops(cfg) + prediction_flops(cfg)


def recurrent_inference_flops(cfg):
    """One sample's recurrent inference: dynamics and prediction."""
    return dynamics_flops(cfg) + prediction_flops(cfg)


def selfplay_move_flops(cfg, lanes, simulations):
    """The network FLOPs of one self-play move of every lane: one initial
    inference a lane and one recurrent inference a lane a simulation."""
    return lanes * (initial_inference_flops(cfg) + simulations * recurrent_inference_flops(cfg))


def train_step_flops(cfg, batch):
    """The forward and backward FLOPs of one unrolled loss at `batch` rows:
    the backward counted as twice the forward, the learner's recomputation
    of its checkpointed unroll steps not counted."""
    forward = initial_inference_flops(cfg) + cfg["num_unroll_steps"] * recurrent_inference_flops(cfg)
    return 3 * batch * forward
