"""Plain PyTorch reference of the residual MuZero network (muzero-general
models.py MuZeroResidualNetwork, with its DownSampleResnet), NCHW.

Functional over a dict of float32 tensors named as the network's state dict
(flax's layer names: `TorchConv_i`, `BatchNorm_i`, `TorchDense_i`), in
float32 with TF32 off. Nothing of the program is imported. Departures from
the published description, all shared with the program being judged: the
heads flatten their maps in (h, w, c) order, the action plane is action / A
appended as the last channel, and the hidden state is min-max normalised per
(sample, channel) over H, W with the small-scale rule (+1e-5 below 1e-5).

`precision` rounds the input and the weight of every convolution and dense
layer before the float32 product: "float32" (none), "tf32" (10 mantissa
bits, as TF32 tensor cores round them) or "fp8" (float8 e4m3 with one scale
a tensor). The lower ones are the controls that the comparison has to fail.
"""

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

BN_EPS = 1e-5


def round_tf32(x):
    """Round float32 to TF32's 10 mantissa bits (to nearest, ties away)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def round_fp8(x):
    """Round to float8 e4m3 with one scale per tensor (amax to 448)."""
    scale = x.abs().amax().clamp(min=1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


ROUNDING = {"float32": lambda x: x, "tf32": round_tf32, "fp8": round_fp8}


class FullFloat32:
    """TF32 off for cuDNN and cuBLAS while the reference computes."""

    def __enter__(self):
        self._prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self._prev


def hidden_hw(cfg):
    _, h, w = cfg["observation_shape"]
    if cfg["downsample"]:
        return math.ceil(h / 16), math.ceil(w / 16)
    return h, w


def stacked_channels(cfg):
    c = cfg["observation_shape"][0]
    n = cfg["stacked_observations"]
    return c * (n + 1) + n


def layer_specs(cfg):
    """[(name, kind, shape)] of every tensor of the network: kind "conv" or
    "dense" (a weight, drawn U(+-1/sqrt(fan_in))), "bias:<fan_in>", or a
    batch norm's "bn_weight", "bn_bias", "bn_mean", "bn_var"."""
    C = cfg["channels"]
    hh, ww = hidden_hw(cfg)
    bins = 2 * cfg["support_size"] + 1
    A = len(cfg["action_space"])
    specs = []

    def conv(name, c_in, c_out, k, bias):
        specs.append((f"{name}.weight", "conv", (c_out, c_in, k, k)))
        if bias:
            specs.append((f"{name}.bias", f"bias:{c_in * k * k}", (c_out,)))

    def bn(name, c):
        for leaf, kind in (("weight", "bn_weight"), ("bias", "bn_bias"),
                           ("running_mean", "bn_mean"), ("running_var", "bn_var")):
            specs.append((f"{name}.{leaf}", kind, (c,)))

    def block(name, c):
        conv(f"{name}.TorchConv_0", c, c, 3, False)
        bn(f"{name}.BatchNorm_0", c)
        conv(f"{name}.TorchConv_1", c, c, 3, False)
        bn(f"{name}.BatchNorm_1", c)

    def mlp(name, sizes):
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            specs.append((f"{name}.TorchDense_{i}.weight", "dense", (b, a)))
            specs.append((f"{name}.TorchDense_{i}.bias", f"bias:{a}", (b,)))

    rep = "representation_network"
    if cfg["downsample"] == "resnet":
        half = C // 2
        conv(f"{rep}.DownSampleResnet_0.TorchConv_0", stacked_channels(cfg), half, 3, False)
        conv(f"{rep}.DownSampleResnet_0.TorchConv_1", half, C, 3, False)
        for i in range(8):
            block(f"{rep}.DownSampleResnet_0.ResidualBlock_{i}", half if i < 2 else C)
    elif cfg["downsample"]:
        raise NotImplementedError(f"downsample {cfg['downsample']!r}")
    else:
        conv(f"{rep}.TorchConv_0", stacked_channels(cfg), C, 3, False)
        bn(f"{rep}.BatchNorm_0", C)
    for i in range(cfg["blocks"]):
        block(f"{rep}.ResidualBlock_{i}", C)
    dyn = "dynamics_network"
    conv(f"{dyn}.TorchConv_0", C + 1, C, 3, False)
    bn(f"{dyn}.BatchNorm_0", C)
    for i in range(cfg["blocks"]):
        block(f"{dyn}.ResidualBlock_{i}", C)
    rr = cfg["reduced_channels_reward"]
    conv(f"{dyn}.TorchConv_1", C, rr, 1, True)
    mlp(f"{dyn}.MLP_0", [rr * hh * ww, *cfg["resnet_fc_reward_layers"], bins])
    pred = "prediction_network"
    for i in range(cfg["blocks"]):
        block(f"{pred}.ResidualBlock_{i}", C)
    rv, rp = cfg["reduced_channels_value"], cfg["reduced_channels_policy"]
    conv(f"{pred}.TorchConv_0", C, rv, 1, True)
    conv(f"{pred}.TorchConv_1", C, rp, 1, True)
    mlp(f"{pred}.MLP_0", [rv * hh * ww, *cfg["resnet_fc_value_layers"], bins])
    mlp(f"{pred}.MLP_1", [rp * hh * ww, *cfg["resnet_fc_policy_layers"], A])
    return specs


def avg_pool(x):
    """3x3 average pool, stride 2, one cell of zero padding a side counted in
    the mean; the nine cells summed in window order, then divided by 9."""
    h, w = (x.shape[2] - 1) // 2 + 1, (x.shape[3] - 1) // 2 + 1
    x = F.pad(x, (1, 1, 1, 1))
    total = None
    for i in range(3):
        for j in range(3):
            cell = x[:, :, i:i + 2 * h - 1:2, j:j + 2 * w - 1:2]
            total = cell if total is None else total + cell
    return total / 9


def normalize_hidden(h):
    lo = torch.amin(h, dim=(-2, -1), keepdim=True)
    hi = torch.amax(h, dim=(-2, -1), keepdim=True)
    scale = hi - lo
    scale = torch.where(scale < 1e-5, scale + 1e-5, scale)
    return (h - lo) / scale


def flatten_hwc(x):
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def support_to_scalar(logits, support_size):
    """Softmax expectation over [-S, S], then the inverse of
    h(x) = sign(x)(sqrt(|x|+1)-1) + 0.001x."""
    probs = torch.softmax(logits, dim=-1)
    support = torch.arange(-support_size, support_size + 1, dtype=probs.dtype,
                           device=probs.device)
    x = torch.sum(probs * support, dim=-1)
    eps = 0.001
    return torch.sign(x) * (
        torch.square((torch.sqrt(1.0 + 4.0 * eps * (torch.abs(x) + 1.0 + eps)) - 1.0)
                     / (2.0 * eps)) - 1.0)


class ResNetReference:
    """The network over `params` (name -> float32 tensor). `train`: batch
    norms normalise with the batch's own biased statistics (and update
    nothing); else with the running ones. `checkpoint_blocks`: each residual
    block's activations are recomputed in the backward, to fit large
    batches."""

    def __init__(self, cfg, params, precision="float32", train=False,
                 checkpoint_blocks=False):
        self.cfg = cfg
        self.p = params
        self.q = ROUNDING[precision]
        self.train = train
        self.checkpoint_blocks = checkpoint_blocks
        self.A = len(cfg["action_space"])
        self.S = cfg["support_size"]

    def conv(self, x, name, stride=1, padding=None):
        w = self.p[f"{name}.weight"]
        pad = w.shape[-1] // 2 if padding is None else padding
        y = F.conv2d(self.q(x), self.q(w), None, stride, pad)
        b = self.p.get(f"{name}.bias")
        return y if b is None else y + b[:, None, None]

    def bn(self, x, name):
        g, b = self.p[f"{name}.weight"], self.p[f"{name}.bias"]
        if self.train:
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        else:
            mean, var = self.p[f"{name}.running_mean"], self.p[f"{name}.running_var"]
        scale = g / torch.sqrt(var + BN_EPS)
        return (x - mean[:, None, None]) * scale[:, None, None] + b[:, None, None]

    def dense(self, x, name):
        return F.linear(self.q(x), self.q(self.p[f"{name}.weight"]), self.p[f"{name}.bias"])

    def mlp(self, x, name):
        n = 0
        while f"{name}.TorchDense_{n}.weight" in self.p:
            n += 1
        for i in range(n):
            x = self.dense(x, f"{name}.TorchDense_{i}")
            if i < n - 1:
                x = F.elu(x)
        return x

    def _block(self, x, name):
        out = F.relu(self.bn(self.conv(x, f"{name}.TorchConv_0"), f"{name}.BatchNorm_0"))
        out = self.bn(self.conv(out, f"{name}.TorchConv_1"), f"{name}.BatchNorm_1")
        return F.relu(out + x)

    def block(self, x, name):
        if self.checkpoint_blocks and torch.is_grad_enabled():
            return checkpoint(self._block, x, name, use_reentrant=False)
        return self._block(x, name)

    def representation(self, obs):
        rep = "representation_network"
        if self.cfg["downsample"] == "resnet":
            ds = f"{rep}.DownSampleResnet_0"
            x = self.conv(obs, f"{ds}.TorchConv_0", stride=2, padding=1)
            for i in range(2):
                x = self.block(x, f"{ds}.ResidualBlock_{i}")
            x = self.conv(x, f"{ds}.TorchConv_1", stride=2, padding=1)
            for i in range(2, 5):
                x = self.block(x, f"{ds}.ResidualBlock_{i}")
            x = avg_pool(x)
            for i in range(5, 8):
                x = self.block(x, f"{ds}.ResidualBlock_{i}")
            x = avg_pool(x)
        else:
            x = F.relu(self.bn(self.conv(obs, f"{rep}.TorchConv_0"), f"{rep}.BatchNorm_0"))
        for i in range(self.cfg["blocks"]):
            x = self.block(x, f"{rep}.ResidualBlock_{i}")
        return normalize_hidden(x)

    def dynamics(self, hidden, action):
        dyn = "dynamics_network"
        b, _, h, w = hidden.shape
        plane = (action.to(hidden.dtype) / self.A)[:, None, None, None].expand(b, 1, h, w)
        x = torch.cat([hidden, plane], dim=1)
        x = F.relu(self.bn(self.conv(x, f"{dyn}.TorchConv_0"), f"{dyn}.BatchNorm_0"))
        for i in range(self.cfg["blocks"]):
            x = self.block(x, f"{dyn}.ResidualBlock_{i}")
        reward = self.mlp(flatten_hwc(self.conv(x, f"{dyn}.TorchConv_1")), f"{dyn}.MLP_0")
        return normalize_hidden(x), reward

    def prediction(self, hidden):
        pred = "prediction_network"
        x = hidden
        for i in range(self.cfg["blocks"]):
            x = self.block(x, f"{pred}.ResidualBlock_{i}")
        value = self.mlp(flatten_hwc(self.conv(x, f"{pred}.TorchConv_0")), f"{pred}.MLP_0")
        policy = self.mlp(flatten_hwc(self.conv(x, f"{pred}.TorchConv_1")), f"{pred}.MLP_1")
        return policy, value

    def initial_inference(self, obs):
        """(value logits, policy logits, hidden)."""
        hidden = self.representation(obs)
        policy, value = self.prediction(hidden)
        return value, policy, hidden

    def recurrent_inference(self, hidden, action):
        """(value logits, reward logits, policy logits, next hidden)."""
        nxt, reward = self.dynamics(hidden, action)
        policy, value = self.prediction(nxt)
        return value, reward, policy, nxt


def make_params(cfg, seed: int, device):
    """Seeded weights for every tensor of `layer_specs(cfg)`, made on
    `device` in one draw: U(-1, 1) for all weights and biases together,
    each slice scaled by 1/sqrt(its fan_in) (nn.Conv2d's and nn.Linear's
    default init); batch norms at identity with zero mean and unit variance."""
    specs = layer_specs(cfg)
    drawn = [(name, kind, shape) for name, kind, shape in specs
             if kind in ("conv", "dense") or kind.startswith("bias:")]
    total = sum(math.prod(shape) for _, _, shape in drawn)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    params, offset = {}, 0
    for name, kind, shape in specs:
        if kind in ("conv", "dense") or kind.startswith("bias:"):
            n = math.prod(shape)
            if kind.startswith("bias:"):
                fan_in = int(kind.split(":")[1])
            else:
                fan_in = math.prod(shape[1:])
            params[name] = flat[offset:offset + n].view(shape) / math.sqrt(fan_in)
            offset += n
        else:
            fill = 1.0 if kind in ("bn_weight", "bn_var") else 0.0
            params[name] = torch.full(shape, fill, device=device)
    return params
