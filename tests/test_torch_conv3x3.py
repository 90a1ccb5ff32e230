"""The folded ResNet's fused float32 3x3 conv (ops/conv3x3.py, csrc/conv3x3.cu).

On the CPU: the plain route against a float64 composition of the conv, the
bias, the skip and ReLU; the routing rule as a pure predicate and on the
modules (only a folded float32 3x3, stride 1, pad 1 conv off the mesh, at a
shape and batch where the kernel beat cuDNN, takes the kernel's route); the
folded twin through the new op still the unfolded network's function in
eval mode; the weight layout.

On the card (`gpu` marker; skips without one): the kernel against a float64
conv at every folded ResNet game's shapes, each output within the float32
worst-case bound of its sum, and the `conv3x3` counter on connect4's
search at K = 1 and K = 8 (every folded 3x3 conv on the kernel), on atari's
bfloat16 twin and on the unfolded network (none on the kernel).

The file imports no JAX, so the card tests run where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_conv3x3.py
"""

import pytest
import torch
import torch.nn.functional as F

from muzero_general_tpu_torch import tracing
from muzero_general_tpu_torch.games import atari, connect4, tictactoe, twentyone
from muzero_general_tpu_torch.models import MuZeroNetwork, fold_bn
from muzero_general_tpu_torch.models.common import Conv, conv, conv3x3
from muzero_general_tpu_torch.ops import conv3x3 as op
from muzero_general_tpu_torch.tools import profiling

F32, BF16 = torch.float32, torch.bfloat16


def _inputs(n, cin, cout, h, w, seed, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    bound = (9 * cin) ** -0.5
    x = torch.randn((n, cin, h, w), generator=gen)
    wt = (torch.rand((cout, cin, 3, 3), generator=gen) * 2 - 1) * bound
    b = (torch.rand((cout,), generator=gen) * 2 - 1) * bound
    skip = torch.randn((n, cout, h, w), generator=gen)
    return tuple(t.to(device) for t in (x, wt, b, skip))


def _reference(x, wt, b, skip):
    """The float64 composition: conv, bias, skip, ReLU."""
    y = F.conv2d(x.double(), wt.double(), None, 1, 1) + b.double()[:, None, None]
    if skip is not None:
        y = y + skip.double()
    return torch.relu(y)


def _sites():
    totals = tracing.counters()
    return {site: totals.get(f"conv3x3:{site}", 0) for site in ("kernel", "plain", "library")}


def _delta(before):
    return {site: n - before[site] for site, n in _sites().items()}


# ---- CPU --------------------------------------------------------------------

@pytest.mark.parametrize("cin,cout,h,w,skip", [
    (64, 64, 6, 7, True), (65, 64, 6, 7, False), (3, 64, 6, 7, False),
    (16, 16, 3, 3, True), (128, 128, 11, 11, True), (8, 8, 13, 11, False),
])
def test_plain_route_matches_the_float64_composition(cin, cout, h, w, skip):
    x, wt, b, s = _inputs(5, cin, cout, h, w, seed=cin + h)
    s = s if skip else None
    got = op.conv3x3(x, wt, b, s)
    assert got.dtype == F32 and got.shape == (5, cout, h, w)
    ref = _reference(x, wt, b, s)
    assert float((got.double() - ref).abs().max()) < 2e-5 * float(ref.abs().max())
    # The plain version is nn.Conv2d's own conv with the bias, then the skip
    # and ReLU: the folded twin's library path, bit for bit on the CPU.
    y = F.conv2d(x, wt, b, 1, 1)
    assert torch.equal(got, F.relu(y if s is None else y + s))
    assert (got >= 0).all()


_BASE = dict(x_dtype=F32, compute_dtype=F32, out_dtype=F32, kernel_size=(3, 3),
             stride=(1, 1), padding=(1, 1), mp_group=None, shape=(1024, 64, 64, 6, 7))


def _takes(n, cin, cout, h, w):
    """The rule at a shape, for a folded float32 3x3 stride-1 conv."""
    return op.takes_kernel(**{**_BASE, "shape": (n, cin, cout, h, w)})


@pytest.mark.parametrize("change,takes", [
    ({}, True),
    ({"shape": (2048, 65, 64, 6, 7)}, True),
    ({"shape": (1024, 3, 64, 6, 7)}, True),
    ({"shape": (512, 64, 64, 6, 7)}, True),
    ({"shape": (64, 3, 64, 6, 7)}, True),
    ({"shape": None}, True),
    ({"x_dtype": torch.float16}, False),
    ({"x_dtype": BF16}, False),
    ({"compute_dtype": BF16}, False),
    ({"out_dtype": BF16}, False),
    ({"x_dtype": torch.float64}, False),
    ({"kernel_size": (1, 1), "padding": (0, 0)}, False),
    ({"kernel_size": (5, 5), "padding": (2, 2)}, False),
    ({"stride": (2, 2)}, False),
    ({"padding": (0, 0)}, False),
    ({"mp_group": object()}, False),
    ({"shape": (1024, 64, 60, 6, 7)}, False),  # unmeasured shapes
    ({"shape": (1024, 64, 64, 6, 400)}, False),
    ({"shape": (256, 64, 64, 6, 7)}, False),  # below the batch where it beat cuDNN
    ({"shape": (512, 128, 128, 11, 11)}, False),  # gomoku: cuDNN was faster
    ({"shape": (1024, 16, 16, 3, 3)}, False),  # tictactoe
])
def test_routing_rule_is_a_pure_predicate(change, takes):
    assert op.takes_kernel(**{**_BASE, **change}) is takes


@pytest.mark.parametrize("n,cin,cout,h,w,takes", [
    (512, 64, 64, 6, 7, True), (511, 64, 64, 6, 7, False), (2048, 65, 64, 6, 7, True),
    (64, 3, 64, 6, 7, True), (63, 3, 64, 6, 7, False), (64, 3, 128, 11, 11, True),
    (4096, 128, 128, 11, 11, False), (1024, 32, 32, 3, 3, False),
    (8, 16, 16, 6, 6, False), (1024, 64, 64, 7, 6, False),
])
def test_only_measured_shapes_and_batches_take_the_kernel(n, cin, cout, h, w, takes):
    """KERNEL_SHAPES: the shapes and batches where the kernel beat cuDNN on
    the card; an unmeasured shape keeps the library."""
    assert _takes(n, cin, cout, h, w) is takes


def test_packed_weight_layout():
    wt = torch.randn(8, 5, 3, 3)
    packed = op.pack_weight(wt)
    assert packed.shape == (5, 9, 8) and packed.is_contiguous()
    for co, ci, dy, dx in ((0, 0, 0, 0), (7, 4, 2, 1), (3, 2, 1, 2)):
        assert packed[ci, 3 * dy + dx, co] == wt[co, ci, dy, dx]


def test_the_wrapper_refuses_other_devices():
    x, wt, b, _ = _inputs(1, 4, 8, 3, 3, seed=0)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        op.conv3x3(x.to("meta"), wt, b)


def _tcfg(game, **overrides):
    cfg = game.MuZeroConfig()
    for key, value in overrides.items():
        setattr(cfg, key, value)
    return cfg


@pytest.mark.parametrize("game", [connect4, tictactoe, twentyone])
def test_fold_packs_only_the_kernels_convs(game):
    """fold_bn packs every folded float32 3x3 stride-1 conv once (no
    repacking a call); the unfolded network and a bfloat16 twin pack none;
    the state dict keeps PyTorch's [Cout, Cin, 3, 3] and no packed copy."""
    net = MuZeroNetwork(_tcfg(game), device="cpu", seed=0)
    folded = fold_bn(net)
    convs = [m for m in folded.modules() if isinstance(m, Conv)]
    packed = [m for m in convs if m.packed_weight is not None]
    assert packed and all(m.kernel_size == (3, 3) and m.stride == (1, 1) for m in packed)
    assert all(m.kernel_size != (3, 3) for m in convs if m.packed_weight is None)
    assert all(torch.equal(m.packed_weight, op.pack_weight(m.weight)) for m in packed)
    assert not any("packed" in k for k in folded.state_dict())
    assert all(m.packed_weight is None for m in net.modules() if isinstance(m, Conv))
    bf16 = fold_bn(MuZeroNetwork(_tcfg(game, compute_dtype="bfloat16"), device="cpu", seed=0))
    assert all(m.packed_weight is None for m in bf16.modules() if isinstance(m, Conv))


def test_module_routes_follow_the_rule():
    """On the modules: a folded float32 3x3 takes the kernel's route (its
    plain version here); a strided or 1x1 conv, a bfloat16 one, one on the
    mesh, or the same conv at a batch where cuDNN won keeps PyTorch's conv,
    with the same result as before."""
    x = torch.randn(512, 64, 6, 7)  # connect4's tower at a batch the kernel takes
    skip = torch.randn(512, 64, 6, 7)
    layers = {
        "kernel": conv3x3(64, 64, bias=True),
        "stride2": conv(64, 64, 3, True, stride=2, padding=1),
        "one_by_one": conv(64, 64, 1, True),
        "bf16": conv3x3(64, 64, bias=True, dtype=BF16),
        "mesh": conv3x3(64, 64, bias=True),
    }
    layers["mesh"].mp_group = object()
    for layer in layers.values():
        layer.pack()
    assert layers["kernel"].packed_weight is not None
    for name in ("stride2", "one_by_one", "bf16", "mesh"):
        assert layers[name].packed_weight is None, name
    layers.pop("mesh")  # a forward on the mesh needs its process group
    with torch.no_grad():
        for name, layer in layers.items():
            use_skip = layer.stride == (1, 1)
            before = _sites()
            got = layer.conv_relu(x, skip if use_skip else None)
            want = layer(x)
            want = F.relu(want + skip if use_skip else want)
            torch.testing.assert_close(got, want, rtol=0, atol=0, msg=name)
            site = "plain" if name == "kernel" else "library"
            assert _delta(before) == {**dict.fromkeys(("kernel", "plain", "library"), 0),
                                      site: 1}, name
        before = _sites()  # a batch where cuDNN beat the kernel
        got = layers["kernel"].conv_relu(x[:256], skip[:256])
        torch.testing.assert_close(got, F.relu(layers["kernel"](x[:256]) + skip[:256]),
                                   rtol=0, atol=0)
        assert _delta(before) == {"kernel": 0, "plain": 0, "library": 1}


@pytest.mark.parametrize("game,batch", [(connect4, 5), (tictactoe, 3), (twentyone, 4)])
def test_folded_twin_through_the_op_is_the_unfolded_network(game, batch, monkeypatch):
    """As test_torch_resnet.py holds the fold: with random batch-norm
    statistics, the folded twin, whose 3x3 convs now run the fused op, keeps
    the unfolded network's function in eval mode; every folded 3x3 conv of
    an initial and a recurrent inference goes through the op (the rule
    widened to every shape, so that test_torch_resnet.py's batches and
    tolerance apply; at the real rule these batches keep PyTorch's conv)."""
    cfg = _tcfg(game)
    net = MuZeroNetwork(cfg, device="cpu", seed=1)
    gen = torch.Generator().manual_seed(2)
    for m in net.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.weight.data.uniform_(0.5, 1.5, generator=gen)
            m.bias.data.normal_(0, 0.2, generator=gen)
            m.running_mean.normal_(0, 0.2, generator=gen)
            m.running_var.uniform_(0.5, 1.5, generator=gen)
    folded = fold_bn(net)
    obs = (torch.rand((batch,) + profiling.stacked_shape(cfg), generator=gen) < 0.4).float()
    c, hw = cfg.channels, cfg.observation_shape[1:]
    plain = (_takes(batch, obs.shape[1], c, *hw) + 4 * cfg.blocks * _takes(batch, c, c, *hw))
    with torch.no_grad():
        before = _sites()
        library = folded.initial_inference(obs)
    assert _delta(before) == {"kernel": 0, "plain": plain, "library": 1 + 4 * cfg.blocks - plain}
    widened = {(cin, c, *hw): 1 for cin in (obs.shape[1], c, c + 1)}
    monkeypatch.setattr(op, "KERNEL_SHAPES", widened)
    folded = fold_bn(net)  # fresh route caches
    action = torch.randint(0, len(cfg.action_space), (batch,), generator=gen)
    convs_3x3 = 1 + 2 * 2 * cfg.blocks  # representation's, two towers of blocks
    with torch.no_grad():
        before = _sites()
        got = folded.initial_inference(obs)
        assert _delta(before) == {"kernel": 0, "plain": convs_3x3, "library": 0}
        want = net.initial_inference(obs)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=5e-5, rtol=0)
        before = _sites()
        got = folded.recurrent_inference(want[3], action)
        assert _delta(before) == {"kernel": 0, "plain": convs_3x3, "library": 0}
        for g, w in zip(got, net.recurrent_inference(want[3], action)):
            torch.testing.assert_close(g, w, atol=5e-5, rtol=0)
        for g, w in zip(folded.initial_inference(obs), library):
            assert torch.equal(g, w)  # the plain route is the library path's arithmetic


# ---- the card -----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# (N, Cin, Cout, H, W) of every folded ResNet game's 3x3 convs (the tower's,
# the dynamics conv's with the action plane, the representation's first), at
# the search's batches and at odd ones (a partial group of 8 samples).
CARD_SHAPES = [
    (n, cin, 64, 6, 7) for n in (1, 7, 1024, 2048) for cin in (3, 64, 65)
] + [
    (64, 128, 128, 11, 11), (64, 129, 128, 11, 11), (13, 3, 128, 11, 11),  # gomoku
    (64, 16, 16, 3, 3), (64, 17, 16, 3, 3), (9, 3, 16, 3, 3),  # tictactoe, spiel
    (64, 32, 32, 3, 3), (64, 33, 32, 3, 3), (5, 3, 32, 3, 3),  # twentyone
    (8, 8, 8, 48, 48), (8, 16, 16, 24, 24), (8, 16, 16, 12, 12), (8, 16, 16, 6, 6),
    (8, 17, 16, 6, 6),  # breakout: the downsampler's blocks, the tower, the dynamics conv
]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("skip", [False, True], ids=["no_skip", "skip"])
def test_kernel_is_within_float32s_bound_of_float64(cuda, shape, skip):
    """Every output within the worst-case bound of a float32 sum of its
    terms, gamma_n * sum |term| (n = 9 Cin products, the bias and the
    skip; u = 2^-24), elementwise: any float32 order of the sum meets it,
    and a wrong tap, channel or sample does not. cuDNN's float32 error is
    measured beside it (tools/conv3x3_cost.py prints both): its FFTs read
    4-5x lower than a 576-term sequential sum at connect4's batches. A
    shape whose Cout is not a multiple of the kernel's 32-channel tile
    (tictactoe's, breakout's) has no launch plan: the kernel refuses it and
    the routing rule keeps it on cuDNN."""
    n, cin, cout, h, w = shape
    if skip and cin != cout:
        pytest.skip("a skip add only follows a conv whose input is its output's shape")
    x, wt, b, s = _inputs(n, cin, cout, h, w, seed=n + cin, device=cuda)
    s = s if skip else None
    before = op.conv3x3.launches
    if cout % 32:
        assert not _takes(n, cin, cout, h, w)
        with pytest.raises(RuntimeError, match="conv3x3_forward failed"):
            op.conv3x3(x, wt, b, s, op.pack_weight(wt))
        assert op.conv3x3.launches == before
        return
    got = op.conv3x3(x, wt, b, s, op.pack_weight(wt))
    torch.cuda.synchronize()
    assert op.conv3x3.launches == before + 1
    ref = _reference(x, wt, b, s)
    terms = (F.conv2d(x.double().abs(), wt.double().abs(), None, 1, 1)
             + b.double().abs()[:, None, None])
    if s is not None:
        terms = terms + s.double().abs()
    u = 2.0 ** -24
    k = 9 * cin + 2
    bound = k * u / (1 - k * u) * terms
    assert torch.isfinite(got).all()
    assert ((got.double() - ref).abs() <= bound).all()
    assert float((got.double() - ref).abs().max()) < 1e-5 * float(ref.abs().max())


@pytest.mark.gpu
def test_kernel_refuses_a_shape_it_has_no_plan_for(cuda):
    x, wt, b, _ = _inputs(2, 8, 48, 3, 3, seed=0, device=cuda)  # Cout not a multiple of 32
    before = op.conv3x3.launches
    with pytest.raises(RuntimeError, match="conv3x3_forward failed"):
        op.conv3x3(x, wt, b, None, op.pack_weight(wt))
    assert op.conv3x3.launches == before
    with pytest.raises(ValueError, match="packed"):
        op.conv3x3(x, wt, b, None, None)


@pytest.mark.gpu
@pytest.mark.parametrize("leaves,lanes", [(1, 1024), (8, 256)])
def test_connect4s_search_takes_the_kernel_at_the_cells_batches(cuda, leaves, lanes):
    """The benchmark cells' searches: at K = 1 (1,024 lanes) every folded 3x3
    conv runs the kernel; at K = 8 (256 lanes) every conv of the recurrent
    inferences (2,048 leaves) and the representation's first conv do, and
    the initial inference's 12 tower convs at 256 samples keep cuDNN (faster
    there)."""
    from muzero_general_tpu_torch.ops import mcts as mcts_ops

    cfg = _tcfg(connect4, num_simulations=16, search_batch_leaves=leaves)
    net = fold_bn(MuZeroNetwork(cfg, cuda, seed=0))
    obs = torch.zeros((lanes,) + profiling.stacked_shape(cfg), device=cuda)
    legal = torch.ones((lanes, len(cfg.action_space)), dtype=torch.bool, device=cuda)
    to_play = torch.zeros((lanes,), dtype=torch.int32, device=cuda)
    spec = mcts_ops.SearchSpec.from_config(cfg, batch_size=lanes, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    before, launches = _sites(), op.conv3x3.launches
    with torch.no_grad():
        mcts_ops.run_mcts(net.initial_inference, net.recurrent_inference, obs, legal, to_play,
                          gen, spec)
    torch.cuda.synchronize()
    rounds = cfg.num_simulations // leaves
    tower_on_library = 0 if leaves == 1 else 12
    want = {"kernel": 13 * (1 + rounds) - tower_on_library, "plain": 0,
            "library": tower_on_library}
    assert _delta(before) == want
    assert op.conv3x3.launches - launches == want["kernel"]


@pytest.mark.gpu
def test_atari_bf16_twin_and_the_unfolded_network_never_take_the_kernel(cuda):
    cfg = _tcfg(atari)
    assert cfg.compute_dtype == "bfloat16"
    net = MuZeroNetwork(cfg, cuda, seed=0)
    obs = torch.rand((2,) + profiling.stacked_shape(cfg), device=cuda)
    before, launches = _sites(), op.conv3x3.launches
    with torch.no_grad():
        fold_bn(net).initial_inference(obs)
        got = _delta(before)
        assert got["kernel"] == got["plain"] == 0 and got["library"] > 0
        c4 = MuZeroNetwork(_tcfg(connect4), cuda, seed=0)
        before = _sites()
        value, _, _, hidden = c4.initial_inference(torch.rand(4, 3, 6, 7, device=cuda))
        c4.recurrent_inference(hidden, torch.zeros(4, dtype=torch.long, device=cuda))
    assert _delta(before) == {"kernel": 0, "plain": 0, "library": 0}
    assert op.conv3x3.launches == launches
