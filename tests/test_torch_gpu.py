"""The fused-search CUDA kernel against its plain PyTorch version, on the card.

Every test here carries the `gpu` marker and skips without a CUDA card. The
file imports no JAX, so it also runs where JAX is absent; there the suite's
conftest (which imports JAX) is left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Kernel and plain version get the same card tensors and run the same float32
operations in the same order, with the same Philox tie jitter when it is on,
so visit counts and depth must be equal and root values agree to 1e-5.
"""

import pytest
import torch

from muzero_general_tpu_torch.config import MuZeroConfig as BaseConfig
from muzero_general_tpu_torch.games.cartpole import MuZeroConfig, make_env
from muzero_general_tpu_torch.models import MuZeroNetwork
from muzero_general_tpu_torch.ops import mcts_fused
from muzero_general_tpu_torch.selfplay import SelfPlayDriver

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(cfg, B, num_players, noise, seed, dev):
    net = MuZeroNetwork(cfg, device=dev, seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    A = len(cfg.action_space)
    obs = torch.randn((B,) + tuple(cfg.observation_shape), generator=gen, device=dev)
    legal = torch.rand((B, A), generator=gen, device=dev) < 0.7
    legal[:, 0] = True
    to_play = (torch.arange(B, device=dev) % num_players).to(torch.int32)
    spec = mcts_fused.FusedSpec.from_config(cfg, deterministic_tie_break=True)
    with torch.no_grad():
        root = mcts_fused.prepare_root(net, obs, legal, to_play, gen, spec, noise)
    weights = mcts_fused.fused_weights(net, cfg.encoding_size)
    args = (root.prior, root.hidden, root.reward, root.to_play, root.legal, weights)
    return args, mcts_fused.search_kwargs(spec), legal


def _check_equal(args, kw, legal, sims):
    before = mcts_fused.search.launches
    visits, value, depth = mcts_fused.search(*args, **kw)
    p_visits, p_value, p_depth = mcts_fused.search_plain(*args, **kw)
    torch.cuda.synchronize()
    assert mcts_fused.search.launches == before + 1
    assert torch.equal(visits, p_visits)
    assert torch.equal(depth, p_depth)
    torch.testing.assert_close(value, p_value, rtol=0, atol=1e-5)
    assert bool((visits.sum(1) == sims).all())
    assert not bool(visits[~legal].any())


@pytest.mark.parametrize("num_players", [1, 2])
@pytest.mark.parametrize("noise", [False, True])
def test_kernel_matches_plain_cartpole_shapes(cuda, num_players, noise):
    cfg = MuZeroConfig()
    cfg.players = list(range(num_players))
    args, kw, legal = _inputs(cfg, 64, num_players, noise, 0, cuda)
    _check_equal(args, kw, legal, cfg.num_simulations)


def test_kernel_deeper_dynamics_mlp(cuda):
    cfg = MuZeroConfig()
    cfg.num_simulations = 12
    cfg.encoding_size = 6
    cfg.fc_dynamics_layers = [16, 12]
    cfg.fc_reward_layers = []
    cfg.fc_value_layers = [8]
    cfg.fc_policy_layers = [8]
    args, kw, legal = _inputs(cfg, 40, 1, True, 1, cuda)
    _check_equal(args, kw, legal, cfg.num_simulations)


@pytest.mark.parametrize("tie_jitter", [0.0, 1e-5])
def test_kernel_lunarlander_widths(cuda, tie_jitter):
    cfg = BaseConfig()
    cfg.observation_shape = (1, 1, 8)
    cfg.action_space = list(range(4))
    cfg.encoding_size = 10
    cfg.fc_dynamics_layers = cfg.fc_reward_layers = [64]
    cfg.fc_value_layers = cfg.fc_policy_layers = [64]
    args, kw, legal = _inputs(cfg, 37, 1, True, 2, cuda)
    kw = kw | {"tie_jitter": tie_jitter, "seed": 5}
    _check_equal(args, kw, legal, cfg.num_simulations)


@pytest.mark.parametrize("num_players", [1, 2])
def test_kernel_tie_jitter(cuda, num_players):
    """With tie jitter on, kernel and plain version add the same Philox
    stream, so they still agree exactly; the stream is keyed by the seed."""
    cfg = MuZeroConfig()
    cfg.players = list(range(num_players))
    args, kw, legal = _inputs(cfg, 64, num_players, True, 3, cuda)
    kw = kw | {"tie_jitter": 1e-5, "seed": (1 << 40) + 11}
    _check_equal(args, kw, legal, cfg.num_simulations)
    a = mcts_fused.search(*args, **kw)
    b = mcts_fused.search(*args, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_kernel_rejects_bad_inputs(cuda):
    args, kw, _ = _inputs(MuZeroConfig(), 8, 1, False, 4, cuda)
    with pytest.raises(ValueError, match="dtype"):
        mcts_fused.search(*args[:4], args[4].to(torch.int64), args[5], **kw)
    with pytest.raises(ValueError, match="on cpu"):
        mcts_fused.search(args[0], args[1].cpu(), *args[2:], **kw)
    with pytest.raises(ValueError, match="contiguous"):
        prior = args[0].t().contiguous().t()
        mcts_fused.search(prior, *args[1:], **kw)


def test_selfplay_runs_through_the_kernel(cuda):
    cfg = MuZeroConfig()
    cfg.parallel_games = 32
    cfg.num_simulations = 16
    cfg.selfplay_chunk_moves = 5
    driver = SelfPlayDriver(make_env(), MuZeroNetwork(cfg), cfg, seed=0)
    before = mcts_fused.search.launches
    _, stats = driver.play(temperature=1.0)
    assert mcts_fused.search.launches == before + 5
    assert stats["env_steps"] == 160 and stats["max_tree_depth"] >= 1
