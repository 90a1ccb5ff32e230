"""The port's fused search (plain version, on the CPU) against the JAX package.

The pattern of tests/test_mcts_fused.py: the same weights (a JAX random init
carried over with params_from_jax), the same numpy observations, and with
noise on, the JAX side's own Gamma draw, jax.random.gamma(fold_in(rng, 0),
alpha, (B, A)), injected as root_noise. Both sides break ties by first index
(tie_jitter 0, deterministic_tie_break). Visit counts and tree depth must be
exact. Root values agree to atol 5e-5, rtol 1e-5: the MLPs sum in another
order than XLA's dots, and float32 h^-1 (the support decode) puts leaf values
on a grid of ~6e-5 (1 + |v|) (see tests/test_torch_support.py), so a last-bit
difference in a leaf's expectation can move that leaf by one grid step and the
root mean by that over its visits. Observed: at most 3.1e-5 over 12 seeds,
where the JAX package's own two paths differ by up to 8.3e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muzero_general_tpu.games.cartpole import MuZeroConfig as JaxConfig
from muzero_general_tpu.models import MuZeroNetwork as JaxNetwork
from muzero_general_tpu.ops import mcts as jax_mcts
from muzero_general_tpu.ops import mcts_fused as jax_fused
from muzero_general_tpu_torch.games.cartpole import MuZeroConfig
from muzero_general_tpu_torch.models import MuZeroNetwork, params_from_jax
from muzero_general_tpu_torch.ops import mcts as torch_mcts
from muzero_general_tpu_torch.ops import mcts_fused as torch_fused

B = 8
VALUE_ATOL = 5e-5  # see the module docstring


def _setup(num_players=1, sims=20, overrides=None, seed=0):
    jcfg, tcfg = JaxConfig(), MuZeroConfig()
    for cfg in (jcfg, tcfg):
        cfg.num_simulations = sims
        cfg.players = list(range(num_players))
        for key, value in (overrides or {}).items():
            setattr(cfg, key, value)
    runner = JaxNetwork(jcfg)
    variables = jax.tree_util.tree_map(
        np.asarray, runner.init(jax.random.PRNGKey(seed))
    )
    net = MuZeroNetwork(tcfg, device="cpu")
    net.load_state_dict(params_from_jax(variables))
    rng = np.random.default_rng(5 + seed)
    obs = rng.normal(size=(B, 1, 1, 4)).astype(np.float32)
    legal = np.ones((B, 2), bool)
    legal[1, 0] = False  # one lane with a restricted root
    to_play = (np.arange(B) % num_players).astype(np.int32)
    return jcfg, tcfg, runner, variables, net, obs, legal, to_play


def _port(tcfg, net, obs, legal, to_play, noise, jax_rng):
    root_noise = None
    if noise:
        root_noise = torch.from_numpy(np.array(jax.random.gamma(
            jax.random.fold_in(jax_rng, 0), tcfg.root_dirichlet_alpha,
            legal.shape,
        )))
    spec = torch_fused.FusedSpec.from_config(tcfg, deterministic_tie_break=True)
    assert spec.tie_jitter == 0.0
    return torch_fused.run_mcts_fused(
        net, torch.from_numpy(obs), torch.from_numpy(legal),
        torch.from_numpy(to_play), None, spec, add_exploration_noise=noise,
        root_noise=root_noise,
    )


def _assert_same(got, want, sims):
    np.testing.assert_array_equal(got.root_visit_counts.numpy(),
                                  np.asarray(want.root_visit_counts))
    np.testing.assert_array_equal(got.max_tree_depth.numpy(),
                                  np.asarray(want.max_tree_depth))
    np.testing.assert_allclose(got.root_value.numpy(), np.asarray(want.root_value),
                               rtol=1e-5, atol=VALUE_ATOL)
    np.testing.assert_allclose(got.root_predicted_value.numpy(),
                               np.asarray(want.root_predicted_value),
                               rtol=1e-6, atol=1e-6)
    visits = got.root_visit_counts.numpy()
    assert visits[1, 0] == 0  # masked root action
    np.testing.assert_array_equal(visits.sum(-1), sims)


@pytest.mark.parametrize("num_players", [1, 2])
@pytest.mark.parametrize("noise", [False, True])
def test_plain_matches_jax_fused_kernel(num_players, noise):
    """Against the Pallas kernel itself, run in interpret mode."""
    jcfg, tcfg, runner, variables, net, obs, legal, to_play = _setup(num_players)
    rng = jax.random.PRNGKey(3)
    fspec = jax_fused.FusedSpec.from_config(
        jcfg, deterministic_tie_break=True, interpret=True
    )
    want = jax_fused.run_mcts_fused(
        lambda o: runner.initial_inference(variables, o),
        variables, jnp.asarray(obs), jnp.asarray(legal), jnp.asarray(to_play),
        rng, fspec, add_exploration_noise=noise,
    )
    got = _port(tcfg, net, obs, legal, to_play, noise, rng)
    _assert_same(got, want, jcfg.num_simulations)


@pytest.mark.parametrize("num_players", [1, 2])
@pytest.mark.parametrize("noise", [False, True])
def test_plain_matches_jax_staged_search(num_players, noise):
    """Against ops/mcts.py run_mcts, the oracle-verified staged search."""
    jcfg, tcfg, runner, variables, net, obs, legal, to_play = _setup(
        num_players, seed=1
    )
    rng = jax.random.PRNGKey(4)
    spec = jax_mcts.SearchSpec.from_config(jcfg)._replace(deterministic_tie_break=True)
    want = jax_mcts.run_mcts(
        lambda o: runner.initial_inference(variables, o),
        lambda h, a: runner.recurrent_inference(variables, h, a),
        jnp.asarray(obs), jnp.asarray(legal), jnp.asarray(to_play), rng, spec,
        add_exploration_noise=noise,
    )
    got = _port(tcfg, net, obs, legal, to_play, noise, rng)
    _assert_same(got, want, jcfg.num_simulations)


def test_plain_deeper_dynamics_mlp():
    """Multi-layer dynamics, a reward head with no hidden layer, E=6."""
    overrides = dict(encoding_size=6, fc_dynamics_layers=[16, 12],
                     fc_reward_layers=[], fc_value_layers=[8], fc_policy_layers=[8])
    jcfg, tcfg, runner, variables, net, obs, legal, to_play = _setup(
        1, sims=12, overrides=overrides, seed=2
    )
    rng = jax.random.PRNGKey(9)
    spec = jax_mcts.SearchSpec.from_config(jcfg)._replace(deterministic_tie_break=True)
    want = jax_mcts.run_mcts(
        lambda o: runner.initial_inference(variables, o),
        lambda h, a: runner.recurrent_inference(variables, h, a),
        jnp.asarray(obs), jnp.asarray(legal), jnp.asarray(to_play), rng, spec,
        add_exploration_noise=True,
    )
    got = _port(tcfg, net, obs, legal, to_play, True, rng)
    weights = torch_fused.fused_weights(net, tcfg.encoding_size)
    assert weights.layer_counts == (2, 1, 2, 2)
    assert weights.dims[0] == (6 + 2, 16)
    _assert_same(got, want, jcfg.num_simulations)


def test_search_on_cpu_is_the_plain_version():
    """The wrapper takes the plain version for CPU tensors; no launch counts."""
    _, tcfg, _, _, net, obs, legal, to_play = _setup(2, sims=10)
    spec = torch_fused.FusedSpec.from_config(tcfg)
    root = torch_fused.prepare_root(
        net, torch.from_numpy(obs), torch.from_numpy(legal),
        torch.from_numpy(to_play), torch.Generator().manual_seed(0), spec,
    )
    weights = torch_fused.fused_weights(net, tcfg.encoding_size)
    args = (root.prior, root.hidden, root.reward, root.to_play, root.legal, weights)
    kwargs = torch_fused.search_kwargs(spec) | {"tie_jitter": 0.0}
    before = torch_fused.search.launches
    got = torch_fused.search(*args, **kwargs)
    want = torch_fused.search_plain(*args, **kwargs)
    assert torch_fused.search.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # With tie jitter the search still spends every simulation on legal moves.
    visits, value, depth = torch_fused.search(*args, **(kwargs | {"tie_jitter": 1e-5}), seed=7)
    assert visits[1, 0] == 0 and bool((visits.sum(-1) == 10).all())
    assert bool((depth >= 1).all()) and bool(torch.isfinite(value).all())
    with pytest.raises(ValueError, match="CUDA or CPU"):
        torch_fused.search(*(t.to("meta") for t in args[:5]), weights, **kwargs)


_M32 = 0xFFFFFFFF


def _philox_reference(ctr, key):
    """Philox4x32-10 in Python integers, straight from its definition."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key & _M32, key >> 32
    for _ in range(10):
        p0, p1 = 0xD2511F53 * c0, 0xCD9E8D57 * c2
        c0, c1, c2, c3 = (p1 >> 32) ^ c1 ^ k0, p1 & _M32, (p0 >> 32) ^ c3 ^ k1, p0 & _M32
        k0, k1 = (k0 + 0x9E3779B9) & _M32, (k1 + 0xBB67AE85) & _M32
    return [c0, c1, c2, c3]


# Known-answer vectors of Random123 (Salmon et al., SC'11), Philox4x32-10:
# counter, key (low word first), output.
@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]),
    ((_M32,) * 4, (_M32, _M32), [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     [0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]),
])
def test_philox_known_answers(ctr, key, want):
    seed = key[0] | key[1] << 32
    got = torch_fused.philox4x32_10(tuple(torch.tensor([c]) for c in ctr), seed)
    assert [int(w) for w in got] == want
    assert _philox_reference(ctr, seed) == want


def test_plain_jitter_is_the_kernels_philox_stream():
    """search_plain's tie-jitter bits: word a % 4 of the block at counter
    (lane, simulation, level, a // 4), keyed by the seed, as in the kernel."""
    rng = np.random.default_rng(0)
    ctr = rng.integers(0, 2**32, size=(4, 32), dtype=np.uint64).astype(np.int64)
    seed = int(rng.integers(0, 2**63))
    got = torch_fused.philox4x32_10(tuple(torch.from_numpy(c) for c in ctr), seed)
    for j in range(ctr.shape[1]):
        assert [int(w[j]) for w in got] == _philox_reference(ctr[:, j].tolist(), seed)
    lanes, A, sim, levels = 3, 6, 17, 5
    bits = torch_fused._jitter_bits(lanes, A, sim, levels, seed, torch.device("cpu"))
    assert bits.shape == (lanes, levels, A)
    for b in range(lanes):
        for t in range(levels):
            for a in range(A):
                want = _philox_reference((b, sim, t, a // 4), seed)[a % 4]
                assert int(bits[b, t, a]) == want


@pytest.mark.parametrize("alpha", [0.25, 2.0])
def test_gamma_sampler_moments(alpha):
    """Marsaglia-Tsang draws: mean and variance alpha, seeded, positive."""
    gen = torch.Generator().manual_seed(0)
    x = torch_mcts.sample_gamma(alpha, (200_000,), gen).double()
    # 5 standard errors of the sample mean and variance
    assert abs(float(x.mean()) - alpha) < 5 * np.sqrt(alpha / 2e5)
    var_se = np.sqrt((6 * alpha + 2 * alpha**2) / 2e5)  # sd of x^2 about alpha^2
    assert abs(float(x.var()) - alpha) < 5 * var_se * 2
    assert bool((x >= 0).all())
    y = torch_mcts.sample_gamma(alpha, (200_000,), torch.Generator().manual_seed(0))
    assert torch.equal(x.float(), y)


def test_root_helpers_match_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(6, 4)).astype(np.float32)
    legal = rng.random((6, 4)) < 0.7
    legal[:, 0] = True
    g = rng.gamma(0.25, size=(6, 4)).astype(np.float32)
    visits = rng.integers(0, 20, size=(6, 4)).astype(np.int32) * legal
    t = torch.from_numpy
    np.testing.assert_allclose(
        torch_mcts.masked_softmax(t(logits), t(legal)).numpy(),
        np.asarray(jax_mcts.masked_softmax(logits, legal)), atol=1e-7)
    np.testing.assert_allclose(
        torch_mcts.visit_policy(t(visits)).numpy(),
        np.asarray(jax_mcts.visit_policy(visits)), atol=1e-7)
    # The noise mix of ops/mcts.py:1040-1049 with the Gammas injected.
    prior = np.asarray(jax_mcts.masked_softmax(logits, legal))
    gm = np.where(legal, g, 0.0)
    want = np.where(legal, prior * 0.75 + gm / gm.sum(-1, keepdims=True) * 0.25, 0.0)
    got = torch_mcts.add_root_noise(t(prior), t(legal), 0.25, 0.25, root_noise=t(g))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_select_action_temperatures():
    gen = torch.Generator().manual_seed(0)
    visits = torch.tensor([[3, 7, 7, 0], [5, 0, 9, 1]], dtype=torch.int32)
    legal = torch.tensor([[True, True, True, False], [True, False, True, True]])
    greedy = torch_mcts.select_action(gen, visits, legal, 0.0)
    assert greedy.tolist() == [1, 2]  # first index among equal maxima
    per_lane = torch.tensor([0.0, float("inf")])
    counts = np.zeros((2, 4))
    for _ in range(2000):
        a = torch_mcts.select_action(gen, visits, legal, per_lane)
        counts[np.arange(2), a.numpy()] += 1
    assert counts[0, 1] == 2000  # lane 0 greedy
    assert counts[1, 1] == 0 and counts[1, [0, 2, 3]].min() > 550  # uniform over legal
    counts = np.zeros(4)
    for _ in range(4000):
        counts[int(torch_mcts.select_action(gen, visits[:1], legal[:1], 1.0))] += 1
    np.testing.assert_allclose(counts / 4000, [0.18, 0.41, 0.41, 0.0], atol=0.04)
