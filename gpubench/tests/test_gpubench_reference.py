"""The plain references against the port at tiny sizes on the CPU: the
network, the loss and SGD steps, the search with the kernels' plain
versions, the driver's draws, Connect Four's rules and the checkpoint
reader. (The references import nothing of the port; these tests do.)"""

import numpy as np
import pytest
import torch

from gpubench.reference import checkpoint as ref_ckpt
from gpubench.reference import connect4 as ref_c4
from gpubench.reference import search as ref_search
from gpubench.reference import train as ref_train
from gpubench.reference.resnet import FullFloat32, ResNetReference, make_params
from gpubench.tests import tiny
from gpubench.tests.conftest import ROOT


def port_pair(name, **sizes):
    from gpubench.drivers import port_config
    from muzero_general_tpu_torch.models import MuZeroNetwork

    cell = tiny.cell(name, **sizes)
    cfgd = cell.config["config"]
    params = make_params(cfgd, 11, "cpu")
    net = MuZeroNetwork(port_config(cell, 11), "cpu")
    state = net.state_dict()
    net.load_state_dict({k: params.get(k, state[k]) for k in state})
    return cell, cfgd, params, net


@pytest.mark.parametrize("name", ["connect4.selfplay", "atari.train"])
def test_network_matches_the_port(name):
    cell, cfgd, params, net = port_pair(name, compute_dtype="float32")
    ref = ResNetReference(cfgd, params)
    c = (cfgd["stacked_observations"] + 1) * 3 + cfgd["stacked_observations"]
    obs = torch.rand(3, c, *cfgd["observation_shape"][1:], generator=torch.Generator().manual_seed(0))
    action = torch.tensor([0, 1, 2])
    with torch.no_grad():
        value, _, policy, hidden = net.initial_inference(obs)
        r_value, r_policy, r_hidden = ref.initial_inference(obs)
        torch.testing.assert_close(value, r_value, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(policy, r_policy, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(hidden, r_hidden, rtol=1e-5, atol=1e-5)
        got = net.recurrent_inference(hidden, action)
        want = ref.recurrent_inference(hidden, action)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_sgd_steps_match_the_learner():
    from gpubench.drivers import port_config, train
    from muzero_general_tpu_torch.trainer import Learner

    cell = tiny.cell("atari.train", compute_dtype="float32")
    cfgd = cell.config["config"]
    learner = Learner(port_config(cell, 5), "cpu", seed=5)
    train._load_params(learner, make_params(cfgd, 5, "cpu"))
    batches = [train.one_batch(cfgd, cell.traffic, 5, m, "cpu") for m in range(3)]
    named = dict(learner.network.named_parameters())
    start = {n: p.detach().clone() for n, p in named.items()}
    losses, first = [], None
    for b in batches:
        metrics, _ = learner.train_step(b)
        losses.append(float(metrics["total_loss"]))
        if first is None:
            first = {n: float(learner.optimizer.state[p]["momentum_buffer"].norm())
                     for n, p in named.items()}
    change = {n: float((p.detach() - start[n]).norm()) for n, p in named.items()}
    ref = train.reference_readings(cfgd, cell.traffic, 5, "cpu")
    gaps = train.compare((losses, first, change), ref)
    # The first step agrees to rounding; rounding differences grow through
    # the later ones, most in the representation's batch norms (near
    # invariant under the hidden state's min-max normalisation).
    assert losses[0] == pytest.approx(ref[0][0], rel=1e-5)
    assert gaps["loss_gap"] < 2e-3
    assert gaps["grad_gap"] < 1e-4 and gaps["grad_gap_worst"] < 1e-3
    assert gaps["update_gap"] < 1e-2 and gaps["update_gap_worst"] < 0.1


@pytest.mark.parametrize("leaves", [1, 4])
def test_search_matches_the_port(leaves):
    from muzero_general_tpu_torch.ops import mcts as mcts_ops

    cell, cfgd, params, net = port_pair("connect4.selfplay", search_batch_leaves=leaves)
    spec = ref_search.SearchSpec.from_config(cfgd)
    port_spec = mcts_ops.SearchSpec.from_config(_ns(cfgd), 8, "cpu")
    assert port_spec.use_kernels and port_spec.batch_leaves == leaves
    gen = torch.Generator().manual_seed(3)
    board = torch.zeros(8, 6, 7)
    board[:, 0, :3] = torch.tensor([1.0, -1.0, 1.0])
    obs = torch.from_numpy(ref_c4.encode(board.numpy().astype(np.int64), -np.ones(8)))
    legal = torch.from_numpy(ref_c4.legal_from_obs(obs.numpy()))
    gamma = torch.rand(8, 7, generator=gen) + 0.1
    with torch.no_grad():
        out = mcts_ops.run_mcts(net.initial_inference, net.recurrent_inference, obs, legal,
                                torch.ones(8, dtype=torch.int32), None, port_spec,
                                root_noise=gamma, seed=1234)
        ref = ref_search.run(ResNetReference(cfgd, params), obs, legal, spec,
                             ref_search.MoveDraws(1234, gamma, None))
    assert torch.equal(out.root_visit_counts, ref.visits)
    torch.testing.assert_close(out.root_value, ref.root_value, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(out.root_predicted_value, ref.predicted_value, rtol=1e-5, atol=1e-5)


def _ns(cfgd):
    """The port's config object from a config dict."""
    from muzero_general_tpu_torch.config import MuZeroConfig

    cfg = MuZeroConfig()
    for k, v in cfgd.items():
        setattr(cfg, k, v)
    return cfg


def test_driver_stream_replays_the_driver_draws():
    from muzero_general_tpu_torch.ops import mcts as mcts_ops

    spec = ref_search.SearchSpec.from_config(tiny.cell("connect4.selfplay").config["config"])
    stream = ref_search.DriverStream(99, 8, 7, spec, "cpu")
    host = torch.Generator().manual_seed(99)
    gen = torch.Generator().manual_seed(99)
    for _ in range(3):
        draws = stream.next_move()
        assert draws.key == int(torch.randint(0, 2**31 - 1, (1,), generator=host))
        gamma = mcts_ops.sample_gamma(spec.dirichlet_alpha, (8, 7), gen, "cpu")
        assert torch.equal(draws.gamma, gamma)
        legal = torch.ones(8, 7, dtype=torch.bool)
        visits = torch.randint(0, 5, (8, 7), generator=torch.Generator().manual_seed(1))
        action = mcts_ops.select_action(gen, visits, legal, torch.ones(8))
        _, want = ref_search.sampled_action_gap(visits, legal, torch.ones(8), draws.uniform)
        assert torch.equal(action, want)


def test_connect4_rules_match_the_port():
    from muzero_general_tpu_torch.envs.connect4 import Connect4

    env, G = Connect4("cpu"), 16
    gen = torch.Generator().manual_seed(4)
    state = env.reset(G)
    obs, act, rew, done, tp, tpn = [], [], [], [], [], []
    for _ in range(60):
        legal = env.legal_actions_mask(state)
        a = torch.argmax(torch.rand(G, 7, generator=gen) * legal, dim=1)
        obs.append(env.observation(state))
        tp.append(env.to_play(state))
        state2, r, d = env.step(state, a)
        act.append(a)
        rew.append(r)
        done.append(d)
        tpn.append(env.to_play(state2))
        fresh = env.reset(G)
        state = type(state)(*(torch.where(d.view(-1, *[1] * (x.dim() - 1)), f, x)
                              for f, x in zip(fresh, state2)))
    rec = [torch.stack(x).numpy() for x in (obs, act, rew, done, tp, tpn)]
    assert not ref_c4.check_transitions(*rec).any()
    assert rec[3].any() and (rec[2] == 10).any()
    bad_action = rec[1].copy()
    bad_action[10, 3] = (bad_action[10, 3] + 1) % 7
    assert ref_c4.check_transitions(rec[0], bad_action, *rec[2:])[10, 3]


def test_checkpoint_reader_matches_the_port():
    from muzero_general_tpu_torch.checkpoint import load_checkpoint
    from muzero_general_tpu_torch.models import params_from_jax

    path = ROOT / "pretrained" / "connect4" / "model.checkpoint"
    want = params_from_jax(load_checkpoint(path)["weights"])
    got = ref_ckpt.load_weights(path, "cpu")
    assert set(want) - {k for k in want if k.endswith("num_batches_tracked")} == set(got)
    for k, v in got.items():
        assert torch.equal(v, want[k])


def test_tf32_and_fp8_rounding():
    from gpubench.reference.resnet import round_fp8, round_tf32

    x = torch.tensor([1.0 + 2**-11, 1.0 + 2**-10 + 2**-11, -3.0, 0.0])
    assert round_tf32(x).tolist() == [1.0 + 2**-10, 1.0 + 2**-9, -3.0, 0.0]
    y = torch.linspace(-2, 2, 101)
    assert (round_fp8(y) - y).abs().max() <= 2 * 2**-4 * 2
    with FullFloat32():
        assert not torch.backends.cudnn.allow_tf32
