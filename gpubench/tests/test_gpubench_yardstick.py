"""The frozen yardstick: FLOP and byte counts against hand counts at small
shapes and against torch's own FLOP counter over the reference network, and
the trace reduction on made-up events."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from gpubench.reference.resnet import ResNetReference, make_params
from gpubench.yardstick import flops, peaks, trace, treework

SMALL = dict(observation_shape=[3, 6, 7], stacked_observations=0, action_space=list(range(7)),
             downsample=False, blocks=1, channels=4, reduced_channels_reward=2,
             reduced_channels_value=2, reduced_channels_policy=2,
             resnet_fc_reward_layers=[8], resnet_fc_value_layers=[8],
             resnet_fc_policy_layers=[8], support_size=2, num_unroll_steps=2)
DOWN = dict(SMALL, observation_shape=[3, 32, 32], stacked_observations=1, downsample="resnet",
            channels=8)


def test_flops_by_hand():
    hw = 6 * 7
    conv_in = 2 * 3 * 4 * 9 * hw  # 3 -> 4 channels, 3x3
    block = 2 * (2 * 4 * 4 * 9 * hw)
    rep = conv_in + block
    # two 1x1 heads (4 -> 2), value MLP 84 -> 8 -> 5 bins, policy MLP 84 -> 8 -> 7
    pred = block + 2 * (2 * 4 * 2 * hw) + (2 * 2 * hw * 8 + 2 * 8 * 5) + (2 * 2 * hw * 8 + 2 * 8 * 7)
    # 5 -> 4 channels (the action plane), the tower, a 1x1 head, reward MLP
    dyn = 2 * 5 * 4 * 9 * hw + block + 2 * 4 * 2 * hw + (2 * 2 * hw * 8 + 2 * 8 * 5)
    assert flops.initial_inference_flops(SMALL) == rep + pred
    assert flops.recurrent_inference_flops(SMALL) == dyn + pred
    assert flops.selfplay_move_flops(SMALL, 3, 10) == 3 * (rep + pred + 10 * (dyn + pred))
    assert flops.train_step_flops(SMALL, 4) == 3 * 4 * (rep + pred + 2 * (dyn + pred))


@pytest.mark.parametrize("cfg", [SMALL, DOWN], ids=["plain", "downsample"])
def test_flops_match_torch_counter(cfg):
    """The count from shapes equals torch's own count of the reference
    network's convolutions and matrix products."""
    net = ResNetReference(cfg, make_params(cfg, 3, "cpu"))
    obs = torch.rand(2, (cfg["stacked_observations"] + 1) * 3 + cfg["stacked_observations"],
                     *cfg["observation_shape"][1:])
    with FlopCounterMode(display=False) as count:
        _, _, hidden = net.initial_inference(obs)
    assert count.get_total_flops() == 2 * flops.initial_inference_flops(cfg)
    with FlopCounterMode(display=False) as count:
        net.recurrent_inference(hidden, torch.tensor([1, 2]))
    assert count.get_total_flops() == 2 * flops.recurrent_inference_flops(cfg)


def test_tree_work_by_hand():
    leaf_depth = torch.tensor([1, 3, -1], dtype=torch.int32)
    bound = torch.tensor(4, dtype=torch.int32)
    B, A, D = 3, 7, 11
    levels = 1 + 3 + 4
    f, b = treework.descend_work(leaf_depth, bound, B, A, D)
    assert f == levels * (10 * A + 8)
    assert b == levels * (16 * A + 4) + 4 * (B * A + 2 * B + 1) + 4 * (3 * B + 2 * B * D)
    _, marked = treework.descend_work(leaf_depth, bound, B, A, D, marked=True)
    assert marked == b + 4 * levels
    f, b = treework.backprop_work(leaf_depth, B)
    assert f == (2 + 4) * 10
    assert b == 6 * 28 + B * 44
    _, pre = treework.backprop_work(leaf_depth, B, pre_marked=True)
    assert pre == b - 6 * 4


def test_bound_seconds():
    assert peaks.bound_seconds(67e12, 0) == pytest.approx(1.0)
    assert peaks.bound_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert peaks.bound_seconds(989e12, 1.0, "bfloat16") == pytest.approx(1.0)


def _made_up_trace():
    ops = [(10, 20, "a"), (15, 30, "b"), (40, 50, "a"), (45, 48, "c"), (70, 80, "b")]
    spans = [(0, 100, "play"), (5, 35, "search"), (36, 60, "network"), (36, 55, "descend")]
    return trace.Trace(ops, spans)


def test_busy_is_a_union_and_gaps_are_named():
    tr = _made_up_trace()
    win = trace.windows(tr, "play")[0]
    assert trace.busy_ns(tr, win) == (30 - 10) + (50 - 40) + (80 - 70)
    assert trace.idle_gaps(tr, win) == [(0, 10), (30, 40), (50, 70), (80, 100)]
    named = dict(trace.idle_by_span(tr, win))
    # gap middles: 5 (search starts at 5: innermost search), 35 (search
    # ended at 35: play), 60 (network ends at 60: play), 90 (play)
    assert named == pytest.approx({"search": 10e-9, "play": 50e-9})
    assert trace.top_ops(trace.ops_in(tr, win)) == [["b", 25e-9], ["a", 20e-9], ["c", 3e-9]]
    assert trace.outside_ns(tr, win) == 0
    early = trace.Trace([(-30, -20, "a")] + tr.ops, tr.spans + [(-40, -1, "play.first")])
    assert trace.outside_ns(early, win) == 10
    assert trace.outside_ns(early, win, trace.windows(early, "play.first")[0]) == 0


def test_readings_helpers():
    calls = [{"profiled": True, "wall_s": 150e-9}] + [
        {"profiled": False, "wall_s": w * 1e-9} for w in (90, 100, 400)]
    r = {"trace": _made_up_trace(), "calls": calls}
    assert len(trace.profiled_ops(r, "play")) == 5
    assert trace.kernel_seconds(r, "play", "a") == pytest.approx(20e-9)
    # busy 40 ns of the profiled call over the unprofiled calls' median 100 ns
    assert trace.idle_percent(r, "play") == pytest.approx(60.0)
    assert trace.profiled_ops({"trace": None}, "play") == []
    assert trace.idle_percent({"trace": None, "calls": calls}, "play") is None
