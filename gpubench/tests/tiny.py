"""Tiny versions of the benchmark's cells for the CPU tests: the cells'
own files with their sizes cut, the search's kernels run by their plain
versions (use_pallas_mcts True on the CPU)."""

from gpubench import harness
from gpubench.tests.conftest import ROOT

TINY_TRAIN = dict(observation_shape=[3, 96, 96], stacked_observations=2, blocks=1, channels=8,
                  reduced_channels_reward=4, reduced_channels_value=4,
                  reduced_channels_policy=4, resnet_fc_reward_layers=[8],
                  resnet_fc_value_layers=[8], resnet_fc_policy_layers=[8], support_size=5,
                  batch_size=8, fused_train_steps=3)


def cell(name, **config):
    c = harness.load_cell(name, root=ROOT)
    if c.traffic["generator"] == "selfplay":
        sizes = dict(parallel_games=8, num_simulations=16, selfplay_chunk_moves=2,
                     use_pallas_mcts=True)
        traffic = dict(c.traffic, check_moves=2)
    else:
        sizes = dict(TINY_TRAIN)
        traffic = c.traffic
    sizes.update(config)
    return c._replace(config=dict(c.config, config=dict(c.config["config"], **sizes)),
                      traffic=traffic)
