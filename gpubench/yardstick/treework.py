"""The operations and bytes one launch of the staged search's tree kernels
needs for its own tree (frozen copies of chip_smoke.py's `descend_work` and
`backprop_work`). Each input byte is counted once as read and each output
byte once as written; the work depends on the data (how deep each lane
descends), so it is counted from the launch's own leaf depths."""

import torch


def descend_work(leaf_depth, depth_bound, B, A, D, marked=False):
    """(FLOPs, bytes) of one descent: per level a lane descends, its node's A
    edges of four stats and the chosen child's index (marked: and the taken
    edge's visit written back), about 10 operations per edge plus a log, a
    sqrt and a few for the node; the root's legal row and the min/max once,
    and every output once. `leaf_depth` [B] is the launch's output (-1 for a
    lane cut by the bound), `depth_bound` its bound."""
    cut = torch.where(leaf_depth < 0, depth_bound, leaf_depth)
    levels = int(cut.sum())
    flops = levels * (10 * A + 8)
    nbytes = (levels * (4 * 4 * A + 4 + (4 if marked else 0)) + 4 * (B * A + 2 * B + 1)
              + 4 * (3 * B + 2 * B * D))
    return flops, nbytes


def backprop_work(leaf_depth, B, pre_marked=False):
    """(FLOPs, bytes) of one backprop: per node on a path its edge's path
    entries, visit read (and written, unless pre-marked), value sum read and
    written and reward read, about 10 operations; per lane its leaf and root
    scalars."""
    levels = int((leaf_depth + 1).clamp(min=0).sum())
    flops = levels * 10
    nbytes = levels * (8 + (12 if pre_marked else 16) + 4) + B * 4 * (2 + 1 + 2 * 4)
    return flops, nbytes
