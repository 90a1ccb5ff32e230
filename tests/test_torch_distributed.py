"""The port's multi-process layout (muzero_general_tpu_torch/parallel/
distributed.py), on the CPU, on the pattern of tests/test_distributed.py.

- The two-process smoke (parallel/dist_smoke.py) runs as two OS processes
  with gloo: a train step on the global dp mesh from per-rank local batches,
  whose all_reduced loss must be identical on both ranks; per-rank
  self-play; global_sum.
- Multi-host training: two processes each call
  MuZero("cartpole", ..., distributed={...}, device="cpu").train(), JAX's
  multi-host layout (each rank its own self-play lanes and replay buffer of
  batch_size / 2 rows, global counters, rank 0 alone writing). Their final
  weights must be equal, only rank 0's results_path holds files, and each
  rank writes its own batch rows' priorities into its own buffer (JAX's
  loop reads the global priorities array there and fails as
  non-addressable: ROADMAP section 3).
- The backend is chosen as the port's table says, with no fallback (the
  same two processes).
The test process hosts each run's rendezvous store on a port it bound
itself (parallel/distributed.py host_store); the processes import no JAX.
"""

import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from muzero_general_tpu_torch.parallel import distributed as dist_lib

REPO = pathlib.Path(__file__).resolve().parents[1]
MULTI_HOST = dict(training_steps=8, parallel_games=4, selfplay_chunk_moves=4,
                  num_simulations=4, batch_size=8, fused_train_steps=2, checkpoint_interval=4,
                  max_moves=12, reanalyse_interval=4, PER=True, batch_prefetch=False)


def test_two_process_global_mesh_smoke():
    store, address = dist_lib.host_store()
    env = dict(os.environ, PYTHONPATH=str(REPO), **{dist_lib.AGENT_STORE: "True"})
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "muzero_general_tpu_torch.parallel.dist_smoke",
             "--coordinator", address, "--num-processes", "2",
             "--process-id", str(i), "--device", "cpu"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out[-3000:]}"
    ok = [line for out in outs for line in out.splitlines() if line.startswith("dist_smoke OK")]
    assert len(ok) == 2, outs
    assert all("(gloo)" in line and "global env_steps=32" in line for line in ok), ok
    # Both ranks hold the identical all_reduced loss.
    loss0, loss1 = (line.split("loss=")[1].split(",")[0] for line in ok)
    assert loss0 == loss1, (loss0, loss1)


def _leaves(tree):
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            yield from _leaves(value)
        else:
            yield np.asarray(value).ravel()


def _multi_host_rank(rank, address, root):
    """One process of the multi-host run (torch.multiprocessing). Rank 0's
    spec leaves the backend to the port's table, rank 1's names gloo."""
    os.environ[dist_lib.AGENT_STORE] = "True"  # the test hosts the store
    torch.set_num_threads(1)
    from muzero_general_tpu_torch import MuZero
    from muzero_general_tpu_torch.replay import ReplayBuffer

    rows = []
    update = ReplayBuffer.update_priorities

    def recorded(self, priorities, index_info):
        rows.append((len(index_info), np.shape(priorities)))
        return update(self, priorities, index_info)

    ReplayBuffer.update_priorities = recorded
    path = pathlib.Path(root) / f"rank{rank}"
    spec = {"coordinator_address": address, "num_processes": 2, "process_id": rank,
            **({"backend": "gloo"} if rank else {})}
    mz = MuZero("cartpole", dict(MULTI_HOST, results_path=str(path)), distributed=spec,
                device="cpu")
    dist_lib.initialize(**spec)  # idempotent
    joined = (torch.distributed.get_backend(), str(mz.device), dist_lib.process_count(),
              dist_lib.process_index())
    ckpt = mz.train(log_in_tensorboard=False)
    out = {"weights": np.concatenate(list(_leaves(ckpt["weights"]["params"]))),
           "training_step": ckpt["training_step"], "rows": rows, "joined": joined,
           "files": sorted(p.name for p in path.iterdir())}
    with open(pathlib.Path(root) / f"out{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def multi_host(tmp_path_factory):
    """Both ranks' outputs of one two-process multi-host train() run."""
    import torch.multiprocessing as mp

    root = tmp_path_factory.mktemp("multi_host")
    store, address = dist_lib.host_store()
    mp.spawn(_multi_host_rank, args=(address, str(root)), nprocs=2, join=True)
    outs = []
    for rank in range(2):
        with open(root / f"out{rank}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return outs


def test_multi_host_train(multi_host):
    outs = multi_host
    assert [o["training_step"] for o in outs] == [8, 8]
    assert [o["joined"][:2] for o in outs] == [("gloo", "cpu")] * 2
    np.testing.assert_array_equal(outs[0]["weights"], outs[1]["weights"])
    assert {"model.checkpoint", "replay_buffer.pkl"} <= set(outs[0]["files"])
    assert outs[1]["files"] == []  # rank 1 wrote nothing
    for o in outs:
        # Each rank wrote priorities for its own batch_size / 2 rows only.
        assert o["rows"] and all(n == 4 and shape[0] == 4 for n, shape in o["rows"])


def test_backend_choice_and_spec_errors(multi_host):
    """The two ranks of the multi-host run met over the spec's rendezvous:
    on the CPU over gloo, unnamed (rank 0: the table in
    parallel/distributed.py) or named (rank 1), and a second initialize
    changed nothing. NCCL's refusal of two ranks on one card is not caught
    anywhere: chip_smoke.py's phase 17 names gloo for them."""
    for rank, o in enumerate(multi_host):
        assert o["joined"] == ("gloo", "cpu", 2, rank)
    with pytest.raises(ValueError, match="True or a dict"):
        dist_lib.initialize_from_spec("yes")
    with pytest.raises(ValueError, match="launcher's environment"):
        env = {k: v for k, v in os.environ.items() if k != "MASTER_ADDR"}
        with pytest.MonkeyPatch.context() as m:
            m.setattr(os, "environ", env)
            dist_lib.initialize_from_spec(True, device="cpu")
    with pytest.raises(ValueError, match="one rank drives one device"):
        dist_lib._rank_device(None, [0, 1], 0)
