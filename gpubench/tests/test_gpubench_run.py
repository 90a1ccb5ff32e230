"""A run of each cell end to end at a tiny size on the CPU, past the
harness's look for a card: correct as it stands; not correct with the timed
path broken underneath (a step that leaves its state unchanged, half of the
batch left out, an answer altered where it is produced); the control, the
reference in the precision below the configuration's, fails the cell's
limits. And the command itself: no card, no result; no JAX in the process.
The `gpu` test runs the same on the card at a size a test run holds."""

import json
import subprocess
import sys

import pytest
import torch

from gpubench import harness
from gpubench.drivers import selfplay, train
from gpubench.run import result_line, run_cell
from gpubench.tests import tiny
from gpubench.tests.conftest import ROOT

CPU = {"platform": "cpu", "kind": "cpu", "count": 1}
SELFPLAY = ["connect4.selfplay", "connect4.selfplay-k8"]


def line(cell, trace=False, seed=20260101, device="cpu"):
    out = run_cell(cell, seed, 0.0, trace, torch.device(device), 0.0)
    return result_line(cell, out, trace, CPU)


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
@pytest.mark.parametrize("name", SELFPLAY + ["atari.train"])
def test_cell_runs_correct(name, trace):
    cell = tiny.cell(name, **({"search_batch_leaves": 4} if name.endswith("k8") else {}))
    result = line(cell, trace)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == set(cell.limits["limits"])
    if trace:
        assert set(result["device"]) >= {"busy_s", "window_s"}
        assert "breakdown" in result
    else:
        assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    json.dumps(result)


def test_altered_action_is_caught(monkeypatch):
    from muzero_general_tpu_torch.ops import mcts as mcts_ops

    select = mcts_ops.select_action

    def altered(generator, visits, legal, temperature):
        action = select(generator, visits, legal, temperature)
        # the next legal action of lane 0
        order = torch.roll(torch.arange(visits.shape[-1]), -int(action[0]) - 1)
        action[0] = order[legal[0][order]][0]
        return action

    monkeypatch.setattr(mcts_ops, "select_action", altered)
    assert not line(tiny.cell("connect4.selfplay"))["correct"]


def test_altered_visits_are_caught(monkeypatch):
    from muzero_general_tpu_torch.ops import mcts as mcts_ops

    run = mcts_ops.run_mcts

    def altered(*args, **kwargs):
        out = run(*args, **kwargs)
        visits = out.root_visit_counts.clone()
        top = visits.argmax(-1, keepdim=True)
        visits.scatter_add_(1, top, -torch.ones_like(top, dtype=visits.dtype))
        visits.scatter_add_(1, (top + 1) % visits.shape[-1], torch.ones_like(top, dtype=visits.dtype))
        return out._replace(root_visit_counts=visits)

    monkeypatch.setattr(mcts_ops, "run_mcts", altered)
    result = line(tiny.cell("connect4.selfplay"))
    assert not result["correct"]
    assert result["checks"]["visit_mismatch_share"]["value"] == 1.0


def test_unchanged_env_state_is_caught(monkeypatch):
    from muzero_general_tpu_torch.envs.connect4 import Connect4

    step = Connect4.step

    def stuck(self, state, action, generator=None):
        _, reward, done = step(self, state, action, generator)
        return state, reward, done

    monkeypatch.setattr(Connect4, "step", stuck)
    result = line(tiny.cell("connect4.selfplay"))
    assert not result["correct"] and result["checks"]["env_mismatches"]["value"] > 0


def test_step_with_unchanged_state_is_caught(monkeypatch):
    monkeypatch.setattr(torch.optim.SGD, "step", lambda self, closure=None: None)
    result = line(tiny.cell("atari.train"))
    assert not result["correct"]
    assert result["checks"]["update_gap"]["value"] == pytest.approx(1.0)


def test_checked_call_reads_each_step():
    """The readings taken as the window's call of M steps updates are those
    of the same steps taken one call at a time."""
    from gpubench.drivers import port_config
    from gpubench.reference.resnet import make_params
    from muzero_general_tpu_torch.trainer import Learner

    cell = tiny.cell("atari.train", compute_dtype="float32")
    cfgd = cell.config["config"]

    def learner():
        made = Learner(port_config(cell, 7), "cpu", seed=7)
        train._load_params(made, make_params(cfgd, 7, "cpu"))
        return made

    batches = train.empty_batches(cfgd, train.CHECKED_STEPS, "cpu")
    for m in range(train.CHECKED_STEPS):
        train.fill_batch({k: v[m] for k, v in batches.items()}, cell.traffic, cfgd, 7, m)
    losses, first, change = train.checked_call(learner(), batches)

    alone = learner()
    named = dict(alone.network.named_parameters())
    start = {n: p.detach().clone() for n, p in named.items()}
    step_losses = []
    for m in range(train.CHECKED_STEPS):
        metrics, _ = alone.train_steps({k: v[m:m + 1] for k, v in batches.items()})
        step_losses.append(float(metrics["total_loss"]))
        if m == 0:
            step_first = {n: float(alone.optimizer.state[p]["momentum_buffer"].norm())
                          for n, p in named.items()}
    assert losses == pytest.approx(step_losses, rel=1e-6)
    assert first == pytest.approx(step_first, rel=1e-6)
    assert change == pytest.approx({n: float((p.detach() - start[n]).norm())
                                    for n, p in named.items()}, rel=1e-5)


def test_half_batch_is_caught(monkeypatch):
    from muzero_general_tpu_torch import trainer

    loss_fn = trainer.loss_fn

    def half(network, batch, config, *args, **kwargs):
        rows = batch["action"].shape[0] // 2
        return loss_fn(network, {k: v[:rows] for k, v in batch.items()}, config, *args, **kwargs)

    monkeypatch.setattr(trainer, "loss_fn", half)
    assert not line(tiny.cell("atari.train"))["correct"]


@pytest.mark.parametrize("name, control", [("connect4.selfplay", "tf32"),
                                           ("atari.train", "fp8")])
def test_control_fails_the_limits(name, control):
    cell = tiny.cell(name)
    out = harness.load_driver(cell.traffic).run(cell, 20260102, 0.0, False,
                                                torch.device("cpu"), 0.0, control=control)
    _, program_ok = harness.judge(out["numbers"], cell.limits["limits"])
    numbers = dict(out["numbers"], **out["control_numbers"])
    _, control_ok = harness.judge(numbers, cell.limits["limits"])
    assert program_ok and not control_ok


def test_no_card_no_result():
    env = {"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin", "HOME": str(ROOT)}
    proc = subprocess.run([sys.executable, "gpubench/run.py", "--workload", "connect4.selfplay",
                           "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2 and proc.stdout == ""


def test_a_run_loads_no_jax():
    """A whole tiny run in a fresh process leaves no module of JAX, flax or
    the JAX package behind (top-level names compared whole)."""
    code = ("import torch; from gpubench import harness; from gpubench.tests import tiny;"
            "from gpubench.run import run_cell;"
            "[run_cell(tiny.cell(n), 5, 0.0, t, torch.device('cpu'), 0.0)"
            " for n, t in (('connect4.selfplay', True), ('atari.train', False))];"
            "print(harness.forbidden_loaded())")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.gpu
@pytest.mark.parametrize("name, control, sizes", [
    ("connect4.selfplay", "tf32", {"parallel_games": 256, "num_simulations": 50}),
    ("connect4.selfplay-k8", "tf32", {"parallel_games": 64, "num_simulations": 48}),
    ("atari.train", "fp8", {"batch_size": 64, "blocks": 4}),
])
def test_control_on_the_card(card, name, control, sizes):
    """On the card, at a size a test run holds: the program within the
    cell's limits and the control outside them."""
    c = harness.load_cell(name, root=ROOT)
    cfg = dict(c.config["config"], **sizes)
    c = c._replace(config=dict(c.config, config=cfg))
    driver = selfplay if c.traffic["generator"] == "selfplay" else train
    out = driver.run(c, 20260103, 0.0, False, card, 0.0, control=control)
    _, program_ok = harness.judge(out["numbers"], c.limits["limits"])
    _, control_ok = harness.judge(dict(out["numbers"], **out["control_numbers"]),
                                  c.limits["limits"])
    assert program_ok and not control_ok, (out["numbers"], out["control_numbers"])
