"""The benchmark's files: BENCHMARK.json against the contract's shape, every
cell, configuration, traffic, limits and metric file it names, and a cell,
configuration and per-layer metric taken from added files alone."""

import ast
import json
import re
import shutil

import pytest

from gpubench import harness
from gpubench.tests.conftest import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = ("hidden", "intermediate", "latent", "state", "projection", "head", "channels")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "gpubench/run.py"]
    assert SPEC["paths"] == ["gpubench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_keys():
    for group, keys in (("configs", {"name", "source", "file", "reduced", "why"}),
                        ("workloads", {"name", "config", "traffic", "chips", "why"}),
                        ("end_to_end", {"name", "unit", "better", "bound", "source"}),
                        ("per_layer", {"name", "unit", "better", "source", "layer", "moves"})):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))
        for entry in SPEC[group]:
            assert set(entry) - {"workloads"} == keys, entry["name"]
            assert NAME.match(entry["name"])
            if "unit" in entry:
                assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
            for text in ("why", "layer", "source"):
                if text in entry:
                    assert 1 <= len(entry[text]) <= 200 and "\n" not in entry[text]


def test_bounds():
    bounds = {m["name"]: m["bound"] for m in SPEC["end_to_end"]}
    assert bounds["setup_s"] == 0.25
    assert all(0.01 <= b <= 0.25 for b in bounds.values())
    assert all(m["source"] in ("host_clock", "device_trace") for m in SPEC["end_to_end"])


def test_every_cell_loads_and_reports():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for work in SPEC["workloads"]:
        assert work["chips"] == 1
        cell = harness.load_cell(work["name"], root=ROOT)
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer, work["name"]
        for metric in cell.per_layer:
            assert metric["moves"] in names and metric["moves"] in e2e
        assert set(cell.limits["limits"]), work["name"]
        harness.load_driver(cell.traffic)


def test_configs_hold_what_they_reduce():
    used = {w["config"] for w in SPEC["workloads"]}
    for entry in SPEC["configs"]:
        assert entry["name"] in used
        assert entry["file"] == f"gpubench/configs/{entry['name']}.json"
        config = json.loads((ROOT / entry["file"]).read_text())
        assert config["reduced"] == entry["reduced"]
        for key in entry["reduced"]:
            assert key in config["config"]
            assert not key.endswith(("_dim", "_rank")) and not any(w in key for w in WIDTHS)


def test_every_metric_has_a_reader():
    for metric in SPEC["per_layer"]:
        assert callable(harness.load_reader(metric["name"]))
        if metric["unit"] == "%" and ("roofline" in metric["name"] or "mfu" in metric["name"]):
            assert metric["better"] == "higher"


def test_added_files_alone_make_a_new_cell(tmp_path):
    """A configuration, a traffic mix, a cell and a per-layer metric added
    as files and BENCHMARK.json entries are found with no edit."""
    bench = tmp_path / "gpubench"
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(ROOT / "gpubench" / sub, bench / sub)
    spec = json.loads(json.dumps(SPEC))
    config = json.loads((bench / "configs" / "connect4.json").read_text())
    config["config"]["num_simulations"] = 100
    (bench / "configs" / "connect4-sims100.json").write_text(json.dumps(config))
    traffic = json.loads((bench / "traffic" / "selfplay-1024x200.json").read_text())
    traffic["config"]["parallel_games"] = 512
    (bench / "traffic" / "selfplay-512.json").write_text(json.dumps(traffic))
    (bench / "limits" / "connect4-sims100.selfplay-512.json").write_text(
        (bench / "limits" / "connect4.selfplay.json").read_text())
    (bench / "metrics" / "moves_per_call.selfplay.py").write_text(
        "def read(r):\n    return float(r['calls'][0]['moves'])\n")
    spec["workloads"].append({"name": "connect4-sims100.selfplay-512", "config": "connect4-sims100",
                              "traffic": "selfplay-512", "chips": 1, "why": "added"})
    spec["end_to_end"][0]["workloads"].append("connect4-sims100.selfplay-512")
    spec["per_layer"].append({"name": "moves_per_call.selfplay", "unit": "moves",
                              "better": "higher", "source": "program_counter",
                              "layer": "self-play driver", "moves": "selfplay_env_steps_per_s",
                              "workloads": ["connect4-sims100.selfplay-512"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.load_cell("connect4-sims100.selfplay-512", root=tmp_path, bench_dir=bench)
    assert cell.config["config"]["num_simulations"] == 100
    assert cell.config["config"]["parallel_games"] == 512
    assert [m["name"] for m in cell.per_layer] == ["moves_per_call.selfplay"]
    assert {m["name"] for m in cell.end_to_end} == {"selfplay_env_steps_per_s", "setup_s"}
    read = harness.load_reader("moves_per_call.selfplay", bench_dir=bench)
    assert read({"calls": [{"moves": 8}]}) == 8.0


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_no_source_imports_jax_or_the_jax_package():
    """Top-level names compared whole: muzero_general_tpu_torch is the port,
    muzero_general_tpu the JAX package."""
    for path in (ROOT / "gpubench").rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in harness.FORBIDDEN_MODULES, (path, name)


def test_reference_imports_nothing_of_the_port():
    for path in (ROOT / "gpubench" / "reference").rglob("*.py"):
        for name in _imports(path):
            assert not name.startswith("muzero_general_tpu"), (path, name)
    for path in (ROOT / "gpubench" / "yardstick").rglob("*.py"):
        for name in _imports(path):
            assert not name.startswith("muzero_general_tpu"), (path, name)


@pytest.mark.parametrize("loaded, found", [
    (["muzero_general_tpu_torch", "muzero_general_tpu_torch.ops"], []),
    (["muzero_general_tpu.ops.mcts"], ["muzero_general_tpu"]),
    (["jaxlib.xla_client", "jax"], ["jax", "jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["jaxtyping"], []),
])
def test_forbidden_modules_compare_whole_names(monkeypatch, loaded, found):
    import sys

    fake = {name: object() for name in loaded}
    monkeypatch.setattr(sys, "modules", {**{k: v for k, v in sys.modules.items()
                                            if k.split(".")[0] not in harness.FORBIDDEN_MODULES},
                                         **fake})
    assert harness.forbidden_loaded() == found
