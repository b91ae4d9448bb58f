"""BENCHMARK.json against the benchmark's contract, and every name in it
against a file of its own under bench_torch/."""

import json
import re

import pytest

from bench_torch import harness

B = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = B["end_to_end"] + B["per_layer"]


def test_keys_and_sizes():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert 1 <= B["run_seconds"] <= 51
    assert 2 + 14 * 24 * (B["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert B["command"][1].startswith(B["paths"][0] + "/")


def test_names_units_and_text():
    names = [x["name"] for x in B["configs"] + B["workloads"] + METRICS]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in METRICS)
    texts = [w["why"] for w in B["workloads"]] + [c["source"] for c in B["configs"]]
    texts += [m["layer"] for m in B["per_layer"]]
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)
    setup = [m for m in B["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in B["end_to_end"])
    assert all(m["source"] in ("host_clock", "device_trace") for m in B["end_to_end"])


@pytest.mark.parametrize("w", B["workloads"], ids=lambda w: w["name"])
def test_cell_files(w):
    c = harness.load_cell(w["name"])
    assert (harness.HERE / "configs" / f"{c.config}.py").exists()
    gen = c.traffic["generator"]
    assert (harness.HERE / "traffic" / f"{gen}.py").exists()
    assert w["chips"] == 1
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    assert all(m["moves"] in e2e for m in c.per_layer)


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_reader(m):
    assert callable(harness.metric_reader(m["name"]).read)
    cells = {w["name"] for w in B["workloads"]}
    assert set(m.get("workloads", cells)) <= cells


def test_config_files():
    for c in B["configs"]:
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert c["file"].startswith("bench_torch/")
        assert set(c["reduced"]) <= set(cfg), "each reduced key names a key of the file"


def test_imports_stand_alone():
    """Nothing here imports JAX, the JAX package or the repo's old bench
    tools; of the repo, only the port."""
    import ast

    banned = {"jax", "jaxlib", "simdutf_tpu", "bench", "chip_smoke", "tools"}
    for path in harness.HERE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            else:
                continue
            assert not {m.split(".")[0] for m in mods} & banned, (path, mods)
