"""BENCHMARK.json against the benchmark's contract, and the files each
entry names."""
import json
import re

import pytest

from bench import harness

ROOT = harness.ROOT
B = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
LINE = re.compile(r"[^\t\n\r]{1,200}")
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys_and_sizes():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["paths"] == ["bench"] and B["command"][1] == "bench/run.py"
    assert 1 <= B["run_seconds"] <= 51
    cells = len(B["workloads"])
    # a full check with 24 cells fits its 43200 seconds
    assert 1200 + 24 * 180 + (2 + 14 * 24) * (B["run_seconds"] + 60) <= 43200
    assert 1 <= cells <= 24
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in B[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.fullmatch(n), n
    for c in B["workloads"]:
        assert NAME.fullmatch(c["traffic"]) and LINE.fullmatch(c["why"])
        assert set(c) == {"name", "config", "traffic", "chips", "why"}
        assert c["chips"] in (1, 4)
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.fullmatch(k) for k in c["reduced"])
        assert LINE.fullmatch(c["source"]) and LINE.fullmatch(c["why"])
    for m in B["end_to_end"] + B["per_layer"]:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower",
                                                             "higher")
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert LINE.fullmatch(m["layer"])
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [c["name"] for c in B["workloads"]])
def test_every_cell_finds_its_files_and_reports_enough(cell):
    c = harness.load_cell(cell)
    e2e = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2 and c["per_layer"]
    for m in c["end_to_end"] + c["per_layer"]:
        assert callable(harness.reader(m["name"]))
    moved = {m["moves"] for m in c["per_layer"]}
    assert moved <= e2e
    from repro_torch.configs.base import ModelConfig
    from repro_torch.serving import EngineConfig
    cfg = c["config"]
    EngineConfig(model=ModelConfig(**cfg["model"]), policy=cfg["policy"],
                 device="cpu", **cfg["engine"])
    assert set(cfg["reduced"]) <= set(cfg["model"]) | set(cfg["published"])
    assert c["traffic"]["loop"] in ("open", "closed")


def test_configs_hold_their_files():
    files = [c["file"] for c in B["configs"]]
    assert len(set(files)) == len(files)
    for c in B["configs"]:
        assert c["file"].startswith("bench/")
        f = json.loads((ROOT / c["file"]).read_text())
        assert f["name"] == c["name"] and f["source"] == c["source"]
        assert f["reduced"] == c["reduced"]
    used = {c["config"] for c in B["workloads"]}
    assert used == {c["name"] for c in B["configs"]}


@pytest.mark.parametrize("config", [c["name"] for c in B["configs"]])
def test_every_configuration_names_a_whole_architecture(config):
    entry = next(c for c in B["configs"] if c["name"] == config)
    name = json.loads((ROOT / entry["file"]).read_text()).get("arch",
                                                              "decoder")
    assert NAME.fullmatch(name)
    assert (ROOT / "bench" / "archs" / f"{name}.py").is_file()
    mod = harness.arch(name)
    for api in harness.ARCH_API:
        assert callable(getattr(mod, api)), api
