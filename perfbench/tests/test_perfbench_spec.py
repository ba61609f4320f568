"""Every cell of BENCHMARK.json resolves, by name alone, to its
workload, configuration, traffic and metric files, and the file keeps to
the contract's shape."""

import json
import re

import pytest

from perfbench import spec

BENCH = json.loads(spec.BENCHMARK.read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = spec.load(cell)
    assert c.config["name"] == c.workload["config"]
    assert c.family in ("mixtral", "bert")
    assert spec.family_module("reference", c.family).leaves(c.config)
    assert spec.family_module("flops", c.family).flops_per_token(
        c.config, c.traffic) > 0
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.reader(m["name"]).read)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    assert set(c.workload["check"]["limits"]) == {
        "loss_gap", "grad_gap", "change_gap", "grad_err"}


def test_configs_name_their_files():
    for cfg in BENCH["configs"]:
        data = json.loads((spec.ROOT.parent / cfg["file"]).read_text())
        assert data["name"] == cfg["name"]
        assert data["source"] == cfg["source"]
        assert sorted(data["reduced"]) == sorted(cfg["reduced"])
        assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


def test_names_units_and_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(CELLS)
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])


def test_unknown_cell_refused():
    with pytest.raises(KeyError):
        spec.load("no-such-cell")
