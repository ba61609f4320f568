"""A cell of ``BENCHMARK.json`` resolved to its files, all by name:

- ``workloads/<cell>.json``: the configuration, traffic, mesh and chips,
  the steps the check compares and each compared number's limit;
- ``configs/<config>.json``: the model's sizes as they are run, its
  ``family`` (which names ``reference/<family>.py`` and
  ``flops/<family>.py``), the trainer's model flags and the optimizer;
- ``traffic/<traffic>.json``: the batch, sequence length, accumulation
  and the token corpus the general generator (``tokens.py``) writes;
- ``metrics/<metric>.py``: one reader a metric (``read(run)``).

The cell's metrics are the ``end_to_end`` (``--trace 0``) or ``per_layer``
(``--trace 1``) entries of ``BENCHMARK.json`` whose ``workloads`` list
names the cell, or that have no such list."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BENCHMARK = ROOT.parent / "BENCHMARK.json"


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    @property
    def family(self) -> str:
        return self.config["family"]

    def trainer_flags(self, data: str, trainer_seed: int,
                      device: str = "cuda") -> list:
        """The trainer's command line (``cmd/train.py:build_parser``):
        the configuration's model flags, the traffic's batch flags, the
        token file and the mesh."""
        t = self.traffic
        flags = [*self.config["trainer"],
                 "--seq-len", str(t["seq_len"]),
                 "--global-batch", str(t["global_batch"]),
                 "--grad-accum", str(t["grad_accum"]),
                 "--data", data, "--seed", str(trainer_seed),
                 "--device", device]
        if self.workload.get("mesh"):
            flags += ["--mesh", self.workload["mesh"]]
        return flags

    def tokens_per_step(self) -> int:
        t = self.traffic
        return int(t["global_batch"]) * int(t["seq_len"])


def _for_cell(entries: list, cell: str) -> list:
    return [m for m in entries if cell in m.get("workloads", [cell])]


def load(cell: str, benchmark: Path = BENCHMARK) -> Cell:
    """The cell ``cell`` with its files; KeyError when BENCHMARK.json has
    no such cell."""
    bench = _json(benchmark)
    entry = {w["name"]: w for w in bench["workloads"]}.get(cell)
    if entry is None:
        raise KeyError(f"BENCHMARK.json has no workload {cell!r}")
    workload = _json(ROOT / "workloads" / f"{cell}.json")
    config = _json(ROOT / "configs" / f"{entry['config']}.json")
    traffic = _json(ROOT / "traffic" / f"{entry['traffic']}.json")
    if (workload["config"], workload["traffic"], workload["chips"]) != (
            entry["config"], entry["traffic"], entry["chips"]):
        raise ValueError(f"workloads/{cell}.json disagrees with "
                         f"BENCHMARK.json on config, traffic or chips")
    return Cell(cell, workload, config, traffic,
                _for_cell(bench["end_to_end"], cell),
                _for_cell(bench["per_layer"], cell))


def module(path: Path, name: str):
    """The Python file ``path`` as a module named ``name`` (file names of
    metrics may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """``metrics/<metric>.py``: its ``read(run)`` returns the value, or
    None where the run holds nothing for it to read."""
    return module(ROOT / "metrics" / f"{metric}.py",
                  "perfbench_metric_" + metric.replace(".", "_"))


def family_module(kind: str, family: str):
    """``reference/<family>.py`` or ``flops/<family>.py``."""
    return importlib.import_module(f"perfbench.{kind}.{family}")
