"""Everything the harness knows of a cell, found by name.

``BENCHMARK.json`` at the root of the checkout holds only entries. A cell
(an entry of ``workloads``) names a configuration and a traffic mix; from
those names the harness finds, without a list of its own:

- the configuration's file (its ``configs`` entry's ``file``), whose
  ``family`` names ``perfbench/families/<family>.py`` (the program's side:
  how to build the system under test, the leaves the benchmark draws and
  the FLOP count) and ``perfbench/reference/<family>.py`` (the plain
  reference);
- the mix's file, ``perfbench/traffic/<traffic>.json``; a mix that
  states ``chips`` (and ``global_batch``) is for cells of that many chips;
- each per-layer metric that the cell reports (those whose ``workloads``
  list the cell, or that list none): ``perfbench/metrics/<metric>.py``,
  a reader with a ``read(run)`` function (see ``trace.TracedRun``);
- the limits of the check that decides ``correct``:
  ``perfbench/limits/<workload>.json``.

A later change adds a cell, a configuration, a mix or a metric by adding
files and entries; nothing here lists them.
"""

import dataclasses
import importlib
import importlib.util
import json
import os
from typing import Any, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

#: top-level module names that the harness, and the port in its process,
#: must never load: the JAX package and JAX itself
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "horovod_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: Optional[Dict[str, Any]]
    root: str

    @property
    def family(self):
        return importlib.import_module(
            f"perfbench.families.{self.config['family']}")

    @property
    def reference(self):
        return importlib.import_module(
            f"perfbench.reference.{self.config['family']}")


def _read_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _read_json(os.path.join(root, "BENCHMARK.json"))


def _listed(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def cell(workload: str, root: str = ROOT) -> Cell:
    """The cell named ``workload`` with its configuration, mix, metrics
    and limits. Raises KeyError for a name BENCHMARK.json does not hold."""
    bench = benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; it "
                       f"has {sorted(entries)}")
    w = entries[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    conf = configs[w["config"]]
    limits_path = os.path.join(root, "perfbench", "limits",
                               f"{workload}.json")
    chips = int(w["chips"])
    traffic = _read_json(os.path.join(root, "perfbench", "traffic",
                                      f"{w['traffic']}.json"))
    _check_mix(traffic, w["traffic"], chips)
    return Cell(
        name=workload, chips=chips,
        config=_read_json(os.path.join(root, conf["file"])),
        traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _listed(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _listed(m, workload)],
        limits=(_read_json(limits_path) if os.path.exists(limits_path)
                else None),
        root=root)


def _check_mix(traffic: dict, name: str, chips: int) -> None:
    """A mix that states its chips, or its global batch, is run only as
    stated: every chip takes ``batch_per_chip`` rows of the global batch."""
    if traffic.get("chips", chips) != chips:
        raise ValueError(f"traffic {name!r} is for {traffic['chips']} chips, "
                         f"the cell asks for {chips}")
    rows = chips * traffic["batch_per_chip"]
    if traffic.get("global_batch", rows) != rows:
        raise ValueError(f"traffic {name!r}: global_batch "
                         f"{traffic['global_batch']} is not {chips} x "
                         f"{traffic['batch_per_chip']}")


def load_metric(name: str, root: str = ROOT):
    """The reader module of per-layer metric ``name``, loaded from its
    file (a metric's name may hold dots, which a module name may not)."""
    path = os.path.join(root, "perfbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    if not callable(getattr(module, "read", None)):
        raise TypeError(f"metric file {path} has no read(run)")
    return module


def forbidden_loaded(modules) -> List[str]:
    """Names among ``modules`` (such as ``sys.modules``) whose top-level
    name, the part before the first dot, is one of FORBIDDEN_MODULES,
    compared whole: ``horovod_tpu_torch`` is not ``horovod_tpu``."""
    return sorted(m for m in modules
                  if m.split(".", 1)[0] in FORBIDDEN_MODULES)
