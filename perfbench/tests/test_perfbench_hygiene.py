"""The benchmark's hygiene: nothing of it imports JAX or the JAX package
(top-level names compared whole: ``horovod_tpu_torch`` begins with
``horovod_tpu``), the reference imports nothing of the port, a run
without the cards or without the program prints no result, and
``BENCHMARK.json`` holds to the form the harness and its check read:
names, keys, units, the cells' pairs of configuration and traffic, and
bounds."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from perfbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}
RUN = ["-m", "perfbench.run", "--workload", "gpt2m_b8", "--seed",
       "3000000123", "--seconds", "1", "--trace", "0"]


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _files(sub=""):
    for d, _, names in os.walk(os.path.join(spec.HERE, sub)):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(d, n)


@pytest.mark.parametrize("name,bad", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax.linen", True), ("horovod_tpu", True), ("horovod_tpu.ops", True),
    ("horovod_tpu_torch", False), ("horovod_tpu_torch.ops", False),
    ("jaxtyping", False), ("flax_like", False), ("torch", False),
])
def test_forbidden_names_are_whole_top_level_names(name, bad):
    assert spec.forbidden_loaded([name]) == ([name] if bad else [])


def test_no_file_imports_jax_or_the_jax_package():
    for path in _files():
        found = spec.forbidden_loaded(list(_imports(path)))
        assert not found, f"{path} imports {found}"


def test_the_reference_imports_nothing_of_the_port():
    for path in _files("reference"):
        port = [m for m in _imports(path)
                if m.split(".")[0] == "horovod_tpu_torch"]
        assert not port, f"{path} imports {port}"
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "import perfbench.reference.gpt2, perfbench.reference.resnet,"
            "perfbench.reference.optim;"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('horovod_tpu_torch', 'horovod_tpu', 'jax', 'jaxlib', 'flax')];"
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code, spec.ROOT],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_run_refuses_without_the_cards():
    """On a machine without the cells' cards the run exits non-zero and
    prints no result (this suite runs on the CPU)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    r = subprocess.run([sys.executable, *RUN], capture_output=True,
                       text=True, timeout=300, cwd=spec.ROOT)
    assert r.returncode != 0
    assert "{" not in r.stdout


def test_run_refuses_in_a_bare_checkout(tmp_path):
    """A directory holding only BENCHMARK.json and perfbench/ has no
    program: the run exits non-zero and prints no result."""
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, *RUN], capture_output=True,
                       text=True, timeout=300, cwd=tmp_path, env=env)
    assert r.returncode != 0
    assert "{" not in r.stdout
    assert "horovod_tpu_torch" in r.stderr


@pytest.fixture(scope="module")
def bench():
    return spec.benchmark()


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    size = os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json"))
    assert size <= 64 * 1024
    assert 1 <= len(bench["command"]) <= 32
    assert all(_line(w) for w in bench["command"])
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51


def test_every_pair_of_configuration_and_traffic_is_given_once(bench):
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs)), pairs


def test_names_are_unique_and_well_formed(bench):
    for group in ("configs", "workloads"):
        names = [e["name"] for e in bench[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(metrics) == len(set(metrics))
    assert all(NAME.match(n) for n in metrics)


def test_configs(bench):
    used = {w["config"] for w in bench["workloads"]}
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    assert 1 <= len(bench["configs"]) <= 24
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert any(c["file"].startswith(p.rstrip("/") + "/")
                   for p in bench["paths"])
        assert os.path.exists(os.path.join(spec.ROOT, c["file"]))
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        with open(os.path.join(spec.ROOT, c["file"])) as f:
            held = json.load(f)
        for key in c["reduced"]:
            # a key changed from the source, never a width
            assert key in held and key in held.get("published", {})
            assert not re.search(r"embd|hidden|inner|intermediate|head|"
                                 r"dim$|rank$|filters|expan|width", key)


def test_workloads(bench):
    configs = {c["name"] for c in bench["configs"]}
    assert 1 <= len(bench["workloads"]) <= 24
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs
        assert NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert _line(w["why"])
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)


def test_metrics(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e and 2 <= len(e2e) <= 16
    assert 1 <= len(bench["per_layer"]) <= 128
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in SOURCES_E2E
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
        assert m["moves"] in e2e
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells


def test_a_full_check_fits_its_time(bench):
    runs = 2 + 14 * 24
    seconds = runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert seconds <= 43200


def test_a_mix_for_other_chips_is_refused(tmp_path):
    from perfbench.tests import tiny
    root = tiny.make(str(tmp_path))
    path = os.path.join(root, "perfbench", "traffic", "tiny-lm.json")
    with open(path) as f:
        mix = json.load(f)
    with open(path, "w") as f:
        json.dump({**mix, "chips": 4}, f)
    with pytest.raises(ValueError, match="for 4 chips"):
        spec.cell("tiny_lm", root)
    with open(path, "w") as f:
        json.dump({**mix, "chips": 1,
                   "global_batch": 3 * mix["batch_per_chip"]}, f)
    with pytest.raises(ValueError, match="global_batch"):
        spec.cell("tiny_lm", root)


def test_every_cell_reports_its_metrics(bench):
    """setup_s, another end-to-end metric and a per-layer metric in
    every cell; a metric's cells report the end-to-end metric it moves;
    the step's share of the peak beside the kernels' rooflines."""
    for w in bench["workloads"]:
        cell = spec.cell(w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        assert all(m["moves"] in e2e for m in cell.per_layer)
        names = {m["name"] for m in cell.per_layer}
        if any(n.endswith("_roofline") for n in names):
            assert any("mfu" in n for n in names)
