"""The benchmark's files on the CPU: ``BENCHMARK.json`` keeps to its
contract, every cell finds its configuration, traffic and metrics by
name, the genome stream is seeded and never repeats, and nothing a run
imports is JAX or the JAX package."""
import ast
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from bench import harness
from bench.traffic.generator import GenomeStream, canonical_genomes, load_mix

ROOT = harness.ROOT
SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [c["name"] for c in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert 1 <= len(SPEC["command"]) <= 32
    assert all(_line(w) for w in SPEC["command"])
    for w in SPEC["command"][1:]:
        if os.path.exists(os.path.join(ROOT, w)):
            assert any(w.startswith(p + "/") for p in SPEC["paths"])
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024


@pytest.mark.parametrize("entry", SPEC["configs"] + SPEC["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names_and_lines(entry):
    assert NAME.match(entry["name"])
    for k in ("why", "layer", "source"):
        if k in entry:
            assert _line(entry[k]), k
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for k in ("config", "traffic"):
        if k in entry:
            assert NAME.match(entry[k])
    for k in entry.get("reduced", ()):
        assert NAME.match(k)


def test_unique_names_and_shapes():
    for group in (SPEC["configs"], SPEC["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(c["config"], c["traffic"]) for c in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
        assert any(c["file"].startswith(p + "/") for p in SPEC["paths"])
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_files_by_name(cell):
    c = harness.load_cell(cell)
    config = harness.load_config(c)
    assert config["name"] == c["config"]
    assert config["reference"] in ("exact", "scan")
    mix = load_mix(c["traffic"])
    assert mix["genomes_per_call"] >= 1
    names = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert c["per_layer"]
    for m in c["end_to_end"] + c["per_layer"]:
        assert callable(harness.reader(m["name"]).read)


def test_stream_is_seeded_and_never_repeats():
    mix = {"generator": "sweep", "genomes_per_call": 300,
           "families": ["homo", "hetero_bl", "hetero_bls"],
           "pool_calls": 2}
    seed = 2 ** 33 + 17
    a, b = GenomeStream(mix, seed), GenomeStream(mix, seed)
    calls = [a.next_call() for _ in range(5)]   # 3 past set-up's pool
    for c in calls:
        assert np.array_equal(c, b.next_call())
        assert c.shape == (300, 43) and c.dtype == np.int64
        assert np.bincount(c[:, 0], minlength=3).tolist() == [100] * 3
    canon = canonical_genomes(np.concatenate(calls))
    assert len(np.unique(canon, axis=0)) == len(canon)
    other = GenomeStream(mix, seed + 1).next_call()
    assert not np.array_equal(other, calls[0])


def test_forbidden_names_compare_whole(monkeypatch):
    assert {"jax", "jaxlib", "flax", "repro"} <= set(harness.FORBIDDEN)
    # a probe name, so that what earlier tests loaded does not count
    monkeypatch.setattr(harness, "FORBIDDEN", ("probe_pkg",))
    monkeypatch.setitem(sys.modules, "probe_pkg_torch", sys)
    monkeypatch.setitem(sys.modules, "probe_pkg_torch.core", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "probe_pkg.numpy", sys)
    assert harness.forbidden_modules() == ["probe_pkg"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_under_bench_imports_jax_or_repro():
    bad = []
    for dirpath, _, files in os.walk(harness.BENCH):
        for f in files:
            if f.endswith(".py"):
                p = os.path.join(dirpath, f)
                for name in _imports(p):
                    if name.split(".")[0] in harness.FORBIDDEN:
                        bad.append((p, name))
    assert bad == []


def test_modules_a_run_loads_are_not_jax_or_repro():
    code = (
        "import sys; sys.path[0:1] = [sys.argv[1], sys.argv[1] + '/src']\n"
        "from bench import harness, control, devtrace\n"
        "from bench.reference import rows, model, simulate\n"
        "import repro_torch.core.dse.engine, repro_torch.core.dse.api\n"
        f"for c in {CELLS!r}:\n"
        "    for m in harness.load_cell(c)['end_to_end'] + "
        "harness.load_cell(c)['per_layer']:\n"
        "        harness.reader(m['name'])\n"

        "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code, ROOT],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
