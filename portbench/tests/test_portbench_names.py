"""BENCHMARK.json against the contract's character and shape rules, and
every file it names present."""

import ast
import re

from conftest import PORTBENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_names_and_units(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"])
        assert TEXT.match(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k]), w[k]
        assert TEXT.match(w["why"]) and w["chips"] in (1, 4)
        names.append(w["name"])
    metrics = bench["end_to_end"] + bench["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert TEXT.match(m["layer"])
    assert len({c["name"] for c in bench["configs"]}) == len(bench["configs"])
    assert len({w["name"] for w in bench["workloads"]}) \
        == len(bench["workloads"])
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    for word in bench["command"]:
        assert TEXT.match(word) and not word.startswith("/")
    for p in bench["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p


def test_every_named_file_exists(bench):
    cells = {w["name"]: w for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("portbench/")
    for w in cells.values():
        assert (PORTBENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (PORTBENCH / "limits" / f"{w['name']}.json").is_file()
    for m in bench["per_layer"]:
        assert (PORTBENCH / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            reported = e2e[m["moves"]].get("workloads", cells)
            assert cell in reported, (m["name"], cell)
    for w in cells.values():
        reports = [m for m in e2e.values()
                   if w["name"] in m.get("workloads", cells)]
        assert len(reports) >= 2          # setup_s and one other
        assert any(w["name"] in m.get("workloads", cells)
                   for m in bench["per_layer"])


def test_files_under_paths_are_named_from_name_characters():
    for p in PORTBENCH.rglob("*"):
        if ".cache" in p.parts or "__pycache__" in p.parts:
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


BANNED = {"jax", "jaxlib", "flax", "ganlab_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


def test_no_jax_anywhere_under_portbench():
    """Top-level module names compared whole: ganlab_tpu_torch passes,
    ganlab_tpu fails."""
    for path in PORTBENCH.rglob("*.py"):
        for mod in _imports(path):
            assert mod.split(".")[0] not in BANNED, (path, mod)


def test_reference_imports_nothing_of_the_program():
    for path in (PORTBENCH / "reference").rglob("*.py"):
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top in {"__future__", "dataclasses", "math", "statistics",
                           "numpy", "torch", "portbench"}, (path, mod)
            if top == "portbench":
                assert mod.startswith("portbench.reference"), (path, mod)


def test_whole_name_comparison():
    """The run's own check (``run.BANNED``) compares whole top-level
    names."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("pb_run_names",
                                                  PORTBENCH / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    mods = ["ganlab_tpu_torch.ops", "portbench.trace", "torch"]
    assert not {n.split(".")[0] for n in mods} & set(run.BANNED)
    assert {n.split(".")[0] for n in ["ganlab_tpu.models"]} & set(run.BANNED)
