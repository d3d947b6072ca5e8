"""``BENCHMARK.json`` against its contract's rules, and every name it holds
found as a file under its paths."""

from __future__ import annotations

import json
import re

import pytest

from .conftest import REPO, benchmark

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    bench = benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(bench["paths"]) <= 16 and all(PATH.match(p) for p in bench["paths"])
    assert len(bench["command"]) <= 32 and all(_line(w) for w in bench["command"])
    assert not any(w.startswith("/") or ".." in w for w in bench["command"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    # a full check of 24 cells fits into 12 hours
    assert 2 + 14 * 24 * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_keys():
    bench = benchmark()
    metrics = bench["end_to_end"] + bench["per_layer"]
    for group in (bench["configs"], bench["workloads"], metrics):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4) and _line(w["why"])
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_every_cell_reports_what_the_contract_asks():
    bench = benchmark()
    for w in bench["workloads"]:
        e2e = {m["name"] for m in bench["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])}
        layers = [m for m in bench["per_layer"] if w["name"] in m.get("workloads", [])]
        assert "setup_s" in e2e and len(e2e) >= 2 and layers
        assert all(m["moves"] in e2e for m in layers)
    setup = {m["name"]: m for m in bench["end_to_end"]}["setup_s"]
    assert setup["bound"] == 0.25 and "workloads" not in setup


def test_every_name_has_its_file():
    bench = benchmark()
    base = REPO / bench["paths"][0]
    for c in bench["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        mix = json.loads((base / "traffic" / f"{w['traffic']}.json").read_text())
        assert (base / "drivers" / f"{mix['driver']}.py").is_file()
        assert (base / "checks" / f"{w['name']}.json").is_file()
    for m in bench["per_layer"]:
        assert (base / "layers" / f"{m['name']}.py").is_file()


@pytest.mark.parametrize("name", ["moments_roofline", "mfu"])
def test_shares_of_a_peak_are_named_so(name):
    units = {m["name"]: m["unit"] for m in benchmark()["per_layer"]}
    assert all(units[k] == "%" for k in units if k.endswith(name))
