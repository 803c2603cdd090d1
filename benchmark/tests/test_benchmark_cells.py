"""BENCHMARK.json's shape, and every part of a cell found by its name."""

import json
import re

import pytest

from benchmark import cells

BENCH = json.loads((cells.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((cells.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert (cells.ROOT / p).is_dir()
    assert len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word


def test_names_units_and_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(set(names)) == len(names)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for text in [c["source"] for c in BENCH["configs"]] + [
            x["why"] for x in BENCH["configs"] + BENCH["workloads"]] + [
            m["layer"] for m in BENCH["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert "setup_s" in names


def test_config_pairs_once_and_a_quarter_on_four_chips():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(pairs) // 4)


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_by_name(name):
    cell = cells.load(name)
    w = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert cell.config["name"] == w["config"]
    assert cell.traffic["call"] in ("count", "presplit")
    assert cell.traffic["text"] in ("documents", "paragraphs")
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in reported
        assert callable(cells.metric_reader(m["name"]))
    assert cells.reference_class(cell.config).__name__ == "Reference"


def test_every_metric_and_config_has_its_file():
    for m in BENCH["per_layer"]:
        assert (cells.HERE / "metrics" / f"{m['name']}.py").is_file()
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        conf = json.loads((cells.ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        assert conf["guarantees"] and conf["assumed"] is not None
        assert (cells.HERE / "corpora" / f"{conf['corpus']}.json").is_file()
        # every key in reduced is one the source states and the file changes
        for key in conf["reduced"]:
            assert conf[f"source_{key}"] != conf[key]


def test_a_cell_added_by_data_alone(tmp_path):
    """A new workloads entry over existing files loads with no code change."""
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "gpt2-pretok-bytes.doc-presplit-again", "config":
                               "gpt2-pretok-bytes", "traffic": "doc-presplit",
                               "chips": 1, "why": "a test"})
    f = tmp_path / "BENCHMARK.json"
    f.write_text(json.dumps(bench))
    cell = cells.load("gpt2-pretok-bytes.doc-presplit-again", f)
    assert cell.traffic["call"] == "presplit"
    # no workloads key on call_p95_ms' list: the new cell reports only the rest
    assert {m["name"] for m in cell.end_to_end} == {"scan_GBps", "setup_s"}
    with pytest.raises(KeyError):
        cells.load("no.such-cell", f)
