"""``BENCHMARK.json`` against the files it names and the rules its fields
keep: names, units and lines within their characters, every cell's files
there, every configuration the recipe it names, the chip time of a full
check within its limit."""

import json
import re
import shutil

import pytest

from harness.spec import HERE, load_cell, load_json

ROOT = HERE.parent
B = load_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_command_and_paths():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(B["command"]) <= 32 and all(_line(w) for w in
                                                B["command"])
    assert 1 <= len(B["paths"]) <= 16
    for p in B["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.rstrip("/").endswith("_torch")
    script = B["command"][1]
    assert any(script.startswith(p + "/") for p in B["paths"])
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    # a full check of 24 cells fits its 43200 s
    assert ((2 + 14 * 24) * (B["run_seconds"] + 60) + 24 * 2 * 90 + 1200
            <= 43200)
    assert len(json.dumps(B)) <= 64 * 1024


def test_names_units_and_keys():
    names = []
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
        assert any(c["file"].startswith(p + "/") for p in B["paths"])
        names.append(c["name"])
    assert len(set(names)) == len(names)
    cells = []
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _line(w["why"])
        cells.append((w["config"], w["traffic"]))
    assert len(set(cells)) == len(cells)
    assert {w["config"] for w in B["workloads"]} == set(names)
    metric_names = []
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        metric_names.append(m["name"])
    assert "setup_s" in metric_names
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in metric_names and _line(m["layer"])
        metric_names.append(m["name"])
    for m in B["end_to_end"] + B["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert (HERE / "metrics" / f"{m['name']}.py").exists()
        for cell in m.get("workloads", []):
            assert cell in [w["name"] for w in B["workloads"]]
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(set(metric_names)) == len(metric_names)


@pytest.mark.parametrize("w", B["workloads"], ids=lambda w: w["name"])
def test_every_cell_finds_its_files_and_reports_enough(w):
    cell = load_cell(B, w["name"])
    e2e = [m["name"] for m in cell.metrics(False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.metrics(True)
    assert (HERE / "traffic" / f"{cell.mix['kind']}.py").exists()
    assert (HERE / "reference" / f"{cell.config['reference']}.py").exists()
    assert set(cell.params["limits"]) >= {"logit_gap", "stop_gap"}
    assert all(v > 0 for v in cell.params["limits"].values())
    assert list(cell.counts) == cell.params["counts"]


def test_a_count_added_later_changes_no_cell(tmp_path):
    for part in ("configs", "traffic", "workloads", "counts"):
        shutil.copytree(HERE / part, tmp_path / part)
    (tmp_path / "counts" / "later_kernel.py").write_text(
        "SYMBOLS = ('later_kernel',)\nOPERANDS = 'f32'\nLIBRARY = 'later'\n"
        "COUNTER = None\n\ndef count(hp, call):\n    return 1, 10 ** 12\n")
    for w in B["workloads"]:
        assert (list(load_cell(B, w["name"], base=tmp_path).counts)
                == list(load_cell(B, w["name"]).counts))


@pytest.mark.parametrize("c", B["configs"], ids=lambda c: c["name"])
def test_configuration_is_its_recipe_unchanged(c):
    config = load_json(ROOT / c["file"])
    recipe = load_json(ROOT / config["recipe"])
    changed = {k for k in set(recipe) | set(config["hparams"])
               if recipe.get(k) != config["hparams"].get(k)}
    assert changed == set(c["reduced"]) == set(config["reduced"])
    assert config["source"] == c["source"]
    assert "stop_token_bias" in config["assumed"]


def test_files_under_paths_are_named_from_name_characters():
    for p in B["paths"]:
        for f in (ROOT / p).rglob("*"):
            if "__pycache__" in f.parts or not f.is_file():
                continue
            rel = f.relative_to(ROOT).as_posix()
            assert all(NAME.match(part) for part in rel.split("/")), rel
