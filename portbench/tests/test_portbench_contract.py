"""BENCHMARK.json against the contract's limits on names and units, and
the cells' files found by name."""

import json
import os
import re
import shutil

import pytest

from portbench import registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = registry.benchmark()


def names():
    out = [("config", c["name"]) for c in BENCH["configs"]]
    out += [("workload", w["name"]) for w in BENCH["workloads"]]
    out += [("traffic", w["traffic"]) for w in BENCH["workloads"]]
    out += [("config ref", w["config"]) for w in BENCH["workloads"]]
    out += [(kind, m["name"]) for kind in ("end_to_end", "per_layer")
            for m in BENCH[kind]]
    out += [("reduced", k) for c in BENCH["configs"] for k in c["reduced"]]
    return out


@pytest.mark.parametrize("kind,name", names())
def test_names_use_only_the_allowed_characters(kind, name):
    assert NAME.match(name), (kind, name)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_keys_units_and_directions(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    extra = set(metric) - {"name", "unit", "better", "bound", "source",
                           "layer", "moves", "workloads"}
    assert not extra
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", [])) <= cells
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        e2e = {m["name"] for m in BENCH["end_to_end"]}
        assert metric["moves"] in e2e
        assert metric["layer"] and "\n" not in metric["layer"]


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert len(json.dumps(BENCH)) <= 64 * 1024
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(BENCH["paths"][0] + "/")


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_resolves_its_files_by_name(cell):
    cfg = registry.config(cell["config"])
    traffic = registry.traffic(cell["traffic"])
    limits = registry.limits(cell["name"])["limits"]
    assert cfg["dtype"] == "bfloat16" and traffic["streams"] >= 1
    assert limits
    per_layer = registry.cell_metrics(BENCH, cell["name"], "per_layer")
    assert per_layer
    for m in per_layer:
        assert callable(registry.metric_reader(m["name"]))
    e2e = {m["name"] for m in registry.cell_metrics(BENCH, cell["name"],
                                                    "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2


def test_new_files_are_found_without_editing_any(tmp_path, monkeypatch):
    """A configuration, a traffic mix, limits and a metric dropped into a
    copy of the folder are found by name, every old file unchanged; the
    configuration's ``models`` entries alone choose its networks: here
    ResNeSt-101's body (FastReIDSBS at 3, 4, 23, 3 blocks, deep stem 64),
    built, counted and sized with no list of architectures edited."""
    from portbench import counts, networks, run

    here = tmp_path / "portbench"
    shutil.copytree(registry.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in here.rglob("*") if p.is_file()}
    cfg = registry.config("yolox_x-mot17_sbs_s50_256")
    cfg["models"]["body"] = dict(
        cfg["models"]["body"],
        args={"stage_blocks": [3, 4, 23, 3], "stem_width": 64})
    (here / "configs" / "new_cfg.json").write_text(json.dumps(cfg))
    (here / "traffic" / "new_mix.json").write_text(json.dumps(
        {"streams": 2, "tracker": {"max_dets": 50}}))
    (here / "limits" / "new.cell.json").write_text(
        json.dumps({"limits": {"det_gap": 0.1}}))
    (here / "metrics" / "new.metric_ms.py").write_text(
        "def read(rec):\n    return rec['x'] * 2\n")
    monkeypatch.setattr(registry, "HERE", str(here))
    new_cfg = registry.config("new_cfg")
    body = networks.reference(new_cfg)[1]
    assert body.ResNeSt50_0.n_blocks == 33
    assert body.ResNeSt50_0._ConvBN_2.Conv_0.out_channels == 128
    old_body = counts.cell_counts(
        registry.config("yolox_x-mot17_sbs_s50_256"))["body"]
    new_body = counts.cell_counts(new_cfg)["body"]
    assert new_body["flops"] > 1.5 * old_body["flops"]
    traffic = registry.traffic("new_mix")
    assert traffic["streams"] == 2
    assert run.settings_of(new_cfg, traffic).body_feature_dim == 2048
    assert registry.limits("new.cell")["limits"] == {"det_gap": 0.1}
    assert registry.metric_reader("new.metric_ms")({"x": 3}) == 6
    assert all(p.read_bytes() == b for p, b in before.items())


def test_missing_file_is_an_error(monkeypatch):
    with pytest.raises(FileNotFoundError):
        registry.traffic("no_such_mix")
    with pytest.raises(FileNotFoundError):
        registry.metric_reader("no.such.metric")


def test_command_and_paths_stay_inside_the_benchmark():
    assert BENCH["paths"] == ["portbench"]
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word
    assert os.path.isfile(os.path.join(registry.ROOT, BENCH["command"][1]))
