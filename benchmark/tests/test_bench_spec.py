"""BENCHMARK.json and the files it names: each configuration's file names
its source, `reduced` and `assumed`; every cell's traffic and every
per-layer metric has its file; names keep to the contract's letters."""
from __future__ import annotations

import importlib.util
import json
import os
import re

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    SPEC = json.load(_f)


def test_each_config_file_names_source_reduced_and_assumed():
    for c in SPEC["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["name"] == c["name"]
        assert conf["source"] == c["source"] and len(c["source"]) <= 200
        assert conf["reduced"] == c["reduced"]
        assert conf["assumed"]
        for k in c["reduced"]:
            assert k in conf and k in conf["why_reduced"]
        s = conf["set"]
        assert len(s["per_chrom"]) == s["n_chroms"] == conf["n_chroms"]
        assert s["n_blocks"] == conf["n_blocks"]


def test_every_cell_has_its_traffic_and_config():
    configs = {c["name"] for c in SPEC["configs"]}
    for w in SPEC["workloads"]:
        assert w["config"] in configs and w["chips"] == 1
        with open(os.path.join(BENCH, "traffic", w["traffic"] + ".json")) as f:
            assert json.load(f)["subcommand"] == "methphase"
        assert len(w["why"]) <= 200


def test_every_metric_has_a_reader_and_a_good_name():
    for m in SPEC["per_layer"]:
        path = os.path.join(BENCH, "metrics", m["name"] + ".py")
        spec = importlib.util.spec_from_file_location("m", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert callable(mod.read)
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
    for w in SPEC["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])


def test_every_cell_reports_what_its_per_layer_metrics_move():
    cells = {w["name"] for w in SPEC["workloads"]}
    reports = {w: {m["name"] for m in SPEC["end_to_end"]
                   if w in m.get("workloads", [w])} for w in cells}
    for w in cells:
        assert "setup_s" in reports[w] and len(reports[w]) >= 2
    for m in SPEC["per_layer"]:
        for w in m.get("workloads", sorted(cells)):
            assert w in cells and m["moves"] in reports[w], (m["name"], w)
    for w in cells:
        assert any(w in m.get("workloads", [w]) for m in SPEC["per_layer"])


def test_a_reader_that_finds_nothing_returns_nothing():
    rec = dict(window_s=10.0, passes=1, window_reads=0, stage_s={},
               busy_s=0.0, hbm_bytes_per_s=3.35e12,
               loop_kernel=dict(launches=0, bytes=0, device_s=0.0))
    for m in SPEC["per_layer"]:
        path = os.path.join(BENCH, "metrics", m["name"] + ".py")
        spec = importlib.util.spec_from_file_location("m", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert mod.read(rec) is None
