"""`BENCHMARK.json` and the files it names keep the benchmark's rules:
names, units, keys, the files found by name, and the check's time budget."""
import re

import pytest

from conftest import ROOT
from perfbench import harness as H

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_command(manifest):
    assert set(manifest) == TOP
    assert manifest["command"] == ["python3", "perfbench/run.py"]
    assert manifest["paths"] == ["perfbench"]
    assert 1 <= manifest["run_seconds"] <= 51 and isinstance(manifest["run_seconds"], int)
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_units_and_lines(manifest):
    names = []
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"]) and LINE.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and LINE.match(w["why"])
        assert w["chips"] in (1, 4)
        names.append(w["name"])
    for key in ("end_to_end", "per_layer"):
        for m in manifest[key]:
            allowed = {"name", "unit", "better", "source", "workloads"}
            allowed |= {"bound"} if key == "end_to_end" else {"layer", "moves"}
            assert set(m) <= allowed and set(m) >= allowed - {"workloads"}
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
            names.append(m["name"])
    assert len(names) == len(set(names))


def test_bounds_and_sources(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer(manifest):
    for w in manifest["workloads"]:
        e2e = [m["name"] for m in H.metrics_of(manifest, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert H.metrics_of(manifest, w["name"], True)
    cells = {w["name"] for w in manifest["workloads"]}
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    for m in manifest["per_layer"]:
        assert set(m["workloads"]) <= cells and m["moves"] in e2e
        for c in m["workloads"]:
            assert c in e2e[m["moves"]].get("workloads", [c])
        assert LINE.match(m["layer"])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_files_are_found_by_name(manifest):
    configs = {c["name"]: c for c in manifest["configs"]}
    for c in configs.values():
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("perfbench/")
        assert H.load_json(ROOT / c["file"])["name"] == c["name"]
    for w in manifest["workloads"]:
        assert w["config"] in configs
        assert (ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "perfbench" / "limits" / f"{w['name']}.json").is_file()
    for m in manifest["per_layer"]:
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_reduced_lists_every_change_and_no_width(manifest):
    widths = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|proj|head|d_model"
                        r"|d_ff|experts_per_token|expand")
    for c in manifest["configs"]:
        cfg = H.load_json(ROOT / c["file"])
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        assert all(cfg["published"][k] != cfg[k] for k in c["reduced"])
        assert not any(widths.search(k) for k in c["reduced"])


def test_a_full_check_fits_its_time(manifest):
    runs = 2 + 14 * 24
    assert runs * (manifest["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("name", ["mfu.learn", "attn_fwd_roofline.learn", "optim_update_ms.learn",
                                  "device_idle.learn", "mfu.serve", "moe_ms.serve",
                                  "infserver_flush_ms.serve", "device_idle.serve"])
def test_a_reader_with_nothing_to_read_returns_nothing(name):
    empty = {"kind": "other", "units": 0, "window_s": 0.0, "busy_s": 0.0, "spans": {},
             "flushes": 0}
    assert H.read_metric(name, empty) is None
