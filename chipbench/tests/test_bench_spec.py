"""``BENCHMARK.json`` against the benchmark's contract, and every file it
names found by name."""
import json
import re
import shutil
import subprocess
import sys

import pytest

from cb import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "chipbench/run.py"]
    assert all(_line(w) for w in bench["command"])
    assert bench["paths"] == ["chipbench"]
    assert all(PATH.match(p) and ".." not in p for p in bench["paths"])
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_configs(bench):
    assert 1 <= len(bench["configs"]) <= 24
    files = set()
    used = {w["config"] for w in bench["workloads"]}
    widths = re.compile(r"(hidden|intermediate|latent|state|projection"
                        r"|_dim$|_rank$|head|expansion|expand|top_k|d_model"
                        r"|d_ff)")
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("chipbench/") and c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and key in cfg
            assert not widths.search(key), key
        recorded = cfg.get("reduced", {})
        assert sorted(recorded) == sorted(c["reduced"])
        for key, (published, run) in recorded.items():
            assert cfg[key] == run != published


def test_workloads(bench):
    cells = bench["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    four = sum(w["chips"] == 4 for w in cells)
    assert four <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        cell = spec.find_cell(w["name"], bench)
        assert cell.chips == w["chips"]
        assert cell.dp in (1, w["chips"])
        assert cell.limits and set(cell.limits) <= {
            "loss_gap", "grad_norm_gap", "grad_leaf_gap", "update_leaf_gap",
            "rank_mismatch"}
        if cell.dp > 1:
            assert cell.limits["rank_mismatch"] == 0


def test_metrics(bench):
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(set(names)) == len(names)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and "setup_s" in e2e
    assert 1 <= len(bench["per_layer"]) <= 128
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m.get("workloads", cells)) <= cells
        assert hasattr(spec.load_metric(m["name"]), "read")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], []).append(m["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for w in bench["workloads"]:
        cell = spec.find_cell(w["name"], bench)
        assert "setup_s" in {m["name"] for m in cell.end_to_end}
        assert len(cell.end_to_end) >= 2 and cell.per_layer


def test_files_under_paths_are_named_from_name_characters():
    for p in spec.BENCH.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(spec.ROOT).as_posix()
        assert PATH.match(rel), rel


def test_an_added_traffic_file_makes_a_cell(tmp_path, bench):
    """A later cell is data only: a traffic file, a limits file and its
    entry in BENCHMARK.json."""
    shutil.copytree(spec.BENCH, tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    traffic = json.loads((spec.BENCH / "workloads"
                          / "b4-s4096-remat.json").read_text())
    traffic.update(batch=8, seq_len=512, why="the host-bound regime")
    traffic["train"]["microbatches"] = 2
    (tmp_path / "chipbench" / "workloads" / "b8-s512-mb2.json").write_text(
        json.dumps(traffic))
    (tmp_path / "chipbench" / "limits" / "qwen2-train-512-mb2.json"
     ).write_text((spec.BENCH / "limits" / "qwen2-train-4k.json").read_text())
    new = dict(bench)
    new["workloads"] = bench["workloads"] + [{
        "name": "qwen2-train-512-mb2", "config": "qwen2-0.5b",
        "traffic": "b8-s512-mb2", "chips": 1, "why": "host-bound"}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    cell = spec.find_cell("qwen2-train-512-mb2", root=tmp_path)
    assert (cell.batch, cell.seq_len) == (8, 512)
    assert cell.traffic["train"]["microbatches"] == 2
    assert cell.config["name"] == "qwen2-0.5b"
    assert {m["name"] for m in cell.per_layer} >= {"mfu", "attn_roofline"}
    assert "moe_roofline" not in {m["name"] for m in cell.per_layer}


def test_run_refuses_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run prints no result and exits with another code than 0."""
    shutil.copytree(spec.BENCH, tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "chipbench/run.py", "--workload",
                        "qwen2-train-4k", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_cells_kept_for_later_are_whole():
    """The four-chip cell that ``BENCHMARK.json`` leaves out has every file
    its entry names, so that adding the entry is all it takes."""
    from cells import with_dp4
    bench = with_dp4()
    for w in bench["workloads"]:
        cell = spec.find_cell(w["name"], bench)
        assert cell.chips == w["chips"] and cell.dp in (1, cell.chips)
        assert NAME.match(w["name"]) and _line(w["why"])
    for m in bench["per_layer"]:
        assert hasattr(spec.load_metric(m["name"]), "read")
        assert set(m.get("workloads", [])) <= {w["name"]
                                               for w in bench["workloads"]}
