"""``BENCHMARK.json`` and every file it names: the contract's names,
units and limits, the metrics' ``moves`` and ``workloads``, and that a
configuration, a traffic mix and a per-layer metric are added as new
files and new entries, with no file that exists edited."""

import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from h100bench import loops, run

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and "\n" not in text and "\t" not in text


def test_top_level(bench):
    assert set(bench) == KEYS
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    assert 1 <= len(bench["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in bench["command"])
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    cells = 24  # the most a benchmark may grow to, at this run_seconds
    runs = 2 + 14 * cells
    assert runs * (bench["run_seconds"] + 60) + cells * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entries(bench):
    seen = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"}),
                        ("end_to_end", {"name", "unit", "better", "bound",
                                        "source", "workloads"}),
                        ("per_layer", {"name", "unit", "better", "source",
                                       "layer", "moves", "workloads"})):
        assert 1 <= len(bench[group]) <= {"configs": 24, "workloads": 24,
                                          "end_to_end": 16,
                                          "per_layer": 128}[group]
        for e in bench[group]:
            assert set(e) <= keys, (group, e["name"])
            assert NAME.match(e["name"]), e["name"]
            assert (group, e["name"]) not in seen
            seen.add((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            if "why" in e:
                assert _line(e["why"])
            if "layer" in e:
                assert _line(e["layer"])
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_configs_files_and_cells(bench):
    paths = bench["paths"]
    cells = bench["workloads"]
    files = set()
    for c in bench["configs"]:
        assert any(c["file"].startswith(p + "/") for p in paths)
        assert c["file"] == f"h100bench/configs/{c['name']}.json"
        assert c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert _line(c["source"])
        assert any(w["config"] == c["name"] for w in cells), c["name"]
        assert (ROOT / cfg["preset"]).is_file()
    pairs = set()
    names = {c["name"] for c in bench["configs"]}
    for w in cells:
        assert w["config"] in names
        assert NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        traffic = json.loads((ROOT / "h100bench/traffic"
                              / f"{w['traffic']}.json").read_text())
        assert traffic["kind"] in loops.KINDS
        limits = json.loads((ROOT / "h100bench/limits"
                             / f"{w['name']}.json").read_text())
        assert limits and all(v > 0 for v in limits.values())
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)


def test_every_cell_reports_what_it_must(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for w in bench["workloads"]:
        reported = {m["name"] for m in run.cell_entries(
            bench, w["name"], "end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2, w["name"]
        assert run.cell_entries(bench, w["name"], "per_layer"), w["name"]
    for m in bench["end_to_end"]:
        for cell in m.get("workloads", []):
            assert cell in {w["name"] for w in bench["workloads"]}


def test_per_layer_metrics_move_a_reported_metric(bench):
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        assert m["workloads"], m["name"]
        for cell in m["workloads"]:
            assert cell in cells
            reported = {e["name"] for e in run.cell_entries(
                bench, cell, "end_to_end")}
            assert m["moves"] in reported, (m["name"], cell)
        reader = run.load_metric(m["name"])
        assert callable(reader.read)
    layers = {}
    for m in bench["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def _digest(root: Path):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()}


def test_cells_and_metrics_are_added_as_files(tmp_path):
    """A new configuration, traffic mix, cell, limits and per-layer metric
    are new files and new entries; the harness finds them by name and no
    existing file of the benchmark changes."""
    shutil.copytree(ROOT / "h100bench", tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    before = _digest(tmp_path / "h100bench")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    cfg = json.loads((tmp_path / "h100bench/configs/aff_mini.json")
                     .read_text())
    cfg["name"] = "aff_mini_twin"
    new = {
        "h100bench/configs/aff_mini_twin.json": json.dumps(cfg),
        "h100bench/traffic/infer.b8.json": json.dumps({
            "kind": "infer_batch", "batch": 8, "pool": 8,
            "warmup_calls": 8, "check_calls": 8, "trace_steps": 5}),
        "h100bench/limits/aff_mini_twin.infer.b8.json":
            json.dumps({"logit_gap": 0.03}),
        "h100bench/metrics/busy_ms.infer.py":
            "def read(run):\n    return run.summary['busy_s'] * 1e3\n",
    }
    for rel, text in new.items():
        (tmp_path / rel).write_text(text)
    bench["configs"].append({"name": "aff_mini_twin",
                             "source": cfg["source"],
                             "file": "h100bench/configs/aff_mini_twin.json",
                             "reduced": cfg["reduced"], "why": "a twin"})
    bench["workloads"].append({"name": "aff_mini_twin.infer.b8",
                               "config": "aff_mini_twin",
                               "traffic": "infer.b8", "chips": 1,
                               "why": "closed-loop forwards at b8"})
    for m in bench["end_to_end"]:
        if m["name"] == "infer_img_s":
            m["workloads"].append("aff_mini_twin.infer.b8")
    bench["per_layer"].append({"name": "busy_ms.infer", "unit": "ms",
                               "better": "lower", "source": "device_trace",
                               "layer": "device", "moves": "infer_img_s",
                               "workloads": ["aff_mini_twin.infer.b8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json, h100bench.run as r, h100bench.loops as l\n"
        "b = r.load_json(r.Path('BENCHMARK.json'))\n"
        "c = 'aff_mini_twin.infer.b8'\n"
        "e = [m['name'] for m in r.cell_entries(b, c, 'end_to_end')]\n"
        "p = [m['name'] for m in r.cell_entries(b, c, 'per_layer')]\n"
        "t = r.load_json(r.HERE / 'traffic' / 'infer.b8.json')\n"
        "class S: summary = {'busy_s': 0.5}\n"
        "print(json.dumps([e, p, t['kind'] in l.KINDS, "
        "r.load_metric('busy_ms.infer').read(S), str(r.HERE)]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    e, p, known, value, here = json.loads(out.stdout.strip().splitlines()[-1])
    assert e == ["infer_img_s", "peak_mem_gib", "setup_s"]
    assert p == ["busy_ms.infer"]
    assert known and value == 500.0
    assert Path(here) == tmp_path / "h100bench"
    after = _digest(tmp_path / "h100bench")
    assert {k: v for k, v in after.items() if k in before} == before
