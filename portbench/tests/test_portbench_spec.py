"""The harness finds cells, configurations and per-layer metrics by name,
and a new one is new files alone."""

import json
import shutil
import time

from portbench.core import harness, spec


def _bench():
    with open(spec.ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_every_cell_of_the_benchmark_has_its_files():
    bench = _bench()
    for cell in bench["workloads"]:
        wl = spec.workload(cell["name"])
        assert (wl["config"], wl["traffic"], wl["chips"], wl["why"]) == \
            (cell["config"], cell["traffic"], cell["chips"], cell["why"])
        cfg = spec.config(wl["config"])
        assert (spec.BENCH / cfg["adapter"]).exists() and (spec.BENCH / cfg["reference"]).exists()
    for cfg in bench["configs"]:
        assert spec.ROOT / cfg["file"] == spec.BENCH / "configs" / f"{cfg['name']}.json"
        assert spec.config(cfg["name"])["source"] == cfg["source"]


def test_every_per_layer_metric_has_a_reader_and_back():
    bench = _bench()
    names = {m["name"] for m in bench["per_layer"]}
    assert names == set(spec.metric_names())
    for m in bench["per_layer"]:
        reader = spec.metric(m["name"])
        assert reader.UNIT == m["unit"] and callable(reader.read)


def test_unknown_names_are_refused():
    for bad in ("no-such-cell", "../configs/pcs", "a b"):
        try:
            spec.workload(bad)
        except (FileNotFoundError, ValueError):
            continue
        raise AssertionError(f"{bad!r} was found")


def test_a_new_cell_config_and_metric_are_new_files_alone(tmp_path, monkeypatch):
    """In a copy of the benchmark's folder: a new configuration (the same
    adapter), a new cell of it at 2^4, and a new metric, added as files; a
    traced run on the CPU finds all three by name."""
    base = tmp_path / "portbench"
    shutil.copytree(spec.BENCH, base, ignore=shutil.ignore_patterns("__pycache__"))
    cfg = json.loads((base / "configs" / "pcs.json").read_text())
    cfg["source"] = "a copy of pcs"
    (base / "configs" / "pcs-copy.json").write_text(json.dumps(cfg))
    wl = json.loads((base / "workloads" / "pcs.seg2p24.json").read_text())
    wl.update(config="pcs-copy", traffic="tiny", log_n=4, pool=2)
    (base / "workloads" / "pcs-copy.tiny.json").write_text(json.dumps(wl))
    (base / "metrics" / "traced_proofs.py").write_text(
        'UNIT = "proofs"\n\n\ndef read(ctx):\n    return ctx.proofs + ctx.phase_proofs\n')
    assert "pcs-copy.tiny" not in [p.stem for p in (spec.BENCH / "workloads").glob("*.json")]
    monkeypatch.setattr(harness, "WARMUP", 1)
    monkeypatch.setattr(harness, "TRACE_PROOFS", 2)
    found = spec.workload("pcs-copy.tiny", base)
    result = harness.run_cell(found, spec.config(found["config"], base), 5, 0.01, True, "cpu",
                              time.perf_counter(), base)
    assert result["correct"], result["checks"]
    assert result["metrics"]["traced_proofs"]["value"] == 4
    assert "phase_ms.queries" in result["metrics"]
