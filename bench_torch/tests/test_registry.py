"""The harness finds every piece of a cell by the names in
``BENCHMARK.json``: a new configuration, traffic mix, metric and limits
come as new files and new entries, and run without an edit to any file
already there. A run without a card, or without the program, prints no
result."""

import json
from pathlib import Path
import shutil
import subprocess
import sys

import torch

from bench_torch import harness

from .small import SMALL, run_small

REPO = Path(__file__).resolve().parents[2]
DRIVER = """
import json, sys, time
sys.path.insert(0, {root!r})
from bench_torch import harness
out = {{}}
for name in ("newcfg.sparse", "newell.fewmonths"):
    cell = harness.find_cell(name)
    out[name] = harness.run(cell, 5, 0.2, False, "cpu", time.perf_counter(),
                            need_card=False, log=lambda *a, **k: None)
print(json.dumps(out))
"""
NEW_ENTRY = """
\"\"\"A test's entry: a month's simple kriging.\"\"\"
from glomargridding_tpu_torch import kriging_from_kernel

from bench_torch.entries import kriging
from bench_torch.families.stationary import build

REFERENCE = "plain_simple"


class Entry(kriging.Entry):
    def __call__(self, k):
        s = self.state
        idx, y, E = self.pool[k]
        out = kriging_from_kernel(
            s.kernel, s.lat, s.lon, idx, y, error_cov=E,
            variance=s.variance, method="simple",
            n_blocks=self.cfg["n_blocks"])
        return out, self.work(idx.shape[0])
"""
NEW_REFERENCE = """
\"\"\"A test's reference: simple kriging, whatever the configuration
says.\"\"\"
from bench_torch.reference import stationary


def kriging_fields(cfg, *args, method):
    return stationary.kriging_fields(cfg, *args, method="simple")
"""


def checkout(tmp_path):
    """A checkout of the benchmark and the program under tmp_path."""
    shutil.copytree(REPO / "bench_torch", tmp_path / "bench_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "glomargridding_tpu_torch").symlink_to(
        REPO / "glomargridding_tpu_torch")
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return tmp_path


def snapshot(root):
    return {p: p.read_bytes() for p in (root / "bench_torch").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def add_files(b):
    """A stationary cell on a new entry and reference, and an ellipse
    cell whose configuration names the stream operator with a cutoff, as
    new files under the checkout's bench_torch `b`."""
    cfg = json.loads((b / "configs/glomar_1deg_stationary.json").read_text())
    cfg.update(name="newcfg", grid={"step_deg": 12.0}, n_blocks=2)
    (b / "configs/newcfg.json").write_text(json.dumps(cfg))
    (b / "entries/kriging_simple.py").write_text(NEW_ENTRY)
    (b / "reference/plain_simple.py").write_text(NEW_REFERENCE)
    (b / "traffic/sparse.json").write_text(json.dumps({
        "entry": "kriging_simple", "pool": 2, "compare": 2, "laws": {
            "m": {"law": "uniform", "low": 10, "high": 30,
                  "integer": True}}}))
    (b / "metrics/median_latency_s.py").write_text(
        "import statistics\n\n\ndef read(ctx):\n"
        "    return statistics.median(ctx.latencies)\n")
    (b / "limits/newcfg.sparse.json").write_text(json.dumps({
        "field_err": 1e-3, "uncertainty_err": 1e-3, "mask_err": 1e-3}))
    ell = json.loads((b / "configs/glomar_1deg_ellipse.json").read_text())
    ell.update(name="newell", grid={"step_deg": 9.0}, store="stream",
               max_dist_km=3000.0, members=4, pad_rank=16,
               clip={**ell["clip"], "k0": 64, "max_rank": 512,
                     "rank_multiple": 8})
    (b / "configs/newell.json").write_text(json.dumps(ell))
    (b / "traffic/fewmonths.json").write_text(json.dumps({
        "entry": "month", "pool": 2, "compare": 2, "laws": {
            "m": {"law": "uniform", "low": 20, "high": 40,
                  "integer": True}}}))
    (b / "limits/newell.fewmonths.json").write_text(json.dumps({
        "eig_res": 1e-2, "field_err": 1e-3, "uncertainty_err": 1e-3,
        "mask_err": 1e-3, "members_err": 1e-3}))


def test_new_files_and_entries_are_found_by_name(tmp_path):
    root = checkout(tmp_path)
    before = snapshot(root)
    add_files(root / "bench_torch")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for name in ("newcfg", "newell"):
        bench["configs"].append({"name": name, "source": "a test",
                                 "file": f"bench_torch/configs/{name}.json",
                                 "reduced": [], "why": "a test"})
    bench["workloads"] += [
        {"name": "newcfg.sparse", "config": "newcfg", "traffic": "sparse",
         "chips": 1, "why": "a test"},
        {"name": "newell.fewmonths", "config": "newell",
         "traffic": "fewmonths", "chips": 1, "why": "a test"}]
    bench["end_to_end"].append({
        "name": "median_latency_s", "unit": "s", "better": "lower",
        "bound": 0.05, "source": "host_clock",
        "workloads": ["newcfg.sparse", "newell.fewmonths"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    run = subprocess.run([sys.executable, "-c", DRIVER.format(root=str(root))],
                         cwd=root, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    results = json.loads(run.stdout.strip().splitlines()[-1])
    for name, result in results.items():
        assert result["correct"], (name, result["checks"])
        # analyses_per_s lists its cells, so the new cells have only these
        assert set(result["metrics"]) == {"setup_s", "median_latency_s"}
    assert "eig_res" in results["newell.fewmonths"]["checks"]
    after = snapshot(root)
    assert all(after[p] == data for p, data in before.items())


def test_the_new_entry_reaches_its_own_reference(tmp_path):
    """The simple-kriging entry judged by the ordinary reference is not
    correct: the reference is the one the entry names."""
    root = checkout(tmp_path)
    b = root / "bench_torch"
    add_files(b)
    (b / "reference/plain_simple.py").write_text(
        "from bench_torch.reference.stationary import kriging_fields\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "newcfg", "source": "a test",
                             "file": "bench_torch/configs/newcfg.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "newcfg.sparse", "config": "newcfg",
                               "traffic": "sparse", "chips": 1,
                               "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    driver = DRIVER.format(root=str(root)).replace(
        '("newcfg.sparse", "newell.fewmonths")', '("newcfg.sparse",)')
    run = subprocess.run([sys.executable, "-c", driver], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    result = json.loads(run.stdout.strip().splitlines()[-1])["newcfg.sparse"]
    assert not result["correct"], result["checks"]


def test_a_number_without_a_limit_is_not_correct():
    name = "st1deg.analysis"
    cell = harness.find_cell(name, overrides={**SMALL[name],
                                              "limits": {"mask_err": None}})
    assert cell.limits["mask_err"] is None
    sound = run_small(harness, name)
    assert sound["correct"]
    import time
    result = harness.run(cell, 20240101, 0.2, False, "cpu",
                         time.perf_counter(), need_card=False,
                         log=lambda *a, **k: None)
    assert not result["correct"]
    assert result["checks"]["mask_err"]["limit"] is None


def test_per_layer_metrics_follow_their_cells():
    months = harness.find_cell("ell1deg.months")
    names = {m["name"] for m in months.per_layer}
    assert names == {"lowrank.step_ms", "device.idle_pct", "step_mfu"}
    assert [m["name"] for m in months.end_to_end] == [
        "analyses_per_s", "analysis_p95_s", "setup_s"]
    variants = harness.find_cell("ell1deg.variants")
    assert "analysis_p95_s" not in {m["name"] for m in variants.end_to_end}
    ensemble = harness.find_cell("st1deg.ensemble")
    assert [m["name"] for m in ensemble.end_to_end] == ["analysis_p95_s",
                                                        "setup_s"]
    for cell in (months, variants, ensemble):
        reported = {m["name"] for m in cell.end_to_end}
        assert all(m["moves"] in reported for m in cell.per_layer)


def test_a_split_metric_is_read_by_its_stem():
    def path(metric):
        return Path(harness.reader(metric).__file__).name
    assert path("step_mfu.variants") == "step_mfu.py"
    assert path("eigsh.clip_ms") == "eigsh.clip_ms.py"


def test_without_a_card_the_run_prints_no_result():
    if torch.cuda.is_available():
        return  # this machine has a card: the check is the CPU sandbox's
    run = subprocess.run(
        [sys.executable, "bench_torch/run.py", "--workload", "st1deg.analysis",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert run.returncode != 0
    assert "{" not in run.stdout


def test_without_the_program_the_run_prints_no_result(tmp_path):
    shutil.copytree(REPO / "bench_torch", tmp_path / "bench_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    run = subprocess.run(
        [sys.executable, "bench_torch/run.py", "--workload",
         "st1deg.analysis", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert run.returncode != 0
    assert "{" not in run.stdout
