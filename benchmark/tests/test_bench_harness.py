"""The benchmark's harness on the CPU: the manifest and every file it names,
the names' characters, a workload that exists only in a temporary
directory, the result line, the refusal without a card and the check for
JAX. Tests that need the card carry the ``cuda`` marker and decide inside
the test."""

from __future__ import annotations

import json
import re
import subprocess
import sys
import types

import pytest

from benchmark import harness
from benchmark.tests.tiny import REPO, make_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
RUN = harness.load_module(REPO / "benchmark" / "run.py")


def manifest():
    return json.load(open(REPO / "BENCHMARK.json"))


def test_manifest_keys_and_characters():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= m["run_seconds"] <= 51 and isinstance(m["run_seconds"], int)
    names = [c["name"] for c in m["configs"]] + [w["name"] for w in m["workloads"]] + \
        [x["name"] for x in m["end_to_end"] + m["per_layer"]]
    assert len(names) == len(set(names))
    for w in m["workloads"]:
        for key in ("name", "config", "traffic"):
            assert NAME.match(w[key]), w[key]
        assert w["chips"] in (1, 4) and 0 < len(w["why"]) <= 200
    for c in m["configs"]:
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
    for x in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(x["name"]) and UNIT.match(x["unit"]) and x["better"] in ("lower",
                                                                                   "higher")
    assert any(x["name"] == "setup_s" and x["bound"] <= 0.25 for x in m["end_to_end"])
    assert all(0.01 <= x["bound"] <= 0.25 for x in m["end_to_end"])
    e2e = {x["name"] for x in m["end_to_end"]}
    cells = {w["name"] for w in m["workloads"]}
    for x in m["per_layer"]:
        assert x["moves"] in e2e and "\n" not in x["layer"]
        # the harness reports a per-layer metric only in the cells it lists
        assert x["workloads"] and set(x["workloads"]) <= cells
        if x["unit"] == "%" and ("roofline" in x["name"] or "mfu" in x["name"]):
            assert x["source"] == "device_trace"


def test_every_workload_finds_its_files_by_name():
    m = manifest()
    for w in m["workloads"]:
        wl = harness.load_workload(REPO, w["name"])
        assert wl.driver_path().is_file()
        assert (REPO / "benchmark" / "limits" / f"{w['name']}.json").is_file()
        assert wl.per_layer(), "every cell reports a per-layer metric"
        assert len(wl.end_to_end()) >= 2, "setup_s and one more"
        for metric in wl.per_layer():
            assert wl.metric_path(metric["name"]).is_file()
            assert callable(harness.load_module(wl.metric_path(metric["name"])).read)
    for c in m["configs"]:
        config = json.load(open(REPO / c["file"]))
        assert config["name"] == c["name"] and config["source"] == c["source"]
        assert set(config["reduced"]) == set(c["reduced"])


def test_no_run_without_a_card():
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "iqt-serve-128",
                           "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "diffusioniqt_tpu_torch_fake", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "diffusioniqt_tpu.models", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "flax", types.ModuleType("flax"))
    assert harness.forbidden_modules() == ["diffusioniqt_tpu.models", "flax"]


def _stub_root(tmp_path):
    root = make_root(tmp_path)
    (root / "benchmark" / "drivers" / "stub.py").write_text(
        "def run(wl, seed, seconds, trace, device):\n"
        "    return {'setup_end': 0.0, 'metrics': {'serve_mvox_per_s': (1.5, 'Mvox/s')},\n"
        "            'peak': 0, 'attempted': 3, 'failed': 0,\n"
        "            'readings': {'denoise_rel': 0.001, 'update_rel': 0.002, 'stitch_rel': 0.5}}\n")
    (root / "benchmark" / "traffic" / "stub.json").write_text('{"driver": "stub", "params": {}}')
    m = json.load(open(root / "BENCHMARK.json"))
    m["workloads"][0]["traffic"] = "stub"
    json.dump(m, open(root / "BENCHMARK.json", "w"))
    return root


def test_stub_driver_prints_the_contract_line(tmp_path, capsys):
    root = _stub_root(tmp_path)
    wl = harness.load_workload(root, "tiny-iqt-serve")
    assert RUN.execute(wl, 1, 1.0, False, "cpu", -2.0) == 0
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is False, "stitch_rel 0.5 is over its limit"
    assert line["metrics"]["setup_s"] == {"value": 2.0, "unit": "s"}
    assert set(line["metrics"]) == {"serve_mvox_per_s", "setup_s"}
    assert out.err.strip().splitlines()[-1].startswith("check stitch_rel: 0.5 (limit")


def test_a_loaded_jax_module_refuses_the_result(tmp_path, capsys, monkeypatch):
    root = _stub_root(tmp_path)
    wl = harness.load_workload(root, "tiny-iqt-serve")
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert RUN.execute(wl, 1, 1.0, False, "cpu", 0.0) == 3
    out = capsys.readouterr()
    assert out.out.strip() == "" and "jax" in out.err


@pytest.mark.parametrize("workload", ["tiny-iqt-serve", "tiny-sr-serve", "tiny-iqt-train"])
def test_a_workload_from_files_alone_runs_on_the_cpu(tmp_path, capsys, workload):
    """Configuration, traffic, limits and manifest exist only in ``tmp_path``;
    the whole run (set-up, window, check) goes through the port's plain
    path on the CPU and prints a correct result."""
    root = make_root(tmp_path)
    wl = harness.load_workload(root, workload)
    assert RUN.execute(wl, 2 ** 31 + 7, 0.5, False, "cpu", 0.0) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0


@pytest.mark.cuda
def test_a_cell_on_the_card():
    """One short run of the first cell on the card, as the driver runs it."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "iqt-serve-128",
                           "--seed", "3000000011", "--seconds", "5", "--trace", "0"],
                          cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"] is True


def test_per_layer_readers_on_a_synthetic_trace():
    """Each reader takes its number from a trace; none reads over 100%, and a
    reader with nothing to read gives nothing."""
    names = {"fused": "void igemm::conv_sm90<true, true, 64>(x)", "halo": "halo_row_kernel<x>",
             "plain": "void at::native::reduce_kernel<512>"}
    kernels = [(names["fused"], 0.0, 40.0), (names["halo"], 40.0, 50.0),
               (names["plain"], 60.0, 100.0), (names["plain"], 90.0, 95.0)]
    tr = harness.Trace(kernels=kernels, window=(0.0, 200.0),
                       host_ranges=[("window", 0.0, 200.0), ("sample", 55.0, 150.0)])
    tr.counts = {"forwards": 2, "steps": 1, "microbatches": 4}
    tr.spans = {"infer_volume": [1.0, 2.0], "sample": [0.9, 1.8]}
    tr.work = {"forward_flops": 1e6, "block_least_s": 5e-6}
    assert tr.busy_s() == pytest.approx(90e-6) and tr.window_s == pytest.approx(200e-6)
    read = lambda name: harness.load_module(REPO / "benchmark" / "metrics" / f"{name}.py").read(tr)
    assert read("idle_share.serve") == pytest.approx(55.0)
    assert read("idle_share.train") == pytest.approx(55.0)
    assert read("plain_ops_ms_per_nfe.serve") == pytest.approx(45e-3 / 2)
    assert read("plain_ops_ms_per_step.train") == pytest.approx(45e-3)
    assert read("fused_block_roofline.serve") == pytest.approx(100 * 2 * 5e-6 / 40e-6)
    assert read("outside_sampler_ms.serve") == pytest.approx(150.0)
    assert read("mfu.serve") == pytest.approx(100 * 2e6 / (200e-6 * harness.PEAK_BF16_FLOPS))
    assert read("mfu.train") == pytest.approx(3 * read("mfu.serve") * 4 / 2)
    gaps = tr.breakdown()["idle_gaps"]
    assert gaps[0] == ["sample", pytest.approx(100e-6)]
    tr.kernels = [(names["plain"], 60.0, 100.0)]
    assert read("fused_block_roofline.serve") is None
