"""The harness: BENCHMARK.json against the contract, discovery by name,
the result line, no result without a card, and `correct` against sound
runs, faults of the timed path, and the control (CPU, tiny sizes)."""

import io
import json
import os
import re
import shutil
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import pytest
import torch

from benchmark import compare
from benchmark import run as harness
from benchmark.tests.conftest import ROOT, tiny_root

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SEED = 2 ** 31 + 101


def test_spec_keeps_the_contract():
    assert list(SPEC) == ["command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [c["name"] for c in SPEC["configs"]]
    cells = [w["name"] for w in SPEC["workloads"]]
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    for group in (names, cells, metrics):
        assert len(group) == len(set(group))
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert "setup_s" in [m["name"] for m in SPEC["end_to_end"]]
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
    for text in [c["source"] for c in SPEC["configs"]] + SPEC["command"]:
        assert 1 <= len(text) <= 200 and "\t" not in text
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_name_is_found_by_its_file():
    """A cell's configuration, traffic, the traffic's generator and the
    cell's limits, and every metric's reader, are files named after
    them."""
    from benchmark.generators import clips

    for w in SPEC["workloads"]:
        cell = harness.cell_of(SPEC, w["name"])
        config = json.loads((ROOT / cell["config"]["file"]).read_text())
        assert config["reduced"] == cell["config"]["reduced"] == []
        params = json.loads((ROOT / "benchmark" / "traffic"
                             / f"{w['traffic']}.json").read_text())
        gen = params.get("generator", harness.DEFAULT_GENERATOR)
        assert (ROOT / "benchmark" / "generators" / f"{gen}.py").is_file()
        if gen == "clips":
            assert clips.traffic(params).frames > 0
        limits = json.loads((ROOT / "benchmark" / "limits"
                             / f"{w['name']}.json").read_text())
        assert limits and set(limits) <= set(compare.NAMES)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(harness.reader(m["name"]))


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         SPEC["workloads"][0]["name"], "--seed", str(SEED), "--seconds",
         "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        env=env, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.fixture(scope="module")
def sound(tmp_path_factory):
    """A tiny fp32 run on the CPU (the program's plain versions), with a
    new metric's file and entry added beside the real ones."""
    root = tiny_root(tmp_path_factory.mktemp("sound"))
    (root / "benchmark" / "metrics" / "extra.clips.py").write_text(
        "def read(rec):\n    return len(rec['records'])\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "extra.clips", "unit": "count",
                              "better": "higher", "source": "host_clock",
                              "layer": "entry", "moves": "fps"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return {t: harness.run("tiny", SEED, 0.0, t, device="cpu", root=root)
            for t in (False, True)}


def test_sound_run_is_correct(sound):
    for result in sound.values():
        assert result["correct"], result["checks"]
        assert result["failed"] == 0 and result["attempted"] >= 1
    assert set(sound[False]["metrics"]) == {"fps", "setup_s"}


def test_a_new_metric_is_picked_up(sound):
    assert sound[True]["metrics"]["extra.clips"]["value"] >= 1


def test_the_last_line(sound):
    result = json.loads(json.dumps(sound[False]))
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        assert harness.emit(result) == 0
    last = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(last) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(last["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for m in last["metrics"].values():
        assert set(m) == {"value", "unit"}
    tail = err.getvalue().strip().splitlines()
    assert len(tail) >= len(last["checks"])
    for line, name in zip(tail[-len(last["checks"]):], last["checks"]):
        assert line.startswith(name + " ") and "<=" in line


# a stand-in `jax` module, and a metric reader that imports it
STAND_IN_JAX = "JAX_STAND_IN = True\n"
JAX_READER = "import jax\n\n\ndef read(rec):\n    return 1\n"
EMIT = """
import sys
from pathlib import Path
sys.path[:0] = [sys.argv[1], sys.argv[2]]
from benchmark import run as harness
sys.exit(harness.emit(harness.run("tiny", int(sys.argv[3]), 0.0, True,
                                  device="cpu", root=Path(sys.argv[4]))))
"""


def test_jax_loaded_by_a_metric_means_no_result(tmp_path):
    """A metric file, read after the window and the comparison, that
    loads `jax`: exit code 4, no result line, the module named."""
    root = tiny_root(tmp_path / "root")
    (tmp_path / "site").mkdir()
    (tmp_path / "site" / "jax.py").write_text(STAND_IN_JAX)
    (root / "benchmark" / "metrics" / "extra.jax.py").write_text(JAX_READER)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "extra.jax", "unit": "count",
                              "better": "higher", "source": "host_clock",
                              "layer": "entry", "moves": "fps"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    out = subprocess.run(
        [sys.executable, "-c", EMIT, str(tmp_path / "site"), str(ROOT),
         str(SEED), str(root)], capture_output=True, text=True, timeout=600,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 4, out.stderr[-3000:]
    assert out.stdout.strip() == ""
    assert "['jax']" in out.stderr


# a generator of a new mix: clips of two lengths, a box that moves across
BOXES = """
import numpy as np


def pool(params, seed):
    H, W = params["height"], params["width"]
    out = []
    for i, T in enumerate(params["lengths"]):
        rng = np.random.default_rng([seed, i])
        frames = rng.integers(0, 256, (T, H, W, 3), dtype=np.uint8)
        masks = np.zeros((T, H, W), np.uint8)
        for t in range(T):
            masks[t, 30:70, 10 + 6 * t:50 + 6 * t] = 1
        out.append({"frames": frames, "flow_masks": masks,
                    "masks_dilated": masks})
    return out
"""


def test_a_new_mix_is_files_alone(tmp_path):
    """A traffic file that names a new generator file, and a cell that
    uses it: found, warmed as the file says, run and held to the
    reference with no edit to the harness."""
    root = tiny_root(tmp_path)
    bench = root / "benchmark"
    (bench / "generators" / "boxes.py").write_text(BOXES)
    (bench / "traffic" / "boxes.json").write_text(json.dumps(
        {"generator": "boxes", "lengths": [10, 12], "height": 128,
         "width": 160, "warm_clips": 1}))
    shutil.copy(bench / "limits" / "tiny.json",
                bench / "limits" / "tiny.boxes.json")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "tiny.boxes", "config": "tiny_cfg",
                              "traffic": "boxes", "chips": 1,
                              "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    params, pool = harness.traffic_pool("boxes", SEED, bench)
    assert [len(c["frames"]) for c in pool] == [10, 12]
    result = harness.run("tiny.boxes", SEED, 0.0, True, device="cpu",
                         root=root)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["metrics"]["mfu"]["value"] > 0


def _flow_completion_returns_its_input(pipe):
    pipe.complete_flows = lambda flows, masks: flows


def _propagation_fills_nothing(pipe):
    propagate = pipe.propagate_images

    def nothing(frames, flows, masks):
        updated, updated_masks = propagate(frames, flows, masks)
        return (updated * 0 + frames * (1 - masks),
                updated_masks * 0 + masks)
    pipe.propagate_images = nothing


def _half_the_frames_left_out(pipe):
    generate = pipe.generate

    def half(updated, flows, masks, updated_masks, ori):
        out = generate(updated, flows, masks, updated_masks, ori)
        out[out.shape[0] // 2:] = ori[out.shape[0] // 2:]
        return out
    pipe.generate = half


def _one_frame_altered(pipe):
    generate = pipe.generate

    def altered(updated, flows, masks, updated_masks, ori):
        out = generate(updated, flows, masks, updated_masks, ori)
        k = out.shape[0] // 2
        hole = masks[0, k] > 0.5
        out[k] = torch.where(hole, 255 - out[k], out[k])
        return out
    pipe.generate = altered


@pytest.mark.parametrize("fault", [_flow_completion_returns_its_input,
                                   _propagation_fills_nothing,
                                   _half_the_frames_left_out,
                                   _one_frame_altered])
def test_faults_are_not_correct(tmp_path, fault):
    """The timed path broken underneath: a stage that returns its state
    unchanged, half of a clip's frames left out, an answer altered where
    it is produced. (One chip: no exchange between chips to leave out.)"""
    root = tiny_root(tmp_path)
    result = harness.run("tiny", SEED, 0.0, False, device="cpu", root=root,
                         faults=fault)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_the_control_is_not_correct(tmp_path, precision):
    """The reference with its products' operands in the precision below
    the configuration's, against the cell's limits."""
    from benchmark import control

    root = tiny_root(tmp_path, precision)
    limits = json.loads((root / "benchmark" / "limits" / "tiny.json")
                        .read_text())
    r = control.readings("tiny", SEED, device="cpu", root=root)
    assert not compare.verdict(r, limits), r


@pytest.mark.cuda
def test_cuda_cell_is_correct():
    """One short run of the first cell on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         SPEC["workloads"][0]["name"], "--seed", str(SEED), "--seconds",
         "5", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["correct"] and last["device"]["platform"] == "gpu", last
