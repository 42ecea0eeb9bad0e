"""CPU tests of the benchmark (`python -m pytest benchmark/tests -q`); the
`cuda`-marked ones run a cell on the card and skip without one."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_SETTINGS = {"ref_stride": 4, "neighbor_length": 6,
                 "subvideo_length": 8, "raft_iter": 2}


@pytest.fixture(autouse=True, scope="module")
def _threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def tiny_root(tmp: Path, precision: str = "fp32", frames: int = 12,
              limits_of: str | None = None) -> Path:
    """A checkout-like directory whose BENCHMARK.json has one cell, 'tiny':
    the real metric readers and generators, a 12-frame 128x160 traffic mix
    of the default generator and a configuration of `precision` at tiny
    settings; its limits those of the cell `limits_of` (default: the real
    cell of that precision at 432x240)."""
    bench = tmp / "benchmark"
    for sub in ("traffic", "limits", "configs"):
        (bench / sub).mkdir(parents=True, exist_ok=True)
    for sub in ("metrics", "generators"):
        shutil.copytree(ROOT / "benchmark" / sub, bench / sub,
                        dirs_exist_ok=True)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"] = [{"name": "tiny", "config": "tiny_cfg",
                          "traffic": "tiny", "chips": 1, "why": "test"}]
    spec["configs"] = [{"name": "tiny_cfg", "source": "test",
                        "file": "benchmark/configs/tiny_cfg.json",
                        "reduced": [], "why": "test"}]
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    t = json.loads((ROOT / "benchmark/traffic/clip80_432x240.json")
                   .read_text())
    t.update(frames=frames, width=160, height=128, pool=2)
    (bench / "traffic" / "tiny.json").write_text(json.dumps(t))
    c = json.loads((ROOT / f"benchmark/configs/propainter_{precision}.json")
                   .read_text())
    c["settings"] = TINY_SETTINGS
    (bench / "configs" / "tiny_cfg.json").write_text(json.dumps(c))
    cell = limits_of or f"{precision}.clip80_432x240"
    shutil.copy(ROOT / "benchmark" / "limits" / f"{cell}.json",
                bench / "limits" / "tiny.json")
    return tmp
