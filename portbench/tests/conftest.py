"""Fixtures of the benchmark's CPU tests: the repository on the path, and a
copy of the benchmark with a tiny configuration (d = 16, m = 8, n = 32) and
a tiny cell of each traffic mix, found by name as any other.

    python -m pytest -q portbench/tests
"""

import json
import pathlib
import shutil
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

MIXES = {"prove": "prove_serial", "setup": "setup_serial", "verify": "verify_mixed"}


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device; skips without one")


def bench() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    """(root of a copy of the benchmark that holds the tiny configuration,
    BENCHMARK.json's object with the cells tiny.prove, tiny.setup and
    tiny.verify beside the real ones)."""
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(ROOT / "portbench" / "configs" / "release.json") as f:
        cfg = json.load(f)
    cfg.update(d=16, m=8, n=32)
    with open(root / "portbench" / "configs" / "tiny.json", "w") as f:
        json.dump(cfg, f)
    b = bench()
    b["configs"].append({"name": "tiny", "source": "the release macros at d = 16, m = 8, n = 32",
                         "file": "portbench/configs/tiny.json", "reduced": ["d", "m", "n"],
                         "why": "CPU tests"})
    for kind, mix in MIXES.items():
        name = f"tiny.{kind}"
        b["workloads"].append({"name": name, "config": "tiny", "traffic": mix, "chips": 1,
                               "why": "CPU tests"})
        for m in b["end_to_end"] + b["per_layer"]:
            if any(w.endswith(f".{kind}") for w in m.get("workloads", [])):
                m["workloads"].append(name)
    return root, b
