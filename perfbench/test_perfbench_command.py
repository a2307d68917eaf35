"""The command refuses to measure where it cannot: without a card, and in a
checkout that holds only the benchmark.  On a machine with a card it
measures one short run of a cell (marked ``cuda``)."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CMD = ["perfbench/run.py", "--workload", "forest-x10.adhoc", "--seed",
       str(2**31 + 3), "--seconds", "2"]


def has_card() -> bool:
    import torch
    return torch.cuda.is_available()


def run(cwd, *extra, timeout=120):
    return subprocess.run([sys.executable, *CMD, *extra], cwd=cwd,
                          capture_output=True, text=True, timeout=timeout)


def test_no_card_no_result():
    if has_card():
        pytest.skip("this machine has a card: the command would measure")
    out = run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_on_the_card():
    if not has_card():
        pytest.skip("needs an NVIDIA GPU")
    out = run(ROOT, "--trace", "0", timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert res["metrics"]["device_ms_per_query"]["value"] > 0
