"""The port's examples and CI script on the CPU.

* Each of ``examples/torch_*.py`` runs at a small ``--n`` with
  ``device="cpu"`` and ends in its ✓ line; its asserts hold every answer
  against the raw stream.
* ``scripts/ci_torch.sh``'s time-source lint finds no raw timer in
  ``src/repro_torch/launch/``.
"""
import importlib.util
import re
import subprocess
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = {"torch_quickstart": 20_000, "torch_corpus_analytics": 1 << 14,
            "torch_corpus_search": 1 << 13, "torch_serve_decode": 1 << 13}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small eager ops: the tier-1 run's
    workers share the cores, and torch's spinning OpenMP threads then slow
    every op about a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_ends_in_its_check(name, capsys):
    _load(name).main(device="cpu", n=EXAMPLES[name])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1].endswith("✓"), out[-3:]


def test_ci_lint_finds_no_raw_timer_in_launch():
    script = (ROOT / "scripts" / "ci_torch.sh").read_text()
    pattern, target = re.search(
        r'grep -rn "([^"]+)" (src/repro_torch/launch/)', script).groups()
    assert target == "src/repro_torch/launch/"
    found = subprocess.run(["grep", "-rn", pattern, target],
                           cwd=ROOT, capture_output=True, text=True)
    assert found.returncode == 1, found.stdout      # 1: no line matched
