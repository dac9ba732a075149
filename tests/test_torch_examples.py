"""The PyTorch port's examples (``examples/torch_*.py``) run on the CPU.

Each script runs as its own process with tiny flags, ``--device cpu``, and
the two sharded ones on 8 gloo ranks of the CPU (``--backend gloo``); each
must exit 0 and print its last line.  One intra-op thread a process: the
ranks share the host's cores.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

RUNS = {
    "torch_train.py": (["--steps", "2", "--batch", "2", "--seq", "128"], "final loss"),
    "torch_generate.py": (["--max-new", "3"], "request 5:"),
    "torch_speculate.py": (["--max-new", "3", "--gamma", "2"], "prompt 2:"),
    "torch_finetune_lora.py": (["--steps", "2", "--batch", "2", "--seq", "128"],
                               "merged-model generation"),
    "torch_sharded_train.py": (["--backend", "gloo"], "step 4: loss"),
    "torch_moe_pipeline_train.py": (["--backend", "gloo"], "[moe] step 4: loss"),
}


@pytest.mark.parametrize("script", sorted(RUNS))
def test_example_runs_on_the_cpu(script, tmp_path):
    args, last = RUNS[script]
    env = dict(os.environ, OMP_NUM_THREADS="1", TMPDIR=str(tmp_path))
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / script), "--device", "cpu",
                           *args], cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert last in proc.stdout.strip().splitlines()[-1], proc.stdout[-2000:]


def test_every_torch_example_is_run():
    assert sorted(p.name for p in (ROOT / "examples").glob("torch_*.py")) == sorted(RUNS)
