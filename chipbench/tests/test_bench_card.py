"""The benchmark on the card: one short run of each one-card cell must
come out correct (``python3 -m pytest -q -m cuda chipbench/tests``)."""
import json
import subprocess
import sys

import pytest

from cb import spec


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["qwen2-train-4k", "dbrx-1l-train-4k"])
def test_short_run_on_the_card(name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    p = subprocess.run([sys.executable, "chipbench/run.py", "--workload",
                        name, "--seed", "2147483999", "--seconds", "5",
                        "--trace", "0"], cwd=spec.ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
