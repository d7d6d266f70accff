"""The port tests' cap on torch's threads (``tests/torch_threads.py``):
every ``tests/test_torch_*.py`` imports it before anything else, and it
gives a worker of ``-n N`` its share of the cores while leaving a lone
process as it was.  The cap is read in a fresh subprocess each time, so
this worker's own threads are not disturbed."""
import torch_threads  # noqa: F401 - caps torch's threads under xdist

import ast
import glob
import json
import os
import subprocess
import sys

import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))

_PROBE = """
import json, os, sys
sys.path.insert(0, {tests!r})
import torch
before = torch.get_num_threads(), torch.get_num_interop_threads()
import torch_threads
print(json.dumps({{"before": before, "cap": torch_threads.CAP,
                  "cpus": os.cpu_count(),
                  "after": [torch.get_num_threads(),
                            torch.get_num_interop_threads()]}}))
"""


def _probe(workers: str | None) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k != "PYTEST_XDIST_WORKER_COUNT"}
    if workers is not None:
        env["PYTEST_XDIST_WORKER_COUNT"] = workers
    out = subprocess.run([sys.executable, "-c", _PROBE.format(tests=TESTS)],
                         capture_output=True, text=True, env=env, timeout=120,
                         check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_every_port_test_file_imports_the_cap_first():
    files = sorted(glob.glob(os.path.join(TESTS, "test_torch_*.py")))
    assert files
    late = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        imports = [n for n in tree.body
                   if isinstance(n, (ast.Import, ast.ImportFrom))
                   and not (isinstance(n, ast.ImportFrom)
                            and n.module == "__future__")]
        first = imports[0] if imports else None
        if not (isinstance(first, ast.Import)
                and [a.name for a in first.names] == ["torch_threads"]):
            late.append(os.path.basename(path))
    assert not late, late


@pytest.mark.parametrize("workers", ["2", "6", "64"])
def test_a_worker_gets_its_share_of_the_cores(workers):
    got = _probe(workers)
    cap = max(1, got["cpus"] // int(workers))
    assert got["cap"] == cap
    assert got["after"] == [cap, cap]


@pytest.mark.parametrize("workers", [None, "1"], ids=["no_xdist", "one"])
def test_a_lone_process_is_left_alone(workers):
    got = _probe(workers)
    assert got["cap"] is None
    assert got["after"] == list(got["before"])
