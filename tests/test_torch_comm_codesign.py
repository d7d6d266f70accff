"""The port's walkthrough (``examples/torch_comm_codesign.py``) against the
JAX package's (``examples/comm_codesign.py``): on the same ``--arch`` both
print the same lines, but for the one that names the executor of the
synthesized winner, whose numbers must still be equal.

Both scripts run in subprocesses, started together.  The port's runs with
its peak pinned to the reference's (the walkthrough's seconds come from
the demand builder, which prices FLOPs at the target's peak) and must load
no jax and no ``repro`` module.
"""
import torch_threads  # noqa: F401 - caps torch's threads under xdist

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "dbrx-132b"  # the walkthrough's default
EXECUTOR = "executes it"

_PORT = """
import runpy, sys
sys.argv = [{path!r}, "--arch", {arch!r}]
import repro_torch.core.hw as hw
hw.PEAK_FLOPS_BF16 = {peak!r}
runpy.run_path({path!r}, run_name="__main__")
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")]
assert not bad, bad
"""


def _numbers(line: str):
    return re.findall(r"-?\d+(?:\.\d+)?", line)


def test_walkthrough_prints_the_references_lines():
    import repro.core.hw as ref_hw
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    ref = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "examples", "comm_codesign.py"),
         "--arch", ARCH], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env, cwd=ROOT)
    port = subprocess.Popen(
        [sys.executable, "-c", _PORT.format(
            path=os.path.join(ROOT, "examples", "torch_comm_codesign.py"),
            arch=ARCH, peak=ref_hw.PEAK_FLOPS_BF16)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT)
    ref_out, ref_err = ref.communicate(timeout=300)
    port_out, port_err = port.communicate(timeout=300)
    assert ref.returncode == 0, ref_err[-3000:]
    assert port.returncode == 0, port_err[-3000:]
    ref_lines, port_lines = ref_out.splitlines(), port_out.splitlines()
    assert len(port_lines) == len(ref_lines) > 40
    executors = 0
    for r, p in zip(ref_lines, port_lines):
        if EXECUTOR in r:
            executors += 1
            assert "make_synthesized" in r
            assert "synthesized_collective" in p and EXECUTOR in p
            assert _numbers(p) == _numbers(r), (p, r)
        else:
            assert p == r
    assert executors == 1
