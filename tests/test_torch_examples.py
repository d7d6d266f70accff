"""The port's twins of the JAX package's examples
(``examples/torch_quickstart.py``, ``torch_serve_batch.py``,
``torch_train_100m.py``) run on the CPU with tiny arguments: each ends
the way its JAX original does, and prints its lines."""
import torch_threads  # noqa: F401 - caps torch's threads under xdist

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script: str, *args: str) -> str:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="2", CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "examples",
                                                       script), *args],
                         env=env, capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_quickstart_twin():
    out = _run("torch_quickstart.py", "--device", "cpu", "--steps", "3")
    assert "config: qwen2-0.5b-smoke (dense)" in out
    assert "step    2  loss" in out
    gen = out.split("-> generated:")[1].strip()
    assert gen.startswith("[") and len(gen.strip("[]").split(",")) == 13


@pytest.mark.parametrize("arch", ["mamba2-130m", "seamless-m4t-medium"])
def test_serve_batch_twin(arch):
    out = _run("torch_serve_batch.py", "--device", "cpu", "--arch", arch,
               "--batch", "2", "--prompt-len", "4", "--gen-len", "4")
    assert f"serving {arch}-smoke: batch=2 prompt=4 gen=4" in out
    assert "decode:  p50=" in out and "sample: [" in out


def test_train_100m_twin(tmp_path):
    out = _run("torch_train_100m.py", "--device", "cpu", "--steps", "3",
               "--d-model", "128", "--layers", "2", "--seq", "32",
               "--vocab", "512", "--batch", "2", "--ckpt-dir",
               str(tmp_path))
    assert "model: qwen2-100m" in out
    assert "step     2 loss=" in out
    assert "checkpoint restore verified" in out


def test_twins_ask_for_the_card():
    """Without ``--device cpu`` a twin asks for the card, and where there
    is none it says so and stops."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, os.path.join(
        ROOT, "examples", "torch_quickstart.py"), "--steps", "1"], env=env,
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
