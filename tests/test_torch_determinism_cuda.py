"""F6 on the card: every training step is reproducible bit for bit.

- Each trainer's step (``scripts/time_train_steps.py::CASES``: the head
  step on waveforms and on cached latents, the PLC step, its decoder-free
  latent step and the decoder fine-tune, the reconstruction pretraining
  step with its reseeding, the GAN step), run twice from one start with one
  batch and one seed, gives bit-equal (``torch.equal``) parameters,
  optimizer state, EMA books and counts, and metrics; at full width, random
  weights from a seed. The head step's
  EMA sums used ``index_add_``, whose atomics sum in another order on each
  run: that case failed before the repair.
- The detector: in a process of its own, with ``CUBLAS_WORKSPACE_CONFIG``
  set before CUDA starts and ``torch.use_deterministic_algorithms(True,
  warn_only=True)``, one step of each trainer raises no warning that an op
  "does not have a deterministic implementation".

Marked ``cuda``: each test skips without a card. The file imports neither
jax nor the JAX package; on the machine with the card run it without the
repository's conftest:

    python -m pytest --noconftest tests/test_torch_determinism_cuda.py -q
"""

import os
import subprocess
import sys
import warnings

import pytest
import torch

from multimodal_vqvae_compression_audio_tactile_tpu_torch.scripts.time_train_steps import (
    CASES, run_twice, unequal)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DETERMINISM_WARNING = "does not have a deterministic implementation"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_step_twice_from_one_start_is_bit_equal(cuda, case):
    first, second = run_twice(*CASES[case](cuda))
    assert len(first) == len(second)
    off = unequal(first, second)
    assert not off, (case, off[:10], max(float((first[i] - second[i]).detach().abs().max())
                                         for i in off))


def detect() -> None:
    """One step of each trainer under ``torch.use_deterministic_algorithms(
    True, warn_only=True)``; prints every op that warns, one a line."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    found = set()
    for name, make in CASES.items():
        start, step = make(torch.device("cuda"))
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            run_twice(start, step)
            torch.cuda.synchronize()
        for w in seen:
            if DETERMINISM_WARNING in str(w.message):
                found.add(f"{name}: {str(w.message).splitlines()[0]}")
    for line in sorted(found):
        print("NONDETERMINISTIC", line)
    print("DETECTED", len(found))


@pytest.mark.cuda
def test_detector_finds_no_nondeterministic_op(cuda):
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__)], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "DETECTED 0" in proc.stdout, proc.stdout[-4000:]


if __name__ == "__main__":
    detect()
