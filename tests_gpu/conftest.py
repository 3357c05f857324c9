"""On-card tests: the CUDA kernels against their twins and the card's
measurements (utils/roofline.py), the counterpart of tests_tpu/. They
import no jax (the card's machine has none) and nothing of the JAX
package.

Run on a machine with an NVIDIA card, from the repository root:

    python -m pytest tests_gpu -q -o addopts="" -p no:cacheprovider

(`addopts=""` drops pyproject's xdist workers: one process drives the one
card.) Every test is marked `gpu`, and the autouse fixture below skips it
where torch.cuda.is_available() is False, so on a CPU machine the
directory is collected and every case skips. The fixture is
session-scoped, so it runs before the module fixtures that move scenes to
the card; it decides at run time, never at import or collection."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture(scope="session", autouse=True)
def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "False")
