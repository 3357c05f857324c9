"""Post-processing: Uncharted2 filmic tonemap + sqrt gamma (port of
ops/tonemap.py)."""

from __future__ import annotations

import torch


def _uncharted2_partial(x):
    a, b, c, d, e, f = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
    return ((x * (a * x + c * b) + d * e) / (x * (a * x + b) + d * f)) - e / f


def uncharted2_filmic(color: torch.Tensor, exposure=2.0) -> torch.Tensor:
    curr = _uncharted2_partial(color * exposure)
    white = _uncharted2_partial(torch.tensor(11.2, dtype=torch.float32))
    return curr * (1.0 / white).to(color.device)


def gamma_correct(color: torch.Tensor) -> torch.Tensor:
    """sqrt gamma (gamma 2.0)."""
    return torch.sqrt(torch.clamp_min(color, 0.0))
