"""The numbers that decide `correct`, each held to the limit that
`limits/<cell>.json` gives it.

Render cells compare film pixels that the timed path produced with the
reference's film at the same pixels:
  px_bad_share  share of compared pixels whose largest channel gap
                exceeds PIXEL_TOL
  px_gap_mean   mean absolute gap over the compared values
Train cells compare the first steps of the timed training object with
the reference's steps from the same inputs, and the losses of steps
kept from the window with the reference's loss at the leaves and frame
each started from:
  loss_gap      largest |loss - ref| / |ref| over those steps
  grad_gap      worst leaf of | |g| - |g_ref| | / max(|g_ref|, median),
                the first step's gradient as Adam received it
  step_gap      the same of the parameters' change over the steps
A leaf whose reference gradient norm is under LEAF_FLOOR of the median
leaf's counts in neither gap (a light angle that only steers the shadow
rays gets no gradient); the median is over the counted leaves."""

from __future__ import annotations

import json
import math
from pathlib import Path

import torch

PIXEL_TOL = 1e-3
LEAF_FLOOR = 1e-3


def pixel_numbers(got: torch.Tensor, ref: torch.Tensor) -> dict:
    gap = (got.double() - ref.double()).abs()
    return {"px_bad_share": float((gap.amax(-1) > PIXEL_TOL).double()
                                  .mean()),
            "px_gap_mean": float(gap.mean())}


def _norms(leaves: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            leaves.items()}


def _worst(got: dict, ref: dict, counted) -> float:
    g, r = _norms(got), _norms(ref)
    med = sorted(r[k] for k in counted)[len(counted) // 2]
    return max(abs(g[k] - r[k]) / max(r[k], med) for k in counted)


def train_numbers(got: dict, ref: dict) -> dict:
    """got, ref: {"losses": [...], "grad0": {leaf: tensor},
    "delta": {leaf: tensor}}."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in
                   zip(got["losses"], ref["losses"]))
    gn = _norms(ref["grad0"])
    med = sorted(gn.values())[len(gn) // 2]
    counted = [k for k, v in gn.items() if v >= LEAF_FLOOR * med]
    return {"loss_gap": loss_gap,
            "grad_gap": _worst(got["grad0"], ref["grad0"], counted),
            "step_gap": _worst(got["delta"], ref["delta"], counted)}


def load_limits(root: Path, cell: str) -> dict:
    return json.loads((root / "limits" / f"{cell}.json").read_text())


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, checks): every number finite and at or under its limit;
    checks maps each name to {"value", "limit"}."""
    checks, ok = {}, True
    for name, spec in limits["numbers"].items():
        val = numbers.get(name, math.nan)
        checks[name] = {"value": val, "limit": spec["limit"]}
        ok = ok and math.isfinite(val) and val <= spec["limit"]
    return ok, checks
