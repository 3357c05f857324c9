"""The yardstick's arithmetic: rays per frame or step, percentiles, and
the bytes the material gradient needs (K4's bound)."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # one H100 SXM, NVIDIA's data sheet


def rays(width: int, height: int, bounces: int) -> int:
    """Rays a sample traces: a path segment and a sun shadow ray per
    pixel and bounce (W H 2 B)."""
    return width * height * 2 * bounces


def percentile(values, q: float) -> float:
    """The q-th percentile (0..100) with linear interpolation between
    order statistics (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def k4_material_bytes(width: int, height: int, bounces: int,
                      n_materials: int) -> int:
    """Bytes the gradient of the albedo table needs in one step: for each
    of the `bounces` material fetches, every lane's 3 albedo cotangent
    floats and its 4-byte material id read once; the n_materials x 3
    float gradient written once."""
    return bounces * width * height * (3 * 4 + 4) + n_materials * 3 * 4
