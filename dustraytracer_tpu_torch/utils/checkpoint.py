"""Checkpoint and resume for progressive renders and inverse-rendering
runs (port of utils/checkpoint.py).

The files are the JAX package's npz layout, so either package reads what
the other wrote:

- a film: `accum` (H, W, 3) f32 and `frame`;
- a train state, in `{path}.npz`: `step`, the parameter leaves `p0, p1,
  ...` and the Adam state `o0, o1, ...`. Leaves are in jax.tree flatten
  order (`param_leaves`): sorted dict keys, LightParams and Camera in
  field order. The Adam state is optax's (count, mu leaves, nu leaves),
  which torch.optim.Adam holds per parameter as (step, exp_avg,
  exp_avg_sq).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch


def save_film(path, film) -> None:
    """Persist film accumulation state (resumable progressive render)."""
    np.savez_compressed(path, accum=film.accum.detach().cpu().numpy(),
                        frame=np.asarray(film.frame, np.int32))


def load_film(path, width: int, height: int, device="cpu"):
    """Load a film checkpoint; None if absent or shape-mismatched."""
    from dustraytracer_tpu_torch.render.film import Film

    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        accum = z["accum"]
        frame = int(z["frame"])
    if accum.shape != (height, width, 3):
        return None
    return Film(accum=torch.from_numpy(accum).to(device), frame=frame)


def param_leaves(params: dict) -> list:
    """The tensors of a params dict in jax.tree flatten order: sorted
    keys; a LightParams or Camera value contributes its fields in
    declaration order."""
    out = []
    for key in sorted(params):
        val = params[key]
        if dataclasses.is_dataclass(val):
            out.extend(getattr(val, f.name) for f in dataclasses.fields(val))
        else:
            out.append(val)
    return out


def save_train_state(path, params: dict, optimizer=None,
                     step: int = 0) -> None:
    """Write params and, if given, the torch.optim.Adam state over
    `param_leaves(params)` to `{path}.npz`."""
    leaves = param_leaves(params)
    arrays = {"step": np.asarray(step)}
    arrays.update({f"p{i}": t.detach().cpu().numpy()
                   for i, t in enumerate(leaves)})
    if optimizer is not None:
        states = [optimizer.state.get(t, {}) for t in leaves]
        count = int(states[0]["step"]) if "step" in states[0] else 0
        mu = [s.get("exp_avg", torch.zeros_like(t))
              for s, t in zip(states, leaves)]
        nu = [s.get("exp_avg_sq", torch.zeros_like(t))
              for s, t in zip(states, leaves)]
        arrays["o0"] = np.asarray(count, np.int32)
        arrays.update({f"o{i + 1}": x.detach().cpu().numpy()
                       for i, x in enumerate(mu + nu)})
    np.savez_compressed(str(path) + ".npz", **arrays)


def load_train_state(path, example_params: dict, optimizer=None):
    """Restore what save_train_state (of either package) wrote.

    Copies the saved leaves into `example_params`' tensors in place and,
    when both the file and the call carry an optimizer, sets its Adam
    state (the step count on the leaf's device where the optimizer is
    capturable, on the host otherwise, as torch.optim.Adam keeps it).
    Returns (params, optimizer or None, step), or None when no
    checkpoint exists."""
    npz = str(path) + ".npz"
    if not os.path.exists(npz):
        return None
    leaves = param_leaves(example_params)
    with np.load(npz) as z:
        with torch.no_grad():
            for i, t in enumerate(leaves):
                t.copy_(torch.from_numpy(z[f"p{i}"]))
        restored = None
        if optimizer is not None and "o0" in z:
            count = float(z["o0"])
            n = len(leaves)
            capturable = any(g.get("capturable")
                             for g in optimizer.param_groups)
            for i, t in enumerate(leaves):
                optimizer.state[t] = {
                    "step": torch.tensor(
                        count, dtype=torch.float32,
                        device=t.device if capturable else "cpu"),
                    "exp_avg": torch.from_numpy(z[f"o{i + 1}"]).to(t.device),
                    "exp_avg_sq": torch.from_numpy(
                        z[f"o{n + i + 1}"]).to(t.device)}
            restored = optimizer
        step = int(z["step"])
    return example_params, restored, step
