"""The numbers that decide `correct`, each held to its limit.

Serving: each family's path gives its own readings of the judged requests
against the reference (`paths/<family>.py:serve_readings`); the gap of the
label another output puts first (`argmax_gap`) is shared.

Training: the program's loss of each compared step, the norm of each leaf
of its first clipped gradient (read from Adam's first moment) and of each
leaf's change over the compared steps, against the reference's; a leaf's
gap is taken against its reference norm or the median leaf's, whichever is
larger. Leaves whose reference gradient is under a thousandth of the
median leaf's move by round-off alone and are left out of the change.
"""

from __future__ import annotations

import json
import statistics
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent


def load_limits(cell: str) -> dict:
    return json.loads((ROOT / "limits" / f"{cell}.json").read_text())


def argmax_gap(ref: torch.Tensor, lens: torch.Tensor,
               other: torch.Tensor) -> float:
    """The widest gap, over valid frames, between the reference's best
    logit and its logit of the label that `other` puts first."""
    T = ref.shape[1]
    valid = torch.arange(T, device=ref.device)[None, :] < lens[:, None]
    g = ref.amax(-1) - ref.gather(2, other.argmax(-1, keepdim=True))[..., 0]
    return float(g[valid].max())


def leaf_table(prog: dict, ref: dict, names) -> list[tuple[float, str]]:
    """(gap, leaf) of every leaf in `names`, widest first: the gap between
    the two norms of the leaf against the reference's norm or the median
    leaf's, whichever is larger."""
    med = statistics.median(ref[n] for n in names)
    return sorted(((abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30), n)
                   for n in names), reverse=True)


def train_readings(prog: dict, ref: dict) -> dict:
    """{'loss_gap', 'grad_gap', 'change_gap'} of the compared steps."""
    loss = max(abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(prog["loss"], ref["loss"]))
    names = list(ref["grad_norms"])
    med = statistics.median(ref["grad_norms"].values())
    moved = [n for n in names if ref["grad_norms"][n] >= 1e-3 * med]
    return {"loss_gap": loss,
            "grad_gap": leaf_table(prog["grad_norms"], ref["grad_norms"],
                                   names)[0][0],
            "change_gap": leaf_table(prog["change_norms"],
                                     ref["change_norms"], moved)[0][0]}


def verdict(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(every compared number within its limit, {name: {value, limit}})."""
    checks = {}
    ok = True
    for name, lim in limits.items():
        if lim.get("limit") is None:
            continue
        v = readings.get(name)
        checks[name] = {"value": v, "limit": lim["limit"]}
        if v is None or not v <= lim["limit"]:
            ok = False
    return ok, checks
