"""The numbers that decide `correct`, each held to its limit.

Serving: the reference's float32 CTC logits of each judged request,
against the program's logits of that request and the tokens it served.
The logits' relative error separates the float8 control from the program
on every seed, also where random weights make the encoder's output nearly
the same at every frame and no token can flip. A served row is explained
by some
CTC alignment (a label or blank a frame, repeats merged, blanks dropped);
its reading is the least, over those alignments, of the widest gap by which
an aligned label's reference logit lies below the frame's best. Greedy
decoding on logits equal to the reference's reads 0; rounding can only make
near-ties flip, which reads the size of the rounding; a wrong token reads
the distance to a label the reference does not favour.

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


def path_gap(ref: torch.Tensor, lens: torch.Tensor, tokens: torch.Tensor,
             tok_lens: torch.Tensor) -> torch.Tensor:
    """Per row, the least over the CTC alignments of `tokens` (B, >=n) to
    the first lens[b] frames of ref (B, T, V) of the widest gap between the
    frame's best logit and the aligned label's. inf where none exists."""
    B, T, V = ref.shape
    dev = ref.device
    n_max = int(tok_lens.max()) if B else 0
    S = 2 * n_max + 1
    ext = torch.zeros((B, S), dtype=torch.long, device=dev)
    ext[:, 1::2] = tokens[:, :n_max].long().to(dev)
    gap = ref.amax(-1, keepdim=True) - ref.gather(
        2, ext[:, None, :].expand(B, T, S))
    s_idx = torch.arange(S, device=dev)[None, :]
    valid = s_idx < 2 * tok_lens.to(dev)[:, None] + 1
    prev2 = torch.cat([ext[:, :2], ext[:, :-2]], 1)
    skip = (s_idx % 2 == 1) & (s_idx >= 2) & (ext != prev2)
    inf = torch.full((), float("inf"), device=dev)
    D = torch.where(s_idx < 2, gap[:, 0], inf)
    D = torch.where(valid, D, inf)
    lens = lens.to(dev)
    for t in range(1, T):
        d1 = torch.cat([inf.expand(B, 1), D[:, :-1]], 1)
        d2 = torch.where(skip, torch.cat([inf.expand(B, 2), D[:, :-2]], 1),
                         inf)
        new = torch.maximum(gap[:, t], torch.minimum(torch.minimum(D, d1),
                                                     d2))
        new = torch.where(valid, new, inf)
        D = torch.where((t < lens)[:, None], new, D)
    last = 2 * tok_lens.to(dev)
    end = torch.minimum(D.gather(1, last[:, None])[:, 0],
                        torch.where(last > 0, D.gather(
                            1, (last - 1).clamp(min=0)[:, None])[:, 0], inf))
    empty = lens == 0
    return torch.where(empty, torch.where(tok_lens.to(dev) == 0, 0.0, inf),
                       end)


def argmax_gap(ref: torch.Tensor, lens: torch.Tensor,
               other: torch.Tensor) -> float:
    """The widest gap, over valid frames, between the reference's best
    logit and its logit of the label that `other` puts first."""
    T = ref.shape[1]
    valid = torch.arange(T, device=ref.device)[None, :] < lens[:, None]
    g = ref.amax(-1) - ref.gather(2, other.argmax(-1, keepdim=True))[..., 0]
    return float(g[valid].max())


def serve_readings(pairs) -> dict:
    """Readings of judged requests, each (served ids (B, 1 + T') with the
    counts first, the program's logits, the reference's logits, T'
    lengths): `max_logit_gap` of the served tokens (`path_gap`);
    `logit_rel_err`, the norm of the logits' difference over the norm of
    the reference's, over every valid frame; `tokens_differ`, the rows
    whose served tokens are not the greedy path of the program's own
    logits."""
    from portbench.reference.model import greedy

    gap, d2, r2, differ = 0.0, 0.0, 0.0, 0
    for out, got, want, lens in pairs:
        gap = max(gap, float(path_gap(want, lens, out[:, 1:],
                                      out[:, 0]).max()))
        valid = (torch.arange(want.shape[1], device=want.device)[None, :]
                 < lens[:, None])
        d2 += float(((got.float() - want)[valid] ** 2).sum())
        r2 += float((want[valid] ** 2).sum())
        for row, toks in zip(out.tolist(), greedy(got, lens)):
            differ += row[1:1 + row[0]] != toks
    if not pairs:
        return {}
    return {"max_logit_gap": gap, "logit_rel_err": (d2 / r2) ** 0.5,
            "tokens_differ": differ}


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
