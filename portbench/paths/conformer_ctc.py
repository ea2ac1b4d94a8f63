"""The program's serving path for the Conformer CTC family, and the
readings that judge what it served.

A request is `AsrModel.encode`, `AsrModel.ctc_logits`, `ctc_greedy_decode`
and the copy of the token ids to the host; what is judged is its CTC
logits, against the reference's (`reference.conformer_ctc.serve_reference`).
The logits' relative error separates the float8 control from the program
on every seed, also where random weights make the encoder's output nearly
the same at every frame and no token can flip. A served row is explained
by some CTC alignment (a label or blank a frame, repeats merged, blanks
dropped); its reading is the least, over those alignments, of the widest
gap by which an aligned label's reference logit lies below the frame's
best. Greedy decoding on logits equal to the reference's reads 0; rounding
can only make near-ties flip, which reads the size of the rounding; a
wrong token reads the distance to a label the reference does not favour.

What the harness takes of a family's path: `build`, `serve_request`,
`serve_readings` and, for the calibration, `control_readings`.
"""

from __future__ import annotations

import torch

from portbench.judge import argmax_gap
from portbench.reference.conformer_ctc import greedy


def build(cfg: dict, dev):
    """The program's model for the configuration `cfg`, on `dev`: (its
    resolved config object, the model)."""
    from pytorch_end2end_speech_recognition_tpu_torch.models.asr import (
        AsrModel,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
        AsrConfig,
    )

    cfg = AsrConfig.from_dict(cfg)
    return cfg, AsrModel(cfg, device=dev, seed=0)


def serve_request(model, batch):
    """One request on the program's serving path: (token counts and ids
    (B, 1 + T') on the host, the CTC logits on the device)."""
    from pytorch_end2end_speech_recognition_tpu_torch.ops.ctc import (
        ctc_greedy_decode,
    )

    enc, enc_lens = model.encode(batch["audio"], batch["audio_lens"])
    logits = model.ctc_logits(enc)
    hyp, hyp_lens = ctc_greedy_decode(logits, enc_lens)
    return torch.cat([hyp_lens[:, None], hyp], dim=1).cpu(), logits


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


def serve_readings(pairs) -> dict:
    """Readings of judged requests, each (served ids (B, 1 + T') with the
    counts first, the program's logits, the reference's logits, T'
    lengths): `max_logit_gap` of the served tokens (`path_gap`);
    `logit_rel_err`, the norm of the logits' difference over the norm of
    the reference's, over every valid frame; `tokens_differ`, the rows
    whose served tokens are not the greedy path of the program's own
    logits."""
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


def control_readings(pairs) -> dict:
    """The lower-precision control's readings, from pairs of the
    reference's output in float32 and in the lower precision on the same
    batch, each (logits, T' lengths): the gap of the label the control puts
    first at each frame (`max_logit_gap`), and its logits' relative error."""
    gaps, d2, r2 = [], 0.0, 0.0
    for (want, lens), (low, _) in pairs:
        gaps.append(argmax_gap(want, lens, low))
        valid = (torch.arange(want.shape[1], device=want.device)[None, :]
                 < lens[:, None])
        d2 += float(((low - want)[valid] ** 2).sum())
        r2 += float((want[valid] ** 2).sum())
    return {"max_logit_gap": max(gaps), "logit_rel_err": (d2 / r2) ** 0.5}
