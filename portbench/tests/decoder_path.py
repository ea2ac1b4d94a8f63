"""The program's serving path of the tests' second family
(`decoder_reference`): the Conformer hybrid model's encoder, then its
Transformer decoder's token loop (`precompute`, `init_state`, `step`),
greedy, for the mix's most tokens, each row keeping its `token_lens`.
What is judged is the step log-probs (B, U, V)."""

from __future__ import annotations

import torch

from portbench.judge import argmax_gap
from portbench.paths.conformer_ctc import build  # noqa: F401 (the model)

SOS = 1


def serve_request(model, batch):
    """(token counts and ids (B, 1 + U) on the host, the step log-probs)."""
    enc, enc_lens = model.encode(batch["audio"], batch["audio_lens"])
    dec, dev = model.decoder, enc.device
    B, T, _ = enc.shape
    U = batch["tokens"].shape[1]
    keys = dec.precompute(enc)
    mask = torch.arange(T, device=dev)[None, :] < enc_lens[:, None]
    state = dec.init_state(B, T, max_len=U, device=dev)
    tok = torch.full((B,), SOS, dtype=torch.long, device=dev)
    toks, logps = [], []
    for _ in range(U):
        logp, state, _ = dec.step(tok, state, keys, enc, mask)
        tok = logp.argmax(-1)
        toks.append(tok)
        logps.append(logp)
    lens = batch["token_lens"].long()
    ids = torch.where(torch.arange(U, device=dev)[None, :] < lens[:, None],
                      torch.stack(toks, 1), 0)
    return torch.cat([lens[:, None], ids], 1).cpu(), torch.stack(logps, 1)


def _centred(x):
    return x - x.mean(-1, keepdim=True)


def _valid(want, counts):
    return (torch.arange(want.shape[1], device=want.device)[None, :]
            < counts[:, None])


def serve_readings(pairs) -> dict:
    """Readings of judged requests, each (served ids, the program's step
    log-probs, the reference's, served counts): `max_logp_gap`, the widest
    gap by which a served token's reference log-prob lies below the
    reference's best at its position; `logp_rel_err`, the relative error of
    the log-probs, each position's mean taken out, over the served
    positions; `tokens_differ`, the rows whose served tokens are not the
    argmax of the program's own step log-probs."""
    gap, d2, r2, differ = 0.0, 0.0, 0.0, 0
    for out, got, want, counts in pairs:
        valid = _valid(want, counts)
        toks = out[:, 1:].to(want.device).long()
        g = want.amax(-1) - want.gather(2, toks[..., None])[..., 0]
        gap = max(gap, float(g[valid].max()))
        d = (_centred(got.float()) - _centred(want))[valid]
        d2 += float((d ** 2).sum())
        r2 += float((_centred(want)[valid] ** 2).sum())
        mine = got.argmax(-1).to(toks.device)
        differ += int(((mine != toks) & valid).any(1).sum())
    if not pairs:
        return {}
    return {"max_logp_gap": gap, "logp_rel_err": (d2 / r2) ** 0.5,
            "tokens_differ": differ}


def control_readings(pairs) -> dict:
    """The lower-precision reference against the float32 one on the same
    served tokens: the gap of the token it puts first, and its relative
    error."""
    gaps, d2, r2 = [], 0.0, 0.0
    for (want, counts), (low, _) in pairs:
        gaps.append(argmax_gap(want, counts, low))
        valid = _valid(want, counts)
        d2 += float(((_centred(low) - _centred(want))[valid] ** 2).sum())
        r2 += float((_centred(want)[valid] ** 2).sum())
    return {"max_logp_gap": max(gaps), "logp_rel_err": (d2 / r2) ** 0.5}
