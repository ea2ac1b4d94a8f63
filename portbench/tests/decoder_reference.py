"""The plain reference of a second model family that exists only in the
tests' files: the Conformer hybrid model served greedily by its
Transformer decoder's token loop (`decoder_path`). Its weights, lengths
and training are the Conformer CTC family's; a served request is judged
against the decoder's teacher-forced log-probs of the tokens it served."""

from __future__ import annotations

import torch

from portbench.reference.common import logmel
from portbench.reference.conformer_ctc import (  # noqa: F401 (the family's)
    decoder_logp,
    enc_len,
    encode,
    param_spec,
    train_steps,
)


@torch.no_grad()
def serve_reference(P: dict, batch: dict, served, cfg: dict, prec,
                    block_rows: int):
    """(the decoder's log-probs (B, U, V) at each served position, fed the
    served tokens before it, each row's served count), in blocks of rows."""
    m, fe = cfg["model"], cfg["frontend"]
    dev = batch["audio"].device
    tokens = served[:, 1:].to(dev)
    outs = []
    for r0 in range(0, tokens.shape[0], block_rows):
        sl = slice(r0, r0 + block_rows)
        feats, flens = logmel(batch["audio"][sl], batch["audio_lens"][sl], fe,
                              prec)
        enc, elens = encode(P, feats, flens, m, prec)
        outs.append(decoder_logp(P, enc, elens, tokens[sl], m, prec)[:, :-1])
    return torch.cat(outs), served[:, 0].to(dev)
