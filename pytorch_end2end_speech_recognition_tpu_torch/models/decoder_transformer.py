"""Transformer attention decoder (the port of the JAX package's
`models/decoder_transformer.py`): token embedding + sinusoidal PE, N pre-LN
blocks of (causal self-attention, cross-attention over the encoder frames,
FFN), log-softmax over the vocabulary.

This slice ports the teacher-forced training pass: one parallel pass over
all label positions. The KV-cache `precompute`/`init_state`/`step` interface
comes with beam search. There is no Pallas kernel here: attention is plain
torch in float32, as the reference computes it; the projections run in
`cfg.dtype`.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from pytorch_end2end_speech_recognition_tpu_torch.models.encoders import (
    LN_EPS,
    _dt,
    _layer_norm,
    _linear,
    dropout,
    sinusoidal_pe,
)
from pytorch_end2end_speech_recognition_tpu_torch.utils.config import ModelConfig

NEG_INF = -1e30
SOS_EOS_ID = 1  # the tokenizers' shared <sos>/<eos> id (blank is 0)


def mha(q, k, v, mask, heads: int):
    """Multi-head attention in float32: (out (B, Tq, D), weights (B, H, Tq,
    Tk)). `mask` broadcasts to (B, H, Tq, Tk); masked scores are -1e30 (a
    row with no key gets uniform weights, as in the reference)."""
    B, Tq, D = q.shape
    Tk = k.shape[1]
    dh = D // heads
    qh = q.reshape(B, Tq, heads, dh).transpose(1, 2)
    kh = k.reshape(B, Tk, heads, dh).transpose(1, 2)
    vh = v.reshape(B, Tk, heads, dh).transpose(1, 2)
    s = (qh @ kh.transpose(-1, -2)) / math.sqrt(dh)
    s = torch.where(mask, s, torch.full((), NEG_INF, device=s.device))
    w = torch.softmax(s, dim=-1)
    out = w @ vh
    return out.transpose(1, 2).reshape(B, Tq, D), w


class TransformerDecoderBlock(nn.Module):
    """Pre-LN block: causal self-attn -> cross-attn(enc) -> FFN, residual
    stream in float32."""

    def __init__(self, d_enc: int, cfg: ModelConfig):
        super().__init__()
        D = cfg.decoder_dim
        Fd = cfg.decoder_ffn_dim if cfg.decoder_ffn_dim > 0 else 4 * D
        self.heads = cfg.decoder_heads
        self.rate = cfg.decoder_dropout
        self.dt = _dt(cfg)
        self.ln1 = nn.LayerNorm(D, eps=LN_EPS)
        self.wq1, self.wk1, self.wv1, self.wo1 = (nn.Linear(D, D)
                                                  for _ in range(4))
        self.ln2 = nn.LayerNorm(D, eps=LN_EPS)
        self.wq2 = nn.Linear(D, D)
        self.wk2 = nn.Linear(d_enc, D)
        self.wv2 = nn.Linear(d_enc, D)
        self.wo2 = nn.Linear(D, D)
        self.ln3 = nn.LayerNorm(D, eps=LN_EPS)
        self.fc1 = nn.Linear(D, Fd)
        self.fc2 = nn.Linear(Fd, D)

    def _proj(self, x, layer):
        return _linear(x, layer, self.dt).float()

    def forward(self, x, enc, self_mask, cross_mask, train=False, gen=None):
        h = _layer_norm(x, self.ln1)
        y, _ = mha(self._proj(h, self.wq1), self._proj(h, self.wk1),
                   self._proj(h, self.wv1), self_mask, self.heads)
        x = x + dropout(self._proj(y, self.wo1), self.rate, gen, train)
        q2 = self._proj(_layer_norm(x, self.ln2), self.wq2)
        y2, _ = mha(q2, self._proj(enc, self.wk2), self._proj(enc, self.wv2),
                    cross_mask, self.heads)
        x = x + dropout(self._proj(y2, self.wo2), self.rate, gen, train)
        f = F.relu(_linear(_layer_norm(x, self.ln3), self.fc1, self.dt))
        f = _linear(f, self.fc2, self.dt).float()
        return x + dropout(f, self.rate, gen, train)


class TransformerDecoder(nn.Module):
    def __init__(self, d_enc: int, cfg: ModelConfig):
        super().__init__()
        V, D = cfg.vocab_size, cfg.decoder_dim
        self.D = D
        self.rate = cfg.decoder_dropout
        self.dt = _dt(cfg)
        self.embed = nn.Embedding(V, D)
        self.blocks = nn.ModuleList([TransformerDecoderBlock(d_enc, cfg)
                                     for _ in range(cfg.decoder_layers)])
        self.ln_out = nn.LayerNorm(D, eps=LN_EPS)
        self.proj = nn.Linear(D, V)

    def forward(self, enc: torch.Tensor, enc_lens: torch.Tensor,
                tokens: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Teacher-forced log-probs (B, U+1, V) for targets [tokens, eos]
        from inputs [sos, tokens], causal self-attention, cross-attention to
        the frames t < enc_lens[b]."""
        B, T, _ = enc.shape
        U1 = tokens.shape[1] + 1
        sos = torch.full((B, 1), SOS_EOS_ID, dtype=torch.long,
                         device=enc.device)
        inputs = torch.cat([sos, tokens.long()], dim=1)
        pe = torch.from_numpy(sinusoidal_pe(U1, self.D)).to(enc.device)
        x = self.embed(inputs).float() * math.sqrt(self.D) + pe
        x = dropout(x, self.rate, generator, train)
        self_mask = torch.tril(torch.ones((U1, U1), dtype=torch.bool,
                                          device=enc.device))[None, None]
        cross_mask = (torch.arange(T, device=enc.device)[None, :]
                      < enc_lens[:, None])[:, None, None, :]
        for blk in self.blocks:
            x = blk(x, enc, self_mask, cross_mask, train, generator)
        logits = _linear(_layer_norm(x, self.ln_out), self.proj, self.dt)
        return F.log_softmax(logits.float(), dim=-1)
