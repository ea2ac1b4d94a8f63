"""Attention decoder: an LSTM speller with location-aware attention (the
port of the JAX package's `models/decoder.py`).

`precompute`/`init_state`/`step` is the per-step interface; `forward` is
the teacher-forced pass over U+1 label steps, with scheduled sampling in
training. Numerics as in the reference: the query, key, location and score
projections run in `cfg.dtype` (the keys stay in it), while the location
features are a float32 unfold and product (the reference takes their dtype
from the float32 score weight); energies, softmax, context and the cell
state are float32. The reference declares `decoder_dropout` but applies no
dropout in the speller, and neither does the port. Scheduled sampling
starts from a previous prediction of 0, so a coin at step 0 replaces <sos>
with token 0, as in the reference. The reference rematerialises the step in
training to save memory; the port keeps the activations.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from pytorch_end2end_speech_recognition_tpu_torch.models.decoder_transformer import (  # noqa: E501
    NEG_INF,
    SOS_EOS_ID,
)
from pytorch_end2end_speech_recognition_tpu_torch.models.encoders import (
    _dt,
    _linear,
)
from pytorch_end2end_speech_recognition_tpu_torch.ops.rnn import lstm_cell
from pytorch_end2end_speech_recognition_tpu_torch.utils.config import ModelConfig
from pytorch_end2end_speech_recognition_tpu_torch.utils.profiling import span


class LocationAwareAttention(nn.Module):
    """score = v^T tanh(W_q q + W_k k + W_f conv1d(prev_attn) + b), masked
    softmax over the encoder frames."""

    def __init__(self, d_enc: int, d_dec: int, cfg: ModelConfig):
        super().__init__()
        A = cfg.attention_dim
        self.wq = nn.Linear(d_dec, A, bias=False)
        self.wk = nn.Linear(d_enc, A, bias=False)
        self.wf = nn.Linear(cfg.location_filters, A, bias=False)
        self.conv = nn.Conv1d(1, cfg.location_filters, cfg.location_kernel,
                              bias=False)
        self.v = nn.Linear(A, 1, bias=False)
        self.bias = nn.Parameter(torch.empty(A))
        self.dt = _dt(cfg)

    def precompute(self, enc: torch.Tensor) -> torch.Tensor:
        """(B, T, d_enc) -> projected keys (B, T, A) in cfg.dtype; once per
        utterance."""
        return _linear(enc, self.wk, self.dt)

    def _loc_features(self, prev_attn: torch.Tensor) -> torch.Tensor:
        """'SAME' conv1d of the previous weights (B, T) with the (F, 1, K)
        kernel, as an unfold and a float32 product: (B, T, F)."""
        K = self.conv.kernel_size[0]
        ap = F.pad(prev_attn, ((K - 1) // 2, K // 2))
        shifts = ap.unfold(1, K, 1)                              # (B, T, K)
        return shifts @ self.conv.weight[:, 0, :].T.float()

    def forward(self, query, keys, values, prev_attn, mask):
        """query (B, d_dec), keys (B, T, A), values (B, T, d_enc), prev_attn
        (B, T), mask (B, T) bool -> (context (B, d_enc), attn (B, T)),
        float32."""
        loc = self._loc_features(prev_attn.float())
        s = torch.tanh(keys.float()
                       + _linear(query, self.wq, self.dt).float()[:, None, :]
                       + _linear(loc, self.wf, self.dt).float() + self.bias)
        e = _linear(s, self.v, self.dt).float()[..., 0]
        e = torch.where(mask, e, torch.full((), NEG_INF, device=e.device))
        attn = torch.softmax(e, dim=-1)
        context = torch.einsum("bt,btd->bd", attn, values.float())
        return context, attn


class AttentionDecoder(nn.Module):
    """LSTM decoder over label steps with location-aware attention."""

    def __init__(self, d_enc: int, cfg: ModelConfig):
        super().__init__()
        V, E, H = cfg.vocab_size, cfg.embed_dim, cfg.decoder_dim
        self.H = H
        self.dt = _dt(cfg)
        self.embed = nn.Embedding(V, E)
        self.att = LocationAwareAttention(d_enc, H, cfg)
        dims = [E + d_enc] + [H] * (cfg.decoder_layers - 1)
        self.cells = nn.ModuleList([nn.Linear(d + H, 4 * H) for d in dims])
        self.proj = nn.Linear(H + d_enc, V)
        self.d_enc = d_enc

    def precompute(self, enc: torch.Tensor) -> torch.Tensor:
        return self.att.precompute(enc)

    def init_state(self, B: int, T: int, max_len: int | None = None,
                   device=None) -> dict:
        del max_len  # the recurrent state is O(1) in the decode length
        L = len(self.cells)
        z = lambda *s: torch.zeros(*s, device=device)  # noqa: E731
        return {"h": z(B, L, self.H), "c": z(B, L, self.H), "attn": z(B, T),
                "context": z(B, self.d_enc)}

    def step(self, token, state, keys, values, mask):
        """One decode step: token (B,) -> (log_probs (B, V), new state,
        attn (B, T))."""
        emb = self.embed(token.long()).float()
        context, attn = self.att(state["h"][:, -1], keys, values,
                                 state["attn"], mask)
        x = torch.cat([emb, context], dim=-1)
        hs, cs = [], []
        for li, cell in enumerate(self.cells):
            gates = _linear(torch.cat([x, state["h"][:, li]], dim=-1), cell,
                            self.dt).float()
            x, c_new = lstm_cell(gates, state["c"][:, li])
            hs.append(x)
            cs.append(c_new)
        logits = _linear(torch.cat([x, context], dim=-1), self.proj,
                         self.dt).float()
        new_state = {"h": torch.stack(hs, dim=1), "c": torch.stack(cs, dim=1),
                     "attn": attn, "context": context}
        return F.log_softmax(logits, dim=-1), new_state, attn

    def forward(self, enc, enc_lens, tokens, train: bool = False,
                generator: torch.Generator | None = None,
                scheduled_sampling: float = 0.0,
                coins: torch.Tensor | None = None,
                return_attn: bool = False):
        """Teacher-forced log-probs (B, U+1, V) for the targets [tokens,
        eos] from the inputs [sos, tokens]; with `return_attn` also the
        attention maps (B, U+1, T). In training with scheduled_sampling > 0,
        the input of step s is the previous step's argmax where coins[:, s]
        (B, U+1) bool is set; the coins are drawn from `generator` unless
        given."""
        with span("asr.decoder"):
            B, T, _ = enc.shape
            U1 = tokens.shape[1] + 1
            dev = enc.device
            keys = self.precompute(enc)
            mask = torch.arange(T, device=dev)[None, :] < enc_lens[:, None]
            state = self.init_state(B, T, device=dev)
            sos = torch.full((B, 1), SOS_EOS_ID, dtype=torch.long, device=dev)
            inputs = torch.cat([sos, tokens.long()], dim=1)
            if not (train and scheduled_sampling > 0.0):
                coins = None
            elif coins is None:
                if generator is None:
                    raise ValueError("scheduled sampling in training needs a "
                                     "generator or coins")
                coins = torch.rand((B, U1), generator=generator,
                                   device=dev) < scheduled_sampling
            pred = torch.zeros(B, dtype=torch.long, device=dev)
            logps, attns = [], []
            for s in range(U1):
                tok = inputs[:, s]
                if coins is not None:
                    tok = torch.where(coins[:, s], pred, tok)
                logp, state, attn = self.step(tok, state, keys, enc, mask)
                pred = logp.argmax(dim=-1)
                logps.append(logp)
                attns.append(attn)
            logps = torch.stack(logps, dim=1)
            if return_attn:
                return logps, torch.stack(attns, dim=1)
            return logps
