"""Transformer attention decoder (the port of the JAX package's
`models/decoder_transformer.py`): token embedding + sinusoidal PE, N pre-LN
blocks of (causal self-attention, cross-attention over the encoder frames,
FFN), log-softmax over the vocabulary.

`forward` is the teacher-forced training pass, one parallel pass over all
label positions. `precompute`/`init_state`/`step` is the beam search's
interface, the same as the LSTM speller's: the cross-attention K/V are
computed once per utterance, and each step writes its self-attention K/V
in place into fixed-shape (B, max_len, L, D) float32 caches. There is no
Pallas kernel here: attention is plain torch in float32, as the reference
computes it; the projections run in `cfg.dtype`.

Under tensor parallelism (`parallel/sharding.py`) the training pass runs
Megatron's split as the JAX package's rules lay it out: wq/wk/wv
column-parallel on this rank's heads, wo row-parallel, fc1 and fc2 as in
the encoder's FFN, the embedding and the output projection replicated.
The beam search's interface needs the whole decoder: the beam decoder
gathers a sharded model first (`decode/beam.py`).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from pytorch_end2end_speech_recognition_tpu_torch.models.encoders import (
    LN_EPS,
    _col,
    _dt,
    _layer_norm,
    _linear,
    _row,
    dropout,
    pe_table,
    sinusoidal_pe,  # noqa: F401 (the decoder's table, re-exported)
)
from pytorch_end2end_speech_recognition_tpu_torch.parallel.collectives import (
    copy_to,
    size,
)
from pytorch_end2end_speech_recognition_tpu_torch.utils.config import ModelConfig
from pytorch_end2end_speech_recognition_tpu_torch.utils.profiling import span

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


def mha_grouped(q, k, v, mask, heads: int):
    """`mha` for G query rows of each key row: q (B*G, 1, D) against k, v
    (B, Tk, D) and mask (B, 1, 1, Tk), rows b*G .. b*G + G-1 of q on row b
    of k and v, without repeating the keys G times. -> (out (B*G, 1, D),
    weights (B*G, H, 1, Tk))."""
    B, Tk, D = k.shape
    G = q.shape[0] // B
    dh = D // heads
    qh = q.reshape(B, G, heads, dh).transpose(1, 2)          # (B, H, G, dh)
    kh = k.reshape(B, Tk, heads, dh).transpose(1, 2)
    vh = v.reshape(B, Tk, heads, dh).transpose(1, 2)
    s = (qh @ kh.transpose(-1, -2)) / math.sqrt(dh)          # (B, H, G, Tk)
    s = torch.where(mask, s, torch.full((), NEG_INF, device=s.device))
    w = torch.softmax(s, dim=-1)
    out = (w @ vh).permute(0, 2, 1, 3).reshape(B * G, 1, D)
    return out, w.permute(0, 2, 1, 3).reshape(B * G, heads, 1, Tk)


class TransformerDecoderBlock(nn.Module):
    """Pre-LN block: causal self-attn -> cross-attn(enc) -> FFN, residual
    stream in float32."""

    tp_group = None

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
        """A column-parallel projection (the whole one without a group) of
        an input that has been through `copy_to`."""
        return _col(x, layer, self.dt, self.tp_group).float()

    def _out(self, y, layer):
        return _row(y, layer, self.dt, self.tp_group, False).float()

    def self_qkv(self, x):
        """x (B, Tq, D) float32 -> q, k, v (B, Tq, D) float32 from the
        pre-LN input (this rank's heads' features under tensor
        parallelism)."""
        h = copy_to(_layer_norm(x, self.ln1).to(self.dt), self.tp_group)
        return (self._proj(h, self.wq1), self._proj(h, self.wk1),
                self._proj(h, self.wv1))

    def cross_kv(self, enc):
        """enc (B, T, d_enc) -> (k, v), each (B, T, D) float32; once per
        utterance. Under tensor parallelism enc must have been through
        `copy_to` (`TransformerDecoder.forward` does it once)."""
        return self._proj(enc, self.wk2), self._proj(enc, self.wv2)

    def run(self, x, q, k, v, self_mask, ck, cv, cross_mask, train=False,
            gen=None):
        """The residual body given the attention inputs -> (x, cross
        weights (B, H, Tq, T)). When ck/cv hold fewer rows than x (beam
        search: x has K hypotheses of each utterance, in row-major order),
        each query row attends to its utterance's keys."""
        g = self.tp_group
        heads = self.heads // size(g)
        y, _ = mha(q, k, v, self_mask, heads)
        x = x + dropout(self._out(y, self.wo1), self.rate, gen, train)
        q2 = self._proj(copy_to(_layer_norm(x, self.ln2).to(self.dt), g),
                        self.wq2)
        y2, w = (mha(q2, ck, cv, cross_mask, heads)
                 if ck.shape[0] == q2.shape[0]
                 else mha_grouped(q2, ck, cv, cross_mask, heads))
        x = x + dropout(self._out(y2, self.wo2), self.rate, gen, train)
        f = F.relu(_col(copy_to(_layer_norm(x, self.ln3).to(self.dt), g),
                        self.fc1, self.dt, g))
        f = self._out(f, self.fc2)
        return x + dropout(f, self.rate, gen, train), w


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
                generator: torch.Generator | None = None,
                return_attn: bool = False):
        """Teacher-forced log-probs (B, U+1, V) for targets [tokens, eos]
        from inputs [sos, tokens], causal self-attention, cross-attention to
        the frames t < enc_lens[b]; with `return_attn` also the last
        block's cross-attention weights averaged over heads (B, U+1, T;
        over this rank's heads under tensor parallelism)."""
        with span("asr.decoder"):
            B, T, _ = enc.shape
            U1 = tokens.shape[1] + 1
            sos = torch.full((B, 1), SOS_EOS_ID, dtype=torch.long,
                             device=enc.device)
            inputs = torch.cat([sos, tokens.long()], dim=1)
            x = (self.embed(inputs).float() * math.sqrt(self.D)
                 + pe_table(U1, self.D, enc.device))
            x = dropout(x, self.rate, generator, train)
            self_mask = torch.tril(torch.ones((U1, U1), dtype=torch.bool,
                                              device=enc.device))[None, None]
            cross_mask = (torch.arange(T, device=enc.device)[None, :]
                          < enc_lens[:, None])[:, None, None, :]
            if self.blocks and self.blocks[0].tp_group is not None:
                enc = copy_to(enc.to(self.dt), self.blocks[0].tp_group)
            for blk in self.blocks:
                q, sk, sv = blk.self_qkv(x)
                ck, cv = blk.cross_kv(enc)
                x, w = blk.run(x, q, sk, sv, self_mask, ck, cv, cross_mask,
                               train, generator)
            logps = F.log_softmax(self._logits(x), dim=-1)
            if return_attn:
                return logps, w.mean(dim=1)
            return logps

    def _logits(self, x):
        return _linear(_layer_norm(x, self.ln_out), self.proj, self.dt).float()

    # ---- the beam search's interface (decode/beam.py) --------------------
    def precompute(self, enc: torch.Tensor) -> torch.Tensor:
        """(B, T, d_enc) -> every layer's cross K/V, packed (B, T, L, 2, D)
        float32."""
        return torch.stack([torch.stack(blk.cross_kv(enc), dim=2)
                            for blk in self.blocks], dim=2)

    def init_state(self, B: int, T: int, max_len: int | None = None,
                   device=None) -> dict:
        """Fixed-shape incremental state; `max_len` (the decode-step budget)
        sizes the K/V caches. Builds the PE table on the caches' device, so
        `step` reads it there."""
        if max_len is None:
            raise ValueError("TransformerDecoder.init_state needs max_len")
        L = len(self.blocks)
        kc = torch.zeros(B, max_len, L, self.D, device=device)
        pe_table(max_len, self.D, kc.device)
        return {"k_cache": kc,
                "v_cache": torch.zeros(B, max_len, L, self.D, device=device),
                "pos": torch.zeros(B, dtype=torch.long, device=device)}

    def step(self, token, state, keys, values, mask, per_row_pos=False):
        """One decode step -> (log-probs (B, V), new state, attention (B,
        T)), the last block's cross-attention weights averaged over heads.

        `keys` is the packed cross K/V from `precompute`; `values` (the
        encoder output) is unused, kept for the speller's signature. keys
        and mask (B', T) may hold one row per utterance for B = G B' token
        rows (G hypotheses an utterance). The caches are written in place:
        at one position for every row (`per_row_pos=False`, the full-pass
        beam, whose rows step in lockstep), or at each row's own
        (`per_row_pos=True`, the streaming beam, whose rows fall out of
        lockstep), with the PE rows and causal masks per row to match."""
        del values
        B = token.shape[0]
        kc, vc, pos_v = state["k_cache"], state["v_cache"], state["pos"]
        U, dev = kc.shape[1], kc.device
        rows = torch.arange(B, device=dev)
        pos = pos_v if per_row_pos else pos_v[:1].expand(B)
        # per row, a position past the cache reads the last PE row and its
        # write is dropped, as the reference's gather and scatter do (only
        # rows out of lockstep get there: the streaming beam's dead ones)
        pos_w = pos.clamp(max=U - 1) if per_row_pos else pos
        x = (self.embed(token.long()).float() * math.sqrt(self.D)
             + pe_table(U, self.D, dev)[pos_w])[:, None, :]
        self_mask = (torch.arange(U, device=dev)[None, :]
                     <= pos[:, None])[:, None, None, :]
        cross_mask = mask[:, None, None, :]
        attn = None
        for li, blk in enumerate(self.blocks):
            q, k_new, v_new = blk.self_qkv(x)
            kc[rows, pos_w, li] = (k_new[:, 0] if not per_row_pos else
                                   torch.where((pos < U)[:, None], k_new[:, 0],
                                               kc[rows, pos_w, li]))
            vc[rows, pos_w, li] = (v_new[:, 0] if not per_row_pos else
                                   torch.where((pos < U)[:, None], v_new[:, 0],
                                               vc[rows, pos_w, li]))
            x, w = blk.run(x, q, kc[:, :, li], vc[:, :, li], self_mask,
                           keys[:, :, li, 0], keys[:, :, li, 1], cross_mask)
            attn = w.mean(dim=1)[:, 0]
        logp = F.log_softmax(self._logits(x)[:, 0], dim=-1)
        return logp, {"k_cache": kc, "v_cache": vc, "pos": pos_v + 1}, attn
