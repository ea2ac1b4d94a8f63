"""Language models for shallow fusion and LM training (the port of the JAX
package's `models/lm.py`): `RnnLm`, an LSTM LM whose cells are one
Linear(d + H, 4H) on the concatenation [x, h] (gate order i, f, g, o), and
`TransformerLm`, a causal pre-LN transformer with a K/V cache. Both share
the decoders' `init_state`/`step` interface (sos/eos = 1), so the beam
search reorders LM state with one gather whatever its kind. Everything is
float32, as in the reference, whose LM layers take no dtype. The LM step
is plain torch: the JAX LM step does not use the LSTM recurrence kernel.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from pytorch_end2end_speech_recognition_tpu_torch.models.decoder_transformer import (  # noqa: E501
    SOS_EOS_ID,
    mha,
)
from pytorch_end2end_speech_recognition_tpu_torch.models.encoders import (
    LN_EPS,
    pe_table,
)
from pytorch_end2end_speech_recognition_tpu_torch.ops.rnn import lstm_cell
from pytorch_end2end_speech_recognition_tpu_torch.utils import device as dv
from pytorch_end2end_speech_recognition_tpu_torch.utils.config import ModelConfig


def _with_sos(tokens: torch.Tensor) -> torch.Tensor:
    sos = torch.full((tokens.shape[0], 1), SOS_EOS_ID, dtype=torch.long,
                     device=tokens.device)
    return torch.cat([sos, tokens.long()], dim=1)


class RnnLm(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        V, E, H = cfg.vocab_size, cfg.lm_embed_dim, cfg.lm_dim
        self.H = H
        self.embed = nn.Embedding(V, E)
        dims = [E] + [H] * (cfg.lm_layers - 1)
        self.cells = nn.ModuleList([nn.Linear(d + H, 4 * H) for d in dims])
        self.proj = nn.Linear(H, V)

    def init_state(self, B: int, max_len: int | None = None, device=None):
        del max_len  # the recurrent state is O(1) in the decode length
        L = len(self.cells)
        return {"h": torch.zeros(B, L, self.H, device=device),
                "c": torch.zeros(B, L, self.H, device=device)}

    def step(self, token: torch.Tensor, state: dict):
        """token (B,), state -> (log-probs (B, V), new state)."""
        x = self.embed(token.long()).float()
        hs, cs = [], []
        for li, cell in enumerate(self.cells):
            gates = cell(torch.cat([x, state["h"][:, li]], dim=-1))
            x, c = lstm_cell(gates, state["c"][:, li])
            hs.append(x)
            cs.append(c)
        return (F.log_softmax(self.proj(x), dim=-1),
                {"h": torch.stack(hs, dim=1), "c": torch.stack(cs, dim=1)})

    def forward(self, tokens: torch.Tensor, token_lens: torch.Tensor
                ) -> torch.Tensor:
        """Teacher-forced: (B, U) -> log-probs (B, U+1, V) for the targets
        [tokens, eos] from the inputs [sos, tokens]."""
        del token_lens
        inputs = _with_sos(tokens)
        state = self.init_state(tokens.shape[0], device=tokens.device)
        logps = []
        for u in range(inputs.shape[1]):
            logp, state = self.step(inputs[:, u], state)
            logps.append(logp)
        return torch.stack(logps, dim=1)


class TransformerLmBlock(nn.Module):
    """Pre-LN causal self-attention + FFN (no cross-attention)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        D = cfg.lm_dim
        Fd = cfg.lm_ffn_dim if cfg.lm_ffn_dim > 0 else 4 * D
        self.heads = cfg.lm_heads
        self.ln1 = nn.LayerNorm(D, eps=LN_EPS)
        self.wq, self.wk, self.wv, self.wo = (nn.Linear(D, D)
                                              for _ in range(4))
        self.ln2 = nn.LayerNorm(D, eps=LN_EPS)
        self.fc1 = nn.Linear(D, Fd)
        self.fc2 = nn.Linear(Fd, D)

    def qkv(self, x):
        h = self.ln1(x)
        return self.wq(h), self.wk(h), self.wv(h)

    def run(self, x, q, k, v, mask):
        y, _ = mha(q, k, v, mask, self.heads)
        x = x + self.wo(y)
        return x + self.fc2(F.relu(self.fc1(self.ln2(x))))


class TransformerLm(nn.Module):
    """Causal transformer LM with the RnnLm fusion interface: an
    incremental `step` over a K/V cache, a parallel teacher-forced
    `forward`."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        V, D = cfg.vocab_size, cfg.lm_dim
        self.D = D
        self.embed = nn.Embedding(V, D)
        self.blocks = nn.ModuleList([TransformerLmBlock(cfg)
                                     for _ in range(cfg.lm_layers)])
        self.ln_out = nn.LayerNorm(D, eps=LN_EPS)
        self.proj = nn.Linear(D, V)

    def init_state(self, B: int, max_len: int | None = None, device=None):
        """Fixed-shape K/V caches (B, max_len, L, D) float32, written in
        place by `step`, and the PE table built on their device."""
        if max_len is None:
            raise ValueError("TransformerLm.init_state needs max_len")
        L = len(self.blocks)
        kc = torch.zeros(B, max_len, L, self.D, device=device)
        pe_table(max_len, self.D, kc.device)
        return {"k_cache": kc,
                "v_cache": torch.zeros(B, max_len, L, self.D, device=device),
                "pos": torch.zeros(B, dtype=torch.long, device=device)}

    def step(self, token: torch.Tensor, state: dict,
             per_row_pos: bool = False):
        """token (B,), state -> (log-probs (B, V), new state). The caches
        are written in place at each row's position: one position for all
        rows (the beam steps in lockstep), or with `per_row_pos` each row's
        own (the streaming beam, whose rows fall out of lockstep)."""
        B = token.shape[0]
        kc, vc, pos_v = state["k_cache"], state["v_cache"], state["pos"]
        U, dev = kc.shape[1], kc.device
        rows = torch.arange(B, device=dev)
        pos = pos_v if per_row_pos else pos_v[:1].expand(B)
        # per row, a position past the cache reads the last PE row and its
        # write is dropped, as the reference's gather and scatter do (only
        # rows out of lockstep get there: the streaming beam's dead ones)
        pos_w = pos.clamp(max=U - 1) if per_row_pos else pos
        x = (self.embed(token.long()) * math.sqrt(self.D)
             + pe_table(U, self.D, dev)[pos_w])[:, None, :]
        self_mask = (torch.arange(U, device=dev)[None, :]
                     <= pos[:, None])[:, None, None, :]
        for li, blk in enumerate(self.blocks):
            q, k_new, v_new = blk.qkv(x)
            kc[rows, pos_w, li] = (k_new[:, 0] if not per_row_pos else
                                   torch.where((pos < U)[:, None], k_new[:, 0],
                                               kc[rows, pos_w, li]))
            vc[rows, pos_w, li] = (v_new[:, 0] if not per_row_pos else
                                   torch.where((pos < U)[:, None], v_new[:, 0],
                                               vc[rows, pos_w, li]))
            x = blk.run(x, q, kc[:, :, li], vc[:, :, li], self_mask)
        logits = self.proj(self.ln_out(x))[:, 0]
        return (F.log_softmax(logits, dim=-1),
                {"k_cache": kc, "v_cache": vc, "pos": pos_v + 1})

    def forward(self, tokens: torch.Tensor, token_lens: torch.Tensor
                ) -> torch.Tensor:
        """Teacher-forced: (B, U) -> log-probs (B, U+1, V)."""
        del token_lens
        inputs = _with_sos(tokens)
        U1 = inputs.shape[1]
        x = (self.embed(inputs) * math.sqrt(self.D)
             + pe_table(U1, self.D, inputs.device))
        mask = torch.tril(torch.ones((U1, U1), dtype=torch.bool,
                                     device=inputs.device))[None, None]
        for blk in self.blocks:
            q, k, v = blk.qkv(x)
            x = blk.run(x, q, k, v, mask)
        return F.log_softmax(self.proj(self.ln_out(x)), dim=-1)


def build_lm(cfg: ModelConfig, device=None, seed: int = 0) -> nn.Module:
    """The LM of `cfg.lm_type` ('lstm' or 'transformer') on `device` (None
    -> 'cuda'), its weights drawn from `seed` with the reference's
    initialisers."""
    from pytorch_end2end_speech_recognition_tpu_torch.models.asr import (
        init_params,
    )

    kinds = {"transformer": TransformerLm, "lstm": RnnLm}
    if cfg.lm_type not in kinds:
        raise ValueError(f"unknown lm kind {cfg.lm_type}")
    dev = dv.resolve(device)
    with torch.device("meta"):
        lm = kinds[cfg.lm_type](cfg)
    lm.to_empty(device=dev)
    init_params(lm, torch.Generator().manual_seed(seed))
    return lm


def lm_loss(lm: nn.Module, tokens: torch.Tensor, token_lens: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean NLL per valid target (the tokens and eos) and the target count
    (for perplexity)."""
    logps = lm(tokens, token_lens)                       # (B, U+1, V)
    B, U1, _ = logps.shape
    targets = F.pad(tokens.long(), (0, 1))
    targets[torch.arange(B, device=tokens.device), token_lens.long()] = \
        SOS_EOS_ID
    mask = (torch.arange(U1, device=tokens.device)[None, :]
            <= token_lens[:, None])
    nll = -logps.gather(2, targets[..., None])[..., 0]
    total = torch.where(mask, nll, torch.zeros((), device=nll.device)).sum()
    count = mask.sum()
    return total / count.clamp(min=1), count
