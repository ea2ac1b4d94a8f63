"""Joint CTC/attention beam search with LM shallow fusion (the port of the
JAX package's `decode/beam.py`, id level).

    score(h) = ctc_w psi_ctc(h) + (1 - ctc_w) log P_att(h) + lm_w log P_lm(h)
               + length_penalty |h| + coverage_penalty sum(min(cum_attn, tau))

as in `decode/oracle.py`. All hypothesis state lives in fixed-shape (B, K,
...) tensors on the model's device; the decoder and LM step on the
flattened (B K) rows, and reordering the beams is one gather. Each token
step: the decoder (and LM) step, pre-beam pruning to the `pre_beam_k` best
tokens by (1 - ctc_w) att + lm_w lm (never blank or eos), the CTC prefix
scores of those candidates (`ops/ctc_prefix.py`: the kernels, or the
plain recursion, by `prefix_impl`), slot P of each
hypothesis for eos (live) or keep (finished), the global top K over K (P +
1) candidates, and the parent gather of every state.

Where the reference takes `lax.top_k`, which puts the lower index first on
ties, the port sorts stably in descending order: dead hypotheses all score
NEG_INF, so ties are certain. The token loop holds no host sync: once every
hypothesis of the batch has finished, the reference's `while_loop` stops,
and the port freezes the results on the device instead (their update is a
`where` on that flag), testing the flag on the host once every
SYNC_EVERY steps to leave the loop. The decoder's and LM's K/V caches
are gathered only over the positions written so far: the rest are zero in
every row.

`decode_batch` runs the whole pipeline on a loader's batch and turns the
N-best ids into text with the tokenizer; `decode_ids` stops at the ids.

On a mesh (`mesh=`, the JAX package's multi-device decode) each rank
decodes its own contiguous rows of `decode_batch`'s batch with the whole
model and LM, and the N-best lists are gathered to every rank in input
order (through host tensors). Where the JAX decoder also TP-shards the
decoder's weights under GSPMD, the port gathers a sharded model whole
first and splits by rows only: a token step is launch-bound (the card
idles 82-89% of it), and an all-reduce per linear per step would only add
to that. The tokens are the same.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from pytorch_end2end_speech_recognition_tpu_torch.models.decoder_transformer import (  # noqa: E501
    TransformerDecoder,
)
from pytorch_end2end_speech_recognition_tpu_torch.ops.ctc_prefix import (
    BLANK_ID,
    NEG_INF,
    _by_parent,
    ctc_prefix_score,
    ctc_prefix_select,
    log_add,
    prefix_recursion_plain,
    prefix_select_plain,
)
from pytorch_end2end_speech_recognition_tpu_torch.parallel.collectives import (
    all_gather_objects,
    group_rank,
    size,
)
from pytorch_end2end_speech_recognition_tpu_torch.parallel.mesh import (
    require_mesh,
)
from pytorch_end2end_speech_recognition_tpu_torch.parallel.sharding import (
    gather_model,
)
from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
    DecodeConfig,
)

SOS_EOS_ID = 1
SYNC_EVERY = 8  # token steps between the host's tests of "all finished"


def _top(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, the lower
    index first on ties (as `lax.top_k`)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def blank_padded(ctc_logp: torch.Tensor, enc_lens: torch.Tensor
                 ) -> torch.Tensor:
    """The prefix scorer's log-probs (B, T, V) float32: the CTC log-probs
    with each row's pad frames blank-certain (blank 0, every label
    NEG_INF)."""
    B, T, V = ctc_logp.shape
    dev = ctc_logp.device
    pad = torch.arange(T, device=dev)[None, :, None] >= enc_lens[:, None, None]
    blank_row = torch.where(torch.arange(V, device=dev) == BLANK_ID, 0.0,
                            NEG_INF)
    return torch.where(pad, blank_row, ctc_logp.float()).contiguous()


def _reorder(state: dict | None, rows: torch.Tensor, filled: int):
    """Each tensor of a decoder or LM state gathered along its rows; the
    K/V caches only over their first `filled` positions, in place."""
    if state is None:
        return None
    out = {}
    for name, v in state.items():
        if name in ("k_cache", "v_cache"):
            v[:, :filled] = v[rows, :filled]
            out[name] = v
        else:
            out[name] = v.index_select(0, rows)
    return out


class BeamSearchDecoder:
    """Batched joint beam search over an `AsrModel` (with its decoder) and
    an optional LM (`models/lm.py`), on the model's device. The CTC prefix
    scorer follows `prefix_impl` ('cuda': the kernels, which take their
    plain versions on CPU tensors; 'torch': the plain recursion), by
    default the model's `ctc_impl`. With a `mesh`, every rank of it must
    construct the decoder and call `decode_batch` alike (see the module's
    docstring)."""

    def __init__(self, model, cfg: DecodeConfig, lm=None, mesh=None,
                 prefix_impl: str | None = None):
        require_mesh(mesh)
        self.group = None if mesh is None else mesh.world_group
        model = gather_model(model)
        if model.decoder is None:
            raise ValueError("beam search needs the model's attention "
                             "decoder (ctc_weight < 1)")
        self.model, self.cfg, self.lm = model, cfg, lm
        prefix_impl = prefix_impl or model.cfg.model.ctc_impl
        if prefix_impl not in ("cuda", "torch"):
            raise ValueError(f"prefix_impl={prefix_impl!r}: expected 'cuda' "
                             "or 'torch'")
        self.prefix_kernel = prefix_impl == "cuda"

    @torch.inference_mode()
    def encode(self, audio: torch.Tensor, audio_lens: torch.Tensor):
        """(enc (B, T', D), enc_lens (B,), CTC log-probs (B, T', V))."""
        enc, enc_lens = self.model.encode(audio, audio_lens)
        return enc, enc_lens, F.log_softmax(self.model.ctc_logits(enc),
                                            dim=-1)

    def decode_ids(self, audio: torch.Tensor, audio_lens: torch.Tensor
                   ) -> dict:
        """The reference's `decode_batch` up to the ids: encode, then
        search with max_len = max(4, max_decode_ratio T') and min_lens =
        min_decode_ratio enc_lens. Returns `search_arrays`'s dict."""
        enc, enc_lens, ctc_logp = self.encode(audio, audio_lens)
        max_len = max(4, int(self.cfg.max_decode_ratio * enc.shape[1]))
        min_lens = (enc_lens.float() * self.cfg.min_decode_ratio).to(
            torch.int32)
        return self.search_arrays(enc, enc_lens, ctc_logp, max_len, min_lens)

    def decode_batch(self, batch, tokenizer) -> list[list[dict]]:
        """A bucketed batch -> per-utterance N-best dicts {'text', 'tokens',
        'score'}, best first (`cfg.nbest` of them; [] for pad rows). On a
        mesh, this rank decodes its rows and every rank returns all rows."""
        return by_rows(lambda b: self._decode_rows(b, tokenizer), batch,
                       self.group)

    def _decode_rows(self, batch, tokenizer) -> list[list[dict]]:
        dev = next(self.model.parameters()).device
        out = self.decode_ids(torch.as_tensor(batch.audio, device=dev),
                              torch.as_tensor(batch.audio_lens, device=dev))
        tokens = out["tokens"].cpu().numpy()
        lengths = out["lengths"].cpu().numpy()
        scores = out["scores"].cpu().numpy()
        results = []
        for b in range(tokens.shape[0]):
            if batch.audio_lens[b] == 0:
                results.append([])
                continue
            nbest = []
            for k in range(min(self.cfg.nbest, tokens.shape[1])):
                toks = tokens[b, k, :lengths[b, k]].tolist()
                nbest.append({"text": tokenizer.decode(toks), "tokens": toks,
                              "score": float(scores[b, k])})
            results.append(nbest)
        return results

    def _prefix(self, lp, r_state, last, lengths, cand):
        if self.prefix_kernel:
            return ctc_prefix_score(lp, r_state, last, lengths, cand)
        return prefix_recursion_plain(lp, r_state, cand, last, lengths)[0]

    def _select(self, lp, r_state, last, lengths, parent, tok, is_ext):
        fn = ctc_prefix_select if self.prefix_kernel else prefix_select_plain
        return fn(lp, r_state, last, lengths, parent, tok, is_ext)

    @torch.inference_mode()
    def search_arrays(self, enc, enc_lens, ctc_logp, max_len: int,
                      min_lens=None) -> dict:
        """N-best of every utterance, best first: tokens (B, K, max_len),
        lengths, scores and finished (B, K); `steps`, the token steps
        run."""
        cfg, dec, lm = self.cfg, self.model.decoder, self.lm
        B, T, _ = enc.shape
        V = ctc_logp.shape[-1]
        K = cfg.beam_size
        Pk = min(cfg.pre_beam_k, V - 2)
        BK = B * K
        dev = enc.device
        if min_lens is None:
            min_lens = torch.zeros((B,), dtype=torch.int32, device=dev)
        ctc_w, lm_w = cfg.ctc_weight, cfg.lm_weight
        lp_pen = cfg.length_penalty
        cov_pen, cov_tau = cfg.coverage_penalty, cfg.coverage_tau

        # ---- per-utterance tensors
        mask = torch.arange(T, device=dev)[None, :] < enc_lens[:, None]
        keys = dec.precompute(enc)
        if isinstance(dec, TransformerDecoder):  # attends per utterance
            keys_s, enc_s, mask_s = keys, enc, mask
        else:
            keys_s, enc_s, mask_s = (
                x[:, None].expand(B, K, *x.shape[1:]).reshape(BK, *x.shape[1:])
                for x in (keys, enc, mask))
        lp = blank_padded(ctc_logp, enc_lens)
        lp_blank = lp[:, :, BLANK_ID]

        # ---- the initial beam
        dec_state = dec.init_state(BK, T, max_len, device=dev)
        lm_state = (lm.init_state(BK, max_len + 1, device=dev)
                    if lm is not None else None)
        r_state = torch.stack(
            [torch.full((B, T), NEG_INF, device=dev),
             torch.cumsum(lp_blank, dim=1)], dim=-1)[:, None].repeat(
                 1, K, 1, 1).contiguous()                       # (B, K, T, 2)
        first = (torch.arange(K, device=dev) == 0)[None, :].expand(B, K)
        neg = torch.full((B, K), NEG_INF, device=dev)
        zeros = torch.zeros((B, K), device=dev)
        tokens = torch.zeros((B, K, max_len), dtype=torch.long, device=dev)
        lengths = torch.zeros((B, K), dtype=torch.long, device=dev)
        last = torch.full((B, K), SOS_EOS_ID, dtype=torch.long, device=dev)
        att_cum = torch.where(first, zeros, neg)
        total = att_cum.clone()
        lm_cum = zeros.clone()
        finished = torch.zeros((B, K), dtype=torch.bool, device=dev)
        coverage = zeros.clone()
        cum_attn = torch.zeros((B, K, T), device=dev)
        batch_rows = torch.arange(B, device=dev)[:, None] * K
        slots = torch.arange(max_len, device=dev)
        vocab = torch.arange(V, device=dev)
        never = (vocab == BLANK_ID) | (vocab == SOS_EOS_ID)  # no candidate

        steps = 0
        for step in range(max_len):
            if step and step % SYNC_EVERY == 0 and bool(finished.all()):
                break
            steps += 1
            active = ~finished.all()
            att_logp, dec_state, attn = dec.step(
                last.reshape(BK), dec_state, keys_s, enc_s, mask_s)
            att_logp = att_logp.reshape(B, K, V)
            if cov_pen != 0.0:
                new_cum = cum_attn + attn.reshape(B, K, T)
                new_cov = torch.minimum(new_cum,
                                        torch.full_like(new_cum, cov_tau)
                                        ).sum(dim=-1)
            else:
                new_cum, new_cov = cum_attn, coverage
            if lm is not None:
                lm_logp, lm_state = lm.step(last.reshape(BK), lm_state)
                lm_logp = lm_logp.reshape(B, K, V)
            else:
                lm_logp = torch.zeros((B, K, V), device=dev)

            # ---- pre-beam candidates (never blank or eos)
            pre = torch.where(never, NEG_INF,
                              (1.0 - ctc_w) * att_logp + lm_w * lm_logp)
            cand = _top(pre, Pk)[1]                             # (B, K, Pk)

            psi = (self._prefix(lp, r_state, last, lengths, cand)
                   if ctc_w > 0 else torch.zeros((B, K, Pk), device=dev))
            new_att_cum = att_cum[:, :, None] + att_logp.gather(2, cand)
            new_lm_cum = lm_cum[:, :, None] + lm_logp.gather(2, cand)
            ext_total = ((1.0 - ctc_w) * new_att_cum + ctc_w * psi
                         + lm_w * new_lm_cum
                         + lp_pen * (lengths + 1)[:, :, None]
                         + cov_pen * new_cov[:, :, None])
            # dead or finished hypotheses do not extend
            live = ~finished & (total > NEG_INF / 2)
            ext_total = torch.where(live[:, :, None], ext_total,
                                    torch.full((), NEG_INF, device=dev))

            # ---- slot Pk: eos (live) or keep (finished)
            ctc_eos = (log_add(r_state[:, :, T - 1, 0], r_state[:, :, T - 1, 1])
                       if ctc_w > 0 else zeros)
            eos_total = ((1.0 - ctc_w) * (att_cum + att_logp[:, :, SOS_EOS_ID])
                         + ctc_w * ctc_eos
                         + lm_w * (lm_cum + lm_logp[:, :, SOS_EOS_ID])
                         + lp_pen * lengths + cov_pen * new_cov)
            eos_ok = step >= min_lens[:, None]
            eos_total = torch.where(live & eos_ok, eos_total, neg)
            keep_total = torch.where(finished, total, eos_total)

            # ---- global top K over K (Pk + 1) candidates
            all_scores = torch.cat([ext_total, keep_total[:, :, None]],
                                   dim=2).reshape(B, K * (Pk + 1))
            top_scores, top_idx = _top(all_scores, K)
            parent = top_idx // (Pk + 1)
            slot = top_idx % (Pk + 1)
            is_ext = slot < Pk
            slot_c = slot.clamp(max=Pk - 1)[:, :, None]

            def g2(x):  # (B, K, ...) by parent
                return _by_parent(x, parent)

            tok_ext = g2(cand).gather(2, slot_c)[:, :, 0]
            p_lengths = g2(lengths)
            new_tokens = torch.where(
                is_ext[:, :, None] & (slots == p_lengths[:, :, None]),
                tok_ext[:, :, None], g2(tokens))
            if ctc_w > 0:
                r_state = self._select(lp, r_state, last, lengths, parent,
                                       tok_ext, is_ext)
            flat_parent = (batch_rows + parent).reshape(BK)
            dec_state = _reorder(dec_state, flat_parent, step + 1)
            lm_state = _reorder(lm_state, flat_parent, step + 1)
            last = torch.where(is_ext, tok_ext, g2(last))
            att_cum = torch.where(is_ext, g2(new_att_cum).gather(2, slot_c)[
                :, :, 0], g2(att_cum))
            lm_cum = torch.where(is_ext, g2(new_lm_cum).gather(2, slot_c)[
                :, :, 0], g2(lm_cum))
            coverage = torch.where(is_ext, g2(new_cov), g2(coverage))
            cum_attn = torch.where(is_ext[:, :, None], g2(new_cum),
                                   g2(cum_attn))
            new_finished = ~is_ext | g2(finished)
            # the results, frozen once every hypothesis has finished
            tokens = torch.where(active, new_tokens, tokens)
            lengths = torch.where(active, p_lengths + is_ext, lengths)
            total = torch.where(active, top_scores, total)
            finished = torch.where(active, new_finished, finished)

        order = torch.sort(total, dim=1, descending=True, stable=True).indices
        return {
            "tokens": tokens.gather(1, order[:, :, None].expand_as(tokens)),
            "lengths": lengths.gather(1, order),
            "scores": total.gather(1, order),
            "finished": finished.gather(1, order),
            "steps": steps,
        }


def by_rows(fn, batch, group) -> list:
    """`fn` (a batch -> one result a row) over this rank's rows of `batch`
    (`split_rows`), every rank's results gathered in input order; `fn` of
    the whole batch without a group."""
    if group is None:
        return fn(batch)
    rows = split_rows(len(batch.audio_lens), group)
    mine = fn(batch_rows(batch, rows)) if len(rows) else []
    return [r for part in all_gather_objects(mine, group) for r in part]


def split_rows(n: int, group) -> np.ndarray:
    """This rank's contiguous rows of n (the first n % world ranks take one
    more)."""
    return np.array_split(np.arange(n), size(group))[group_rank(group)]


def batch_rows(batch, rows: np.ndarray):
    """A `Batch` of the given rows (ids and texts, which a loader's batch
    holds for its leading real rows only, likewise)."""
    from pytorch_end2end_speech_recognition_tpu_torch.data.dataset import Batch

    pick = lambda a: a[rows]  # noqa: E731
    return Batch(pick(batch.audio), pick(batch.audio_lens),
                 pick(batch.tokens), pick(batch.token_lens),
                 [batch.ids[i] for i in rows if i < len(batch.ids)],
                 [batch.texts[i] for i in rows if i < len(batch.texts)])
