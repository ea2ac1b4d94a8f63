"""Chunk-synchronized joint CTC/attention beam search with bounded state (the
port of the JAX package's `decode/chunk_beam.py`).

The beam ADVANCES once per fixed-size chunk of encoder frames, and
everything carried across chunks is O(1) in the stream's length:

- hypothesis arrays (tokens, lengths, scores) bounded by `max_tokens`;
- a sliding right-aligned window of the last `window_frames` encoder
  frames for the attention decoder (and the location-aware speller's
  attention history, shifted with the window);
- per-hypothesis CTC lattice columns (r_n, r_b) over that same window:
  each chunk extends every carried hypothesis's lattice over the new frames
  (`lat_step`, a loop over the chunk's frames), and candidate extensions
  are scored with emission anywhere in the window, chained through the
  column just before the window (the prefix kernels' `r_init`);
- the windowed CTC log-probs, and the decoder's and LM's incremental state
  with per-row positions (hypotheses fall out of lockstep once they can
  wait).

Within a chunk each live hypothesis offers `pre_beam_k` extensions and one
WAIT slot advertised at `total + wait_threshold`: an extension is taken only
when its joint score beats waiting. All scores of a fixed prefix are
constant within a chunk, so a hypothesis that waits once is settled for the
rest of it. On the final chunk the wait slot is the EOS slot, with the CTC
end mass of the carried lattice, and end detection stops the search once a
finished hypothesis leads every live one by `final_margin` (off when a
length or coverage penalty is positive).

The reference's token loop is a `lax.while_loop` whose condition is global:
the body runs on every row while any row still runs, and re-sorts a settled
row's hypotheses each time. The port runs the body exactly as often: the
condition is computed on the device each step and every piece of state is
frozen once it turns false (a `where` on that flag), and the host tests the
flag once every SYNC_EVERY steps to leave the loop; there is no other host
sync in the loop. The budget is `max_tokens` steps on the final chunk,
`steps_per_chunk` otherwise.

A waiting hypothesis keeps its parent's old decoder and LM state. The K/V
caches are written in place, so the write that the waiting hypothesis's step
made at its position p stays in the cache; it is never read: rows read only
positions up to their own, and the hypothesis's next step (its position is
still p) overwrites position p before reading it. Positions below p hold
what the extensions wrote, as in the reference.

Deliberate difference: the reference carries the pre-window column
`r_prevcol` from one chunk to the next and never reads it (each chunk
recomputes it from the lattice window, JAX `decode/chunk_beam.py:273` and
`:516`). The port's carry leaves it out; the results are the same.
"""

from __future__ import annotations

import torch

from pytorch_end2end_speech_recognition_tpu_torch.decode.beam import (
    SOS_EOS_ID,
    SYNC_EVERY,
    _top,
)
from pytorch_end2end_speech_recognition_tpu_torch.models.decoder_transformer import (  # noqa: E501
    TransformerDecoder,
)
from pytorch_end2end_speech_recognition_tpu_torch.models.lm import (
    TransformerLm,
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
from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
    DecodeConfig,
)

CACHES = ("k_cache", "v_cache")


def _pick(stepped: dict | None, old: dict | None, rows: torch.Tensor,
          take: torch.Tensor) -> dict | None:
    """The kept hypotheses' decoder or LM state: row `rows[i]` of the
    stepped state where `take[i]`, else of the old one. The K/V caches are
    one tensor in both (written in place), so they are only gathered."""
    if stepped is None:
        return None
    out = {}
    for name, new in stepped.items():
        if name in CACHES:
            out[name] = new.index_select(0, rows)
        else:
            m = take.reshape((-1,) + (1,) * (new.dim() - 1))
            out[name] = torch.where(m, new.index_select(0, rows),
                                    old[name].index_select(0, rows))
    return out


class ChunkBeamDecoder:
    """Streaming joint beam over fixed-size encoder-frame chunks, on the
    model's device.

    Usage:
        cb = ChunkBeamDecoder(model, decode_cfg, lm=lm)
        carry = cb.init(B=1)
        for each chunk of `chunk_frames` encoder frames:
            carry, beam = cb.feed(carry, enc_c, logp_c, chunk_len,
                                  final=..., min_tokens=...)
        # `beam` holds the current (tokens, lengths, scores, finished),
        # score-sorted: partials mid-stream, the N-best after the final
        # chunk; `beam['steps']` the token steps the advance ran.

    The CTC prefix scorer follows `prefix_impl` ('cuda': the kernels, which
    take their plain versions on CPU tensors; 'torch': the plain
    recursion), by default the model's `ctc_impl`.
    """

    def __init__(self, model, cfg: DecodeConfig, lm=None,
                 chunk_frames: int = 64, window_frames: int = 256,
                 steps_per_chunk: int = 16, max_tokens: int = 256,
                 wait_threshold: float = -2.5,
                 final_margin: float = 25.0,
                 prefix_impl: str | None = None):
        assert window_frames >= chunk_frames > 0
        if model.decoder is None:
            raise ValueError("the chunk beam needs the model's attention "
                             "decoder (ctc_weight < 1)")
        self.model, self.cfg, self.lm = model, cfg, lm
        self.C = int(chunk_frames)
        self.W = int(window_frames)
        self.S = int(steps_per_chunk)
        self.U = int(max_tokens)
        self.tau = float(wait_threshold)
        self.final_margin = float(final_margin)
        self._dec_per_row = isinstance(model.decoder, TransformerDecoder)
        self._lm_per_row = isinstance(lm, TransformerLm)
        self._d_enc = model.encoder.d_out
        self._vocab = int(model.cfg.model.vocab_size)
        self.device = next(model.parameters()).device
        prefix_impl = prefix_impl or model.cfg.model.ctc_impl
        if prefix_impl not in ("cuda", "torch"):
            raise ValueError(f"prefix_impl={prefix_impl!r}: expected 'cuda' "
                             "or 'torch'")
        self.prefix_kernel = prefix_impl == "cuda"

    # ------------------------------------------------------------------ init
    def init(self, B: int = 1) -> dict:
        """Device carry for B parallel streams."""
        K, W, U, dev = self.cfg.beam_size, self.W, self.U, self.device
        # U + 1 positions: a hypothesis at the U-token cap is still stepped
        # for its EOS score at position U
        dec_state = self.model.decoder.init_state(B * K, W, U + 1,
                                                  device=dev)
        lm_state = (self.lm.init_state(B * K, U + 1, device=dev)
                    if self.lm is not None else None)
        neg = torch.full((B, K), NEG_INF, device=dev)
        zeros = torch.zeros((B, K), device=dev)
        # pre-stream window slots behave as an infinite blank-certain
        # prehistory: columns (r_n=-inf, r_b=0), blank-certain log-probs
        r0 = torch.stack([torch.full((B, K, W), NEG_INF, device=dev),
                          torch.zeros((B, K, W), device=dev)], dim=-1)
        blank_row = torch.where(
            torch.arange(self._vocab, device=dev) == BLANK_ID, 0.0, NEG_INF)
        return {
            "enc_win": torch.zeros((B, W, self._d_enc), device=dev),
            "win_valid": torch.zeros((B, W), dtype=torch.bool, device=dev),
            "tokens": torch.zeros((B, K, U), dtype=torch.long, device=dev),
            "lengths": torch.zeros((B, K), dtype=torch.long, device=dev),
            "last": torch.full((B, K), SOS_EOS_ID, dtype=torch.long,
                               device=dev),
            "att_cum": zeros.clone(),
            "lm_cum": zeros.clone(),
            "total": torch.where(
                (torch.arange(K, device=dev) == 0)[None, :], zeros, neg),
            "finished": torch.zeros((B, K), dtype=torch.bool, device=dev),
            "coverage": zeros.clone(),
            "cum_attn": torch.zeros((B, K, W), device=dev),
            "r_win": r0,
            "lp_win": blank_row.expand(B, W, self._vocab).contiguous(),
            "dec_state": dec_state,
            "lm_state": lm_state,
        }

    # -------------------------------------------------------------- pieces
    def _prefix(self, lp, r_win, last, lengths, cand, r_init):
        if self.prefix_kernel:
            return ctc_prefix_score(lp, r_win, last, lengths, cand, r_init)
        return prefix_recursion_plain(lp, r_win, cand, last, lengths,
                                      r_init=r_init)[0]

    def _select(self, lp, r_win, last, lengths, parent, tok, is_ext, r_init):
        fn = ctc_prefix_select if self.prefix_kernel else prefix_select_plain
        return fn(lp, r_win, last, lengths, parent, tok, is_ext, r_init=r_init)

    @staticmethod
    def lat_step(r_col, lp_last, lp_blank):
        """The within-prefix lattice over a chunk's frames, from the window's
        last column r_col (B, K, 2): stay in n by re-emitting the last token
        (lp_last (B, K, C)), move n -> b or stay in b on blank (lp_blank
        (B, C)) -> the new columns (B, K, C, 2). A loop over the C frames,
        as the reference's `lax.scan`."""
        r_n, r_b = r_col[..., 0], r_col[..., 1]
        cols = []
        for t in range(lp_last.shape[2]):
            n_new = r_n + lp_last[:, :, t]
            b_new = log_add(r_b, r_n) + lp_blank[:, t, None]
            r_n, r_b = n_new, b_new
            cols.append(torch.stack([n_new, b_new], dim=-1))
        return torch.stack(cols, dim=2)

    # ------------------------------------------------------------------ feed
    @torch.inference_mode()
    def feed(self, carry: dict, enc_chunk, ctc_logp_chunk, chunk_len,
             final: bool = False, min_tokens=None):
        """Advance the beam over one chunk.

        enc_chunk (B, C, d_enc); ctc_logp_chunk (B, C, V) log-softmax;
        chunk_len (B,) valid frames (C except possibly on the final chunk);
        min_tokens (B,) the fewest tokens an EOS needs (on the final
        chunk). Pass chunk_len and min_tokens as tensors on the model's
        device to keep the feed free of host copies. Returns (carry, beam)
        with beam's 'tokens' (B, K, U), 'lengths', 'scores', 'finished'
        score-sorted and 'steps' the token steps run. `carry` is consumed:
        the decoder's and LM's K/V caches are updated in place."""
        cfg, dec, lm = self.cfg, self.model.decoder, self.lm
        dev = self.device
        B = enc_chunk.shape[0]
        V = ctc_logp_chunk.shape[-1]
        K, Pk = cfg.beam_size, min(cfg.pre_beam_k, V - 2)
        C, W, U = self.C, self.W, self.U
        BK = B * K
        ctc_w, lm_w = cfg.ctc_weight, cfg.lm_weight
        lp_pen = cfg.length_penalty
        cov_pen, cov_tau = cfg.coverage_penalty, cfg.coverage_tau
        tau = self.tau
        chunk_len = torch.as_tensor(chunk_len, device=dev)
        min_tokens = (torch.zeros((B,), dtype=torch.long, device=dev)
                      if min_tokens is None
                      else torch.as_tensor(min_tokens, device=dev))
        enc_chunk = enc_chunk.to(dev)
        logp_c = ctc_logp_chunk.to(dev).float()

        # ---- pad rows of the chunk: blank certain, labels impossible
        vocab = torch.arange(V, device=dev)
        pad = torch.arange(C, device=dev)[None, :, None] >= \
            chunk_len[:, None, None]
        blank_row = torch.where(vocab == BLANK_ID, 0.0, NEG_INF)
        lp = torch.where(pad, blank_row, logp_c)                 # (B, C, V)
        lp_blank = lp[:, :, BLANK_ID]

        # ---- slide the window left by C (right-aligned; the validity mask
        # covers the not-yet-full window)
        enc_win = torch.cat([carry["enc_win"], enc_chunk.float()], 1)[:, C:]
        win_valid = torch.cat(
            [carry["win_valid"],
             torch.arange(C, device=dev)[None, :] < chunk_len[:, None]],
            1)[:, C:]
        cum_attn = torch.cat(
            [carry["cum_attn"], torch.zeros((B, K, C), device=dev)],
            2)[:, :, C:]
        dec_state = carry["dec_state"]
        if "attn" in dec_state:
            # the location-attention history slides with the window
            dec_state = dict(dec_state)
            dec_state["attn"] = torch.cat(
                [dec_state["attn"], torch.zeros((BK, C), device=dev)],
                1)[:, C:]
        keys = dec.precompute(enc_win)
        if self._dec_per_row:  # attends per utterance
            keys_s, enc_s, mask_s = keys, enc_win, win_valid
        else:
            keys_s, enc_s, mask_s = (
                x[:, None].expand(B, K, *x.shape[1:]).reshape(
                    BK, *x.shape[1:]) for x in (keys, enc_win, win_valid))

        # ---- the windowed CTC log-probs slide with the frames
        lp_win = torch.cat([carry["lp_win"], lp], 1)[:, C:].contiguous()

        # ---- extend every carried hypothesis's lattice over the new chunk,
        # chained from the window's last column, then slide it
        r_win = carry["r_win"]
        lp_last = lp.gather(2, carry["last"][:, None, :].expand(B, C, K)) \
            .transpose(1, 2)                                     # (B, K, C)
        lp_last = torch.where((carry["lengths"] > 0)[:, :, None], lp_last,
                              NEG_INF)
        r_new_frames = self.lat_step(r_win[:, :, W - 1], lp_last, lp_blank)
        r_prevcol = r_win[:, :, C - 1]
        r_win = torch.cat([r_win[:, :, C:], r_new_frames], 2).contiguous()

        tokens, lengths = carry["tokens"], carry["lengths"]
        last = carry["last"]
        att_cum, lm_cum = carry["att_cum"], carry["lm_cum"]
        total, finished = carry["total"], carry["finished"]
        coverage = carry["coverage"]
        settled = torch.zeros((B, K), dtype=torch.bool, device=dev)
        lm_state = carry["lm_state"]

        budget = U if final else self.S
        # end detection assumes extensions only add negative log terms; a
        # positive length or coverage penalty lets a live hypothesis gain
        # score per token, so the early stop is off for those configs
        end_detect = final and lp_pen <= 0.0 and cov_pen <= 0.0
        never = (vocab == BLANK_ID) | (vocab == SOS_EOS_ID)
        slots = torch.arange(U, device=dev)
        batch_rows = torch.arange(B, device=dev)[:, None] * K
        ident = torch.arange(BK, device=dev)
        neg2 = torch.full((B, K, 2), NEG_INF, device=dev)
        dec_kw = {"per_row_pos": True} if self._dec_per_row else {}
        lm_kw = {"per_row_pos": True} if self._lm_per_row else {}

        steps = 0
        for i in range(budget):
            # the reference's loop condition, on the device
            row_done = (finished | settled).all(dim=1)
            if end_detect:
                best_fin = torch.where(finished, total, NEG_INF).amax(1)
                best_live = torch.where(~finished, total, NEG_INF).amax(1)
                row_done = row_done | (best_fin > best_live
                                       + self.final_margin)
            active = ~row_done.all()
            if i and i % SYNC_EVERY == 0 and not bool(active):
                break
            steps += 1

            att_logp, stepped_dec, attn = dec.step(
                last.reshape(BK), dec_state, keys_s, enc_s, mask_s, **dec_kw)
            att_logp = att_logp.reshape(B, K, V)
            if cov_pen != 0.0:
                new_cum = cum_attn + attn.reshape(B, K, W)
                new_cov = torch.minimum(
                    new_cum, torch.full_like(new_cum, cov_tau)).sum(-1)
            else:
                new_cum, new_cov = cum_attn, coverage
            if lm is not None:
                lm_logp, stepped_lm = lm.step(last.reshape(BK), lm_state,
                                              **lm_kw)
                lm_logp = lm_logp.reshape(B, K, V)
            else:
                lm_logp = torch.zeros((B, K, V), device=dev)
                stepped_lm = None

            pre = torch.where(never, NEG_INF,
                              (1.0 - ctc_w) * att_logp + lm_w * lm_logp)
            cand = _top(pre, Pk)[1]                              # (B, K, Pk)
            if ctc_w > 0:
                psi = self._prefix(lp_win, r_win, last, lengths, cand,
                                   r_prevcol)
            else:
                psi = torch.zeros((B, K, Pk), device=dev)

            new_att_cum = att_cum[:, :, None] + att_logp.gather(2, cand)
            new_lm_cum = lm_cum[:, :, None] + lm_logp.gather(2, cand)
            ext_total = ((1.0 - ctc_w) * new_att_cum + ctc_w * psi
                         + lm_w * new_lm_cum
                         + lp_pen * (lengths + 1)[:, :, None]
                         + cov_pen * new_cov[:, :, None])
            live = (~finished & ~settled & (total > NEG_INF / 2)
                    & (lengths < U))
            ext_total = torch.where(live[:, :, None], ext_total, NEG_INF)

            # ---- slot Pk: WAIT mid-stream, EOS on the final chunk; the CTC
            # end mass is the lattice total at the window's last frame
            alive = ~finished & (total > NEG_INF / 2)
            ctc_eos = (log_add(r_win[:, :, W - 1, 0], r_win[:, :, W - 1, 1])
                       if ctc_w > 0 else torch.zeros((B, K), device=dev))
            eos_total = ((1.0 - ctc_w) * (att_cum
                                          + att_logp[:, :, SOS_EOS_ID])
                         + ctc_w * ctc_eos
                         + lm_w * (lm_cum + lm_logp[:, :, SOS_EOS_ID])
                         + lp_pen * lengths + cov_pen * new_cov)
            eos_ok = lengths >= min_tokens[:, None]
            eos_total = torch.where(alive & eos_ok, eos_total, NEG_INF)
            wait_true = torch.where(alive, total, NEG_INF)
            if final:
                slot_true = torch.where(finished, total, eos_total)
                slot_adv = slot_true
            else:
                # waiting is advertised tau below its true score, so an
                # extension with acoustic evidence in this chunk outbids it;
                # a selected wait stores the true score
                slot_true, slot_adv = wait_true, wait_true + tau

            all_adv = torch.cat([ext_total, slot_adv[:, :, None]],
                                2).reshape(B, K * (Pk + 1))
            all_true = torch.cat([ext_total, slot_true[:, :, None]],
                                 2).reshape(B, K * (Pk + 1))
            top_idx = _top(all_adv, K)[1]
            new_total = all_true.gather(1, top_idx)
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
                r_sel = self._select(lp_win, r_win, last, lengths, parent,
                                     tok_ext, is_ext, r_prevcol)
            else:
                r_sel = torch.where(is_ext[:, :, None, None], 0.0, g2(r_win))
            new_finished = g2(finished)
            if final:
                new_finished = new_finished | ~is_ext
            new = {
                "tokens": new_tokens,
                "lengths": p_lengths + is_ext,
                "last": torch.where(is_ext, tok_ext, g2(last)),
                "att_cum": torch.where(
                    is_ext, g2(new_att_cum).gather(2, slot_c)[:, :, 0],
                    g2(att_cum)),
                "lm_cum": torch.where(
                    is_ext, g2(new_lm_cum).gather(2, slot_c)[:, :, 0],
                    g2(lm_cum)),
                "total": new_total,
                "finished": new_finished,
                # a wait settles the hypothesis for the rest of the chunk
                "settled": torch.where(is_ext, False,
                                       g2(settled) | (not final)),
                "coverage": torch.where(is_ext, g2(new_cov), g2(coverage)),
                "cum_attn": torch.where(is_ext[:, :, None], g2(new_cum),
                                        g2(cum_attn)),
                "r_win": r_sel,
                "r_prevcol": torch.where(is_ext[:, :, None], neg2,
                                         g2(r_prevcol)),
            }
            # everything frozen once the loop condition is false
            (tokens, lengths, last, att_cum, lm_cum, total, finished,
             settled, coverage, cum_attn, r_win, r_prevcol) = (
                torch.where(active, new[k], old) for k, old in (
                    ("tokens", tokens), ("lengths", lengths), ("last", last),
                    ("att_cum", att_cum), ("lm_cum", lm_cum),
                    ("total", total), ("finished", finished),
                    ("settled", settled), ("coverage", coverage),
                    ("cum_attn", cum_attn), ("r_win", r_win),
                    ("r_prevcol", r_prevcol)))
            rows = torch.where(active, (batch_rows + parent).reshape(BK),
                               ident)
            take = is_ext.reshape(BK) & active
            dec_state = _pick(stepped_dec, dec_state, rows, take)
            lm_state = _pick(stepped_lm, lm_state, rows, take)

        new_carry = {
            "enc_win": enc_win, "win_valid": win_valid, "tokens": tokens,
            "lengths": lengths, "last": last, "att_cum": att_cum,
            "lm_cum": lm_cum, "total": total, "finished": finished,
            "coverage": coverage, "cum_attn": cum_attn, "r_win": r_win,
            "lp_win": lp_win, "dec_state": dec_state, "lm_state": lm_state,
        }
        order = torch.sort(total, dim=1, descending=True, stable=True).indices
        beam = {
            "tokens": tokens.gather(1, order[:, :, None].expand_as(tokens)),
            "lengths": lengths.gather(1, order),
            "scores": total.gather(1, order),
            "finished": finished.gather(1, order),
            "steps": steps,
        }
        return new_carry, beam
