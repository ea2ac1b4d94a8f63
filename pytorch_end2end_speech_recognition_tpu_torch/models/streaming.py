"""Streaming chunked encoding for unbounded audio (the port of the JAX
package's `models/streaming.py`; rung 5's "streaming chunked encode").

Overlap-carry design: audio arrives in chunks; each encode window is
[left-context tail of already-processed audio | new audio], and outputs are
emitted only for the region past what was already emitted, holding back a
half-overlap margin whose receptive field extends beyond the window. This
is exact for finite-receptive-field stacks (convs) and an approximation for
unbounded ones (attention, BiLSTM) that converges as `overlap_s` grows.

All bookkeeping is in absolute sample positions, so emitted output steps
tile the stream exactly once whatever the chunk sizes. Each window is
padded to a multiple of `chunk + overlap` samples as in the reference: the
result depends on the padded length (the stride-2 subsampling pads by its
parity), so another pad would give other frames. The audio tail, the
emitted frames and the beam's frame buffers stay on the model's device;
the number of frames a window emits is computed on the host from the
frontend's and the encoder's length arithmetic (`encoded_len`), so no
window waits on the device for its length.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.nn.functional as F

from pytorch_end2end_speech_recognition_tpu_torch.ops.frontend import (
    num_frames,
)
from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
    refuse_e_branchformer,
)


def encoded_len(cfg, n_samples: int) -> int:
    """Encoder frames of a row of `n_samples` samples, on the host: the
    frontend's frame count, then the encoder's length arithmetic (x4 conv
    subsampling for the Conformer and Transformer, none for the BiLSTM, the
    VGG's two pools and the pyramid's halvings for the pBLSTM)."""
    n = num_frames(n_samples, cfg.frontend.win_length, cfg.frontend.hop_length)
    m = cfg.model
    if m.encoder in ("conformer", "transformer"):
        return ((n + 1) // 2 + 1) // 2
    if m.encoder == "blstm":
        return n
    if m.encoder == "pblstm":
        if m.vgg_frontend:
            n = n // 2 // 2
        for i in range(m.encoder_layers):
            if 0 < i <= m.pyramid_layers:
                n //= 2
        return n
    raise ValueError(f"unknown encoder kind {m.encoder}")


def _device(model) -> torch.device:
    return next(model.parameters()).device


@dataclass
class StreamState:
    carry: torch.Tensor                # unprocessed/context audio tail
    window_start: int = 0              # absolute sample index of carry[0]
    emitted_upto: int = 0              # absolute sample pos covered by output
    tokens: list = field(default_factory=list)
    last_token: int = 0


class StreamingEncoder:
    """Chunked encode with overlap-carry; one utterance per stream, on the
    model's device."""

    def __init__(self, model, chunk_s: float = 8.0, overlap_s: float = 2.0):
        refuse_e_branchformer(model.cfg.model, "streaming")
        self.model = model
        self.device = _device(model)
        sr = model.cfg.frontend.sample_rate
        hop = model.cfg.frontend.hop_length
        self.sr = sr
        self.hop = hop
        self.chunk = max(int(chunk_s * sr) // hop * hop, 4 * hop)
        self.overlap = max(int(overlap_s * sr) // hop * hop, 2 * hop)
        # samples consumed per encoder output step (the reference probes
        # the encoder once; the same lengths come from the arithmetic)
        probe_len = self.chunk + self.overlap
        flens = num_frames(probe_len, model.cfg.frontend.win_length, hop)
        self.step_samples = hop * max(
            1, int(round(float(flens) / max(self.n_out(probe_len), 1))))

    def n_out(self, n_samples: int) -> int:
        """Frames the encoder emits for a window of `n_samples` samples."""
        return encoded_len(self.model.cfg, n_samples)

    def init_stream(self) -> StreamState:
        return StreamState(carry=torch.zeros((0,), device=self.device))

    @torch.inference_mode()
    def _run_window(self, window: torch.Tensor):
        """Encode one window, padding its length to a bucket size ->
        (enc (n, D), ctc logits (n, V)) on the device."""
        L = int(window.shape[0])
        bucket = self.chunk + self.overlap
        pad_to = max(bucket, ((L + bucket - 1) // bucket) * bucket)
        a = F.pad(window, (0, pad_to - L))[None]
        lens = torch.full((1,), L, dtype=torch.int32, device=self.device)
        enc, _ = self.model.encode(a, lens)
        logits = self.model.ctc_logits(enc)
        n = self.n_out(L)
        return enc[0, :n], logits[0, :n]

    def process(self, state: StreamState, chunk, final: bool = False
                ) -> tuple[StreamState, torch.Tensor, torch.Tensor]:
        """Feed one audio chunk -> (state, new enc frames, new ctc logits),
        the frames on the model's device."""
        chunk = torch.as_tensor(chunk, dtype=torch.float32,
                                device=self.device).reshape(-1)
        audio = torch.cat([state.carry, chunk])
        window_len = self.chunk + self.overlap
        empty = (torch.zeros((0, 1), device=self.device),
                 torch.zeros((0, 1), device=self.device))
        if not final and len(audio) < window_len:
            state.carry = audio
            return state, *empty

        outs_e, outs_l = [], []
        while len(audio) >= window_len or (final and len(audio) > 0):
            window = audio[:window_len] if not final else audio
            enc, logits = self._run_window(window)
            n = len(enc)
            ss = self.step_samples
            # output step j covers absolute samples starting at
            # window_start + j*ss; emit steps past emitted_upto, holding
            # back the trailing half-overlap unless final
            first_j = max(
                0, -(-(state.emitted_upto - state.window_start) // ss))
            if final and len(audio) <= window_len:
                last_j = n
                audio = audio[:0]
            else:
                hold = max(1, (self.overlap // 2) // ss)
                last_j = max(n - hold, first_j)
            if last_j > first_j:
                outs_e.append(enc[first_j:last_j])
                outs_l.append(logits[first_j:last_j])
                state.emitted_upto = state.window_start + last_j * ss
            if len(audio) == 0:
                state.carry = audio
                break
            # slide: keep a half-overlap of context before emitted_upto
            keep_abs = max(state.window_start,
                           state.emitted_upto - self.overlap // 2)
            drop = keep_abs - state.window_start
            audio = audio[drop:]
            state.window_start = keep_abs
            state.carry = audio
            if not final and len(audio) < window_len:
                break
        if outs_e:
            return state, torch.cat(outs_e), torch.cat(outs_l)
        return state, *empty


def _greedy_update(state: StreamState, logits: torch.Tensor) -> None:
    """Online greedy CTC over new logit rows: one host copy of their argmax
    ids."""
    for t in logits.argmax(dim=-1).tolist():
        if t != 0 and t != state.last_token:
            state.tokens.append(int(t))
        state.last_token = int(t)


@dataclass
class _BeamStream:
    enc_state: StreamState
    carry: dict                      # ChunkBeamDecoder device carry
    buf_enc: torch.Tensor            # frames awaiting a full beam chunk
    buf_logp: torch.Tensor
    frames_fed: int = 0
    beam: dict | None = None         # latest beam arrays (partials/final)
    finalized: bool = False


class StreamingBeamTranscriber:
    """Streaming encode + chunk-synchronized joint CTC/attention beam
    (`decode/chunk_beam.py`): encoder frames buffer on the device into
    blocks of `chunk_frames`, each block advances the beam once, and
    everything carried is O(1) in the stream's length. Greedy partials
    stream per feed; `partial_text(..., beam=True)` exposes the current
    best beam hypothesis mid-stream."""

    def __init__(self, model, tokenizer, decode_cfg=None, lm=None,
                 chunk_s: float = 8.0, overlap_s: float = 2.0,
                 chunk_frames: int = 64, window_frames: int = 256,
                 max_tokens: int = 256, steps_per_chunk: int = 16,
                 wait_threshold: float = -2.5):
        from pytorch_end2end_speech_recognition_tpu_torch.decode.chunk_beam import (  # noqa: E501
            ChunkBeamDecoder,
        )
        from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
            DecodeConfig,
        )

        self.enc = StreamingEncoder(model, chunk_s, overlap_s)
        self.device = self.enc.device
        self.tokenizer = tokenizer
        self.cfg = decode_cfg or DecodeConfig(mode="beam")
        self.cb = ChunkBeamDecoder(
            model, self.cfg, lm=lm, chunk_frames=chunk_frames,
            window_frames=window_frames, max_tokens=max_tokens,
            steps_per_chunk=steps_per_chunk, wait_threshold=wait_threshold)

    def init_stream(self) -> _BeamStream:
        z = torch.zeros((0, 1), device=self.device)
        return _BeamStream(enc_state=self.enc.init_stream(),
                           carry=self.cb.init(B=1), buf_enc=z, buf_logp=z)

    def _feed_block(self, s: _BeamStream, block_e, block_l, n_valid: int,
                    final: bool):
        C = self.cb.C
        enc_c = F.pad(block_e, (0, 0, 0, C - len(block_e)))[None]
        logp_c = F.pad(block_l, (0, 0, 0, C - len(block_l)))[None]
        min_tok = 0
        if final:
            total = s.frames_fed + n_valid
            min_tok = int(self.cfg.min_decode_ratio * total)
        full = lambda v: torch.full((1,), v, dtype=torch.long,  # noqa: E731
                                    device=self.device)
        s.carry, beam = self.cb.feed(s.carry, enc_c, logp_c, full(n_valid),
                                     final=final, min_tokens=full(min_tok))
        s.frames_fed += n_valid
        s.beam = beam

    def feed(self, stream: _BeamStream, chunk, final: bool = False):
        s = stream
        s.enc_state, e, logits = self.enc.process(s.enc_state, chunk,
                                                  final=final)
        if len(e):
            _greedy_update(s.enc_state, logits)
            logp = F.log_softmax(logits.float(), dim=-1)
            if s.buf_enc.shape[-1] != e.shape[-1]:
                s.buf_enc = e.new_zeros((0, e.shape[-1]), dtype=torch.float32)
                s.buf_logp = e.new_zeros((0, logp.shape[-1]),
                                         dtype=torch.float32)
            s.buf_enc = torch.cat([s.buf_enc, e.float()])
            s.buf_logp = torch.cat([s.buf_logp, logp])
        C = self.cb.C
        while len(s.buf_enc) >= C:
            last_block = final and len(s.buf_enc) == C
            self._feed_block(s, s.buf_enc[:C], s.buf_logp[:C], C,
                             final=last_block)
            s.buf_enc, s.buf_logp = s.buf_enc[C:], s.buf_logp[C:]
            if last_block:
                s.finalized = True
        if final and not s.finalized:
            n = len(s.buf_enc)  # possibly 0: still resolves EOS on-device
            if s.buf_enc.shape[-1] == 1 and n == 0 and s.frames_fed == 0:
                return s  # nothing was ever encoded
            self._feed_block(s, s.buf_enc, s.buf_logp, n, final=True)
            s.buf_enc, s.buf_logp = s.buf_enc[:0], s.buf_logp[:0]
            s.finalized = True
        return s

    def partial_text(self, stream: _BeamStream, beam: bool = False) -> str:
        """Greedy partial by default (lowest latency); `beam=True` returns
        the chunk beam's current best hypothesis. Until the first beam
        advance (the first `chunk_frames` frames) there is no beam yet, and
        `beam=True` returns the greedy partial, as the reference does."""
        if beam and stream.beam is not None:
            n = int(stream.beam["lengths"][0, 0])
            return self.tokenizer.decode(
                stream.beam["tokens"][0, 0, :n].tolist())
        return self.tokenizer.decode(stream.enc_state.tokens)

    def final_nbest(self, stream: _BeamStream) -> list[dict]:
        if stream.beam is None:
            return []
        tokens = stream.beam["tokens"][0].cpu().numpy()
        lengths = stream.beam["lengths"][0].cpu().numpy()
        scores = stream.beam["scores"][0].cpu().numpy()
        nbest = []
        for k in range(min(self.cfg.nbest, tokens.shape[0])):
            if scores[k] < -1e29:
                continue
            toks = tokens[k, : lengths[k]].tolist()
            nbest.append({"text": self.tokenizer.decode(toks),
                          "tokens": toks, "score": float(scores[k])})
        return nbest

    def transcribe_stream(self, chunks) -> str:
        stream = self.init_stream()
        chunks = list(chunks)
        for i, c in enumerate(chunks):
            stream = self.feed(stream, c, final=(i == len(chunks) - 1))
        nbest = self.final_nbest(stream)
        return nbest[0]["text"] if nbest else ""


class StreamingTranscriber:
    """Online greedy-CTC transcription over a StreamingEncoder."""

    def __init__(self, model, tokenizer, chunk_s: float = 8.0,
                 overlap_s: float = 2.0):
        self.enc = StreamingEncoder(model, chunk_s, overlap_s)
        self.tokenizer = tokenizer

    def feed(self, state: StreamState, chunk, final: bool = False):
        state, _, logits = self.enc.process(state, chunk, final=final)
        if len(logits):
            _greedy_update(state, logits)
        return state

    def transcribe_stream(self, chunks) -> str:
        """Consume an iterable of audio chunks; return the final text."""
        state = self.enc.init_stream()
        chunks = list(chunks)
        for i, c in enumerate(chunks):
            state = self.feed(state, c, final=(i == len(chunks) - 1))
        return self.tokenizer.decode(state.tokens)

