"""Serving bundles: a trained checkpoint as one program per (batch,
seconds) bucket (the port of the JAX package's `serving/export.py`).

A greedy bundle holds, for each bucket, a `torch.export` program of encode
-> CTC logits -> greedy collapse with the weights inside, saved with
`torch.export.save`. The hand-written kernels on that path are registered
operators (`asr_port::logmel`, `subsample`, `toeplitz_expand`,
`attention_fwd`, `flash_fwd`, `lstm_fwd`, `ffn_fwd`; `ops/*_kernel.py`),
so the program calls them as nodes of its graph: a serving host loads it
without the model code (`ops`' registrations and the tokenizer are all it
imports).
The path gates are static per bucket, so each bucket's program has its path
fixed: a 30 s bucket (T' 750) takes the dense-bias attention, a 60 s bucket
(T' 1,498) the flash attention.

A beam bundle differs from the JAX one, which exports the whole joint
CTC/attention beam as one program. The port's beam loop cannot be one
exported program: its host tests "all finished" every SYNC_EVERY steps,
its reorder and eos gate take the step as a Python int, and unrolling it
to max_len steps would make a graph of max_len times ~600 operators a
bucket. So a beam bundle holds `weights.pt` (the model's state dict) and
`config.json`; `ServingBundle` rebuilds the model from them and runs
`BeamSearchDecoder.decode_ids` on the bucket-padded batch, which derives
the bucket's max_len and the min_decode_ratio from the config; `meta.json`
records both, as the JAX exporter bakes them into its program. It needs the
port's model code.

Bundle layout (one directory):
    meta.json                  mode, format, device, sample rate, buckets,
                               vocab hash (+ max_len, min_decode_ratio)
    tokenizer.json             vocab for host-side detokenization
    greedy_b{B}_s{S}.pt2       one program per (batch, seconds) bucket
    weights.pt, config.json    (mode='beam')

Usage:
    python -m pytorch_end2end_speech_recognition_tpu_torch.cli.export \\
        --config cfg.json --checkpoint-tag best --out-dir bundle/ \\
        [--mode beam --batch-sizes 1,8 --seconds 10,30] [--device cpu]

Serving host: `load_bundle(dir).transcribe(list_of_float_arrays)` pads to
the smallest covering bucket and detokenizes; the bundle runs on the device
it was exported on (a CUDA bundle raises without a card).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn as nn

# the operators a greedy program calls: importing these registers them
from pytorch_end2end_speech_recognition_tpu_torch.ops import (  # noqa: F401
    attention_kernel,
    ffn_kernel,
    frontend_kernel,
    rnn_kernel,
    subsample_kernel,
)
from pytorch_end2end_speech_recognition_tpu_torch.ops.ctc import (
    ctc_greedy_decode,
)
from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
    refuse_e_branchformer,
)

FORMATS = {"greedy": "torch.export", "beam": "state"}


class GreedyProgram(nn.Module):
    """What a greedy bundle exports: the model's frontend, encoder and CTC
    head (no decoder weights), audio (B, Ts) float32 and lengths (B,) int32
    -> (tokens (B, T') int32, lengths (B,) int32), as `AsrModel.encode`,
    `ctc_logits` and `ctc_greedy_decode` compute them."""

    def __init__(self, model):
        super().__init__()
        self.frontend = model.frontend
        self.encoder = model.encoder
        self.ctc_head = model.ctc_head

    def forward(self, audio: torch.Tensor, audio_lens: torch.Tensor):
        feats, flens = self.frontend(audio, audio_lens)
        enc, enc_lens = self.encoder(feats, flens)
        return ctc_greedy_decode(self.ctc_head(enc), enc_lens)


def export_bundle(cfg, tokenizer, out_dir, checkpoint_tag="best",
                  mode="greedy", batch_sizes=(1, 8), seconds=(10, 30),
                  device=None, mesh=None) -> Path:
    """Export the checkpoint `checkpoint_tag` of `cfg.train.checkpoint_dir`
    into a serving bundle directory, on `device` (None -> 'cuda'): export
    on the device that will serve. One program (greedy) or one max_len
    (beam) for each bucket of the cross product of `batch_sizes` and
    `seconds`. Each program's export time and size go to stderr.

    `mesh`: restore the checkpoint through a Solver sharded over the
    training mesh (every rank of it calls this alike), gather its state
    whole, and export single-device programs, equal to an unsharded
    export; rank 0 writes the bundle, on the mesh's device."""
    if mode not in FORMATS:
        raise ValueError(f"unknown bundle mode {mode!r}: 'greedy' or 'beam'")
    refuse_e_branchformer(cfg.model, "export_bundle")
    from pytorch_end2end_speech_recognition_tpu_torch.models.streaming import (
        encoded_len,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.training.solver import (
        Solver,
    )

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    cfg = copy.deepcopy(cfg)
    # the Solver only holds the checkpoint's weights here: no metrics file
    cfg.train.metrics_path = cfg.train.tensorboard_dir = ""
    solver = Solver(cfg, tokenizer, device=device, mesh=mesh)
    solver.load_checkpoint(checkpoint_tag)
    if mesh is not None:
        from pytorch_end2end_speech_recognition_tpu_torch.parallel.sharding import (  # noqa: E501
            gather_model,
        )

        model = gather_model(solver.model)
        if mesh.rank != 0:
            return out
        solver.model = model
    model = solver.model.eval()
    dev, cfg = solver.device, solver.cfg
    sr = cfg.frontend.sample_rate
    if mode == "beam":
        torch.save(model.state_dict(), out / "weights.pt")
        (out / "config.json").write_text(cfg.to_json())
    program = None
    if mode == "greedy":
        _lstm_as_operator(model.encoder, cfg.model)
        program = GreedyProgram(model).eval()
    arts = []
    for B in batch_sizes:
        for S in seconds:
            Ts = int(S * sr)
            if mode == "beam":
                T = encoded_len(cfg, Ts)
                arts.append({"file": "weights.pt", "batch": B, "seconds": S,
                             "max_len": max(4, int(
                                 cfg.decode.max_decode_ratio * T))})
                continue
            name = f"greedy_b{B}_s{S}.pt2"
            t0 = time.perf_counter()
            with torch.no_grad():
                ep = torch.export.export(program, (
                    torch.zeros((B, Ts), dtype=torch.float32, device=dev),
                    torch.zeros((B,), dtype=torch.int32, device=dev)))
            ep.example_inputs = None  # else the file keeps the zero batch
            torch.export.save(ep, out / name)
            print(f"[export] {name}: {time.perf_counter() - t0:.1f} s, "
                  f"{(out / name).stat().st_size} bytes, "
                  f"{len(ep.graph.nodes)} graph nodes", file=sys.stderr)
            arts.append({"file": name, "batch": B, "seconds": S})
    tokenizer.save(out / "tokenizer.json")
    meta = {
        "mode": mode,
        "format": FORMATS[mode],
        "sample_rate": sr,
        "artifacts": arts,
        "vocab_hash": tokenizer.vocab_hash(),
        "device": dev.type,
        "config_name": cfg.name,
    }
    if mode == "beam":
        meta["min_decode_ratio"] = cfg.decode.min_decode_ratio
    (out / "meta.json").write_text(json.dumps(meta, indent=2))
    return out


def _lstm_as_operator(encoder, mcfg) -> None:
    """Have a (p)BiLSTM encoder with `lstm_impl='torch'` run its recurrence
    as the LSTM operator in the exported program, one graph node (the plain
    loop would unroll over T): on CPU tensors the operator is the kernel's
    plain version, on CUDA tensors the kernel. Both do the recurrent product
    in float32, as `lstm_scan` does only at dtype float32, so another dtype
    raises rather than export a program that computes differently."""
    if mcfg.encoder not in ("blstm", "pblstm") or mcfg.lstm_impl != "torch":
        return
    if mcfg.dtype != "float32":
        raise ValueError(
            f"export_bundle: a {mcfg.encoder} encoder with lstm_impl='torch' "
            f"exports only at dtype float32 (got {mcfg.dtype!r}): its "
            "exported recurrence multiplies in float32")
    encoder.cfg = dataclasses.replace(encoder.cfg, lstm_impl="cuda")


class ServingBundle:
    """Host-side loader: pads requests into the smallest covering bucket
    and detokenizes results. A greedy bundle needs no model code, only the
    bundle directory and the port's operators; a beam bundle rebuilds the
    model from its config and weights."""

    def __init__(self, bundle_dir):
        from pytorch_end2end_speech_recognition_tpu_torch.data.tokenizer import (  # noqa: E501
            Tokenizer,
        )
        from pytorch_end2end_speech_recognition_tpu_torch.utils import (
            device as dv,
        )

        self.dir = Path(bundle_dir)
        self.meta = json.loads((self.dir / "meta.json").read_text())
        self.tokenizer = Tokenizer.load(self.dir / "tokenizer.json")
        if self.tokenizer.vocab_hash() != self.meta["vocab_hash"]:
            raise ValueError("bundle tokenizer.json does not match meta "
                             "vocab_hash — corrupted bundle")
        mode = self.meta["mode"]
        if FORMATS.get(mode) != self.meta.get("format"):
            raise ValueError(f"bundle mode {mode!r} with format "
                             f"{self.meta.get('format')!r}")
        self.device = dv.resolve(self.meta["device"])
        self.buckets = {(a["batch"], a["seconds"]): a
                        for a in self.meta["artifacts"]}
        self._programs = {}
        self._beam = None
        if mode == "beam":
            self._beam = self._load_beam()
        else:
            for key, art in self.buckets.items():
                self._programs[key] = torch.export.load(
                    self.dir / art["file"]).module()

    def _load_beam(self):
        from pytorch_end2end_speech_recognition_tpu_torch.decode.beam import (
            BeamSearchDecoder,
        )
        from pytorch_end2end_speech_recognition_tpu_torch.models.asr import (
            AsrModel,
        )
        from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
            AsrConfig,
        )

        cfg = AsrConfig.from_json((self.dir / "config.json").read_text())
        model = AsrModel(cfg, device=self.device)
        model.load_state_dict(torch.load(
            self.dir / "weights.pt", map_location=self.device,
            weights_only=True))
        return BeamSearchDecoder(model.eval(), model.cfg.decode)

    def _pick_bucket(self, n_utts: int, max_samples: int):
        sr = self.meta["sample_rate"]
        fits = [(b, s) for (b, s) in self.buckets
                if b >= n_utts and s * sr >= max_samples]
        if not fits:
            raise ValueError(
                f"no exported bucket covers batch={n_utts}, "
                f"samples={max_samples}; exported: {sorted(self.buckets)}")
        return min(fits, key=lambda bs: (bs[0], bs[1]))

    @torch.no_grad()
    def transcribe_ids(self, audios) -> list[list[int]]:
        """Token ids of each request (the best hypothesis in beam mode):
        audios is a list of 1-D float arrays at the bundle's sample rate."""
        n = len(audios)
        max_samples = max(len(a) for a in audios)
        B, S = self._pick_bucket(n, max_samples)
        Ts = int(S * self.meta["sample_rate"])
        batch = np.zeros((B, Ts), np.float32)
        lens = np.zeros((B,), np.int32)
        for i, a in enumerate(audios):
            batch[i, : len(a)] = np.asarray(a, np.float32)
            lens[i] = len(a)
        audio = torch.from_numpy(batch).to(self.device)
        audio_lens = torch.from_numpy(lens).to(self.device)
        if self._beam is not None:
            out = self._beam.decode_ids(audio, audio_lens)
            tokens, lengths = out["tokens"][:, 0], out["lengths"][:, 0]
        else:
            tokens, lengths = self._programs[(B, S)](audio, audio_lens)
        # one copy to the host: the lengths ride in column 0
        host = torch.cat([lengths[:, None].to(tokens.dtype), tokens],
                         dim=1).cpu().numpy()
        return [host[i, 1:1 + host[i, 0]].tolist() for i in range(n)]

    def transcribe(self, audios) -> list[str]:
        """audios: list of 1-D float arrays (sample_rate mono)."""
        return [self.tokenizer.decode(ids)
                for ids in self.transcribe_ids(audios)]


def load_bundle(bundle_dir) -> ServingBundle:
    return ServingBundle(bundle_dir)
