"""One-shot transcription of WAV files with a trained checkpoint (the port of
the JAX package's `cli/transcribe.py`). Usage:

    python -m pytorch_end2end_speech_recognition_tpu_torch.cli.transcribe \
        --config cfg.json --checkpoint-tag best a.wav b.wav \
        [--mode beam --beam-size 10 --lm-checkpoint lm_dir] \
        [--streaming --chunk-s 8] [--device cpu]

Prints one JSON line `{"file": ..., "text": ...}` per file. Without
`--streaming` each file is one padded batch row (greedy CTC, or the joint
CTC/attention beam with `--mode beam`); with it, the file is fed in
`--chunk-s` pieces through the overlap-carry streaming encoder
(`models/streaming.py`), with greedy CTC or, with `--mode beam`, the
chunk-synchronized joint beam (`decode/chunk_beam.py`): the path for audio
of unbounded length. An LM checkpoint (`cli/train_lm.py`) is fused when
`--lm-checkpoint` is given and `decode.lm_weight` > 0. Runs on CUDA unless
`--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", required=True)
    ap.add_argument("--checkpoint-tag", default="best")
    ap.add_argument("--mode", default="greedy", choices=["greedy", "beam"])
    ap.add_argument("--beam-size", type=int, default=None)
    ap.add_argument("--lm-weight", type=float, default=None)
    ap.add_argument("--lm-checkpoint", default=None)
    ap.add_argument("--streaming", action="store_true",
                    help="chunked streaming encode; with --mode beam, "
                         "greedy partials + chunk-synchronized joint beam")
    ap.add_argument("--chunk-s", type=float, default=8.0)
    ap.add_argument("--overlap-s", type=float, default=2.0)
    # chunk-synchronized beam knobs (decode/chunk_beam.py; --mode beam)
    ap.add_argument("--beam-chunk-frames", type=int, default=64,
                    help="encoder frames per beam advance")
    ap.add_argument("--beam-window-frames", type=int, default=256,
                    help="sliding attention/CTC window (fidelity knob)")
    ap.add_argument("--beam-max-tokens", type=int, default=256,
                    help="carried-hypothesis token budget (O(1) state)")
    ap.add_argument("--set", action="append", default=[], metavar="K=V")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("wavs", nargs="+", help="WAV files to transcribe")
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)

    import numpy as np
    import torch

    from pytorch_end2end_speech_recognition_tpu_torch.cli.train import (
        load_config,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.data.audio import (
        read_wav,
        resample,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.data.tokenizer import (
        load_for_config,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.training.solver import (
        Solver,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
        parse_overrides,
    )

    cfg = parse_overrides(load_config(args.config), args.set)
    if args.beam_size is not None:
        cfg.decode.beam_size = args.beam_size
    if args.lm_weight is not None:
        cfg.decode.lm_weight = args.lm_weight
    tok = load_for_config(cfg)
    # the Solver only holds the checkpoint's weights here: no metrics file
    cfg.train.metrics_path = cfg.train.tensorboard_dir = ""
    solver = Solver(cfg, tok, device=args.device)
    solver.load_checkpoint(args.checkpoint_tag)
    model = solver.model.eval()
    dev = solver.device
    cfg = solver.cfg
    sr = cfg.frontend.sample_rate

    def load_audio(path):
        wav, wav_sr = read_wav(path)
        if wav_sr != sr:
            wav = resample(wav, wav_sr, sr)
        return np.asarray(wav, np.float32)

    lm = None
    if args.mode == "beam" and args.lm_checkpoint and cfg.decode.lm_weight > 0:
        from pytorch_end2end_speech_recognition_tpu_torch.cli.train_lm import (
            load_lm,
        )

        lm = load_lm(args.lm_checkpoint, cfg, tok, device=dev)

    if args.streaming:
        from pytorch_end2end_speech_recognition_tpu_torch.models.streaming import (  # noqa: E501
            StreamingBeamTranscriber,
            StreamingTranscriber,
        )

        if args.mode == "beam":
            st = StreamingBeamTranscriber(
                model, tok, cfg.decode, lm=lm,
                chunk_s=args.chunk_s, overlap_s=args.overlap_s,
                chunk_frames=args.beam_chunk_frames,
                window_frames=args.beam_window_frames,
                max_tokens=args.beam_max_tokens)
        else:
            st = StreamingTranscriber(model, tok, chunk_s=args.chunk_s,
                                      overlap_s=args.overlap_s)
        for path in args.wavs:
            audio = load_audio(path)
            step = int(args.chunk_s * sr)
            chunks = [audio[i : i + step] for i in range(0, len(audio), step)]
            text = st.transcribe_stream(chunks or [audio])
            print(json.dumps({"file": path, "text": text}), flush=True)
        return

    from pytorch_end2end_speech_recognition_tpu_torch.ops.ctc import (
        ctc_greedy_decode,
    )

    beam = None
    if args.mode == "beam":
        from pytorch_end2end_speech_recognition_tpu_torch.decode.beam import (
            BeamSearchDecoder,
        )

        beam = BeamSearchDecoder(model, cfg.decode, lm=lm)

    for path in args.wavs:
        audio = load_audio(path)
        # pad to a coarse bucket, as the reference does to bound recompiles
        # (the padded length decides the stride-2 subsampling's padding)
        bucket = 1 << max(int(np.ceil(np.log2(max(len(audio), sr)))), 0)
        a = np.zeros((1, bucket), np.float32)
        a[0, : len(audio)] = audio
        a = torch.from_numpy(a).to(dev)
        lens = torch.tensor([len(audio)], dtype=torch.int32, device=dev)
        with torch.inference_mode():
            if beam is not None:
                enc, enc_lens, logp = beam.encode(a, lens)
                max_len = max(4, int(cfg.decode.max_decode_ratio
                                     * enc.shape[1]))
                out = beam.search_arrays(enc, enc_lens, logp, max_len)
                n = int(out["lengths"][0, 0])
                text = tok.decode(out["tokens"][0, 0, :n].tolist())
            else:
                enc, enc_lens = model.encode(a, lens)
                hyp, hyp_lens = ctc_greedy_decode(model.ctc_logits(enc),
                                                  enc_lens)
                text = tok.decode(hyp[0, : int(hyp_lens[0])].tolist())
        print(json.dumps({"file": path, "text": text}), flush=True)


if __name__ == "__main__":
    main()
