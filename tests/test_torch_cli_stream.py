"""The port's `cli/train_lm.py` and `cli/transcribe.py` on the CPU
(`--device cpu`, tiny models): `train_lm` against the JAX package's over 5
steps from the same (bridged) initial weights on the same texts, the LM
checkpoint's round trip, and each of `transcribe`'s four modes (batch
greedy, batch beam, streaming greedy, streaming beam with an LM checkpoint)
printing one JSON line per file equal to the port's in-process path."""

import json

import numpy as np
import pytest
import torch
import torch_train_case as case_mod
from flax import nnx

from pytorch_end2end_speech_recognition_tpu.cli.train_lm import (
    train_lm as jtrain_lm,
)
from pytorch_end2end_speech_recognition_tpu.data.tokenizer import (
    CharTokenizer as JCharTokenizer,
)
from pytorch_end2end_speech_recognition_tpu.models.lm import (
    build_lm as jbuild_lm,
)
from pytorch_end2end_speech_recognition_tpu.utils.config import (
    AsrConfig as JAsrConfig,
)
from pytorch_end2end_speech_recognition_tpu_torch import bridge
from pytorch_end2end_speech_recognition_tpu_torch.cli import train_lm as tlm_cli
from pytorch_end2end_speech_recognition_tpu_torch.cli import transcribe
from pytorch_end2end_speech_recognition_tpu_torch.data.audio import write_wav
from pytorch_end2end_speech_recognition_tpu_torch.data.tokenizer import (
    CharTokenizer,
)
from pytorch_end2end_speech_recognition_tpu_torch.models.lm import build_lm
from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
    AsrConfig,
)

TEXTS = ["a bad cafe", "dead beef", "fade cab", "bead face", "ace bed",
         "deaf dab", "cede a fad", "bad bed", "cafe dead", "a faced bee",
         "abed cafe", "bade fee"]
DEV = ["bad cafe", "fed a bee", "dace fade"]
# parameters after 5 adamw steps at lr 1e-2: Adam's first updates are
# ~lr g / |g|, so float32 gradients summed in another order move a
# parameter by a small fraction of a step (7e-6 seen); the bound is a
# hundredth of one step
PARAM_TOL = 1e-4
PPL_TOL = 1e-4   # relative


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The tensors here are tiny: torch's intra-op thread pool only adds
    overhead to each of their many small ops (7x on a loaded host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lm_cfgs():
    cfgs = []
    for c in (JAsrConfig(), AsrConfig()):
        m = c.model
        m.lm_type, m.lm_layers, m.lm_dim, m.lm_embed_dim = "lstm", 1, 16, 8
        cfgs.append(c)
    return cfgs


def _bridged(jmodule) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in (
        bridge._convert(n, a) for n, a in case_mod.flat(jmodule).items())}


def test_train_lm_matches_jax_and_round_trips(tmp_path):
    """5 steps (batch 4, lr 1e-2) of the port's train_lm, started from the
    weights of JAX build_lm(nnx.Rngs(0)) (what the JAX train_lm starts
    from), against the JAX train_lm: every parameter within PARAM_TOL and
    the dev perplexity within PPL_TOL; the saved checkpoint loads back bit
    for bit through load_lm."""
    jcfg, tcfg = _lm_cfgs()
    jtok, ttok = JCharTokenizer(TEXTS), CharTokenizer(TEXTS)
    assert jtok.vocab == ttok.vocab
    jcfg.model.vocab_size = tcfg.model.vocab_size = ttok.vocab_size
    jparams, jppl = jtrain_lm(jcfg, jtok, TEXTS, DEV, str(tmp_path / "j"),
                              steps=5, batch_size=4, lr=1e-2)
    start = build_lm(tcfg.model, device="cpu")
    start.load_state_dict(_bridged(jbuild_lm(jcfg.model, nnx.Rngs(0))))
    lm, ppl = tlm_cli.train_lm(tcfg, ttok, TEXTS, DEV, str(tmp_path / "t"),
                               steps=5, batch_size=4, lr=1e-2, device="cpu",
                               lm=start)
    want = {k: v for k, v in (bridge._convert(n, a) for n, a in
                              case_mod.flat(jparams).items())}
    got = dict(lm.named_parameters())
    assert set(got) == set(want)
    moved = 0
    for name, p in got.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=0,
                                   atol=PARAM_TOL, err_msg=name)
        moved += not np.allclose(p.detach().numpy(),
                                 _bridged(jbuild_lm(jcfg.model, nnx.Rngs(0)))
                                 [name].numpy())
    assert moved == len(got)
    assert abs(ppl - jppl) <= PPL_TOL * jppl, (ppl, jppl)
    back = tlm_cli.load_lm(str(tmp_path / "t"), tcfg, ttok, device="cpu")
    for name, p in back.named_parameters():
        assert torch.equal(p, got[name]), name


@pytest.fixture(scope="module")
def trained_dir(tmp_path_factory):
    """A tiny hybrid model's checkpoint (BiLSTM d16, the LSTM speller,
    vocab 10) with its tokenizer and config, an LM checkpoint for it, and
    two WAVs of 1.7 s and 2.9 s."""
    from pytorch_end2end_speech_recognition_tpu_torch.training.solver import (
        Solver,
    )

    tmp = tmp_path_factory.mktemp("transcribe")
    cfg = AsrConfig()
    m = cfg.model
    m.encoder, m.encoder_layers, m.encoder_dim = "blstm", 1, 16
    m.decoder, m.decoder_layers, m.decoder_dim = "lstm", 1, 16
    m.embed_dim, m.attention_dim = 8, 12
    m.location_kernel, m.location_filters = 5, 4
    m.ctc_weight, m.dtype = 0.3, "float32"
    m.lm_type, m.lm_layers, m.lm_dim, m.lm_embed_dim = "lstm", 1, 16, 8
    cfg.frontend.spec_augment = False
    cfg.decode.max_decode_ratio = 0.05
    cfg.train.checkpoint_dir = str(tmp / "ckpt")
    cfg.train.metrics_path = ""
    tok = CharTokenizer(charset="abcdef")
    solver = Solver(cfg, tok, device="cpu")
    solver.save_checkpoint("best")
    tok.save(tmp / "ckpt" / "tokenizer.json")
    (tmp / "cfg.json").write_text(solver.cfg.to_json())
    tlm_cli.train_lm(solver.cfg, tok, TEXTS, DEV, str(tmp / "lm"), steps=3,
                     batch_size=4, device="cpu")
    rng = np.random.default_rng(5)
    wavs = []
    for i, n in enumerate((27200, 46400)):
        path = tmp / f"u{i}.wav"
        write_wav(path, (rng.standard_normal(n) * 0.1).astype(np.float32),
                  16000)
        wavs.append(str(path))
    return tmp, solver, tok, wavs


STREAM = ["--chunk-s", "1.0", "--overlap-s", "0.5",
          "--beam-chunk-frames", "32", "--beam-window-frames", "64",
          "--beam-max-tokens", "12"]


@pytest.mark.parametrize("mode", ["greedy", "beam", "stream_greedy",
                                  "stream_beam_lm"])
def test_transcribe_prints_the_in_process_result(trained_dir, mode, capsys):
    from pytorch_end2end_speech_recognition_tpu_torch.data.audio import (
        read_wav,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.decode.beam import (
        BeamSearchDecoder,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.models.streaming import (
        StreamingBeamTranscriber,
        StreamingTranscriber,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops.ctc import (
        ctc_greedy_decode,
    )

    tmp, solver, tok, wavs = trained_dir
    args = ["--config", str(tmp / "cfg.json"), "--checkpoint-tag", "best",
            "--device", "cpu", "--beam-size", "3"]
    if mode in ("beam", "stream_beam_lm"):
        args += ["--mode", "beam"]
    if mode.startswith("stream"):
        args += ["--streaming"] + STREAM
    if mode == "stream_beam_lm":
        args += ["--lm-checkpoint", str(tmp / "lm"), "--lm-weight", "0.3"]
    capsys.readouterr()
    transcribe.main(args + wavs)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["file"] for x in lines] == wavs

    model, cfg = solver.model.eval(), solver.cfg
    cfg.decode.beam_size = 3
    want = []
    for path in wavs:
        audio = read_wav(path)[0]
        if mode.startswith("stream"):
            chunks = [audio[i:i + 16000] for i in range(0, len(audio), 16000)]
            if mode == "stream_greedy":
                st = StreamingTranscriber(model, tok, 1.0, 0.5)
            else:
                cfg.decode.lm_weight = 0.3
                lm = tlm_cli.load_lm(str(tmp / "lm"), cfg, tok, device="cpu")
                st = StreamingBeamTranscriber(
                    model, tok, cfg.decode, lm=lm, chunk_s=1.0,
                    overlap_s=0.5, chunk_frames=32, window_frames=64,
                    max_tokens=12)
            want.append(st.transcribe_stream(chunks))
            continue
        bucket = 1 << int(np.ceil(np.log2(max(len(audio), 16000))))
        a = torch.zeros((1, bucket))
        a[0, :len(audio)] = torch.from_numpy(audio)
        lens = torch.tensor([len(audio)])
        with torch.no_grad():
            if mode == "greedy":
                enc, el = model.encode(a, lens)
                hyp, hl = ctc_greedy_decode(model.ctc_logits(enc), el)
                want.append(tok.decode(hyp[0, :int(hl[0])].tolist()))
            else:
                bsd = BeamSearchDecoder(model, cfg.decode)
                enc, el, lp = bsd.encode(a, lens)
                out = bsd.search_arrays(
                    enc, el, lp,
                    max(4, int(cfg.decode.max_decode_ratio * enc.shape[1])))
                n = int(out["lengths"][0, 0])
                want.append(tok.decode(out["tokens"][0, 0, :n].tolist()))
    assert [x["text"] for x in lines] == want
    assert any(want), want
