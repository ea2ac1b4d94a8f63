"""The shared cases of the serving and decode-CLI tests
(`test_torch_serving.py`, `test_torch_cli_decode.py`): a 2-layer d64
flagship conformer (2-layer transformer decoder d64) and a tiny hybrid
(1-layer BiLSTM d16, the LSTM speller), each a JAX model whose weights are
bridged into the port, with a character tokenizer of the digits corpus,
float32 on the CPU. Each case saves a `best` checkpoint, its tokenizer and
its config in both packages, so that either package's CLIs can load it."""

from types import SimpleNamespace

import numpy as np
import torch
import torch_train_case as case_mod

from pytorch_end2end_speech_recognition_tpu.data.tokenizer import (
    CharTokenizer as JCharTokenizer,
)
from pytorch_end2end_speech_recognition_tpu_torch import bridge
from pytorch_end2end_speech_recognition_tpu_torch.data.audio import load_audio
from pytorch_end2end_speech_recognition_tpu_torch.data.manifest import (
    read_manifest,
)
from pytorch_end2end_speech_recognition_tpu_torch.data.tokenizer import (
    CharTokenizer,
)

SR = 16000


def _save(tmp, jcfg, tcfg, texts):
    for c, tag in ((jcfg, "j"), (tcfg, "t")):
        c.frontend.spec_augment = False
        c.data.batch_size, c.data.n_length_buckets = 4, 1
        c.train.metrics_path = str(tmp / f"{tag}_metrics.jsonl")
        c.train.checkpoint_dir = str(tmp / f"{tag}_ckpt")
        c.data.tokenizer_path = str(tmp / f"{tag}_tokenizer.json")
    jtok, tok = JCharTokenizer(texts), CharTokenizer(texts)
    jtok.save(jcfg.data.tokenizer_path)
    tok.save(tcfg.data.tokenizer_path)
    return jtok, tok


def conformer_case(tmp, digits_corpus):
    """The flagship at 2 layers, d64 (FFN 128, H4) with its 2-layer
    transformer decoder at d64: the JAX Solver's initial weights saved as
    its `best` checkpoint, and the port's Solver with them bridged in,
    saved as the port's `best`."""
    from pytorch_end2end_speech_recognition_tpu.training.solver import (
        Solver as JSolver,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.training.solver import (
        Solver,
    )

    jcfg, tcfg = case_mod.configs(layers=2)
    for c in (jcfg, tcfg):
        m = c.model
        m.encoder_dim, m.encoder_ffn_dim, m.decoder_dim = 64, 128, 64
    texts = [u.text for u in read_manifest(digits_corpus["train"])]
    jtok, tok = _save(tmp, jcfg, tcfg, texts)
    jsolver = JSolver(jcfg, jtok)
    jsolver.save_checkpoint("best")
    solver = Solver(tcfg, tok, device="cpu")
    missing, unexpected = solver.model.load_state_dict(
        bridge.state_dict_from_jax(case_mod.flat(jsolver.model)),
        strict=False)
    assert not unexpected and all(k.startswith("frontend.") for k in missing)
    solver.save_checkpoint("best")
    (tmp / "j_cfg.json").write_text(jcfg.to_json())
    (tmp / "t_cfg.json").write_text(tcfg.to_json())
    return SimpleNamespace(jcfg=jcfg, tcfg=tcfg, jtok=jtok, tok=tok,
                           jsolver=jsolver, solver=solver,
                           jcfg_path=str(tmp / "j_cfg.json"),
                           tcfg_path=str(tmp / "t_cfg.json"))


def hybrid_case(tmp, digits_corpus):
    """`test_torch_beam.py`'s tiny model: a 1-layer BiLSTM d16 encoder and
    the LSTM speller d16 at ctc_weight 0.3, beam 3, decodes capped at
    max_decode_ratio 0.05 of the encoder frames (random weights rarely
    choose eos), the JAX model's weights bridged into the port's `best`
    checkpoint."""
    from pytorch_end2end_speech_recognition_tpu.models.asr import (
        AsrModel as JAsrModel,
    )
    from pytorch_end2end_speech_recognition_tpu.utils.config import (
        AsrConfig as JAsrConfig,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.training.solver import (
        Solver,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
        AsrConfig,
    )
    from flax import nnx

    jcfg, tcfg = JAsrConfig(), AsrConfig()
    texts = [u.text for u in read_manifest(digits_corpus["train"])]
    jtok, tok = _save(tmp, jcfg, tcfg, texts)
    for c in (jcfg, tcfg):
        m = c.model
        m.encoder, m.encoder_layers, m.encoder_dim = "blstm", 1, 16
        m.vocab_size, m.decoder, m.decoder_layers = tok.vocab_size, "lstm", 1
        m.decoder_dim, m.embed_dim = 16, 8
        m.attention_dim, m.location_kernel, m.location_filters = 12, 5, 4
        m.ctc_weight, m.dtype = 0.3, "float32"
        d = c.decode
        d.beam_size, d.pre_beam_k, d.max_decode_ratio = 3, 6, 0.05
    jm = JAsrModel(jcfg, nnx.Rngs(0))
    solver = Solver(tcfg, tok, device="cpu")
    missing, unexpected = solver.model.load_state_dict(
        bridge.state_dict_from_jax(case_mod.flat(jm)), strict=False)
    assert not unexpected and all(k.startswith("frontend.") for k in missing)
    solver.save_checkpoint("best")
    (tmp / "t_cfg.json").write_text(tcfg.to_json())
    return SimpleNamespace(jcfg=jcfg, tcfg=tcfg, jtok=jtok, tok=tok, jm=jm,
                           solver=solver, tcfg_path=str(tmp / "t_cfg.json"))


def audios_of(manifest, n):
    return [load_audio(u.audio, SR) for u in read_manifest(manifest)[:n]]


def padded(audios, B, seconds):
    """The batch a bundle's bucket (B, seconds) makes of the requests."""
    batch = np.zeros((B, int(seconds * SR)), np.float32)
    lens = np.zeros((B,), np.int32)
    for i, a in enumerate(audios):
        batch[i, :len(a)] = a
        lens[i] = len(a)
    return batch, lens


def live_greedy(model, batch, lens, n):
    """The port's live encode -> CTC logits -> greedy ids of the first n
    rows, and the logits and encoder lengths."""
    from pytorch_end2end_speech_recognition_tpu_torch.ops.ctc import (
        ctc_greedy_decode,
    )

    with torch.no_grad():
        enc, enc_lens = model.encode(torch.from_numpy(batch),
                                     torch.from_numpy(lens))
        logits = model.ctc_logits(enc)
        ids, id_lens = ctc_greedy_decode(logits, enc_lens)
    return ([ids[i, :int(id_lens[i])].tolist() for i in range(n)],
            logits.numpy(), enc_lens.numpy())
