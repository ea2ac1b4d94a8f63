"""The port's trainer on its own, on the CPU: checkpoints (a round trip bit
for bit, retention of step checkpoints, the vocabulary guard), exact
resume (k steps, save, load, N - k steps equal N steps bit for bit, with
dropout, SpecAugment and time warp drawing from the generator), the
plateau decay, `decode_batch` text (greedy and beam), and
`cli.train` end to end with `--device cpu`, then `--resume`."""

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pytorch_end2end_speech_recognition_tpu_torch.configs.presets import (
    flagship_conformer,
)
from pytorch_end2end_speech_recognition_tpu_torch.data.dataset import (
    BucketedLoader,
)
from pytorch_end2end_speech_recognition_tpu_torch.data.manifest import (
    read_manifest,
)
from pytorch_end2end_speech_recognition_tpu_torch.data.tokenizer import (
    CharTokenizer,
    Tokenizer,
)
from pytorch_end2end_speech_recognition_tpu_torch.training import checkpoint
from pytorch_end2end_speech_recognition_tpu_torch.training.solver import Solver

TINY = {"model.encoder_layers": 1, "model.encoder_dim": 64,
        "model.encoder_ffn_dim": 128, "model.encoder_heads": 2,
        "model.decoder_layers": 1, "model.decoder_dim": 32,
        "model.subsample_channels": 8}


def tiny_cfg(tmp, **train):
    cfg = flagship_conformer()
    for k, v in TINY.items():
        cfg.override(k, str(v))
    cfg.data.batch_size, cfg.data.n_length_buckets = 4, 2
    cfg.train.checkpoint_dir = str(tmp / "ckpt")
    cfg.train.metrics_path = str(tmp / "ckpt" / "metrics.jsonl")
    cfg.train.log_every, cfg.train.eval_every = 1, 1000
    cfg.train.schedule, cfg.train.lr = "constant", 1e-3
    cfg.frontend.time_warp_param = 5
    for k, v in train.items():
        setattr(cfg.train, k, v)
    return cfg


@pytest.fixture(scope="module")
def data(digits_corpus):
    utts = read_manifest(digits_corpus["train"])
    dev = read_manifest(digits_corpus["dev"])
    return utts, dev, CharTokenizer([u.text for u in utts])


def solver_and_loader(tmp, data, **train):
    utts, _, tok = data
    cfg = tiny_cfg(tmp, **train)
    return Solver(cfg, tok, device="cpu"), BucketedLoader(utts, tok, cfg.data)


def state(solver):
    """Parameters, optimizer state and generator state, flattened."""
    opt = solver.opt.state_dict()
    return ([p.detach().clone() for p in solver.params]
            + [t.clone() for t in opt["m1"] + opt["m2"] + opt["acc"]]
            + [solver.generator.get_state()]), (opt["count"],
                                                opt["mini_step"])


def test_checkpoint_round_trip_is_bit_exact(tmp_path, data):
    """After two steps: save, load into a fresh Solver; parameters,
    optimizer state (adadelta inside MultiSteps, mid-accumulation) and
    generator state equal bit for bit, with the meta fields; the file
    loads with weights_only=True."""
    s, loader = solver_and_loader(tmp_path, data, optimizer="adadelta",
                                  grad_accum_steps=3)
    s.fit(loader, steps=2)
    s.lr_scale, s.best_wer, s.evals_since_best = 0.25, 0.5, 1
    s.save_checkpoint("last")
    raw = torch.load(tmp_path / "ckpt" / "last" / "state.pt",
                     weights_only=True)
    assert set(raw) == {"params", "opt_state", "meta"}
    assert (tmp_path / "ckpt" / "last.config.json").exists()
    r, _ = solver_and_loader(tmp_path, data, optimizer="adadelta",
                             grad_accum_steps=3)
    r.load_checkpoint("last")
    (a, ca), (b, cb) = state(s), state(r)
    assert ca == cb == (0, 2)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    assert (r.step, r.best_wer, r.lr_scale, r.evals_since_best) == (
        2, 0.5, 0.25, 1)
    assert (r.cursor_epoch, r.cursor_batch) == (s.cursor_epoch,
                                                s.cursor_batch) == (0, 2)


@pytest.mark.parametrize("optimizer,accum,k", [("adamw", 1, 3),
                                               ("adadelta", 2, 3),
                                               ("adamw", 1, 6)])
def test_resume_equals_the_uninterrupted_run(tmp_path, data, optimizer,
                                             accum, k):
    """k steps, save, load into a fresh Solver, N - k steps: the same
    parameters, optimizer and generator state, and the same logged losses
    as N steps in one go, bit for bit. Dropout 0.1, SpecAugment with time
    warp; k = 6 resumes at the epoch boundary (6 batches an epoch)."""
    N = 10
    full, loader = solver_and_loader(tmp_path / "a", data,
                                     optimizer=optimizer,
                                     grad_accum_steps=accum)
    assert len(loader) == 6
    full.fit(loader, steps=N)
    part, loader = solver_and_loader(tmp_path / "b", data,
                                     optimizer=optimizer,
                                     grad_accum_steps=accum)
    part.fit(loader, steps=k)
    part.save_checkpoint("last")
    resumed, loader = solver_and_loader(tmp_path / "b", data,
                                        optimizer=optimizer,
                                        grad_accum_steps=accum)
    resumed.load_checkpoint("last")
    resumed.fit(loader, steps=N)
    (a, ca), (b, cb) = state(full), state(resumed)
    assert ca == cb and all(torch.equal(x, y) for x, y in zip(a, b))
    assert [r["loss"] for r in full.log] == [
        r["loss"] for r in part.log + resumed.log]
    assert (resumed.cursor_epoch, resumed.cursor_batch) == (1, 4)


def test_step_checkpoints_are_retained_and_best_kept(tmp_path, data):
    """eval_every 1, keep_checkpoints 2, five steps: exactly the newest two
    step_* directories and their configs, best, its config, and dev
    records in metrics.jsonl."""
    utts, dev, tok = data
    s, loader = solver_and_loader(tmp_path, data, eval_every=1,
                                  keep_checkpoints=2)
    s.fit(loader, BucketedLoader(dev, tok, s.cfg.data, train=False), steps=5)
    ckpt = tmp_path / "ckpt"
    assert sorted(p.name for p in ckpt.glob("step_*")) == [
        "step_00000004", "step_00000004.config.json", "step_00000005",
        "step_00000005.config.json"]
    assert (ckpt / "best" / "state.pt").exists()
    assert (ckpt / "best.config.json").exists()
    assert checkpoint.latest_step_checkpoint(str(ckpt)) == "step_00000005"
    assert checkpoint.load_config(str(ckpt), "best").to_dict() == \
        s.cfg.to_dict()
    rows = [json.loads(r) for r in open(ckpt / "metrics.jsonl")]
    assert [r["step"] for r in rows if r["tag"] == "dev"] == [1, 2, 3, 4, 5]
    assert [r["step"] for r in rows if r["tag"] == "train"] == [1, 2, 3, 4, 5]


def test_evaluation_logs_the_attention_image_to_tensorboard(
        tmp_path, data, monkeypatch):
    """With a tensorboard writer, each evaluation writes one utterance's
    decoder attention (its longest transcript) as an image of (U+1, T')
    weights, each row summing to 1 (the writer is stubbed: importing
    tensorboard here would load TensorFlow)."""
    utts, dev, tok = data
    s, loader = solver_and_loader(tmp_path, data, eval_every=2)
    images = []
    monkeypatch.setattr(s.logger, "_tb", SimpleNamespace(
        add_scalar=lambda *a, **kw: None))
    monkeypatch.setattr(s.logger, "log_image",
                        lambda tag, a, step: images.append((tag, a, step)))
    s.fit(loader, BucketedLoader(dev, tok, s.cfg.data, train=False), steps=4)
    assert [(t, st) for t, _, st in images] == [("dev/attention", 2),
                                                ("dev/attention", 4)]
    for _, a, _ in images:
        assert a.ndim == 2 and 2 <= a.shape[0] <= 17 and a.shape[1] > 5
        np.testing.assert_allclose(a.sum(axis=1), 1.0, rtol=1e-5)


def test_vocab_hash_guards_checkpoint_mismatch(tmp_path, data):
    """A checkpoint loads with its own vocabulary and raises ValueError
    with another of the same size."""
    utts, _, _ = data
    cfg = tiny_cfg(tmp_path)
    tok_a, tok_b = CharTokenizer(charset="ABC"), CharTokenizer(charset="ABD")
    Solver(cfg, tok_a, device="cpu").save_checkpoint("last")
    Solver(cfg, tok_a, device="cpu").load_checkpoint("last")
    with pytest.raises(ValueError, match="tokenizer/checkpoint mismatch"):
        Solver(cfg, tok_b, device="cpu").load_checkpoint("last")


def test_plateau_decays_after_patience_evals_without_improvement(
        tmp_path, data, monkeypatch):
    """With patience 2 and factor 0.5: the scale halves after two dev WERs
    that do not improve on the best, the count restarts after a decay or
    an improvement, and each dev record holds the scale in force when it
    was measured (the reference's order); best is saved on improvement."""
    utts, dev, tok = data
    s, loader = solver_and_loader(tmp_path, data, eval_every=1,
                                  schedule="plateau", plateau_patience=2)
    wers = iter([0.9, 0.95, 0.97, 0.96, 0.8, 0.85, 0.8, 0.9])
    monkeypatch.setattr(s, "evaluate", lambda loader: next(wers))
    saved = []
    monkeypatch.setattr(s, "save_checkpoint",
                        lambda tag="last": saved.append((s.step, tag)))
    s.fit(loader, BucketedLoader(dev, tok, s.cfg.data, train=False), steps=8)
    rows = [json.loads(r) for r in open(tmp_path / "ckpt" / "metrics.jsonl")]
    scales = [r["lr_scale"] for r in rows if r["tag"] == "dev"]
    assert scales == [1.0, 1.0, 1.0, 0.5, 0.5, 0.5, 0.5, 0.25]
    assert s.lr_scale == 0.25 and s.best_wer == 0.8
    assert saved == [(1, "best"), (5, "best")]


def test_decode_batch_text_greedy_and_beam(tmp_path, data):
    """Solver.decode_batch is the tokenizer's text of the greedy ids;
    BeamSearchDecoder.decode_batch's N-best texts are the tokenizer's text
    of decode_ids' tokens, best first, and a pad row gets []."""
    from pytorch_end2end_speech_recognition_tpu_torch.decode.beam import (
        BeamSearchDecoder,
    )

    utts, dev, tok = data
    s, _ = solver_and_loader(tmp_path, data)
    loader = BucketedLoader(dev, tok, s.cfg.data, train=False)
    batch = next(iter(loader.epoch(0)))
    assert (batch.audio_lens == 0).any()
    hyp, lens = s.greedy_ids(batch)
    texts = s.decode_batch(batch)
    assert texts == [tok.decode(hyp[i, :lens[i]]) for i in range(len(hyp))]
    assert any(texts)
    dcfg = s.cfg.decode
    dcfg.beam_size, dcfg.nbest, dcfg.pre_beam_k = 3, 2, 6
    dcfg.max_decode_ratio = 0.3
    dec = BeamSearchDecoder(s.model, dcfg)
    out = dec.decode_batch(batch, tok)
    ids = dec.decode_ids(torch.as_tensor(batch.audio),
                         torch.as_tensor(batch.audio_lens))
    for b, nbest in enumerate(out):
        if batch.audio_lens[b] == 0:
            assert nbest == []
            continue
        assert len(nbest) == 2
        assert nbest[0]["score"] >= nbest[1]["score"]
        for k, hypk in enumerate(nbest):
            n = int(ids["lengths"][b, k])
            assert hypk["tokens"] == ids["tokens"][b, k, :n].tolist()
            assert hypk["text"] == tok.decode(hypk["tokens"])


def cli_args(tmp, corpus, steps, *extra):
    args = ["--config", "flagship_conformer", "--device", "cpu",
            "--set", f"data.train_manifest={corpus['train']}",
            "--set", f"data.dev_manifest={corpus['dev']}",
            "--set", "data.batch_size=4", "--set", "data.n_length_buckets=2",
            "--set", f"train.steps={steps}", "--set", "train.eval_every=2",
            "--set", "train.log_every=1", "--set", "train.keep_checkpoints=2",
            "--set", "train.schedule=plateau",
            "--set", "train.plateau_patience=1",
            "--set", f"train.checkpoint_dir={tmp}/ckpt",
            "--set", f"train.metrics_path={tmp}/ckpt/metrics.jsonl"]
    for k, v in TINY.items():
        args += ["--set", f"{k}={v}"]
    return args + list(extra)


def test_cli_train_end_to_end_then_resume(tmp_path, digits_corpus):
    """`cli.train --device cpu` for 4 steps, then `--resume` to 6: the
    tokenizer copy, last, best, two step checkpoints with configs, train
    and dev records; the resumed run ends with the parameters of an
    uninterrupted 6-step run, bit for bit."""
    from pytorch_end2end_speech_recognition_tpu_torch.cli import train

    s4 = train.main(cli_args(tmp_path / "a", digits_corpus, 4))
    assert s4.step == 4 and s4.device.type == "cpu"
    s6 = train.main(cli_args(tmp_path / "a", digits_corpus, 6, "--resume"))
    one = train.main(cli_args(tmp_path / "b", digits_corpus, 6))
    assert s6.step == one.step == 6
    assert all(torch.equal(a, b) for a, b in zip(s6.params, one.params))
    assert s6.lr_scale == one.lr_scale
    ckpt = tmp_path / "a" / "ckpt"
    names = sorted(p.name for p in ckpt.iterdir())
    assert names == ["best", "best.config.json", "last", "last.config.json",
                     "metrics.jsonl", "step_00000004",
                     "step_00000004.config.json", "step_00000006",
                     "step_00000006.config.json", "tokenizer.json"]
    tok = Tokenizer.load(ckpt / "tokenizer.json")
    assert tok.vocab_hash() == s6.tokenizer.vocab_hash()
    rows = [json.loads(r) for r in open(ckpt / "metrics.jsonl")]
    assert [r["step"] for r in rows if r["tag"] == "train"] == list(
        range(1, 7))
    assert [r["step"] for r in rows if r["tag"] == "dev"] == [2, 4, 6]
    assert checkpoint.load_checkpoint(str(ckpt), "last")["step"] == 6


def test_cli_train_refuses_parallelism_and_needs_a_card(
        tmp_path, digits_corpus, monkeypatch, capsys):
    """Since the parallelism slice the multi-process flags run (two-process
    checks: tests/test_torch_multiproc.py); refused are the flags without a
    rendezvous, a mesh that is not the port's, and CUDA without a card.
    train.dp = 2 on one process trains at dp 1, as the JAX CLI's mesh
    default does, and says so."""
    from pytorch_end2end_speech_recognition_tpu_torch.cli import train

    with pytest.raises(ValueError, match="env://"):
        train.main(cli_args(tmp_path, digits_corpus, 1, "--distributed"))
    with pytest.raises(SystemExit):
        train.main(cli_args(tmp_path, digits_corpus, 1,
                            "--process-id", "0"))
    monkeypatch.setenv("ASR_PROCESS_ID", "1")
    with pytest.raises(SystemExit):
        train.main(cli_args(tmp_path, digits_corpus, 1))
    monkeypatch.delenv("ASR_PROCESS_ID")
    with pytest.raises(TypeError, match="make_mesh"):
        Solver(tiny_cfg(tmp_path), CharTokenizer(charset="AB"), device="cpu",
               mesh=object())
    solver = train.main(cli_args(tmp_path / "dp2", digits_corpus, 1,
                                 "--set", "train.dp=2"))
    assert "mesh defaulted to dp=1 tp=1" in capsys.readouterr().err
    assert solver.step == 1 and solver.mesh.dp == solver.mesh.tp == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = cli_args(tmp_path, digits_corpus, 1)
    i = args.index("--device")
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(args[:i] + args[i + 2:])
    assert not Path(tmp_path / "ckpt" / "last").exists()
