"""The port's multi-process paths on the CPU, as the JAX package's
tests/test_multihost.py: two ranks over gloo (`tests/torch_parallel_case.py`)
against one process.

- `Solver.fit` on two data ranks, each on its loader shard, equals one
  process fed both shards' batches concatenated (losses, every parameter),
  and both ranks see the one-process dev WER;
- `cli.train --coordinator file://... --num-processes 2` (tp 2) writes one
  checkpoint and one tokenizer and rank 0's metrics alone, and `--resume`
  at dp 2 goes on from it;
- `cli.decode` over two ranks prints the one-process decode's lines and its
  WER line;
- `cli.export` over two ranks (tp 2) writes the bundle that one process's
  export writes.
A rank that fails, or a rendezvous that times out, fails the test."""

import json
import re

import numpy as np
import pytest
import torch

from tests.test_torch_parallel import run_ranks
from tests.torch_parallel_case import fit_cfg, loaders

STEPS = 6


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from pytorch_end2end_speech_recognition_tpu_torch.data.synthetic import (
        make_digits_corpus,
    )

    root = tmp_path_factory.mktemp("digits")
    make_digits_corpus(root, n_train=24, n_dev=6, n_test=6, max_digits=3)
    return str(root)


@pytest.fixture(scope="module")
def cli_runs(corpus, tmp_path_factory):
    """cli.train at tp 2 for 4 steps, `--resume` at dp 2 to 6, cli.decode
    (beam) and cli.export (greedy) of the checkpoint, each over 2 ranks."""
    tmp = tmp_path_factory.mktemp("cli")
    cfg = fit_cfg(corpus, train__tp=2, train__dp=1,
                  train__checkpoint_dir=str(tmp / "ckpt"),
                  train__metrics_path=str(tmp / "metrics.jsonl"))
    cfg.decode.beam_size = 2
    (tmp / "cfg.json").write_text(cfg.to_json())
    common = ["--config", str(tmp / "cfg.json"), "--device", "cpu"]
    runs = [
        {"name": "train", "module": "train", "argv": common + ["--steps", "4"]},
        {"name": "resume", "module": "train",
         "argv": common + ["--steps", str(STEPS), "--resume",
                           "--set", "train.dp=2", "--set", "train.tp=1"]},
        {"name": "decode", "module": "decode",
         "argv": common + ["--checkpoint-tag", "last", "--manifest",
                           f"{corpus}/test.jsonl", "--mode", "beam"]},
        {"name": "export", "module": "export",
         "argv": common + ["--checkpoint-tag", "last", "--out-dir",
                           str(tmp / "bundle"), "--batch-sizes", "2",
                           "--seconds", "2"]},
    ]
    run_ranks(tmp, 2, runs, None, cli=True)
    return tmp, cfg, common


def test_two_process_fit_matches_single(corpus, tmp_path):
    from pytorch_end2end_speech_recognition_tpu_torch.data.dataset import (
        Batch,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.training.solver import (
        Solver,
    )

    out = run_ranks(tmp_path, 2, [{"name": "fit", "kind": "fit",
                                   "mesh": (2, 1), "corpus": corpus,
                                   "steps": STEPS}], {})
    got = [torch.load(out / f"results_{r}.pt", weights_only=False)["fit"]
           for r in range(2)]
    cfg = fit_cfg(corpus)
    tok, _, dev = loaders(cfg)
    shards = [loaders(cfg, s, 2)[1] for s in range(2)]
    solver = Solver(cfg, tok, device="cpu")
    losses, ep = [], 0
    while len(losses) < STEPS:
        for b0, b1 in zip(shards[0].epoch(ep), shards[1].epoch(ep)):
            if len(losses) == STEPS:
                break
            cat = [np.concatenate([getattr(b0, k), getattr(b1, k)])
                   for k in ("audio", "audio_lens", "tokens", "token_lens")]
            losses.append(float(solver.train_step(Batch(*cat))["loss"]))
        ep += 1
    np.testing.assert_allclose(got[0]["losses"], losses, rtol=2e-4)
    for name, p in solver._params().items():
        if re.search(r"\.(k|wk1|wk2)\.bias$", name):
            # the softmax ignores a key bias: its gradient is rounding
            # noise alone, which Adam's normalisation turns into steps
            continue
        np.testing.assert_allclose(got[0]["params"][name].numpy(),
                                   p.detach().numpy(), rtol=5e-4, atol=5e-5,
                                   err_msg=name)
    assert got[0]["wer"] == got[1]["wer"] == solver.evaluate(dev)


def test_cli_train_two_processes(cli_runs):
    """One checkpoint and one tokenizer, rank 0's metrics alone, and a
    resume on another mesh that goes on from the checkpoint's step."""
    tmp, _, _ = cli_runs
    assert sorted(p.name for p in (tmp / "ckpt").iterdir()) == [
        "last", "last.config.json", "tokenizer.json"]
    assert sorted(p.name for p in (tmp / "ckpt" / "last").iterdir()) == [
        "state.pt"]
    rows = [json.loads(x) for x in
            (tmp / "metrics.jsonl").read_text().splitlines()]
    steps = [r["step"] for r in rows if r["tag"] == "train"]
    assert steps == list(range(1, STEPS + 1))
    assert all(np.isfinite(r["loss"]) for r in rows if r["tag"] == "train")
    for r in range(2):
        err = (tmp / f"resume_{r}.err").read_text()
        assert "resuming from last" in err
        assert f"done at step {STEPS}" in err
    assert "mesh defaulted" not in (tmp / "train_0.err").read_text()


def test_cli_decode_two_processes_matches_single(cli_runs, corpus, capsys):
    from pytorch_end2end_speech_recognition_tpu_torch.cli import decode

    tmp, _, common = cli_runs
    decode.main(common + ["--checkpoint-tag", "last", "--manifest",
                          f"{corpus}/test.jsonl", "--mode", "beam"])
    single = capsys.readouterr()
    wer_line = re.search(r"WER .*", single.err).group(0)
    assert re.search(r"WER .*", (tmp / "decode_0.err").read_text()).group(
        0) == wer_line
    assert (tmp / "decode_0.out").read_text() == single.out
    assert (tmp / "decode_1.out").read_text() == ""
    assert len(single.out.splitlines()) == 6


def test_export_bundle_mesh_matches_unsharded(cli_runs, tmp_path):
    from pytorch_end2end_speech_recognition_tpu_torch.data.tokenizer import (
        load_for_config,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.serving.export import (
        export_bundle,
        load_bundle,
    )

    tmp, cfg, _ = cli_runs
    one = export_bundle(cfg, load_for_config(cfg), tmp_path / "one",
                        checkpoint_tag="last", batch_sizes=[2], seconds=[2],
                        device="cpu")
    two = tmp / "bundle"
    prog = "greedy_b2_s2.pt2"
    a = torch.export.load(str(one / prog)).state_dict
    b = torch.export.load(str(two / prog)).state_dict
    assert set(a) == set(b) and a
    assert all(torch.equal(a[k], b[k]) for k in a)
    rng = np.random.default_rng(3)
    audios = [rng.standard_normal(n).astype(np.float32) * 0.1
              for n in (16000, 23000)]
    assert (load_bundle(one).transcribe_ids(audios)
            == load_bundle(two).transcribe_ids(audios))
