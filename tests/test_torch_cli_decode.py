"""The port's `cli/decode.py`, `export.py`, `main.py`, `demo.py` and
`supervise.py` on the CPU (`--device cpu`, tiny models): greedy decode
against the JAX package's `cli.decode` on the same (bridged) checkpoint
weights, line for line and the WER line; beam and attention-only decode
and `--nbest-out` against the port's in-process beam; `cli.export` then
`load_bundle`; `cli.main` routing both ways; `cli.demo` in its CTC-only and
hybrid forms; the JAX supervisor tests' three cases against the port's
`run_supervised` with the same stand-in child."""

import ast
import json
import sys

import numpy as np
import pytest
import torch
import torch_serving_case as sc
from test_supervise import CHILD

from pytorch_end2end_speech_recognition_tpu.cli import decode as jdecode
from pytorch_end2end_speech_recognition_tpu.utils import (
    platform as jplatform,
)
from pytorch_end2end_speech_recognition_tpu_torch.cli import decode
from pytorch_end2end_speech_recognition_tpu_torch.cli import demo
from pytorch_end2end_speech_recognition_tpu_torch.cli import (
    export as cli_export,
)
from pytorch_end2end_speech_recognition_tpu_torch.cli import main as cli_main
from pytorch_end2end_speech_recognition_tpu_torch.cli import train as cli_train
from pytorch_end2end_speech_recognition_tpu_torch.cli.supervise import (
    run_supervised,
)
from pytorch_end2end_speech_recognition_tpu_torch.data.dataset import (
    BucketedLoader,
)
from pytorch_end2end_speech_recognition_tpu_torch.data.manifest import (
    read_manifest,
)
from pytorch_end2end_speech_recognition_tpu_torch.decode.beam import (
    BeamSearchDecoder,
)
from pytorch_end2end_speech_recognition_tpu_torch.serving import load_bundle


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case(tmp_path_factory, digits_corpus):
    """The 2-layer d64 flagship in both packages; its configs name the
    digits corpus' test manifest as `data.test_manifest`."""
    tmp = tmp_path_factory.mktemp("cli_decode")
    c = sc.conformer_case(tmp, digits_corpus)
    for cfg, path in ((c.jcfg, c.jcfg_path), (c.tcfg, c.tcfg_path)):
        cfg.data.test_manifest = str(digits_corpus["test"])
        open(path, "w").write(cfg.to_json())
    c.tmp, c.manifest = tmp, str(digits_corpus["test"])
    return c


def _run(fn, argv, capsys):
    capsys.readouterr()
    fn(argv)
    out = capsys.readouterr()
    wer = [x for x in out.err.splitlines() if x.startswith("WER ")]
    return [json.loads(x) for x in out.out.splitlines()], wer


def test_greedy_decode_matches_the_jax_cli(case, capsys, monkeypatch):
    """The same JSON lines, in the same order, and the same WER/CER/SER
    line as the JAX `cli.decode` on the JAX checkpoint of the same
    weights."""
    monkeypatch.setattr(jplatform, "enable_compilation_cache",
                        lambda *a, **k: None)
    args = ["--checkpoint-tag", "best", "--manifest", case.manifest]
    want, want_wer = _run(jdecode.main, ["--config", case.jcfg_path] + args,
                          capsys)
    got, got_wer = _run(decode.main, ["--config", case.tcfg_path,
                                      "--device", "cpu"] + args, capsys)
    assert len(got) == len(read_manifest(case.manifest)) == len(want)
    assert got == want
    assert len(got_wer) == 1 and got_wer == want_wer


@pytest.mark.parametrize("mode", ["beam", "attention"])
def test_beam_decode_matches_in_process(case, mode, capsys, tmp_path):
    """Beam (joint, beam 3) and attention-only (ctc_weight 0) decoding:
    each line's hyp is the in-process BeamSearchDecoder.decode_batch's
    best text, and `--nbest-out` holds its N-best lists."""
    nbest = tmp_path / "nbest.jsonl"
    got, wer = _run(decode.main, [
        "--config", case.tcfg_path, "--checkpoint-tag", "best",
        "--manifest", case.manifest, "--device", "cpu", "--mode", mode,
        "--beam-size", "3", "--set", "decode.max_decode_ratio=0.2",
        "--nbest-out", str(nbest)], capsys)
    cfg = case.solver.cfg
    cfg.decode.beam_size, cfg.decode.max_decode_ratio = 3, 0.2
    cfg.decode.ctc_weight = 0.0 if mode == "attention" else 0.3
    bsd = BeamSearchDecoder(case.solver.model, cfg.decode)
    loader = BucketedLoader(read_manifest(case.manifest), case.tok, cfg.data,
                            train=False)
    want, want_nbest = [], []
    for batch in loader.epoch(0):
        res = bsd.decode_batch(batch, case.tok)
        want_nbest += [{"id": u, "nbest": r} for u, r in zip(batch.ids, res)]
        want += [{"id": batch.ids[i], "ref": batch.texts[i],
                  "hyp": res[i][0]["text"] if res[i] else ""}
                 for i in range(len(res)) if batch.audio_lens[i] > 0]
    assert got == want and len(wer) == 1
    rows = [json.loads(x) for x in nbest.read_text().splitlines()]
    assert rows == json.loads(json.dumps(want_nbest))
    assert all(len(r["nbest"]) == cfg.decode.nbest for r in rows if r["nbest"])


def test_export_cli_then_load_bundle(case, digits_corpus, tmp_path):
    """`cli.export` writes a bundle (the cross product of its lists) that
    `load_bundle` serves with the live greedy tokens."""
    out = tmp_path / "bundle"
    cli_export.main(["--config", case.tcfg_path, "--checkpoint-tag", "best",
                     "--out-dir", str(out), "--batch-sizes", "1,2",
                     "--seconds", "3", "--device", "cpu"])
    bundle = load_bundle(out)
    assert sorted(bundle.buckets) == [(1, 3), (2, 3)]
    audios = sc.audios_of(digits_corpus["test"], 2)
    batch, lens = sc.padded(audios, 2, 3)
    want, _, _ = sc.live_greedy(case.solver.model, batch, lens, 2)
    assert bundle.transcribe_ids(audios) == want


def test_main_routes_test_to_decode_and_else_to_train(case, capsys,
                                                      monkeypatch):
    """`--test` decodes the config's test manifest, printing what
    `cli.decode` prints; without it the arguments go to `cli.train`."""
    want, want_wer = _run(decode.main, [
        "--config", case.tcfg_path, "--device", "cpu",
        "--manifest", case.manifest], capsys)
    got, got_wer = _run(cli_main.main, [
        "--config", case.tcfg_path, "--test", "--device", "cpu"], capsys)
    assert got == want and got_wer == want_wer and got
    seen = []
    monkeypatch.setattr(cli_train, "main", seen.append)
    cli_main.main(["--config", case.tcfg_path, "--steps", "2",
                   "--device", "cpu"])
    assert seen == [["--config", case.tcfg_path, "--steps", "2",
                     "--device", "cpu"]]


@pytest.mark.parametrize("extra,keys", [
    ([], {"train_wer", "dev_wer"}),
    (["--encoder", "conformer", "--ctc-weight", "0.5", "--decoder",
      "transformer"], {"train_wer", "dev_wer", "beam_dev_wer"})])
def test_demo_runs_on_the_cpu(extra, keys, tmp_path, capsys):
    """The demo's recipe for 2 steps, CTC-only (BiLSTM) and hybrid
    (Conformer + transformer decoder, the beam's dev WER too): it prints
    its result dict with finite WERs."""
    capsys.readouterr()
    demo.main(["--workdir", str(tmp_path), "--steps", "2", "--device", "cpu"]
              + extra)
    result = ast.literal_eval(capsys.readouterr().out.splitlines()[-1])
    assert set(result) == keys
    assert all(np.isfinite(v) and v >= 0 for v in result.values())
    assert (tmp_path / "ckpt" / "last").exists()


# the JAX tests/test_supervise.py cases (:58, :71, :78): child mode,
# hang_timeout, the supervisor's return code and the child's runs
@pytest.mark.parametrize("mode,hang_timeout,rc,runs", [
    ("hang_then_ok", 6.0, 0, 2),
    ("crash_then_ok", 30.0, 0, 2),
    ("always_crash", 30.0, 1, 3)])
def test_supervisor_restarts_as_the_jax_one(mode, hang_timeout, rc, runs,
                                            tmp_path):
    script = tmp_path / "child.py"
    script.write_text(CHILD)
    counter = tmp_path / "count"
    metrics = tmp_path / "metrics.jsonl"
    launcher = [sys.executable, str(script), str(counter), str(metrics),
                mode]
    got = run_supervised([], metrics, hang_timeout=hang_timeout,
                         max_restarts=2, poll_s=0.2, launcher=launcher)
    assert got == rc
    assert int(counter.read_text()) == runs
    if rc == 0:
        assert metrics.read_text() == "step 1\n"
