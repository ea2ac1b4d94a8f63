"""The port's `Solver.fit` and `Solver.evaluate` against the JAX package's
on the same loader: flagship-small (2 layers, d128, the 2-layer transformer
decoder) with the JAX weights bridged in, float32 on the CPU, dropout 0,
SpecAugment off, three steps of adamw with the noam warmup from the digits
corpus in one bucket shape (one JAX compile), then the greedy dev WER."""

import json

import numpy as np
import pytest
import torch
import torch_train_case as case_mod

from pytorch_end2end_speech_recognition_tpu.data.dataset import (
    BucketedLoader as JLoader,
)
from pytorch_end2end_speech_recognition_tpu.data.manifest import (
    read_manifest as jread_manifest,
)
from pytorch_end2end_speech_recognition_tpu.data.tokenizer import (
    CharTokenizer as JCharTokenizer,
)
from pytorch_end2end_speech_recognition_tpu_torch import bridge
from pytorch_end2end_speech_recognition_tpu_torch.data.dataset import (
    BucketedLoader,
)
from pytorch_end2end_speech_recognition_tpu_torch.data.manifest import (
    read_manifest,
)
from pytorch_end2end_speech_recognition_tpu_torch.data.tokenizer import (
    CharTokenizer,
)

STEPS = 3


@pytest.fixture(scope="module")
def case(tmp_path_factory, digits_corpus):
    from pytorch_end2end_speech_recognition_tpu.training.solver import (
        Solver as JSolver,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.training.solver import (
        Solver,
    )

    tmp = tmp_path_factory.mktemp("solver")
    jcfg, tcfg = case_mod.configs(layers=2)
    for c, tag in ((jcfg, "j"), (tcfg, "t")):
        c.frontend.spec_augment = False
        c.data.batch_size, c.data.n_length_buckets = 4, 1
        c.train.log_every, c.train.eval_every = 1, 1000
        c.train.metrics_path = str(tmp / f"{tag}.jsonl")
        c.train.checkpoint_dir = str(tmp / f"{tag}_ckpt")
    texts = [u.text for u in read_manifest(digits_corpus["train"])]
    jtok, tok = JCharTokenizer(texts), CharTokenizer(texts)
    jsolver = JSolver(jcfg, jtok)
    solver = Solver(tcfg, tok, device="cpu")
    missing, unexpected = solver.model.load_state_dict(
        bridge.state_dict_from_jax(case_mod.flat(jsolver.model)),
        strict=False)
    assert not unexpected and all(k.startswith("frontend.") for k in missing)
    jl = JLoader(jread_manifest(digits_corpus["train"]), jtok, jcfg.data)
    tl = BucketedLoader(read_manifest(digits_corpus["train"]), tok,
                        tcfg.data)
    assert len(tl.shape_set) == 1
    jhist = jsolver.fit(jl, steps=STEPS)
    hist = solver.fit(tl, steps=STEPS)
    jdev = JLoader(jread_manifest(digits_corpus["dev"]), jtok, jcfg.data,
                   train=False)
    dev = BucketedLoader(read_manifest(digits_corpus["dev"]), tok, tcfg.data,
                         train=False)
    return dict(jsolver=jsolver, solver=solver, jhist=jhist, hist=hist,
                jrows=[json.loads(r) for r in open(jcfg.train.metrics_path)],
                jdev=jdev, dev=dev)


def test_fit_losses_and_grad_norms_match_jax(case):
    """Every step's loss, ctc_loss, att_loss and grad_norm within
    `test_torch_train.py`'s 1e-5 relative (measured: 1.4e-6 and 5.3e-6 at
    the third step)."""
    rows, log = case["jrows"], case["solver"].log
    assert [r["step"] for r in rows] == [r["step"] for r in log] == [1, 2, 3]
    for want, got in zip(rows, log):
        for k in ("loss", "ctc_loss", "att_loss", "grad_norm"):
            assert got[k] == pytest.approx(want[k], rel=1e-5), (k, got["step"])
    assert case["hist"]["loss"] == pytest.approx(case["jhist"]["loss"],
                                                 rel=1e-5)
    assert case["solver"].step == case["jsolver"].step == STEPS
    assert (case["solver"].cursor_epoch, case["solver"].cursor_batch) == (
        case["jsolver"].cursor_epoch, case["jsolver"].cursor_batch)


def test_evaluate_gives_the_jax_wer(case):
    """After the three steps: the same greedy ids on every dev batch, the
    same transcripts and the same WER."""
    js, ts = case["jsolver"], case["solver"]
    for jb, tb in zip(case["jdev"].epoch(0), case["dev"].epoch(0)):
        hyp, hyp_lens = ts.greedy_ids(tb)
        arrays = js._put(jb)
        jhyp, jlens = js._eval_step(js.params, js.rest, arrays[0], arrays[1])
        jlens = np.asarray(jlens)
        np.testing.assert_array_equal(hyp_lens, jlens)
        for i, n in enumerate(jlens):
            np.testing.assert_array_equal(hyp[i, :n], np.asarray(jhyp)[i, :n])
        assert ts.decode_batch(tb) == js.decode_batch(jb)
    assert ts.evaluate(case["dev"]) == js.evaluate(case["jdev"])


def test_params_after_fit_stay_close_to_jax(case):
    """Each parameter after three updates within 2 lr0 of the JAX one's
    (Adam's first steps are sign-like, so an element whose gradient is
    float32 noise may move the other way), and all but a few in a
    thousand within 1e-3 lr0."""
    from pytorch_end2end_speech_recognition_tpu.training import schedules

    lr0 = float(schedules.make_schedule(case["jsolver"].cfg.train)(2))
    got = dict(case["solver"].model.named_parameters())
    total = loose = 0
    for name, want in bridge.state_dict_from_jax(
            case_mod.flat(case["jsolver"].merged_model())).items():
        d = (got[name].detach() - want).abs()
        assert float(d.max()) <= 2 * lr0 + 1e-6, name
        total += d.numel()
        loose += int((d > 1e-3 * lr0 + 1e-7).sum())
    assert loose <= 3e-3 * total, (loose, total)
    assert torch.isfinite(torch.stack([p.sum() for p in got.values()])).all()
