"""A model family is a property of the configuration: a second family that
exists only in new files (`decoder_reference`, `decoder_path`: the small
Conformer hybrid model served greedily by its Transformer decoder's token
loop, judged on the step log-probs of the served tokens) runs through the
harness to `correct`, and its two controls read not correct: one served
token altered, and the reference in float8 in the program's place. The
harness's shared files name no family.

The limits here are the tests' own, set from CPU readings of seeds 11-14
(float32 program, plain path): `logp_rel_err` 2.2e-6 to 4.4e-6 for the
program against 0.106 to 0.168 for the float8 reference; `max_logp_gap` 0
for the program, 0 to 0.32 for float8 (a greedy token of random weights
flips on some seeds only)."""

import re

import torch

from portbench import harness
from portbench.reference.common import Prec, logmel
from portbench.tests import decoder_path, decoder_reference, small

FAMILY = harness.Family(decoder_reference, decoder_path)
MIX = {**small.SERVE_MIX, "tokens": [4, 8]}
LIMITS = {"logp_rel_err": {"limit": 0.01}, "max_logp_gap": {"limit": 0.05},
          "tokens_differ": {"limit": 0}}
SHARED = ("harness.py", "judge.py", "weights.py", "shapes.py", "traffic.py",
          "trace.py", "run.py", "calibrate.py")


def run_family(seconds=0.3, seed=11):
    """A run at a small size on the CPU; the window has to reach the judged
    requests (among the pool's first four rounds)."""
    doc = small.config_doc()
    doc["family"] = "decoder_tests"   # found by no name: passed as FAMILY
    return harness.run("conformer_m.serve.30s", seed, seconds, False,
                       torch.device("cpu"), small.bench(),
                       files=(doc, MIX, LIMITS), family=FAMILY)


def test_a_second_family_in_new_files_is_correct():
    r = run_family()
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["checks"]) == set(LIMITS)


def test_its_served_token_altered_is_not_correct(monkeypatch):
    real = decoder_path.serve_request

    def altered(model, batch):
        out, logp = real(model, batch)
        out = out.clone()
        out[:, 1] = 3 + (out[:, 1] - 2) % (logp.shape[-1] - 3)
        return out, logp

    monkeypatch.setattr(decoder_path, "serve_request", altered)
    r = run_family()
    assert not r["correct"]
    assert r["checks"]["tokens_differ"]["value"] > 0


def test_its_float8_reference_in_the_programs_place_is_not_correct(
        monkeypatch):
    """The reference with its products in float8 decodes greedily, one
    teacher-forced pass a token, in the program's place."""
    doc = small.config_doc()
    cfg, m = doc["config"], doc["config"]["model"]

    def control(model, batch):
        w = {n: p.detach() for n, p in model.named_parameters()}
        prec = Prec("fp8")
        feats, flens = logmel(batch["audio"], batch["audio_lens"],
                              cfg["frontend"], prec)
        enc, elens = decoder_reference.encode(w, feats, flens, m, prec)
        U = batch["tokens"].shape[1]
        toks = torch.zeros((enc.shape[0], 0), dtype=torch.long)
        logps = []
        for _ in range(U):
            lp = decoder_reference.decoder_logp(w, enc, elens, toks, m,
                                                prec)[:, -1]
            logps.append(lp)
            toks = torch.cat([toks, lp.argmax(-1)[:, None]], 1)
        lens = batch["token_lens"].long()
        ids = torch.where(torch.arange(U)[None, :] < lens[:, None], toks, 0)
        return torch.cat([lens[:, None], ids], 1), torch.stack(logps, 1)

    monkeypatch.setattr(decoder_path, "serve_request", control)
    r = run_family(seconds=3.0)
    assert not r["correct"]
    assert r["checks"]["logp_rel_err"]["value"] > LIMITS["logp_rel_err"][
        "limit"]


def test_the_shared_files_name_no_family():
    for name in SHARED:
        text = (harness.ROOT / name).read_text()
        for word in ("ctc_greedy_decode", "reference.model", "rel_table_std",
                     "conformer_ctc", "decoder_reference", "decoder_path"):
            assert word not in text, (name, word)
        assert not re.search(r"\b(80|128)\b", text), name
