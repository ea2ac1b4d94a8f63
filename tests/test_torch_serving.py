"""The port's serving bundles (`serving/export.py`) on the CPU: a greedy
bundle of the 2-layer d64 flagship conformer and of a 1-layer BiLSTM
(whose recurrence the LSTM operator keeps one graph node), each giving the
port's live greedy tokens exactly and agreeing with the JAX model on every
frame whose top-2 margin clears `test_torch_model.py`'s tolerance; a beam
bundle of a tiny hybrid equal to the JAX `BeamSearchDecoder.decode_batch`
token for token; the JAX serving tests' bucket selection, overflow and
vocab-hash refusal; `meta.json`'s keys against a JAX bundle's; `mesh=`
raising; a greedy bundle loaded and run in a fresh process with none of
the port's model, training or decode modules imported; each kernel
wrapper exported as one node of its operator; and the exporter's refusal
of a bfloat16 'torch'-impl BiLSTM. Weights are bridged
from seeded JAX models, float32."""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_serving_case as sc

from pytorch_end2end_speech_recognition_tpu.decode.beam import (
    BeamSearchDecoder as JBeam,
)
from pytorch_end2end_speech_recognition_tpu_torch.data.tokenizer import (
    CharTokenizer,
)
from pytorch_end2end_speech_recognition_tpu_torch.decode.beam import (
    BeamSearchDecoder,
)
from pytorch_end2end_speech_recognition_tpu_torch.serving import (
    export_bundle,
    load_bundle,
)

PKG = "pytorch_end2end_speech_recognition_tpu_torch"
ROOT = Path(__file__).resolve().parents[1]
ENC_TOL = 1e-4   # test_torch_model.py's: float32 sums in another order
BUCKET = (2, 3)  # the JAX serving tests' one bucket: 2 requests of <= 3 s


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The models are tiny: torch's intra-op pool only adds overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def conformer(tmp_path_factory, digits_corpus):
    tmp = tmp_path_factory.mktemp("serve_conformer")
    case = sc.conformer_case(tmp, digits_corpus)
    t0 = time.perf_counter()
    case.bundle = export_bundle(case.tcfg, case.tok, tmp / "bundle",
                                checkpoint_tag="best", batch_sizes=(2,),
                                seconds=(3,), device="cpu")
    case.export_s = time.perf_counter() - t0
    return case


@pytest.fixture(scope="module")
def blstm(tmp_path_factory, digits_corpus):
    tmp = tmp_path_factory.mktemp("serve_blstm")
    case = sc.hybrid_case(tmp, digits_corpus)
    t0 = time.perf_counter()
    case.bundle = export_bundle(case.tcfg, case.tok, tmp / "bundle",
                                checkpoint_tag="best", batch_sizes=(2,),
                                seconds=(3,), device="cpu")
    case.export_s = time.perf_counter() - t0
    case.beam_bundle = export_bundle(case.tcfg, case.tok, tmp / "beam",
                                     checkpoint_tag="best", mode="beam",
                                     batch_sizes=(2,), seconds=(3,),
                                     device="cpu")
    return case


def _jax_model(case):
    return case.jsolver.model if hasattr(case, "jsolver") else case.jm


@pytest.mark.parametrize("kind", ["conformer", "blstm"])
def test_greedy_bundle_matches_live_and_jax(kind, request, digits_corpus):
    """The bundle's tokens equal the port's live encode -> ctc_greedy_decode
    on the same padded batch, exactly; those live logits agree with the
    JAX model's encode/ctc_logits within ENC_TOL on valid frames, and the
    greedy paths agree on every frame whose JAX top-2 margin exceeds it
    (the transcripts too when every frame does). The BiLSTM's program
    holds the LSTM operator and stays under 2,000 graph nodes."""
    case = request.getfixturevalue(kind)
    audios = sc.audios_of(digits_corpus["train"], 2)
    bundle = load_bundle(case.bundle)
    got = bundle.transcribe_ids(audios)
    batch, lens = sc.padded(audios, *BUCKET)
    want, logits, enc_lens = sc.live_greedy(case.solver.model, batch, lens, 2)
    assert got == want
    assert bundle.transcribe(audios) == [case.tok.decode(w) for w in want]

    jm = _jax_model(case)
    jenc, jlens = jm.encode(jnp.asarray(batch), jnp.asarray(lens),
                            train=False)
    jlogits = np.asarray(jm.ctc_logits(jenc))
    np.testing.assert_array_equal(enc_lens, np.asarray(jlens))
    valid = np.arange(logits.shape[1])[None, :] < enc_lens[:, None]
    np.testing.assert_allclose(logits * valid[..., None],
                               jlogits * valid[..., None], rtol=ENC_TOL,
                               atol=ENC_TOL)
    top2 = np.sort(jlogits, axis=-1)[..., -2:]
    sure = (top2[..., 1] - top2[..., 0] > ENC_TOL) & valid
    print(f"{kind}: {int((valid & ~sure).sum())} of {int(valid.sum())} valid "
          f"frames within {ENC_TOL} of a tie; export {case.export_s:.1f} s")
    np.testing.assert_array_equal(logits.argmax(-1)[sure],
                                  jlogits.argmax(-1)[sure])
    if sure.sum() == valid.sum():
        from pytorch_end2end_speech_recognition_tpu.ops.ctc import (
            ctc_greedy_decode as jgreedy,
        )

        jtok, jtl = jgreedy(jnp.asarray(jlogits), jlens)
        assert want == [np.asarray(jtok)[i, :int(jtl[i])].tolist()
                        for i in range(2)]

    ep = torch.export.load(Path(case.bundle) / "greedy_b2_s3.pt2")
    targets = [str(n.target) for n in ep.graph.nodes]
    if kind == "blstm":
        assert targets.count("asr_port.lstm_fwd.default") == 1
        assert len(targets) < 2000, len(targets)


def _wrapper_case(name):
    """A kernel wrapper whose autograd.Function calls its operator, small
    CPU inputs for it, and the operator's graph target."""
    from pytorch_end2end_speech_recognition_tpu_torch.ops import (
        attention_kernel as ak,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops import (
        ffn_kernel as fk,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops import (
        rnn_kernel as rk,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops import (
        subsample_kernel as sk,
    )

    g = torch.Generator().manual_seed(14)

    def r(*s):
        return torch.randn(*s, generator=g) * 0.5

    B, T, H, D = 2, 9, 2, 16
    lens = torch.tensor([T, 5])
    qkv = (r(B, T, D), r(B, T, D), r(B, T, D))
    if name == "toeplitz_expand":
        return (lambda d: ak.toeplitz_dense(d, T, 12, torch.float32),
                (r(H, 2 * T - 1),))
    if name == "attention_fwd":
        return (lambda q, k, v, b, n: ak.fused_attention(q, k, v, b, n, H),
                (*qkv, r(H, 12, 12), lens))
    if name == "flash_fwd":
        return (lambda q, k, v, d, n: ak.flash_attention(q, k, v, d, n, H),
                (*qkv, r(H, 2 * T - 1), lens))
    if name == "ffn_fwd":
        return (lambda x, *p: fk.ffn_block_fused(x, *p, rate=0.0, scale=0.5),
                (r(B, T, D), r(D), r(D), r(4 * D, D), r(4 * D), r(D, 4 * D),
                 r(D)))
    if name == "subsample":
        return (sk.subsample,
                (r(B, T, D), lens, *(t.to(torch.bfloat16) for t in (
                    r(8, 1, 3, 3), r(8), r(8, 8, 3, 3), r(8)))))
    return (lambda x, n, *p: torch.cat(
        rk.bilstm_kernel(x, n, p[:3], p[3:]), dim=-1),
        (r(B, T, D), lens, r(D, 32), r(8, 32), r(32), r(D, 32), r(8, 32),
         r(32)))


@pytest.mark.parametrize("name", ["toeplitz_expand", "attention_fwd",
                                  "flash_fwd", "ffn_fwd", "lstm_fwd",
                                  "subsample"])
def test_wrappers_export_as_their_operator(name):
    """Under no_grad, `torch.export` traces each kernel wrapper's
    autograd.Function into one node of its operator. The saved and loaded
    program gives the eager wrapper's output bit for bit."""
    import io

    fn, args = _wrapper_case(name)

    class Call(torch.nn.Module):
        def forward(self, *a):
            return fn(*a)

    with torch.no_grad():
        ep = torch.export.export(Call(), args)
        buf = io.BytesIO()
        torch.export.save(ep, buf)
        buf.seek(0)
        got = torch.export.load(buf).module()(*args)
        want = fn(*args)
    targets = [str(n.target) for n in ep.graph.nodes]
    assert targets.count(f"asr_port.{name}.default") == 1, targets
    assert torch.equal(got, want)


def test_bf16_torch_lstm_refuses_to_export():
    """The exporter runs a 'torch'-impl (p)BiLSTM's recurrence as the LSTM
    operator, which multiplies in float32. At float32 it swaps the
    encoder's impl and leaves the model's config alone. At another dtype it
    raises, because the program would not compute what the live model
    does."""
    from pytorch_end2end_speech_recognition_tpu_torch.serving.export import (
        _lstm_as_operator,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
        AsrConfig,
    )

    for kind in ("blstm", "pblstm"):
        m = AsrConfig().model
        m.encoder, m.lstm_impl, m.dtype = kind, "torch", "float32"
        enc = SimpleNamespace(cfg=m)
        _lstm_as_operator(enc, m)
        assert (enc.cfg.lstm_impl, m.lstm_impl) == ("cuda", "torch")
        m.dtype = "bfloat16"
        enc = SimpleNamespace(cfg=m)
        with pytest.raises(ValueError, match="float32"):
            _lstm_as_operator(enc, m)
        assert enc.cfg is m
    m = AsrConfig().model
    m.encoder, m.lstm_impl, m.dtype = "conformer", "torch", "bfloat16"
    enc = SimpleNamespace(cfg=m)
    _lstm_as_operator(enc, m)
    assert enc.cfg is m


def test_beam_bundle_matches_jax_decoder(blstm, digits_corpus):
    """A beam bundle (beam 3) gives the JAX BeamSearchDecoder.decode_batch's
    best hypothesis on the same padded batch, token for token, and the
    port's live decode_batch's; its meta bakes max_len and
    min_decode_ratio as the JAX exporter does."""
    audios = sc.audios_of(digits_corpus["train"], 2)
    bundle = load_bundle(blstm.beam_bundle)
    got = bundle.transcribe_ids(audios)
    batch, lens = sc.padded(audios, *BUCKET)
    jdec = JBeam(blstm.jm, blstm.jcfg.decode)
    ref = jdec.decode_batch(SimpleNamespace(audio=batch, audio_lens=lens),
                            blstm.jtok)
    assert got == [ref[i][0]["tokens"] for i in range(2)]
    live = BeamSearchDecoder(blstm.solver.model, blstm.solver.cfg.decode
                             ).decode_batch(
        SimpleNamespace(audio=batch, audio_lens=lens), blstm.tok)
    assert bundle.transcribe(audios) == [live[i][0]["text"] for i in range(2)]
    meta = bundle.meta
    T = int(bundle._beam.encode(torch.from_numpy(batch),
                                torch.from_numpy(lens))[0].shape[1])
    assert meta["artifacts"][0]["max_len"] == max(
        4, int(blstm.tcfg.decode.max_decode_ratio * T))
    assert meta["min_decode_ratio"] == blstm.tcfg.decode.min_decode_ratio
    assert (meta["mode"], meta["format"]) == ("beam", "state")


def test_bucket_selection_and_overflow(conformer):
    """JAX tests/test_serving.py:168 on the port's bundle."""
    bundle = load_bundle(conformer.bundle)
    assert bundle._pick_bucket(1, int(1.5 * 16000)) == (2, 3)
    assert bundle._pick_bucket(2, int(3 * 16000)) == (2, 3)
    with pytest.raises(ValueError, match="no exported bucket"):
        bundle._pick_bucket(3, 16000)  # batch overflow
    with pytest.raises(ValueError, match="no exported bucket"):
        bundle._pick_bucket(1, int(10 * 16000))  # duration overflow


def test_vocab_hash_integrity(conformer, tmp_path):
    """JAX tests/test_serving.py:178: a copy whose tokenizer was swapped is
    refused."""
    out = tmp_path / "corrupt"
    shutil.copytree(conformer.bundle, out)
    CharTokenizer(charset="XYZQW").save(out / "tokenizer.json")
    with pytest.raises(ValueError, match="vocab_hash"):
        load_bundle(out)


def test_meta_keys_match_the_jax_bundle(conformer, blstm, tmp_path):
    """meta.json keeps the JAX bundle's keys, with `device` in place of
    `platforms` and `format` added (beam: `min_decode_ratio` and each
    bucket's `max_len`); the JAX bundle is exported from the same JAX
    checkpoint."""
    from pytorch_end2end_speech_recognition_tpu.serving import (
        export_bundle as jexport_bundle,
    )

    jout = jexport_bundle(conformer.jcfg, conformer.jtok, tmp_path / "jax",
                          checkpoint_tag="best", batch_sizes=(2,),
                          seconds=(3,))
    jmeta = json.loads((jout / "meta.json").read_text())
    meta = json.loads((Path(conformer.bundle) / "meta.json").read_text())
    assert set(meta) == set(jmeta) - {"platforms"} | {"device", "format"}
    assert [set(a) for a in meta["artifacts"]] == [
        set(a) for a in jmeta["artifacts"]]
    for key in ("mode", "sample_rate", "vocab_hash", "config_name"):
        assert meta[key] == jmeta[key], key
    assert (meta["device"], meta["format"]) == ("cpu", "torch.export")
    assert [a["file"] for a in meta["artifacts"]] == ["greedy_b2_s3.pt2"]
    beam = json.loads((Path(blstm.beam_bundle) / "meta.json").read_text())
    assert set(beam) == set(meta) | {"min_decode_ratio"}
    assert [set(a) for a in beam["artifacts"]] == [
        set(a) | {"max_len"} for a in jmeta["artifacts"]]


def test_export_from_a_mesh_raises(conformer, tmp_path):
    """Export through a mesh runs since the parallelism slice (its
    two-process check is tests/test_torch_multiproc.py); a mesh that is
    not the port's is refused."""
    with pytest.raises(TypeError, match="make_mesh"):
        export_bundle(conformer.tcfg, conformer.tok, tmp_path / "m",
                      batch_sizes=(2,), seconds=(3,), device="cpu",
                      mesh=object())


def test_greedy_bundle_needs_no_model_code(conformer, digits_corpus,
                                           tmp_path):
    """A fresh process loads the bundle and transcribes with no module of
    the port's models/, training/ or decode/ imported, and gets the live
    tokens."""
    audios = sc.audios_of(digits_corpus["train"], 2)
    np.savez(tmp_path / "req.npz", *audios)
    code = f"""
import json, sys
import numpy as np
from {PKG}.serving import load_bundle
req = np.load(sys.argv[2])
ids = load_bundle(sys.argv[1]).transcribe_ids([req[k] for k in req.files])
mods = sorted(m for m in sys.modules
              if m.split(".")[:2] in ([{PKG!r}, "models"],
                                      [{PKG!r}, "training"],
                                      [{PKG!r}, "decode"]))
print(json.dumps({{"ids": ids, "mods": mods}}))
"""
    res = subprocess.run(
        [sys.executable, "-c", code, str(conformer.bundle),
         str(tmp_path / "req.npz")], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.splitlines()[-1])
    assert out["mods"] == []
    batch, lens = sc.padded(audios, *BUCKET)
    want, _, _ = sc.live_greedy(conformer.solver.model, batch, lens, 2)
    assert out["ids"] == want
