"""The shared case of the hybrid-training-step parity tests
(`test_torch_train*.py`, `test_torch_transformer.py`): flagship-small (4 L,
d128, 2-layer decoder d128, vocab 64) or rung-3-small (Transformer encoder
d64 H4 FFN 256, 2-layer decoder d64 FFN 256) in both packages, float32 on
the CPU, dropout 0, a short noam warmup, a ragged batch of 3 rows with one
pad row, and the JAX SpecAugment mask that the JAX train step draws from
its key, for the port to inject."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import nnx

from pytorch_end2end_speech_recognition_tpu_torch import bridge
from pytorch_end2end_speech_recognition_tpu_torch.data.dataset import Batch

VOCAB = 64


def flat(state) -> dict:
    """nnx params (a module's or a State) as dotted path -> numpy."""
    if isinstance(state, nnx.Module):
        state = nnx.state(state, nnx.Param)
    return {".".join(map(str, path)): np.array(
        v[...] if isinstance(v, nnx.Variable) else v)
        for path, v in nnx.to_flat_state(state)}


def configs(layers: int = 4, jax_attn_impl: str | None = None,
            preset: str = "flagship_conformer"):
    """flagship-small (or, with preset 'libri100_transformer', rung-3-small)
    in both packages; `jax_attn_impl` overrides the JAX model's resolved
    attention ('pallas' takes its flash path past 768 frames, which on the
    CPU is the chunked XLA version)."""
    from __graft_entry__ import _flagship_cfg
    from pytorch_end2end_speech_recognition_tpu.configs import (
        presets as jpresets,
    )
    from pytorch_end2end_speech_recognition_tpu.utils.config import (
        resolve_platform,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.configs import presets

    tcfg = getattr(presets, preset)()
    if preset == "flagship_conformer":
        jcfg = _flagship_cfg(small=True)
        m = tcfg.model
        m.encoder_dim, m.encoder_ffn_dim, m.decoder_dim = 128, 256, 128
    else:
        jcfg = resolve_platform(getattr(jpresets, preset)())
        for m in (jcfg.model, tcfg.model):
            m.encoder_dim, m.encoder_ffn_dim, m.encoder_heads = 64, 256, 4
            m.decoder_dim, m.decoder_ffn_dim, m.decoder_layers = 64, 256, 2
            m.vocab_size = VOCAB
    if jax_attn_impl is not None:
        jcfg.model.attn_impl = jax_attn_impl
    for c in (jcfg, tcfg):
        c.model.encoder_layers = layers
        c.model.dtype = "float32"
        c.model.encoder_dropout = c.model.decoder_dropout = 0.0
        # a short warmup, so that the first update (noam at count 0) moves
        # the parameters by ~1e-4 rather than ~3e-7
        c.train.warmup_steps = 10
        c.train.prng_impl = "threefry2x32"  # JAX's default: no global change
    return jcfg, tcfg


def build(tmp_dir, layers: int = 4, Ts: int = 20480, ragged: int = 12000,
          jax_attn_impl: str | None = None,
          preset: str = "flagship_conformer"):
    """The JAX model and Solver, the batch (numpy and jnp: rows of Ts and
    `ragged` samples and a pad row), the train step's key and its
    SpecAugment mask, the initial JAX params. The default Ts (126 frames)
    gives 32 encoder frames."""
    from pytorch_end2end_speech_recognition_tpu.models.asr import (
        AsrModel as JAsrModel,
    )
    from pytorch_end2end_speech_recognition_tpu.ops.specaugment import (
        spec_augment,
    )
    from pytorch_end2end_speech_recognition_tpu.training.solver import (
        Solver as JSolver,
    )

    jcfg, tcfg = configs(layers, jax_attn_impl, preset)
    jcfg.train.metrics_path = str(tmp_dir / "metrics.jsonl")
    jmodel = JAsrModel(jcfg, nnx.Rngs(0))

    class _Tok:
        vocab_size = VOCAB

    jsolver = JSolver(jcfg, _Tok(), model=jmodel)
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal((3, Ts)) * 0.1).astype(np.float32)
    audio_lens = np.asarray([Ts, ragged, 0], np.int32)     # row 2: pad row
    audio[1, ragged:] = 0.0
    audio[2] = 0.0
    tokens = rng.integers(2, VOCAB, (3, 5)).astype(np.int32)
    token_lens = np.asarray([5, 3, 0], np.int32)
    tokens *= np.arange(5)[None, :] < token_lens[:, None]
    arrays = [jnp.asarray(a) for a in (audio, audio_lens, tokens, token_lens)]
    key = jax.random.PRNGKey(7)
    # the key path of Solver.train_step -> AsrModel.encode -> features
    k_spec = jax.random.split(jax.random.split(key)[0])[0]
    feats, flens = jmodel.frontend(arrays[0], arrays[1])
    mask = np.array(spec_augment(k_spec, jnp.ones_like(feats), flens,
                                 jcfg.frontend))
    return dict(jcfg=jcfg, tcfg=tcfg, jmodel=jmodel, jsolver=jsolver,
                arrays=arrays, key=key, flat0=flat(jmodel),
                batch=Batch(audio, audio_lens, tokens, token_lens),
                mask=torch.from_numpy(mask))


def tokenizer_of(vocab_size: int):
    """A character tokenizer of `vocab_size` ids (the Solver's vocabulary
    comes from its tokenizer)."""
    from pytorch_end2end_speech_recognition_tpu_torch.data.tokenizer import (
        N_SPECIAL,
        CharTokenizer,
    )

    return CharTokenizer(charset="".join(
        chr(0x100 + i) for i in range(vocab_size - N_SPECIAL - 1)))


def port_solver(case):
    """The port's Solver on the CPU with the JAX weights bridged in (no
    metrics file)."""
    from pytorch_end2end_speech_recognition_tpu_torch.training.solver import (
        Solver,
    )

    case["tcfg"].train.metrics_path = ""
    solver = Solver(case["tcfg"], tokenizer_of(VOCAB), device="cpu")
    missing, unexpected = solver.model.load_state_dict(
        bridge.state_dict_from_jax(case["flat0"]), strict=False)
    assert not unexpected and all(k.startswith("frontend.") for k in missing)
    return solver


def scalars(metrics: dict) -> dict:
    return {k: float(v) for k, v in metrics.items()}
