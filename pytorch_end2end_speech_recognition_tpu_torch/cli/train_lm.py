"""Language-model training entry point (the port of the JAX package's
`cli/train_lm.py`): trains the LM of `model.lm_type` (`models/lm.py`) on
manifest transcripts, reports dev perplexity and saves a checkpoint that
beam-search shallow fusion loads (`load_lm`).

    python -m pytorch_end2end_speech_recognition_tpu_torch.cli.train_lm \
        --config cfg.json --out lm_ckpt [--steps 10000] [--device cpu]

The optimizer is the JAX package's: global-norm clip at 5.0, then adamw
(optax's defaults: weight decay 1e-4) at a constant learning rate, with
optax's semantics (`training/schedules.py`). The checkpoint is the tag `lm`
under `--out` (`training/checkpoint.py`, `torch.save`). Runs on CUDA unless
`--device cpu` is given.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

ADAMW_WEIGHT_DECAY = 1e-4   # optax.adamw's default
CLIP_NORM = 5.0


def batches(token_lists, batch_size, max_len, rng):
    order = rng.permutation(len(token_lists))
    for s in range(0, len(order) - batch_size + 1, batch_size):
        idx = order[s : s + batch_size]
        U = max(1, min(max_len, max(len(token_lists[i]) for i in idx)))
        toks = np.zeros((batch_size, U), np.int32)
        lens = np.zeros((batch_size,), np.int32)
        for r, i in enumerate(idx):
            t = token_lists[i][:U]
            toks[r, : len(t)] = t
            lens[r] = len(t)
        yield toks, lens


def _optimizer(params, lr: float):
    from pytorch_end2end_speech_recognition_tpu_torch.training.schedules import (  # noqa: E501
        Optimizer,
    )

    return Optimizer(params, lambda count: lr, "adam", ADAMW_WEIGHT_DECAY,
                     CLIP_NORM)


def train_lm(cfg, tok, texts, dev_texts, out_dir: str, steps: int,
             batch_size: int = 32, lr: float = 1e-3, seed: int = 0,
             log_every: int = 200, device=None, lm=None):
    """Train for `steps` steps over shuffled batches of the tokenized
    `texts`, then measure dev perplexity and save the checkpoint. `lm`, when
    given, is the model to start from (else `build_lm` from `seed`).
    Returns (lm, dev perplexity)."""
    from pytorch_end2end_speech_recognition_tpu_torch.models.lm import (
        build_lm,
        lm_loss,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.training.checkpoint import (  # noqa: E501
        save_checkpoint,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.utils import device as dv

    dev = dv.resolve(device)
    cfg.model.vocab_size = tok.vocab_size
    if lm is None:
        lm = build_lm(cfg.model, device=dev, seed=seed)
    lm.train()
    names, params = zip(*lm.named_parameters())
    opt = _optimizer(list(params), lr)

    token_lists = [tok.encode(t) for t in texts if t.strip()]
    dev_lists = [tok.encode(t) for t in dev_texts if t.strip()]
    if len(token_lists) < batch_size:
        # the reference's loop would never yield a batch, and never end
        raise ValueError(f"{len(token_lists)} training texts: fewer than "
                         f"one batch of {batch_size}")
    rng = np.random.default_rng(seed)
    step, t0 = 0, time.time()
    put = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    while step < steps:
        for toks, lens in batches(token_lists, batch_size, 256, rng):
            loss, _ = lm_loss(lm, put(toks), put(lens))
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            opt.step(list(grads))
            step += 1
            if step % log_every == 0:
                print(f"[lm] step={step} loss={float(loss):.4f} "
                      f"wall={time.time()-t0:.1f}s", file=sys.stderr)
            if step >= steps:
                break
    # dev perplexity
    lm.eval()
    tot, cnt = 0.0, 0
    eval_bs = max(1, min(batch_size, len(dev_lists)))
    with torch.no_grad():
        for toks, lens in batches(dev_lists, eval_bs, 256,
                                  np.random.default_rng(0)):
            loss, count = lm_loss(lm, put(toks), put(lens))
            tot += float(loss * count)
            cnt += int(count)
    ppl = float(np.exp(tot / max(cnt, 1)))
    print(f"[lm] dev perplexity {ppl:.2f}", file=sys.stderr)
    save_checkpoint(out_dir, "lm", params=dict(zip(names, params)),
                    opt_state=opt.state_dict(), step=steps, best_wer=ppl,
                    cfg=cfg)
    return lm, ppl


def load_lm(ckpt_dir: str, cfg, tok, device=None):
    """Restore a language model (RNN or transformer) for shallow fusion, in
    eval mode on `device` (None -> 'cuda')."""
    from pytorch_end2end_speech_recognition_tpu_torch.models.lm import build_lm
    from pytorch_end2end_speech_recognition_tpu_torch.training.checkpoint import (  # noqa: E501
        load_checkpoint,
    )

    cfg.model.vocab_size = tok.vocab_size
    lm = build_lm(cfg.model, device=device)
    params = load_checkpoint(ckpt_dir, "lm")["params"]
    own = dict(lm.named_parameters())
    if set(params) != set(own):
        raise ValueError(f"LM checkpoint under {ckpt_dir} holds other "
                         "parameters than model.lm_type/lm_* describe")
    with torch.no_grad():
        for name, p in own.items():
            p.copy_(params[name])
    return lm.eval()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--steps", type=int, default=10000)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--extra-text", default=None,
                    help="optional text file with one sentence per line")
    ap.add_argument("--set", action="append", default=[], metavar="K=V")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    from pytorch_end2end_speech_recognition_tpu_torch.cli.train import (
        load_config,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.data.manifest import (
        read_manifest,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.data.tokenizer import (
        load_for_config,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
        parse_overrides,
    )

    cfg = parse_overrides(load_config(args.config), args.set)
    tok = load_for_config(cfg)
    texts = [u.text for u in read_manifest(cfg.data.train_manifest)]
    if args.extra_text:
        texts += Path(args.extra_text).read_text().splitlines()
    dev_texts = (
        [u.text for u in read_manifest(cfg.data.dev_manifest)]
        if cfg.data.dev_manifest else texts[:200]
    )
    return train_lm(cfg, tok, texts, dev_texts, args.out, args.steps,
                    args.batch_size, args.lr, device=args.device)


if __name__ == "__main__":
    main()
