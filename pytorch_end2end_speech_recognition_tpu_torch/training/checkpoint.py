"""Checkpoint save and restore with `torch.save` (the port of the JAX
package's `training/checkpoint.py`, which writes Orbax directories).

Each tag (`last`, `best`, `step_XXXXXXXX`) is a directory holding
`state.pt`, with its `{tag}.config.json` beside it. The file holds the
parameters by name, the optimizer's state and the meta fields of the JAX
package's checkpoints: step, best dev WER, the random state (here the
`torch.Generator`'s byte state, in place of the PRNG key), the loader
cursor, the plateau scale, the evaluations since the best and the
tokenizer's vocab hash (and on a mesh, every data rank's generator
state). Parameters and optimizer moments are whole tensors: a sharded
Solver gathers them first, and slices them again on restore, for any
mesh. Everything in it is a tensor or a plain Python
value, so it loads with `torch.load(..., weights_only=True)`. Checkpoints
written by the JAX package (Orbax) are not read.
"""

from __future__ import annotations

import shutil
from pathlib import Path

import torch

from pytorch_end2end_speech_recognition_tpu_torch.utils.config import AsrConfig

STATE_FILE = "state.pt"


def _default_meta() -> dict:
    """Training state beyond (params, opt): step, best metric, generator
    state, loader cursor, plateau-LR state, vocab hash (0 = unknown)."""
    return {
        "step": 0,
        "best_wer": 0.0,
        "rng": torch.zeros(0, dtype=torch.uint8),
        # every data rank's generator state on a mesh with dp > 1
        "rng_data_ranks": torch.zeros(0, dtype=torch.uint8),
        "cursor_epoch": 0,
        "cursor_batch": 0,
        "lr_scale": 1.0,
        "evals_since_best": 0,
        "vocab_hash": 0,
    }


def save_checkpoint(
    ckpt_dir: str, tag: str, params: dict, opt_state: dict, step: int,
    best_wer: float, cfg: AsrConfig | None = None,
    extra_meta: dict | None = None,
) -> None:
    """Write `{ckpt_dir}/{tag}/state.pt` (replacing it whole: written to a
    temporary file, then renamed) and `{tag}.config.json` beside it."""
    path = Path(ckpt_dir) / tag
    path.mkdir(parents=True, exist_ok=True)
    meta = _default_meta()
    meta["step"] = int(step)
    meta["best_wer"] = float(best_wer)
    for k, v in (extra_meta or {}).items():
        if k not in meta:
            raise KeyError(f"unknown checkpoint meta field {k!r}")
        meta[k] = v
    tree = {"params": {k: v.detach() for k, v in params.items()},
            "opt_state": opt_state, "meta": meta}
    tmp = path / (STATE_FILE + ".tmp")
    torch.save(tree, tmp)
    tmp.replace(path / STATE_FILE)
    if cfg is not None:
        (path.parent / f"{tag}.config.json").write_text(cfg.to_json())


def load_checkpoint(ckpt_dir: str, tag: str) -> dict:
    """{'params': {name: CPU tensor}, 'opt_state': ..., and the meta
    fields}."""
    tree = torch.load(Path(ckpt_dir) / tag / STATE_FILE, map_location="cpu",
                      weights_only=True)
    out = {"params": tree["params"], "opt_state": tree["opt_state"]}
    out.update(tree["meta"])
    return out


def save_step_checkpoint(
    ckpt_dir: str, step: int, params: dict, opt_state: dict,
    best_wer: float, cfg: AsrConfig | None = None, max_to_keep: int = 3,
    extra_meta: dict | None = None,
) -> None:
    """Step-tagged checkpoint with retention of the newest `max_to_keep`
    (best and last are kept apart)."""
    save_checkpoint(ckpt_dir, f"step_{step:08d}", params, opt_state, step,
                    best_wer, cfg, extra_meta=extra_meta)
    steps = sorted(p for p in Path(ckpt_dir).glob("step_*") if p.is_dir())
    for old in steps[:-max_to_keep]:
        shutil.rmtree(old, ignore_errors=True)
        extra = old.parent / f"{old.name}.config.json"
        if extra.exists():
            extra.unlink()


def latest_step_checkpoint(ckpt_dir: str) -> str | None:
    steps = sorted(p for p in Path(ckpt_dir).glob("step_*") if p.is_dir())
    return steps[-1].name if steps else None


def load_config(ckpt_dir: str, tag: str) -> AsrConfig | None:
    p = Path(ckpt_dir) / f"{tag}.config.json"
    if p.exists():
        return AsrConfig.from_json(p.read_text())
    return None
