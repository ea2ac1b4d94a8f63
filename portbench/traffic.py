"""The one traffic generator: reads a mix from `traffic/<name>.json` and
makes a cell's inputs from the seed, on the device.

A mix fixes the batch, the range of utterance lengths, the grid every
batch is padded to, the range of token counts (training), the number of
distinct batches in the pool and whether SpecAugment masks are drawn.
Every seed gets the same set of lengths, evenly spaced over the range (the
same work), dealt to rows and batches in its own order; the audio, tokens
and masks are drawn from the seed. Audio is speech-like: 0.1 s segments,
each a tone of its own pitch and level plus noise of its own level, so that
log-mel frames differ from one another as speech frames do.
"""

from __future__ import annotations

import hashlib
import json
import math
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
FIRST_TOKEN = 3  # ids 0, 1, 2: blank, sos/eos, unk


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of the run's seed."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def load_mix(name: str) -> dict:
    return json.loads((ROOT / "traffic" / f"{name}.json").read_text())


def speechlike(n_rows: int, n_samples: int, sr: int,
               gen: torch.Generator, dev) -> torch.Tensor:
    seg = sr // 10
    n_seg = -(-n_samples // seg)

    def u():
        return torch.rand(n_rows, n_seg, 1, device=dev, generator=gen)

    pitch, tone, noise = 100 + 3900 * u(), 10 ** (2 * u() - 2), 10 ** (
        2 * u() - 3)
    t = torch.arange(seg, device=dev) / sr
    x = tone * torch.sin(2 * math.pi * pitch * t) + noise * torch.randn(
        n_rows, n_seg, seg, device=dev, generator=gen)
    return 0.3 * x.reshape(n_rows, -1)[:, :n_samples].contiguous()


def spec_mask(frame_lens: torch.Tensor, T: int, F: int, fe: dict,
              gen: torch.Generator) -> torch.Tensor:
    """A (B, T, F) SpecAugment mask of 0s and 1s: `n_freq_masks` bands of
    width U[0, F_param] starting in [0, max(F - w, 1)), `n_time_masks`
    spans of width min(U[0, T_param], max(int(len * ratio), 1), T_param)
    starting in [0, max(len - w, 1))."""
    B, dev = frame_lens.shape[0], frame_lens.device
    lens = frame_lens.long()[:, None]

    def uniform_int(high):
        u = torch.rand((B, 1), generator=gen, device=dev)
        return torch.minimum((u * high).long(), high - 1)

    f_idx = torch.arange(F, device=dev)[None, :]
    t_idx = torch.arange(T, device=dev)[None, :]
    keep_f = torch.ones((B, F), dtype=torch.bool, device=dev)
    for _ in range(fe["n_freq_masks"]):
        w = uniform_int(torch.full((B, 1), fe["freq_mask_param"] + 1,
                                   device=dev))
        start = uniform_int(torch.clamp(F - w, min=1))
        keep_f &= ~((f_idx >= start) & (f_idx < start + w))
    max_t = torch.clamp((frame_lens * fe["time_mask_ratio"]).long(), min=1)
    max_t = torch.clamp(max_t, max=fe["time_mask_param"])[:, None]
    keep_t = torch.ones((B, T), dtype=torch.bool, device=dev)
    for _ in range(fe["n_time_masks"]):
        w = torch.minimum(uniform_int(torch.full(
            (B, 1), fe["time_mask_param"] + 1, device=dev)), max_t)
        start = uniform_int(torch.clamp(lens - w, min=1))
        keep_t &= ~((t_idx >= start) & (t_idx < start + w))
    return (keep_t[:, :, None] & keep_f[:, None, :]).float()


def spread(lo: float, hi: float, n: int, order: torch.Tensor) -> list[float]:
    """n values evenly spaced over [lo, hi], in the order `order`."""
    vals = [lo + (hi - lo) * (i + 0.5) / n for i in range(n)]
    return [vals[i] for i in order.tolist()]


def make_pool(mix: dict, cfg: dict, seed: int, dev) -> list[dict]:
    """The pool of `mix['pool']` distinct batches, each a dict of device
    tensors: audio (B, grid) float32 with zeros past each row, audio_lens
    (B,) int32 samples; with 'tokens' in the mix also tokens (B, U_max)
    int32 (0 past each row) and token_lens; with 'spec_augment' a
    SpecAugment mask (B, frames, n_mels)."""
    fe = cfg["frontend"]
    sr = fe["sample_rate"]
    B, n_batches = mix["batch"], mix["pool"]
    grid = round(mix["grid_seconds"] * sr)
    n = B * n_batches
    cpu = torch.Generator().manual_seed(sub_seed(seed, "order"))
    secs = spread(*mix["seconds"], n, torch.randperm(n, generator=cpu))
    lens = torch.tensor([min(round(s * sr), grid) for s in secs],
                        dtype=torch.int32).reshape(n_batches, B)
    if "tokens" in mix:
        lo, hi = mix["tokens"]
        toks = torch.tensor(
            [round(u) for u in spread(lo, hi, n, torch.randperm(
                n, generator=cpu))], dtype=torch.int32).reshape(n_batches, B)
    gen = torch.Generator(device=dev).manual_seed(sub_seed(seed, "inputs"))
    win = round(sr * fe["win_ms"] / 1000)
    hop = round(sr * fe["hop_ms"] / 1000)
    n_frames = (grid - win) // hop + 1
    pool = []
    for i in range(n_batches):
        al = lens[i].to(dev)
        audio = speechlike(B, grid, sr, gen, dev)
        audio = torch.where(torch.arange(grid, device=dev)[None, :]
                            < al[:, None], audio, 0.0)
        batch = {"audio": audio, "audio_lens": al}
        if "tokens" in mix:
            tl = toks[i].to(dev)
            U = mix["tokens"][1]
            ids = torch.randint(FIRST_TOKEN, cfg["model"]["vocab_size"],
                                (B, U), generator=gen, device=dev)
            batch["tokens"] = torch.where(
                torch.arange(U, device=dev)[None, :] < tl[:, None], ids,
                0).to(torch.int32)
            batch["token_lens"] = tl
        if mix.get("spec_augment"):
            flens = torch.clamp((al - win) // hop + 1, min=0)
            batch["spec_mask"] = spec_mask(flens, n_frames, fe["n_mels"], fe,
                                           gen)
        pool.append(batch)
    return pool

