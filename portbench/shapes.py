"""Length arithmetic that the work counts share: frames of the log-mel,
encoder frames after the x4 subsampling, lattice states of CTC."""

from __future__ import annotations


def frames(samples: int, fe: dict) -> int:
    win = round(fe["sample_rate"] * fe["win_ms"] / 1000)
    hop = round(fe["sample_rate"] * fe["hop_ms"] / 1000)
    return max(0, (int(samples) - win) // hop + 1)


def enc_len(n_frames: int) -> int:
    return ((n_frames + 1) // 2 + 1) // 2


def enc_lens(cfg: dict, batch: dict) -> list[int]:
    """Each row's encoder frames, from its real samples."""
    return [enc_len(frames(n, cfg["frontend"])) for n in batch["audio_lens"]]


def grid_enc_len(cfg: dict, batch: dict) -> int:
    """Encoder frames of the padded grid."""
    return enc_len(frames(batch["grid"], cfg["frontend"]))
