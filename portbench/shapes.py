"""What the work counts read of a batch: its lengths on the host, with
each row's encoder frames and the grid's by the family's own length
arithmetic (`ref.enc_len`), and the frames of the log-mel."""

from __future__ import annotations


def frames(samples: int, fe: dict) -> int:
    win = round(fe["sample_rate"] * fe["win_ms"] / 1000)
    hop = round(fe["sample_rate"] * fe["hop_ms"] / 1000)
    return max(0, (int(samples) - win) // hop + 1)


def describe(batch: dict, cfg: dict, ref) -> dict:
    """B, grid and audio_lens (samples), token_lens where the batch has
    tokens, and enc_lens and enc_grid: encoder frames of each row's real
    samples and of the padded grid."""
    out = {"B": int(batch["audio"].shape[0]),
           "grid": int(batch["audio"].shape[1]),
           "audio_lens": batch["audio_lens"].tolist()}
    if "token_lens" in batch:
        out["token_lens"] = batch["token_lens"].tolist()
    fe = cfg["frontend"]
    out["enc_lens"] = [ref.enc_len(n, fe) for n in out["audio_lens"]]
    out["enc_grid"] = ref.enc_len(out["grid"], fe)
    return out
