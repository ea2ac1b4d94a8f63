"""The log-mel function (`csrc/logmel.cu`): for each real frame, the real
DFT at the bins the mel filterbank reads (bf16 operands), the power, the
filterbank's nonzero weights; the real audio read once, the bf16 basis of
those bins read once, the float32 features written once."""

from portbench import shapes
from portbench.reference.common import mel_filterbank


def work(cfg: dict, batch: dict) -> dict:
    fe = cfg["frontend"]
    win = round(fe["sample_rate"] * fe["win_ms"] / 1000)
    fb = mel_filterbank(fe["n_mels"], fe["n_fft"], fe["sample_rate"],
                        fe["fmin"], fe["fmax"])
    bins = int((fb != 0).any(axis=1).sum())
    nnz = int((fb != 0).sum())
    n = sum(shapes.frames(s, fe) for s in batch["audio_lens"])
    flops = n * (2 * win * 2 * bins + 3 * bins + 2 * nnz)
    nbytes = (4 * sum(batch["audio_lens"]) + 2 * win * 2 * bins
              + 4 * n * fe["n_mels"])
    return {"flops": flops, "bytes": nbytes, "precision": "bf16"}
