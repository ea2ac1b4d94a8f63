"""The CTC forward recursion (`csrc/ctc.cu` alpha) over each row's real
lattice: T real encoder frames by S = 2U + 1 states; the float32 lattice
log-probs read once and the alphas written once; a log-sum-exp of up to
three terms a cell, counted as 8 float32 operations. A dependent chain of
T steps: latency, not these counts, bounds it."""


def work(cfg: dict, batch: dict) -> dict:
    cells = sum(t * (2 * u + 1) for t, u in zip(batch["enc_lens"],
                                                 batch["token_lens"]))
    return {"flops": 8 * cells, "bytes": 2 * 4 * cells, "precision": "fp32"}
