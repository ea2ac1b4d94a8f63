"""The CTC backward recursion and gradient (`csrc/ctc.cu` beta) over each
row's real lattice, T frames by S = 2U + 1 states: the float32 lattice
log-probs and alphas read once, the gradient of the log-probs written
once; the recursion's log-sum-exp and the gradient's, counted as 12
float32 operations a cell."""


def work(cfg: dict, batch: dict) -> dict:
    cells = sum(t * (2 * u + 1) for t, u in zip(batch["enc_lens"],
                                                 batch["token_lens"]))
    return {"flops": 12 * cells, "bytes": 3 * 4 * cells, "precision": "fp32"}
