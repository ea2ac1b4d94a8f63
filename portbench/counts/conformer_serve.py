"""Model FLOPs of serving a Conformer CTC model, from each row's real
length: the matrix products and convolutions of the plain reference's
forward (log-mel as a DFT product and a filterbank product, the two
subsampling convolutions and the projection, every block's two FFNs, q, k,
v, o, QK^T and PV, the convolution module's pointwise and depthwise
convolutions, the CTC head). Elementwise work is not counted. bf16."""

from portbench import shapes


def frontend(cfg: dict, n: int) -> int:
    fe = cfg["frontend"]
    win = round(fe["sample_rate"] * fe["win_ms"] / 1000)
    bins = fe["n_fft"] // 2 + 1
    return 2 * n * win * 2 * bins + 2 * n * bins * fe["n_mels"]


def subsample(cfg: dict, n: int) -> tuple[int, int]:
    """(conv1 FLOPs, conv2 and projection FLOPs) for n frames."""
    m = cfg["model"]
    D = m["encoder_dim"]
    C = m["subsample_channels"] or D
    f1 = (cfg["frontend"]["n_mels"] + 1) // 2
    f2 = (f1 + 1) // 2
    t1 = (n + 1) // 2
    t2 = (t1 + 1) // 2
    return 2 * C * t1 * f1 * 9, 2 * C * t2 * f2 * 9 * C + 2 * t2 * f2 * C * D


def encoder(cfg: dict, t: int) -> int:
    m = cfg["model"]
    D, Fd, K = m["encoder_dim"], m["encoder_ffn_dim"], m["conformer_kernel"]
    layer = (8 * t * D * Fd + 8 * t * D * D + 4 * t * t * D
             + 6 * t * D * D + 2 * t * D * K)
    return m["encoder_layers"] * layer + 2 * t * D * m["vocab_size"]


def work(cfg: dict, batch: dict) -> dict:
    total = 0
    for s, t in zip(batch["audio_lens"], batch["enc_lens"]):
        n = shapes.frames(s, cfg["frontend"])
        c1, c2 = subsample(cfg, n)
        total += frontend(cfg, n) + c1 + c2 + encoder(cfg, t)
    return {"flops": total, "bytes": 0, "precision": "bf16"}
