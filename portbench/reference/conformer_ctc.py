"""Plain PyTorch reference of the Conformer CTC family, in float32.

The Conformer CTC/attention model as the benchmarked configurations
describe it: log-mel with per-utterance CMVN (`common.logmel`), the
two-layer stride-2 conv subsampling, Conformer blocks (macaron FFNs,
relative-bias self-attention, the convolution module), the CTC head,
greedy decoding, the Transformer decoder, the hybrid CTC/label-smoothed-CE
loss, the global-norm clip and AdamW on the Noam schedule. Written from
the configuration alone: it imports no module of the measured program,
derives its own relative-position buckets, and reads the weights from a
state dict keyed by the program's parameter names.

What the harness takes of a family's reference: `param_spec`, `enc_len`,
`serve_reference` (what a served request is judged against) and
`train_steps`.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.common import Prec, frame_count, logmel

LN_EPS = 1e-6
NEG = -1e30
SOS_EOS = 1


# ------------------------------------------------------------ parameters
def param_spec(cfg: dict, init: dict) -> list[tuple[str, tuple, str,
                                                    float]]:
    """(name, shape, init, scale) of every parameter of the configuration
    `cfg`, in the program's order and names. init: 'normal' (N(0,
    scale^2)), 'zeros', 'ones'. Weights are LeCun-normal, embeddings N(0,
    1/dim), the relative-bias table N(0, init['rel_table_std']^2); biases
    0, LayerNorm scales 1."""
    m = cfg["model"]
    D, Fd, H, L = (m["encoder_dim"], m["encoder_ffn_dim"], m["encoder_heads"],
                   m["encoder_layers"])
    C = m["subsample_channels"] or D
    K = m["conformer_kernel"]
    V = m["vocab_size"]
    spec = []

    def lin(name, d_out, d_in, bias=True):
        spec.append((f"{name}.weight", (d_out, d_in), "normal",
                     1 / math.sqrt(d_in)))
        if bias:
            spec.append((f"{name}.bias", (d_out,), "zeros", 0.0))

    def ln(name, d):
        spec.append((f"{name}.weight", (d,), "ones", 0.0))
        spec.append((f"{name}.bias", (d,), "zeros", 0.0))

    spec.append(("encoder.sub.conv1.weight", (C, 1, 3, 3), "normal", 1 / 3))
    spec.append(("encoder.sub.conv1.bias", (C,), "zeros", 0.0))
    spec.append(("encoder.sub.conv2.weight", (C, C, 3, 3), "normal",
                 1 / math.sqrt(9 * C)))
    spec.append(("encoder.sub.conv2.bias", (C,), "zeros", 0.0))
    f_out = ((cfg["frontend"]["n_mels"] + 1) // 2 + 1) // 2
    lin("encoder.sub.proj", D, f_out * C)
    spec.append(("encoder.rel.table", (L, H, 64), "normal",
                 init["rel_table_std"]))
    for i in range(L):
        b = f"encoder.blocks.{i}"
        ln(f"{b}.ff1.ln", D)
        lin(f"{b}.ff1.fc1", Fd, D)
        lin(f"{b}.ff1.fc2", D, Fd)
        ln(f"{b}.mhsa.ln", D)
        for p in "qkvo":
            lin(f"{b}.mhsa.{p}", D, D)
        ln(f"{b}.conv.ln", D)
        lin(f"{b}.conv.pw1", 2 * D, D)
        spec.append((f"{b}.conv.dw.weight", (D, 1, K), "normal",
                     1 / math.sqrt(K)))
        spec.append((f"{b}.conv.dw.bias", (D,), "zeros", 0.0))
        ln(f"{b}.conv.norm", D)
        lin(f"{b}.conv.pw2", D, D)
        ln(f"{b}.ff2.ln", D)
        lin(f"{b}.ff2.fc1", Fd, D)
        lin(f"{b}.ff2.fc2", D, Fd)
        ln(f"{b}.ln", D)
    lin("ctc_head.proj", V, D)
    if m["ctc_weight"] < 1.0:
        Dd = m["decoder_dim"]
        Fdd = m["decoder_ffn_dim"] or 4 * Dd
        spec.append(("decoder.embed.weight", (V, Dd), "normal",
                     1 / math.sqrt(Dd)))
        for i in range(m["decoder_layers"]):
            b = f"decoder.blocks.{i}"
            ln(f"{b}.ln1", Dd)
            for p in ("wq1", "wk1", "wv1", "wo1"):
                lin(f"{b}.{p}", Dd, Dd)
            ln(f"{b}.ln2", Dd)
            lin(f"{b}.wq2", Dd, Dd)
            lin(f"{b}.wk2", Dd, D)
            lin(f"{b}.wv2", Dd, D)
            lin(f"{b}.wo2", Dd, Dd)
            ln(f"{b}.ln3", Dd)
            lin(f"{b}.fc1", Fdd, Dd)
            lin(f"{b}.fc2", Dd, Fdd)
        ln("decoder.ln_out", Dd)
        lin("decoder.proj", V, Dd)
    return spec


# ------------------------------------------------------------ lengths
def enc_len(samples, fe: dict):
    """Encoder frames of `samples` (int or tensor): the log-mel's frames
    after the two stride-2 convolutions."""
    n_frames = frame_count(samples, fe)
    return ((n_frames + 1) // 2 + 1) // 2


# ------------------------------------------------------------ encoder
def _ln(x, P, name):
    return F.layer_norm(x, (x.shape[-1],), P[f"{name}.weight"],
                        P[f"{name}.bias"], LN_EPS)


def _lin(x, P, name, prec):
    return F.linear(prec.q(x), prec.q(P[f"{name}.weight"]),
                    P.get(f"{name}.bias"))


def _keep(x, mask):
    return torch.where(mask, x, torch.zeros((), device=x.device))


def _same_s2(n: int) -> tuple[int, int]:
    """'SAME' padding of a kernel-3, stride-2 convolution over n steps."""
    total = max((-(-n // 2) - 1) * 2 + 3 - n, 0)
    return total // 2, total - total // 2


def _drop(x, drops):
    """Dropout with the next of `drops`' (keep mask, 1 / (1 - rate))."""
    if drops is None:
        return x
    keep, scale = next(drops)
    return x * keep * scale


def rel_buckets(T: int, device, n_buckets: int = 64,
                max_dist: int = 256) -> torch.Tensor:
    """Bucket of each relative offset j - i in [-(T-1), T-1]: the sign
    selects a half of the table; offsets under a quarter of the buckets are
    exact, longer ones log-spaced up to `max_dist`."""
    rel = torch.arange(-(T - 1), T, device=device)
    nb = n_buckets // 2
    half = nb // 2
    arel = rel.abs()
    log_ratio = torch.log(torch.clamp(arel.float(), min=1.0) / half)
    big = half + (log_ratio / math.log(max_dist / half)
                  * (nb - half)).to(torch.int32)
    big = torch.clamp(big, max=nb - 1)
    return (rel > 0).to(torch.int32) * nb + torch.where(
        arel < half, arel.to(torch.int32), big)


def rel_bias(P, T: int) -> torch.Tensor:
    """(L, H, T, T): bias[l, h, i, j] = table[l, h, bucket(j - i)]."""
    table = P["encoder.rel.table"]
    b = rel_buckets(T, table.device)
    i = torch.arange(T, device=table.device)
    idx = (T - 1) + i[None, :] - i[:, None]
    return table[:, :, b[idx]]


def _heads(x, H):
    B, T, D = x.shape
    return x.reshape(B, T, H, D // H).transpose(1, 2)


def _attend(q, k, v, mask, H, prec, bias=None):
    """Multi-head attention: scores / sqrt(dh) (+ bias), masked entries at
    -1e30, softmax over keys. mask broadcasts to (B, H, Tq, Tk)."""
    dh = q.shape[-1] // H
    s = torch.matmul(prec.q(_heads(q, H)),
                     prec.q(_heads(k, H)).transpose(-1, -2)) / math.sqrt(dh)
    if bias is not None:
        s = s + bias
    p = torch.softmax(torch.where(mask, s, NEG), dim=-1)
    o = torch.matmul(prec.q(p), prec.q(_heads(v, H)))
    B, _, Tq, _ = o.shape
    return o.transpose(1, 2).reshape(B, Tq, -1)


def encode(P, feats, flens, m: dict, prec: Prec, drops=None):
    """(B, N, M) features -> (encoder output (B, T', D) with zeros past each
    row's length, T' lengths)."""
    dev = feats.device
    H, L, K = m["encoder_heads"], m["encoder_layers"], m["conformer_kernel"]

    def tmask(lens, T):
        return torch.arange(T, device=dev)[None, :] < lens[:, None]

    h = _keep(feats, tmask(flens, feats.shape[1])[..., None])[:, None]
    lens = flens
    for conv in ("conv1", "conv2"):
        (t0, t1), (f0, f1) = _same_s2(h.shape[2]), _same_s2(h.shape[3])
        h = F.pad(h, (f0, f1, t0, t1))
        h = F.relu(F.conv2d(prec.q(h), prec.q(P[f"encoder.sub.{conv}.weight"]),
                            P[f"encoder.sub.{conv}.bias"], stride=2))
        lens = (lens + 1) // 2
        h = _keep(h, tmask(lens, h.shape[2])[:, None, :, None])
    B, C, T, Fo = h.shape
    x = _lin(h.permute(0, 2, 3, 1).reshape(B, T, Fo * C), P,
             "encoder.sub.proj", prec)
    x = _drop(x, drops)
    mask = tmask(lens, T)
    key_ok = mask[:, None, None, :]
    bias = rel_bias(P, T)
    for i in range(L):
        b = f"encoder.blocks.{i}"

        def ffn(x, ff):
            y = _lin(F.silu(_lin(_ln(x, P, f"{b}.{ff}.ln"), P,
                                 f"{b}.{ff}.fc1", prec)),
                     P, f"{b}.{ff}.fc2", prec)
            return x + 0.5 * _drop(y, drops)

        x = ffn(x, "ff1")
        hn = _ln(x, P, f"{b}.mhsa.ln")
        q, k, v = (_lin(hn, P, f"{b}.mhsa.{p}", prec) for p in "qkv")
        y = _lin(_attend(q, k, v, key_ok, H, prec, bias[i][None]), P,
                 f"{b}.mhsa.o", prec)
        x = x + _drop(y, drops)
        y = F.glu(_lin(_ln(x, P, f"{b}.conv.ln"), P, f"{b}.conv.pw1", prec),
                  dim=-1)
        y = _keep(y, mask[..., None]).transpose(1, 2)
        y = F.conv1d(F.pad(prec.q(y), ((K - 1) // 2, K - 1 - (K - 1) // 2)),
                     prec.q(P[f"{b}.conv.dw.weight"]), P[f"{b}.conv.dw.bias"],
                     groups=y.shape[1]).transpose(1, 2)
        y = _lin(F.silu(_ln(y, P, f"{b}.conv.norm")), P, f"{b}.conv.pw2",
                 prec)
        x = x + _drop(y, drops)
        x = ffn(x, "ff2")
        x = _ln(x, P, f"{b}.ln")
    return _keep(x, mask[..., None]), lens


def ctc_logits(P, enc, prec: Prec) -> torch.Tensor:
    return _lin(enc, P, "ctc_head.proj", prec)


def greedy(logits: torch.Tensor, lens: torch.Tensor) -> list[list[int]]:
    """Best path per row: argmax, repeats merged, blanks (0) dropped."""
    out = []
    for row, n in zip(logits.argmax(-1).tolist(), lens.tolist()):
        toks, prev = [], 0
        for t in row[:n]:
            if t != 0 and t != prev:
                toks.append(t)
            prev = t
        out.append(toks)
    return out


# ------------------------------------------------------------ decoder
def sinusoid(T: int, D: int, device) -> torch.Tensor:
    pos = np.arange(T)[:, None]
    ang = pos / np.power(10000.0, 2 * np.arange(D // 2)[None, :] / D)
    pe = np.zeros((T, D))
    pe[:, 0::2], pe[:, 1::2] = np.sin(ang), np.cos(ang)
    return torch.tensor(pe, dtype=torch.float32, device=device)


def decoder_logp(P, enc, enc_lens, tokens, m: dict, prec: Prec,
                 drops=None) -> torch.Tensor:
    """Teacher-forced log-probs (B, U+1, V) of [tokens, eos] from inputs
    [sos, tokens]: pre-LN blocks of causal self-attention, cross-attention
    to the frames t < enc_lens, ReLU FFN."""
    dev = enc.device
    B, T, _ = enc.shape
    Dd, H = m["decoder_dim"], m["decoder_heads"]
    U1 = tokens.shape[1] + 1
    inputs = torch.cat([torch.full((B, 1), SOS_EOS, dtype=torch.long,
                                   device=dev),
                        tokens.long()], dim=1)
    x = P["decoder.embed.weight"][inputs] * math.sqrt(Dd) + sinusoid(
        U1, Dd, dev)
    x = _drop(x, drops)
    causal = torch.tril(torch.ones(U1, U1, dtype=torch.bool,
                                   device=dev))[None, None]
    cross = (torch.arange(T, device=dev)[None, :]
             < enc_lens[:, None])[:, None, None, :]
    for i in range(m["decoder_layers"]):
        b = f"decoder.blocks.{i}"
        h = _ln(x, P, f"{b}.ln1")
        q, k, v = (_lin(h, P, f"{b}.{p}", prec) for p in ("wq1", "wk1", "wv1"))
        x = x + _drop(_lin(_attend(q, k, v, causal, H, prec), P, f"{b}.wo1",
                           prec), drops)
        q = _lin(_ln(x, P, f"{b}.ln2"), P, f"{b}.wq2", prec)
        k, v = _lin(enc, P, f"{b}.wk2", prec), _lin(enc, P, f"{b}.wv2", prec)
        x = x + _drop(_lin(_attend(q, k, v, cross, H, prec), P, f"{b}.wo2",
                           prec), drops)
        f = _lin(F.relu(_lin(_ln(x, P, f"{b}.ln3"), P, f"{b}.fc1", prec)), P,
                 f"{b}.fc2", prec)
        x = x + _drop(f, drops)
    return F.log_softmax(_lin(_ln(x, P, "decoder.ln_out"), P, "decoder.proj",
                              prec), dim=-1)


# ------------------------------------------------------------ losses
def ce_per_utt(logp, tokens, token_lens, smoothing: float) -> torch.Tensor:
    """Label-smoothed CE over [tokens, eos], averaged over U + 1 positions
    of each row (0 for rows without tokens)."""
    B, U1, V = logp.shape
    tgt = torch.cat([tokens.long(), torch.zeros(B, 1, dtype=torch.long,
                                                 device=logp.device)], 1)
    tgt = tgt.scatter(1, token_lens.long()[:, None], SOS_EOS)
    nll = -logp.gather(-1, tgt[..., None])[..., 0]
    nll = (1 - smoothing) * nll - smoothing * logp.mean(-1)
    valid = torch.arange(U1, device=logp.device)[None, :] <= token_lens[:, None]
    per = torch.where(valid, nll, 0.0).sum(1) / (token_lens + 1).float()
    return torch.where(token_lens > 0, per, 0.0)


def hybrid_loss_sum(logits, enc_lens, logp, tokens, token_lens,
                    m: dict) -> torch.Tensor:
    """The rows' summed contributions to the hybrid loss (divide by the
    batch's rows with tokens): w * CTC NLL / U + (1 - w) * CE."""
    w = m["ctc_weight"]
    total = torch.zeros((), device=logits.device)
    if w > 0:
        lp = F.log_softmax(logits.float(), -1).transpose(0, 1)
        nll = F.ctc_loss(lp, tokens.long(), enc_lens.long(),
                         token_lens.long(), blank=0, reduction="none")
        nll = torch.where(token_lens > 0, nll, 0.0)
        total = total + w * (nll / token_lens.clamp(min=1).float()).sum()
    if w < 1:
        total = total + (1 - w) * ce_per_utt(logp, tokens, token_lens,
                                             m["label_smoothing"]).sum()
    return total


# ------------------------------------------------------------ training
def dropout_shapes(B: int, T: int, U1: int, m: dict) -> list[tuple]:
    """The shapes of one step's dropout draws, in the order the model's
    forward takes them: after the subsampling and after each FFN, MHSA and
    convolution module of every encoder block; then after the decoder's
    embedding and its three sub-layers of every block."""
    enc = [(B, T, m["encoder_dim"])] * (1 + 4 * m["encoder_layers"])
    dec = ([(B, U1, m["decoder_dim"])] * (1 + 3 * m["decoder_layers"])
           if m["ctc_weight"] < 1.0 else [])
    return enc + dec


def noam(train: dict, count: int) -> float:
    if train["schedule"] == "noam":
        s, w = float(count + 1), train["warmup_steps"]
        return train["lr"] * w ** 0.5 * min(s ** -0.5, s * w ** -1.5)
    if train["schedule"] == "constant":
        return train["lr"]
    raise ValueError(f"the reference has no schedule {train['schedule']!r}")


def train_steps(P0: dict, batches: list, cfg: dict, prec: Prec, seed: int,
                block_rows: int) -> dict:
    """Drive the hybrid step from the weights P0 over `batches`, one update
    each: (audio, audio_lens, tokens, token_lens, spec_mask) on the device.
    Dropout masks are drawn as the model takes them (`dropout_shapes`) from
    a generator on the device seeded with `seed`; rows go forward and back
    in blocks of `block_rows`, their gradients summed.

    Returns {'loss': [per step], 'grad_norms': the first clipped gradient's
    norm of each leaf, 'change_norms': each leaf's distance from P0 after
    the last step}."""
    m, fe, tr = cfg["model"], cfg["frontend"], cfg["train"]
    names = list(P0)
    params = [P0[n].detach().clone().float() for n in names]
    m1 = [torch.zeros_like(p) for p in params]
    m2 = [torch.zeros_like(p) for p in params]
    dev = params[0].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    rate, dec_rate = m["encoder_dropout"], m["decoder_dropout"]
    out = {"loss": []}
    for count, (audio, alens, tokens, tlens, spec) in enumerate(batches):
        B = audio.shape[0]
        T = enc_len(audio.shape[1], fe)
        shapes = dropout_shapes(B, T, tokens.shape[1] + 1, m)
        n_enc = 1 + 4 * m["encoder_layers"]
        masks = []
        for j, shp in enumerate(shapes):
            r = rate if j < n_enc else dec_rate
            u = torch.rand(shp, generator=gen, device=dev)
            masks.append(((u < 1.0 - r).float(), 1.0 / (1.0 - r)))
        n_valid = max(int((tlens > 0).sum()), 1)
        grads = [torch.zeros_like(p) for p in params]
        loss = 0.0
        for r0 in range(0, B, block_rows):
            sl = slice(r0, r0 + block_rows)
            leaves = [p.detach().requires_grad_(True) for p in params]
            P = dict(zip(names, leaves))
            with torch.no_grad():
                feats, flens = logmel(audio[sl], alens[sl], fe, prec)
                feats = feats * spec[sl]
            drops = iter([(k[sl], s) for k, s in masks])
            enc, elens = encode(P, feats, flens, m, prec, drops)
            logits = ctc_logits(P, enc, prec)
            logp = (decoder_logp(P, enc, elens, tokens[sl], m, prec, drops)
                    if m["ctc_weight"] < 1.0 else None)
            part = hybrid_loss_sum(logits, elens, logp, tokens[sl],
                                   tlens[sl], m) / n_valid
            g = torch.autograd.grad(part, leaves, allow_unused=True)
            for acc, gi in zip(grads, g):
                if gi is not None:
                    acc += gi
            loss += float(part.detach())
        out["loss"].append(loss)
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads]))
        if float(norm) >= tr["grad_clip"]:
            grads = [g / norm * tr["grad_clip"] for g in grads]
        if count == 0:
            out["grad_norms"] = dict(zip(names, (
                float(torch.linalg.vector_norm(g)) for g in grads)))
        b1, b2, eps, wd = 0.9, 0.999, 1e-8, tr["weight_decay"]
        lr = noam(tr, count)
        with torch.no_grad():
            for p, g, a, v in zip(params, grads, m1, m2):
                a.mul_(b1).add_((1 - b1) * g)
                v.mul_(b2).add_((1 - b2) * g * g)
                upd = (a / (1 - b1 ** (count + 1))) / (
                    torch.sqrt(v / (1 - b2 ** (count + 1))) + eps)
                if tr["optimizer"] == "adamw":
                    upd = upd + wd * p
                p.add_(-lr * upd)
    out["change_norms"] = {n: float(torch.linalg.vector_norm(p - P0[n].float()))
                           for n, p in zip(names, params)}
    return out


@torch.no_grad()
def serve_reference(P: dict, batch: dict, served, cfg: dict, prec: Prec,
                    block_rows: int):
    """What a served request is judged against: the CTC logits (B, T', V)
    and T' lengths of its padded batch, computed in blocks of rows (the
    served ids play no part)."""
    m, fe = cfg["model"], cfg["frontend"]
    audio, alens = batch["audio"], batch["audio_lens"]
    outs, lens = [], []
    for r0 in range(0, audio.shape[0], block_rows):
        feats, flens = logmel(audio[r0:r0 + block_rows],
                              alens[r0:r0 + block_rows], fe, prec)
        enc, elens = encode(P, feats, flens, m, prec)
        outs.append(ctc_logits(P, enc, prec))
        lens.append(elens)
    return torch.cat(outs), torch.cat(lens)
