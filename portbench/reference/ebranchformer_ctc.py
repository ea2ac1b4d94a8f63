"""Plain PyTorch reference of the E-Branchformer CTC family, in float32.

E-Branchformer (Kim et al. 2022, arXiv:2210.00077; ESPnet's
`EBranchformerEncoderLayer`) as OWSM v3.1 lays it out (Peng et al. 2024,
arXiv:2401.16658): log-mel with per-utterance CMVN (`common.logmel`), the
two-layer stride-2 conv subsampling, absolute sinusoidal positions (x *
sqrt(D) + PE, ESPnet's `abs_pos`), E-Branchformer blocks, a final layer
norm, the CTC head and greedy decoding; the Transformer decoder, the
hybrid CTC/label-smoothed-CE loss, the global-norm clip and AdamW on the
Noam schedule are the Conformer family's (`conformer_ctc`). A block,
pre-LN, dropout after each marked term:

    x = x + 1/2 * FFN_a(LN(x))                      # Swish, D -> F -> D
    a = MHSA(LN(x))                                 # global branch
    (r, z) = halves of GELU(W1 LN(x))               # U wide
    c = W2 (r * DWConv(LN(z)))                      # local branch (cgMLP)
    m = [a, c]                                      # 2D channels
    x = x + Wm (m + DWConv(m))                      # the merge, 2D -> D
    x = x + 1/2 * FFN_b(LN(x));  x = LN(x)

Where it departs from ESPnet, as the program does:
- the pad frames of each depthwise convolution's input are zeroed (ESPnet
  convolves them as they are), so that a row's output does not depend on
  its batch's padding;
- the subsampling pads 'SAME' (the system's rule: 20 mel positions after
  it at 80 mels) where ESPnet's `Conv2dSubsampling` convolves 'valid' (19);
- layer norms take eps 1e-6 (the system's), ESPnet's 1e-12;
- per-utterance CMVN and a pre-emphasis of 0.97 where OWSM normalizes by
  global mean-variance statistics of its training data;
- no dropout inside the cgMLP's gating unit (ESPnet drops after the gate
  product as well as after the branch).

Written from the configuration alone: it imports no module of the measured
program and reads the weights from a state dict keyed by the program's
parameter names. What the harness takes of a family's reference:
`param_spec`, `enc_len`, `serve_reference` and `train_steps`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.common import Prec, logmel
from portbench.reference.conformer_ctc import (
    _attend,
    _drop,
    _keep,
    _lin,
    _ln,
    _same_s2,
    ctc_logits,
    decoder_logp,
    enc_len,
    hybrid_loss_sum,
    noam,
    sinusoid,
)


# ------------------------------------------------------------ parameters
def param_spec(cfg: dict, init: dict) -> list[tuple[str, tuple, str,
                                                    float]]:
    """(name, shape, init, scale) of every parameter of the configuration
    `cfg`, in the program's order and names. init: 'normal' (N(0,
    scale^2)), 'zeros', 'ones'. Weights are LeCun-normal (a depthwise
    kernel's fan-in is its width), embeddings N(0, 1/dim); biases 0,
    LayerNorm scales 1. `init` holds nothing this family reads."""
    m = cfg["model"]
    D, Fd, L = m["encoder_dim"], m["encoder_ffn_dim"], m["encoder_layers"]
    C = m["subsample_channels"] or D
    U = m["cgmlp_units"]
    V = m["vocab_size"]
    spec = []

    def lin(name, d_out, d_in):
        spec.append((f"{name}.weight", (d_out, d_in), "normal",
                     1 / math.sqrt(d_in)))
        spec.append((f"{name}.bias", (d_out,), "zeros", 0.0))

    def ln(name, d):
        spec.append((f"{name}.weight", (d,), "ones", 0.0))
        spec.append((f"{name}.bias", (d,), "zeros", 0.0))

    def dw(name, d, k):
        spec.append((f"{name}.weight", (d, 1, k), "normal", 1 / math.sqrt(k)))
        spec.append((f"{name}.bias", (d,), "zeros", 0.0))

    spec.append(("encoder.sub.conv1.weight", (C, 1, 3, 3), "normal", 1 / 3))
    spec.append(("encoder.sub.conv1.bias", (C,), "zeros", 0.0))
    spec.append(("encoder.sub.conv2.weight", (C, C, 3, 3), "normal",
                 1 / math.sqrt(9 * C)))
    spec.append(("encoder.sub.conv2.bias", (C,), "zeros", 0.0))
    f_out = ((cfg["frontend"]["n_mels"] + 1) // 2 + 1) // 2
    lin("encoder.sub.proj", D, f_out * C)
    for i in range(L):
        b = f"encoder.blocks.{i}"
        ln(f"{b}.ff1.ln", D)
        lin(f"{b}.ff1.fc1", Fd, D)
        lin(f"{b}.ff1.fc2", D, Fd)
        ln(f"{b}.mhsa.ln", D)
        for p in "qkvo":
            lin(f"{b}.mhsa.{p}", D, D)
        ln(f"{b}.cgmlp.ln", D)
        lin(f"{b}.cgmlp.fc1", U, D)
        ln(f"{b}.cgmlp.norm", U // 2)
        dw(f"{b}.cgmlp.dw", U // 2, m["cgmlp_kernel"])
        lin(f"{b}.cgmlp.fc2", D, U // 2)
        dw(f"{b}.merge.dw", 2 * D, m["merge_kernel"])
        lin(f"{b}.merge.proj", D, 2 * D)
        ln(f"{b}.ff2.ln", D)
        lin(f"{b}.ff2.fc1", Fd, D)
        lin(f"{b}.ff2.fc2", D, Fd)
        ln(f"{b}.ln", D)
    ln("encoder.ln_out", D)
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


# ------------------------------------------------------------ encoder
def _depthwise(y, P, name, mask, prec):
    """A depthwise convolution over time of y (B, T, C), 'same' padded,
    its input zeroed past each row's length."""
    K = P[f"{name}.weight"].shape[-1]
    y = _keep(y, mask[..., None]).transpose(1, 2)
    y = F.conv1d(F.pad(prec.q(y), ((K - 1) // 2, K - 1 - (K - 1) // 2)),
                 prec.q(P[f"{name}.weight"]), P[f"{name}.bias"],
                 groups=y.shape[1])
    return y.transpose(1, 2)


def encode(P, feats, flens, m: dict, prec: Prec, drops=None):
    """(B, N, M) features -> (encoder output (B, T', D) with zeros past each
    row's length, T' lengths)."""
    dev = feats.device
    H, L, D = m["encoder_heads"], m["encoder_layers"], m["encoder_dim"]

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
    x = _drop(x * math.sqrt(D) + sinusoid(T, D, dev), drops)
    mask = tmask(lens, T)
    key_ok = mask[:, None, None, :]
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
        a = _drop(_lin(_attend(q, k, v, key_ok, H, prec), P, f"{b}.mhsa.o",
                       prec), drops)
        g = F.gelu(_lin(_ln(x, P, f"{b}.cgmlp.ln"), P, f"{b}.cgmlp.fc1",
                        prec))
        r, z = g.chunk(2, dim=-1)
        z = _depthwise(_ln(z, P, f"{b}.cgmlp.norm"), P, f"{b}.cgmlp.dw", mask,
                       prec)
        c = _drop(_lin(r * z, P, f"{b}.cgmlp.fc2", prec), drops)
        mm = torch.cat([a, c], dim=-1)
        y = _lin(mm + _depthwise(mm, P, f"{b}.merge.dw", mask, prec), P,
                 f"{b}.merge.proj", prec)
        x = x + _drop(y, drops)
        x = ffn(x, "ff2")
        x = _ln(x, P, f"{b}.ln")
    x = _ln(x, P, "encoder.ln_out")
    return _keep(x, mask[..., None]), lens


# ------------------------------------------------------------ training
def dropout_shapes(B: int, T: int, U1: int, m: dict) -> list[tuple]:
    """The shapes of one step's dropout draws, in the order the model's
    forward takes them: after the positions, then in every encoder block
    after ff1, the attention branch, the cgMLP branch, the merge and ff2;
    then after the decoder's embedding and its three sub-layers of every
    block."""
    enc = [(B, T, m["encoder_dim"])] * (1 + 5 * m["encoder_layers"])
    dec = ([(B, U1, m["decoder_dim"])] * (1 + 3 * m["decoder_layers"])
           if m["ctc_weight"] < 1.0 else [])
    return enc + dec


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
    n_enc = 1 + 5 * m["encoder_layers"]
    out = {"loss": []}
    for count, (audio, alens, tokens, tlens, spec) in enumerate(batches):
        B = audio.shape[0]
        T = enc_len(audio.shape[1], fe)
        masks = []
        for j, shp in enumerate(dropout_shapes(B, T, tokens.shape[1] + 1,
                                               m)):
            r = m["encoder_dropout"] if j < n_enc else m["decoder_dropout"]
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
    out["change_norms"] = {
        n: float(torch.linalg.vector_norm(p - P0[n].float()))
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
