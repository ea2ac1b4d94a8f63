"""The LSTM recurrence (`csrc/lstm.cu`): the kernels of the JAX package's
`ops/rnn_pallas.py`.

The input projection `x @ W_ih` stays one large matrix product in torch
(as it stays in XLA there); the sequential part is a kernel. What the
kernels compute is not `ops/rnn.py` `lstm_scan`: the recurrent product is
float32 with W_hh not cast, the forward also returns c_all (the frozen c
past each row's length), and the backward recomputes the gates from
(xg, h_prev, c_prev), takes no cotangent for c_all, and returns dxg and
dW_hh. The kernels take D directions stacked, (D, B, T, .), so that a
bidirectional layer is one forward launch and one backward launch:
`lstm_fwd` and `lstm_bwd` launch on CUDA tensors, count the launch, and
take the plain version only for CPU tensors. The backward's plain version
is the kernel's three parts composed: the gate activations of every step
(`lstm_bwd_gates_plain`), the reverse-time recurrence on them
(`lstm_bwd_recur_plain`) and dW_hh (`lstm_bwd_dw_plain`). `LstmLayer`
makes the pair one differentiable function and `bilstm_kernel` a
bidirectional layer of it. `lstm_seq_fwd`, `lstm_seq_bwd`, `LstmSeq` and
`lstm_scan_kernel` are one direction of the same kernels, the
counterparts of `lstm_seq_pallas` and `lstm_scan_pallas`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _gates(xg_t, h, c, whh):
    """One step's (h', c', (i, f, g, o)) from float32 inputs."""
    gates = xg_t + h @ whh
    i, f, g, o = gates.chunk(4, dim=-1)
    i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), \
        torch.sigmoid(o)
    c_new = f * c + i * g
    return o * torch.tanh(c_new), c_new, (i, f, g, o)


def lstm_seq_fwd_plain(xg, whh, lens):
    """The forward kernel in torch: xg (B, T, 4H) float32, whh (H, 4H)
    float32, lens (B,) -> (h_all, c_all), (B, T, H) float32. h_all is 0
    and c_all holds the frozen c at steps t >= lens[b]."""
    B, T, H4 = xg.shape
    h = xg.new_zeros(B, H4 // 4)
    c = torch.zeros_like(h)
    hs, cs = [], []
    for t in range(T):
        h_new, c_new, _ = _gates(xg[:, t], h, c, whh)
        valid = (t < lens)[:, None]
        hs.append(torch.where(valid, h_new, torch.zeros_like(h_new)))
        c = torch.where(valid, c_new, c)
        h = torch.where(valid, h_new, h)
        cs.append(c)
    return torch.stack(hs, dim=1), torch.stack(cs, dim=1)


def lstm_seq_bwd_plain(xg, whh, lens, h_all, c_all, g):
    """The backward kernel in torch: the cotangent g (B, T, H) of h_all ->
    (dxg (B, T, 4H), dW_hh (H, 4H)), reverse in time, the gates recomputed
    from (xg, h_prev, c_prev) with h_prev/c_prev the forward's outputs
    shifted by one step (zeros at t = 0). dgates are zero at steps t >=
    lens[b], where the carries keep their value."""
    B, T, H4 = xg.shape
    h_prev = F.pad(h_all, (0, 0, 1, 0))[:, :T]
    c_prev = F.pad(c_all, (0, 0, 1, 0))[:, :T]
    dh = xg.new_zeros(B, H4 // 4)
    dc = torch.zeros_like(dh)
    dwhh = torch.zeros_like(whh)
    dxg = torch.empty_like(xg)
    for t in reversed(range(T)):
        _, c_new, (i, f, gg, o) = _gates(xg[:, t], h_prev[:, t], c_prev[:, t],
                                         whh)
        tc = torch.tanh(c_new)
        dh_t = dh + g[:, t]
        dc_t = dc + dh_t * o * (1.0 - tc * tc)
        dgates = torch.cat([dc_t * gg * i * (1.0 - i),
                            dc_t * c_prev[:, t] * f * (1.0 - f),
                            dc_t * i * (1.0 - gg * gg),
                            dh_t * tc * o * (1.0 - o)], dim=-1)
        valid = (t < lens)[:, None]
        dgates = torch.where(valid, dgates, torch.zeros_like(dgates))
        dxg[:, t] = dgates
        dwhh += h_prev[:, t].T @ dgates
        dh = torch.where(valid, dgates @ whh.T, dh)
        dc = torch.where(valid, dc_t * f, dc)
    return dxg, dwhh


def lstm_fwd_plain(xg, whh, lens):
    """The forward kernel in torch over D stacked directions: xg (D, B, T,
    4H), whh (D, H, 4H) -> (h_all, c_all), (D, B, T, H)."""
    hc = [lstm_seq_fwd_plain(x, w, lens) for x, w in zip(xg, whh)]
    return (torch.stack([h for h, _ in hc]),
            torch.stack([c for _, c in hc]))


def _shift(a):
    """a[..., t - 1, :] at step t, zeros at t = 0 (h_prev, c_prev)."""
    return F.pad(a, (0, 0, 1, 0))[..., :a.shape[-2], :]


def lstm_bwd_gates_plain(xg, whh, h_all):
    """Part (a) of the backward kernel: the gate activations (sigmoid i, f,
    o; tanh g) of every step at once, from xg (.., B, T, 4H) and h_prev
    (h_all shifted by one step), with whh (.., H, 4H)."""
    gates = xg + _shift(h_all) @ whh.unsqueeze(-3)
    i, f, g, o = gates.chunk(4, dim=-1)
    return torch.cat([torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                      torch.sigmoid(o)], dim=-1)


def lstm_bwd_recur_plain(act, whh, lens, c_all, g):
    """Part (b): the reverse-time recurrence on the activations act (.., B,
    T, 4H) -> dgates (.., B, T, 4H), zero at steps t >= lens[b], where the
    carries keep their value."""
    T = act.shape[-2]
    c_prev = _shift(c_all)
    dh = torch.zeros_like(g[..., 0, :])
    dc = torch.zeros_like(dh)
    dxg = torch.empty_like(act)
    for t in reversed(range(T)):
        i, f, gg, o = act[..., t, :].chunk(4, dim=-1)
        cp = c_prev[..., t, :]
        tc = torch.tanh(f * cp + i * gg)
        dh_t = dh + g[..., t, :]
        dc_t = dc + dh_t * o * (1.0 - tc * tc)
        dgates = torch.cat([dc_t * gg * i * (1.0 - i),
                            dc_t * cp * f * (1.0 - f),
                            dc_t * i * (1.0 - gg * gg),
                            dh_t * tc * o * (1.0 - o)], dim=-1)
        valid = (t < lens)[:, None]
        dgates = torch.where(valid, dgates, torch.zeros_like(dgates))
        dxg[..., t, :] = dgates
        dh = torch.where(valid, dgates @ whh.transpose(-1, -2), dh)
        dc = torch.where(valid, dc_t * f, dc)
    return dxg


def lstm_bwd_dw_plain(h_all, dgates):
    """Part (c): dW_hh = sum over rows and steps of h_prev^T dgates, (..,
    H, 4H)."""
    H, H4 = h_all.shape[-1], dgates.shape[-1]
    h_prev = _shift(h_all).reshape(*h_all.shape[:-3], -1, H)
    return h_prev.transpose(-1, -2) @ dgates.reshape(*dgates.shape[:-3], -1,
                                                     H4)


def lstm_bwd_plain(xg, whh, lens, h_all, c_all, g):
    """The backward kernel in torch over D stacked directions: its three
    parts composed -> (dxg (D, B, T, 4H), dW_hh (D, H, 4H))."""
    act = lstm_bwd_gates_plain(xg, whh, h_all)
    dxg = lstm_bwd_recur_plain(act, whh, lens, c_all, g)
    return dxg, lstm_bwd_dw_plain(h_all, dxg)


def _check(name, xg, whh, lens, *more):
    if xg.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {xg.device}")
    if xg.dim() != 4 or xg.dtype != torch.float32 or xg.shape[3] % 16:
        raise TypeError(f"{name}: xg must be (D, B, T, 4H) float32 with H a "
                        f"multiple of 4, got {tuple(xg.shape)} {xg.dtype}")
    D, B, T, H4 = xg.shape
    shapes = [("whh", whh, (D, H4 // 4, H4)), ("lens", lens, (B,))]
    shapes += [(n, t, (D, B, T, H4 // 4)) for n, t in more]
    for nm, t, shape in shapes:
        if tuple(t.shape) != shape or t.device != xg.device:
            raise ValueError(f"{name}: {nm} must be {shape} on {xg.device}")
        if nm != "lens" and t.dtype != torch.float32:
            raise TypeError(f"{name}: {nm} must be float32, got {t.dtype}")


def lstm_plan(bwd: bool, D: int, B: int, H: int) -> dict:
    """The cluster configuration the forward (bwd False) or the backward
    recurrence takes at (D, B, H) on this card; raises where none fits."""
    import ctypes

    from pytorch_end2end_speech_recognition_tpu_torch.ops import _build

    out = (ctypes.c_int * 7)()
    _build.check(_build.load().lstm_plan(int(bwd), D, B, H, out),
                 f"lstm_plan(D={D}, B={B}, H={H})")
    return dict(zip(("cluster", "rows", "warps", "clusters",
                     "clusters_at_once", "threads", "smem_bytes"), out))


def lstm_fwd(xg, whh, lens):
    """(h_all, c_all) of the recurrence over D stacked directions: the
    forward kernel on CUDA tensors, `lstm_fwd_plain` on CPU tensors, as the
    operator `asr_port::lstm_fwd` (one node of an exported program, where
    the plain loop would unroll over T)."""
    return lstm_fwd_op(xg, whh, lens)


lstm_fwd.launches = 0


@torch.library.custom_op(
    "asr_port::lstm_fwd", mutates_args=(), device_types="cpu",
    schema="(Tensor xg, Tensor whh, Tensor lens) -> (Tensor, Tensor)")
def lstm_fwd_op(xg, whh, lens):
    """The operator's CPU version: `lstm_fwd_plain`."""
    return lstm_fwd_plain(xg, whh, lens)


@lstm_fwd_op.register_fake
def _lstm_fwd_fake(xg, whh, lens):
    D, B, T, H4 = xg.shape
    return (xg.new_empty((D, B, T, H4 // 4), dtype=torch.float32),
            xg.new_empty((D, B, T, H4 // 4), dtype=torch.float32))


@lstm_fwd_op.register_kernel("cuda")
def _lstm_fwd_cuda(xg, whh, lens):
    from pytorch_end2end_speech_recognition_tpu_torch.ops import _build

    _check("lstm_fwd", xg, whh, lens)
    D, B, T, H4 = xg.shape
    H = H4 // 4
    xg, whh = xg.contiguous(), whh.contiguous()
    lens32 = lens.to(torch.int32).contiguous()
    h_all = xg.new_empty(D, B, T, H)
    c_all = xg.new_empty(D, B, T, H)
    if B and T:
        err = _build.load().lstm_fwd_launch(
            xg.data_ptr(), whh.data_ptr(), lens32.data_ptr(),
            h_all.data_ptr(), c_all.data_ptr(), D, B, T, H,
            torch.cuda.current_stream(xg.device).cuda_stream)
        _build.check(err, "lstm_fwd")
        lstm_fwd.launches += 1
    return h_all, c_all


def lstm_bwd(xg, whh, lens, h_all, c_all, g):
    """(dxg, dW_hh) over D stacked directions for the cotangent g of h_all:
    the backward kernels on CUDA tensors, `lstm_bwd_plain` on CPU
    tensors."""
    if xg.device.type == "cpu":
        return lstm_bwd_plain(xg, whh, lens, h_all, c_all, g)
    from pytorch_end2end_speech_recognition_tpu_torch.ops import _build

    g = g.float()
    _check("lstm_bwd", xg, whh, lens, ("h_all", h_all), ("c_all", c_all),
           ("g", g))
    D, B, T, H4 = xg.shape
    H = H4 // 4
    xg, whh, h_all, c_all, g = (t.contiguous()
                                for t in (xg, whh, h_all, c_all, g))
    lens32 = lens.to(torch.int32).contiguous()
    dxg = torch.empty_like(xg)
    dwhh = torch.zeros_like(whh)
    if B and T:
        lib = _build.load()
        part = xg.new_empty(D, lib.lstm_bwd_splits(D, B, T, H), H, H4)
        err = lib.lstm_bwd_launch(
            xg.data_ptr(), whh.data_ptr(), lens32.data_ptr(),
            h_all.data_ptr(), c_all.data_ptr(), g.data_ptr(), dxg.data_ptr(),
            dwhh.data_ptr(), part.data_ptr(), D, B, T, H,
            torch.cuda.current_stream(xg.device).cuda_stream)
        _build.check(err, "lstm_bwd")
        lstm_bwd.launches += 1
    return dxg, dwhh


lstm_bwd.launches = 0


def lstm_seq_fwd(xg, whh, lens):
    """One direction of `lstm_fwd`: xg (B, T, 4H), whh (H, 4H) -> (h_all,
    c_all), (B, T, H)."""
    h_all, c_all = lstm_fwd(xg[None], whh[None], lens)
    return h_all[0], c_all[0]


def lstm_seq_bwd(xg, whh, lens, h_all, c_all, g):
    """One direction of `lstm_bwd`: (dxg (B, T, 4H), dW_hh (H, 4H))."""
    dxg, dwhh = lstm_bwd(xg[None], whh[None], lens, h_all[None],
                         c_all[None], g[None])
    return dxg[0], dwhh[0]


class LstmLayer(torch.autograd.Function):
    """h_all (D, B, T, H) of the recurrence over xg (D, B, T, 4H) with W_hh
    (D, H, 4H), differentiable in both: one forward and one backward
    launch for all D directions."""

    @staticmethod
    def forward(ctx, xg, whh, lens):
        h_all, c_all = lstm_fwd(xg, whh, lens)
        ctx.save_for_backward(xg, whh, lens, h_all, c_all)
        return h_all

    @staticmethod
    def backward(ctx, g):
        xg, whh, lens, h_all, c_all = ctx.saved_tensors
        dxg, dwhh = lstm_bwd(xg, whh, lens, h_all, c_all, g)
        return dxg, dwhh, None


class LstmSeq(torch.autograd.Function):
    """h_all (B, T, H) of the recurrence over xg (B, T, 4H) with W_hh (H,
    4H), differentiable in both (outputs only, as `lstm_seq_pallas`)."""

    @staticmethod
    def forward(ctx, xg, whh, lens):
        h_all, c_all = lstm_seq_fwd(xg, whh, lens)
        ctx.save_for_backward(xg, whh, lens, h_all, c_all)
        return h_all

    @staticmethod
    def backward(ctx, g):
        xg, whh, lens, h_all, c_all = ctx.saved_tensors
        dxg, dwhh = lstm_seq_bwd(xg, whh, lens, h_all, c_all, g)
        return dxg, dwhh, None


def _input_gates(x, w_ih, bias, dtype):
    """x @ W_ih in `dtype` with a float32 result, plus the bias."""
    return (x.to(dtype) @ w_ih.to(dtype)).float() + bias


def lstm_scan_kernel(x, lens, w_ih, w_hh, bias, reverse: bool = False,
                     dtype=torch.float32):
    """One LSTM direction through the recurrence kernels (outputs only, the
    counterpart of `lstm_scan_pallas`): the input product in `dtype` with a
    float32 result plus the bias, then `LstmSeq` with W_hh in float32."""
    from pytorch_end2end_speech_recognition_tpu_torch.ops.rnn import (
        flip_sequences,
    )

    if reverse:
        x = flip_sequences(x, lens)
    ys = LstmSeq.apply(_input_gates(x, w_ih, bias, dtype), w_hh.float(), lens)
    if reverse:
        ys = flip_sequences(ys, lens)
    return ys


def bilstm_kernel(x, lens, params_fwd, params_bwd, dtype=torch.float32):
    """Both directions of a bidirectional layer through one `LstmLayer`
    (the reverse direction's input and output flipped outside the kernel,
    as `lstm_scan_kernel` flips them) -> (forward, backward) outputs, each
    (B, T, H)."""
    from pytorch_end2end_speech_recognition_tpu_torch.ops.rnn import (
        flip_sequences,
    )

    (wf, uf, bf), (wb, ub, bb) = params_fwd, params_bwd
    xg = torch.stack([_input_gates(x, wf, bf, dtype),
                      _input_gates(flip_sequences(x, lens), wb, bb, dtype)])
    h = LstmLayer.apply(xg, torch.stack([uf.float(), ub.float()]), lens)
    return h[0], flip_sequences(h[1], lens)
