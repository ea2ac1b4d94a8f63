"""The x4 convolution subsampling's convolutions: the CUDA kernel
(`csrc/subsample.cu`) and its plain version.

The JAX package has no kernel here (`ConvSubsample` is two `nnx.Conv`s);
the port's kernel keeps the conv1 activation out of device memory and runs
conv2 on the tensor cores. `ConvSubsample` calls the operator
`asr_port::subsample` when it records no gradient at dtype bfloat16 (every
serving path, and exported programs); training keeps the plain version's
autograd.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pytorch_end2end_speech_recognition_tpu_torch.ops.masks import (
    length_mask,
    masked,
)


def _same_pad_s2(n: int) -> tuple[int, int]:
    """Flax 'SAME' padding for kernel 3, stride 2: (0, 1) when n is even,
    (1, 1) when odd."""
    total = max((-(-n // 2) - 1) * 2 + 3 - n, 0)
    return total // 2, total - total // 2


def _conv(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    (t0, t1), (f0, f1) = _same_pad_s2(h.shape[2]), _same_pad_s2(h.shape[3])
    h = F.pad(h.to(w.dtype), (f0, f1, t0, t1))
    return F.relu(F.conv2d(h, w, b, stride=2))


def subsample_plain(x: torch.Tensor, lens: torch.Tensor, w1: torch.Tensor,
                    b1: torch.Tensor, w2: torch.Tensor,
                    b2: torch.Tensor) -> torch.Tensor:
    """x (B, T, F) float32, lens (B,) -> (B, T2, F2 * C) in the weights'
    dtype, T2 = ceil(ceil(T / 2) / 2) (likewise F2), (F2, C) flattened with C
    fastest, as Flax's NHWC flattens it.

    w1 (C, 1, 3, 3), b1 (C,), w2 (C, C, 3, 3), b2 (C,), already cast to the
    model's dtype. Frames at or past lens are zeroed, the rest cast to that
    dtype; each convolution pads SAME, runs at stride 2 and is followed by
    ReLU; conv1's output is zeroed at t1 >= (lens + 1) // 2 and conv2's at
    t2 >= (lens1 + 1) // 2."""
    h = masked(x, length_mask(lens, x.shape[1])[:, :, None])[:, None]
    h = _conv(h, w1, b1)                                  # (B, C, T1, F1)
    lens = (lens + 1) // 2
    h = masked(h, length_mask(lens, h.shape[2])[:, None, :, None])
    h = _conv(h, w2, b2)
    lens = (lens + 1) // 2
    h = masked(h, length_mask(lens, h.shape[2])[:, None, :, None])
    B, C, T, Fo = h.shape
    # Flax is NHWC and flattens (F, C) with C fastest
    return h.permute(0, 2, 3, 1).reshape(B, T, Fo * C)


def subsample(x: torch.Tensor, lens: torch.Tensor, w1: torch.Tensor,
              b1: torch.Tensor, w2: torch.Tensor,
              b2: torch.Tensor) -> torch.Tensor:
    """`subsample_plain`'s function as the operator `asr_port::subsample`:
    the kernel on CUDA tensors (bf16 weights, C a multiple of 16 up to
    1024), the plain version on CPU tensors. Records no gradient."""
    return subsample_op(x, lens, w1, b1, w2, b2)


subsample.launches = 0


@torch.library.custom_op(
    "asr_port::subsample", mutates_args=(), device_types="cpu",
    schema="(Tensor x, Tensor lens, Tensor w1, Tensor b1, Tensor w2, "
           "Tensor b2) -> Tensor")
def subsample_op(x, lens, w1, b1, w2, b2):
    """The operator's CPU version: `subsample_plain`."""
    return subsample_plain(x, lens, w1, b1, w2, b2)


def _out_shape(x, w1):
    B, T, n_mels = x.shape
    T2, F2 = ((T + 1) // 2 + 1) // 2, ((n_mels + 1) // 2 + 1) // 2
    return B, T2, F2 * w1.shape[0]


@subsample_op.register_fake
def _subsample_fake(x, lens, w1, b1, w2, b2):
    return x.new_empty(_out_shape(x, w1), dtype=w1.dtype)


def kernel_plan(n_mels: int, C: int) -> dict:
    """The kernel's plan for n_mels and C channels (`subsample_plan` in
    `csrc/subsample.cu`): output channels a block (nw), N pieces, dynamic
    shared memory bytes, conv1 window entries a parity (s16), 64-channel
    chunks. Raises ValueError, naming the widths, where
    the kernel does not take them."""
    import ctypes

    from pytorch_end2end_speech_recognition_tpu_torch.ops import _build

    out = (ctypes.c_int * 5)()
    if _build.load().subsample_plan(n_mels, C, out) != 0:
        raise ValueError(
            f"subsample kernel takes C a multiple of 16 from 16 to 1024 and "
            f"n_mels whose conv1 window fits shared memory (got C={C}, "
            f"n_mels={n_mels})")
    keys = ("nw", "pieces", "smem_bytes", "s16", "chunks")
    return dict(zip(keys, list(out)))


@subsample_op.register_kernel("cuda")
def _subsample_cuda(x, lens, w1, b1, w2, b2):
    """The operator's CUDA version: checks what the kernel takes, lays the
    weights out for it, launches it and counts the launch on
    `subsample.launches`."""
    from pytorch_end2end_speech_recognition_tpu_torch.ops import _build

    for name, t in (("lens", lens), ("w1", w1), ("b1", b1), ("w2", w2),
                    ("b2", b2)):
        if t.device != x.device:
            raise ValueError(f"subsample: {name} on {t.device}, x on "
                             f"{x.device}")
    if x.dtype != torch.float32 or x.dim() != 3:
        raise TypeError(f"subsample: x must be (B, T, n_mels) float32, got "
                        f"{tuple(x.shape)} {x.dtype}")
    if any(t.dtype != torch.bfloat16 for t in (w1, b1, w2, b2)):
        raise TypeError("subsample kernel: w1, b1, w2, b2 must be bfloat16")
    B, T, n_mels = x.shape
    C = w1.shape[0]
    if (w1.shape != (C, 1, 3, 3) or b1.shape != (C,)
            or w2.shape != (C, C, 3, 3) or b2.shape != (C,)
            or lens.shape != (B,)):
        raise ValueError(f"subsample: w1 {tuple(w1.shape)}, b1 "
                         f"{tuple(b1.shape)}, w2 {tuple(w2.shape)}, b2 "
                         f"{tuple(b2.shape)} and lens {tuple(lens.shape)} "
                         f"disagree with x {tuple(x.shape)}")
    if lens.dtype.is_floating_point:
        raise TypeError(f"subsample: lens must be integer, got {lens.dtype}")
    p = kernel_plan(n_mels, C)
    out = torch.empty(_out_shape(x, w1), dtype=torch.bfloat16, device=x.device)
    if out.numel() == 0:
        return out
    cin, nout = p["chunks"] * 64, p["pieces"] * p["nw"]
    # conv1: (9 taps, bias, 6 zeros) a row; conv2: [tap][out][in]; zero
    # rows and columns past C
    w1p = torch.zeros((cin, 16), dtype=torch.bfloat16, device=x.device)
    w1p[:C, :9] = w1.reshape(C, 9)
    w1p[:C, 9] = b1
    w2r = w2.permute(2, 3, 0, 1).reshape(9, C, C)
    if (nout, cin) != (C, C):
        w2r = F.pad(w2r, (0, cin - C, 0, nout - C))
    w2r = w2r.contiguous()
    b2p = F.pad(b2.float(), (0, nout - C))
    x = x.contiguous()
    lens32 = lens.to(torch.int32).contiguous()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _build.load().subsample_launch(
        x.data_ptr(), lens32.data_ptr(), w1p.data_ptr(), w2r.data_ptr(),
        b2p.data_ptr(), out.data_ptr(), B, T, n_mels, C, stream)
    _build.check(err, "subsample")
    subsample.launches += 1
    return out
