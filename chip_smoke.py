"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --train-seeds 0,1,2   # [8]/[13] over draws

Phases, every one of which must pass (the script exits non-zero otherwise):

1. versions, and the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from `csrc/` (parallel nvcc, ptxas -v printed;
   the wgmma/TMA kernels' registers and spills summed up);
3. each kernel against its plain PyTorch version on the card, at the shapes
   the main paths give it, with kernel, plain, library and bound times:
   [3a] log-mel (bf16 on ragged and full rows and on a random dense
   filterbank; controls that must fail: a nonzero basis_prev zeroed, the
   frames read one hop late, one band's last bin left out of its range;
   two launches bit for bit; timed in turns with a library sequence of
   unfold, cuBLAS matmuls and log; float32 too), Toeplitz expand and
   reduce ([3b]/[3d]: at the flagship's 12 x 4 blocks and rung 4's 16 x
   8; the expand bit for bit, the reduce within T u sum|g|, two launches
   bit for bit and blind to a random pad band; each timed in turns with its
   library call and the parent kernel, `csrc/probe/toeplitz_parent.cu`,
   built beside the library), attention forward and backward
   (also at rung 4's d512/H8 shape), the long-audio flash attention forward
   and backward (the bias as float32 diagonals; B=16 x T' 1,638, B=4 x T'
   3,000 and rung 5's width, B=8 x T 750, H16, D1024), CTC alpha and beta
   at the lattice of every training path ([3g]: the flagship's, rung 3's,
   long audio's, an4_ctc's and wsj_las's; also against
   `torch.nn.functional.ctc_loss`, and timed in turns with it; two
   launches bit for bit), each with controls that must fail the same check
   (attention: bias dropped, lengths ignored;
   flash forward: diagonals dropped, lengths ignored; flash backward, held
   on ddiag alone to its float32 bound: ddiag shifted by one diagonal, a
   batch row left out, diagonals reversed; CTC: skip transitions disabled,
   lengths one frame short); the Toeplitz expand and reduce timed in turns
   with one gather and one `index_add_`;
   the attention and flash forwards (wgmma/TMA) timed in turns against
   SDPA (5 windows of 50 launches, medians) with their TFLOP/s and bound /
   kernel; the three gradient sums (Toeplitz reduce, attention backward's
   dbias, flash backward's ddiag) launched twice on the same inputs, the
   count of elements whose bits differ printed, which must be 0; [3k] the
   subsampling kernel at the serving cells' shapes (M 30 s, L 30 s, M 65
   s, OWSM 30 s at C 1024), held to its plain version and timed in turns
   with it and with cuDNN's bare convolutions; [3l] the attention forward
   without a bias at OWSM v3.1 medium's layer (B=32 x T' 750, d1024, H16)
   against the plain version without a bias on ragged and full lengths
   (controls: lengths ignored, a bias not added), timed in turns with
   SDPA;
4. the main path: the `flagship_conformer` preset at full width (12 L, d256,
   H4, FFN 1024, vocab 64), bf16, seeded random weights, encode -> CTC
   logits -> greedy decode on a ragged batch of 32 requests padded to 30 s;
   launch counts 1/1/12; the same model with every implementation set to
   'torch' as the reference, and a control (its relative bias zeroed) that
   must fail that comparison; requests alone vs in the batch; a
   numpy-oracle check of the log-mel on one utterance;
5. a few ragged requests answered, each held against itself alone and
   against the plain model, and their tokens printed;
6. throughput in audio-seconds per second at B=32 x 30 s, the median of
   timed windows;
7. a torch.profiler trace of the forward: device busy and idle share, and
   device time by kernel group and by kernel;
8. the training path at full width: one hybrid step (SpecAugment ->
   encoder -> CTC + 2-layer decoder -> hybrid loss, lambda 0.3 ->
   backward) on B=32 x 30 s with U=64 tokens, bf16, ragged, held against
   the same weights in plain torch on the card (loss, and every parameter's
   gradient by relative error and cosine), with a control (the plain model
   with its relative bias zeroed) that must fail; launch counts of one
   Solver step; five Solver steps with dropout and SpecAugment on, finite;
   train throughput in audio-seconds per second, peak memory, and a
   torch.profiler breakdown of one step; [8r] the same step with
   model.remat (every encoder block under torch.utils.checkpoint): its peak
   memory against the step without, and its loss and gradients against
   plain torch within [8]'s tolerances;
9. long-audio serving at full width past FLASH_T (T' 1,638): a ragged batch
   of 16 speech-like rows of 17-65 s padded to 2^20 samples, against the
   same weights in plain torch with a bias-zeroed control; launch counts per
   forward (logmel 1, flash 12, Toeplitz 0, dense attention 0); two
   requests padded as the JAX transcribe CLI pads them (20 s to 2^19
   samples, T' 819; 50 s to 2^20), with their tokens; throughput at B=16 x
   65.536 s; a profile;
10. one long-audio hybrid train step at full width (B=16 x 2^20 samples,
   U=128) against plain torch on the card (loss, every gradient, the
   relative-bias table's included, with a bias-zeroed control); launch
   counts per Solver.train_step (flash 12 + 12, Toeplitz 0 + 0, CTC 1 + 1);
   train throughput, peak memory and a profile;
3i. (run after [3g]) the LSTM recurrence kernels, forward and backward,
   both directions of a layer in one launch (thread-block clusters), against
   their plain versions at layer 0 of an4_ctc (B=32 x T 800, D 80, H 256)
   and wsj_las (B=32 x T 400, D 2,560, H 320), ragged lengths with a
   zero-length row, every element of h, c, dxg and dW_hh held to a float32
   bound; controls that must fail it (lengths ignored, W_hh read
   transposed, input and forget gates swapped, the directions' W_hh
   swapped); two backward launches compared bit for bit; the cluster plans;
   kernel and cuDNN (`torch.nn.LSTM(bidirectional=True)` on packed
   sequences, the yardstick) in turns, plain and bound times, and the time
   per dependent step;
11. an4_ctc (rung 1: 2-layer BiLSTM, H 256) serving at full width on a
   ragged B=32 batch of 2-8 s speech-like rows: launch counts (logmel 1,
   LSTM forward 2: one per layer), kernels vs plain torch with a control
   (layer 0's W_hh zeroed), throughput, peak memory and a profile;
12. the wsj_las hybrid step at full width (VGG + 4-layer pBLSTM, H 320,
   location-aware speller, lambda 0.3, SpecAugment, scheduled sampling
   0.1) on a ragged B=32 batch of 8-16 s rows, U <= 200: one step against
   plain torch on the card (loss, every gradient) with a control, launch
   counts (logmel 1, LSTM 4 + 4, CTC 1 + 1), five Solver steps, train
   throughput, peak memory and a profile; one an4_ctc CTC-only step;
3j. (run after [3i]) the fused FFN kernels (LayerNorm, fc1, SiLU, fc2,
   dropout, residual), forward and backward, against their plain versions
   at the flagship's and rung 3's rows (R = 32 x 750 = 24,000, D 256, F
   1,024), a ragged R and rung 4's width (D 512, F 2,048), rates 0 and 0.1,
   every element of out and the seven gradients held to 2^-6 (|plain| +
   m); controls that must fail it (b1 dropped, gamma ignored, the backward
   seeded with seed + 1, the last row tile left out, a row split of the
   backward's launch B, one 128-row tile's a and gh1 of its launch A, the
   split's rows left out of launch A's column sums, dgamma zeroed); two
   backward launches bit for bit; the dropout mask read from both kernels
   against the plain formula, its drop fraction and kept scale; kernel,
   plain, unfused-torch and bound times, the D-256 forward (wgmma/TMA) in
   turns with the unfused sequence at rates 0 and 0.1, the backward in
   turns with the unfused sequence's backward alone, split by launch;
13. the flagship with model.ffn_impl=cuda: serving launch counts (logmel 1,
   Toeplitz 1, attention 12, FFN 24) against all-plain torch (with the
   bias-zeroed control) and against the same kernels with ffn_impl=torch;
   one hybrid step at dropout 0 against plain torch (FFN 24 + 24); five
   Solver steps with dropout 0.1 and SpecAugment; serving and training
   throughput of ffn_impl=cuda and torch in turns; rung 4 with
   ffn_impl=cuda takes plain torch FFNs, as the JAX gate does;
14. libri100_transformer (rung 3: 12-layer Transformer encoder d256, H4,
   FFN 1,024, relative bias, 6-layer decoder, vocab 256) with
   ffn_impl=cuda on the B=32 x 30 s ragged batch: serving launch counts
   (logmel 1, Toeplitz 1, attention 12, FFN 12) against plain torch with a
   bias-zeroed control, throughput and a profile; one hybrid step (U <=
   128; attention 12 + 12, FFN 12 + 12, Toeplitz 1 + 1, CTC 1 + 1) against
   plain torch with a control; five Solver steps; train throughput, peak
   memory.
15. beam decode, ids level (joint CTC/attention, beam 10, 40 candidates,
   ctc_weight 0.3), for wsj_las (B=32 x 8-16 s, the LSTM speller), rung 3
   (inside [14]) and rung 4 with its 2 x 650 RnnLm at lm_weight 0.3
   (inside [16]): the CTC prefix kernels (score, select) against their
   plain versions at the model's lattice, within PREFIX_STEP_TOL T' (1 +
   |plain|), two launches bit for bit, and a control (the blank term
   dropped) that must fail; the decode through the kernels (one score and
   one select launch a token step) against the same decode with the plain
   prefix scorer, N-best tokens, lengths and finished flags equal on every
   row; SYNC_EVERY token steps under torch.cuda.set_sync_debug_mode
   ('error'), with a .item() as the control that must raise; decode
   audio-s/s, device kernels and ms a token step and the idle
   share. Each decode is capped at 12 token steps by max_decode_ratio
   (random weights rarely choose eos); the widths are the presets';
16. libri960_conformer (rung 4: 16-layer Conformer d512, H8, FFN 2,048,
   subsampling channels 128, 6-layer decoder d512, vocab 1,024) at full
   width on the B=32 x 30 s ragged batch: serving launch counts (logmel 1,
   Toeplitz 1, attention 16; its FFN plain torch by the JAX gate), logits
   against plain torch with a bias-zeroed control, throughput, peak memory
   and a profile; [15]; one hybrid step at B=16 x 30 s (U <= 128) against
   plain torch with [8]'s tolerances and a control, launch counts, the
   step's peak memory and a profile;
17. the trainer from a manifest: `cli.train.main` in process on the
   flagship at full width (bf16, the kernels, SpecAugment and dropout on)
   over a generated phrases corpus (512 train and 64 dev utterances of
   2.1-3.9 s, B=32), 20 steps with dev evaluations at 10 and 20 and a
   plateau schedule, then `--resume` to 30: the launches of every train
   step (as [8]'s) and dev forward, none of the plain versions; the
   checkpoint directory's files and the metrics records; the plateau
   decay replayed on the dev records; the resumed step 21 against the
   uninterrupted run's (utterance ids, SpecAugment mask bits, loss within
   [8]'s tolerance; a fresh-generator control must fail); a checkpoint
   round trip bit for bit; the vocabulary guard; dev logits against plain
   torch and both WERs; pinned batch copies in profiles of two fit steps,
   in turns with the same batches copied pageable (which must fail), the
   copied batches equal to the loader's; audio-s/s of fit, idle share,
   the copy's share of busy time and the host syncs of a step (printed,
   not gated); time warp on the card against the CPU;
18. streaming: rung 4 with its RnnLm at 0.3 streams one 60 s speech-like
   recording fed in 0.5 s pieces with the reference's defaults (chunk 8 s,
   overlap 2 s, 64-frame beam chunks, a 256-frame window, 256 tokens, 16
   steps a chunk, wait threshold -2.5): the launches of each encode window
   (logmel 1, Toeplitz 1, attention 16, no plain version); the emitted
   frames within 2 of the full-pass encode (the flash path); the streamed
   logits against the same windows on the plain model, with a bias-zeroed
   control; an4_ctc's StreamingTranscriber against plain torch (the LSTM
   kernel through streaming) with a W_hh-zeroed control; the prefix
   kernels at the window with a random pre-window column (r_init) against
   their plain versions, with a control that drops it; after every beam
   advance, the beam on the kernels against the same feeds with the plain
   prefix scorer (tokens, lengths, finished flags equal; scores within
   ctc_weight W 2^-22 (1 + |score|)); one score and one select launch a
   token step; a feed of SYNC_EVERY token steps under
   torch.cuda.set_sync_debug_mode('error') with a .item() control; the
   carry's bytes and the peak memory equal after 20 s and 59.5 s;
   `cli.train_lm` for 50 steps on [17]'s corpus, then
   `cli.transcribe --streaming` greedy and beam with that LM on [17]'s
   checkpoint (one JSON line a WAV, only the kernels launched). Printed,
   not gated: the error against the full pass at overlaps 0.5 s and 3 s,
   streaming audio-s/s greedy and beam, the latency of each 0.5 s feed,
   advances and token steps, ms and kernels a token step and the idle
   share under torch.profiler, lat_step's launches, and the prefix pair's
   times at the window against their bound;
19. serving bundles and the remaining CLIs: the flagship (seeded random
   weights, the relative bias at BIAS_STD) saved as a checkpoint and
   exported by `cli.export` in two processes at once, buckets (8, 30) and
   (32, 30), and (1, 10) and (1, 60); an4_ctc's greedy bundle (8, 8);
   rung 4's beam bundle (8, 10, beam 10, no LM). A fresh process (this
   script with `--bundle-child`) loads the greedy bundles with
   `serving.load_bundle` and transcribes 1 request of 7 s, 5 of 12-28 s,
   32 of 3-30 s, 1 of 50 s and an4's 8 of 2-8 s: the tokens equal the live
   model's greedy decode of the same padded batch; launches per call
   log-mel 1, Toeplitz 1, attention 12 (10 and 30 s), log-mel 1, flash 12
   (60 s), LSTM 2 (an4_ctc), no plain version; none of the port's models/,
   training/ or decode/ modules imported; no tensor of a program off the
   card but 0-d scalars; a control (the (32, 30) program exported with the
   relative bias zeroed) differs on some row; the beam bundle's texts equal
   the live decoder's and its prefix launches its token steps; `cli.decode`
   greedy and beam on a synthetic manifest equal to the in-process
   decodes, with the WER line and `--nbest-out`; `cli.main --test` equal
   to `cli.decode`; `cli.demo --steps 20 --encoder conformer`; and
   `cli.supervise` running `cli.train` for 20 steps to exit code 0.
   Printed, not gated: each program's export time and each bundle's
   bytes, the load time, and the (32, 30) bundle's transcribe audio-s/s
   beside [6]'s live forward.
20. data and tensor parallelism (`rung5_phase`): [20a] rung 5
   (libri960_multihost: 24 Conformer layers d1,024, H16, FFN 4,096, the
   6-layer decoder d512, vocab 1,024; bf16, seed 20) whole through
   `Solver(mesh=make_mesh(1, 1))` in a world-1 process group over
   'cpu:gloo,cuda:nccl' (an NCCL all-reduce of a card tensor first): one
   hybrid step on a ragged B=8 x 30 s batch (U <= 128) against plain
   torch on the card at [8]'s tolerances with a bias-zeroed control;
   launches (log-mel 1, flash 24 + 24, CTC 1 + 1), peak memory, step
   time. The card's compute mode must be Default. [20b] the same step at
   dp 1 x tp 2, two processes on the card over gloo (this script with
   `--dist-child`): the loss and every gradient, gathered whole, against
   [20a]'s kernel step, with two controls that must fail (pw1 split
   contiguously, not as GLU halves; block 0's row-parallel all-reduce
   left out); each rank's launches (flash 24 + 24 on 8 heads), peak
   memory, and parameter and Adam bytes (under 0.6 of [20a]'s). [20c] the
   flagship through `cli.train` at dp 2 x tp 1 (two processes, B=16
   each) against one process at B=32 for 5 steps on [17]'s manifest,
   dropout and SpecAugment off: each step's loss within 5e-4; one
   checkpoint and one tokenizer.json; `--resume` at dp 1 x tp 2 restoring
   every local slice bit for bit; `cli.decode` over two processes
   printing the one-process decode's lines and WER line. Every child has
   a timeout; one that fails or hangs fails the phase with every child's
   output printed. Its step times are no scaling numbers: two ranks share
   one card and gloo stages CUDA tensors through the host.
21. context and pipeline parallelism without a mesh, profiling, corpus
   prep and the native library (`cp_pp_phase`): [21a] the flagship with
   `cp_mode='ring'` on [4]'s batch (T' 750: the float32 diagonals and the
   flash kernels where it otherwise takes the dense pair): forward
   launches (log-mel 1, flash 12), logits against plain torch with a
   zeroed-diagonals control, 'ulysses' bit for bit 'ring', one hybrid
   step against plain torch at [8]'s tolerances, a `Solver.train_step`'s
   launches (flash 12 + 12, CTC 1 + 1), host-clock forward and step in
   turns with the dense path (printed, not gated); [21b] `pp_stages` 2
   with `ffn_impl=cuda`: no FFN launch in a forward or a step, logits bit
   for bit those of `pp_stages` 1 with `ffn_impl=torch`, and the FFN
   kernel in each of 24 blocks at `pp_stages` 1 as the control; [21c]
   `sharded_self_attention` with no group, ring and Ulysses, at (32, 750,
   4, 64) float32 with the diagonals against whole-row attention, their
   `StepTimer` times and peak memory beside kernel #7's time at that
   shape in bf16; [21d] in a fresh process (this script with `--profile-child`; late in this
   one torch.profiler records few or no device kernels) a
   `StepTimer.tick` no shorter than the call's device time and `trace()`
   naming the flash kernel; [21e] an AN4 tree through `prep_an4`, the
   native library's g++ build time, a loader batch decoded natively equal
   to the Python reader's bit for bit, one an4_ctc `Solver.train_step`
   from it (log-mel 1, LSTM 2 + 2, CTC 1 + 1), and the native Levenshtein
   against Python's on [17]'s dev WER inputs.

It then prints the total time, the `kernels` JSON line, the card's name and
power limit, and last `{"ok": true, "device": {...}}`. Without a card it
exits non-zero before printing any result. It imports only the port, never
JAX.
"""

from __future__ import annotations

import json
import math
import os
import platform
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

B, SECONDS, SR = 32, 30.0, 16000
WIN, HOP = 400, 160
REQUEST_LENS = (4 * SR, 2 * SR, 4 * SR // 3, SR)  # __graft_entry__.entry()
ALONE_ROWS = (1, 2, 7)  # batch rows also answered alone
WINDOWS, ITERS = 7, 5
PKG = "pytorch_end2end_speech_recognition_tpu_torch"
# std of the relative-position table in the kernel checks and the model.
# At the init's 0.02 the bias moves the attention output by ~1e-3 and the
# logits by less than bf16 noise, so a kernel that dropped or misread it
# would pass. A table of std 4 makes attention local, as a trained one is,
# and the attention branch a visible part of the residual stream; the
# controls in [3] and [4] show that the checks then see the bias.
BIAS_STD = 4.0

# tolerances of the kernel checks, kernel vs plain on the same inputs
TOL_LOGMEL = 1e-3      # float32 sums in another order, in the log domain
TOL_TOEPLITZ = 0.0     # a copy: exact
# attention, elementwise, from the bf16 unit roundoff u = 2^-8: both outputs
# are rounded once to bf16 (2u|o|), and the kernel rounds the unnormalised
# e where the plain version rounds p (at most 3u p_j each, <= 4u sum p|v|):
#   |kernel - plain| <= 2^-7 |plain| + 2^-6 (p . |v|)
ATTN_RTOL, ATTN_VTOL = 2.0 ** -7, 2.0 ** -6
# the whole bf16 model through 12 layers: kernels vs plain torch, and one
# request alone vs in the batch (cuBLAS picks other GEMM tilings for other
# row counts), differ by bf16 rounding at other places; 0.05 was measured on
# an H100, the tolerance is twice that. Greedy paths must agree on every
# frame whose top-2 logit margin exceeds twice the tolerance.
TOL_LOGITS = 0.1
MIN_SURE = 0.01  # share of frames that must clear that margin
# attention backward, elementwise, kernel vs plain on the same bf16 inputs.
# Both round q*scale, p (for dv) and ds (for dq, dk) to bf16 at the same
# points and the outputs once; float32 differences (exp2 of the stored lse
# vs exp/sum, summation order) can move a rounded p or ds by one ulp (2^-8
# relative). So with the magnitude terms m_dv = p^T |g|, m_dq = s |d| |k|,
# m_dk = |d|^T |q s|, m_dbias = sum_b |d|, |d| = p (|dp| + |delta|):
#   |kernel - plain| <= 2^-7 (|plain| + m)
ATTN_BWD_TOL = 2.0 ** -7
# Toeplitz reduce: float32 sums of up to T terms in another order (the
# kernel adds row-chunk partials with atomics): |err| <= T u sum|g|
# CTC: float32 log-space recursions over 750 frames in another order
TOL_CTC_LL = 1e-5      # |d ll| <= TOL (1 + |ll|)
# the gradient wrt a lattice log-prob is g exp(gamma), an occupancy, with
# gamma = alpha + beta - lp - ll a sum of log-domain values of magnitude up
# to |ll|, each carrying float32 rounding of |ll| 2^-24; with 64 such
# roundings, d(g e^gamma) = g e^gamma d gamma bounds each element:
#   |d grad| <= TOL_CTC_GRAD (1 + |ll|) |grad| + CTC_ABS |g|
# (the absolute term, 2^-24, is for occupancies that underflow on one side)
TOL_CTC_GRAD = 2.0 ** -18
CTC_ABS = 2.0 ** -24
# the training step, kernel model vs plain model on the card (bf16, 12
# layers, same weights, same mask, dropout 0). Measured on an H100 over
# twelve draws of the batch, mask and bias table (`--train-seeds 0,...,5`,
# [8] and [13]): loss <= 1.23e-4 relative, every gradient's relative error
# <= 0.053 and cosine >= 0.99860. The lowest are the attention query and
# key weights (decoder block 0's cross-attention, encoder block 11), whose
# gradients pass through the softmax's p (dp - delta), a difference of
# near-equal terms that magnifies the bf16 noise upstream. The tolerances
# are about 2x (4x the loss); where the norms agree 1 - cosine = rel^2 /
# 2, so the cosine's is the relative error's, 1 - 0.1^2 / 2. The control
# (relative bias zeroed) measured 2.3e-3, 0.26 and 1.8.
TOL_TRAIN_LOSS = 5e-4  # relative
TRAIN_MIN_COS = 0.995  # every parameter's gradient, cosine to plain's
TRAIN_MAX_REL = 0.1    # and relative error ||g_k - g_p|| / ||g_p||
U_TOKENS = 64          # tokens per row, as the JAX package's benchmarks.py
TRAIN_WINDOWS, TRAIN_ITERS = 5, 2
# long audio ([3h], [9], [10]): rows padded to 2^20 samples, T' = 1,638
LONG_SAMPLES, LONG_B, LONG_MIN_S = 2 ** 20, 16, 17
U_LONG = 128           # tokens per row of the long train step
# the flash kernels against their plain versions: out, dq, dk and dv use
# the bounds of the dense kernels (ATTN_RTOL/ATTN_VTOL forward,
# ATTN_BWD_TOL backward): both keep the bias in float32 and round q * scale,
# p (e in the kernel) and ds to bf16 at the same points.
# ddiag is float32 on both sides and never rounded to bf16: both sum the
# same float32 ds = p (dp - delta) along each diagonal, in other orders.
# Per element ds differs by float32 roundings of p (exp2 of the stored lse
# vs exp / sum), dp and delta: <= 2^-14 of its magnitude p (|dp| + |delta|)
# (16x over a 2^-18 error of p at an exponent argument of 64). Each sum adds
# at most (n - 1) 2^-24 of its terms' magnitude, with n the adds in
# sequence: in the kernel 64 in-block adds and one global atomic per (batch
# row, 64-query block), in the plain version the B-row sum and one atomic
# per query row. With m the per-diagonal sum of the magnitudes:
#   |kernel - plain| <= flash_ddiag_tol(B, T) (|plain| + m)
# A central diagonal sums N ~ B T terms of random sign, so |ddiag| grows
# like sqrt(N) and m like N: the bound must stay far below 2^-7, which is
# about |ddiag| itself at B=16 x T' 1,638.
def flash_ddiag_tol(B: int, T: int) -> float:
    return 2.0 ** -14 + (64 + B * -(-T // 64) + B + T) * 2.0 ** -24


# the LSTM recurrence kernels against their plain versions ([3i]): both
# float32 (no TF32) on the same inputs, so they differ only in the order of
# float32 sums (the H-term gate dot products, dgates @ W_hh^T over 4H, dW_hh
# over B x T steps) and in expf/tanhf against torch's, carried through the
# recurrence. Elementwise, with m the tensor's largest |plain| for h, c and
# dxg, and for dW_hh the magnitude sum_t |h_prev|^T |dgates|:
#   |kernel - plain| <= LSTM_TOL (|plain| + m)
LSTM_TOL = 2.0 ** -16
# (tag, B, T, D, H): layer 0 of an4_ctc (8 s rows) and of wsj_las (16 s
# rows after the VGG front)
LSTM_SHAPES = (("an4_ctc layer 0", 32, 800, 80, 256),
               ("wsj_las layer 0", 32, 400, 2560, 320))
# the LSTM rungs' models, kernels vs plain torch on the card ([11], [12]):
# the plain `lstm_scan` rounds h and W_hh to bf16 for the recurrent product,
# the kernels keep it float32 (as the JAX package's xla and pallas paths
# differ), so these tolerances come from a measured spread. Measured on an
# H100: an4_ctc max |dlogit| 0.0010 (logit std 0.133), tolerance 2.5x;
# wsj_las loss 6.6e-7 relative, every gradient's cosine >= 0.99605 and
# relative error <= 0.0888: the loss tolerance is 15x, the gradients' 2x
# (the cosine's gap to 1). The controls (layer 0's W_hh zeroed) measured
# 0.2589, and 3.7e-4, 0.718 and 0.88.
TOL_AN4_LOGITS = 0.0025
TOL_LAS_LOSS = 1e-5    # relative
LAS_MIN_COS = 0.992    # every parameter's gradient, cosine to plain's
LAS_MAX_REL = 0.18     # and relative error
AN4_SECONDS, LAS_SECONDS = 8, 16
U_LAS = 200            # padded tokens per row of the wsj_las step
# the fused FFN kernels against their plain versions ([3j]): both round y,
# a, g2 and gh1 to bf16 at the same points and sum in float32 in other
# orders, so a rounded operand can differ by one bf16 ulp (2^-7 of it)
# where the float32 values straddle a rounding boundary, and its
# propagation from the previous product by less than another. With m the
# magnitude of the product or sum that yields each output, computed from
# the plain version's absolute values (`ffn_magnitudes`):
#   |kernel - plain| <= FFN_TOL (|plain| + m),  FFN_TOL = 2 x 2^-7
# for out and dx. dgamma, dbeta, dW1, db1, dW2 and db2 are sums over the R
# rows of terms t_r whose errors e_r, by the same rule, are bounded by
# FFN_TOL c_r (c_r the magnitude of row r's term), independent between
# rows and of either sign. The sum of the c_r grows as R while the output
# grows as sqrt(R) (the cotangent's signs are random): as m it would pass
# a kernel that drops a tenth of the rows or returns dgamma = 0. Hoeffding's
# inequality gives P(|sum e_r| > k FFN_TOL sqrt(sum c_r^2)) <=
# 2 exp(-k^2 / 2), 5e-11 per element at k = FFN_SUM_K = 7, so for these
#   m = FFN_SUM_K sqrt(sum_r c_r^2)
FFN_TOL = 2.0 ** -6
FFN_SUM_K = 7.0
# (tag, R, D, F): the flagship's and rung 3's rows (B=32 x T' 750) and a
# ragged count (a partial last row tile), and rung 4's width
FFN_SHAPES = (("flagship, R = 32 x 750", 24000, 256, 1024),
              ("ragged R", 23977, 256, 1024),
              ("rung 4's width", 11999, 512, 2048))
U_RUNG3, V_RUNG3 = 128, 256  # rung 3's tokens per row and BPE vocabulary
U_RUNG4, V_RUNG4 = 128, 1024  # rung 4's (its bpe1024 tokenizer path)
# the prefix kernels against their plain versions ([15]): both run the same
# float32 operations in the same order, so they differ only where CUDA's
# expf/log1pf and torch's exp/log1p round differently (each within 2 ulp):
# a log_add then moves by a few ulp of its result, and over T' frames the
# carried columns by at most a few ulp a step, relative:
#   |kernel - plain| <= PREFIX_STEP_TOL T' (1 + |plain|)
PREFIX_STEP_TOL = 2.0 ** -22
# [3g]: (tag, B, T', vocab, U) of the CTC lattice (S = 2U + 1) of every
# training path beside the flagship's: rung 3, long audio, the an4_ctc
# CTC-only step ([12]: 8 s rows, U_LAS padded tokens) and wsj_las after its
# 32x reduction
CTC_SHAPES = (("rung 3", 32, 750, V_RUNG3, U_RUNG3),
              ("long audio", LONG_B, 1638, 64, U_LONG),
              ("an4_ctc", 32, 798, 32, U_LAS),
              ("wsj_las", 32, 50, 32, U_LAS))


# kernel-name patterns for the profile summary, first match wins
PROFILE_GROUPS = (
    ("ffn", ("ffn_",)),
    ("lstm", ("lstm_",)),
    # the attention kernels in kDiag mode
    ("flash", ("attention_fwd_kernel<2>", "attn_bwd_delta_kernel<2>",
               "attn_bwd_main_kernel<2>", "attn_bwd_dq_sum_kernel<2>",
               "ddiag_sum")),
    ("logmel", ("logmel_",)),
    ("toeplitz", ("toeplitz_",)),
    ("attention_bwd", ("attn_bwd_",)),
    ("attention", ("attention_fwd_kernel",)),
    ("ctc", ("ctc_",)),
    ("optimizer", ("foreach", "multi_tensor")),
    ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "sm90_")),
    ("conv", ("conv", "cudnn", "implicit")),
    ("layer_norm", ("layer_norm", "layernorm", "gammabeta")),
    ("memcpy", ("memcpy",)),
    ("reduce", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn over `iters` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def turns_ms(fns: dict, windows: int = 5, iters: int = 50,
             warmup: int = 3) -> dict:
    """Median device time of each fn, measured in turns: each of `windows`
    windows times the fns in order and then in reverse (kernel, library,
    library, kernel), `iters` launches per timing (CUDA events); the median
    is taken over the 2 x windows means of each fn."""
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    samples = {name: [] for name in fns}
    order = list(fns) + list(fns)[::-1]
    for _ in range(windows):
        for name in order:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fns[name]()
            end.record()
            end.synchronize()
            samples[name].append(start.elapsed_time(end) / iters)
    return {name: statistics.median(v) for name, v in samples.items()}


def bits_differ(a, b) -> int:
    """Elements of the tensors in `a` whose bits differ from `b`'s."""
    n = 0
    for x, y in zip(a, b):
        if x is None:
            continue
        dt = torch.int16 if x.element_size() == 2 else torch.int32
        n += int((x.view(dt) != y.view(dt)).sum())
    return n


def kernel_split(fn, iters: int = 10) -> dict:
    """{kernel name: device ms per call of fn} for the kernels fn launches
    (`profile_step` over `iters` calls), names cut to the kernel's own."""
    _, kernel_ms, _ = profile_step(fn, iters)
    out = {}
    for key, t in kernel_ms.items():
        m = re.search(r"(\w+_kernel)(<\d+>)?", key)
        name = (m.group(1) + (m.group(2) or "")) if m else key[:40]
        out[name] = out.get(name, 0.0) + t
    return out


def print_split(tag: str, split: dict, card: str) -> None:
    print(f"{tag}, device ms per launch by kernel: "
          + ", ".join(f"{k} {v:.4f}" for k, v in sorted(
              split.items(), key=lambda kv: -kv[1]))
          + f" (sum {sum(split.values()):.4f}); {card}", flush=True)


def print_turns(tag: str, turns: dict, flops: float, bound_ms: float,
                card: str, windows: int = 5, iters: int = 50) -> None:
    """One line for a kernel timed in turns (`turns_ms` with `windows` and
    `iters`) against its library yardstick: both medians, the kernel's
    TFLOP/s and bound / kernel, and whether the kernel is at or below the
    yardstick."""
    k, lib = turns["kernel"], turns["library"]
    print(f"{tag}: kernel {k:.4f} ms, library {lib:.4f} ms (medians of "
          f"{windows} windows x {iters} launches in turns), "
          f"{flops / k / 1e9:.1f} "
          f"TFLOP/s, bound / kernel {bound_ms / k:.3f}, kernel "
          f"{'at or below' if k <= lib else 'ABOVE'} the library; {card}",
          flush=True)


def bound(n_bytes: float, op_seconds: float, peaks: dict) -> tuple[float, str]:
    """(least time in ms, 'bytes' or 'operations'): the larger of the bytes
    over the memory rate and the operations over their peak rate (the
    slowest unit's, where several run concurrently)."""
    t_bytes = n_bytes / peaks["hbm_bytes_per_s"]
    if op_seconds > t_bytes:
        return op_seconds * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def speechlike(n_rows: int, n_samples: int, gen, dev) -> torch.Tensor:
    """Non-stationary test audio: 0.1 s segments, each a tone of its own
    pitch and level plus noise of its own level, so log-mel frames differ
    from one another as speech frames do. Stationary noise gives nearly
    equal frames, and nearly equal logits, behind which a wrong kernel hides.
    """
    seg = SR // 10
    n_seg = -(-n_samples // seg)
    u = lambda: torch.rand(n_rows, n_seg, 1, device=dev, generator=gen)
    pitch, tone, noise = 100 + 3900 * u(), 10 ** (2 * u() - 2), 10 ** (2 * u() - 3)
    t = torch.arange(seg, device=dev) / SR
    x = tone * torch.sin(2 * math.pi * pitch * t) + noise * torch.randn(
        n_rows, n_seg, seg, device=dev, generator=gen)
    return 0.3 * x.reshape(n_rows, -1)[:, :n_samples].contiguous()


def tokenizer_of(V: int):
    """A character tokenizer of V ids: the Solver takes its vocabulary from
    a tokenizer."""
    from pytorch_end2end_speech_recognition_tpu_torch.data.tokenizer import (
        N_SPECIAL,
        CharTokenizer,
    )

    return CharTokenizer(charset="".join(
        chr(0x100 + i) for i in range(V - N_SPECIAL - 1)))


def make_solver(cfg, V: int, dev):
    """A Solver for `cfg` with a vocabulary of V ids, writing no metrics
    file."""
    from pytorch_end2end_speech_recognition_tpu_torch.training.solver import (
        Solver,
    )

    cfg.train.metrics_path = ""
    return Solver(cfg, tokenizer_of(V), device=dev)


class OneBatch:
    """A loader for `Solver.fit` that yields one fixed batch at every
    cursor."""

    def __init__(self, batch):
        self.batch = batch

    def repeat(self, epoch: int = 0, batch: int = 0, with_cursor=False):
        while True:
            yield (epoch, batch, self.batch) if with_cursor else self.batch
            batch += 1


def n_frames_of(n: int) -> int:
    return max(0, (n - WIN) // HOP + 1)


def grid_len(n: int, batch_frames: int) -> int:
    """The fewest samples >= n whose frame count is >= n's and has
    `batch_frames`' residue mod 4. Both stride-2 'SAME' subsampling
    convolutions pad by the parity of their input (as the JAX package's
    do), so a request answered alone sees the frame grid it sees in a
    padded batch only then."""
    f = n_frames_of(n)
    while f % 4 != batch_frames % 4:
        f += 1
    return max(n, WIN + HOP * (f - 1))


def heads_of(x: torch.Tensor, H: int) -> torch.Tensor:
    B, T, D = x.shape
    return x.reshape(B, T, H, D // H).transpose(1, 2).float()


def attn_bwd_magnitudes(q, k, v, bias, lens, g, H):
    """The magnitude terms of the attention backward's rounding bound (see
    ATTN_BWD_TOL), in float32: (m_dq, m_dk, m_dv, m_dbias)."""
    B, T, D = q.shape
    scale = (D // H) ** -0.5
    qs = (heads_of(q, H) * scale).to(q.dtype).float()
    kh, vh, gh = heads_of(k, H), heads_of(v, H), heads_of(g, H)
    sc = qs @ kh.transpose(-1, -2)
    if bias is not None:
        sc = sc + bias[None, :, :T, :T].float()
    key_ok = torch.arange(T, device=q.device)[None, :] < lens[:, None]
    sc = torch.where(key_ok[:, None, None, :], sc,
                     torch.full((), -1e30, device=q.device))
    e = torch.exp(sc - sc.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True).clamp_min(1e-30)
    del sc, e
    dp = gh @ vh.transpose(-1, -2)
    mag = p * (dp.abs() + (dp * p).sum(-1, keepdim=True).abs())
    del dp
    merge = lambda x: x.transpose(1, 2).reshape(B, T, D)
    m_dv = merge(p.transpose(-1, -2) @ gh.abs())
    m_dq = merge(mag @ kh.abs()) * scale
    m_dk = merge(mag.transpose(-1, -2) @ qs.abs())
    m_db = None
    if bias is not None:
        P = bias.shape[-1]
        m_db = torch.nn.functional.pad(mag.sum(0), (0, P - T, 0, P - T))
    return m_dq, m_dk, m_dv, m_db


def grad_table(got: dict, want: dict) -> list[tuple[float, float, str]]:
    """(cosine, relative error, name) of two name -> gradient dicts, lowest
    cosine first, over the parameters whose plain gradient norm exceeds
    1e-3 of the median norm (the key projections' biases have zero gradient
    in exact arithmetic and carry only rounding noise)."""
    norms = {k: float(w.float().norm()) for k, w in want.items()}
    floor = 1e-3 * statistics.median(norms.values())
    rows = []
    for k, w in want.items():
        if norms[k] <= floor:
            continue
        a, b = got[k].float().flatten(), w.float().flatten()
        rows.append((float(torch.dot(a, b) / (a.norm() * b.norm())),
                     float((a - b).norm() / b.norm()), k))
    return sorted(rows)


def grad_stats(got: dict, want: dict) -> tuple[float, float, float, int]:
    """(min cosine, max relative error, median cosine, parameters compared)
    of `grad_table`."""
    rows = grad_table(got, want)
    return (rows[0][0], max(r[1] for r in rows),
            statistics.median(r[0] for r in rows), len(rows))


def profile_step(fn, iters: int):
    """torch.profiler over `iters` calls of fn after one warm call:
    (wall ms per call, {kernel: device ms per call}, launches per call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    kernel_ms, n_launch = {}, 0
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            t = getattr(ev, "self_device_time_total", None)
            if t is None:
                t = ev.self_cuda_time_total
            kernel_ms[ev.key] = t / 1e3 / iters
            n_launch += ev.count
    return wall_ms, kernel_ms, n_launch / iters


def print_profile(tag: str, wall_ms: float, kernel_ms: dict, n: float,
                  card: str) -> None:
    busy = sum(kernel_ms.values())
    groups = {}
    for key, t in kernel_ms.items():
        low = key.lower()
        grp = next((g for g, pats in PROFILE_GROUPS
                    if any(p in low for p in pats)), "other")
        groups[grp] = groups.get(grp, 0.0) + t
    print(f"{tag}: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms (idle "
          f"share {1 - busy / wall_ms:.3f}), {n:.0f} device kernels; {card}")
    for grp, t in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"    {grp:13s} {t:8.3f} ms  {100 * t / max(busy, 1e-9):5.1f}%")
    for key, t in sorted(kernel_ms.items(), key=lambda kv: -kv[1])[:12]:
        print(f"    {t:8.3f} ms  {key[:110]}")


def compare(tag, got, want, lens, need_sure=False, tol=TOL_LOGITS):
    """Hold logits `got` to `want` (both (B, T, V) float32) on the frames
    t < lens[b]: max |d| <= tol, and the argmax equal on every frame whose
    top-2 margin in `want` exceeds 2 * tol. Returns max |d|."""
    valid = (torch.arange(want.shape[1], device=want.device)[None, :]
             < lens[:, None])
    err = (got - want).abs().amax(-1)[valid].max().item()
    top2 = want.topk(2, dim=-1).values
    sure = valid & ((top2[..., 0] - top2[..., 1]) > 2 * tol)
    agree = got.argmax(-1) == want.argmax(-1)
    print(f"{tag}: max |dlogit| {err:.4f} (tol {tol}, logit "
          f"std {want[valid].std().item():.3f}); argmax equal on "
          f"{float(agree[valid].float().mean()):.4f} of valid frames, on "
          f"{int(agree[sure].sum())}/{int(sure.sum())} frames with margin "
          f"> {2 * tol} of {int(valid.sum())}", flush=True)
    check(err <= tol, f"{tag}: logits differ by {err}")
    check(bool(agree[sure].all()), f"{tag}: argmax differs on a clear frame")
    if need_sure:
        share = float(sure.sum()) / float(valid.sum())
        check(share >= MIN_SURE, f"{tag}: only {share:.4f} of frames "
              "have a clear margin to compare")
    return err


def lstm_excess(got, want, mag) -> tuple[float, float, float]:
    """(max |got - want|, share of elements beyond LSTM_TOL (|want| + mag),
    largest ratio to that bound)."""
    lim = (LSTM_TOL * (want.abs() + mag)).clamp_min(1e-30)
    d = (got - want).abs()
    return d.max().item(), (d > lim).float().mean().item(), \
        (d / lim).max().item()


def ctc_case(Bc, Tc, Vc, Uc, gen, dev):
    """(logits (B, T, V), frame lens, labels (B, U) without repeats, label
    lens), ragged as the flagship's [3g] batch: even rows full, odd rows of
    T/30 to T frames, at most half a row's frames in labels, the last row a
    pad row (no labels)."""
    tlen = torch.full((Bc,), Tc, dtype=torch.int64, device=dev)
    tlen[1::2] = torch.randint(max(1, Tc // 30), Tc + 1, (Bc // 2,),
                               device=dev, generator=gen)
    logits = torch.randn(Bc, Tc, Vc, device=dev, generator=gen)
    steps = torch.randint(1, Vc - 1, (Bc, Uc), device=dev, generator=gen)
    labels = 1 + torch.cumsum(steps, 1) % (Vc - 1)
    lens = torch.minimum(
        torch.randint(1, Uc + 1, (Bc,), device=dev, generator=gen), tlen // 2)
    lens[Bc - 1] = 0
    labels = labels * (torch.arange(Uc, device=dev)[None, :] < lens[:, None])
    return logits, tlen, labels, lens


def ctc_check(tag, logits, tlen, labels, lens, g_ll, peaks, card,
              plain: bool) -> tuple[dict, dict]:
    """[3g] at one lattice: the CTC kernels (on the lattice as the main path
    builds it, S padded to STATE_ALIGN) against their plain versions (ll and
    alpha to TOL_CTC_LL, every gradient element to its bound), two launches
    bit for bit, controls that must fail (beta without skip transitions or
    with lengths one frame short; alpha without skip transitions), the
    loss and logit gradient against F.ctc_loss; then each kernel in turns
    with its F.ctc_loss yardstick (forward; forward + backward), its bound
    at the unpadded S and its time per dependent step, and with `plain` the
    plain versions' times. Returns the kernels' rows."""
    from pytorch_end2end_speech_recognition_tpu_torch.ops.ctc import (
        ctc_loss,
        lattice_inputs,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops.ctc_kernel import (
        STATE_ALIGN,
        ctc_alpha,
        ctc_alpha_plain,
        ctc_beta,
        ctc_beta_plain,
    )

    F = torch.nn.functional
    Bc, Tc, _ = logits.shape
    S = 2 * labels.shape[1] + 1
    lat, skip, sok = lattice_inputs(logits, labels, lens, pad_to=STATE_ALIGN)
    last = 2 * lens
    alpha, ll = ctc_alpha(lat, skip, sok, tlen, last)
    a_ref, ll_ref = ctc_alpha_plain(lat, skip, sok, tlen, last)
    cgrad = ctc_beta(lat, skip, sok, tlen, last, alpha, ll, g_ll)
    cgrad_ref = ctc_beta_plain(lat, skip, sok, tlen, last, a_ref, ll_ref,
                               g_ll)
    torch.cuda.synchronize()
    d_ll = (ll - ll_ref).abs()
    fin = a_ref > -1e29
    d_alpha = (alpha - a_ref).abs()[fin]
    d_grad = (cgrad - cgrad_ref).abs()

    def ctc_grad_excess(got, want, mag, ll_row, g_row):
        """(share of elements beyond TOL_CTC_GRAD (1 + |ll|) mag + CTC_ABS
        |g|, largest ratio of |got - want| to that bound)."""
        tol = (TOL_CTC_GRAD * (1 + ll_row.abs())[:, None, None] * mag
               + CTC_ABS * g_row.abs()[:, None, None])
        d = (got - want).abs()
        ratio = torch.where(d > 0, d / tol, torch.zeros_like(d))
        return (d > tol).float().mean().item(), ratio.max().item()

    check(bool((ll_ref > -1e29).all()), f"ctc {tag}: a row no path can "
          "explain")
    share, worst = ctc_grad_excess(cgrad, cgrad_ref, cgrad_ref.abs(), ll_ref,
                                   g_ll)
    print(f"[3] ctc {tag}, lattice {tuple(lat.shape)} (S {S}): alpha: max "
          f"|d ll| {d_ll.max().item():.3e}, max |d alpha| on reachable "
          f"states {d_alpha.max().item():.3e}; beta: max |d grad| "
          f"{d_grad.max().item():.3e}, share beyond the elementwise bound "
          f"{share:.3e} (largest ratio to it {worst:.3e})", flush=True)
    check(torch.equal(fin, alpha > -1e29),
          f"ctc alpha {tag}: reachable states differ")
    check(bool((d_ll <= TOL_CTC_LL * (1 + ll_ref.abs())).all())
          and bool((d_alpha <= TOL_CTC_LL * (1 + a_ref.abs()[fin])).all()),
          f"ctc alpha {tag} disagrees with its plain version")
    check(share == 0.0, f"ctc beta {tag} disagrees with its plain version")
    alpha2, ll2 = ctc_alpha(lat, skip, sok, tlen, last)
    n_diff = bits_differ((alpha2, ll2, ctc_beta(lat, skip, sok, tlen, last,
                                                alpha, ll, g_ll)),
                         (alpha, ll, cgrad))
    print(f"[3] ctc {tag} determinism: a second launch of each differs in "
          f"{n_diff} elements (must be 0)", flush=True)
    check(n_diff == 0, f"ctc {tag} kernels are not deterministic")
    del alpha2, ll2
    # controls: a beta kernel without skip transitions (labels without
    # repeats use them), or one that starts a frame early, must fail
    for ctl_tag, sk, tl in (("skip transitions disabled",
                             torch.zeros_like(skip), tlen),
                            ("lengths one frame short", skip, tlen - 1)):
        bad = ctc_beta(lat, sk, sok, tl, last, alpha, ll, g_ll)
        share_c, _ = ctc_grad_excess(bad, cgrad_ref, cgrad_ref.abs(), ll_ref,
                                     g_ll)
        print(f"[3] ctc {tag} beta control, {ctl_tag}: share beyond the "
              f"bound {share_c:.3e} (must be > 0)", flush=True)
        check(share_c > 0.0, f"ctc {tag} beta control '{ctl_tag}' passed "
              "the check")
        del bad
    # against torch's CTC, forward and backward, rows with labels; the
    # gradient wrt a logit is p_v - occ_v (g = 1), each element held to the
    # bound above with mag = p_v + occ_v
    rows = lens > 0
    x = logits.clone().requires_grad_()
    loss_k = ctc_loss(x, tlen, labels, lens, impl="cuda")
    (loss_k * rows).sum().backward()
    y = logits.clone().requires_grad_()
    loss_t = F.ctc_loss(F.log_softmax(y, -1).transpose(0, 1), labels, tlen,
                        lens, reduction="none", zero_infinity=True)
    (loss_t * rows).sum().backward()
    d_loss = (loss_k - loss_t).abs()[rows]
    p_v = torch.softmax(logits, -1)
    share, worst = ctc_grad_excess(x.grad, y.grad, p_v + (p_v - y.grad).abs(),
                                   loss_t.detach(), rows.float())
    print(f"[3] ctc {tag} kernels vs F.ctc_loss: max |d loss| "
          f"{d_loss.max().item():.3e} (loss up to "
          f"{loss_t[rows].max().item():.1f}), max |d grad| "
          f"{(x.grad - y.grad).abs().max().item():.3e}, share beyond the "
          f"elementwise bound {share:.3e} (largest ratio to it {worst:.3e})",
          flush=True)
    check(bool((d_loss <= TOL_CTC_LL * (1 + loss_t[rows].abs())).all())
          and share == 0.0, f"ctc {tag} kernels disagree with F.ctc_loss")
    del p_v, x, y
    # control: without skip transitions the same labels (no repeats) must
    # give another likelihood
    _, ll_ctl = ctc_alpha(lat, torch.zeros_like(skip), sok, tlen, last)
    ctl = ((ll_ctl - ll_ref).abs() > TOL_CTC_LL * (1 + ll_ref.abs()))[rows]
    print(f"[3] ctc {tag} control, skip transitions disabled: "
          f"{int(ctl.sum())}/{int(rows.sum())} rows beyond the tolerance "
          "(must be > 0)", flush=True)
    check(bool(ctl.any()), f"ctc {tag} control (no skips) passed the check")

    lp_t = F.log_softmax(logits, -1).transpose(0, 1).detach().requires_grad_()

    def torch_ctc():
        return F.ctc_loss(lp_t, labels, tlen, lens, reduction="none",
                          zero_infinity=True)

    ta = turns_ms({"kernel": lambda: ctc_alpha(lat, skip, sok, tlen, last),
                   "library": torch_ctc}, iters=20)
    tb = turns_ms({"kernel": lambda: ctc_beta(lat, skip, sok, tlen, last,
                                              alpha, ll, g_ll),
                   "library": lambda: torch.autograd.grad(torch_ctc().sum(),
                                                          lp_t)}, iters=20)
    # each input read once and each output written once, at the function's
    # own S (the kernels' padding is layout); ~10 and 12 float32 operations
    # a lattice cell
    cells, flags, row = Bc * Tc * S, 2 * Bc * S, 4 * Bc
    steps = int(tlen.max())
    out = []
    for name, t, n_lat, n_row, ops, ref in (
            ("alpha", ta, 2, 3, 10.0,
             lambda: ctc_alpha_plain(lat, skip, sok, tlen, last)),
            ("beta", tb, 3, 4, 12.0,
             lambda: ctc_beta_plain(lat, skip, sok, tlen, last, alpha, ll,
                                    g_ll))):
        b_ms, b_by = bound(4 * n_lat * cells + flags + n_row * row,
                           ops * cells / peaks["fp32_flops"], peaks)
        p_ms = cuda_ms(ref, iters=3, warmup=1) if plain else None
        # the kernel's device time alone, without the host's share of the
        # wrapper (which sets the pace of short lattices)
        split = kernel_split(lambda: ctc_alpha(lat, skip, sok, tlen, last)
                             if name == "alpha" else
                             ctc_beta(lat, skip, sok, tlen, last, alpha, ll,
                                      g_ll))
        print_split(f"[3] ctc_{name} {tag} (torch.profiler)", split, card)
        print(f"[3] ctc_{name} {tag} (B={Bc}, T'={Tc}, S={S}): kernel "
              f"{t['kernel']:.4f} ms ({t['kernel'] * 1e3 / steps:.4f} us per "
              f"dependent step over {steps} frames), F.ctc_loss "
              f"{'forward' if name == 'alpha' else 'forward + backward'} "
              f"{t['library']:.4f} ms (medians of 5 windows x 20 launches in "
              f"turns), bound {b_ms:.4f} ms ({b_by})"
              + (f", plain {p_ms:.1f} ms" if plain else "")
              + f"; kernel {'below' if t['kernel'] < t['library'] else 'ABOVE'}"
              f" the library; {card}", flush=True)
        out.append(dict(
            name=f"ctc_{name}", route="cuda", source=f"{PKG}/csrc/ctc.cu",
            replaces="pytorch_end2end_speech_recognition_tpu/ops/ctc_pallas.py:"
                     + ("160" if name == "alpha" else "211"),
            max_abs_err=(d_ll if name == "alpha" else d_grad).max().item(),
            ms=t["kernel"], plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=t["library"]))
    return tuple(out)


def lstm_kernel_phase(dev, gen, peaks, card, kernels) -> None:
    """[3i] the LSTM recurrence kernels (TPU kernels 11 and 12), both
    directions of a layer in one launch, against their plain versions at
    layer 0 of both rungs, ragged lengths with a zero-length row; four
    controls that must fail; two backward launches compared bit for bit;
    the cluster plan; times in turns against cuDNN's bidirectional LSTM
    beside the bound, and the time per dependent step. The forward
    direction's draws come from `gen` as they did when each direction had
    its own launch (the later phases draw what they drew before); the
    reverse direction's from a generator of its own."""
    import torch.nn.functional as F

    from pytorch_end2end_speech_recognition_tpu_torch.ops.rnn import (
        flip_sequences,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops.rnn_kernel import (
        lstm_bwd,
        lstm_bwd_plain,
        lstm_fwd,
        lstm_fwd_plain,
        lstm_plan,
    )

    def bwd_ref(xg, whh, lens, h, c, g):
        """(dxg, dW_hh) of the plain version and dW_hh's magnitude term."""
        dxg, dw = lstm_bwd_plain(xg, whh, lens, h, c, g)
        H = h.shape[-1]
        hprev = F.pad(h, (0, 0, 1, 0))[..., :h.shape[-2], :]
        m_dw = (hprev.abs().reshape(2, -1, H).transpose(1, 2)
                @ dxg.abs().reshape(2, -1, 4 * H))
        return dxg, dw, m_dw

    own = torch.Generator(device=dev).manual_seed(11)
    err_f = err_b = 0.0
    for si, (tag, BB, TT, DD, HH) in enumerate(LSTM_SHAPES):
        def u(*sh, a, g_=gen):
            return (torch.rand(*sh, device=dev, generator=g_) * 2 - 1) * a
        x = torch.randn(BB, TT, DD, device=dev, generator=gen)
        wih0, whh0 = u(DD, 4 * HH, a=DD ** -0.5), u(HH, 4 * HH, a=HH ** -0.5)
        b = torch.zeros(4 * HH, device=dev)
        b[HH:2 * HH] = 1.0
        lens = torch.randint(1, TT + 1, (BB,), device=dev, generator=gen)
        lens[0], lens[1] = TT, 0
        g0 = torch.randn(BB, TT, HH, device=dev, generator=gen)
        wih1 = u(DD, 4 * HH, a=DD ** -0.5, g_=own)
        whh1 = u(HH, 4 * HH, a=HH ** -0.5, g_=own)
        g = torch.stack([g0, torch.randn(BB, TT, HH, device=dev,
                                         generator=own)])
        wih, whh = torch.stack([wih0, wih1]), torch.stack([whh0, whh1])
        xg = torch.stack([x @ wih0 + b, flip_sequences(x, lens) @ wih1 + b])
        plans = {k: lstm_plan(k == "backward", 2, BB, HH)
                 for k in ("forward", "backward")}
        print(f"[3i] lstm {tag}: cluster plans (two directions, B={BB}, H "
              f"{HH}): " + "; ".join(
                  f"{k} {p['clusters']} clusters of {p['cluster']} blocks x "
                  f"{p['threads']} threads, {p['rows']} rows each, "
                  f"{p['smem_bytes']} B shared, the card holds "
                  f"{p['clusters_at_once']} at once"
                  for k, p in plans.items()), flush=True)
        h, c = lstm_fwd(xg, whh, lens)
        hp, cp = lstm_fwd_plain(xg, whh, lens)
        dx, dw = lstm_bwd(xg, whh, lens, hp, cp, g)
        dx2, dw2 = lstm_bwd(xg, whh, lens, hp, cp, g)
        dxp, dwp, m_dw = bwd_ref(xg, whh, lens, hp, cp, g)
        torch.cuda.synchronize()
        res = {"h": lstm_excess(h, hp, hp.abs().max()),
               "c": lstm_excess(c, cp, cp.abs().max()),
               "dxg": lstm_excess(dx, dxp, dxp.abs().max()),
               "dW_hh": lstm_excess(dw, dwp, m_dw)}
        err_f = max(err_f, res["h"][0], res["c"][0])
        err_b = max(err_b, res["dxg"][0], res["dW_hh"][0])
        differ = bits_differ((dx, dw), (dx2, dw2))
        print(f"[3i] lstm {tag} (B={BB}, T={TT}, D {DD}, H {HH}), both "
              "directions in one launch: " + "; ".join(
                  f"{k} max |kernel - plain| {e:.3e}, share beyond 2^-16 "
                  f"(|plain| + m) {sh:.3e}, ratio {r:.3e}"
                  for k, (e, sh, r) in res.items())
              + f"; two backward launches differ in {differ} elements",
              flush=True)
        check(all(r[1] == 0.0 for r in res.values())
              and bool(torch.all(h[:, 1] == 0))
              and bool(torch.all(dx[:, 1] == 0)),
              f"lstm kernels disagree ({tag}): {res}")
        check(differ == 0, f"lstm backward not repeatable ({tag})")
        # controls, each a kernel that misreads its inputs: the lengths
        # ignored, W_hh read transposed, the input and forget gates
        # swapped, the two directions' W_hh swapped
        full = torch.full_like(lens, TT)
        wt = whh.transpose(1, 2).contiguous().view(2, HH, 4 * HH)
        perm = torch.cat([torch.arange(HH, 2 * HH), torch.arange(HH),
                          torch.arange(2 * HH, 4 * HH)]).to(dev)
        xs, ws = xg[..., perm].contiguous(), whh[..., perm].contiguous()
        for ctag, args in (("lengths ignored", (xg, whh, full)),
                           ("W_hh transposed", (xg, wt, lens)),
                           ("input and forget gates swapped", (xs, ws, lens)),
                           ("the directions' W_hh swapped",
                            (xg, whh.flip(0).contiguous(), lens))):
            ch, cc = lstm_fwd(*args)
            cdx, cdw = lstm_bwd(*args, hp, cp, g)
            sh_f = max(lstm_excess(ch, hp, hp.abs().max())[1],
                       lstm_excess(cc, cp, cp.abs().max())[1])
            sh_b = max(lstm_excess(cdx, dxp, dxp.abs().max())[1],
                       lstm_excess(cdw, dwp, m_dw)[1])
            print(f"[3i] lstm control ({tag}), {ctag}: share beyond the "
                  f"bound h/c {sh_f:.3e}, dxg/dW_hh {sh_b:.3e} (both must "
                  "be > 0)", flush=True)
            check(sh_f > 0.0 and sh_b > 0.0,
                  f"lstm control '{ctag}' passed ({tag})")
        # times: the two-direction launches in turns with cuDNN's
        # bidirectional LSTM on packed sequences with the same weights (it
        # also does x @ W_ih; the zero-length row packed at length 1), the
        # plain versions, and the bound for this run's valid steps
        steps = float(lens.sum())
        ops = 2 * 2.0 * steps * HH * 4 * HH
        fb = bound(nbytes(xg, whh, lens, hp, cp),
                   ops / peaks["fp32_flops"], peaks)
        bb = bound(nbytes(xg, whh, lens, hp, cp, g, dxp, dwp),
                   3 * ops / peaks["fp32_flops"], peaks)
        lstm = torch.nn.LSTM(DD, HH, batch_first=True,
                             bidirectional=True).to(dev)
        with torch.no_grad():
            for sfx, d in (("l0", 0), ("l0_reverse", 1)):
                getattr(lstm, f"weight_ih_{sfx}").copy_(wih[d].T)
                getattr(lstm, f"weight_hh_{sfx}").copy_(whh[d].T)
                getattr(lstm, f"bias_ih_{sfx}").copy_(b)
                getattr(lstm, f"bias_hh_{sfx}").zero_()
        xq = x.clone().requires_grad_()
        packed = torch.nn.utils.rnn.pack_padded_sequence(
            xq, lens.clamp(min=1).cpu(), batch_first=True,
            enforce_sorted=False)
        out = torch.nn.utils.rnn.pad_packed_sequence(
            lstm(packed)[0], batch_first=True, total_length=TT)[0]
        valid = (torch.arange(TT, device=dev)[None, :]
                 < lens[:, None])[..., None]
        lib_err = max(((out[..., :HH] - h[0]) * valid).abs().max().item(),
                      ((out[..., HH:] - flip_sequences(h[1], lens))
                       * valid).abs().max().item())
        n_pk = lstm(packed)[0].data.shape[0]
        g_pk = torch.cat([torch.randn(n_pk, HH, device=dev, generator=gen),
                          torch.randn(n_pk, HH, device=dev, generator=own)],
                         -1)
        params = (packed.data, *lstm.parameters())

        def lib_fwd():
            with torch.no_grad():
                return lstm(packed)

        fwd_t = turns_ms({"kernel": lambda: lstm_fwd(xg, whh, lens),
                          "library": lib_fwd}, windows=3, iters=5)
        bwd_t = turns_ms({"kernel": lambda: lstm_bwd(xg, whh, lens, hp, cp,
                                                     g),
                          "library": lambda: torch.autograd.grad(
                              lstm(packed)[0].data, params, g_pk)},
                         windows=3, iters=5)
        row_f = dict(ms=fwd_t["kernel"], plain_ms=cuda_ms(
            lambda: lstm_fwd_plain(xg, whh, lens), iters=1, warmup=1),
            bound_ms=fb[0], bound_by=fb[1], library_ms=fwd_t["library"])
        row_b = dict(ms=bwd_t["kernel"], plain_ms=cuda_ms(
            lambda: lstm_bwd_plain(xg, whh, lens, hp, cp, g), iters=1,
            warmup=1), bound_ms=bb[0], bound_by=bb[1],
            library_ms=bwd_t["library"])
        for kname, row in (("forward", row_f), ("backward", row_b)):
            print(f"[3i] lstm {kname} {tag}, both directions: kernel "
                  f"{row['ms']:.4f} ms ({1e3 * row['ms'] / TT:.2f} us per "
                  f"dependent step, {TT} steps), cuDNN bidirectional "
                  f"{'fwd' if row is row_f else 'fwd + bwd'} "
                  f"{row['library_ms']:.4f} ms (medians of 3 windows x 5 "
                  f"launches in turns), plain {row['plain_ms']:.3f} ms, "
                  f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}); "
                  f"{card}", flush=True)
        print(f"[3i] cuDNN LSTM vs the kernel's h on valid steps, both "
              f"directions: max |diff| {lib_err:.3e} (cuDNN also computes x "
              "@ W_ih, which the kernel takes as xg)", flush=True)
        # the backward's launches: (a) the gate pre-pass, (b) the
        # recurrence, (c) dW_hh and its ordered sum
        _, kms, _ = profile_step(lambda: lstm_bwd(xg, whh, lens, hp, cp, g),
                                 3)
        parts = sorted(((re.search(r"lstm_\w+(<\w+>)?", k)[0], t)
                        for k, t in kms.items() if "lstm_" in k),
                       key=lambda kv: -kv[1])
        print(f"[3i] lstm backward {tag}, device ms per call by kernel: "
              + ", ".join(f"{k} {t:.4f}" for k, t in parts) + f"; {card}",
              flush=True)
        if si == 0:
            kernels["lstm_fwd"] = dict(
                name="lstm_fwd", route="cuda", source=f"{PKG}/csrc/lstm.cu",
                replaces="pytorch_end2end_speech_recognition_tpu/ops/"
                         "rnn_pallas.py:136", **row_f)
            kernels["lstm_bwd"] = dict(
                name="lstm_bwd", route="cuda", source=f"{PKG}/csrc/lstm.cu",
                replaces="pytorch_end2end_speech_recognition_tpu/ops/"
                         "rnn_pallas.py:193", **row_b)
        del lstm, packed, xq, out, g_pk, params
    kernels["lstm_fwd"]["max_abs_err"] = err_f
    kernels["lstm_bwd"]["max_abs_err"] = err_b


def logmel_library(audio, basis, basis_prev, mel_b, hop, n_frames, flens):
    """The log-mel as a sequence of library calls (the [3a] yardstick; no
    single PyTorch call computes it): frames by unfold, cast to bf16, a
    cuBLAS bf16 matmul with the (win, 2F) basis, the predecessor term,
    power, a float32 matmul with the filterbank, log, the frame mask."""
    win = basis.shape[0]
    fr = audio.unfold(1, win, hop)[:, :n_frames].to(torch.bfloat16)
    reim = (fr @ basis).float()
    prev = torch.nn.functional.pad(
        audio[:, hop - 1:(n_frames - 1) * hop:hop].to(torch.bfloat16).float(),
        (1, 0))
    reim = reim + prev[..., None] * basis_prev
    n = reim.shape[-1] // 2
    mel = (reim[..., :n].square() + reim[..., n:].square()) @ mel_b
    valid = torch.arange(n_frames, device=audio.device)[None, :] < flens[:, None]
    return torch.where(valid[..., None], torch.log(mel + 1e-10),
                       torch.zeros((), device=audio.device))


def logmel_kernel_phase(dev, front, audio, audio_lens, full_lens, n_frames,
                        peaks, card, kernels) -> None:
    """[3a] the log-mel kernels (TPU kernel 1) against their plain version
    on the main path's batch (B=32 x 30 s, ragged and full rows): the bf16
    wgmma kernel and the float32 one within TOL_LOGMEL; on the ragged batch
    the bf16 kernel's controls, each of which must exceed the tolerance (a
    nonzero basis_prev, which the Hann window's zero first sample leaves
    at 0 on the main path, held and then zeroed; the frames read one hop
    late; one band's last bin left out of its range), a random dense
    filterbank (every bin of every band nonzero) that must pass, and two
    launches compared bit for bit; on the full batch its time in turns with
    the library sequence (`logmel_library`), plain and bound times."""
    from pytorch_end2end_speech_recognition_tpu_torch.ops.frontend_kernel import (
        logmel,
        logmel_plain,
        mel_band_ranges,
        mel_plan,
    )

    gl = torch.Generator(device=dev).manual_seed(11)  # [3a]'s own draws
    plan = (front.mel_bands, front.mel_t)
    hop = front.hop
    for dt in (torch.bfloat16, torch.float32):
        basis = (front.basis if dt == front.basis.dtype
                 else front.basis.to(dt).contiguous())
        for tag, al in (("ragged", audio_lens), ("full", full_lens)):
            flens = front.frame_lens(al)
            args = (audio, basis, front.basis_prev, front.mel_b, hop,
                    n_frames, flens)
            out = logmel(*args, plan=plan)
            ref = logmel_plain(*args)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            print(f"[3a] logmel {str(dt)[6:]} {tag} lens: max |kernel - "
                  f"plain| = {err:.3e} (tol {TOL_LOGMEL})", flush=True)
            check(err <= TOL_LOGMEL and bool(torch.isfinite(out).all()),
                  f"logmel {dt} {tag} disagrees with its plain version ({err})")
            if dt != front.basis.dtype:
                continue
            kernels.setdefault("logmel", dict(name="logmel", max_abs_err=0.0))
            kernels["logmel"]["max_abs_err"] = max(
                err, kernels["logmel"]["max_abs_err"])
            if tag == "ragged":
                n_diff = bits_differ((out,), (logmel(*args, plan=plan),))
                print(f"[3a] logmel bf16, two launches: {n_diff} elements "
                      "differ in their bits", flush=True)
                check(n_diff == 0, f"logmel launches differ ({n_diff})")
                bp = 0.5 * torch.randn(front.basis_prev.shape, device=dev,
                                       generator=gl)
                late = torch.cat([audio[:, hop:], audio.new_zeros(
                    audio.shape[0], hop)], 1)
                # the band whose last bin weighs the most loses that bin
                bands, mel_t = plan
                M = front.mel_b.shape[1]
                _, hi = mel_band_ranges(front.mel_b)
                m_cut = int(front.mel_b[hi, torch.arange(M, device=dev)]
                            .argmax())
                cut = bands.clone()
                cut[2 + M + m_cut] -= 1
                dense = 0.01 + 0.1 * torch.rand(front.mel_b.shape, device=dev,
                                                generator=gl)
                want_bp = logmel_plain(audio, basis, bp, *args[3:])
                want_dense = logmel_plain(audio, basis, front.basis_prev,
                                          dense, *args[4:])
                for ctag, must_fail, got, want in (
                        ("a nonzero basis_prev", False,
                         logmel(audio, basis, bp, *args[3:], plan=plan),
                         want_bp),
                        ("control: that basis_prev zeroed", True,
                         logmel(audio, basis, torch.zeros_like(bp),
                                *args[3:], plan=plan), want_bp),
                        ("control: frames read one hop late", True,
                         logmel(late, *args[1:], plan=plan), ref),
                        (f"control: band {m_cut}'s last bin left out", True,
                         logmel(*args, plan=(cut, mel_t)), ref),
                        ("a random dense filterbank", False,
                         logmel(audio, basis, front.basis_prev, dense,
                                *args[4:], plan=mel_plan(dense)),
                         want_dense)):
                    e = (got - want).abs().max().item()
                    print(f"[3a] logmel bf16, {ctag}: max |kernel - plain| "
                          f"{e:.3e} ({'must exceed' if must_fail else 'within'}"
                          f" {TOL_LOGMEL})", flush=True)
                    check((e > TOL_LOGMEL) if must_fail else
                          (e <= TOL_LOGMEL), f"logmel {ctag}: {e}")
                del late, dense, want_bp, want_dense, got, want
                continue
            # the bound: the DFT of the bins the filterbank reads on the
            # tensor cores (bf16), the filterbank's nonzeros on the float32
            # CUDA cores, concurrently; the bytes of audio, operands, output
            win = basis.shape[0]
            n_valid = int(flens.sum())
            lo, hi = mel_band_ranges(front.mel_b)
            n_bins = int(hi.max()) - int(lo.min()) + 1
            dft = 2.0 * n_valid * win * 2 * n_bins
            mel_ops = 2.0 * n_valid * int((front.mel_b != 0).sum())
            b_ms, b_by = bound(
                nbytes(audio, basis, front.basis_prev, front.mel_b, flens, out),
                max(dft / peaks["bf16_flops"], mel_ops / peaks["fp32_flops"]),
                peaks)
            turns = turns_ms({
                "kernel": lambda: logmel(*args, plan=plan),
                "library": lambda: logmel_library(*args)}, iters=20)
            row = dict(route="cuda", source=f"{PKG}/csrc/logmel.cu",
                       replaces="pytorch_end2end_speech_recognition_tpu/ops/"
                                "frontend_pallas.py:138",
                       ms=turns["kernel"],
                       plain_ms=cuda_ms(lambda: logmel_plain(*args), iters=5),
                       bound_ms=b_ms, bound_by=b_by,
                       library_ms=turns["library"])
            kernels["logmel"].update(row)
            print_turns(f"[3a] logmel bf16 (B={audio.shape[0]} x "
                        f"{audio.shape[1] / SR:g} s, {n_frames} frames, the "
                        f"DFT of {n_bins} bins)", turns, dft, b_ms, card,
                        iters=20)
            print(f"[3a] logmel bf16: plain {row['plain_ms']:.4f} ms, bound "
                  f"{b_ms:.4f} ms ({b_by}); library = the sequence unfold, "
                  "bf16 cuBLAS matmul, predecessor term, power, float32 "
                  f"matmul, log, mask; {card}", flush=True)
        del out, ref


FFN_OUTPUTS = ("out", "dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")


def ffn_inputs(R, D, F, gen, dev):
    """x (R, D) bf16, gamma, beta (D,) float32, w1 (F, D), b1, w2 (D, F),
    b2 bf16 at the init's scale, and a cotangent g (R, D) bf16. The biases
    (std 0.5) and the LayerNorm scale (1 + 0.5 N) sit far from their init,
    so that the controls that drop them can fail."""
    r = lambda *s: torch.randn(*s, device=dev, generator=gen)  # noqa: E731
    bf = torch.bfloat16
    return (r(R, D).to(bf), 1.0 + 0.5 * r(D), 0.5 * r(D),
            (r(F, D) * D ** -0.5).to(bf), (0.5 * r(F)).to(bf),
            (r(D, F) * F ** -0.5).to(bf), (0.5 * r(D)).to(bf),
            r(R, D).to(bf))


def ffn_magnitudes(x, g, gamma, beta, w1, b1, w2, b2, seed, rate, scale):
    """The magnitude terms m of the FFN_TOL bound, float32, for the outputs
    FFN_OUTPUTS, from the absolute values of the operands, rounded where
    the kernels round them (y, a, g2, gh1 to bf16): for out, those of the
    product a W2^T and the sum that yields it; for dx, those of gy = gh1
    W1 (m_gy) through the LayerNorm backward. For the six sums over rows,
    FFN_SUM_K sqrt(sum c^2) over their terms' magnitudes c:
      dW1  |gh1| |y|    db1  |gh1|    dW2  |g2| |a|    db2  |g2|
    (db2 sums float32 g2, which both sides compute alike: a loose term);
    dgamma and dbeta sum gy = gh1 W1 over rows, so their independent
    terms are one per row and F column: |gh1| |W1| |xn| and |gh1| |W1|."""
    from pytorch_end2end_speech_recognition_tpu_torch.ops.ffn_kernel import (
        LN_EPS,
        keep_multiplier,
    )

    bf = torch.bfloat16
    R, D = x.shape
    xf = x.float()
    mean = xf.mean(1, keepdim=True)
    rstd = torch.rsqrt((xf - mean).square().mean(1, keepdim=True) + LN_EPS)
    xn = (xf - mean) * rstd
    y = (xn * gamma + beta).to(bf).float()
    W1, W2 = w1.float(), w2.float()
    h1 = y @ W1.t() + b1.float()
    sig = torch.sigmoid(h1)
    a = (h1 * sig).to(bf).float()
    h2 = a @ W2.t() + b2.float()
    keep = 1.0
    if rate > 0:
        keep = keep_multiplier(seed, torch.arange(R, device=x.device), D,
                               rate)
    m_out = scale * keep * (a.abs() @ W2.abs().t() + b2.float().abs()
                            + h2.abs())
    g2 = scale * g.float() * keep
    g2w = g2.to(bf).float()
    ga = g2w @ W2
    gh1 = (ga * (sig * (1.0 + h1 * (1.0 - sig)))).to(bf).float()
    del ga, sig, h1, h2
    m_gy = gh1.abs() @ W1.abs()
    gm = gamma.abs() * m_gy
    m_dx = rstd * (gm + gm.mean(1, keepdim=True) + xn.abs() * (
        gm * xn.abs()).mean(1, keepdim=True))
    del gm, m_gy
    q = gh1.square() @ W1.square()
    sums = ((q * xn.square()).sum(0), q.sum(0),
            gh1.square().t() @ y.square(), gh1.square().sum(0),
            g2w.square().t() @ a.square(), g2.square().sum(0))
    return (m_out, m_dx, *(FFN_SUM_K * s.sqrt() for s in sums))


def ffn_excess(got, want, mags):
    """Per output: (max |kernel - plain|, share of elements beyond FFN_TOL
    (|plain| + m), largest ratio to that bound)."""
    res = []
    for a, w, m in zip(got, want, mags):
        d = (a.float() - w.float()).abs()
        lim = (FFN_TOL * (w.float().abs() + m)).clamp_min(1e-30)
        res.append((d.max().item(), (d > lim).float().mean().item(),
                    (d / lim).max().item()))
    return res


def ffn_kernel_phase(dev, gen, peaks, card, kernels) -> None:
    """[3j] the fused FFN kernels (TPU kernels 13 and 14) against their
    plain versions on the card: the flagship's rows (R = 24,000, D 256, F
    1,024), a ragged R and rung 4's width (D 512, F 2,048), bf16 x and
    weights, scale 0.5, rates 0 and 0.1, every element of out and the
    seven gradients held to FFN_TOL; controls that must fail it; the
    dropout mask read from the kernels and held to the plain formula and
    its statistics; times beside the bound and the unfused torch sequence
    as the library yardstick."""
    import torch.nn.functional as F

    from pytorch_end2end_speech_recognition_tpu_torch.ops.ffn_kernel import (
        LN_EPS,
        bwd_plan,
        ffn_bwd,
        ffn_bwd_plain,
        ffn_fwd,
        ffn_fwd_plain,
        keep_multiplier,
    )

    scale = 0.5
    seed = torch.tensor([20261016], dtype=torch.int32, device=dev)
    err_f = err_b = 0.0
    for si, (tag, R, D, F_) in enumerate(FFN_SHAPES):
        x, gamma, beta, w1, b1, w2, b2, g = ffn_inputs(R, D, F_, gen, dev)
        w = (gamma, beta, w1, b1, w2, b2)
        for rate in (0.0, 0.1):
            out = ffn_fwd(x, *w, seed, rate, scale)
            grads = ffn_bwd(x, g, *w, seed, rate, scale)
            want = (ffn_fwd_plain(x, *w, seed, rate, scale),
                    *ffn_bwd_plain(x, g, *w, seed, rate, scale))
            mags = ffn_magnitudes(x, g, *w, seed, rate, scale)
            torch.cuda.synchronize()
            res = ffn_excess((out, *grads), want, mags)
            err_f = max(err_f, res[0][0])
            err_b = max([err_b] + [r[0] for r in res[1:]])
            print(f"[3j] ffn {tag} (R {R}, D {D}, F {F_}, bf16, scale "
                  f"{scale}), rate {rate}: " + "; ".join(
                      f"{n} max |kernel - plain| {e:.3e}, share beyond 2^-6 "
                      f"(|plain| + m) {sh:.3e}, ratio {r:.3e}"
                      for n, (e, sh, r) in zip(FFN_OUTPUTS, res)), flush=True)
            check(all(r[1] == 0.0 for r in res) and all(
                t.dtype == p.dtype for t, p in zip((out, *grads), want)),
                f"ffn kernels disagree ({tag}, rate {rate}): {res}")
            n_diff = bits_differ(grads, ffn_bwd(x, g, *w, seed, rate, scale))
            print(f"[3j] ffn backward {tag}, rate {rate}, two launches: "
                  f"{n_diff} elements differ in their bits", flush=True)
            check(n_diff == 0, f"ffn backward launches differ ({n_diff})")
            if si == 1 and rate > 0:
                # controls, each a kernel that misreads its inputs or drops
                # part of a sum, with the outputs it must fail on: b1
                # dropped, gamma ignored, the backward's mask from seed + 1,
                # the last (partial) row tile never computed; one of the S
                # row splits left out of launch B's weight gradients, one
                # 128-row tile's a and gh1 never written by launch A (read
                # by launch B as zeros), the split's rows left out of launch
                # A's column sums, and dgamma zeroed
                ones, zb1 = torch.ones_like(gamma), torch.zeros_like(b1)
                w_nob1 = (gamma, beta, w1, zb1, w2, b2)
                w_nog = (ones, beta, w1, b1, w2, b2)
                Rc = (R - 1) // 64 * 64
                cut = ffn_bwd(x[:Rc], g[:Rc], *w, seed, rate, scale)
                S = bwd_plan(R, D, F_)["S"]
                n_tiles = -(-R // 64)
                per = -(-n_tiles // S) * 64  # rows per split
                r0, r1 = S // 2 * per, min(S // 2 * per + per, R)
                g_cut = g.clone()
                g_cut[r0:r1] = 0
                sp = ffn_bwd(x, g_cut, *w, seed, rate, scale)
                t0 = -(-R // 128) // 2 * 128  # a 128-row tile of launch A
                g_tile = g.clone()
                g_tile[t0:t0 + 128] = 0
                tl = ffn_bwd(x, g_tile, *w, seed, rate, scale)
                del g_tile
                full = (out, *grads)
                for ctag, must, c_got in (
                        ("b1 dropped", ("out",),
                         (ffn_fwd(x, *w_nob1, seed, rate, scale),
                          *ffn_bwd(x, g, *w_nob1, seed, rate, scale))),
                        ("gamma ignored", ("out",),
                         (ffn_fwd(x, *w_nog, seed, rate, scale),
                          *ffn_bwd(x, g, *w_nog, seed, rate, scale))),
                        ("the backward seeded with seed + 1", ("dx",),
                         (out, *ffn_bwd(x, g, *w, seed + 1, rate, scale))),
                        (f"the last row tile ({R - Rc} rows) left out",
                         ("out", "dx"),
                         (torch.cat([ffn_fwd(x[:Rc], *w, seed, rate, scale),
                                     x[Rc:]]),
                          torch.cat([cut[0], torch.zeros_like(x[Rc:])]),
                          *cut[1:])),
                        (f"launch B's row split {S // 2} of {S} (rows {r0}-"
                         f"{r1 - 1}) left out", ("dw1", "dw2"),
                         full[:4] + (sp[3], full[5], sp[5]) + full[7:]),
                        (f"launch A's a and gh1 of rows {t0}-{t0 + 127} never"
                         " written", ("dw1", "dw2"),
                         full[:4] + (tl[3], full[5], tl[5]) + full[7:]),
                        (f"launch A's column sums over rows {r0}-{r1 - 1} "
                         "left out", ("dgamma", "dbeta", "db1", "db2"),
                         full[:2] + sp[1:3] + (full[4], sp[4], full[6])
                         + sp[6:]),
                        ("dgamma zeroed", ("dgamma",),
                         full[:2] + (torch.zeros_like(grads[1]),) + full[3:])):
                    shares = dict(zip(FFN_OUTPUTS, (
                        r[1] for r in ffn_excess(c_got, want, mags))))
                    print(f"[3j] ffn control, {ctag}: share beyond the bound "
                          + ", ".join(f"{n} {s:.3e}" for n, s in
                                      shares.items())
                          + f"; fails on {[n for n, s in shares.items() if s]}"
                          f" (must include {list(must)})", flush=True)
                    check(all(shares[n] > 0.0 for n in must),
                          f"ffn control '{ctag}' passed on {must}")
                del cut, c_got, sp, g_cut, full, tl
            if si == 0 and rate > 0:
                # the forward's mask: out = 0 + 1 * keep * (a 0 + 1) at x = 0
                # float32; the backward's, row by row: db2 = sum_r g keep
                # with g one-hot in row r
                xz = torch.zeros(R, D, device=dev)
                w_read = (gamma, beta, w1, b1, torch.zeros_like(w2),
                          torch.ones_like(b2))
                mask = ffn_fwd(xz, *w_read, seed, rate, 1.0)
                mask2 = ffn_fwd(xz, *w_read, seed + 7, rate, 1.0)
                plain_mask = keep_multiplier(seed, torch.arange(R, device=dev),
                                             D, rate)
                rows_b = (0, 63, 64, R // 2 + 5, R - 1)
                bwd_same = 0
                for r in rows_b:
                    g1 = torch.zeros(R, D, device=dev)
                    g1[r] = 1.0
                    db2 = ffn_bwd(xz, g1, *w, seed, rate, 1.0)[6]
                    bwd_same += int(torch.equal(db2 != 0, mask[r] != 0))
                frac = (mask == 0).float().mean().item()
                sigma = math.sqrt(rate * (1 - rate) / mask.numel())
                kept = mask[mask != 0]
                ks = float(np.float32(1.0 / (1.0 - rate)))
                other = (mask2 != mask).float().mean().item()
                print(f"[3j] ffn dropout mask at rate {rate} over {R} x {D}: "
                      f"kernel == plain formula: {torch.equal(mask, plain_mask)}"
                      f"; drop fraction {frac:.5f} ({(frac - rate) / sigma:+.2f}"
                      f" sigma); kept elements all {ks!r} (= 1/(1-rate) in "
                      f"float32): {bool(torch.all(kept == ks))}; seed + 7 "
                      f"differs on {other:.4f} of elements; the backward's "
                      f"mask equals the forward's on {bwd_same}/{len(rows_b)} "
                      f"rows {rows_b}", flush=True)
                check(torch.equal(mask, plain_mask)
                      and abs(frac - rate) <= 6 * sigma
                      and bool(torch.all(kept == ks)) and other > 0.1
                      and bwd_same == len(rows_b), "ffn dropout mask")
                del xz, mask, mask2, plain_mask
            if si in (0, 2) and rate > 0:
                # times at the training path's rate; the library yardstick
                # is the unfused torch sequence (no single PyTorch call
                # computes the block): F.layer_norm, two cuBLAS F.linear,
                # SiLU, the residual, and its autograd backward
                leaves = [t.detach().requires_grad_() for t in (x, *w)]

                def unfused(xx, gm, bt, w1_, b1_, w2_, b2_):
                    y = F.layer_norm(xx.float(), (D,), gm, bt, LN_EPS)
                    h = F.silu(F.linear(y.to(torch.bfloat16), w1_, b1_))
                    return xx + scale * F.linear(h, w2_, b2_)

                fb = bound(nbytes(x, *w, out),
                           4.0 * R * D * F_ / peaks["bf16_flops"], peaks)
                # the backward's five products (h1, dW2, ga, dW1, gy; h2
                # enters no gradient): 10 R D F, what the D-256 kernels do
                # (the D-512 ones do 14: their launch B recomputes h1, ga)
                bb = bound(nbytes(x, g, *w, *grads),
                           10.0 * R * D * F_ / peaks["bf16_flops"], peaks)
                if D == 256:  # the wgmma kernel, in turns with cuBLAS
                    turns = turns_ms({
                        "kernel": lambda: ffn_fwd(x, *w, seed, rate, scale),
                        "library": lambda: unfused(x, *w)})
                    turns0 = turns_ms({
                        "kernel": lambda: ffn_fwd(x, *w, seed, 0.0, scale),
                        "library": lambda: unfused(x, *w)})
                    for rt, tt in ((rate, turns), (0.0, turns0)):
                        print_turns(f"[3j] ffn forward (wgmma) {tag}, rate "
                                    f"{rt}", tt, 4.0 * R * D * F_, fb[0],
                                    card)
                else:
                    turns = {"kernel": cuda_ms(
                                 lambda: ffn_fwd(x, *w, seed, rate, scale)),
                             "library": cuda_ms(lambda: unfused(x, *w))}
                row_f = dict(
                    ms=turns["kernel"],
                    plain_ms=cuda_ms(lambda: ffn_fwd_plain(
                        x, *w, seed, rate, scale), iters=5),
                    bound_ms=fb[0], bound_by=fb[1],
                    library_ms=turns["library"])
                # the backward in turns with the unfused sequence's
                # autograd backward alone (its forward run once, outside the
                # timed window); its forward + backward timed as well
                out_u = unfused(*leaves)
                bwd = lambda: ffn_bwd(x, g, *w, seed, rate, scale)  # noqa: E731
                tb = turns_ms({"kernel": bwd,
                               "library": lambda: torch.autograd.grad(
                                   out_u, leaves, g, retain_graph=True)},
                              iters=20)
                print_turns(f"[3j] ffn backward {tag}, rate {rate} (library: "
                            "the unfused sequence's backward alone)", tb,
                            10.0 * R * D * F_, bb[0], card, iters=20)
                print_split(f"[3j] ffn backward {tag}", kernel_split(bwd),
                            card)
                row_b = dict(
                    ms=tb["kernel"],
                    plain_ms=cuda_ms(lambda: ffn_bwd_plain(
                        x, g, *w, seed, rate, scale), iters=5),
                    bound_ms=bb[0], bound_by=bb[1], library_ms=tb["library"])
                fwd_bwd = cuda_ms(lambda: torch.autograd.grad(
                    unfused(*leaves), leaves, g), iters=10)
                fwd0 = cuda_ms(lambda: ffn_fwd(x, *w, seed, 0.0, scale))
                for kname, row in (("forward", row_f), ("backward", row_b)):
                    print(f"[3j] ffn {kname} {tag}: kernel {row['ms']:.4f} ms"
                          f", plain {row['plain_ms']:.4f} ms, unfused torch "
                          f"sequence {'fwd' if row is row_f else 'bwd alone'}"
                          f" {row['library_ms']:.4f} ms, bound "
                          f"{row['bound_ms']:.4f} ms ({row['bound_by']}); "
                          f"{card}", flush=True)
                print(f"[3j] ffn unfused torch sequence {tag}, forward + "
                      f"backward: {fwd_bwd:.4f} ms; {card}", flush=True)
                print(f"[3j] ffn forward {tag} at rate 0 (serving): kernel "
                      f"{fwd0:.4f} ms", flush=True)
                if si == 0:
                    kernels["ffn_fwd"] = dict(
                        name="ffn_fwd", route="cuda",
                        source=f"{PKG}/csrc/ffn.cu",
                        replaces="pytorch_end2end_speech_recognition_tpu/ops/"
                                 "ffn_pallas.py:167", **row_f)
                    kernels["ffn_bwd"] = dict(
                        name="ffn_bwd", route="cuda",
                        source=f"{PKG}/csrc/ffn.cu",
                        replaces="pytorch_end2end_speech_recognition_tpu/ops/"
                                 "ffn_pallas.py:202", **row_b)
                del leaves, out_u
            del out, grads, want, mags
    print("[3j] ffn library yardstick: the unfused torch sequence (bf16 "
          "cuBLAS linears, float32 layer norm), its forward and its "
          "backward alone; no single PyTorch call computes the block",
          flush=True)
    kernels["ffn_fwd"]["max_abs_err"] = err_f
    kernels["ffn_bwd"]["max_abs_err"] = err_b


# the serving cells' subsampling shapes: (tag, B, T frames, C); n_mels 80
SUB_SHAPES = (("M 30 s", 256, 2998, 256), ("L 30 s", 128, 2998, 512),
              ("M 65 s", 128, 6551, 256), ("OWSM 30 s", 32, 2998, 1024))


def sub_excess(out, ref) -> float:
    """max |out - ref| / (2^-5 |ref| + 2^-4 rms(ref)), as the card tests
    hold the subsampling kernel: above 1 fails (bf16 outputs; the plain
    version rounds each convolution before its bias, up to 2^-7 |ref| at
    the output, and conv1 activations may differ by an ulp, of which conv2
    sums 9 C)."""
    out, ref = out.float(), ref.float()
    rms = ref.pow(2).mean().sqrt()
    return float(((out - ref).abs() / (2.0 ** -5 * ref.abs()
                                       + 2.0 ** -4 * rms)).max())


def subsample_library(x, lens, w1, b1, w2, b2):
    """The yardstick: the two convolutions as cuDNN runs them at best, bf16
    in channels_last, SAME pads and ReLU, without the masks, casts and the
    layout copy that `subsample_plain` adds."""
    import torch.nn.functional as F

    from pytorch_end2end_speech_recognition_tpu_torch.ops.subsample_kernel import (  # noqa: E501
        _same_pad_s2,
    )

    h = x.to(w1.dtype)[:, None].contiguous(memory_format=torch.channels_last)
    for w, b in ((w1, b1), (w2, b2)):
        (t0, t1), (f0, f1) = _same_pad_s2(h.shape[2]), _same_pad_s2(h.shape[3])
        h = F.relu(F.conv2d(F.pad(h, (f0, f1, t0, t1)), w, b, stride=2))
    return h


def subsample_kernel_phase(dev, peaks, card, kernels) -> None:
    """[3k] the subsampling kernel (`csrc/subsample.cu`, no TPU kernel: XLA's
    convolutions there) at the serving cells' shapes: held to
    `subsample_plain` (B 8, ragged lengths with 1 and T) and timed in turns
    at the cells' B beside the plain version (the port's sequence before the
    kernel) and cuDNN's bare convolutions (`library_ms`), with its bound.
    Draws from a generator of its own."""
    from pytorch_end2end_speech_recognition_tpu_torch.ops.subsample_kernel import (  # noqa: E501
        kernel_plan,
        subsample,
        subsample_plain,
    )

    gen = torch.Generator().manual_seed(20)
    n_mels = 80

    def inputs(B, T, C):
        x = (torch.randn(B, T, n_mels, generator=gen) * 2.0).to(dev)
        lens = [T, 1] + torch.randint(1, T + 1, (B - 2,),
                                      generator=gen).tolist()
        w = (torch.randn(C, 1, 3, 3, generator=gen) / 3.0,
             torch.randn(C, generator=gen) * 0.3,
             torch.randn(C, C, 3, 3, generator=gen) / (3.0 * C ** 0.5),
             torch.randn(C, generator=gen) * 0.1)
        return (x, torch.tensor(lens, device=dev),
                *(a.to(dev, torch.bfloat16) for a in w))

    rows, worst = [], 0.0
    for tag, B, T, C in SUB_SHAPES:
        plan = kernel_plan(n_mels, C)
        small = inputs(8, T, C)
        exc = sub_excess(subsample(*small), subsample_plain(*small))
        worst = max(worst, exc)
        check(exc <= 1.0, f"[3k] subsample {tag}: kernel vs plain excess "
              f"{exc:.3f} > 1")
        args = inputs(B, T, C)
        turns = turns_ms({"kernel": lambda: subsample(*args),
                          "plain": lambda: subsample_plain(*args),
                          "library": lambda: subsample_library(*args)},
                         windows=3, iters=5, warmup=1)
        T1, F1 = (T + 1) // 2, (n_mels + 1) // 2
        T2, F2 = (T1 + 1) // 2, (F1 + 1) // 2
        flops = 2.0 * 9 * C * (C * T2 * F2 + T1 * F1) * B
        n_bytes = nbytes(args[0]) + B * T2 * F2 * C * 2 + 9 * C * (C + 1) * 2
        b_ms, b_by = bound(n_bytes, flops / peaks["bf16_flops"], peaks)
        k = turns["kernel"]
        print(f"[3k] subsample {tag} (B {B}, T {T}, n_mels {n_mels}, C {C}; "
              f"plan NW {plan['nw']} x {plan['pieces']}, "
              f"{plan['smem_bytes']} B shared): kernel {k:.3f} ms, "
              f"plain {turns['plain']:.3f} ms, library (cuDNN convolutions "
              f"alone) {turns['library']:.3f} ms (medians of 3 windows x 5 "
              f"launches in turns), bound {b_ms:.3f} ms ({b_by}), "
              f"{flops / k / 1e9:.1f} TFLOP/s, bound / kernel {b_ms / k:.3f};"
              f" B 8 vs plain: excess {exc:.3f}; {card}", flush=True)
        rows.append(dict(shape=tag, ms=k, plain_ms=turns["plain"],
                         bound_ms=b_ms, bound_by=b_by,
                         library_ms=turns["library"]))
        del args, small
        torch.cuda.empty_cache()
    kernels["subsample"] = dict(
        name="subsample", route="cuda", source=f"{PKG}/csrc/subsample.cu",
        replaces="none (XLA's convolutions in the JAX package)",
        **{k: v for k, v in rows[0].items() if k != "shape"},
        shapes=rows, max_excess=worst)


# the attention of the absolute-position encoders: one layer of OWSM v3.1
# medium's serving cell, (B, T', D, H) = (32, 750, 1024, 16)
NOBIAS_SHAPE = (32, 750, 1024, 16)


def nobias_attention_phase(dev, peaks, card, shape=NOBIAS_SHAPE) -> None:
    """[3l] the attention forward without a bias (`attention_fwd_kernel<0>`,
    the E-Branchformer's; [3c] runs it only as a control) at `shape`: held
    on ragged (with 1, 2 and T') and full lengths to `attention_plain`
    without a bias under [3c]'s tolerance; controls that must fail the same
    check: the lengths ignored, and a bias (std BIAS_STD) that the kernel
    does not add; timed in turns against SDPA without a mask at full
    lengths. Draws from a generator of its own."""
    from pytorch_end2end_speech_recognition_tpu_torch.ops.attention_kernel import (  # noqa: E501
        attention_fwd,
        attention_plain,
        fused_attention,
    )

    B, T, D, H = shape
    gen = torch.Generator().manual_seed(23)
    q, k, v = (torch.randn(B, T, D, generator=gen).to(dev, torch.bfloat16)
               for _ in range(3))
    full = torch.full((B,), T, dtype=torch.int32, device=dev)
    ragged = torch.randint(1, T + 1, (B,), generator=gen, dtype=torch.int32)
    ragged[0], ragged[1], ragged[2] = 1, 2, T
    ragged = ragged.to(dev)
    bias = (torch.randn(H, T, T, generator=gen) * BIAS_STD).to(
        dev, torch.bfloat16)

    def excess(out, lens, bias_ref=None):
        """(max |out - plain| on valid rows, share of valid elements beyond
        the bf16 tolerance) against the plain version with `bias_ref`."""
        ref = attention_plain(q, k, v, bias_ref, lens, H).float()
        pv = attention_plain(q, k, v.abs(), bias_ref, lens, H).float()
        valid = (torch.arange(T, device=dev)[None, :]
                 < lens[:, None])[..., None].expand_as(ref)
        diff = (out.float() - ref).abs()
        over = (diff > ATTN_RTOL * ref.abs() + ATTN_VTOL * pv) & valid
        return diff[valid].max().item(), over.sum().item() / valid.sum().item()

    where = f"B={B} x T' {T}, D {D}, H {H}"
    for tag, lens in (("ragged", ragged), ("full", full)):
        err, share = excess(fused_attention(q, k, v, None, lens, H), lens)
        print(f"[3l] attention without a bias, {where}, {tag} lens: max "
              f"|kernel - plain| on valid rows = {err:.3e}; share beyond "
              f"2^-7|o| + 2^-6 p.|v|: {share:.3e}", flush=True)
        check(share == 0.0, f"[3l] attention without a bias ({tag}) "
              f"disagrees ({err}, {share})")
    for tag, out, lens, bias_ref in (
            ("lengths ignored", fused_attention(q, k, v, None, full, H),
             ragged, None),
            ("a bias not added", fused_attention(q, k, v, None, full, H),
             full, bias)):
        err, share = excess(out, lens, bias_ref)
        print(f"[3l] attention without a bias, control, {tag}: max |diff| "
              f"{err:.3e}, share beyond tolerance {share:.3e} (must be > 0)",
              flush=True)
        check(share > 0.0, f"[3l] control '{tag}' passed the check")
    qh, kh, vh = (t.view(B, T, H, D // H).transpose(1, 2).contiguous()
                  for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    flops = 4.0 * T * T * D * B
    b_ms, _ = bound(nbytes(q, k, v, q, full),  # q, k, v read, o written
                    flops / peaks["bf16_flops"], peaks)
    turns = turns_ms({
        "kernel": lambda: attention_fwd(q, k, v, None, full, H),
        "library": lambda: sdpa(qh, kh, vh)})
    print_turns(f"[3l] attention forward without a bias (wgmma) {where} "
                "against SDPA without a mask", turns, flops, b_ms, card)
    del q, k, v, qh, kh, vh, bias
    torch.cuda.empty_cache()


def serve(m, a, al):
    """encode -> CTC logits -> greedy decode: (enc, enc_lens, logits,
    tokens, n_tokens)."""
    from pytorch_end2end_speech_recognition_tpu_torch.ops.ctc import (
        ctc_greedy_decode,
    )

    enc, elens = m.encode(a, al)
    logits = m.ctc_logits(enc)
    tokens, tlens = ctc_greedy_decode(logits, elens)
    return enc, elens, logits, tokens, tlens


def _zero_first_recurrence(model) -> None:
    """The control of [11] and [12]: layer 0's W_hh zeroed in both
    directions, a recurrence that ignores h."""
    with torch.no_grad():
        layer = model.encoder.layers[0]
        layer.fwd.w_hh.zero_()
        layer.bwd.w_hh.zero_()


def an4_serve_phase(dev, gen, card, kernels, counted, t_start) -> None:
    """[11] an4_ctc (rung 1: 2-layer BiLSTM, H 256) serving at full width:
    a ragged B=32 batch of 2-8 s speech-like rows, kernels vs plain torch,
    launch counts, throughput and a profile."""
    from pytorch_end2end_speech_recognition_tpu_torch.configs.presets import (
        an4_ctc,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.models.asr import AsrModel

    Ts = AN4_SECONDS * SR
    audio = speechlike(B, Ts, gen, dev)
    lens = torch.randint(2 * SR, Ts + 1, (B,), device=dev, generator=gen)
    lens[0] = Ts
    audio = audio * (torch.arange(Ts, device=dev)[None, :] < lens[:, None])
    model = AsrModel(an4_ctc(), device=dev, seed=0).eval()
    mc = model.cfg.model
    check(mc.lstm_impl == "cuda" and model.cfg.frontend.impl == "cuda"
          and mc.dtype == "bfloat16", f"an4_ctc did not resolve to the "
          f"kernels in bf16: {mc}")
    ref_cfg = an4_ctc()
    ref_cfg.frontend.impl = "torch"
    ref_cfg.model.lstm_impl = "torch"
    ref_model = AsrModel(ref_cfg, device=dev, seed=0).eval()
    for fn in counted:
        fn.launches = 0
    with torch.inference_mode():
        enc, elens, logits, tokens, tlens = serve(model, audio, lens)
    torch.cuda.synchronize()
    counts = {f.__name__: f.launches for f in counted if f.launches}
    L = mc.encoder_layers  # one launch for both directions of a layer
    print(f"[11] an4_ctc serving launches: {counts}", flush=True)
    check(counts == {"logmel": 1, "lstm_fwd": L},
          f"an4_ctc serving launch counts {counts}")
    kernels["lstm_fwd"]["launches"] = counts["lstm_fwd"]
    n_frames = (Ts - WIN) // HOP + 1
    check(tuple(enc.shape) == (B, n_frames, 2 * mc.encoder_dim)
          and bool(torch.isfinite(logits).all())
          and torch.equal(elens, (lens - WIN) // HOP + 1),
          f"an4_ctc encoder output {tuple(enc.shape)}")
    with torch.inference_mode():
        ref_logits = serve(ref_model, audio, lens)[2]
    compare(f"[11] an4_ctc kernels vs plain torch (bf16, ragged B={B} x "
            f"2-{AN4_SECONDS} s)", logits, ref_logits, elens,
            need_sure=True, tol=TOL_AN4_LOGITS)
    _zero_first_recurrence(ref_model)
    with torch.inference_mode():
        ctl_logits = serve(ref_model, audio, lens)[2]
    valid = (torch.arange(logits.shape[1], device=dev)[None, :]
             < elens[:, None])
    ctl = (logits - ctl_logits).abs().amax(-1)[valid].max().item()
    print(f"[11] control, plain model with layer 0's W_hh zeroed: max "
          f"|dlogit| {ctl:.4f} (must exceed {TOL_AN4_LOGITS})", flush=True)
    check(ctl > TOL_AN4_LOGITS, "the an4_ctc tolerance cannot see the "
          "recurrence")
    toks = tokens[0, :int(tlens[0])].tolist()
    print(f"[11] row 0: {int(elens[0])} frames, {len(toks)} tokens "
          f"{toks[:16]}{' ...' if len(toks) > 16 else ''}", flush=True)
    del ref_model, ref_logits, ctl_logits
    full = torch.full((B,), Ts, dtype=torch.int64, device=dev)
    rates = []
    with torch.inference_mode():
        for _ in range(2):
            serve(model, audio, full)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(WINDOWS):
            t0 = time.perf_counter()
            for _ in range(ITERS):
                serve(model, audio, full)
            torch.cuda.synchronize()
            rates.append(B * AN4_SECONDS * ITERS / (time.perf_counter() - t0))
    print(f"[11] an4_ctc throughput: median {statistics.median(rates):.1f} "
          f"audio-s/s over {WINDOWS} windows of {ITERS} x (B={B} x "
          f"{AN4_SECONDS} s) (min {min(rates):.1f}, max {max(rates):.1f}); "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB;"
          f" {card}; {time.perf_counter() - t_start:.0f} s since start",
          flush=True)
    with torch.inference_mode():
        wall_ms, kernel_ms, n = profile_step(
            lambda: serve(model, audio, full), ITERS)
    print_profile("[11] profile of one an4_ctc forward", wall_ms, kernel_ms, n,
                  card)


def las_train_phase(dev, gen, card, kernels, counted, t_start) -> None:
    """[12] the wsj_las hybrid step at full width (VGG + 4-layer pBLSTM, H
    320, location-aware speller, lambda 0.3, SpecAugment, scheduled
    sampling 0.1) on a ragged B=32 batch of 8-16 s rows, U <= 200: one
    step against plain torch on the card with a failing control, launch
    counts, five Solver steps, throughput, peak memory and a profile; then
    one an4_ctc CTC-only step."""
    from pytorch_end2end_speech_recognition_tpu_torch.configs.presets import (
        an4_ctc,
        wsj_las,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.data.dataset import Batch
    from pytorch_end2end_speech_recognition_tpu_torch.ops import frontend as fe
    from pytorch_end2end_speech_recognition_tpu_torch.ops.specaugment import (
        spec_augment_mask,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
        resolve_device,
    )

    V = wsj_las().model.vocab_size
    Ts = LAS_SECONDS * SR
    audio = speechlike(B, Ts, gen, dev)
    lens = torch.randint(LAS_SECONDS // 2 * SR, Ts + 1, (B,), device=dev,
                         generator=gen)
    lens[0] = Ts
    audio = audio * (torch.arange(Ts, device=dev)[None, :] < lens[:, None])
    # 32x downsampling (VGG 4x, three pyramid layers 8x): ~50 frames for a
    # 16 s row, so CTC can explain at most ~25 labels without repeats
    enc_lens = ((lens - WIN) // HOP + 1) // 32
    tok = 1 + torch.cumsum(torch.randint(1, V - 1, (B, U_LAS), device=dev,
                                         generator=gen), 1) % (V - 1)
    tok_lens = torch.minimum(
        torch.randint(U_LAS // 2, U_LAS + 1, (B,), device=dev, generator=gen),
        enc_lens // 2)
    tok = tok * (torch.arange(U_LAS, device=dev)[None, :] < tok_lens[:, None])
    host = lambda t: t.cpu().numpy().astype(np.int32)  # noqa: E731
    batch = Batch(audio.cpu().numpy(), host(lens), host(tok), host(tok_lens))
    fcfg = resolve_device(wsj_las(), dev).frontend
    front = fe.Frontend(fcfg, dev)
    spec_mask = spec_augment_mask(front.frame_lens(lens), front.n_frames(Ts),
                                  fcfg.n_mels, fcfg, gen)
    coins = torch.rand(B, U_LAS + 1, device=dev, generator=gen) < \
        wsj_las().train.scheduled_sampling

    def las_solver(impl: str) -> "Solver":
        c = wsj_las()
        c.model.encoder_dropout = 0.0
        if impl == "torch":
            c.frontend.impl = "torch"
            c.model.lstm_impl = c.model.ctc_impl = "torch"
        return make_solver(c, V, dev)

    ks = las_solver("cuda")
    mc = ks.cfg.model
    check(mc.lstm_impl == "cuda" and mc.ctc_impl == "cuda"
          and ks.model.decoder is not None and mc.dtype == "bfloat16",
          "the wsj_las step is not on the kernels or has no speller")
    for fn in counted:
        fn.launches = 0
    km, kg = ks.grads(batch, spec_mask=spec_mask, coins=coins)
    torch.cuda.synchronize()
    counts = {f.__name__: f.launches for f in counted if f.launches}
    L = mc.encoder_layers
    print(f"[12] wsj_las hybrid step launches: {counts}", flush=True)
    check(counts == {"logmel": 1, "lstm_fwd": L, "lstm_bwd": L,
                     "ctc_alpha": 1, "ctc_beta": 1},
          f"wsj_las step launch counts {counts}")
    kernels["lstm_bwd"]["launches"] = counts["lstm_bwd"]
    kg = {n: g.detach() for n, g in zip(ks.names, kg)}
    check(all(bool(torch.isfinite(g).all()) for g in kg.values())
          and all(bool(torch.isfinite(v)) for v in km.values()),
          "wsj_las kernel step not finite")
    del ks
    ps = las_solver("torch")
    pm, pg = ps.grads(batch, spec_mask=spec_mask, coins=coins)
    pg = {n: g.detach() for n, g in zip(ps.names, pg)}
    d_loss = abs(float(km["loss"]) - float(pm["loss"])) / float(pm["loss"])
    cmin, rmax, cmed, n_cmp = grad_stats(kg, pg)
    print(f"[12] wsj_las kernels vs plain torch, one hybrid step (B={B} x "
          f"{LAS_SECONDS // 2}-{LAS_SECONDS} s ragged, U<={U_LAS} padded, "
          f"token lens {int(tok_lens.min())}-{int(tok_lens.max())}, "
          f"{int(coins.sum())} coins set, bf16): loss "
          f"{float(km['loss']):.5f} vs {float(pm['loss']):.5f} (ctc "
          f"{float(km['ctc_loss']):.4f} vs {float(pm['ctc_loss']):.4f}, att "
          f"{float(km['att_loss']):.4f} vs {float(pm['att_loss']):.4f}), "
          f"relative |d loss| {d_loss:.2e} (tol {TOL_LAS_LOSS}); gradients "
          f"of {n_cmp} parameters: cosine min {cmin:.5f} median {cmed:.5f} "
          f"(tol {LAS_MIN_COS}), relative error max {rmax:.4f} (tol "
          f"{LAS_MAX_REL})", flush=True)
    check(d_loss <= TOL_LAS_LOSS and cmin >= LAS_MIN_COS
          and rmax <= LAS_MAX_REL, "wsj_las kernel step disagrees with plain")
    _zero_first_recurrence(ps.model)
    cm, cg = ps.grads(batch, spec_mask=spec_mask, coins=coins)
    cg = {n: g.detach() for n, g in zip(ps.names, cg)}
    c_loss = abs(float(cm["loss"]) - float(km["loss"])) / float(cm["loss"])
    cmin_c, rmax_c, cmed_c, _ = grad_stats(kg, cg)
    print(f"[12] control, plain model with layer 0's W_hh zeroed: relative "
          f"|d loss| {c_loss:.2e}, cosine min {cmin_c:.5f} median "
          f"{cmed_c:.5f}, relative error max {rmax_c:.4f} (must fail)",
          flush=True)
    check(c_loss > TOL_LAS_LOSS or cmin_c < LAS_MIN_COS
          or rmax_c > LAS_MAX_REL, "the wsj_las tolerance cannot see the "
          "recurrence")
    del ps, pg, cg, kg

    solver = make_solver(wsj_las(), V, dev)
    check(solver.cfg.model.encoder_dropout > 0
          and solver.cfg.frontend.spec_augment
          and solver.cfg.train.scheduled_sampling > 0,
          "wsj_las training draws are off")
    solver.cfg.train.log_every = 1
    solver.fit(OneBatch(batch), steps=5)
    losses = [r["loss"] for r in solver.log]
    print(f"[12] 5 wsj_las Solver steps (dropout 0.1, SpecAugment, scheduled"
          f" sampling 0.1): loss {[round(x, 4) for x in losses]}, grad_norm "
          f"{[round(r['grad_norm'], 3) for r in solver.log]}", flush=True)
    check(len(losses) == 5 and all(math.isfinite(x) for x in losses)
          and all(bool(torch.isfinite(p).all())
                  for p in solver.model.parameters()),
          "wsj_las Solver steps not finite")
    full_batch = Batch(batch.audio, np.full(B, Ts, np.int32), batch.tokens,
                       batch.token_lens)
    solver.train_step(full_batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rates = []
    for _ in range(TRAIN_WINDOWS):
        t0 = time.perf_counter()
        for _ in range(TRAIN_ITERS):
            solver.train_step(full_batch)
        torch.cuda.synchronize()
        rates.append(B * LAS_SECONDS * TRAIN_ITERS
                     / (time.perf_counter() - t0))
    print(f"[12] wsj_las train throughput: median "
          f"{statistics.median(rates):.1f} audio-s/s over {TRAIN_WINDOWS} "
          f"windows of {TRAIN_ITERS} steps x (B={B} x {LAS_SECONDS} s, "
          f"U={U_LAS}) (min {min(rates):.1f}, max {max(rates):.1f}); peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"{card}; {time.perf_counter() - t_start:.0f} s since start",
          flush=True)
    wall_ms, kernel_ms, n = profile_step(
        lambda: solver.train_step(full_batch), 1)
    print_profile("[12] profile of one wsj_las train step", wall_ms,
                  kernel_ms, n, card)
    del solver

    # one an4_ctc CTC-only step (B=32 x 8 s rows of the same audio)
    Ta = AN4_SECONDS * SR
    a_lens = torch.clamp(lens // 2, max=Ta)
    a_tok_lens = torch.minimum(tok_lens, ((a_lens - WIN) // HOP + 1) // 2)
    a_batch = Batch(batch.audio[:, :Ta], host(a_lens), batch.tokens,
                    host(a_tok_lens))
    an4 = make_solver(an4_ctc(), V, dev)
    for fn in counted:
        fn.launches = 0
    m = an4.train_step(a_batch)
    torch.cuda.synchronize()
    counts = {f.__name__: f.launches for f in counted if f.launches}
    L = an4.cfg.model.encoder_layers
    print(f"[12] an4_ctc Solver.train_step launches: {counts}; loss "
          f"{float(m['loss']):.4f}, grad_norm {float(m['grad_norm']):.3f}",
          flush=True)
    check(counts == {"logmel": 1, "lstm_fwd": L, "lstm_bwd": L,
                     "ctc_alpha": 1, "ctc_beta": 1},
          f"an4_ctc step launch counts {counts}")
    check(math.isfinite(float(m["loss"])) and "att_loss" not in m,
          "an4_ctc step not finite or not CTC-only")


def ffn_path(model) -> str:
    """Which FFN path each FfnBlock of `model` takes."""
    from pytorch_end2end_speech_recognition_tpu_torch.models.encoders import (
        FfnBlock,
    )

    blocks = [b for b in model.modules() if isinstance(b, FfnBlock)]
    n = sum(b.fused for b in blocks)
    return (f"ffn_impl={model.cfg.model.ffn_impl}: {n} of {len(blocks)} "
            "FfnBlocks on the fused FFN kernels, "
            f"{len(blocks) - n} on plain torch")


def _launches(counted) -> dict:
    return {f.__name__: f.launches for f in counted if f.launches}


def _with_table(model, table):
    with torch.no_grad():
        model.encoder.rel.table.copy_(table)
    return model


def plain_subsampling(model):
    """`model` with each `ConvSubsample` on `subsample_plain`. It takes the
    operator `asr_port::subsample` (the kernel, on the card) whenever it
    records no gradient at bf16, whatever the config's impls: a plain
    reference left so would hold the kernel against itself."""
    from unittest import mock

    from pytorch_end2end_speech_recognition_tpu_torch.models import encoders
    from pytorch_end2end_speech_recognition_tpu_torch.ops.subsample_kernel import (  # noqa: E501
        subsample_plain,
    )

    def plain(forward):
        def run(x, lens):
            with mock.patch.object(encoders, "subsample", subsample_plain):
                return forward(x, lens)
        return run

    for mod in model.modules():
        if isinstance(mod, encoders.ConvSubsample):
            mod.forward = plain(mod.forward)
    return model


def _abba(tag, runs, windows, seconds_per_call, card, t_start):
    """Throughput of each (name, fn) in `runs`, timed in turns (A B, B A,
    ...): audio-seconds per second per window of fn(), median per name."""
    rates = {name: [] for name, _ in runs}
    for wi in range(windows):
        for name, fn in (runs if wi % 2 == 0 else runs[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            rates[name].append(seconds_per_call / (time.perf_counter() - t0))
    print(f"{tag}: " + "; ".join(
        f"{name} median {statistics.median(r):.1f} audio-s/s (min "
        f"{min(r):.1f}, max {max(r):.1f})" for name, r in rates.items())
        + f" over {windows} windows each, in turns; {card}; "
        f"{time.perf_counter() - t_start:.0f} s since start", flush=True)


def flagship_ffn_phase(dev, card, kernels, counted, t_start, audio,
                       audio_lens, full_lens, table, batch, spec_mask) -> None:
    """[13] flagship_conformer with model.ffn_impl=cuda at B=32 x 30 s: the
    serving forward's launch counts, held against the all-plain model (with
    its bias-zeroed control) and against the same kernels with
    ffn_impl=torch; one hybrid step at dropout 0 against plain torch with
    launch counts; five Solver steps with dropout 0.1 and SpecAugment;
    serving and training throughput of ffn_impl=cuda and torch in turns.
    Rung 4 with ffn_impl=cuda takes the plain FFN (the JAX gate)."""
    from pytorch_end2end_speech_recognition_tpu_torch.configs.presets import (
        flagship_conformer,
        libri960_conformer,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.data.dataset import Batch
    from pytorch_end2end_speech_recognition_tpu_torch.models.asr import AsrModel
    from pytorch_end2end_speech_recognition_tpu_torch.models.encoders import (
        FfnBlock,
    )

    def cfg(ffn: str, impl: str = "cuda", dropout: float | None = None):
        c = flagship_conformer()
        c.model.ffn_impl = ffn
        if impl == "torch":
            c.frontend.impl = "torch"
            c.model.attn_impl = c.model.ctc_impl = "torch"
        if dropout is not None:
            c.model.encoder_dropout = c.model.decoder_dropout = dropout
        return c

    V = flagship_conformer().model.vocab_size
    L = flagship_conformer().model.encoder_layers
    mk = _with_table(AsrModel(cfg("cuda"), device=dev, seed=0).eval(), table)
    mt = _with_table(AsrModel(cfg("torch"), device=dev, seed=0).eval(), table)
    mp = plain_subsampling(_with_table(
        AsrModel(cfg("torch", "torch"), device=dev, seed=0).eval(), table))
    r4 = libri960_conformer().model
    r4.ffn_impl = "cuda"
    r4_fused = FfnBlock(r4).fused
    for tag, m in (("ffn kernels", mk), ("same kernels, ffn torch", mt),
                   ("all plain", mp)):
        print(f"[13] flagship FFN path ({tag}): {ffn_path(m)}", flush=True)
    print(f"[13] rung 4 (D {r4.encoder_dim}, F {r4.encoder_ffn_dim}) with "
          f"ffn_impl=cuda: fused FFN {r4_fused} (fits_vmem false: plain torch,"
          " as the JAX gate)", flush=True)
    check(all(b.fused for b in mk.modules() if isinstance(b, FfnBlock))
          and not any(b.fused for b in mt.modules() if isinstance(b, FfnBlock))
          and not r4_fused, "the FFN gate")
    for fn in counted:
        fn.launches = 0
    with torch.inference_mode():
        enc, elens, logits, _, _ = serve(mk, audio, audio_lens)
    torch.cuda.synchronize()
    counts = _launches(counted)
    print(f"[13] flagship ffn_impl=cuda serving launches: {counts}",
          flush=True)
    check(counts == {"logmel": 1, "toeplitz_fwd": 1, "attention_fwd": L,
                     "ffn_fwd": 2 * L, "subsample": 1},
          f"[13] serving launch counts {counts}")
    kernels["ffn_fwd"]["launches"] = counts["ffn_fwd"]
    check(bool(torch.isfinite(logits).all()) and enc.dtype == torch.bfloat16,
          "[13] logits not finite")
    with torch.inference_mode():
        p_logits = serve(mp, audio, audio_lens)[2]
        t_logits = serve(mt, audio, audio_lens)[2]
    compare(f"[13] ffn kernels vs all plain torch (bf16, {L} L, ragged B={B} "
            f"x {SECONDS:.0f} s)", logits, p_logits, elens, need_sure=True)
    compare("[13] ffn kernels vs the same kernels with ffn_impl=torch",
            logits, t_logits, elens, need_sure=True)
    with torch.no_grad():
        mp.encoder.rel.table.zero_()
    with torch.inference_mode():
        ctl_logits = serve(mp, audio, audio_lens)[2]
    valid = (torch.arange(logits.shape[1], device=dev)[None, :]
             < elens[:, None])
    ctl = (logits - ctl_logits).abs().amax(-1)[valid].max().item()
    print(f"[13] control, plain model with the relative bias zeroed: max "
          f"|dlogit| {ctl:.4f} (must exceed {TOL_LOGITS})", flush=True)
    check(ctl > TOL_LOGITS, "[13] the logit tolerance cannot see the bias")
    del mp, p_logits, t_logits, ctl_logits, enc

    def serve_iters(m):
        def run():
            with torch.inference_mode():
                for _ in range(ITERS):
                    serve(m, audio, full_lens)
        return run

    for m in (mt, mk):
        serve_iters(m)()
    _abba(f"[13] flagship serving throughput, {ITERS} x (B={B} x "
          f"{SECONDS:.0f} s) per window", [("ffn_impl=torch", serve_iters(mt)),
                                           ("ffn_impl=cuda", serve_iters(mk))],
          WINDOWS, B * SECONDS * ITERS, card, t_start)
    with torch.inference_mode():
        wall_ms, kernel_ms, n = profile_step(
            lambda: serve(mk, audio, full_lens), ITERS)
    print_profile("[13] profile of one flagship forward, ffn_impl=cuda",
                  wall_ms, kernel_ms, n, card)
    del mk, mt

    # one hybrid step at dropout 0, kernels (FFN included) vs plain torch
    ks = make_solver(cfg("cuda", dropout=0.0), V, dev)
    _with_table(ks.model, table)
    for fn in counted:
        fn.launches = 0
    km, kg = ks.grads(batch, spec_mask=spec_mask)
    torch.cuda.synchronize()
    counts = _launches(counted)
    print(f"[13] flagship ffn_impl=cuda hybrid step launches: {counts}",
          flush=True)
    check(counts == {"logmel": 1, "toeplitz_fwd": 1, "attention_fwd": L,
                     "attention_bwd": L, "toeplitz_reduce": 1, "ctc_alpha": 1,
                     "ctc_beta": 1, "ffn_fwd": 2 * L, "ffn_bwd": 2 * L},
          f"[13] step launch counts {counts}")
    kernels["ffn_bwd"]["launches"] = counts["ffn_bwd"]
    kg = {n_: g.detach() for n_, g in zip(ks.names, kg)}
    del ks
    ps = make_solver(cfg("torch", "torch", 0.0), V, dev)
    _with_table(ps.model, table)
    pm, pg = ps.grads(batch, spec_mask=spec_mask)
    pg = {n_: g.detach() for n_, g in zip(ps.names, pg)}
    d_loss = abs(float(km["loss"]) - float(pm["loss"])) / float(pm["loss"])
    cmin, rmax, cmed, n_cmp = grad_stats(kg, pg)
    print(f"[13] ffn kernels vs plain torch, one hybrid step (B={B} x "
          f"{SECONDS:.0f} s ragged, U<={U_TOKENS}, bf16, {L} L): loss "
          f"{float(km['loss']):.5f} vs {float(pm['loss']):.5f}, relative "
          f"|d loss| {d_loss:.2e} (tol {TOL_TRAIN_LOSS}); gradients of "
          f"{n_cmp} parameters: cosine min {cmin:.5f} median {cmed:.5f} (tol "
          f"{TRAIN_MIN_COS}), relative error max {rmax:.4f} (tol "
          f"{TRAIN_MAX_REL})", flush=True)
    check(all(bool(torch.isfinite(g).all()) for g in kg.values())
          and d_loss <= TOL_TRAIN_LOSS and cmin >= TRAIN_MIN_COS
          and rmax <= TRAIN_MAX_REL, "[13] kernel step disagrees with plain")
    with torch.no_grad():
        ps.model.encoder.rel.table.zero_()
    cm, cg = ps.grads(batch, spec_mask=spec_mask)
    cg = {n_: g.detach() for n_, g in zip(ps.names, cg)}
    c_loss = abs(float(cm["loss"]) - float(km["loss"])) / float(cm["loss"])
    cmin_c, rmax_c, cmed_c, _ = grad_stats(kg, cg)
    print(f"[13] control, plain model with the relative bias zeroed: "
          f"relative |d loss| {c_loss:.2e}, cosine min {cmin_c:.5f} median "
          f"{cmed_c:.5f}, relative error max {rmax_c:.4f} (must fail)",
          flush=True)
    check(c_loss > TOL_TRAIN_LOSS or cmin_c < TRAIN_MIN_COS
          or rmax_c > TRAIN_MAX_REL, "[13] the train-step tolerance cannot "
          "see the bias")
    del ps, pg, cg, kg

    # five Solver steps with dropout 0.1 and SpecAugment, then throughput
    # of ffn_impl=cuda and torch in turns on full rows
    sk = make_solver(cfg("cuda"), V, dev)
    check(sk.cfg.model.encoder_dropout > 0 and sk.cfg.frontend.spec_augment,
          "[13] training draws are off")
    sk.cfg.train.log_every = 1
    sk.fit(OneBatch(batch), steps=5)
    losses = [r["loss"] for r in sk.log]
    print(f"[13] 5 Solver steps, ffn_impl=cuda (dropout 0.1, SpecAugment): "
          f"loss {[round(v, 4) for v in losses]}, grad_norm "
          f"{[round(r['grad_norm'], 3) for r in sk.log]}", flush=True)
    check(len(losses) == 5 and all(math.isfinite(v) for v in losses)
          and all(bool(torch.isfinite(p).all())
                  for p in sk.model.parameters()), "[13] Solver steps")
    st = make_solver(cfg("torch"), V, dev)
    full_batch = Batch(batch.audio, np.full(B, batch.audio.shape[1], np.int32),
                       batch.tokens, batch.token_lens)

    def steps(sv):
        def run():
            for _ in range(TRAIN_ITERS):
                sv.train_step(full_batch)
        return run

    for sv in (st, sk):
        sv.train_step(full_batch)
    torch.cuda.reset_peak_memory_stats()
    _abba(f"[13] flagship train throughput, {TRAIN_ITERS} steps x (B={B} x "
          f"{SECONDS:.0f} s, U={U_TOKENS}) per window",
          [("ffn_impl=torch", steps(st)), ("ffn_impl=cuda", steps(sk))],
          TRAIN_WINDOWS, B * SECONDS * TRAIN_ITERS, card, t_start)
    print(f"[13] peak memory over both: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    del st
    wall_ms, kernel_ms, n = profile_step(lambda: sk.train_step(full_batch), 1)
    print_profile("[13] profile of one flagship train step, ffn_impl=cuda",
                  wall_ms, kernel_ms, n, card)
    del sk


def rung3_phase(dev, gen, card, kernels, counted, t_start, audio, audio_lens,
                full_lens, spec_mask, peaks) -> None:
    """[14] libri100_transformer (rung 3: 12-layer Transformer encoder d256,
    H4, FFN 1,024, relative bias; 6-layer transformer decoder; vocab 256)
    at full width with ffn_impl=cuda on the ragged B=32 x 30 s batch:
    serving launch counts, against plain torch with a bias-zeroed control,
    throughput and a profile; one hybrid step (U <= 128) against plain
    torch with launch counts and a control; five Solver steps with dropout
    0.1; train throughput and peak memory."""
    from pytorch_end2end_speech_recognition_tpu_torch.configs.presets import (
        libri100_transformer,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.data.dataset import Batch
    from pytorch_end2end_speech_recognition_tpu_torch.models.asr import AsrModel
    from pytorch_end2end_speech_recognition_tpu_torch.models.encoders import (
        TransformerEncoder,
    )

    def cfg(impl: str, dropout: float | None = None):
        c = libri100_transformer()
        c.model.vocab_size = V_RUNG3
        if impl == "cuda":
            c.model.ffn_impl = "cuda"
        else:
            c.frontend.impl = "torch"
            c.model.attn_impl = c.model.ctc_impl = "torch"
        if dropout is not None:
            c.model.encoder_dropout = c.model.decoder_dropout = dropout
        return c

    m0 = libri100_transformer().model
    L, V = m0.encoder_layers, V_RUNG3
    table = torch.randn(L, m0.encoder_heads, 64, device=dev,
                        generator=gen) * BIAS_STD
    mk = _with_table(AsrModel(cfg("cuda"), device=dev, seed=0).eval(), table)
    mp = plain_subsampling(_with_table(
        AsrModel(cfg("torch"), device=dev, seed=0).eval(), table))
    mc = mk.cfg.model
    check(isinstance(mk.encoder, TransformerEncoder) and mc.attn_impl == "cuda"
          and mc.dtype == "bfloat16" and mk.decoder is not None
          and len(mk.decoder.blocks) == 6, "rung 3 did not build as shipped")
    print(f"[14] rung 3 FFN path: {ffn_path(mk)}; plain: {ffn_path(mp)}",
          flush=True)
    for fn in counted:
        fn.launches = 0
    with torch.inference_mode():
        enc, elens, logits, tokens, tlens = serve(mk, audio, audio_lens)
    torch.cuda.synchronize()
    counts = _launches(counted)
    print(f"[14] rung 3 serving launches: {counts}", flush=True)
    check(counts == {"logmel": 1, "toeplitz_fwd": 1, "attention_fwd": L,
                     "ffn_fwd": L, "subsample": 1},
          f"[14] serving launch counts {counts}")
    T_enc = enc.shape[1]
    check(tuple(enc.shape) == (B, T_enc, mc.encoder_dim)
          and enc.dtype == torch.float32 and T_enc <= 768
          and tuple(logits.shape) == (B, T_enc, V)
          and bool(torch.isfinite(logits).all()),
          f"[14] encoder output {tuple(enc.shape)} {enc.dtype}")
    with torch.inference_mode():
        p_logits = serve(mp, audio, audio_lens)[2]
    compare(f"[14] rung 3 kernels vs plain torch (bf16, {L} L, ragged B={B} "
            f"x {SECONDS:.0f} s, T' {T_enc})", logits, p_logits, elens,
            need_sure=True)
    with torch.no_grad():
        mp.encoder.rel.table.zero_()
    with torch.inference_mode():
        ctl_logits = serve(mp, audio, audio_lens)[2]
    valid = torch.arange(T_enc, device=dev)[None, :] < elens[:, None]
    ctl = (logits - ctl_logits).abs().amax(-1)[valid].max().item()
    print(f"[14] control, plain model with the relative bias zeroed: max "
          f"|dlogit| {ctl:.4f} (must exceed {TOL_LOGITS})", flush=True)
    check(ctl > TOL_LOGITS, "[14] the logit tolerance cannot see the bias")
    toks = tokens[0, :int(tlens[0])].tolist()
    print(f"[14] row 0: {int(elens[0])} frames, {len(toks)} tokens "
          f"{toks[:16]}{' ...' if len(toks) > 16 else ''}", flush=True)
    del mp, p_logits, ctl_logits, enc
    rates = []
    with torch.inference_mode():
        for _ in range(2):
            serve(mk, audio, full_lens)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(WINDOWS):
            t0 = time.perf_counter()
            for _ in range(ITERS):
                serve(mk, audio, full_lens)
            torch.cuda.synchronize()
            rates.append(B * SECONDS * ITERS / (time.perf_counter() - t0))
    print(f"[14] rung 3 serving throughput: median "
          f"{statistics.median(rates):.1f} audio-s/s over {WINDOWS} windows "
          f"of {ITERS} x (B={B} x {SECONDS:.0f} s) (min {min(rates):.1f}, max "
          f"{max(rates):.1f}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card}; "
          f"{time.perf_counter() - t_start:.0f} s since start", flush=True)
    with torch.inference_mode():
        wall_ms, kernel_ms, n = profile_step(
            lambda: serve(mk, audio, full_lens), ITERS)
    print_profile("[14] profile of one rung 3 forward", wall_ms, kernel_ms, n,
                  card)
    # [15] rung 3's beam (no LM), the decode capped at 12 steps
    dcfg = mk.cfg.decode
    dcfg.max_decode_ratio = 12 / T_enc
    beam_decode_phase("rung 3", mk, None, dcfg, audio, audio_lens,
                      torch.Generator(device=dev).manual_seed(14), peaks, card,
                      counted, t_start)
    del mk

    # one hybrid step, U <= 128 BPE tokens of 256, kernels vs plain torch
    tok = 1 + torch.cumsum(torch.randint(1, V - 1, (B, U_RUNG3), device=dev,
                                         generator=gen), 1) % (V - 1)
    tok_lens = torch.minimum(
        torch.randint(U_RUNG3 // 2, U_RUNG3 + 1, (B,), device=dev,
                      generator=gen), elens // 2)
    tok = tok * (torch.arange(U_RUNG3, device=dev)[None, :]
                 < tok_lens[:, None])
    host = lambda t: t.cpu().numpy().astype(np.int32)  # noqa: E731
    batch = Batch(audio.cpu().numpy(), host(audio_lens), host(tok),
                  host(tok_lens))
    ks = make_solver(cfg("cuda", 0.0), V, dev)
    _with_table(ks.model, table)
    for fn in counted:
        fn.launches = 0
    km, kg = ks.grads(batch, spec_mask=spec_mask)
    torch.cuda.synchronize()
    counts = _launches(counted)
    print(f"[14] rung 3 hybrid step launches: {counts}", flush=True)
    check(counts == {"logmel": 1, "toeplitz_fwd": 1, "attention_fwd": L,
                     "attention_bwd": L, "toeplitz_reduce": 1, "ctc_alpha": 1,
                     "ctc_beta": 1, "ffn_fwd": L, "ffn_bwd": L},
          f"[14] step launch counts {counts}")
    kg = {n_: g.detach() for n_, g in zip(ks.names, kg)}
    del ks
    ps = make_solver(cfg("torch", 0.0), V, dev)
    _with_table(ps.model, table)
    pm, pg = ps.grads(batch, spec_mask=spec_mask)
    pg = {n_: g.detach() for n_, g in zip(ps.names, pg)}
    d_loss = abs(float(km["loss"]) - float(pm["loss"])) / float(pm["loss"])
    cmin, rmax, cmed, n_cmp = grad_stats(kg, pg)
    print(f"[14] rung 3 kernels vs plain torch, one hybrid step (B={B} x "
          f"{SECONDS:.0f} s ragged, U<={U_RUNG3}, token lens "
          f"{int(tok_lens.min())}-{int(tok_lens.max())}, bf16, {L} L + 6-layer"
          f" decoder): loss {float(km['loss']):.5f} vs {float(pm['loss']):.5f}"
          f" (ctc {float(km['ctc_loss']):.4f} vs {float(pm['ctc_loss']):.4f}, "
          f"att {float(km['att_loss']):.4f} vs {float(pm['att_loss']):.4f}), "
          f"relative |d loss| {d_loss:.2e} (tol {TOL_TRAIN_LOSS}); gradients "
          f"of {n_cmp} parameters: cosine min {cmin:.5f} median {cmed:.5f} "
          f"(tol {TRAIN_MIN_COS}), relative error max {rmax:.4f} (tol "
          f"{TRAIN_MAX_REL})", flush=True)
    check(all(bool(torch.isfinite(g).all()) for g in kg.values())
          and d_loss <= TOL_TRAIN_LOSS and cmin >= TRAIN_MIN_COS
          and rmax <= TRAIN_MAX_REL, "[14] kernel step disagrees with plain")
    with torch.no_grad():
        ps.model.encoder.rel.table.zero_()
    cm, cg = ps.grads(batch, spec_mask=spec_mask)
    cg = {n_: g.detach() for n_, g in zip(ps.names, cg)}
    c_loss = abs(float(cm["loss"]) - float(km["loss"])) / float(cm["loss"])
    cmin_c, rmax_c, cmed_c, _ = grad_stats(kg, cg)
    print(f"[14] control, plain model with the relative bias zeroed: "
          f"relative |d loss| {c_loss:.2e}, cosine min {cmin_c:.5f} median "
          f"{cmed_c:.5f}, relative error max {rmax_c:.4f} (must fail)",
          flush=True)
    check(c_loss > TOL_TRAIN_LOSS or cmin_c < TRAIN_MIN_COS
          or rmax_c > TRAIN_MAX_REL, "[14] the train-step tolerance cannot "
          "see the bias")
    del ps, pg, cg, kg

    solver = make_solver(cfg("cuda"), V, dev)
    check(solver.cfg.model.encoder_dropout > 0, "[14] dropout is off")
    solver.cfg.train.log_every = 1
    solver.fit(OneBatch(batch), steps=5)
    losses = [r["loss"] for r in solver.log]
    print(f"[14] 5 rung 3 Solver steps (dropout 0.1, SpecAugment): loss "
          f"{[round(v, 4) for v in losses]}, grad_norm "
          f"{[round(r['grad_norm'], 3) for r in solver.log]}", flush=True)
    check(len(losses) == 5 and all(math.isfinite(v) for v in losses)
          and all(bool(torch.isfinite(p).all())
                  for p in solver.model.parameters()), "[14] Solver steps")
    full_batch = Batch(batch.audio, np.full(B, batch.audio.shape[1], np.int32),
                       batch.tokens, batch.token_lens)
    solver.train_step(full_batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rates = []
    for _ in range(TRAIN_WINDOWS):
        t0 = time.perf_counter()
        for _ in range(TRAIN_ITERS):
            solver.train_step(full_batch)
        torch.cuda.synchronize()
        rates.append(B * SECONDS * TRAIN_ITERS / (time.perf_counter() - t0))
    print(f"[14] rung 3 train throughput: median {statistics.median(rates):.1f}"
          f" audio-s/s over {TRAIN_WINDOWS} windows of {TRAIN_ITERS} steps x "
          f"(B={B} x {SECONDS:.0f} s, U={U_RUNG3}) (min {min(rates):.1f}, max "
          f"{max(rates):.1f}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card}; "
          f"{time.perf_counter() - t_start:.0f} s since start", flush=True)
    wall_ms, kernel_ms, n = profile_step(lambda: solver.train_step(full_batch),
                                         1)
    print_profile("[14] profile of one rung 3 train step", wall_ms, kernel_ms,
                  n, card)
    del solver


def start_parent_build():
    """Start nvcc on the parent Toeplitz kernels (the probe
    `csrc/probe/toeplitz_parent.cu`), beside the library's own build:
    (library path, process)."""
    import subprocess
    from pathlib import Path

    from pytorch_end2end_speech_recognition_tpu_torch.ops import _build

    src = Path(__file__).resolve().parent / PKG / "csrc" / "probe" / \
        "toeplitz_parent.cu"
    out = _build.BUILD_ROOT / "probe"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libtoeplitz_parent.so"
    cmd = [_build._nvcc(), *_build.ARCH, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-o", str(lib), str(src)]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


class ParentToeplitz:
    """The parent Toeplitz kernels (before their redesign), for timing in
    turns with the new ones; not counted, not on any path."""

    def __init__(self, lib_path, proc):
        import ctypes

        out, _ = proc.communicate()
        check(proc.returncode == 0, f"the parent Toeplitz probe did not "
              f"build:\n{out}")
        self.lib = ctypes.CDLL(str(lib_path))
        P_, I_ = ctypes.c_void_p, ctypes.c_int
        self.lib.toeplitz_parent_launch.argtypes = [P_, P_, I_, I_, I_, I_, P_]
        self.lib.toeplitz_parent_reduce_launch.argtypes = [
            P_, P_, P_, I_, I_, I_, I_, P_]

    def expand(self, diag, T, P):
        out = torch.empty((diag.shape[0], P, P), dtype=torch.bfloat16,
                          device=diag.device)
        err = self.lib.toeplitz_parent_launch(
            diag.data_ptr(), out.data_ptr(), 1, diag.shape[0], T, P,
            torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"parent toeplitz expand: error {err}")
        return out

    def reduce(self, g, T):
        N, P = g.shape[0], g.shape[1]
        part = torch.empty((-(-T // 64), N, 2 * T - 1), device=g.device)
        out = torch.empty((N, 2 * T - 1), device=g.device)
        err = self.lib.toeplitz_parent_reduce_launch(
            g.data_ptr(), part.data_ptr(), out.data_ptr(), 1, N, T, P,
            torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"parent toeplitz reduce: error {err}")
        return out


def device_ms(fn, name: str) -> float:
    """Device time per call of fn in kernels whose name holds `name`
    (`kernel_split`); where the profiler recorded none of them (it has
    dropped a call's device activity), fn's time by CUDA events, said so."""
    t = sum(t for k, t in kernel_split(fn).items() if name in k)
    if t > 0:
        return t
    print(f"    the profiler recorded no {name} kernel: its device time by "
          f"CUDA events instead", flush=True)
    return cuda_ms(fn)


def toeplitz_expand_phase(tag, diag, T_enc, P, parent, peaks, card) -> dict:
    """[3b] the expand at one shape: bf16 and float32 bit for bit against
    the plain expansion (a gather and a rounding), the bf16 kernel timed in
    turns with the library gather and the parent kernel, its device time,
    and its bound. Returns the kernels-line entry."""
    from pytorch_end2end_speech_recognition_tpu_torch.ops.attention_kernel import (
        toeplitz_expand,
        toeplitz_fwd,
    )

    N, dev = diag.shape[0], diag.device
    errs = []
    for dt in (torch.bfloat16, torch.float32):
        out = toeplitz_fwd(diag, T_enc, P, dt)
        ref = toeplitz_expand(diag, P, P, T=T_enc).to(dt)
        torch.cuda.synchronize()
        n_bits = bits_differ((out,), (ref,))
        err = (out.float() - ref.float()).abs().max().item()
        errs.append(err)
        print(f"[3b] toeplitz expand {tag} {str(dt)[6:]}: elements whose "
              f"bits differ from the plain expansion {n_bits} of "
              f"{out.numel()} (must be 0), max |kernel - plain| {err:.3e}",
              flush=True)
        check(n_bits == 0 and err <= TOL_TOEPLITZ,
              f"toeplitz expand {tag} {dt} disagrees ({n_bits})")
        del ref
    dt = torch.bfloat16
    out = toeplitz_fwd(diag, T_enc, P, dt)
    check(torch.equal(parent.expand(diag, T_enc, P), out),
          f"toeplitz expand {tag}: the parent kernel differs")
    # the library yardstick: one advanced-indexing gather of the diagonals
    # (rounded to bf16 beforehand, as rounding commutes with a gather) by a
    # precomputed (P, P) index
    ii = torch.arange(P, device=dev)
    idx = torch.clamp((T_enc - 1) + ii[None, :] - ii[:, None], 0,
                      2 * T_enc - 2)
    diag_b = diag.to(dt)
    check(torch.equal(diag_b[:, idx], out),
          "toeplitz: the library gather differs from the kernel")
    turns = turns_ms({"kernel": lambda: toeplitz_fwd(diag, T_enc, P, dt),
                      "library": lambda: diag_b[:, idx],
                      "parent": lambda: parent.expand(diag, T_enc, P)})
    dev_ms = device_ms(lambda: toeplitz_fwd(diag, T_enc, P, dt),
                       "toeplitz_expand")
    b_ms, b_by = bound(nbytes(diag, out), 0.0, peaks)
    print(f"[3b] toeplitz expand {tag} (N {N}, T {T_enc}, P {P}, bf16): "
          f"kernel {turns['kernel']:.4f} ms (device {dev_ms:.4f}), library "
          f"gather diag[:, idx] {turns['library']:.4f} ms, parent kernel "
          f"{turns['parent']:.4f} ms (medians of 5 windows x 50 launches in "
          f"turns), bound {b_ms:.4f} ms ({b_by}), bound / kernel "
          f"{b_ms / turns['kernel']:.3f} (device {b_ms / dev_ms:.3f}); {card}",
          flush=True)
    return dict(
        name="toeplitz", route="cuda", source=f"{PKG}/csrc/toeplitz.cu",
        replaces="pytorch_end2end_speech_recognition_tpu/ops/"
                 "attention_pallas.py:424",
        max_abs_err=max(errs), ms=turns["kernel"],
        plain_ms=cuda_ms(lambda: toeplitz_expand(diag, P, P, T=T_enc).to(dt)),
        bound_ms=b_ms, bound_by=b_by, library_ms=turns["library"])


def toeplitz_reduce_phase(tag, core, P, pad_gen, parent, peaks, card) -> dict:
    """[3d] the reduce at one shape: the cotangent (N, P, P) bf16 holds
    `core` (N, T, T) and a zero pad band (as the attention backward leaves
    it), and again a random pad band drawn from pad_gen (which the reduce
    must not read): two launches bit for bit, every diagonal within T u
    sum|g| of the plain sums; timed in turns with `index_add_` and the
    parent kernel. Returns the kernels-line entry."""
    from pytorch_end2end_speech_recognition_tpu_torch.ops.attention_kernel import (
        toeplitz_reduce,
        toeplitz_reduce_plain,
    )

    N, T_enc = core.shape[0], core.shape[1]
    dev = core.device
    g_bias = torch.zeros(N, P, P, device=dev, dtype=torch.bfloat16)
    g_bias[:, :T_enc, :T_enc] = core.to(torch.bfloat16)
    noisy = torch.randn(N, P, P, device=dev, generator=pad_gen).to(
        torch.bfloat16)
    noisy[:, :T_enc, :T_enc] = g_bias[:, :T_enc, :T_enc]
    red = toeplitz_reduce(g_bias, T_enc)
    n_diff = bits_differ((red,), (toeplitz_reduce(g_bias, T_enc),))
    print(f"[3d] toeplitz reduce {tag} determinism: two launches differ in "
          f"{n_diff} of {red.numel()} elements (must be 0)", flush=True)
    check(n_diff == 0, "toeplitz reduce is not deterministic")
    red_ref = toeplitz_reduce_plain(g_bias, T_enc)
    red_tol = T_enc * 2.0 ** -24 * toeplitz_reduce_plain(g_bias.abs(), T_enc)
    err = (red - red_ref).abs()
    share = (err > red_tol).float().mean().item()
    pad_share = ((toeplitz_reduce(noisy, T_enc) - red_ref).abs()
                 > red_tol).float().mean().item()
    print(f"[3d] toeplitz reduce {tag}: max |kernel - plain| = "
          f"{err.max().item():.3e}, share beyond T u sum|g|: {share:.3e}; "
          f"with a random pad band: {pad_share:.3e} (both must be 0)",
          flush=True)
    check(share == 0.0 and pad_share == 0.0,
          f"toeplitz reduce {tag} disagrees ({share}, {pad_share})")
    par_share = ((parent.reduce(g_bias, T_enc) - red_ref).abs()
                 > red_tol).float().mean().item()
    check(par_share == 0.0, f"toeplitz reduce {tag}: the parent kernel "
          f"disagrees ({par_share})")
    # the library yardstick: one index_add_ of the T x T core by the same
    # precomputed diagonal index, into a zeroed output (index_add_ takes
    # one dtype, so the core is a float32 copy made beforehand)
    ii = torch.arange(T_enc, device=dev)
    idx_r = ((T_enc - 1) + ii[None, :] - ii[:, None]).reshape(-1)
    g32 = g_bias[:, :T_enc, :T_enc].float().reshape(N, -1).contiguous()

    def reduce_library():
        return torch.zeros(N, 2 * T_enc - 1, device=dev).index_add_(
            1, idx_r, g32)

    lib_share = ((reduce_library() - red_ref).abs() > red_tol).float() \
        .mean().item()
    check(lib_share == 0.0, "toeplitz reduce: the library index_add_ is "
          f"beyond the bound ({lib_share})")
    turns = turns_ms({"kernel": lambda: toeplitz_reduce(g_bias, T_enc),
                      "library": reduce_library,
                      "parent": lambda: parent.reduce(g_bias, T_enc)})
    dev_ms = device_ms(lambda: toeplitz_reduce(g_bias, T_enc),
                       "toeplitz_reduce")
    b_ms, b_by = bound(N * T_enc * T_enc * 2 + nbytes(red), 0.0, peaks)
    print(f"[3d] toeplitz reduce {tag} (N {N}, T {T_enc}, P {P}, bf16): kernel "
          f"{turns['kernel']:.4f} ms (device {dev_ms:.4f}), library index_add_ "
          f"(float32 core) {turns['library']:.4f} ms, parent kernels "
          f"{turns['parent']:.4f} ms (medians of 5 windows x 50 launches in "
          f"turns), bound {b_ms:.4f} ms ({b_by}), bound / kernel "
          f"{b_ms / turns['kernel']:.3f} (device {b_ms / dev_ms:.3f}); {card}",
          flush=True)
    return dict(
        name="toeplitz_reduce", route="cuda", source=f"{PKG}/csrc/toeplitz.cu",
        replaces="pytorch_end2end_speech_recognition_tpu/ops/"
                 "attention_pallas.py:458",
        max_abs_err=err.max().item(), ms=turns["kernel"],
        plain_ms=cuda_ms(lambda: toeplitz_reduce_plain(g_bias, T_enc)),
        bound_ms=b_ms, bound_by=b_by, library_ms=turns["library"])


def prefix_tol(T: int) -> float:
    """PREFIX_STEP_TOL over T frames (see PREFIX_STEP_TOL)."""
    return T * PREFIX_STEP_TOL


def prefix_excess(got, want, T) -> float:
    """Largest |got - want| / (prefix_tol(T) (1 + |want|)): at most 1."""
    return ((got - want).abs() / (prefix_tol(T) * (1 + want.abs()))).max() \
        .item()


def prefix_kernel_phase(tag, lp, K, Pk, gen, peaks, card):
    """[15] the prefix kernels against their plain versions on the card, at
    one model's lattice: lp (B, T', V) the CTC log-probs of its encoder
    output with pad frames blank-certain, K hypotheses, Pk candidates each,
    over two steps of made-up beam state: every hypothesis extended by one
    of its candidates from the empty prefix (select), then Pk candidates of
    each, one of them its last token, scored (score), then a mix of
    extended and kept hypotheses from random parents (select). psi and the
    columns within PREFIX_STEP_TOL T' (1 + |plain|); two launches bit for
    bit; the control, the last select's plain version with the blank term
    dropped (blank log-probs 0), must exceed the bound. Returns (score entry, select
    entry) for the kernels line, and the largest excess."""
    from pytorch_end2end_speech_recognition_tpu_torch.ops.ctc_prefix import (
        NEG_INF,
        ctc_prefix_score,
        ctc_prefix_select,
        prefix_recursion_plain,
        prefix_select_plain,
    )

    B, T, V = lp.shape
    dev = lp.device

    def candidates():
        return torch.rand(B, K, V - 2, device=dev, generator=gen).argsort(
            -1)[..., :Pk] + 2

    r0 = torch.stack([torch.full((B, T), NEG_INF, device=dev),
                      torch.cumsum(lp[:, :, 0], 1)], -1)[:, None].repeat(
                          1, K, 1, 1).contiguous()
    last0 = torch.full((B, K), 1, device=dev, dtype=torch.long)
    len0 = torch.zeros((B, K), device=dev, dtype=torch.long)
    cand0 = candidates()
    keep = torch.arange(K, device=dev)[None, :].expand(B, K).contiguous()
    tok1 = cand0.gather(2, torch.randint(0, Pk, (B, K, 1), device=dev,
                                         generator=gen))[..., 0]
    ext = torch.ones((B, K), dtype=torch.bool, device=dev)
    r1 = prefix_select_plain(lp, r0, last0, len0, keep, tok1, ext)
    r1_k = ctc_prefix_select(lp, r0, last0, len0, keep, tok1, ext)
    cand1 = candidates()
    cand1[:, :, 0] = tok1                      # the last token again
    len1 = torch.ones_like(len0)
    psi = prefix_recursion_plain(lp, r1, cand1, tok1, len1)[0]
    psi_k = ctc_prefix_score(lp, r1, tok1, len1, cand1)
    parent2 = torch.randint(0, K, (B, K), device=dev, generator=gen)
    ext2 = torch.rand(B, K, device=dev, generator=gen) < 0.7
    tok2 = cand1.gather(1, parent2[..., None].expand(B, K, Pk)).gather(
        2, torch.randint(0, Pk, (B, K, 1), device=dev, generator=gen))[..., 0]
    r2 = prefix_select_plain(lp, r1, tok1, len1, parent2, tok2, ext2)
    r2_k = ctc_prefix_select(lp, r1, tok1, len1, parent2, tok2, ext2)
    torch.cuda.synchronize()
    ex = {"select, from the empty prefix": prefix_excess(r1_k, r1, T),
          "score": prefix_excess(psi_k, psi, T),
          "select, mixed": prefix_excess(r2_k, r2, T)}
    n_bits = bits_differ((psi_k, r2_k), (
        ctc_prefix_score(lp, r1, tok1, len1, cand1),
        ctc_prefix_select(lp, r1, tok1, len1, parent2, tok2, ext2)))
    # psi reads the blank term only through the columns a select wrote
    no_blank = lp.clone()
    no_blank[:, :, 0] = 0.0
    ctl = prefix_excess(r2_k, prefix_select_plain(no_blank, r1, tok1, len1,
                                                  parent2, tok2, ext2), T)
    err = max((psi_k - psi).abs().max().item(),
              (r2_k - r2).abs().max().item())
    print(f"[15] {tag} prefix kernels vs plain (B {B}, T' {T}, V {V}, K {K}, "
          f"{Pk} candidates): " + ", ".join(
              f"{k} {v:.3e}" for k, v in ex.items())
          + f" of the bound T' 2^-22 (1 + |plain|) (each must be <= 1); max "
          f"|kernel - plain| {err:.3e}; two launches differ in {n_bits} "
          f"elements (must be 0); control, the blank term dropped: "
          f"{ctl:.3e} of the bound (must exceed 1)", flush=True)
    check(all(v <= 1.0 for v in ex.values()) and n_bits == 0 and ctl > 1.0,
          f"[15] {tag} prefix kernels disagree with plain ({ex}, {n_bits}, "
          f"{ctl})")
    # times and bounds: the bytes the chains need (r once; each row's lp
    # columns of the tokens it scores and its blank column once; the
    # outputs once) and their float32 operations (3 log_adds of ~8 and 3
    # adds a chain step) at the float32 rate
    uniq = sum(int(torch.unique(cand1[b]).numel()) + 1 for b in range(B))
    s_ms = cuda_ms(lambda: ctc_prefix_score(lp, r1, tok1, len1, cand1))
    s_plain = cuda_ms(lambda: prefix_recursion_plain(lp, r1, cand1, tok1,
                                                     len1), iters=2, warmup=1)
    s_b, s_by = bound(T * uniq * 4 + nbytes(r1, cand1, psi),
                      27.0 * B * K * Pk * T / peaks["fp32_flops"], peaks)
    n_ext = int(ext2.sum())
    uniq2 = sum(int(torch.unique(tok2[b][ext2[b]]).numel()) + 1
                for b in range(B))
    x_ms = cuda_ms(lambda: ctc_prefix_select(lp, r1, tok1, len1, parent2,
                                             tok2, ext2))
    x_plain = cuda_ms(lambda: prefix_select_plain(
        lp, r1, tok1, len1, parent2, tok2, ext2), iters=2, warmup=1)
    x_b, x_by = bound(T * uniq2 * 4 + 2 * nbytes(r2),
                      27.0 * n_ext * T / peaks["fp32_flops"], peaks)
    print(f"[15] {tag} prefix score kernel {s_ms:.4f} ms (plain {s_plain:.3f}"
          f" ms, bound {s_b:.4f} ms by {s_by}; {s_ms * 1e3 / T:.3f} us a "
          f"dependent step); select kernel {x_ms:.4f} ms (plain "
          f"{x_plain:.3f} ms, bound {x_b:.4f} ms by {x_by}; "
          f"{x_ms * 1e3 / T:.3f} us a step); {card}", flush=True)
    src = f"{PKG}/csrc/ctc_prefix.cu"
    rep = "pytorch_end2end_speech_recognition_tpu/decode/beam.py:204"
    return (dict(name="ctc_prefix_score", route="cuda", source=src,
                 replaces=rep, max_abs_err=(psi_k - psi).abs().max().item(),
                 ms=s_ms, plain_ms=s_plain, bound_ms=s_b, bound_by=s_by,
                 library_ms=None),
            dict(name="ctc_prefix_select", route="cuda", source=src,
                 replaces=rep, max_abs_err=(r2_k - r2).abs().max().item(),
                 ms=x_ms, plain_ms=x_plain, bound_ms=x_b, bound_by=x_by,
                 library_ms=None), max(ex.values()))


def beam_decode_phase(tag, model, lm, dcfg, audio, lens, gen, peaks, card,
                      counted, t_start):
    """[15] beam decode at one model's full width, ids level: encode, the
    prefix kernels against their plain versions at its lattice
    (`prefix_kernel_phase`), the decode through the kernels (launch counts:
    one score and one select a token step) against the same decode with
    the plain prefix scorer (tokens, lengths and finished flags equal on
    every row, scores within ctc_weight T' 2^-22 (1 + |score|)), a search
    of SYNC_EVERY steps with no host sync (under the sync debugger's error
    mode, with a control that must raise), decode audio-s/s and launches per token step (torch.profiler). The decode
    length is capped by `dcfg.max_decode_ratio` (random weights rarely
    choose eos). Returns the prefix kernels' entries and the launch counts
    of the counted decode."""
    from pytorch_end2end_speech_recognition_tpu_torch.decode import beam as beam_mod
    from pytorch_end2end_speech_recognition_tpu_torch.decode.beam import (
        BeamSearchDecoder,
        blank_padded,
    )

    bsd = BeamSearchDecoder(model, dcfg, lm=lm)
    check(bsd.prefix_kernel, f"[15] {tag}: the prefix scorer is not on the "
          "kernels")
    enc, elens, logp = bsd.encode(audio, lens)
    B_, T = enc.shape[:2]
    V = logp.shape[-1]
    K, Pk = dcfg.beam_size, min(dcfg.pre_beam_k, V - 2)
    max_len = max(4, int(dcfg.max_decode_ratio * T))
    entries = prefix_kernel_phase(tag, blank_padded(logp, elens), K, Pk, gen,
                                  peaks, card)
    for fn in counted:
        fn.launches = 0
    out = bsd.search_arrays(enc, elens, logp, max_len)
    torch.cuda.synchronize()
    counts = _launches(counted)
    steps = out["steps"]
    print(f"[15] {tag} beam decode launches (B {B_}, T' {T}, K {K}, {Pk} "
          f"candidates, ctc_weight {dcfg.ctc_weight}, lm_weight "
          f"{dcfg.lm_weight if lm is not None else 0}, max_len {max_len} = "
          f"max(4, {dcfg.max_decode_ratio} T'), {steps} steps): {counts}",
          flush=True)
    want = ({"ctc_prefix_score": steps, "ctc_prefix_select": steps}
            if dcfg.ctc_weight > 0 else {})
    check(counts == want, f"[15] {tag} decode launch counts {counts}")
    plain = BeamSearchDecoder(model, dcfg, lm=lm, prefix_impl="torch") \
        .search_arrays(enc, elens, logp, max_len)
    same = {k: int((out[k] == plain[k]).reshape(B_, -1).all(-1).sum())
            for k in ("tokens", "lengths", "finished")}
    d_score = (out["scores"] - plain["scores"]).abs()
    s_exc = (d_score / (dcfg.ctc_weight * prefix_tol(T)
                        * (1 + plain["scores"].abs()))).max().item()
    print(f"[15] {tag} kernels vs plain prefix scorer, whole decode: rows of "
          f"{B_} with equal N-best " + ", ".join(
              f"{k} {v}" for k, v in same.items())
          + f" (each must be {B_}); max |d score| "
          f"{d_score.max().item():.3e}, {s_exc:.3e} of the bound ctc_weight "
          f"T' 2^-22 (1 + |score|) (must be <= 1)", flush=True)
    check(all(v == B_ for v in same.values()) and s_exc <= 1.0,
          f"[15] {tag}: the decode on the kernels differs from the plain "
          f"prefix scorer ({same}, {s_exc})")
    # no host sync in the token loop: a search of SYNC_EVERY steps (which
    # never tests "all finished") under the sync debugger's error mode; the
    # control, a .item() under the same mode, must raise
    n_sync = beam_mod.SYNC_EVERY
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        try:
            torch.ones((), device=enc.device).item()
            caught = False
        except RuntimeError:
            caught = True
        quiet = bsd.search_arrays(enc, elens, logp, n_sync)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"[15] {tag} {quiet['steps']} token steps under "
          f"torch.cuda.set_sync_debug_mode('error'): no host sync; control, "
          f"a .item() under the same mode raised: {caught} (must be True)",
          flush=True)
    check(caught and quiet["steps"] == n_sync,
          f"[15] {tag}: the sync check is blind or the loop stopped early")
    toks = out["tokens"][0, 0, :int(out["lengths"][0, 0])].tolist()
    print(f"[15] {tag} row 0 best: {toks[:16]}"
          f"{' ...' if len(toks) > 16 else ''}, score "
          f"{float(out['scores'][0, 0]):.3f}", flush=True)
    secs = float(lens.sum()) / SR
    rates = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e2, l2, p2 = bsd.encode(audio, lens)
        bsd.search_arrays(e2, l2, p2, max_len)
        torch.cuda.synchronize()
        rates.append(secs / (time.perf_counter() - t0))
    wall_ms, kernel_ms, n = profile_step(
        lambda: bsd.search_arrays(enc, elens, logp, max_len), 1)
    busy = sum(kernel_ms.values())
    print(f"[15] {tag} decode (encode + {steps}-step beam search, B {B_}, "
          f"{secs:.1f} audio-s): median {statistics.median(rates):.1f} "
          f"audio-s/s of 3 (min {min(rates):.1f}, max {max(rates):.1f}); the "
          f"search alone under torch.profiler: wall {wall_ms:.1f} ms, device "
          f"busy {busy:.1f} ms (idle share {1 - busy / wall_ms:.3f}), "
          f"{n / steps:.0f} device kernels a token step, "
          f"{wall_ms / steps:.2f} ms a step; {card}; "
          f"{time.perf_counter() - t_start:.0f} s since start", flush=True)
    return entries, counts


def beam_phase(dev, gen, peaks, card, counted, t_start):
    """[15] beam decode for wsj_las (the LSTM speller, no LM) on a ragged
    B=32 batch of 8-16 s rows (T' 50), its decode capped at 12 steps."""
    from pytorch_end2end_speech_recognition_tpu_torch.configs.presets import (
        wsj_las,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.models.asr import AsrModel

    cfg = wsj_las()
    check(cfg.decode.mode == "beam" and cfg.decode.beam_size == 10,
          "wsj_las does not decode with beam 10")
    model = AsrModel(cfg, device=dev, seed=0).eval()
    Ts = LAS_SECONDS * SR
    audio = speechlike(B, Ts, gen, dev)
    lens = torch.randint(LAS_SECONDS // 2 * SR, Ts + 1, (B,), device=dev,
                         generator=gen)
    lens[0] = Ts
    audio = audio * (torch.arange(Ts, device=dev)[None, :] < lens[:, None])
    cfg.decode.max_decode_ratio = 12 / 50
    beam_decode_phase("wsj_las", model, None, cfg.decode, audio, lens, gen,
                      peaks, card, counted, t_start)


def rung4_phase(dev, gen, peaks, card, kernels, counted, t_start, audio,
                audio_lens, full_lens, spec_mask) -> None:
    """[16] libri960_conformer (rung 4: 16-layer Conformer d512, H8, FFN
    2,048, subsampling channels 128; 6-layer transformer decoder d512;
    vocab 1,024) at full width on the ragged B=32 x 30 s batch: serving
    launch counts, logits against plain torch with a bias-zeroed control,
    throughput and a profile; [15] its beam decode with the RnnLm (2 x 650)
    at lm_weight 0.3; one hybrid step at B=16 x 30 s (U <= 128) against
    plain torch with [8]'s tolerances and a control, launch counts, peak
    memory and a profile."""
    from pytorch_end2end_speech_recognition_tpu_torch.configs.presets import (
        libri960_conformer,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.data.dataset import Batch
    from pytorch_end2end_speech_recognition_tpu_torch.models.asr import AsrModel
    from pytorch_end2end_speech_recognition_tpu_torch.models.encoders import (
        ConformerEncoder,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.models.lm import (
        RnnLm,
        build_lm,
    )

    def cfg(impl: str, dropout: float | None = None):
        c = libri960_conformer()
        c.model.vocab_size = V_RUNG4
        if impl == "torch":
            c.frontend.impl = "torch"
            c.model.attn_impl = c.model.ctc_impl = "torch"
        if dropout is not None:
            c.model.encoder_dropout = c.model.decoder_dropout = dropout
        return c

    m0 = cfg("cuda").model
    L, H, V = m0.encoder_layers, m0.encoder_heads, V_RUNG4
    table = torch.randn(L, H, 64, device=dev, generator=gen) * BIAS_STD
    mk = _with_table(AsrModel(cfg("cuda"), device=dev, seed=0).eval(), table)
    mp = plain_subsampling(_with_table(
        AsrModel(cfg("torch"), device=dev, seed=0).eval(), table))
    mc = mk.cfg.model
    check(isinstance(mk.encoder, ConformerEncoder) and mc.encoder_dim == 512
          and H == 8 and L == 16 and mc.subsample_channels == 128
          and mc.attn_impl == "cuda" and mc.dtype == "bfloat16"
          and len(mk.decoder.blocks) == 6 and mc.decoder_dim == 512,
          "rung 4 did not build as shipped")
    n_par = sum(p.numel() for p in mk.parameters())
    print(f"[16] rung 4: {n_par / 1e6:.1f} M parameters; FFN path: "
          f"{ffn_path(mk)}", flush=True)
    for fn in counted:
        fn.launches = 0
    with torch.inference_mode():
        enc, elens, logits, tokens, tlens = serve(mk, audio, audio_lens)
    torch.cuda.synchronize()
    counts = _launches(counted)
    print(f"[16] rung 4 serving launches: {counts}", flush=True)
    check(counts == {"logmel": 1, "toeplitz_fwd": 1, "attention_fwd": L,
                     "subsample": 1}, f"[16] serving launch counts {counts}")
    T_enc = enc.shape[1]
    check(tuple(logits.shape) == (B, T_enc, V) and T_enc <= 768
          and bool(torch.isfinite(logits).all()),
          f"[16] logits {tuple(logits.shape)}")
    with torch.inference_mode():
        p_logits = serve(mp, audio, audio_lens)[2]
    compare(f"[16] rung 4 kernels vs plain torch (bf16, {L} L d512 H8, "
            f"ragged B={B} x {SECONDS:.0f} s, T' {T_enc})", logits, p_logits,
            elens, need_sure=True)
    with torch.no_grad():
        mp.encoder.rel.table.zero_()
    with torch.inference_mode():
        ctl_logits = serve(mp, audio, audio_lens)[2]
    valid = torch.arange(T_enc, device=dev)[None, :] < elens[:, None]
    ctl = (logits - ctl_logits).abs().amax(-1)[valid].max().item()
    print(f"[16] control, plain model with the relative bias zeroed: max "
          f"|dlogit| {ctl:.4f} (must exceed {TOL_LOGITS})", flush=True)
    check(ctl > TOL_LOGITS, "[16] the logit tolerance cannot see the bias")
    del mp, p_logits, ctl_logits, enc, logits
    rates = []
    with torch.inference_mode():
        serve(mk, audio, full_lens)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(ITERS):
                serve(mk, audio, full_lens)
            torch.cuda.synchronize()
            rates.append(B * SECONDS * ITERS / (time.perf_counter() - t0))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        wall_ms, kernel_ms, n = profile_step(
            lambda: serve(mk, audio, full_lens), ITERS)
    print(f"[16] rung 4 serving throughput: median "
          f"{statistics.median(rates):.1f} audio-s/s over 3 windows of "
          f"{ITERS} x (B={B} x {SECONDS:.0f} s) (min {min(rates):.1f}, max "
          f"{max(rates):.1f}); peak memory {peak:.2f} GiB; {card}", flush=True)
    print_profile("[16] profile of one rung 4 forward", wall_ms, kernel_ms, n,
                  card)

    # [15] rung 4's beam with its RnnLm, the decode capped at 12 steps
    lm = build_lm(mk.cfg.model, device=dev, seed=1).eval()
    check(isinstance(lm, RnnLm) and mk.cfg.decode.lm_weight == 0.3
          and mk.cfg.model.lm_dim == 650 and len(lm.cells) == 2,
          "rung 4's LM is not the 2 x 650 RnnLm at lm_weight 0.3")
    dcfg = mk.cfg.decode
    dcfg.max_decode_ratio = 12 / T_enc
    entries, launches = beam_decode_phase(
        "rung 4 (RnnLm)", mk, lm, dcfg, audio, audio_lens, gen, peaks, card,
        counted, t_start)
    for e in entries[:2]:
        e["launches"] = launches.get(e["name"], 0)
        kernels[e["name"]] = e
    del mk, lm

    # one hybrid step at B=16 x 30 s, U <= 128, kernels vs plain torch
    Bt = B // 2
    nf = (audio_lens[:Bt] - WIN) // HOP + 1
    enc_lens = ((nf + 1) // 2 + 1) // 2
    tok = 1 + torch.cumsum(torch.randint(1, V - 1, (Bt, U_RUNG4), device=dev,
                                         generator=gen), 1) % (V - 1)
    tok_lens = torch.minimum(
        torch.randint(U_RUNG4 // 2, U_RUNG4 + 1, (Bt,), device=dev,
                      generator=gen), enc_lens // 2)
    tok = tok * (torch.arange(U_RUNG4, device=dev)[None, :]
                 < tok_lens[:, None])
    host = lambda t: t.cpu().numpy().astype(np.int32)  # noqa: E731
    batch = Batch(audio[:Bt].cpu().numpy(), host(audio_lens[:Bt]), host(tok),
                  host(tok_lens))
    mask = spec_mask[:Bt]
    ks = make_solver(cfg("cuda", 0.0), V, dev)
    _with_table(ks.model, table)
    for fn in counted:
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    km, kg = ks.grads(batch, spec_mask=mask)
    torch.cuda.synchronize()
    k_peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    counts = _launches(counted)
    print(f"[16] rung 4 hybrid step launches: {counts}", flush=True)
    check(counts == {"logmel": 1, "toeplitz_fwd": 1, "attention_fwd": L,
                     "attention_bwd": L, "toeplitz_reduce": 1, "ctc_alpha": 1,
                     "ctc_beta": 1}, f"[16] step launch counts {counts}")
    kg = {n_: g.detach() for n_, g in zip(ks.names, kg)}
    wall_ms, kernel_ms, n = profile_step(lambda: ks.grads(batch,
                                                          spec_mask=mask), 1)
    del ks
    ps = make_solver(cfg("torch", 0.0), V, dev)
    _with_table(ps.model, table)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    pm, pg = ps.grads(batch, spec_mask=mask)
    torch.cuda.synchronize()
    p_peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    pg = {n_: g.detach() for n_, g in zip(ps.names, pg)}
    d_loss = abs(float(km["loss"]) - float(pm["loss"])) / float(pm["loss"])
    cmin, rmax, cmed, n_cmp = grad_stats(kg, pg)
    print(f"[16] rung 4 kernels vs plain torch, one hybrid step (B={Bt} x "
          f"{SECONDS:.0f} s ragged, U<={U_RUNG4}, vocab {V}, bf16, {L} L + "
          f"6-layer decoder; step peak memory {k_peak:.2f} GiB with the "
          f"kernels, {p_peak:.2f} GiB plain): loss {float(km['loss']):.5f} vs "
          f"{float(pm['loss']):.5f} (ctc {float(km['ctc_loss']):.4f} vs "
          f"{float(pm['ctc_loss']):.4f}, att {float(km['att_loss']):.4f} vs "
          f"{float(pm['att_loss']):.4f}), relative |d loss| {d_loss:.2e} (tol "
          f"{TOL_TRAIN_LOSS}); gradients of {n_cmp} parameters: cosine min "
          f"{cmin:.5f} median {cmed:.5f} (tol {TRAIN_MIN_COS}), relative "
          f"error max {rmax:.4f} (tol {TRAIN_MAX_REL})", flush=True)
    check(all(bool(torch.isfinite(g).all()) for g in kg.values())
          and d_loss <= TOL_TRAIN_LOSS and cmin >= TRAIN_MIN_COS
          and rmax <= TRAIN_MAX_REL, "[16] kernel step disagrees with plain")
    with torch.no_grad():
        ps.model.encoder.rel.table.zero_()
    cm, cg = ps.grads(batch, spec_mask=mask)
    cg = {n_: g.detach() for n_, g in zip(ps.names, cg)}
    c_loss = abs(float(cm["loss"]) - float(km["loss"])) / float(cm["loss"])
    cmin_c, rmax_c, cmed_c, _ = grad_stats(kg, cg)
    print(f"[16] control, plain model with the relative bias zeroed: "
          f"relative |d loss| {c_loss:.2e}, cosine min {cmin_c:.5f} median "
          f"{cmed_c:.5f}, relative error max {rmax_c:.4f} (must fail)",
          flush=True)
    check(c_loss > TOL_TRAIN_LOSS or cmin_c < TRAIN_MIN_COS
          or rmax_c > TRAIN_MAX_REL, "[16] the train-step tolerance cannot "
          "see the bias")
    del ps, pg, cg, kg
    print_profile(f"[16] profile of one rung 4 hybrid step (B={Bt}, forward "
                  "and backward)", wall_ms, kernel_ms, n, card)
    print(f"[16] done; {time.perf_counter() - t_start:.0f} s since start",
          flush=True)


def trainer_phase(dev, card, counted, t_start):
    """[17] the trainer from a manifest: `cli.train.main` in process on the
    flagship at full width (bf16, the kernels, SpecAugment and dropout on),
    the phrases corpus (512 train and 64 dev utterances of 2.1-3.9 s), 20
    steps with dev evaluations at 10 and 20, then `--resume` to 30. Checks:
    launch counts of every train step and dev forward, none of the plain
    versions; every array that `_put` copies in two fit steps is pinned
    (the profiler's memcpy kinds a second witness), with a pageable
    control that must fail, and the copied batches equal to the loader's; a checkpoint round trip bit for bit; the resumed run's first
    batch, SpecAugment mask and loss against the uninterrupted run's step
    21, with a fresh-generator control that must fail; the checkpoint
    directory's files; the plateau decay against the dev records; the
    vocabulary guard; dev logits of the kernels against plain torch, and
    both WERs; time warp on the card against the CPU. Printed, not gated:
    audio-s/s of fit against a plain pageable loop (5 pairs of turns in
    alternating order), idle share, the batch copy's share of busy time
    pinned and pageable, and the host syncs of one step."""
    import itertools
    import tempfile
    import warnings

    from pytorch_end2end_speech_recognition_tpu_torch.cli import train as cli
    from pytorch_end2end_speech_recognition_tpu_torch.data.dataset import (
        BucketedLoader,
        pin_batch,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.data.manifest import (
        read_manifest,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.data.synthetic import (
        make_phrases_corpus,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.data.tokenizer import (
        CharTokenizer,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.models import (
        encoders as tenc,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops import (
        attention_kernel as tak,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops import ctc as tctc
    from pytorch_end2end_speech_recognition_tpu_torch.ops import frontend as fe
    from pytorch_end2end_speech_recognition_tpu_torch.ops import (
        specaugment as sa,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.training.solver import (
        Solver,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
        resolve_device,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.utils.metrics_log import (
        MetricsLogger,
    )

    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_17_"))
    corpus = make_phrases_corpus(tmp / "corpus", n_train=512, n_dev=64,
                                 n_test=1, seed=0)
    ckpt = tmp / "ckpt"
    args = ["--config", "flagship_conformer",
            "--set", f"data.train_manifest={corpus['train']}",
            "--set", f"data.dev_manifest={corpus['dev']}",
            "--set", "data.batch_size=32",
            "--set", "data.batch_frames=15360000",
            "--set", "train.eval_every=10", "--set", "train.log_every=5",
            "--set", "train.keep_checkpoints=2",
            "--set", "train.schedule=plateau",
            "--set", "train.plateau_patience=1",
            "--set", f"train.checkpoint_dir={ckpt}",
            "--set", f"train.metrics_path={ckpt / 'metrics.jsonl'}"]
    print(f"[17] phrases corpus of 512 + 64 utterances written in "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)

    # every train step's and dev forward's launches, from the kernels'
    # counters and from counters put on the plain versions the path would
    # take off the card; the mask and loss of each step 21
    plain = {"logmel_plain": (fe, "logmel_plain"),
             "attention_plain": (tak, "attention_plain"),
             "toeplitz_expand": (tenc, "toeplitz_expand"),
             "ctc_alpha_plain": (tctc, "ctc_alpha_plain")}
    plain_calls = dict.fromkeys(plain, 0)
    saved = {k: getattr(m, a) for k, (m, a) in plain.items()}

    def counting(key):
        def call(*a, **kw):
            plain_calls[key] += 1
            return saved[key](*a, **kw)
        return call

    def snap():
        return {**{f.__name__: f.launches for f in counted}, **plain_calls}

    per_step, per_dev, step21 = [], [], []
    last_mask = []
    orig_step, orig_greedy = Solver.train_step, Solver.greedy_ids
    orig_mask = sa.spec_augment_mask

    def mask_rec(*a, **kw):
        m = orig_mask(*a, **kw)
        last_mask[:] = [m]
        return m

    def step_rec(self, batch, *a, **kw):
        before = snap()
        m = orig_step(self, batch, *a, **kw)
        after = snap()
        per_step.append({k: after[k] - before[k] for k in after
                         if after[k] != before[k]})
        if self.step == 21:
            step21.append((self, list(batch.ids), last_mask[0].clone(),
                           float(m["loss"])))
        return m

    def greedy_rec(self, batch):
        before = snap()
        out = orig_greedy(self, batch)
        after = snap()
        per_dev.append({k: after[k] - before[k] for k in after
                        if after[k] != before[k]})
        return out

    for key, (mod, attr) in plain.items():
        setattr(mod, attr, counting(key))
    sa.spec_augment_mask = mask_rec
    Solver.train_step, Solver.greedy_ids = step_rec, greedy_rec
    try:
        t0 = time.perf_counter()
        run1 = cli.main(args + ["--set", "train.steps=20"])
        t_run1 = time.perf_counter() - t0
        n_step1, n_dev1 = len(per_step), len(per_dev)
        # the uninterrupted run goes on to step 21, logging nowhere (the
        # CLI closed its file); other Solvers below write no metrics file
        tok = run1.tokenizer
        cfg = resolve_device(run1.cfg, dev)
        cfg.train.metrics_path = ""
        run1.logger = MetricsLogger(None, echo=False)
        train_loader = BucketedLoader(read_manifest(corpus["train"]), tok,
                                      cfg.data)
        dev_loader = BucketedLoader(read_manifest(corpus["dev"]), tok,
                                    cfg.data, train=False)
        run1.fit(train_loader, steps=21)
        t0 = time.perf_counter()
        run2 = cli.main(args + ["--set", "train.steps=30", "--resume"])
        t_run2 = time.perf_counter() - t0
        # control: resumed from the same checkpoint with a fresh generator
        ctl = Solver(cfg, tok, device=dev)
        ctl.load_checkpoint("step_00000020")
        ctl.generator.manual_seed(cfg.train.seed)
        ctl.fit(train_loader, steps=21)
    finally:
        for key, (mod, attr) in plain.items():
            setattr(mod, attr, saved[key])
        sa.spec_augment_mask = orig_mask
        Solver.train_step, Solver.greedy_ids = orig_step, orig_greedy
    L = cfg.model.encoder_layers
    want_step = {"logmel": 1, "toeplitz_fwd": 1, "attention_fwd": L,
                 "attention_bwd": L, "toeplitz_reduce": 1, "ctc_alpha": 1,
                 "ctc_beta": 1}
    want_dev = {"logmel": 1, "toeplitz_fwd": 1, "attention_fwd": L,
                "subsample": 1}
    n_dev_batches = len(dev_loader)
    print(f"[17] cli.train to step 20 in {t_run1:.1f} s ({n_step1} train "
          f"steps, {n_dev1} dev forwards = 2 evaluations x {n_dev_batches} "
          f"dev batches, shapes {dev_loader.shape_set}); --resume to 30 in "
          f"{t_run2:.1f} s; train shapes {train_loader.shape_set}",
          flush=True)
    bad_steps = [c for c in per_step if c != want_step]
    bad_dev = [c for c in per_dev if c != want_dev]
    print(f"[17] launches of each of {len(per_step)} train steps: "
          f"{per_step[0]}; of each of {len(per_dev)} dev forwards: "
          f"{per_dev[0]}; {len(bad_steps)} steps and {len(bad_dev)} "
          f"forwards differ {(bad_steps + bad_dev)[:3]}; plain versions "
          f"called: {plain_calls}",
          flush=True)
    check(n_step1 == 20 and n_dev1 == 2 * n_dev_batches
          and len(per_step) == 20 + 1 + 10 + 1
          and len(per_dev) == 3 * n_dev_batches,
          "[17] wrong number of train steps or dev forwards")
    check(not bad_steps and not bad_dev
          and not any(plain_calls.values()),
          "[17] launch counts differ from [8]'s or a plain version ran")

    # files, the dev records and the plateau decay
    names = sorted(p.name for p in ckpt.iterdir())
    want_names = sorted(["tokenizer.json", "metrics.jsonl", "last",
                         "last.config.json", "best", "best.config.json",
                         "step_00000020", "step_00000020.config.json",
                         "step_00000030", "step_00000030.config.json"])
    rows = [json.loads(r) for r in open(ckpt / "metrics.jsonl")]
    trains = [r for r in rows if r["tag"] == "train"]
    devs = [r for r in rows if r["tag"] == "dev"]
    print(f"[17] checkpoint directory: {names}; train records at steps "
          f"{[r['step'] for r in trains]}, loss "
          f"{[round(r['loss'], 4) for r in trains]}; dev records "
          f"{[(r['step'], round(r['wer'], 4), r['lr_scale']) for r in devs]}",
          flush=True)
    check(names == want_names, f"[17] checkpoint files {names}")
    check([r["step"] for r in trains] == [5, 10, 15, 20, 25, 30]
          and [r["step"] for r in devs] == [10, 20, 30]
          and all(math.isfinite(r["loss"]) for r in trains),
          "[17] metrics.jsonl records")
    scale, best, since = 1.0, float("inf"), 0
    for r in devs:      # the reference's rule, replayed on the records
        check(r["lr_scale"] == scale, f"[17] lr_scale at {r['step']}")
        if r["wer"] < best:
            best, since = r["wer"], 0
        else:
            since += 1
            if since >= 1:
                scale, since = scale * 0.5, 0
    check(run2.lr_scale == scale and run2.best_wer == best,
          f"[17] plateau: lr_scale {run2.lr_scale} (want {scale}), best "
          f"{run2.best_wer} (want {best})")
    print(f"[17] plateau: lr_scale {run2.lr_scale} after the dev WERs "
          f"{[r['wer'] for r in devs]} (patience 1, factor 0.5)", flush=True)

    # resume: step 21 of the resumed run against the uninterrupted run's
    (s_a, ids_a, mask_a, loss_a), (s_b, ids_b, mask_b, loss_b), (
        s_c, ids_c, mask_c, _) = step21
    check(s_a is run1 and s_b is run2 and s_c is ctl, "[17] step 21 order")
    d_loss = abs(loss_b - loss_a) / abs(loss_a)
    mask_same = torch.equal(mask_a, mask_b)
    ctl_same = ids_c == ids_a and torch.equal(mask_c, mask_a)
    print(f"[17] resume: step 21 ids equal {ids_a == ids_b} ({len(ids_a)} "
          f"rows), SpecAugment mask bits equal {mask_same}, loss "
          f"{loss_a:.6f} vs {loss_b:.6f} (relative {d_loss:.2e}, tol "
          f"{TOL_TRAIN_LOSS}); control, a fresh generator: ids equal "
          f"{ids_c == ids_a}, mask equal {torch.equal(mask_c, mask_a)} "
          f"(must differ)", flush=True)
    check(ids_a == ids_b and mask_same and d_loss <= TOL_TRAIN_LOSS,
          "[17] the resumed step 21 differs from the uninterrupted one")
    check(not ctl_same, "[17] the mask check cannot see the generator")
    del ctl, run1

    # checkpoint round trip: what run 2 saved as 'last', loaded anew
    rt = Solver(cfg, tok, device=dev)
    rt.load_checkpoint("last")
    got, want = rt.opt.state_dict(), run2.opt.state_dict()
    pairs = (list(zip(rt.params, run2.params))
             + list(zip(got["m1"] + got["m2"], want["m1"] + want["m2"]))
             + [(rt.generator.get_state(), run2.generator.get_state())])
    n_diff = sum(int((a != b).sum()) for a, b in pairs)
    print(f"[17] checkpoint round trip: {len(pairs)} tensors (parameters, "
          f"optimizer moments, generator state), elements that differ: "
          f"{n_diff}; count {got['count']} vs {want['count']}, step "
          f"{rt.step}, cursor ({rt.cursor_epoch}, {rt.cursor_batch})",
          flush=True)
    check(n_diff == 0 and got["count"] == want["count"] and rt.step == 30
          and (rt.cursor_epoch, rt.cursor_batch) == (run2.cursor_epoch,
                                                     run2.cursor_batch),
          "[17] checkpoint round trip not bit for bit")
    # the vocabulary guard: a same-sized vocabulary of other symbols
    other = CharTokenizer(charset="".join(
        chr(0x100 + i) for i in range(tok.vocab_size - 4)))
    rt.tokenizer = other
    try:
        rt.load_checkpoint("last")
        guarded = False
    except ValueError:
        guarded = True
    rt.tokenizer = tok
    rt.load_checkpoint("last")
    print(f"[17] vocab guard: another vocabulary of {other.vocab_size} ids "
          f"raises ValueError: {guarded}; the same one loads", flush=True)
    check(guarded, "[17] a checkpoint loaded with another vocabulary")

    # dev parity: kernels against plain torch on the same weights
    pcfg = resolve_device(cfg, dev)
    pcfg.frontend.impl = "torch"
    pcfg.model.attn_impl = pcfg.model.ctc_impl = "torch"
    ps = Solver(pcfg, tok, device=dev)
    ps.model.load_state_dict(run2.model.state_dict())
    plain_subsampling(ps.model)
    worst = 0.0
    with torch.inference_mode():
        for batch in dev_loader.epoch(0):
            a = torch.as_tensor(batch.audio, device=dev)
            al = torch.as_tensor(batch.audio_lens, device=dev)
            enc, el = run2.model.encode(a, al)
            penc, _ = ps.model.encode(a, al)
            worst = max(worst, compare(
                f"[17] dev batch {tuple(batch.audio.shape)}, kernels vs "
                f"plain torch", run2.model.ctc_logits(enc),
                ps.model.ctc_logits(penc), el))
    from pytorch_end2end_speech_recognition_tpu_torch.metrics import wer

    scorer, wer_inputs = wer.edit_distance, []

    def recorded(ref, hyp):  # [21e] holds the native scorer to these
        wer_inputs.append((list(ref), list(hyp)))
        return scorer(ref, hyp)

    wer.edit_distance = recorded
    try:
        wer_k, wer_p = run2.evaluate(dev_loader), ps.evaluate(dev_loader)
    finally:
        wer.edit_distance = scorer
    print(f"[17] dev logits max |d| {worst:.4f} (tol {TOL_LOGITS}); greedy "
          f"dev WER kernels {wer_k:.4f}, plain torch {wer_p:.4f}", flush=True)
    check(worst <= TOL_LOGITS, "[17] dev logits of the kernels disagree")
    del ps, rt

    # pinned copies: two fit steps under the profiler; the control is the
    # same two batches through the pageable copy. In turns: pinned and
    # pageable on the batches at one cursor, then pageable and pinned on
    # the next two
    from torch.profiler import ProfilerActivity, profile

    def profiled(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / 2
        kernel_ms, kinds = {}, {}
        for ev in prof.key_averages():
            if str(getattr(ev, "device_type", "")).endswith("CUDA"):
                t = getattr(ev, "self_device_time_total", None)
                if t is None:
                    t = ev.self_cuda_time_total
                kernel_ms[ev.key] = t / 1e3 / 2
                if "HtoD" in ev.key:
                    kinds[ev.key] = kinds.get(ev.key, 0) + ev.count
        busy = max(sum(kernel_ms.values()), 1e-9)
        share = sum(t for k, t in kernel_ms.items() if "HtoD" in k) / busy
        return kinds, share, busy, wall

    def memcpys(kinds, what):
        return sum(n for k, n in kinds.items() if what in k)

    run2.logger = MetricsLogger(None, echo=False)
    seen, put_log = [], []
    orig_put = run2._put

    def put_rec(batch):
        # the exact check: is each of the 4 arrays `_put` copies pinned?
        arrays = (batch.audio, batch.audio_lens, batch.tokens,
                  batch.token_lens)
        put_log.append(tuple(isinstance(a, torch.Tensor) and a.is_pinned()
                             for a in arrays))
        out = orig_put(batch)
        if record_copies:
            seen.append(tuple(t.clone() for t in out))
        return out

    def turn(kind, fn):
        put_log.clear()
        return kind, fn(), list(put_log)

    def pinned_turn(cursor):
        run2.cursor_epoch, run2.cursor_batch = cursor
        return profiled(lambda: run2.fit(train_loader, steps=run2.step + 2))

    def pageable_turn(batches):
        return profiled(lambda: [run2.train_step(b) for b in batches])

    c0 = (run2.cursor_epoch, run2.cursor_batch)
    rep = train_loader.repeat(*c0)
    first, second = [next(rep), next(rep)], [next(rep), next(rep)]
    c1 = (c0[0], c0[1] + 2)
    run2._put = put_rec
    record_copies = True
    turns = [turn("pinned", lambda: pinned_turn(c0))]
    record_copies = False
    turns += [turn("pageable", lambda: pageable_turn(first)),
              turn("pageable", lambda: pageable_turn(second)),
              turn("pinned", lambda: pinned_turn(c1))]
    del run2._put
    n_bad = sum(int((a.cpu() != torch.as_tensor(b)).sum())
                for got_b, want_b in zip(seen, first)
                for a, b in zip(got_b, (want_b.audio, want_b.audio_lens,
                                        want_b.tokens, want_b.token_lens)))
    for kind, (kinds, share, busy, wall), flags in turns:
        print(f"[17] two steps, {kind} batches: arrays pinned at _put "
              f"{[sum(f) for f in flags]} of 4 a step; the profiler's "
              f"host-to-device copies {kinds}; copy share of busy time "
              f"{share:.4f}, busy {busy:.3f} ms a step, wall {wall:.3f} ms "
              f"(idle share {1 - busy / wall:.3f}); {card}", flush=True)
    print(f"[17] the fit steps' copied batches: elements that differ from "
          f"the loader's {n_bad}; the pageable turns must fail the pinned "
          f"check", flush=True)
    # gated: every array pinned at `_put` (exact), and no pageable copy
    # in the profile of a pinned turn; the profiler's counts are a second
    # witness only, as it has listed 2 of a step's 4 copies and, in one
    # call, no device activity at all
    check(all(len(flags) == 2 and all(all(f) for f in flags)
              and memcpys(kinds, "Pageable") == 0
              for kind, (kinds, *_), flags in turns if kind == "pinned")
          and n_bad == 0,
          "[17] the batch copies are not all pinned, or differ from the "
          "loader")
    check(all(len(flags) == 2 and not any(any(f) for f in flags)
              for kind, _, flags in turns if kind == "pageable"),
          "[17] the pinned check cannot see a pageable copy")
    # fit's throughput over 10 steps (loader, prefetch and pinning
    # included) against the same 10 batches loaded and copied pageable in
    # a plain loop, without the profiler: 5 pairs of turns from one
    # cursor, the order alternating
    c2 = (run2.cursor_epoch, run2.cursor_batch)

    def fit_turn():
        run2.cursor_epoch, run2.cursor_batch = c2
        run2.fit(train_loader, steps=run2.step + 10)

    def loop_turn():
        rep = train_loader.repeat(*c2)
        for _ in range(10):
            run2.train_step(next(rep))

    secs = sum(float(b.audio_lens.sum()) for b in
               itertools.islice(train_loader.repeat(*c2), 10)) / SR
    rates = {"fit": [], "loop": []}
    for i in range(10):
        kind = ("fit", "loop")[(i + i // 2) % 2]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (fit_turn if kind == "fit" else loop_turn)()
        torch.cuda.synchronize()
        rates[kind].append(secs / (time.perf_counter() - t0))
    for kind, name in (("fit", "fit (prefetch, pinned)"),
                       ("loop", "a loop loading each batch and copying it "
                                "pageable")):
        r = sorted(rates[kind])
        print(f"[17] audio-s/s over 10 steps ({secs:.1f} audio-s), {name}: "
              f"median {statistics.median(r):.1f} of 5 turns (min "
              f"{r[0]:.1f}, max {r[-1]:.1f}); {card}", flush=True)
    print(f"[17] fit's last train record in cli.train (evaluations and "
          f"checkpoints included): {trains[-1]['audio_s_per_s']:.1f} "
          f"audio-s/s; {card}", flush=True)

    # host syncs of one train step, on a pinned batch and on the same
    # batch pageable
    batch = next(rep)
    for kind, b in (("pinned", pin_batch(batch)), ("pageable", batch)):
        run2.train_step(b)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                run2.train_step(b)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        syncs = [f"{Path(w.filename).name}:{w.lineno} ({w.message})"
                 for w in caught if "synchronizing" in str(w.message)]
        print(f"[17] host syncs in one train step on a {kind} batch: "
              f"{len(syncs)}", flush=True)
        for line in syncs:
            print(f"    {line[:160]}")

    # time warp on the card against the CPU, the same injected draws
    g = torch.Generator().manual_seed(17)
    feats = torch.randn(4, 300, 80, generator=g)
    flens = torch.tensor([300, 250, 120, 0])
    draws = (20 + torch.randint(0, 200, (4, 1), generator=g),
             torch.randint(-20, 21, (4, 1), generator=g))
    w_cpu = sa.time_warp(feats, flens, 20, draws=draws)
    w_gpu = sa.time_warp(feats.to(dev), flens.to(dev), 20,
                         draws=tuple(d.to(dev) for d in draws))
    d_warp = float((w_gpu.cpu() - w_cpu).abs().max())
    print(f"[17] time warp (W 20) on the card vs the CPU: max |d| "
          f"{d_warp:.2e} (tol 1e-6); {time.perf_counter() - t_phase:.1f} s "
          f"for [17], {time.perf_counter() - t_start:.0f} s since start",
          flush=True)
    check(d_warp <= 1e-6 and not torch.equal(w_cpu, feats),
          "[17] time warp differs on the card")
    del run2
    # [18] trains an LM on the corpus and transcribes with the checkpoint;
    # [21e] scores the dev WER's inputs again
    return (tmp, corpus, ckpt), wer_inputs


STREAM_SECONDS, STREAM_FEED = 60, 0.5   # [18]: one stream, fed in 0.5 s
AN4_STREAM_SECONDS = 20


def _carry_bytes(carry) -> int:
    """Bytes of every tensor a chunk-beam carry holds (nested states too)."""
    n = 0
    for v in carry.values():
        if isinstance(v, dict):
            n += nbytes(*v.values())
        elif v is not None:
            n += nbytes(v)
    return n


def _pieces(audio, seconds: float):
    step = int(seconds * SR)
    return [audio[i:i + step] for i in range(0, audio.shape[0], step)]


def _stream_frames(enc_model, pieces, chunk_s=8.0, overlap_s=2.0):
    """A StreamingEncoder over the pieces: (emitted enc frames, their CTC
    logits, windows encoded)."""
    from pytorch_end2end_speech_recognition_tpu_torch.models.streaming import (
        StreamingEncoder,
    )

    se = StreamingEncoder(enc_model, chunk_s, overlap_s)
    runs = [0]
    orig = se._run_window

    def run(window):
        runs[0] += 1
        return orig(window)
    se._run_window = run
    state, outs_e, outs_l = se.init_stream(), [], []
    for i, p in enumerate(pieces):
        state, e, lg = se.process(state, p, final=i == len(pieces) - 1)
        if len(e):
            outs_e.append(e)
            outs_l.append(lg)
    return torch.cat(outs_e), torch.cat(outs_l), runs[0]


def _rel_err(a, b) -> float:
    n = min(len(a), len(b))
    return float((a[:n].float() - b[:n].float()).abs().mean()
                 / (b[:n].float().abs().mean() + 1e-6))


def stream_phase(dev, gen, peaks, card, counted, t_start, trained) -> None:
    """[18] streaming on the card. Rung 4 (`libri960_conformer`, bf16,
    random weights, the bias table at std 4, its 2 x 650 RnnLm at 0.3,
    beam 10, 40 candidates, ctc_weight 0.3) streams one 60 s speech-like
    recording fed in 0.5 s pieces, with the reference's defaults (chunk
    8 s, overlap 2 s, 64-frame beam chunks, a 256-frame window, 256
    tokens, 16 steps a chunk, wait threshold -2.5). Checks: the launches of
    each window (logmel 1, Toeplitz 1, attention 16, no plain version); the
    emitted frames' count within 2 of the full-pass encode (flash path);
    the streamed logits against the same windows on the plain model, with
    a bias-zeroed control; an4_ctc's StreamingTranscriber against plain
    torch (the LSTM kernel through streaming), with a W_hh-zeroed control;
    the prefix kernels at the window with a non-trivial r_init against
    their plain versions, with a control that drops it; after every beam
    advance, the beam on the kernels against the same feeds with the plain
    prefix scorer; one score and one select launch a token step; a feed of
    SYNC_EVERY steps under the sync debugger; the carry's bytes and the
    peak memory after 20 s and after 59.5 s; `cli.train_lm` on [17]'s
    corpus, then `cli.transcribe --streaming` greedy and beam with the LM
    on [17]'s checkpoint. Printed, not gated: the error against the full
    pass at overlaps 0.5 and 3 s, streaming audio-s/s greedy and beam, the
    latency of each 0.5 s feed, advances and token steps, ms and kernels a
    token step and the idle share, lat_step's launches, and the prefix
    pair's times against their bound."""
    import contextlib
    import io
    import shutil

    from pytorch_end2end_speech_recognition_tpu_torch.cli import train_lm
    from pytorch_end2end_speech_recognition_tpu_torch.cli import transcribe
    from pytorch_end2end_speech_recognition_tpu_torch.configs.presets import (
        an4_ctc,
        libri960_conformer,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.data.audio import (
        load_audio,
        write_wav,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.data.manifest import (
        read_manifest,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.decode import chunk_beam
    from pytorch_end2end_speech_recognition_tpu_torch.decode.beam import (
        SYNC_EVERY,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.decode.chunk_beam import (
        ChunkBeamDecoder,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.models import (
        encoders as tenc,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.models.asr import AsrModel
    from pytorch_end2end_speech_recognition_tpu_torch.models.lm import build_lm
    from pytorch_end2end_speech_recognition_tpu_torch.models.streaming import (
        StreamingBeamTranscriber,
        StreamingTranscriber,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops import (
        attention_kernel as tak,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops import ctc_prefix as cp
    from pytorch_end2end_speech_recognition_tpu_torch.ops import frontend as fe

    t_phase = time.perf_counter()
    tmp, corpus, ckpt = trained
    # the plain versions the path would take off the card, counted
    plain = {"logmel_plain": (fe, "logmel_plain"),
             "attention_plain": (tak, "attention_plain"),
             "toeplitz_expand": (tenc, "toeplitz_expand"),
             "prefix_recursion_plain": (chunk_beam, "prefix_recursion_plain"),
             "prefix_select_plain": (chunk_beam, "prefix_select_plain")}
    plain_calls = dict.fromkeys(plain, 0)
    saved = {k: getattr(m, a) for k, (m, a) in plain.items()}

    def counting(key):
        def call(*a, **kw):
            plain_calls[key] += 1
            return saved[key](*a, **kw)
        return call

    def zero():
        for fn in counted:
            fn.launches = 0
        for k in plain_calls:
            plain_calls[k] = 0

    def launches():
        torch.cuda.synchronize()
        return {**_launches(counted),
                **{k: v for k, v in plain_calls.items() if v}}

    def cfg(impl: str):
        c = libri960_conformer()
        c.model.vocab_size = V_RUNG4
        if impl == "torch":
            c.frontend.impl = "torch"
            c.model.attn_impl = c.model.ctc_impl = "torch"
        return c

    L = 16
    table = torch.randn(L, 8, 64, device=dev, generator=gen) * BIAS_STD
    mk = _with_table(AsrModel(cfg("cuda"), device=dev, seed=0).eval(), table)
    audio = speechlike(1, STREAM_SECONDS * SR, gen, dev)[0]
    pieces = _pieces(audio, STREAM_FEED)
    for key, (mod, attr) in plain.items():
        setattr(mod, attr, counting(key))
    try:
        # ---- the encoder: launches per window, tiling, kernels vs plain
        zero()
        enc_k, log_k, windows = _stream_frames(mk, pieces)
        counts = launches()
        per_window = {"logmel": 1, "toeplitz_fwd": 1, "attention_fwd": L,
                      "subsample": 1}
        print(f"[18] rung 4 streaming encode of {STREAM_SECONDS} s in "
              f"{len(pieces)} feeds of {STREAM_FEED} s (chunk 8 s, overlap "
              f"2 s): {windows} windows, launches {counts}", flush=True)
        check(counts == {k: v * windows for k, v in per_window.items()},
              f"[18] streaming encoder launches {counts} for {windows} "
              "windows")
        with torch.inference_mode():
            full_lens = torch.tensor([STREAM_SECONDS * SR], device=dev)
            zero()
            enc_f, fl = mk.encode(audio[None], full_lens)
            full_counts = launches()
            full = enc_f[0, :int(fl[0])]
        print(f"[18] emitted {len(enc_k)} frames; full-pass encode "
              f"{len(full)} frames (T' {len(full)} > FLASH_T: {full_counts})"
              f"; streamed vs full relative error {_rel_err(enc_k, full):.4f}"
              f" at overlap 2 s", flush=True)
        check(abs(len(enc_k) - len(full)) <= 2 and full_counts.get(
            "flash_fwd", 0) == L, "[18] the emitted frames do not tile the "
              "stream, or the full pass missed the flash path")
        mp = plain_subsampling(_with_table(
            AsrModel(cfg("torch"), device=dev, seed=0).eval(), table))
        _, log_p, _ = _stream_frames(mp, pieces)
        n_t = torch.tensor([len(log_k)], device=dev)
        compare(f"[18] rung 4 streamed logits, kernels vs plain torch on the "
                f"same {windows} windows (bf16)", log_k[None], log_p[None],
                n_t, need_sure=True)
        with torch.no_grad():
            mp.encoder.rel.table.zero_()
        _, log_c, _ = _stream_frames(mp, pieces)
        ctl = (log_k - log_c).abs().amax(-1).max().item()
        print(f"[18] control, plain model with the relative bias zeroed: max "
              f"|dlogit| {ctl:.4f} (must exceed {TOL_LOGITS})", flush=True)
        check(ctl > TOL_LOGITS, "[18] the streamed-logit tolerance cannot "
              "see the bias")
        del mp, log_p, log_c
        errs = {ov: _rel_err(_stream_frames(mk, pieces, 8.0, ov)[0], full)
                for ov in (0.5, 3.0)}
        print(f"[18] streamed vs full-pass encoder output, relative error: "
              + ", ".join(f"overlap {k} s {v:.4f}" for k, v in errs.items()),
              flush=True)

        # ---- an4_ctc: the LSTM kernel through streaming
        an4 = AsrModel(an4_ctc(), device=dev, seed=0).eval()
        ref_cfg = an4_ctc()
        ref_cfg.frontend.impl = "torch"
        ref_cfg.model.lstm_impl = "torch"
        an4_p = AsrModel(ref_cfg, device=dev, seed=0).eval()
        a4 = speechlike(1, AN4_STREAM_SECONDS * SR, gen, dev)[0]
        p4 = _pieces(a4, STREAM_FEED)
        zero()
        _, l4k, w4 = _stream_frames(an4, p4)
        c4 = launches()
        n_l = an4.cfg.model.encoder_layers
        print(f"[18] an4_ctc streaming of {AN4_STREAM_SECONDS} s: {w4} "
              f"windows, launches {c4}", flush=True)
        check(c4 == {"logmel": w4, "lstm_fwd": n_l * w4},
              f"[18] an4_ctc streaming launches {c4}")
        _, l4p, _ = _stream_frames(an4_p, p4)
        compare("[18] an4_ctc streamed logits, kernels vs plain torch",
                l4k[None], l4p[None], torch.tensor([len(l4k)], device=dev),
                need_sure=True, tol=TOL_AN4_LOGITS)
        tok4 = tokenizer_of(an4.cfg.model.vocab_size)
        st4 = StreamingTranscriber(an4, tok4)
        st4p = StreamingTranscriber(an4_p, tok4)
        t4k = st4.transcribe_stream(p4)
        t4p = st4p.transcribe_stream(p4)
        _zero_first_recurrence(an4_p)
        _, l4c, _ = _stream_frames(an4_p, p4)
        ctl4 = (l4k - l4c).abs().amax(-1).max().item()
        print(f"[18] an4_ctc greedy streamed text equal to plain torch's: "
              f"{t4k == t4p} ({len(t4k)} characters); control, layer 0's "
              f"W_hh zeroed: max |dlogit| {ctl4:.4f} (must exceed "
              f"{TOL_AN4_LOGITS})", flush=True)
        check(ctl4 > TOL_AN4_LOGITS, "[18] the an4_ctc streaming tolerance "
              "cannot see the recurrence")
        del an4, an4_p

        # ---- the prefix kernels at the window, with a pre-window column
        lm = build_lm(mk.cfg.model, device=dev, seed=1).eval()
        dcfg = mk.cfg.decode
        K, Pk, Wn = dcfg.beam_size, dcfg.pre_beam_k, 256
        lp_win = torch.log_softmax(log_k[:Wn].float(), -1)[None].contiguous()
        r = (torch.randn(1, K, Wn, 2, device=dev, generator=gen).cumsum(2)
             - 5.0)
        r_init = torch.log_softmax(
            torch.randn(1, K, 2, device=dev, generator=gen), -1) - 1.0
        last = torch.randint(2, V_RUNG4, (1, K), device=dev, generator=gen)
        lengths = torch.randint(1, 20, (1, K), device=dev, generator=gen)
        cand = torch.rand(1, K, V_RUNG4 - 2, device=dev,
                          generator=gen).argsort(-1)[..., :Pk] + 2
        cand[:, :, 0] = last
        parent = torch.randint(0, K, (1, K), device=dev, generator=gen)
        is_ext = torch.rand(1, K, device=dev, generator=gen) < 0.7
        tok = cand.gather(1, parent[..., None].expand(1, K, Pk))[:, :, 1]
        psi_k = cp.ctc_prefix_score(lp_win, r, last, lengths, cand, r_init)
        psi_p = cp.prefix_recursion_plain(lp_win, r, cand, last, lengths,
                                          r_init=r_init)[0]
        sel_k = cp.ctc_prefix_select(lp_win, r, last, lengths, parent, tok,
                                     is_ext, r_init)
        sel_p = cp.prefix_select_plain(lp_win, r, last, lengths, parent, tok,
                                       is_ext, r_init=r_init)
        ex = {"score": prefix_excess(psi_k, psi_p, Wn),
              "select": prefix_excess(sel_k, sel_p, Wn)}
        ctl_p = {"score": prefix_excess(cp.ctc_prefix_score(
            lp_win, r, last, lengths, cand), psi_p, Wn),
            "select": prefix_excess(cp.ctc_prefix_select(
                lp_win, r, last, lengths, parent, tok, is_ext), sel_p, Wn)}
        s_ms = cuda_ms(lambda: cp.ctc_prefix_score(lp_win, r, last, lengths,
                                                   cand, r_init))
        x_ms = cuda_ms(lambda: cp.ctc_prefix_select(
            lp_win, r, last, lengths, parent, tok, is_ext, r_init))
        s_plain = cuda_ms(lambda: cp.prefix_recursion_plain(
            lp_win, r, cand, last, lengths, r_init=r_init), iters=2, warmup=1)
        x_plain = cuda_ms(lambda: cp.prefix_select_plain(
            lp_win, r, last, lengths, parent, tok, is_ext, r_init=r_init),
            iters=2, warmup=1)
        uniq = int(torch.unique(cand).numel()) + 1
        s_b, s_by = bound(Wn * uniq * 4 + nbytes(r, r_init, cand, psi_k),
                          27.0 * K * Pk * Wn / peaks["fp32_flops"], peaks)
        n_ext = int(is_ext.sum())
        x_b, x_by = bound(Wn * (n_ext + 1) * 4 + 2 * nbytes(sel_k)
                          + nbytes(r_init),
                          27.0 * n_ext * Wn / peaks["fp32_flops"], peaks)
        print(f"[18] prefix kernels at the window (B 1, W {Wn}, V {V_RUNG4},"
              f" K {K}, {Pk} candidates, a random pre-window column): "
              f"score {ex['score']:.3e}, select {ex['select']:.3e} of the "
              f"bound W 2^-22 (1 + |plain|) (each must be <= 1); control, "
              f"r_init dropped: score {ctl_p['score']:.3e}, select "
              f"{ctl_p['select']:.3e} (each must exceed 1); score kernel "
              f"{s_ms:.4f} ms (plain {s_plain:.3f} ms, bound {s_b:.6f} ms by "
              f"{s_by}), select kernel {x_ms:.4f} ms (plain {x_plain:.3f} "
              f"ms, bound {x_b:.6f} ms by {x_by}); {card}", flush=True)
        check(all(v <= 1.0 for v in ex.values())
              and all(v > 1.0 for v in ctl_p.values()),
              f"[18] windowed prefix kernels: {ex}, control {ctl_p}")

        # ---- the chunk beam: kernels vs the plain scorer after every
        # advance, launches, carry bytes and peak memory
        tok_r4 = tokenizer_of(V_RUNG4)
        sbt = StreamingBeamTranscriber(mk, tok_r4, dcfg, lm=lm)
        check(sbt.cb.prefix_kernel and (sbt.cb.C, sbt.cb.W, sbt.cb.U,
                                        sbt.cb.S, sbt.cb.tau)
              == (64, 256, 256, 16, -2.5), "[18] chunk beam settings")
        ref = ChunkBeamDecoder(mk, dcfg, lm=lm, prefix_impl="torch")
        ref_carry = [ref.init(1)]
        orig_feed = sbt.cb.feed
        adv = []            # (steps, compared ok, max |d score| excess)

        def feed_both(carry, e, lp, n, final=False, min_tokens=None):
            carry, beam = orig_feed(carry, e, lp, n, final=final,
                                    min_tokens=min_tokens)
            before = dict(plain_calls)
            ref_carry[0], rb = ref.feed(ref_carry[0], e, lp, n, final=final,
                                        min_tokens=min_tokens)
            plain_calls.update(before)  # the reference's calls: not counted
            same = all(torch.equal(beam[k], rb[k])
                       for k in ("tokens", "lengths", "finished"))
            exc = ((beam["scores"] - rb["scores"]).abs()
                   / (dcfg.ctc_weight * prefix_tol(sbt.cb.W)
                      * (1 + rb["scores"].abs()))).max().item()
            adv.append((beam["steps"], same, exc))
            return carry, beam

        sbt.cb.feed = feed_both
        zero()
        stream = sbt.init_stream()
        carry_at, peak_at = {}, {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for i, p in enumerate(pieces):
            final = i == len(pieces) - 1
            stream = sbt.feed(stream, p, final=final)
            t_fed = (i + 1) * STREAM_FEED
            if t_fed in (20.0, STREAM_SECONDS - STREAM_FEED):
                torch.cuda.synchronize()
                carry_at[t_fed] = _carry_bytes(stream.carry)
                peak_at[t_fed] = torch.cuda.max_memory_allocated()
        counts = launches()
        sbt.cb.feed = orig_feed
        steps = sum(a[0] for a in adv)
        n_adv = len(adv)
        bad = [i for i, a in enumerate(adv) if not a[1] or a[2] > 1.0]
        print(f"[18] rung 4 chunk beam over {STREAM_SECONDS} s: {n_adv} "
              f"advances, {steps} token steps ({steps / n_adv:.1f} an "
              f"advance; the last, final one {adv[-1][0]}); launches "
              f"{counts}; after every advance vs the plain prefix scorer: "
              f"{n_adv - len(bad)} of {n_adv} with equal tokens, lengths "
              f"and finished flags and scores within ctc_weight W 2^-22 (1 "
              f"+ |score|) (largest {max(a[2] for a in adv):.3e})",
              flush=True)
        want = {k: v * windows for k, v in per_window.items()}
        want.update(ctc_prefix_score=steps, ctc_prefix_select=steps)
        check(not bad, f"[18] the chunk beam on the kernels differs from the "
              f"plain scorer at advances {bad[:5]}")
        check(counts == want, f"[18] chunk-beam stream launches {counts}, "
              f"want {want}")
        nb = sbt.final_nbest(stream)
        print(f"[18] final best: {len(nb[0]['tokens']) if nb else 0} tokens,"
              f" score {nb[0]['score'] if nb else float('nan'):.3f}; carry "
              f"bytes after 20 s {carry_at[20.0]} and after "
              f"{STREAM_SECONDS - STREAM_FEED} s "
              f"{carry_at[STREAM_SECONDS - STREAM_FEED]}; peak memory "
              f"{peak_at[20.0] / 2**20:.1f} MiB and "
              f"{peak_at[STREAM_SECONDS - STREAM_FEED] / 2**20:.1f} MiB",
              flush=True)
        check(len(set(carry_at.values())) == 1
              and peak_at[STREAM_SECONDS - STREAM_FEED]
              <= peak_at[20.0] + 2 ** 20, "[18] the carry or the peak "
              "memory grows with the stream")

        # no host sync in a feed's token loop: SYNC_EVERY steps a chunk
        cb8 = ChunkBeamDecoder(mk, dcfg, lm=lm, steps_per_chunk=SYNC_EVERY)
        C = cb8.C
        blocks = [(enc_k[s:s + C].float()[None],
                   torch.log_softmax(log_k[s:s + C].float(), -1)[None])
                  for s in (0, C)]
        n_c = torch.full((1,), C, device=dev)
        c8, _ = cb8.feed(cb8.init(1), *blocks[0], n_c)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            try:
                torch.ones((), device=dev).item()
                caught = False
            except RuntimeError:
                caught = True
            c8, b8 = cb8.feed(c8, *blocks[1], n_c)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        print(f"[18] a chunk-beam feed of {b8['steps']} token steps under "
              f"torch.cuda.set_sync_debug_mode('error'): no host sync; "
              f"control, a .item() under the same mode raised: {caught} "
              "(must be True)", flush=True)
        check(caught and b8["steps"] == SYNC_EVERY,
              "[18] the sync check is blind or the feed stopped early")
        del cb8, c8, ref, ref_carry

        # ---- printed: throughput, feed latency, the token step's profile
        greedy = StreamingTranscriber(mk, tok_r4)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        greedy.transcribe_stream(pieces)
        torch.cuda.synchronize()
        g_rate = STREAM_SECONDS / (time.perf_counter() - t0)
        stream, lat = sbt.init_stream(), []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, p in enumerate(pieces):
            t1 = time.perf_counter()
            stream = sbt.feed(stream, p, final=i == len(pieces) - 1)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t1) * 1e3)
        b_rate = STREAM_SECONDS / (time.perf_counter() - t0)
        lat_s = sorted(lat)
        print(f"[18] streaming throughput over {STREAM_SECONDS} s: greedy "
              f"{g_rate:.1f} audio-s/s, beam (LM 0.3) {b_rate:.1f} audio-s/s"
              f"; latency of a {STREAM_FEED} s feed, beam: median "
              f"{statistics.median(lat):.1f} ms, p95 "
              f"{lat_s[int(0.95 * (len(lat_s) - 1))]:.1f} ms, max "
              f"{lat_s[-1]:.1f} ms (the final feed {lat[-1]:.1f} ms); "
              f"{card}", flush=True)
        prof_pieces = pieces[:int(20 / STREAM_FEED)]
        run_steps = []
        orig_cb = sbt.cb.feed

        def feed_rec(*a, **kw):
            out = orig_cb(*a, **kw)
            run_steps.append(out[1]["steps"])
            return out

        def twenty():
            run_steps.clear()
            s = sbt.init_stream()
            for p in prof_pieces:
                s = sbt.feed(s, p)

        sbt.cb.feed = feed_rec
        wall_ms, kernel_ms, n = profile_step(twenty, 1)
        sbt.cb.feed = orig_cb
        busy = sum(kernel_ms.values())
        n_steps = sum(run_steps)
        print(f"[18] profile of 20 s of the beam stream ({len(run_steps)} "
              f"advances, {n_steps} token steps): wall {wall_ms:.1f} ms, "
              f"device busy {busy:.1f} ms (idle share "
              f"{1 - busy / wall_ms:.3f}); {n:.0f} device kernels, "
              f"{n / max(n_steps, 1):.0f} a token step on average (the "
              f"encoder's included), {wall_ms / max(n_steps, 1):.2f} ms a "
              f"token step; {card}", flush=True)
        print_profile("[18] the same profile by group", wall_ms, kernel_ms, n,
                      card)
        # the GEMMs of one advance by input dtype: the decoder's projections
        # run in the model's dtype on the float32 window, the LM and the
        # attention products in float32
        from torch.utils._python_dispatch import TorchDispatchMode

        class GemmDtypes(TorchDispatchMode):
            def __init__(self):
                super().__init__()
                self.seen = {}

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                name = func.overloadpacket.__name__
                # under inference mode `linear` and `matmul` arrive whole
                if name in ("linear", "matmul", "mm", "addmm", "bmm"):
                    dt = str(args[0].dtype).replace("torch.", "")
                    key = f"{name} {dt}"
                    self.seen[key] = self.seen.get(key, 0) + 1
                return func(*args, **(kwargs or {}))

        cb1 = ChunkBeamDecoder(mk, dcfg, lm=lm)
        with GemmDtypes() as gd:
            cb1.feed(cb1.init(1), *blocks[0], n_c)
        print(f"[18] GEMM ops of one advance by input dtype: {gd.seen}",
              flush=True)
        check(any("bfloat16" in k for k in gd.seen),
              "[18] the decoder's GEMMs are not in bf16")
        del cb1
        r_col = torch.zeros((1, K, 2), device=dev)
        lp_last = lp_win[:, :64, :K].transpose(1, 2).contiguous()
        lt_wall, lt_ms, lt_n = profile_step(
            lambda: ChunkBeamDecoder.lat_step(r_col, lp_last,
                                              lp_win[:, :64, 0]), 3)
        print(f"[18] lat_step over a 64-frame chunk: {lt_n:.0f} kernel "
              f"launches, device {sum(lt_ms.values()):.3f} ms, wall "
              f"{lt_wall:.2f} ms an advance (an advance's wall "
              f"{wall_ms / max(len(run_steps), 1):.1f} ms); {card}",
              flush=True)

        # ---- the CLIs on [17]'s checkpoint: train_lm, then transcribe
        cfg_path = str(ckpt / "last.config.json")
        lm_dir = str(tmp / "lm")
        t0 = time.perf_counter()
        _, ppl = train_lm.main(["--config", cfg_path, "--out", lm_dir,
                                "--steps", "50", "--device", "cuda"])
        t_lm = time.perf_counter() - t0
        dev_utts = read_manifest(corpus["dev"])[:2]
        wavs = [u.audio for u in dev_utts]
        long_wav = str(tmp / "long.wav")
        write_wav(long_wav, np.concatenate(
            [load_audio(u.audio, SR) for u in read_manifest(corpus["dev"])
             [:8]]), SR)
        wavs.append(long_wav)
        outs = {}
        for mode, extra in (("greedy", []),
                            ("beam", ["--mode", "beam", "--lm-checkpoint",
                                      lm_dir, "--lm-weight", "0.3"])):
            zero()
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                transcribe.main(["--config", cfg_path, "--checkpoint-tag",
                                 "last", "--streaming", "--device", "cuda"]
                                + extra + wavs)
            secs = time.perf_counter() - t0
            lines = [json.loads(x) for x in buf.getvalue().splitlines()]
            outs[mode] = (lines, launches(), secs)
        for mode, (lines, c, secs) in outs.items():
            print(f"[18] cli.transcribe --streaming {mode}: {len(lines)} "
                  f"lines for {len(wavs)} WAVs in {secs:.1f} s; launches "
                  f"{c}; " + "; ".join(
                      f"{Path(x['file']).name}: {x['text'][:40]!r}"
                      for x in lines), flush=True)
        gl, gc, _ = outs["greedy"]
        bl, bc, _ = outs["beam"]
        kern_only = all(k in ("logmel", "toeplitz_fwd", "attention_fwd",
                              "ctc_prefix_score", "ctc_prefix_select",
                              "subsample")
                        for c in (gc, bc) for k in c)
        check([x["file"] for x in gl] == wavs and [x["file"] for x in bl]
              == wavs and kern_only and gc.get("attention_fwd", 0) > 0
              and gc.get("subsample", 0) > 0
              and bc.get("ctc_prefix_score", 0) > 0
              and bc.get("ctc_prefix_score") == bc.get("ctc_prefix_select"),
              "[18] cli.transcribe --streaming output or launches")
        print(f"[18] cli.train_lm 50 steps on [17]'s corpus in {t_lm:.1f} s,"
              f" dev perplexity {ppl:.2f}; {time.perf_counter() - t_phase:.1f}"
              f" s for [18], {time.perf_counter() - t_start:.0f} s since "
              "start", flush=True)
    finally:
        for key, (mod, attr) in plain.items():
            setattr(mod, attr, saved[key])
        shutil.rmtree(tmp, ignore_errors=True)


# ---- [19] serving bundles and the remaining CLIs
BUNDLE_SETS = (  # request set: (bundle, seconds of each request)
    ("1 x 7 s", "short", (7.0,)),
    ("5 x 12-28 s", "batch", (12.0, 16.0, 20.0, 24.0, 28.0)),
    ("32 x 3-30 s", "batch", tuple(3.0 + 27.0 * i / 31 for i in range(32))),
    ("1 x 50 s", "short", (50.0,)),
)
# the launches of one transcribe call of each bucket's program (no plain
# version runs): the 10 s and 30 s buckets (T' 250, 750) take the dense
# bias, the 60 s bucket (T' 1,498) the flash path, each Conformer bucket
# one subsampling launch, an4_ctc's LSTM 2 layers
BUNDLE_LAUNCHES = {
    (1, 10): {"logmel": 1, "toeplitz_fwd": 1, "attention_fwd": 12,
              "subsample": 1},
    (8, 30): {"logmel": 1, "toeplitz_fwd": 1, "attention_fwd": 12,
              "subsample": 1},
    (32, 30): {"logmel": 1, "toeplitz_fwd": 1, "attention_fwd": 12,
               "subsample": 1},
    (1, 60): {"logmel": 1, "flash_fwd": 12, "subsample": 1},
    (8, 8): {"logmel": 1, "lstm_fwd": 2},
}
# the operators' wrappers (their launch counters) and the plain versions
# that the operators' CPU versions call, by module of ops/
BUNDLE_KERNELS = (("frontend_kernel", "logmel"),
                  ("attention_kernel", "toeplitz_fwd"),
                  ("attention_kernel", "attention_fwd"),
                  ("attention_kernel", "flash_fwd"),
                  ("rnn_kernel", "lstm_fwd"), ("ffn_kernel", "ffn_fwd"),
                  ("subsample_kernel", "subsample"))
BUNDLE_PLAIN = (("frontend_kernel", "logmel_plain"),
                ("attention_kernel", "toeplitz_expand"),
                ("attention_kernel", "attention_plain"),
                ("attention_kernel", "flash_fwd_plain"),
                ("rnn_kernel", "lstm_fwd_plain"),
                ("ffn_kernel", "ffn_fwd_plain"),
                ("subsample_kernel", "subsample_plain"))
V_AN4 = 32  # an4_ctc's character vocabulary


def _program_tensors(prog):
    """Every tensor a loaded program holds: parameters, buffers and the
    constants set as attributes, by dotted name."""
    out = {}
    for mname, mod in prog.named_modules():
        for n, v in vars(mod).items():
            if isinstance(v, torch.Tensor):
                out[f"{mname}.{n}".lstrip(".")] = v
        for n, v in list(mod.named_parameters(recurse=False)) + list(
                mod.named_buffers(recurse=False)):
            out[f"{mname}.{n}".lstrip(".")] = v
    return out


def bundle_child(spec_path: str) -> int:
    """[19]'s serving host, run as `python3 chip_smoke.py --bundle-child
    SPEC` in a fresh process. It loads the bundles the spec names with
    `serving.load_bundle` alone, transcribes each request set, and writes
    (JSON) each set's token ids, bucket, launches and plain-version calls;
    then the transcribe throughput of one set (the median of timed
    windows), the load time, the programs' tensors that are not on the
    card, and the port's models/, training/ and decode/ modules imported."""
    import importlib

    spec = json.loads(Path(spec_path).read_text())
    ops = {m: importlib.import_module(f"{PKG}.ops.{m}")
           for m, _ in BUNDLE_KERNELS}
    plain_calls = {}
    for mod, name in BUNDLE_PLAIN:
        def counting(*a, _f=getattr(ops[mod], name), _n=name, **kw):
            plain_calls[_n] = plain_calls.get(_n, 0) + 1
            return _f(*a, **kw)
        setattr(ops[mod], name, counting)
    from pytorch_end2end_speech_recognition_tpu_torch.serving import (
        load_bundle,
    )

    kernels = [getattr(ops[m], n) for m, n in BUNDLE_KERNELS]
    t0 = time.perf_counter()
    bundles = {k: load_bundle(d) for k, d in spec["bundles"].items()}
    out = {"load_s": time.perf_counter() - t0, "sets": {}}
    reqs = {}
    for name, (key, npz) in spec["sets"].items():
        req = np.load(npz)
        reqs[name] = audios = [req[k] for k in req.files]
        for fn in kernels:
            fn.launches = 0
        plain_calls.clear()
        ids = bundles[key].transcribe_ids(audios)  # ends in a copy: synced
        out["sets"][name] = {
            "ids": ids,
            "bucket": list(bundles[key]._pick_bucket(
                len(audios), max(len(a) for a in audios))),
            "launches": {fn.__name__: fn.launches for fn in kernels
                         if fn.launches},
            "plain": dict(plain_calls)}
    key, name = spec["throughput"]
    audios = reqs[name]
    secs = sum(len(a) for a in audios) / SR
    for _ in range(2):
        bundles[key].transcribe(audios)
    rates = []
    for _ in range(WINDOWS):
        t0 = time.perf_counter()
        for _ in range(ITERS):
            bundles[key].transcribe(audios)
        rates.append(secs * ITERS / (time.perf_counter() - t0))
    out["rates"] = rates
    out["host_tensors"] = [
        [key, list(bucket), tname, list(t.shape)]
        for key, b in bundles.items() for bucket, prog in b._programs.items()
        for tname, t in _program_tensors(prog).items()
        if t.device.type != "cuda"]
    out["n_tensors"] = sum(len(_program_tensors(p)) for b in bundles.values()
                           for p in b._programs.values())
    out["modules"] = sorted(
        m for m in sys.modules if m.split(".")[:2] in (
            [PKG, "models"], [PKG, "training"], [PKG, "decode"]))
    Path(spec["out"]).write_text(json.dumps(out))
    return 0


def _padded(audios, B: int, seconds: float):
    """The bucket (B, seconds)'s batch of the requests, padded as
    `ServingBundle.transcribe` pads them (numpy float32 and int32)."""
    batch = np.zeros((B, int(seconds * SR)), np.float32)
    lens = np.zeros((B,), np.int32)
    for i, a in enumerate(audios):
        batch[i, :len(a)] = a
        lens[i] = len(a)
    return batch, lens


def _live_ids(model, audios, B, seconds, dev):
    """The live model's greedy ids of the requests on the bucket's padded
    batch."""
    batch, lens = _padded(audios, B, seconds)
    with torch.inference_mode():
        *_, tok, tl = serve(model, torch.from_numpy(batch).to(dev),
                            torch.from_numpy(lens).to(dev))
    host = torch.cat([tl[:, None].to(tok.dtype), tok], 1).cpu().numpy()
    return [host[i, 1:1 + host[i, 0]].tolist() for i in range(len(audios))]


def _bundle_bytes(path: Path) -> int:
    return sum(p.stat().st_size for p in path.iterdir())


def bundle_phase(dev, gen, card, counted, t_start, live_rate) -> None:
    """[19] serving bundles and the remaining CLIs, at full width with
    seeded random weights (the relative bias at BIAS_STD): the flagship's
    checkpoint exported by `cli.export` in two subprocesses at once
    (buckets (8, 30) and (32, 30); (1, 10) and (1, 60)), an4_ctc's greedy
    bundle (8, 8) and rung 4's beam bundle (8, 10, beam 10, no LM) in
    process; a fresh process loads the greedy bundles with `load_bundle`
    and transcribes four request sets and an4's batch. Checks: each set's
    tokens equal the live model's greedy decode of the same padded batch;
    launches per call (log-mel 1, Toeplitz 1, attention 12 at 10 and 30 s;
    log-mel 1, flash 12 at 60 s; LSTM 2 for an4_ctc), no plain version;
    no model, training or decode module imported there; the programs hold
    no tensor off the card but 0-d scalars; a control (the relative bias
    zeroed before export) differs on at least one row; the beam bundle's
    texts equal the live decoder's, its prefix launches its token steps;
    `cli.decode` greedy and beam on a synthetic manifest equal to the
    in-process decodes, the WER line and `--nbest-out`; `cli.main --test`
    equal to `cli.decode`; `cli.demo --steps 20 --encoder conformer`
    printing its result; `cli.supervise` running `cli.train` for 20 steps
    to exit code 0. Printed, not gated: export seconds and bytes, load
    time, the (32, 30) bundle's transcribe audio-s/s beside [6]'s live
    forward."""
    import ast
    import contextlib
    import io
    import shutil
    import subprocess
    import tempfile
    import threading
    from types import SimpleNamespace

    from pytorch_end2end_speech_recognition_tpu_torch.cli import (
        decode as cli_decode,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.cli import demo as cli_demo
    from pytorch_end2end_speech_recognition_tpu_torch.cli import main as cli_main
    from pytorch_end2end_speech_recognition_tpu_torch.cli import (
        supervise as cli_supervise,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.configs import presets
    from pytorch_end2end_speech_recognition_tpu_torch.data.dataset import (
        BucketedLoader,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.data.manifest import (
        read_manifest,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.data.synthetic import (
        make_phrases_corpus,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.data.tokenizer import (
        N_SPECIAL,
        CharTokenizer,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.decode.beam import (
        BeamSearchDecoder,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.models.asr import AsrModel
    from pytorch_end2end_speech_recognition_tpu_torch.serving import (
        export_bundle,
        load_bundle,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.serving.export import (
        GreedyProgram,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.training.solver import (
        Solver,
    )

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_19_"))
    procs = []

    def launches():
        return {f.__name__: f.launches for f in counted if f.launches}

    def zero():
        for f in counted:
            f.launches = 0

    try:
        corpus = make_phrases_corpus(tmp / "corpus", n_train=64, n_dev=4,
                                     n_test=16, seed=19)
        texts = [u.text for u in read_manifest(corpus["train"])]
        chars = sorted(set("".join(texts)) - {" "})
        V = presets.flagship_conformer().model.vocab_size
        tok = CharTokenizer(charset="".join(chars) + "".join(
            chr(0x100 + i) for i in range(V - N_SPECIAL - 1 - len(chars))))
        check(tok.vocab_size == V, f"[19] tokenizer of {tok.vocab_size} ids")
        tok.save(tmp / "tokenizer.json")
        cfg = presets.flagship_conformer()
        cfg.data.tokenizer_path = str(tmp / "tokenizer.json")
        cfg.data.test_manifest = str(corpus["test"])
        cfg.train.checkpoint_dir = str(tmp / "flagship")
        cfg.train.metrics_path = ""
        cfg_path = tmp / "flagship.json"
        cfg_path.write_text(cfg.to_json())
        solver = Solver(cfg, tok, device=dev)
        with torch.no_grad():
            solver.model.encoder.rel.table.normal_(0.0, BIAS_STD,
                                                   generator=gen)
        solver.save_checkpoint("best")
        model = solver.model.eval()

        # the flagship's two bundles, exported at once in two processes
        t_exp = time.perf_counter()
        for key, bs, secs in (("batch", "8,32", "30"), ("short", "1", "10,60")):
            procs.append((key, subprocess.Popen(
                [sys.executable, "-m", f"{PKG}.cli.export", "--config",
                 str(cfg_path), "--checkpoint-tag", "best", "--out-dir",
                 str(tmp / f"bundle_{key}"), "--batch-sizes", bs,
                 "--seconds", secs, "--device", dev.type], cwd=root,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))

        # meanwhile: the request sets and the live model's tokens
        reqs, want = {}, {}
        buckets = {"1 x 7 s": (1, 10), "5 x 12-28 s": (8, 30),
                   "32 x 3-30 s": (32, 30), "1 x 50 s": (1, 60)}
        for name, key, secs in BUNDLE_SETS:
            lens = [int(s * SR) for s in secs]
            a = speechlike(len(lens), max(lens), gen, dev).cpu().numpy()
            reqs[name] = [a[i, :n].copy() for i, n in enumerate(lens)]
            np.savez(tmp / f"req_{len(reqs)}.npz", *reqs[name])
            want[name] = _live_ids(model, reqs[name], *buckets[name], dev)
        # an4_ctc's greedy bundle at (8, 8), exported in process
        an4_cfg = presets.an4_ctc()
        an4_cfg.train.checkpoint_dir = str(tmp / "an4")
        an4_cfg.train.metrics_path = ""
        an4 = Solver(an4_cfg, tokenizer_of(V_AN4), device=dev)
        an4.save_checkpoint("best")
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(io.StringIO()) as err:
            export_bundle(an4_cfg, tokenizer_of(V_AN4), tmp / "bundle_an4",
                          batch_sizes=(8,), seconds=(8,), device=dev.type)
        t_an4 = time.perf_counter() - t0
        an4_lens = [int(s * SR) for s in np.linspace(2.0, 8.0, 8)]
        a = speechlike(8, max(an4_lens), gen, dev).cpu().numpy()
        reqs["an4 8 x 2-8 s"] = [a[i, :n].copy()
                                 for i, n in enumerate(an4_lens)]
        np.savez(tmp / "req_an4.npz", *reqs["an4 8 x 2-8 s"])
        want["an4 8 x 2-8 s"] = _live_ids(an4.model.eval(),
                                          reqs["an4 8 x 2-8 s"], 8, 8, dev)
        print(f"[19] an4_ctc bundle (8, 8) exported in {t_an4:.1f} s: "
              + err.getvalue().strip().replace("\n", "; "), flush=True)

        # the control: the flagship's (32, 30) program exported with the
        # relative bias zeroed must miss the live tokens on some row
        ctl = AsrModel(solver.cfg, device=dev)
        ctl.load_state_dict(model.state_dict())
        with torch.no_grad():
            ctl.encoder.rel.table.zero_()
            ep = torch.export.export(GreedyProgram(ctl.eval()), (
                torch.zeros((32, 30 * SR), device=dev),
                torch.zeros((32,), dtype=torch.int32, device=dev)))
            batch, blens = _padded(reqs["32 x 3-30 s"], 32, 30)
            ctl_tok, ctl_tl = ep.module()(torch.from_numpy(batch).to(dev),
                                          torch.from_numpy(blens).to(dev))
        ctl_ids = [ctl_tok[i, :int(ctl_tl[i])].tolist() for i in range(32)]
        n_differ = sum(c != w for c, w in zip(ctl_ids, want["32 x 3-30 s"]))
        print(f"[19] control, the (32, 30) program exported with the "
              f"relative bias zeroed: {n_differ}/32 rows differ from the "
              f"live tokens (must be >= 1)", flush=True)
        check(n_differ >= 1, "[19] a bundle without its relative bias "
              "gives the live tokens: the check cannot see the bias")
        del ctl, ep

        # the exports' results
        for key, p in procs:
            out, _ = p.communicate(timeout=600)
            for line in out.splitlines():
                if line.startswith("[export]"):
                    print(f"[19] {key} bundle: {line}", flush=True)
            check(p.returncode == 0, f"[19] cli.export ({key}) failed:\n"
                  + out[-3000:])
            print(f"[19] {key} bundle: {_bundle_bytes(tmp / f'bundle_{key}')}"
                  f" bytes", flush=True)
        procs.clear()
        print(f"[19] both cli.export processes done "
              f"{time.perf_counter() - t_exp:.1f} s after their start",
              flush=True)

        # a fresh process serves them: load_bundle alone
        spec = {"bundles": {k: str(tmp / f"bundle_{k}")
                            for k in ("batch", "short", "an4")},
                "sets": {name: (key, str(tmp / f"req_{i + 1}.npz"))
                         for i, (name, key, _) in enumerate(BUNDLE_SETS)},
                "throughput": ["batch", "32 x 3-30 s"],
                "out": str(tmp / "served.json")}
        spec["sets"]["an4 8 x 2-8 s"] = ("an4", str(tmp / "req_an4.npz"))
        (tmp / "spec.json").write_text(json.dumps(spec))
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, str(root / "chip_smoke.py"), "--bundle-child",
             str(tmp / "spec.json")], cwd=root, capture_output=True,
            text=True, timeout=600)
        check(child.returncode == 0, "[19] the serving process failed:\n"
              + child.stderr[-3000:])
        served = json.loads((tmp / "served.json").read_text())
        print(f"[19] serving process: {time.perf_counter() - t0:.1f} s, "
              f"load_bundle of 5 programs {served['load_s']:.1f} s; port "
              f"modules of models/, training/, decode/ imported there: "
              f"{served['modules']}", flush=True)
        check(served["modules"] == [], "[19] the serving process imported "
              f"model code: {served['modules']}")
        host = served["host_tensors"]
        big = [t for t in host if t[3]]
        print(f"[19] programs' tensors off the card, of "
              f"{served['n_tensors']}: {len(host) - len(big)} 0-d scalars "
              f"{sorted({t[2] for t in host if not t[3]})}, {len(big)} "
              f"others {big[:4]}", flush=True)
        check(not big, "[19] a program holds a host tensor beyond a 0-d "
              "scalar: transcribe would copy it every call")
        an4_set = "an4 8 x 2-8 s"
        for name, res in served["sets"].items():
            bucket = tuple(res["bucket"])
            same = sum(g == w for g, w in zip(res["ids"], want[name]))
            print(f"[19] {name} -> bucket {bucket}: tokens equal to the live "
                  f"model's on {same}/{len(want[name])} rows; launches "
                  f"{res['launches']}, plain versions {res['plain']}",
                  flush=True)
            check(res["ids"] == want[name] and res["plain"] == {}
                  and res["launches"] == BUNDLE_LAUNCHES[bucket]
                  and bucket == ((8, 8) if name == an4_set
                                 else buckets[name]),
                  f"[19] {name}: tokens, bucket or launches")
        for key in ("logmel", "lstm_fwd"):
            check(served["sets"][an4_set]["launches"].get(key)
                  == BUNDLE_LAUNCHES[(8, 8)][key], f"[19] an4 {key}")
        rates = served["rates"]
        print(f"[19] (32, 30) bundle transcribe: median "
              f"{statistics.median(rates):.1f} audio-s/s of requests over "
              f"{len(rates)} windows of {ITERS} calls (min {min(rates):.1f},"
              f" max {max(rates):.1f}); [6]'s live forward at B=32 x 30 s: "
              f"{live_rate:.1f}; {card}", flush=True)

        # cli.supervise: cli.train for 20 steps in its own process group,
        # beside the in-process CLIs below
        sup_dir = tmp / "supervised"
        sup_rc = []

        def supervise():
            try:
                cli_supervise.main([
                    "--config", str(cfg_path), "--hang-timeout", "300",
                    "--max-restarts", "0", "--steps", "20",
                    "--device", dev.type,
                    "--set", f"data.train_manifest={corpus['train']}",
                    "--set", "data.batch_size=32",
                    "--set", f"train.checkpoint_dir={sup_dir}",
                    "--set", f"train.metrics_path={sup_dir / 'm.jsonl'}",
                    "--set", "train.log_every=5"])
            except SystemExit as e:
                sup_rc.append(e.code)

        t_sup = time.perf_counter()
        sup = threading.Thread(target=supervise)
        sup.start()

        # rung 4's beam bundle at (8, 10), beam 10, no LM, in process
        r4_cfg = presets.libri960_conformer()
        r4_cfg.train.checkpoint_dir = str(tmp / "rung4")
        r4_cfg.train.metrics_path = ""
        r4_cfg.decode.beam_size, r4_cfg.decode.lm_weight = 10, 0.0
        # 12 token steps at T' 250, as [15] caps its decodes
        r4_cfg.decode.max_decode_ratio = 0.05
        r4_tok = tokenizer_of(V_RUNG4)
        r4 = Solver(r4_cfg, r4_tok, device=dev)
        with torch.no_grad():
            r4.model.encoder.rel.table.normal_(0.0, BIAS_STD, generator=gen)
        r4.save_checkpoint("best")
        export_bundle(r4_cfg, r4_tok, tmp / "bundle_r4", mode="beam",
                      batch_sizes=(8,), seconds=(10,), device=dev.type)
        r4_bundle = load_bundle(tmp / "bundle_r4")
        r4_lens = [int(s * SR) for s in np.linspace(4.0, 10.0, 8)]
        a = speechlike(8, max(r4_lens), gen, dev).cpu().numpy()
        r4_req = [a[i, :n].copy() for i, n in enumerate(r4_lens)]
        zero()
        t0 = time.perf_counter()
        r4_texts = r4_bundle.transcribe(r4_req)
        torch.cuda.synchronize()
        t_r4 = time.perf_counter() - t0
        r4_launch = launches()
        batch, blens = _padded(r4_req, 8, 10)
        live_dec = BeamSearchDecoder(r4.model.eval(), r4.cfg.decode)
        live = live_dec.decode_batch(SimpleNamespace(audio=batch,
                                                     audio_lens=blens), r4_tok)
        steps = int(live_dec.decode_ids(
            torch.from_numpy(batch).to(dev),
            torch.from_numpy(blens).to(dev))["steps"])
        print(f"[19] rung 4 beam bundle (8, 10), beam 10: {t_r4:.2f} s a "
              f"call, launches {r4_launch}, {steps} token steps live; texts "
              f"equal to the live decoder's on "
              f"{sum(t == r[0]['text'] for t, r in zip(r4_texts, live))}/8 "
              "rows", flush=True)
        check(r4_texts == [r[0]["text"] for r in live]
              and r4_launch.get("ctc_prefix_score") == steps
              and r4_launch.get("ctc_prefix_select") == steps
              and r4_launch.get("attention_fwd") == 16
              and r4_launch.get("subsample") == 1,
              "[19] rung 4 beam bundle against the live decoder")
        del r4, r4_bundle, live_dec

        # cli.decode on the synthetic test manifest: greedy and beam
        def run_cli(fn, argv):
            out, err = io.StringIO(), io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                fn(argv)
            wer = [x for x in err.getvalue().splitlines()
                   if x.startswith("WER ")]
            return ([json.loads(x) for x in out.getvalue().splitlines()],
                    wer, time.perf_counter() - t0)

        base = ["--config", str(cfg_path), "--checkpoint-tag", "best",
                "--device", dev.type]
        test = ["--manifest", str(corpus["test"])]
        nbest = tmp / "nbest.jsonl"
        greedy, g_wer, g_s = run_cli(cli_decode.main, base + test)
        beam, b_wer, b_s = run_cli(cli_decode.main, base + test + [
            "--mode", "beam", "--beam-size", "10", "--set",
            "decode.max_decode_ratio=0.2", "--nbest-out", str(nbest)])
        main_out, m_wer, m_s = run_cli(cli_main.main, base + ["--test"])
        loader = BucketedLoader(read_manifest(corpus["test"]), tok,
                                solver.cfg.data, train=False)
        dcfg = solver.cfg.decode
        dcfg.beam_size, dcfg.max_decode_ratio = 10, 0.2
        bsd = BeamSearchDecoder(model, dcfg)
        g_want, b_want, n_want = [], [], []
        for b in loader.epoch(0):
            hyps = solver.decode_batch(b)
            res = bsd.decode_batch(b, tok)
            for i in range(len(b.ids)):
                if b.audio_lens[i] == 0:
                    continue
                row = {"id": b.ids[i], "ref": b.texts[i]}
                g_want.append({**row, "hyp": hyps[i]})
                b_want.append({**row, "hyp": res[i][0]["text"]})
            n_want += [{"id": u, "nbest": r} for u, r in zip(b.ids, res)]
        n_rows = [json.loads(x) for x in nbest.read_text().splitlines()]
        print(f"[19] cli.decode greedy: {len(greedy)} lines in {g_s:.1f} s, "
              f"{g_wer}; beam 10: {len(beam)} lines in {b_s:.1f} s, "
              f"{b_wer}, {len(n_rows)} N-best rows; cli.main --test: "
              f"{len(main_out)} lines in {m_s:.1f} s, {m_wer}; first hyp "
              f"{greedy[0]['hyp'][:40]!r}", flush=True)
        check(greedy == g_want and beam == b_want and len(g_wer) == 1
              and len(b_wer) == 1 and len(greedy) == 16
              and n_rows == json.loads(json.dumps(n_want)),
              "[19] cli.decode against the in-process decodes")
        check(main_out == greedy and m_wer == g_wer,
              "[19] cli.main --test differs from cli.decode")

        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(io.StringIO()):
            cli_demo.main(["--workdir", str(tmp / "demo"), "--steps", "20",
                           "--encoder", "conformer", "--device", dev.type])
        result = ast.literal_eval(out.getvalue().splitlines()[-1])
        print(f"[19] cli.demo --steps 20 --encoder conformer in "
              f"{time.perf_counter() - t0:.1f} s: {result}", flush=True)
        check(set(result) == {"train_wer", "dev_wer"}
              and all(math.isfinite(v) for v in result.values()),
              "[19] cli.demo result")
        sup.join(timeout=600)
        metrics = ([json.loads(x) for x in
                    (sup_dir / "m.jsonl").read_text().splitlines()]
                   if (sup_dir / "m.jsonl").exists() else [])
        print(f"[19] cli.supervise (cli.train, 20 steps): exit code "
              f"{sup_rc} in {time.perf_counter() - t_sup:.1f} s; last "
              f"metrics record {metrics[-1] if metrics else None}",
              flush=True)
        check(not sup.is_alive() and sup_rc == [0]
              and (sup_dir / "last").exists()
              and any(r.get("step") == 20 for r in metrics),
              "[19] cli.supervise did not train to step 20 and exit 0")
        print(f"[19] {time.perf_counter() - t_phase:.1f} s for [19], "
              f"{time.perf_counter() - t_start:.0f} s since start",
              flush=True)
    finally:
        for _, p in procs:
            p.kill()
            p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


R5_B = 8               # [20a]/[20b]: rung 5's check batch, B = 8 x 30 s
R5_SEED = 20
DIST_TIMEOUT = 420     # seconds a child rank of [20b]/[20c] may take
D20_STEPS = 5          # [20c]'s steps, one process and two
TOL_D20_LOSS = 5e-4    # [20c]: relative, each step's loss


def r5_cfg(impl: str, overrides: dict):
    """libri960_multihost (rung 5) as [20] runs it: vocab 1,024 as rung 4's
    card runs, dropout 0 and no SpecAugment (one step held against
    another), weights from R5_SEED; `impl` 'cuda' (the kernels) or 'torch'
    (plain); `overrides` dotted config values (a narrow rehearsal)."""
    from pytorch_end2end_speech_recognition_tpu_torch.configs.presets import (
        libri960_multihost,
    )

    c = libri960_multihost()
    c.model.vocab_size = V_RUNG4
    c.model.encoder_dropout = c.model.decoder_dropout = 0.0
    c.frontend.spec_augment = False
    c.train.seed = R5_SEED
    c.train.metrics_path = ""
    if impl == "torch":
        c.frontend.impl = "torch"
        c.model.attn_impl = c.model.ctc_impl = "torch"
    for k, v in overrides.items():
        c.override(k, str(v))
    return c


def compute_mode() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def run_children(tag: str, specs: list, timeout: float = DIST_TIMEOUT):
    """Run `python3 chip_smoke.py --dist-child SPEC RANK` for each rank's
    spec file at once; each child's output. A child that fails or outlives
    `timeout` fails the phase, with every child's output printed; no child
    is left running."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, OMP_NUM_THREADS="4")
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--dist-child",
         str(spec), str(rank)], cwd=root, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank, spec in enumerate(specs)]
    deadline = time.perf_counter() + timeout
    outs, timed_out = [], False
    for p in procs:
        try:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.perf_counter()))[0])
        except subprocess.TimeoutExpired:
            timed_out = True
            break
    if timed_out or any(p.returncode != 0 for p in procs[:len(outs)]):
        for p in procs:
            if p.poll() is None:
                p.kill()
        outs = [p.communicate()[0] if i >= len(outs) else outs[i]
                for i, p in enumerate(procs)]
        for rank, out in enumerate(outs):
            print(f"{tag} rank {rank} output:\n{out}", flush=True)
    check(not timed_out, f"{tag}: a rank outlived {timeout} s")
    check(all(p.returncode == 0 for p in procs),
          f"{tag}: rank exit codes {[p.returncode for p in procs]}")
    return outs


def child_results(out: str) -> list[dict]:
    return [json.loads(line.split(" ", 1)[1]) for line in out.splitlines()
            if line.startswith("DIST_RESULT ")]


def _step_stats(got: dict, want: dict, loss: float, want_loss: float):
    """(relative |d loss|, min cosine, max relative error, median cosine,
    parameters compared) of a step against a reference, as [8] holds
    them."""
    d_loss = abs(loss - want_loss) / abs(want_loss)
    cmin, rmax, cmed, n_cmp = grad_stats(got, want)
    return d_loss, cmin, rmax, cmed, n_cmp


def _step_ok(d_loss, cmin, rmax) -> bool:
    return (d_loss <= TOL_TRAIN_LOSS and cmin >= TRAIN_MIN_COS
            and rmax <= TRAIN_MAX_REL)


def rung5_phase(dev, card, counted, t_start, audio, audio_lens,
                overrides: dict | None = None, flagship_sets=()) -> None:
    """[20] data and tensor parallelism on the card.

    [20a] rung 5 (libri960_multihost: 24 Conformer layers d1,024, H16, FFN
    4,096; the 6-layer decoder d512, vocab 1,024) at full width, bf16,
    through `Solver(mesh=make_mesh(1, 1))` in a world-1 process group over
    'cpu:gloo,cuda:nccl': one hybrid step on a ragged B=8 x 30 s batch (U
    <= 128) against the same weights in plain torch on the card, with a
    bias-zeroed control; launches per step (log-mel 1, flash 24 + 24,
    Toeplitz 0 + 0, CTC 1 + 1), peak memory, step time.

    [20b] the same step at dp 1 x tp 2: two processes on the one card over
    gloo (`rung5_child`), the same weights sharded from the full state,
    the same batch; the loss and every gradient, gathered whole, against
    [20a]'s kernel step; controls that must fail (pw1 split contiguously,
    not as GLU halves; the row-parallel all-reduce left out in one block),
    each held over block 0's gradients; per rank, launches (flash 24 + 24 on 8 heads), peak memory, parameter
    and Adam bytes.

    [20c] the flagship through `cli.train` at dp 2 x tp 1 (two processes on
    the card over gloo, per-rank batch 16) against one process at batch
    32, [17]'s manifest, 5 steps, dropout and SpecAugment off: each step's
    loss within 5e-4; one checkpoint and one tokenizer.json; `--resume` at
    dp 1 x tp 2 restoring every local slice bit for bit; `cli.decode` on
    two processes printing the one-process WER line and utterance lines.

    Step times here are not scaling numbers: two ranks share one card, and
    gloo stages CUDA tensors through the host. `overrides` (rung 5's
    config) and `flagship_sets` ([20c]'s extra `--set` pairs) narrow the
    models for a rehearsal on the CPU."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from pytorch_end2end_speech_recognition_tpu_torch.data.dataset import Batch
    from pytorch_end2end_speech_recognition_tpu_torch.parallel.mesh import (
        abort,
        initialize_multihost,
        make_mesh,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.training.solver import (
        Solver,
    )

    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_20_"))
    gen = torch.Generator(device=dev).manual_seed(R5_SEED)
    cuda = dev.type == "cuda"
    child_dev = "cuda:0" if cuda else "cpu"
    overrides = overrides or {}
    try:
        initialize_multihost(f"file://{tmp / 'rdzv_20a'}",
                             num_processes=1, process_id=0,
                             backend="cpu:gloo,cuda:nccl" if cuda else "gloo",
                             timeout_s=300)
        one = torch.ones(1, device=dev)
        dist.all_reduce(one)
        check(float(one) == 1.0, "[20a] NCCL all-reduce at world 1")
        mesh = make_mesh(1, 1, device=dev.type)
        print(f"[20a] process group: world {dist.get_world_size()}, backend "
              f"{dist.get_backend()}; NCCL all-reduce of a card tensor: "
              f"{float(one)}; mesh dp {mesh.dp} x tp {mesh.tp} on "
              f"{mesh.device}", flush=True)
        m0 = r5_cfg("cuda", overrides).model
        L, H, V = m0.encoder_layers, m0.encoder_heads, V_RUNG4
        check(L == 24 and H == 16 and m0.encoder_dim == 1024
              and m0.encoder_ffn_dim == 4096 and m0.decoder_layers == 6
              and m0.decoder_dim == 512 and m0.encoder == "conformer",
              "rung 5 is not the preset")
        table = torch.randn(L, H, 64, device=dev, generator=gen) * BIAS_STD
        B8 = R5_B
        nf = (audio_lens[:B8] - WIN) // HOP + 1
        enc_lens = ((nf + 1) // 2 + 1) // 2
        tok = 1 + torch.cumsum(torch.randint(
            1, V - 1, (B8, U_RUNG4), device=dev, generator=gen), 1) % (V - 1)
        tok_lens = torch.minimum(torch.randint(
            U_RUNG4 // 2, U_RUNG4 + 1, (B8,), device=dev, generator=gen),
            enc_lens // 2)
        tok = tok * (torch.arange(U_RUNG4, device=dev)[None, :]
                     < tok_lens[:, None])
        host = lambda t: t.cpu().numpy().astype(np.int32)  # noqa: E731
        batch = Batch(audio[:B8].cpu().numpy(), host(audio_lens[:B8]),
                      host(tok), host(tok_lens))

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ks = Solver(r5_cfg("cuda", overrides), tokenizer_of(V), mesh=mesh)
        _with_table(ks.model, table)
        n_par = sum(p.numel() for p in ks.params)
        n_enc = sum(p.numel() for p in ks.model.encoder.parameters())
        state_bytes = 3 * 4 * n_par   # parameters, Adam's two moments
        print(f"[20a] rung 5: {n_par / 1e6:.1f} M parameters ({n_enc / 1e6:.1f}"
              f" M in the encoder), built in {time.perf_counter() - t0:.1f} "
              f"s; parameter and Adam bytes {state_bytes / 2**30:.2f} GiB",
              flush=True)
        for fn in counted:
            fn.launches = 0
        km, kg = ks.grads(batch)
        torch.cuda.synchronize()
        counts = _launches(counted)
        k_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"[20a] rung 5 hybrid step launches: {counts}", flush=True)
        check(counts == {"logmel": 1, "flash_fwd": L, "flash_bwd": L,
                         "ctc_alpha": 1, "ctc_beta": 1},
              f"[20a] step launch counts {counts}")
        kg = {n: g.detach() for n, g in zip(ks.names, kg)}
        check(all(bool(torch.isfinite(g).all()) for g in kg.values()),
              "[20a] kernel gradients not finite")
        ref_path = tmp / "r5_ref.pt"
        torch.save({"loss": float(km["loss"]),
                    "grads": {n: g.cpu() for n, g in kg.items()}}, ref_path)
        torch.save({"table": table.cpu(), "audio": batch.audio,
                    "audio_lens": batch.audio_lens, "tokens": batch.tokens,
                    "token_lens": batch.token_lens}, tmp / "r5_data.pt")
        ks.train_step(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ks.train_step(batch)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        del ks
        torch.cuda.empty_cache()
        ps = Solver(r5_cfg("torch", overrides), tokenizer_of(V), device=dev)
        _with_table(ps.model, table)
        pm, pg = ps.grads(batch)
        pg = {n: g.detach() for n, g in zip(ps.names, pg)}
        d_loss, cmin, rmax, cmed, n_cmp = _step_stats(
            kg, pg, float(km["loss"]), float(pm["loss"]))
        print(f"[20a] rung 5 kernels vs plain torch, one hybrid step (B={B8} "
              f"x {SECONDS:.0f} s ragged, T' {int(enc_lens.max())}, U<="
              f"{U_RUNG4}, vocab {V}, bf16, {L} L d1024 H16 + 6-layer decoder;"
              f" flash by the 15 MiB rule): loss {float(km['loss']):.5f} vs "
              f"{float(pm['loss']):.5f}, relative |d loss| {d_loss:.2e} (tol "
              f"{TOL_TRAIN_LOSS}); gradients of {n_cmp} parameters: cosine "
              f"min {cmin:.5f} median {cmed:.5f} (tol {TRAIN_MIN_COS}), "
              f"relative error max {rmax:.4f} (tol {TRAIN_MAX_REL}); step "
              f"peak memory {k_peak:.2f} GiB; Solver.train_step "
              f"{step_s * 1e3:.1f} ms; {card}", flush=True)
        check(_step_ok(d_loss, cmin, rmax),
              "[20a] rung 5 kernel step disagrees with plain")
        with torch.no_grad():
            ps.model.encoder.rel.table.zero_()
        cm, cg = ps.grads(batch)
        cg = {n: g.detach() for n, g in zip(ps.names, cg)}
        c = _step_stats(kg, cg, float(km["loss"]), float(cm["loss"]))
        print(f"[20a] control, plain model with the relative bias zeroed: "
              f"relative |d loss| {c[0]:.2e}, cosine min {c[1]:.5f}, relative"
              f" error max {c[2]:.4f} (must fail)", flush=True)
        check(not _step_ok(*c[:3]), "[20a] the step tolerance cannot see the "
              "bias")
        del ps, pg, cg, kg
        torch.cuda.empty_cache()
        abort()
        print(f"[20a] done in {time.perf_counter() - t_phase:.1f} s",
              flush=True)

        mode = compute_mode()
        print(f"[20] compute mode: {mode} (two ranks share the card only in "
              "Default)", flush=True)
        check(mode == "Default", f"[20] compute mode {mode}")
        # [20b] rung 5 at dp 1 x tp 2, two ranks on the card over gloo
        t_b = time.perf_counter()
        specs = []
        for rank in range(2):
            spec = tmp / f"r5_{rank}.json"
            spec.write_text(json.dumps({
                "kind": "r5", "rdzv": str(tmp / "rdzv_20b"),
                "data": str(tmp / "r5_data.pt"), "ref": str(ref_path),
                "device": child_dev, "state_bytes_20a": state_bytes,
                "peak_20a": k_peak, "overrides": overrides}))
            specs.append(spec)
        outs = run_children("[20b]", specs)
        for rank, out in enumerate(outs):
            for line in out.splitlines():
                if line.startswith("[20b]"):
                    print(line, flush=True)
        res = [r for out in outs for r in child_results(out)]
        check(len(res) == 2, f"[20b] results from {len(res)} ranks")
        for r in res:
            check(r["counts"] == {"logmel": 1, "flash_fwd": L,
                                  "flash_bwd": L, "ctc_alpha": 1,
                                  "ctc_beta": 1},
                  f"[20b] rank {r['rank']} launch counts {r['counts']}")
            check(r["state_bytes"] < 0.6 * state_bytes,
                  f"[20b] rank {r['rank']} holds {r['state_bytes']} bytes of "
                  "parameters and Adam state")
        top = next(r for r in res if r["rank"] == 0)
        check(_step_ok(*top["step"]), "[20b] tp 2 step disagrees with [20a]")
        for name in ("glu_contiguous", "reduce_left_out"):
            check(not _step_ok(*top[name]), f"[20b] control {name} passed")
        print(f"[20b] done in {time.perf_counter() - t_b:.1f} s (step times "
              "here are no scaling numbers: two ranks share one card and "
              "gloo stages card tensors through the host)", flush=True)
        os.remove(ref_path)
        dist_train_phase(dev, card, tmp, child_dev, flagship_sets)
    finally:
        abort()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[20] done in {time.perf_counter() - t_phase:.1f} s; "
          f"{time.perf_counter() - t_start:.0f} s since start", flush=True)


def rung5_child(spec: dict, rank: int) -> None:
    """[20b] one rank of rung 5 at dp 1 x tp 2 (see `rung5_phase`)."""
    from pytorch_end2end_speech_recognition_tpu_torch.data.dataset import Batch
    from pytorch_end2end_speech_recognition_tpu_torch.models import (
        encoders as tenc,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.parallel.mesh import (
        initialize_multihost,
        make_mesh,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.parallel.sharding import (
        full_tensor,
        shard_tensor,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.training.solver import (
        Solver,
    )

    counted = counted_wrappers()
    initialize_multihost(f"file://{spec['rdzv']}",
                         num_processes=2, process_id=rank, backend="gloo",
                         timeout_s=DIST_TIMEOUT)
    dev = torch.device(spec["device"])
    mesh = make_mesh(1, 2, device=spec["device"])
    data = torch.load(spec["data"], weights_only=False)
    batch = Batch(data["audio"], data["audio_lens"], data["tokens"],
                  data["token_lens"])
    cfg = r5_cfg("cuda" if dev.type == "cuda" else "torch",
                 spec["overrides"])
    solver = Solver(cfg, tokenizer_of(cfg.model.vocab_size), mesh=mesh)
    _with_table(solver.model, data["table"].to(dev))
    state_bytes = 3 * sum(p.numel() * p.element_size()
                          for p in solver.params)
    ref = (torch.load(spec["ref"], weights_only=True, mmap=True)
           if rank == 0 else None)

    def step(tag, prefix=""):
        """One step; rank 0 gets its stats against [20a]'s kernel step,
        over the gradients whose names start with `prefix`. (A control
        that fails on some gradients fails on all: their minimum cosine
        is no higher and their maximum error no lower.)"""
        metrics, grads = solver.grads(batch)
        full = {n: full_tensor(mesh, g, solver.dims.get(n))
                for n, g in zip(solver.names, grads) if n.startswith(prefix)}
        if rank != 0:
            return None
        stats = _step_stats(full, {n: ref["grads"][n] for n in full},
                            float(metrics["loss"]), ref["loss"])
        print(f"[20b] {tag}: loss {float(metrics['loss']):.5f} vs [20a] "
              f"{ref['loss']:.5f}, relative |d loss| {stats[0]:.2e}; "
              f"gradients of {stats[4]} parameters, gathered whole: cosine "
              f"min {stats[1]:.5f} median {stats[3]:.5f}, relative error max "
              f"{stats[2]:.4f}", flush=True)
        return stats[:3]

    for fn in counted:
        fn.launches = 0
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    main_stats = step("kernels at dp 1 x tp 2 vs [20a]'s step")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    counts = _launches(counted)
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30
            if dev.type == "cuda" else 0.0)
    share = state_bytes / spec["state_bytes_20a"]
    print(f"[20b] rank {rank}: launches {counts}; peak memory {peak:.2f} GiB"
          f" ([20a] {spec['peak_20a']:.2f}); parameter and Adam bytes "
          f"{state_bytes / 2**30:.2f} GiB ({share:.3f} of [20a]'s); the step"
          f" with its gathers {step_s:.1f} s", flush=True)

    # the controls gather block 0's gradients alone (the gloo gathers of
    # all of them take most of a step's time), where both faults show
    block0 = "encoder.blocks.0."
    # control 1: pw1 split contiguously (rank r holds rows r D/... of (a;
    # b) in one block), not as matching GLU halves
    convs = [m for m in solver.model.modules()
             if isinstance(m, tenc.ConvModule)]
    saved = [m.pw1.weight.data for m in convs]
    col = tenc._col
    for m in convs:
        whole = full_tensor(mesh, m.pw1.weight, (0, True)).to(dev)
        m.pw1.weight.data = shard_tensor(whole, 0, False, 2,
                                         mesh.model_rank).contiguous()
    tenc._col = lambda x, layer, dt, group, glu=False: col(x, layer, dt,
                                                           group, False)
    try:
        glu_stats = step("control, pw1 split contiguously (must fail)",
                         block0)
    finally:
        tenc._col = col
        for m, w in zip(convs, saved):
            m.pw1.weight.data = w

    # control 2: the row-parallel all-reduce left out in one block (block
    # 0's first FFN)
    reduce_from = tenc.reduce_from
    calls = [0]

    def skip_first(x, group):
        calls[0] += 1
        return x if calls[0] == 1 else reduce_from(x, group)

    tenc.reduce_from = skip_first
    try:
        red_stats = step("control, block 0's fc2 all-reduce left out (must "
                         "fail)", block0)
    finally:
        tenc.reduce_from = reduce_from
    print("DIST_RESULT " + json.dumps({
        "rank": rank, "counts": counts, "state_bytes": state_bytes,
        "peak_gib": peak, "step": main_stats, "glu_contiguous": glu_stats,
        "reduce_left_out": red_stats}), flush=True)


def dist_train_phase(dev, card, tmp, child_dev, flagship_sets) -> None:
    """[20c] (see `rung5_phase`)."""
    import contextlib
    import io

    from pytorch_end2end_speech_recognition_tpu_torch.cli import (
        decode as cli_decode,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.cli import train as cli
    from pytorch_end2end_speech_recognition_tpu_torch.data.synthetic import (
        make_phrases_corpus,
    )

    t_c = time.perf_counter()
    # [17]'s manifest, written again from its seed ([18] deleted [17]'s)
    corpus = make_phrases_corpus(tmp / "corpus", n_train=512, n_dev=64,
                                 n_test=1, seed=0)

    def args(name: str, batch: int) -> list:
        return ["--config", "flagship_conformer",
                "--set", f"data.train_manifest={corpus['train']}",
                "--set", f"data.dev_manifest={corpus['dev']}",
                "--set", f"data.batch_size={batch}",
                "--set", "data.batch_frames=15360000",
                "--set", "train.eval_every=1000000",
                "--set", "train.log_every=1",
                "--set", "model.encoder_dropout=0.0",
                "--set", "model.decoder_dropout=0.0",
                "--set", "frontend.spec_augment=false",
                "--set", f"train.checkpoint_dir={tmp / name}",
                "--set", f"train.metrics_path={tmp / (name + '.jsonl')}",
                *flagship_sets]

    def losses(name: str) -> list:
        return [json.loads(x)["loss"] for x in
                (tmp / f"{name}.jsonl").read_text().splitlines()
                if json.loads(x)["tag"] == "train"]

    def children(tag: str, module: str, argv: list, check_resume=None):
        specs = []
        for rank in range(2):
            spec = tmp / f"{tag}_{rank}.json"
            spec.write_text(json.dumps({
                "kind": "cli", "module": module, "check_resume": check_resume,
                "argv": argv + [
                    "--coordinator", f"file://{tmp / ('rdzv_' + tag)}",
                    "--num-processes", "2", "--process-id", str(rank),
                    "--device", child_dev, "--dist-backend", "gloo"]}))
            specs.append(spec)
        return run_children(f"[20c] {tag}", specs)

    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        cli.main(args("one", 32) + ["--steps", str(D20_STEPS),
                                    "--device", dev.type])
    t_two = time.perf_counter()
    children("train", "train", args("two", 16) + [
        "--steps", str(D20_STEPS), "--set", "train.dp=2",
        "--set", "train.tp=1"])
    t_two = time.perf_counter() - t_two
    one, two = losses("one"), losses("two")
    rel = [abs(a - b) / abs(a) for a, b in zip(one, two)]
    print(f"[20c] flagship through cli.train, {D20_STEPS} steps on [17]'s "
          f"manifest (dropout and SpecAugment off): one process at B=32 "
          f"losses {[round(x, 5) for x in one]}; dp 2 x tp 1 (two processes "
          f"on the card over gloo, B=16 each) {[round(x, 5) for x in two]};"
          f" relative |d loss| max {max(rel):.2e} (tol {TOL_D20_LOSS}); the "
          f"two-process run {t_two:.1f} s with its start-up (no scaling "
          f"number)", flush=True)
    check(len(one) == len(two) == D20_STEPS and max(rel) <= TOL_D20_LOSS,
          "[20c] two-process losses differ from one process's")
    files = sorted(p.name for p in (tmp / "two").iterdir())
    print(f"[20c] two-process checkpoint directory: {files}", flush=True)
    check(files == ["last", "last.config.json", "tokenizer.json"],
          f"[20c] checkpoint directory {files}")
    outs = children("resume", "train", args("two", 16) + [
        "--steps", str(D20_STEPS), "--resume", "--set", "train.dp=1",
        "--set", "train.tp=2"], check_resume=str(tmp / "two"))
    res = [r for out in outs for r in child_results(out)]
    print(f"[20c] --resume at dp 1 x tp 2: {res}", flush=True)
    check(len(res) == 2 and all(r["differ"] == 0 and r["sliced"] > 0
                                for r in res),
          "[20c] the resumed slices differ from the checkpoint")
    dec = ["--config", str(tmp / "two" / "last.config.json"),
           "--checkpoint-tag", "last", "--manifest", str(corpus["dev"])]
    outs = children("decode", "decode", dec)
    got = io.StringIO()
    err = io.StringIO()
    with contextlib.redirect_stdout(got), contextlib.redirect_stderr(err):
        cli_decode.main(dec + ["--device", dev.type])
    wer_one = re.search(r"WER .*", err.getvalue()).group(0)
    wer_two = re.search(r"WER .*", outs[0])
    lines_two = [x for x in outs[0].splitlines() if x.startswith("{")]
    print(f"[20c] cli.decode (greedy) of {len(lines_two)} dev utterances: "
          f"two processes '{wer_two.group(0) if wer_two else None}', one "
          f"'{wer_one}'", flush=True)
    check(wer_two is not None and wer_two.group(0) == wer_one
          and lines_two == got.getvalue().splitlines()
          and not any(x.startswith("{") for x in outs[1].splitlines()),
          "[20c] two-process decode differs from one process's")
    print(f"[20c] done in {time.perf_counter() - t_c:.1f} s; {card}",
          flush=True)


def cli_child(spec: dict, rank: int) -> None:
    """[20c] one rank of a CLI; with `check_resume` (a checkpoint
    directory), every local slice the Solver restores is compared with
    that checkpoint's whole tensor, sliced, bit for bit."""
    import importlib

    from pytorch_end2end_speech_recognition_tpu_torch.parallel.sharding import (
        shard_tensor,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.training import (
        checkpoint,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.training.solver import (
        Solver,
    )

    if spec["check_resume"]:
        saved = checkpoint.load_checkpoint(spec["check_resume"],
                                           "last")["params"]
        load = Solver.load_checkpoint

        def checked(self, tag="last"):
            load(self, tag)
            differ = sliced = 0
            for n, p in zip(self.names, self.params):
                want = saved[n]
                if n in self.dims:
                    want = shard_tensor(want, *self.dims[n], self.mesh.tp,
                                        self.mesh.model_rank)
                    sliced += 1
                differ += int(not torch.equal(p.detach().cpu(), want))
            print("DIST_RESULT " + json.dumps({
                "rank": rank, "differ": differ, "sliced": sliced,
                "params": len(self.names), "step": self.step}), flush=True)

        Solver.load_checkpoint = checked
    importlib.import_module(f"{PKG}.cli.{spec['module']}").main(spec["argv"])


# ---- [21] context and pipeline parallelism without a mesh, profiling, the
# corpus converters and the native library
CP_WINDOWS = 6         # host-clock calls a path in [21a]'s turns
CP_TOL_RTOL, CP_TOL_ATOL = 2e-4, 2e-5  # tests/test_torch_cp.py's outputs


def _plain_attention(q, k, v, diag, lens):
    """Whole-row float32 attention on (B, T, H, D) with the dense bias of
    `diag` and the keys past lens masked: [21c]'s reference, written apart
    from parallel/cp.py's online softmax."""
    from pytorch_end2end_speech_recognition_tpu_torch.ops.attention_kernel import (  # noqa: E501
        toeplitz_expand,
    )

    T, D = q.shape[1], q.shape[3]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(D)
    s = s + toeplitz_expand(diag, T, T)[None]
    keep = torch.arange(T, device=q.device)[None, :] < lens[:, None]
    s = s.masked_fill(~keep[:, None, None, :], float("-inf"))
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    return out * keep[:, :, None, None]


def cp_pp_phase(dev, card, counted, t_start, audio, audio_lens, table,
                batch, spec_mask, V, wer_inputs) -> None:
    """[21] `cp_mode` and `pp_stages` 2 without a mesh at the flagship's
    full width, `sharded_self_attention` with no group, the profiling
    helpers, the corpus converters and the native library; `wer_inputs`
    are [17]'s dev (reference, hypothesis) word lists."""
    import shutil
    import tempfile

    from pytorch_end2end_speech_recognition_tpu_torch import native
    from pytorch_end2end_speech_recognition_tpu_torch.configs.presets import (
        an4_ctc,
        flagship_conformer,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.data.dataset import (
        BucketedLoader,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.data.manifest import (
        read_manifest,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.data.prep import (
        prep_an4,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.data.tokenizer import (
        CharTokenizer,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.metrics import wer
    from pytorch_end2end_speech_recognition_tpu_torch.models.asr import AsrModel
    from pytorch_end2end_speech_recognition_tpu_torch.models.encoders import (
        FfnBlock,
        RelPosBias,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops.attention_kernel import (  # noqa: E501
        flash_fwd,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.parallel.cp import (
        MODES,
        sharded_self_attention,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.training.solver import (
        Solver,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.utils import profiling

    t_phase = time.perf_counter()

    def cfg_of(impl: str, cp: str = "ring", pp: int = 1, ffn: str = "torch"):
        c = flagship_conformer()
        c.model.cp_mode, c.model.pp_stages, c.model.ffn_impl = cp, pp, ffn
        c.model.encoder_dropout = c.model.decoder_dropout = 0.0
        if impl == "torch":
            c.frontend.impl = "torch"
            c.model.attn_impl = c.model.ctc_impl = "torch"
        return c

    def model_of(c):
        return _with_table(AsrModel(c, device=dev, seed=0).eval(), table)

    def solver_of(c):
        sv = make_solver(c, V, dev)
        _with_table(sv.model, table)
        return sv

    def counted_run(fn):
        for f in counted:
            f.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, _launches(counted)

    # [21a] cp_mode without a mesh: the diagonals at T' 750, flash kernels
    L = flagship_conformer().model.encoder_layers
    km = model_of(cfg_of("cuda"))
    check(km.encoder.blocks[0].mhsa.cp_mode == "ring", "[21a] cp_mode lost")
    with torch.inference_mode():
        (enc, elens, logits, _, _), fwd = counted_run(
            lambda: serve(km, audio, audio_lens))
    print(f"[21a] cp_mode='ring' forward launches (B={B} x {SECONDS:.0f} s, "
          f"T' {enc.shape[1]}): {fwd}", flush=True)
    check(fwd == {"logmel": 1, "flash_fwd": L, "subsample": 1},
          f"[21a] cp_mode forward launch counts {fwd}")
    pm = plain_subsampling(model_of(cfg_of("torch")))
    with torch.inference_mode():
        plogits = serve(pm, audio, audio_lens)[2]
    compare(f"[21a] cp_mode='ring' kernels vs plain torch (bf16, {L} L, "
            f"ragged B={B}, T' {enc.shape[1]})", logits, plogits, elens,
            need_sure=True)
    um = model_of(cfg_of("cuda", cp="ulysses"))
    with torch.inference_mode():
        ulogits = serve(um, audio, audio_lens)[2]
    same = torch.equal(ulogits, logits)
    print(f"[21a] cp_mode='ulysses' logits equal to 'ring' bit for bit: "
          f"{same} (max |d| {(ulogits - logits).abs().max().item():.3e})",
          flush=True)
    check(same, "[21a] ulysses and ring differ without a mesh")
    del um
    with torch.no_grad():
        pm.encoder.rel.table.zero_()
    with torch.inference_mode():
        ctl_logits = serve(pm, audio, audio_lens)[2]
    valid = torch.arange(logits.shape[1], device=dev)[None, :] < elens[:, None]
    ctl = (logits - ctl_logits).abs().amax(-1)[valid].max().item()
    print(f"[21a] control, plain model with the diagonals zeroed: max "
          f"|dlogit| {ctl:.4f} (must exceed {TOL_LOGITS})", flush=True)
    check(ctl > TOL_LOGITS, "[21a] the logit tolerance cannot see the bias")
    del pm, ctl_logits, plogits
    dm = model_of(cfg_of("cuda", cp=""))
    with torch.inference_mode():
        _abba(f"[21a] host-clock forward at B={B} x {SECONDS:.0f} s (not a "
              "claim)", [("cp_mode (flash)", lambda: serve(km, audio,
                                                          audio_lens)),
                         ("dense path", lambda: serve(dm, audio,
                                                      audio_lens))],
              2 * CP_WINDOWS, B * SECONDS, card, t_start)
    del km
    ks = solver_of(cfg_of("cuda"))
    (kmet, kg), step = counted_run(lambda: ks.grads(batch,
                                                    spec_mask=spec_mask))
    kg = {n: g.detach() for n, g in zip(ks.names, kg)}
    ps = solver_of(cfg_of("torch"))
    pmet, pg = ps.grads(batch, spec_mask=spec_mask)
    pg = {n: g.detach() for n, g in zip(ps.names, pg)}
    torch.cuda.synchronize()
    del ps
    d_loss = abs(float(kmet["loss"]) - float(pmet["loss"])) / float(
        pmet["loss"])
    cmin, rmax, cmed, n_cmp = grad_stats(kg, pg)
    print(f"[21a] cp_mode kernels vs plain torch, one hybrid step (U<="
          f"{U_TOKENS}): loss {float(kmet['loss']):.5f} vs "
          f"{float(pmet['loss']):.5f}, relative |d loss| {d_loss:.2e} (tol "
          f"{TOL_TRAIN_LOSS}); gradients of {n_cmp} parameters: cosine min "
          f"{cmin:.5f} median {cmed:.5f} (tol {TRAIN_MIN_COS}), relative "
          f"error max {rmax:.4f} (tol {TRAIN_MAX_REL})", flush=True)
    check(d_loss <= TOL_TRAIN_LOSS and cmin >= TRAIN_MIN_COS
          and rmax <= TRAIN_MAX_REL, "[21a] cp_mode step disagrees with plain")
    del kg, pg
    metrics, step = counted_run(lambda: ks.train_step(batch,
                                                      spec_mask=spec_mask))
    print(f"[21a] cp_mode Solver.train_step launches: {step}", flush=True)
    check(step == {"logmel": 1, "flash_fwd": L, "flash_bwd": L,
                   "ctc_alpha": 1, "ctc_beta": 1},
          f"[21a] cp_mode train step launch counts {step}")
    check(math.isfinite(float(metrics["loss"])), "[21a] step not finite")
    ds = solver_of(cfg_of("cuda", cp=""))
    _abba(f"[21a] host-clock Solver.train_step at B={B} x {SECONDS:.0f} s "
          "(not a claim)", [("cp_mode (flash)", lambda: ks.train_step(batch)),
                            ("dense path", lambda: ds.train_step(batch))],
          CP_WINDOWS, B * SECONDS, card, t_start)
    del ks, ds

    # [21b] pp_stages 2 without a mesh: the plain block loop, whose FFN
    # blocks the JAX gate keeps off the fused kernels
    fm = model_of(cfg_of("cuda", cp="", pp=2, ffn="cuda"))
    check(not any(m.fused for m in fm.modules() if isinstance(m, FfnBlock)),
          "[21b] a fused FFN under pp_stages 2")
    with torch.inference_mode():
        pp_logits, pp_fwd = counted_run(
            lambda: serve(fm, audio, audio_lens)[2])
        ref_logits = serve(dm, audio, audio_lens)[2]
    same = torch.equal(pp_logits, ref_logits)
    print(f"[21b] pp_stages 2, ffn_impl=cuda forward launches: {pp_fwd}; "
          f"logits equal to pp_stages 1 with ffn_impl=torch bit for bit: "
          f"{same}", flush=True)
    check("ffn_fwd" not in pp_fwd and pp_fwd.get("attention_fwd") == L,
          f"[21b] pp_stages 2 launch counts {pp_fwd}")
    check(same, "[21b] pp_stages 2 logits differ from pp_stages 1")
    gm = model_of(cfg_of("cuda", cp="", ffn="cuda"))
    with torch.inference_mode():
        _, on = counted_run(lambda: serve(gm, audio, audio_lens))
    check(on.get("ffn_fwd") == 2 * L, f"[21b] gate control: {on}")
    del fm, gm, dm
    fs = solver_of(cfg_of("cuda", cp="", pp=2, ffn="cuda"))
    _, pp_step = counted_run(lambda: fs.train_step(batch))
    print(f"[21b] pp_stages 2 Solver.train_step launches: {pp_step} (the "
          f"control, pp_stages 1 with ffn_impl=cuda: ffn_fwd {on.get('ffn_fwd')} "
          f"in a forward)", flush=True)
    check("ffn_fwd" not in pp_step and "ffn_bwd" not in pp_step,
          f"[21b] FFN kernels under pp_stages 2: {pp_step}")
    del fs

    # [21c] sharded_self_attention with no group (one ring step, Ulysses on
    # every head) at the flagship's per-layer shape, float32
    Bq, T, H, Dh = B, int(enc.shape[1]), 4, 64
    g = torch.Generator(device=dev).manual_seed(21)
    q, k, v = (torch.randn(Bq, T, H, Dh, device=dev, generator=g)
               for _ in range(3))
    rel = RelPosBias(L, H).to(dev)
    with torch.no_grad():
        rel.table.copy_(table)
        diag = rel.diags(T)[0]  # layer 0's (H, 2T-1) at BIAS_STD
    lens = elens.to(torch.int64)
    ref = _plain_attention(q, k, v, diag, lens)
    times = {}
    for mode in MODES:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        timer = profiling.StepTimer()
        for _ in range(4):
            timer.start()
            out = sharded_self_attention(None, q, k, v, lens, mode, diag)
            timer.tick(out)
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        err = float(((out - ref).abs()
                     - CP_TOL_RTOL * ref.abs()).max())
        times[mode] = timer.stats(skip_warmup=1)["p50_s"] * 1e3
        print(f"[21c] sharded_self_attention '{mode}', no group, ({Bq}, {T}, "
              f"{H}, {Dh}) float32 with the diagonals: max(|d| - "
              f"{CP_TOL_RTOL} |ref|) {err:.2e} (tol {CP_TOL_ATOL}); "
              f"StepTimer p50 {times[mode]:.3f} ms, peak "
              f"{peak:.2f} GiB above the inputs; {card}", flush=True)
        check(err <= CP_TOL_ATOL, f"[21c] {mode} differs from plain attention")
    qb, kb, vb = (t.reshape(Bq, T, H * Dh).to(torch.bfloat16)
                  for t in (q, k, v))
    flash_ms = cuda_ms(lambda: flash_fwd(qb, kb, vb, diag, lens, H))
    print(f"[21c] beside kernel #7 (flash forward) at the same shape in "
          f"bf16: {flash_ms:.4f} ms (CUDA events); {card}", flush=True)

    # [21d] the profiling helpers on the card: the profiler in a fresh
    # process (in this one, after [18]'s profiles, it recorded a few or no
    # device kernels)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke21_"))
    try:
        torch.save({"q": q.cpu(), "k": k.cpu(), "v": v.cpu(),
                    "diag": diag.cpu(), "lens": lens.cpu(),
                    "out": str(tmp / "profiled.json")}, tmp / "inputs.pt")
        root = Path(__file__).resolve().parent
        child = subprocess.run(
            [sys.executable, str(root / "chip_smoke.py"), "--profile-child",
             str(tmp / "inputs.pt")], cwd=root, capture_output=True,
            text=True, timeout=300)
        check(child.returncode == 0, "[21d] the profiling process failed:\n"
              + child.stderr[-3000:])
        got = json.loads((tmp / "profiled.json").read_text())
        print(f"[21d] StepTimer.tick after one ring call: {got['tick_ms']:.3f}"
              f" ms; its device time under torch.profiler "
              f"{got['device_ms']:.3f} ms ({got['kernels']} kernels); "
              f"trace(): {got['trace_bytes']} bytes of Chrome trace, the "
              f"flash kernel named: {got['named']} (a fresh process)",
              flush=True)
        check(got["device_ms"] > 0 and got["tick_ms"] >= got["device_ms"],
              "[21d] StepTimer.tick did not wait")
        check(got["named"], "[21d] no flash kernel in trace")
        del q, k, v, ref, out, qb, kb, vb

        # [21e] an AN4 tree -> manifests, the native library, the loader
        root = tmp / "an4"
        (root / "etc").mkdir(parents=True)
        (root / "wav").mkdir()
        from pytorch_end2end_speech_recognition_tpu_torch.data.audio import (
            write_wav,
        )

        rng = np.random.default_rng(21)
        lines = {"train": [], "test": []}
        for split, n in (("train", 10), ("test", 2)):
            for i in range(n):
                uid = f"{split[:2]}{i:03d}-spk1-b"
                x = (np.sin(np.arange(16000 + 3200 * i) * (0.02 + 0.003 * i))
                     * 0.4 + rng.standard_normal(16000 + 3200 * i) * 0.01)
                write_wav(root / "wav" / f"{uid}.wav", x.astype(np.float32),
                          16000)
                lines[split].append(f"<s> WORD{i} UTT </s> ({uid})")
        for split in lines:
            (root / "etc" / f"an4_{split}.transcription").write_text(
                "\n".join(lines[split]))
        prep_an4.main(["--root", str(root), "--out", str(tmp / "man"),
                       "--dev-fraction", "0.2"])
        utts = read_manifest(tmp / "man" / "train.jsonl")
        check(len(utts) == 8, f"[21e] prep_an4 wrote {len(utts)} train utts")
        saved = native.BUILD_ROOT
        native.BUILD_ROOT = tmp / "native"
        t0 = time.perf_counter()
        native.build()
        build_s = time.perf_counter() - t0
        native.BUILD_ROOT = saved
        print(f"[21e] prep_an4: {len(utts)} train utterances; the native "
              f"library built with g++ in {build_s:.2f} s", flush=True)
        cfg = an4_ctc()
        cfg.train.metrics_path = ""
        tok = CharTokenizer([u.text for u in utts])
        loader = BucketedLoader(utts, tok, cfg.data)
        paths = [u.audio for u in utts]
        n_native = native.load_batch_native(
            paths, np.zeros((len(paths), 64000), np.float32),
            np.zeros(len(paths), np.int32))
        nb = next(loader.epoch(0))
        os.environ["ASR_TPU_NO_NATIVE"] = "1"
        try:
            pb = next(loader.epoch(0))
        finally:
            del os.environ["ASR_TPU_NO_NATIVE"]
        same = all(np.array_equal(getattr(nb, f), getattr(pb, f)) for f in
                   ("audio", "audio_lens", "tokens", "token_lens"))
        print(f"[21e] loader batch {nb.audio.shape}: {n_native}/{len(paths)} "
              f"rows decoded natively; native and Python batches equal bit "
              f"for bit: {same}", flush=True)
        check(n_native == len(paths) and same, "[21e] native batch differs")
        solver = Solver(cfg, tok, device=dev)
        metrics, an4 = counted_run(lambda: solver.train_step(nb))
        print(f"[21e] an4_ctc Solver.train_step from that batch: loss "
              f"{float(metrics['loss']):.4f}, launches {an4}", flush=True)
        check(an4 == {"logmel": 1, "lstm_fwd": cfg.model.encoder_layers,
                      "lstm_bwd": cfg.model.encoder_layers, "ctc_alpha": 1,
                      "ctc_beta": 1} and math.isfinite(float(metrics["loss"])),
              f"[21e] an4_ctc step launch counts {an4}")
        del solver
        diff = sum(native.levenshtein(r, h) != wer.edit_distance_np(r, h)
                   for r, h in wer_inputs)
        print(f"[21e] native levenshtein on [17]'s {len(wer_inputs)} dev "
              f"(reference, hypothesis) pairs: {diff} differ from Python's",
              flush=True)
        check(wer_inputs and diff == 0, "[21e] native levenshtein differs")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[21] done in {time.perf_counter() - t_phase:.1f} s; "
          f"{time.perf_counter() - t_start:.0f} s since start", flush=True)


def profile_child(spec_path: str) -> int:
    """[21d]'s profiling, run as `python3 chip_smoke.py --profile-child
    INPUTS` in a fresh process: one ring `sharded_self_attention` call's
    device time under torch.profiler, a `StepTimer.tick` after another,
    and `profiling.trace` of kernel #7 on the same inputs in bf16; writes
    the results as JSON where INPUTS says."""
    import tempfile

    from pytorch_end2end_speech_recognition_tpu_torch.ops.attention_kernel import (  # noqa: E501
        flash_fwd,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.parallel.cp import (
        sharded_self_attention,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.utils import profiling

    data = torch.load(spec_path, weights_only=False)
    dev = torch.device("cuda")
    q, k, v, diag, lens = (data[n].to(dev) for n in
                           ("q", "k", "v", "diag", "lens"))
    B, T, H, Dh = q.shape

    def call():
        return sharded_self_attention(None, q, k, v, lens, "ring", diag)

    _, kernel_ms, n = profile_step(call, 1)
    timer = profiling.StepTimer()
    call()
    torch.cuda.synchronize()
    timer.start()
    tick_ms = timer.tick(call()) * 1e3
    qb, kb, vb = (t.reshape(B, T, H * Dh).to(torch.bfloat16)
                  for t in (q, k, v))
    flash_fwd(qb, kb, vb, diag, lens, H)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp):
            flash_fwd(qb, kb, vb, diag, lens, H)
            torch.cuda.synchronize()
        text = (Path(tmp) / "trace.json").read_text()
    Path(data["out"]).write_text(json.dumps({
        "device_ms": sum(kernel_ms.values()), "kernels": n,
        "tick_ms": tick_ms, "trace_bytes": len(text),
        "named": "attention_fwd_kernel" in text}))
    return 0


def counted_wrappers():
    """The kernel wrappers with launch counters, as main() counts them."""
    from pytorch_end2end_speech_recognition_tpu_torch.ops.attention_kernel import (  # noqa: E501
        attention_bwd,
        attention_fwd,
        flash_bwd,
        flash_fwd,
        toeplitz_fwd,
        toeplitz_reduce,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops.ctc_kernel import (
        ctc_alpha,
        ctc_beta,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops.ctc_prefix import (
        ctc_prefix_score,
        ctc_prefix_select,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops.ffn_kernel import (
        ffn_bwd,
        ffn_fwd,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops.frontend_kernel import (
        logmel,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops.rnn_kernel import (
        lstm_bwd,
        lstm_fwd,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops.subsample_kernel import (  # noqa: E501
        subsample,
    )

    return (logmel, toeplitz_fwd, attention_fwd, attention_bwd,
            toeplitz_reduce, ctc_alpha, ctc_beta, flash_fwd, flash_bwd,
            lstm_fwd, lstm_bwd, ffn_fwd, ffn_bwd, ctc_prefix_score,
            ctc_prefix_select, subsample)


def dist_child(spec_path: str, rank: int) -> int:
    """A child rank of [20b] or [20c]."""
    spec = json.loads(Path(spec_path).read_text())
    if spec["kind"] == "r5":
        rung5_child(spec, rank)
    else:
        cli_child(spec, rank)
    return 0


def train_seed_sweep(seeds: list[int]) -> int:
    """`python3 chip_smoke.py --train-seeds 0,1,2`: the train-step
    comparisons of [8] (the kernels, ffn_impl=torch) and [13]
    (ffn_impl=cuda) against plain torch, at [8]'s size and weights, on a
    fresh draw of the batch, SpecAugment mask and relative-bias table per
    seed. Prints, per seed and comparison, the loss difference and the
    three lowest gradient cosines with their parameters, and the largest
    relative error; the spread that TRAIN_MIN_COS must clear."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 2
    from pytorch_end2end_speech_recognition_tpu_torch.configs.presets import (
        flagship_conformer,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.data.dataset import Batch
    from pytorch_end2end_speech_recognition_tpu_torch.ops import _build
    from pytorch_end2end_speech_recognition_tpu_torch.ops import frontend as fe
    from pytorch_end2end_speech_recognition_tpu_torch.ops.specaugment import (
        spec_augment_mask,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.utils import device as dv
    from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
        resolve_device,
    )

    dev = torch.device("cuda")
    dv.set_tf32(False)
    card = dv.card_info()
    _build.build()
    _build.load()
    mcfg = resolve_device(flagship_conformer(), dev).model
    fcfg = resolve_device(flagship_conformer(), dev).frontend
    V, L, H = mcfg.vocab_size, mcfg.encoder_layers, mcfg.encoder_heads
    Ts = int(SECONDS * SR)
    front = fe.Frontend(fcfg, dev)
    n_frames = front.n_frames(Ts)
    host = lambda t: t.cpu().numpy()  # noqa: E731

    def cfg(impl: str, ffn: str):
        c = flagship_conformer()
        c.model.encoder_dropout = c.model.decoder_dropout = 0.0
        c.model.ffn_impl = ffn
        if impl == "torch":
            c.frontend.impl = "torch"
            c.model.attn_impl = c.model.ctc_impl = "torch"
        return c

    lowest = {}
    for seed in seeds:
        gen = torch.Generator(device=dev).manual_seed(seed)
        audio = speechlike(B, Ts, gen, dev)
        lens = torch.full((B,), Ts, dtype=torch.int64, device=dev)
        lens[1::2] = torch.randint(SR, Ts + 1, (B // 2,), device=dev,
                                   generator=gen)
        table = torch.randn(L, H, 64, device=dev, generator=gen) * BIAS_STD
        nf = (lens - WIN) // HOP + 1
        enc_lens = ((nf + 1) // 2 + 1) // 2
        tok = 1 + torch.cumsum(torch.randint(
            1, V - 1, (B, U_TOKENS), device=dev, generator=gen), 1) % (V - 1)
        tok_lens = torch.minimum(torch.randint(
            U_TOKENS // 2, U_TOKENS + 1, (B,), device=dev, generator=gen),
            enc_lens // 2)
        tok = tok * (torch.arange(U_TOKENS, device=dev)[None, :]
                     < tok_lens[:, None])
        batch = Batch(host(audio), host(lens).astype(np.int32),
                      host(tok).astype(np.int32),
                      host(tok_lens).astype(np.int32))
        spec_mask = spec_augment_mask(front.frame_lens(lens), n_frames,
                                      fcfg.n_mels, fcfg, gen)
        res = {}
        for tag, c in (("plain", cfg("torch", "torch")),
                       ("[8]", cfg("cuda", "torch")),
                       ("[13]", cfg("cuda", "cuda"))):
            sv = make_solver(c, V, dev)
            with torch.no_grad():
                sv.model.encoder.rel.table.copy_(table)
            m, g = sv.grads(batch, spec_mask=spec_mask)
            res[tag] = (float(m["loss"]),
                        {n: t.detach() for n, t in zip(sv.names, g)})
            del sv, g
        for tag in ("[8]", "[13]"):
            rows = grad_table(res[tag][1], res["plain"][1])
            d_loss = abs(res[tag][0] - res["plain"][0]) / res["plain"][0]
            worst = max(rows, key=lambda r: r[1])
            lowest.setdefault(tag, []).append((rows[0][0], worst[1], d_loss))
            print(f"[sweep] seed {seed} {tag} vs plain: relative |d loss| "
                  f"{d_loss:.2e}; lowest cosines " + ", ".join(
                      f"{n} {c:.5f} (rel {r:.4f})" for c, r, n in rows[:3])
                  + f"; largest relative error {worst[1]:.4f} ({worst[2]})",
                  flush=True)
        del res
    for tag, v in lowest.items():
        cos, rel, dl = zip(*v)
        print(f"[sweep] {tag} over seeds {seeds}: lowest cosine "
              f"{min(cos):.5f} (each: {[round(c, 5) for c in cos]}; tol "
              f"{TRAIN_MIN_COS}), largest relative error {max(rel):.4f} (tol "
              f"{TRAIN_MAX_REL}), largest relative |d loss| {max(dl):.2e} "
              f"(tol {TOL_TRAIN_LOSS}); {card}", flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    from pytorch_end2end_speech_recognition_tpu_torch.configs.presets import (
        flagship_conformer,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.models.asr import AsrModel
    from pytorch_end2end_speech_recognition_tpu_torch.models.encoders import (
        FLASH_T,
        RelPosBias,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops import _build
    from pytorch_end2end_speech_recognition_tpu_torch.ops import frontend as fe
    from pytorch_end2end_speech_recognition_tpu_torch.ops.attention_kernel import (
        attention_bwd,
        attention_bwd_plain,
        attention_fwd,
        attention_plain,
        flash_bwd,
        flash_bwd_plain,
        flash_fwd,
        flash_fwd_plain,
        fused_attention,
        toeplitz_expand,
        toeplitz_fwd,
        toeplitz_reduce,
        toeplitz_reduce_plain,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops.ctc import (
        ctc_loss,
        lattice_inputs,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops.ctc_kernel import (
        ctc_alpha,
        ctc_alpha_plain,
        ctc_beta,
        ctc_beta_plain,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops.frontend_kernel import (
        logmel,
        logmel_plain,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.utils import device as dv
    from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
        FrontendConfig,
        resolve_device,
    )

    from pytorch_end2end_speech_recognition_tpu_torch.ops.ffn_kernel import (
        ffn_bwd,
        ffn_fwd,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops.rnn_kernel import (
        lstm_bwd,
        lstm_fwd,
    )

    from pytorch_end2end_speech_recognition_tpu_torch.ops.ctc_prefix import (
        ctc_prefix_score,
        ctc_prefix_select,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops.subsample_kernel import (  # noqa: E501
        subsample,
    )

    COUNTED = (logmel, toeplitz_fwd, attention_fwd, attention_bwd,
               toeplitz_reduce, ctc_alpha, ctc_beta, flash_fwd, flash_bwd,
               lstm_fwd, lstm_bwd, ffn_fwd, ffn_bwd, ctc_prefix_score,
               ctc_prefix_select, subsample)
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    dv.set_tf32(False)
    peaks = dv.H100_PEAKS
    card = dv.card_info()
    name = torch.cuda.get_device_name(0)
    print(f"[1] python {platform.python_version()} torch {torch.__version__} "
          f"cuda {torch.version.cuda} card '{name}' ({card})", flush=True)

    t0 = time.perf_counter()
    parent_build = start_parent_build()
    lib_path, log = _build.build()
    parent = ParentToeplitz(*parent_build)
    print(f"[2] built {lib_path} and the parent Toeplitz probe in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    lines = log.splitlines()
    for line in lines:
        if any(w in line for w in ("registers", "Compiling entry", "spill",
                                   "error")):
            print("    " + line.strip())
    # the wgmma/TMA kernels (namespace hop): registers and spills, from the
    # ptxas -v lines that follow each entry. The warp-specialised ones move
    # registers with setmaxnreg, which hangs unless ptxas compiled them at
    # exactly 65,536 / threads: checked here, before any of them launches.
    ws_threads = {"attention_fwd_kernel": 512, "ffn_fwd_wgmma_kernel": 384,
                  "attn_bwd_delta_kernel": 384, "attn_bwd_main_kernel": 384,
                  "attn_bwd_dbias_kernel": 384,
                  "ffn_bwd_rows_wgmma_kernel": 384,
                  "ffn_bwd_weights_wgmma_kernel": 384,
                  "logmel_wgmma_kernel": 384,
                  "subsample_conv_wgmma_kernel": 384}
    for i, line in enumerate(lines):
        m = re.search(r"hop\d+([a-z_]+)(?:I(Li(\d+)E|f|13__nv_bfloat16)|E)",
                      line)
        if "Compiling entry" in line and m:
            info = " ".join(lines[i + 1:i + 5])
            regs = re.search(r"Used (\d+) registers", info)
            spill = re.search(r"(\d+) bytes spill stores", info)
            targ = (f"NW {m.group(3)}" if m.group(1).startswith("subsample")
                    else f"bias mode {m.group(3)}" if m.group(3) else
                    {"f": "float32 x", "13__nv_bfloat16": "bf16 x",
                     None: "dense bias" if m.group(1).startswith("attn")
                     else "bf16"}[m.group(2)])
            need = (65536 // ws_threads[m.group(1)] // 8 * 8
                    if m.group(1) in ws_threads else None)
            print(f"[2] wgmma kernel {m.group(1)} ({targ}): "
                  f"{regs.group(1) if regs else '?'} registers"
                  + (f" (65,536 / {ws_threads[m.group(1)]} threads: {need})"
                     if need else "")
                  + f", {spill.group(1) if spill else '?'} bytes spilled",
                  flush=True)
            check(need is None or (regs and int(regs.group(1)) == need),
                  f"{m.group(1)} ({targ}) not compiled at {need} registers: "
                  "its setmaxnreg would hang")
            check(need is None or (spill and int(spill.group(1)) == 0),
                  f"{m.group(1)} ({targ}) spills registers")
    # the LSTM cluster kernels, one instantiation per rows-per-cluster R
    lstm_regs = []
    for i, line in enumerate(lines):
        m = re.search(r"lstm_(fwd|bwd)_kernelILi(\d+)E", line)
        if "Compiling entry" in line and m:
            info = " ".join(lines[i + 1:i + 5])
            regs = re.search(r"Used (\d+) registers", info)
            spill = re.search(r"(\d+) bytes spill stores", info)
            lstm_regs.append(f"{m.group(1)} R={m.group(2)} "
                             f"{regs.group(1) if regs else '?'}/"
                             f"{spill.group(1) if spill else '?'}")
    print("[2] LSTM cluster kernels, registers/bytes spilled: "
          + ", ".join(sorted(lstm_regs)), flush=True)
    lib = _build.load()
    from pytorch_end2end_speech_recognition_tpu_torch.ops.rnn_kernel import (
        lstm_plan,
    )
    for tag, HH in (("an4_ctc", 256), ("wsj_las", 320)):
        for which in (False, True):
            p = lstm_plan(which, 2, B, HH)
            print(f"[2] LSTM {'backward' if which else 'forward'} plan, "
                  f"{tag} (two directions, B={B}, H {HH}): cluster size "
                  f"{p['cluster']}, {p['rows']} rows a cluster, "
                  f"{p['clusters']} clusters, "
                  f"cudaOccupancyMaxActiveClusters {p['clusters_at_once']}, "
                  f"{p['threads']} threads, {p['smem_bytes']} B shared",
                  flush=True)
    print("[2] wgmma kernels' dynamic shared memory (no bias, dense, "
          "diagonals): " + "; ".join(
              f"{kn} " + ", ".join(f"{lib.attention_smem_bytes(w, i)}"
                                   for i in range(3)) + " B"
              for w, kn in enumerate(("attention_fwd_kernel",
                                      "attn_bwd_delta_kernel",
                                      "attn_bwd_main_kernel")))
          + f"; attn_bwd_dbias_kernel {lib.attention_smem_bytes(3, 1)} B"
          + "; " + ", ".join(
              f"{kn} {lib.ffn_smem_bytes(w)} B" for w, kn in enumerate((
                  "ffn_fwd_wgmma_kernel", "ffn_bwd_rows_wgmma_kernel",
                  "ffn_bwd_weights_wgmma_kernel")))
          + f"; logmel_wgmma_kernel {lib.logmel_smem_bytes()} B (one "
          "block an SM; a block may take 232,448)", flush=True)

    cfg = resolve_device(flagship_conformer(), dev)
    fcfg, mcfg = cfg.frontend, cfg.model
    gen = torch.Generator(device=dev).manual_seed(0)
    Ts = int(SECONDS * SR)
    audio = speechlike(B, Ts, gen, dev)
    full_lens = torch.full((B,), Ts, dtype=torch.int64, device=dev)
    # the main path's batch: even rows full, odd rows from 1 s to 30 s
    audio_lens = full_lens.clone()
    audio_lens[1::2] = torch.randint(SR, Ts + 1, (B // 2,), device=dev,
                                     generator=gen)
    kernels = {}

    # ---- [3a] log-mel at the main path's shapes (bf16 DFT operands) and f32
    front = fe.Frontend(fcfg, dev)
    n_frames = front.n_frames(Ts)
    logmel_kernel_phase(dev, front, audio, audio_lens, full_lens, n_frames,
                        peaks, card, kernels)

    # ---- [3b] Toeplitz expansion of all 12 layers x 4 heads, and of rung
    # 4's 16 layers x 8 heads at the same frames
    T_enc = ((n_frames + 1) // 2 + 1) // 2
    P = -(-T_enc // 128) * 128
    table = torch.randn(mcfg.encoder_layers, mcfg.encoder_heads, 64,
                        device=dev, generator=gen) * BIAS_STD
    rel = RelPosBias(mcfg.encoder_layers, mcfg.encoder_heads).to(dev)
    with torch.no_grad():
        rel.table.copy_(table)
        diag = rel.diags(T_enc).reshape(-1, 2 * T_enc - 1).contiguous()
    kernels["toeplitz"] = toeplitz_expand_phase("flagship", diag, T_enc, P,
                                                parent, peaks, card)
    gen4 = torch.Generator(device=dev).manual_seed(4)
    rel4 = RelPosBias(16, 8).to(dev)
    with torch.no_grad():
        rel4.table.copy_(torch.randn(16, 8, 64, device=dev, generator=gen4)
                         * BIAS_STD)
        diag4 = rel4.diags(T_enc).reshape(-1, 2 * T_enc - 1).contiguous()
    toeplitz_expand_phase("rung 4", diag4, T_enc, P, parent, peaks, card)
    del rel4, diag4
    # the first layer's (H, P, P) bias, std BIAS_STD
    bias = toeplitz_fwd(diag, T_enc, P, torch.bfloat16)[:mcfg.encoder_heads]

    # ---- [3c] attention: one layer's q/k/v at the main path's shape
    H, D = mcfg.encoder_heads, mcfg.encoder_dim
    Dh = D // H
    mk = lambda: torch.randn(B, T_enc, D, device=dev, generator=gen).to(
        torch.bfloat16)
    q, k, v = mk(), mk(), mk()
    full = torch.full((B,), T_enc, dtype=torch.int32, device=dev)
    ragged = torch.randint(1, T_enc + 1, (B,), device=dev, generator=gen,
                           dtype=torch.int32)
    ragged[0], ragged[1], ragged[2] = 1, 2, T_enc

    def attn_excess(out, lens, bias_ref=bias):
        """(max |out - plain| on valid rows, share of valid elements beyond
        the bf16 tolerance) against the plain version with `bias_ref`."""
        ref = attention_plain(q, k, v, bias_ref, lens, H).float()
        pv = attention_plain(q, k, v.abs(), bias_ref, lens, H).float()
        valid = (torch.arange(T_enc, device=dev)[None, :]
                 < lens[:, None])[..., None].expand_as(ref)
        diff = (out.float() - ref).abs()
        over = (diff > ATTN_RTOL * ref.abs() + ATTN_VTOL * pv) & valid
        return diff[valid].max().item(), over.sum().item() / valid.sum().item()

    attn_err = 0.0
    for tag, lens in (("ragged", ragged), ("full", full)):
        err, share = attn_excess(fused_attention(q, k, v, bias, lens, H), lens)
        attn_err = max(attn_err, err)
        print(f"[3] attention {tag} lens: max |kernel - plain| on valid rows "
              f"= {err:.3e}; share beyond 2^-7|o| + 2^-6 p.|v|: {share:.3e}",
              flush=True)
        check(share == 0.0, f"attention ({tag}) disagrees ({err}, {share})")
    # controls: a kernel that dropped the bias, or ignored the lengths, must
    # fail the same check
    for tag, out in (
            ("bias dropped", fused_attention(q, k, v, None, ragged, H)),
            ("lengths ignored", fused_attention(q, k, v, bias, full, H))):
        err, share = attn_excess(out, ragged)
        print(f"[3] attention control, {tag}: max |diff| {err:.3e}, share "
              f"beyond tolerance {share:.3e} (must be > 0)", flush=True)
        check(share > 0.0, f"attention control '{tag}' passed the check")
    qh, kh, vh = (t.view(B, T_enc, H, Dh).transpose(1, 2).contiguous()
                  for t in (q, k, v))
    key_ok = torch.arange(T_enc, device=dev)[None, :] < full[:, None]
    sdpa_mask = (bias[None, :, :T_enc, :T_enc].float()
                 + torch.where(key_ok, 0.0, float("-inf"))[:, None, None, :]
                 ).to(torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    flops = 4.0 * H * T_enc * Dh * float(full.sum())
    b_ms, b_by = bound(  # q, k, v read, an output of q's shape written
        nbytes(q, k, v, q, full) + H * T_enc * T_enc * bias.element_size(),
        flops / peaks["bf16_flops"], peaks)
    turns = turns_ms({
        "kernel": lambda: attention_fwd(q, k, v, bias, full, H),
        "library": lambda: sdpa(qh, kh, vh, attn_mask=sdpa_mask)})
    kernels["attention"] = dict(
        name="attention", route="cuda", source=f"{PKG}/csrc/attention.cu",
        replaces="pytorch_end2end_speech_recognition_tpu/ops/"
                 "attention_pallas.py:82",
        max_abs_err=attn_err, ms=turns["kernel"],
        plain_ms=cuda_ms(lambda: attention_plain(q, k, v, bias, full, H)),
        bound_ms=b_ms, bound_by=b_by, library_ms=turns["library"])
    print_turns("[3] attention forward (wgmma) B=32 x T' "
                f"{T_enc}", turns, flops, b_ms, card)
    # the same against SDPA on the bias alone, broadcast over the batch
    # ((1, H, T, T): all keys valid at full lengths), which reads 32x less
    # mask than the yardstick above
    bcast = bias[None, :, :T_enc, :T_enc].contiguous()
    print_turns("[3] attention forward (wgmma) against SDPA with the "
                "batch-broadcast bias", turns_ms({
                    "kernel": lambda: attention_fwd(q, k, v, bias, full, H),
                    "library": lambda: sdpa(qh, kh, vh, attn_mask=bcast)}),
                flops, b_ms, card)
    del qh, kh, vh, sdpa_mask, bcast
    nobias_attention_phase(dev, peaks, card)

    # ---- [3d] Toeplitz reduce: the cotangent of every layer's bias block,
    # bf16 with a zero pad band (as the attention backward leaves it), at
    # the flagship's 12 x 4 blocks and rung 4's 16 x 8
    N = mcfg.encoder_layers * H
    core = torch.randn(N, T_enc, T_enc, device=dev, generator=gen)
    kernels["toeplitz_reduce"] = toeplitz_reduce_phase(
        "flagship", core, P, gen4, parent, peaks, card)
    core4 = torch.randn(128, T_enc, T_enc, device=dev, generator=gen4)
    toeplitz_reduce_phase("rung 4", core4, P, gen4, parent, peaks, card)
    del core, core4

    # ---- [3e] attention backward at the main path's shape: ragged lens
    # with a pad row (lens 0) and full lens; the cotangent is zero past each
    # row's length, as on the training path
    ragged_b = ragged.clone()
    ragged_b[3] = 0
    g_out = torch.randn(B, T_enc, D, device=dev, generator=gen).to(
        torch.bfloat16)

    def masked_g(gg, lens):
        ok = torch.arange(gg.shape[1], device=dev)[None, :] < lens[:, None]
        return gg * ok[..., None].to(gg.dtype)

    def bwd_excess(qq, kk, vv, bb, lens, gg, HH, got, bias_ref="same",
                   lens_ref=None):
        """(max |kernel - plain|, share of elements beyond the bound) over
        dq, dk, dv and dbias, against the plain backward on `bias_ref` and
        `lens_ref` (default: the kernel's own)."""
        bias_ref = bb if bias_ref == "same" else bias_ref
        lens_ref = lens if lens_ref is None else lens_ref
        want = attention_bwd_plain(qq, kk, vv, bias_ref, lens_ref, gg, HH)
        mags = attn_bwd_magnitudes(qq, kk, vv, bias_ref, lens_ref, gg, HH)
        errs, over, total = [0.0], 0, 0
        for a, w, m in zip(got, want, mags):
            if a is None or w is None:
                continue
            d = (a.float() - w.float()).abs()
            errs.append(d.max().item())
            over += int((d > ATTN_BWD_TOL * (w.float().abs() + m)).sum())
            total += d.numel()
        return max(errs), over / total

    bwd_err = 0.0
    for tag, lens in (("ragged + pad row", ragged_b), ("full", full)):
        gg = masked_g(g_out, lens)
        _, lse = attention_fwd(q, k, v, bias, lens, H, with_lse=True)
        got = attention_bwd(q, k, v, bias, lens, gg, lse, H)
        n_diff = bits_differ(got, attention_bwd(q, k, v, bias, lens, gg, lse,
                                                H))
        print(f"[3] attention backward determinism ({tag} lens): two "
              f"launches differ in {n_diff} elements of dq, dk, dv and dbias"
              " (must be 0)", flush=True)
        check(n_diff == 0, "attention backward is not deterministic")
        err, share = bwd_excess(q, k, v, bias, lens, gg, H, got)
        bwd_err = max(bwd_err, err)
        print(f"[3] attention backward {tag} lens: max |kernel - plain| = "
              f"{err:.3e}; share beyond 2^-7 (|plain| + m): {share:.3e}",
              flush=True)
        check(share == 0.0, f"attention backward ({tag}) disagrees "
              f"({err}, {share})")
        del got
    gg = masked_g(g_out, ragged_b)
    for tag, bb, lens in (("bias dropped", None, ragged_b),
                          ("lengths ignored", bias, full)):
        _, lse = attention_fwd(q, k, v, bb, lens, H, with_lse=True)
        got = attention_bwd(q, k, v, bb, lens, gg, lse, H)
        err, share = bwd_excess(q, k, v, bb, lens, gg, H, got, bias_ref=bias,
                                lens_ref=ragged_b)
        print(f"[3] attention backward control, {tag}: max |diff| {err:.3e},"
              f" share beyond the bound {share:.3e} (must be > 0)", flush=True)
        check(share > 0.0, f"attention backward control '{tag}' passed")
        del got
    gg = g_out
    _, lse = attention_fwd(q, k, v, bias, full, H, with_lse=True)
    qh, kh, vh = (heads_of(t, H).to(torch.bfloat16).requires_grad_()
                  for t in (q, k, v))
    gh = heads_of(gg, H).to(torch.bfloat16)
    key_ok = torch.arange(T_enc, device=dev)[None, :] < full[:, None]
    lib_mask = (bias[None, :, :T_enc, :T_enc].float()
                + torch.where(key_ok, 0.0, float("-inf"))[:, None, None, :]
                ).to(torch.bfloat16).expand(B, H, T_enc, T_enc).contiguous()
    lib_mask.requires_grad_()

    def sdpa_fwd_bwd():
        o = sdpa(qh, kh, vh, attn_mask=lib_mask)
        return torch.autograd.grad(o, (qh, kh, vh, lib_mask), gh)

    flops = 10.0 * H * T_enc * Dh * float(full.sum())
    b_ms, b_by = bound(  # q, k, v, g read; dq, dk, dv written; bias core
        # read, dbias (H, P, P) written, lse read
        7 * nbytes(q) + H * T_enc * T_enc * 2 + nbytes(bias) + nbytes(lse),
        flops / peaks["bf16_flops"], peaks)
    turns = turns_ms({
        "kernel": lambda: attention_bwd(q, k, v, bias, full, gg, lse, H),
        "library": sdpa_fwd_bwd}, iters=20)
    print_turns(f"[3] attention backward (wgmma) B={B} x T' {T_enc}", turns,
                flops, b_ms, card, iters=20)
    print_split("[3] attention backward", kernel_split(
        lambda: attention_bwd(q, k, v, bias, full, gg, lse, H)), card)
    kernels["attention_bwd"] = dict(
        name="attention_bwd", route="cuda", source=f"{PKG}/csrc/attention.cu",
        replaces="pytorch_end2end_speech_recognition_tpu/ops/"
                 "attention_pallas.py:281",
        max_abs_err=bwd_err, ms=turns["kernel"],
        plain_ms=cuda_ms(
            lambda: attention_bwd_plain(q, k, v, bias, full, gg, H), iters=5),
        bound_ms=b_ms, bound_by=b_by, library_ms=turns["library"])
    print("[3] attention backward library yardstick: SDPA forward + backward"
          " with the float bias as attn_mask requiring grad", flush=True)
    del q, k, v, qh, kh, vh, gh, lib_mask, g_out, gg, lse

    # ---- [3f] the same backward at rung 4's width (d512, H8, T 750), the
    # shape the JAX package routes through its head-split kernel (#5)
    H4, D4, B4 = 8, 512, 8
    mk4 = lambda *sh: torch.randn(*sh, device=dev, generator=gen).to(
        torch.bfloat16)
    q4, k4, v4 = mk4(B4, T_enc, D4), mk4(B4, T_enc, D4), mk4(B4, T_enc, D4)
    bias4 = torch.zeros(H4, P, P, device=dev, dtype=torch.bfloat16)
    bias4[:, :T_enc, :T_enc] = (mk4(H4, T_enc, T_enc).float() * BIAS_STD
                                ).to(torch.bfloat16)
    lens4 = torch.randint(1, T_enc + 1, (B4,), device=dev, generator=gen)
    lens4[0], lens4[1] = T_enc, 0
    g4 = masked_g(mk4(B4, T_enc, D4), lens4)
    _, lse4 = attention_fwd(q4, k4, v4, bias4, lens4, H4, with_lse=True)
    got4 = attention_bwd(q4, k4, v4, bias4, lens4, g4, lse4, H4)
    err, share = bwd_excess(q4, k4, v4, bias4, lens4, g4, H4, got4)
    print(f"[3] attention backward at rung 4's shape (B {B4}, T {T_enc}, "
          f"d{D4}, H{H4}): max |kernel - plain| {err:.3e}, share beyond the "
          f"bound {share:.3e}", flush=True)
    check(share == 0.0, f"attention backward at rung 4's shape ({share})")
    flops4 = 10.0 * H4 * T_enc * (D4 // H4) * float(lens4.sum())
    b_ms, b_by = bound(7 * nbytes(q4) + H4 * T_enc * T_enc * 2
                       + nbytes(bias4) + nbytes(lse4),
                       flops4 / peaks["bf16_flops"], peaks)
    plain4 = cuda_ms(lambda: attention_bwd_plain(q4, k4, v4, bias4, lens4,
                                                 g4, H4), iters=5)
    # library yardstick: SDPA forward + backward with the float bias (and
    # the key mask; the pad row at length 1, as SDPA takes no empty row) as
    # an attn_mask that requires grad, as in [3e]
    qh4, kh4, vh4 = (heads_of(t, H4).to(torch.bfloat16).requires_grad_()
                     for t in (q4, k4, v4))
    gh4 = heads_of(g4, H4).to(torch.bfloat16)
    key_ok4 = (torch.arange(T_enc, device=dev)[None, :]
               < lens4.clamp(min=1)[:, None])
    mask4 = (bias4[None, :, :T_enc, :T_enc].float()
             + torch.where(key_ok4, 0.0, float("-inf"))[:, None, None, :]
             ).to(torch.bfloat16).contiguous().requires_grad_()
    turns4 = turns_ms({
        "kernel": lambda: attention_bwd(q4, k4, v4, bias4, lens4, g4, lse4,
                                        H4),
        "library": lambda: torch.autograd.grad(
            sdpa(qh4, kh4, vh4, attn_mask=mask4), (qh4, kh4, vh4, mask4),
            gh4)}, iters=20)
    print_turns("[3] attention backward (wgmma) at rung 4's shape", turns4,
                flops4, b_ms, card, iters=20)
    print_split("[3] attention backward at rung 4's shape", kernel_split(
        lambda: attention_bwd(q4, k4, v4, bias4, lens4, g4, lse4, H4)), card)
    print(f"[3] attention backward at rung 4's shape: kernel "
          f"{turns4['kernel']:.4f} ms, plain {plain4:.4f} ms, SDPA fwd + bwd "
          f"{turns4['library']:.4f} ms, bound {b_ms:.4f} ms ({b_by}); {card}",
          flush=True)
    del q4, k4, v4, bias4, g4, lse4, got4, qh4, kh4, vh4, gh4, mask4

    # ---- [3h] long-audio flash attention, forward (TPU kernel 7) and
    # backward (kernel 8): the bias as float32 diagonals of a std-BIAS_STD
    # table, at the long paths' shape (B=16 x T' 1,638, H4, D256), at
    # B=4 x T' 3,000, and at rung 5's width (B=8 x T 750, H16, D1024), where
    # the JAX package's rule also takes the diagonals
    T_long = ((n_frames_of(LONG_SAMPLES) + 1) // 2 + 1) // 2

    def flash_inputs(BB, TT, HH, DD):
        tbl = RelPosBias(1, HH).to(dev)
        with torch.no_grad():
            tbl.table.copy_(torch.randn(1, HH, 64, device=dev, generator=gen)
                            * BIAS_STD)
            dd = tbl.diags(TT)[0].contiguous()
        mk_ = lambda: torch.randn(BB, TT, DD, device=dev, generator=gen).to(
            torch.bfloat16)
        full_ = torch.full((BB,), TT, dtype=torch.int32, device=dev)
        rag = torch.randint(1, TT + 1, (BB,), device=dev, generator=gen,
                            dtype=torch.int32)
        rag[0], rag[1] = TT, 1
        rag_b = rag.clone()
        rag_b[2] = 0   # the backward's ragged lengths hold a pad row
        return mk_(), mk_(), mk_(), mk_(), dd, full_, rag, rag_b

    def flash_excess(out, qq, kk, vv, dd, lens, HH):
        """(max |out - plain| on valid rows, share of valid elements beyond
        2^-7|o| + 2^-6 p.|v|) against the plain flash forward with dd."""
        ref = flash_fwd_plain(qq, kk, vv, dd, lens, HH).float()
        pv = flash_fwd_plain(qq, kk, vv.abs(), dd, lens, HH).float()
        valid = (torch.arange(qq.shape[1], device=dev)[None, :]
                 < lens[:, None])[..., None].expand_as(ref)
        diff = (out.float() - ref).abs()
        over = (diff > ATTN_RTOL * ref.abs() + ATTN_VTOL * pv) & valid
        return diff[valid].max().item(), over.sum().item() / valid.sum().item()

    def flash_bwd_ref(qq, kk, vv, dd, lens, gg, HH):
        """(the plain flash backward, its bounds' magnitude terms); ddiag's
        term is the per-diagonal sum of the dense m_dbias."""
        TT = qq.shape[1]
        want = flash_bwd_plain(qq, kk, vv, dd, lens, gg, HH)
        mags = list(attn_bwd_magnitudes(qq, kk, vv, toeplitz_expand(dd, TT, TT),
                                        lens, gg, HH))
        mags[3] = toeplitz_reduce_plain(mags[3], TT)
        return want, mags

    def flash_bwd_excess(got, ref):
        """Against `ref` from flash_bwd_ref: (max |kernel - plain|, share
        beyond the bound, largest ratio to the bound, median of bound /
        |plain|) over dq, dk and dv (2^-7) and the same over ddiag
        (flash_ddiag_tol); outputs that are None in `got` are not
        compared."""
        want, mags = ref
        BB, TT = want[0].shape[:2]
        tols = (ATTN_BWD_TOL,) * 3 + (flash_ddiag_tol(BB, TT),)
        res = []
        for group in ((0, 1, 2), (3,)):
            errs, worst, over, total, ratios = [0.0], [0.0], 0, 0, []
            for i in group:
                if got[i] is None:
                    continue
                w = want[i].float().abs()
                lim = tols[i] * (w + mags[i])
                d = (got[i].float() - want[i].float()).abs()
                errs.append(d.max().item())
                worst.append((d / lim.clamp_min(1e-30)).max().item())
                over += int((d > lim).sum())
                total += d.numel()
                ratios.append((lim / w.clamp_min(1e-30)).flatten())
            ratio = torch.cat(ratios).median().item() if ratios else 0.0
            res.append((max(errs), over / max(total, 1), max(worst), ratio))
        return res

    flash_err, flash_bwd_err = 0.0, 0.0
    for si, (tag, BB, TT, HH, DD) in enumerate((
            (f"B={LONG_B} x T' {T_long}", LONG_B, T_long, H, D),
            ("B=4 x T' 3000", 4, 3000, H, D),
            ("rung 5's width, B=8 x T 750, H16, D1024", 8, T_enc, 16, 1024))):
        fq, fk, fv, fg, fd, ffull, frag, frag_b = flash_inputs(BB, TT, HH, DD)
        for ltag, lens in (("ragged", frag), ("full", ffull)):
            err, share = flash_excess(flash_fwd(fq, fk, fv, fd, lens, HH)[0],
                                      fq, fk, fv, fd, lens, HH)
            flash_err = max(flash_err, err)
            print(f"[3] flash forward {tag}, {ltag} lens: max |kernel - "
                  f"plain| on valid rows {err:.3e}; share beyond 2^-7|o| + "
                  f"2^-6 p.|v|: {share:.3e}", flush=True)
            check(share == 0.0, f"flash forward ({tag}, {ltag}) disagrees "
                  f"({err}, {share})")
        dtol = flash_ddiag_tol(BB, TT)
        for ltag, lens in (("ragged + pad row", frag_b), ("full", ffull)):
            gg = masked_g(fg, lens)
            _, flse = flash_fwd(fq, fk, fv, fd, lens, HH, with_lse=True)
            got = flash_bwd(fq, fk, fv, fd, lens, gg, flse, HH)
            if si == 0:
                n_diff = bits_differ(got, flash_bwd(fq, fk, fv, fd, lens, gg,
                                                    flse, HH))
                print(f"[3] flash backward determinism ({tag}, {ltag} lens):"
                      f" two launches differ in {n_diff} elements of dq, dk,"
                      " dv and ddiag (must be 0)", flush=True)
                check(n_diff == 0, "flash backward is not deterministic")
            ref = flash_bwd_ref(fq, fk, fv, fd, lens, gg, HH)
            (err, share, _, _), (derr, dshare, dworst, dratio) = (
                flash_bwd_excess(got, ref))
            flash_bwd_err = max(flash_bwd_err, err, derr)
            print(f"[3] flash backward {tag}, {ltag} lens: dq, dk, dv max "
                  f"|kernel - plain| {err:.3e}, share beyond 2^-7 (|plain| + "
                  f"m) {share:.3e}; ddiag max |kernel - plain| {derr:.3e}, "
                  f"share beyond {dtol:.3e} (|plain| + m) {dshare:.3e}, "
                  f"largest ratio to it {dworst:.3e}, median bound / |plain| "
                  f"{dratio:.3e}", flush=True)
            check(share == 0.0 and dshare == 0.0, f"flash backward ({tag}, "
                  f"{ltag}) disagrees ({err}, {share}; ddiag {derr}, "
                  f"{dshare})")
            if si == 0 and lens is frag_b:
                # ddiag controls, each compared on ddiag alone, must fail:
                # the kernel's ddiag shifted by one diagonal; the kernel run
                # without batch row 0 (a full-length row); and a backward
                # that read diag[(T-1) - (j - i)] (the reversed diagonals,
                # its ddiag reversed back)
                rev = fd.flip(1).contiguous()
                _, rlse = flash_fwd(fq, fk, fv, rev, lens, HH, with_lse=True)
                _, slse = flash_fwd(fq[1:], fk[1:], fv[1:], fd, lens[1:], HH,
                                    with_lse=True)
                for ctag, dd_ in (
                        ("ddiag shifted by one diagonal",
                         got[3].roll(1, dims=1)),
                        ("batch row 0 left out",
                         flash_bwd(fq[1:], fk[1:], fv[1:], fd, lens[1:],
                                   gg[1:], slse, HH)[3]),
                        ("diagonals reversed",
                         flash_bwd(fq, fk, fv, rev, lens, gg, rlse,
                                   HH)[3].flip(1))):
                    _, (derr, dshare, _, _) = flash_bwd_excess(
                        (None, None, None, dd_), ref)
                    print(f"[3] flash backward control, {ctag}: ddiag max "
                          f"|diff| {derr:.3e}, share beyond the bound "
                          f"{dshare:.3e} (must be > 0)", flush=True)
                    check(dshare > 0.0, f"flash backward control '{ctag}' "
                          "passed")
                del rev, rlse, slse, dd_
            del got, ref
        if si == 0:
            # forward controls: the diagonals dropped (the kernel without a
            # bias) and the lengths ignored must fail
            for ctag, out in (
                    ("diagonals dropped",
                     attention_fwd(fq, fk, fv, None, frag, HH)[0]),
                    ("lengths ignored",
                     flash_fwd(fq, fk, fv, fd, ffull, HH)[0])):
                err, share = flash_excess(out, fq, fk, fv, fd, frag, HH)
                print(f"[3] flash forward control, {ctag}: max |diff| "
                      f"{err:.3e}, share beyond tolerance {share:.3e} (must "
                      "be > 0)", flush=True)
                check(share > 0.0, f"flash control '{ctag}' passed")
        # times at full lengths: kernel, plain, and SDPA with the bias
        # materialized (bf16, as in [3c]/[3e]) as the library yardstick
        gg = fg
        _, flse = flash_fwd(fq, fk, fv, fd, ffull, HH, with_lse=True)
        Dh_ = DD // HH
        qh, kh, vh = (heads_of(t, HH).to(torch.bfloat16).requires_grad_()
                      for t in (fq, fk, fv))
        gh = heads_of(gg, HH).to(torch.bfloat16)
        lib_mask = toeplitz_expand(fd, TT, TT)[None].to(torch.bfloat16).expand(
            BB, HH, TT, TT).contiguous()
        flops = 4.0 * HH * TT * Dh_ * float(ffull.sum())
        fb_ms, fb_by = bound(nbytes(fq, fk, fv, fq, ffull, fd),
                             flops / peaks["bf16_flops"], peaks)
        turns = turns_ms({
            "kernel": lambda: flash_fwd(fq, fk, fv, fd, ffull, HH),
            "library": lambda: sdpa(qh, kh, vh, attn_mask=lib_mask)})
        print_turns(f"[3] flash forward (wgmma) {tag}", turns, flops, fb_ms,
                    card)
        lib_mask.requires_grad_()
        bb_ms, bb_by = bound(7 * nbytes(fq) + 2 * nbytes(fd) + nbytes(flse),
                             2.5 * flops / peaks["bf16_flops"], peaks)
        turns_b = turns_ms({
            "kernel": lambda: flash_bwd(fq, fk, fv, fd, ffull, gg, flse, HH),
            "library": lambda: torch.autograd.grad(
                sdpa(qh, kh, vh, attn_mask=lib_mask),
                (qh, kh, vh, lib_mask), gh)}, windows=3, iters=10)
        del qh, kh, vh, gh, lib_mask
        print_turns(f"[3] flash backward (wgmma) {tag}", turns_b,
                    2.5 * flops, bb_ms, card, windows=3, iters=10)
        print_split(f"[3] flash backward {tag}", kernel_split(
            lambda: flash_bwd(fq, fk, fv, fd, ffull, gg, flse, HH)), card)
        row_f = dict(
            ms=turns["kernel"],
            plain_ms=cuda_ms(lambda: flash_fwd_plain(fq, fk, fv, fd, ffull,
                                                     HH), iters=5),
            bound_ms=fb_ms, bound_by=fb_by, library_ms=turns["library"])
        row_b = dict(
            ms=turns_b["kernel"],
            plain_ms=cuda_ms(lambda: flash_bwd_plain(fq, fk, fv, fd, ffull, gg,
                                                     HH), iters=3, warmup=1),
            bound_ms=bb_ms, bound_by=bb_by, library_ms=turns_b["library"])
        for kname, row in (("flash forward", row_f),
                           ("flash backward", row_b)):
            print(f"[3] {kname} {tag}: kernel {row['ms']:.4f} ms, plain "
                  f"{row['plain_ms']:.4f} ms, SDPA {'fwd' if row is row_f else 'fwd + bwd'} "
                  f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} "
                  f"ms ({row['bound_by']}); {card}", flush=True)
        if si == 0:
            kernels["flash_attention"] = dict(
                name="flash_attention", route="cuda",
                source=f"{PKG}/csrc/attention.cu",
                replaces="pytorch_end2end_speech_recognition_tpu/ops/"
                         "attention_pallas.py:526", **row_f)
            kernels["flash_attention_bwd"] = dict(
                name="flash_attention_bwd", route="cuda",
                source=f"{PKG}/csrc/attention.cu",
                replaces="pytorch_end2end_speech_recognition_tpu/ops/"
                         "attention_pallas.py:651", **row_b)
        del fq, fk, fv, fg, fd, flse, gg
    kernels["flash_attention"]["max_abs_err"] = flash_err
    kernels["flash_attention_bwd"]["max_abs_err"] = flash_bwd_err
    print("[3] flash library yardsticks: SDPA forward, and forward + "
          "backward with the bias' gradient, on the bias materialized as a "
          "bf16 (B, H, T, T) attn_mask", flush=True)

    # ---- [3g] CTC at the train step's shape: T' frames of the ragged
    # batch, U = 64 labels without repeats, vocab 64, one pad row; then the
    # lattice of every other training path, on a generator of its own
    V = mcfg.vocab_size
    nf_r = (audio_lens - WIN) // HOP + 1
    enc_lens_r = ((nf_r + 1) // 2 + 1) // 2
    c_logits = torch.randn(B, T_enc, V, device=dev, generator=gen)
    steps_ = torch.randint(1, V - 1, (B, U_TOKENS), device=dev, generator=gen)
    c_labels = 1 + torch.cumsum(steps_, 1) % (V - 1)   # never a repeat
    c_lens = torch.minimum(
        torch.randint(1, U_TOKENS + 1, (B,), device=dev, generator=gen),
        enc_lens_r // 2)
    c_lens[B - 1] = 0
    c_labels = c_labels * (torch.arange(U_TOKENS, device=dev)[None, :]
                           < c_lens[:, None])
    g_ll = torch.randn(B, device=dev, generator=gen)
    rows = ctc_check("flagship 30 s", c_logits, enc_lens_r, c_labels, c_lens,
                     g_ll, peaks, card, plain=True)
    kernels["ctc_alpha"], kernels["ctc_beta"] = rows
    del c_logits, c_labels
    cgen = torch.Generator(device=dev).manual_seed(10)
    for tag, Bc, Tc, Vc, Uc in CTC_SHAPES:
        logits_, tlen_, labels_, lens_ = ctc_case(Bc, Tc, Vc, Uc, cgen, dev)
        ctc_check(tag, logits_, tlen_, labels_, lens_,
                  torch.randn(Bc, device=dev, generator=cgen), peaks, card,
                  plain=False)
        del logits_, labels_
    print("[3] ctc library yardsticks: F.ctc_loss forward (alpha), forward "
          "+ backward (beta); the CTC bound counts bytes, but each row's "
          "frames are dependent steps and set the floor", flush=True)

    # ---- [3i] the LSTM recurrence (rungs 1 and 2)
    lstm_kernel_phase(dev, gen, peaks, card, kernels)
    # ---- [3j] the fused FFN block (the flagship and rung 3, ffn_impl=cuda),
    # on a generator of its own: the later phases draw what they drew
    # before it was added
    ffn_kernel_phase(dev, torch.Generator(device=dev).manual_seed(13), peaks,
                     card, kernels)
    # ---- [3k] the subsampling kernel at the serving cells' shapes
    subsample_kernel_phase(dev, peaks, card, kernels)

    # ---- [4] the main path, full width, bf16, through the kernels
    model = AsrModel(flagship_conformer(), device=dev, seed=0).eval()
    check(model.cfg.model.attn_impl == "cuda" and model.cfg.frontend.impl
          == "cuda" and model.cfg.model.dtype == "bfloat16",
          f"flagship did not resolve to the kernels in bf16: {model.cfg.model}")
    cfg_ref = flagship_conformer()
    cfg_ref.frontend.impl = "torch"
    cfg_ref.model.attn_impl = "torch"
    ref_model = plain_subsampling(AsrModel(cfg_ref, device=dev, seed=0).eval())
    with torch.no_grad():
        model.encoder.rel.table.copy_(table)
        ref_model.encoder.rel.table.copy_(table)

    def alone(row: torch.Tensor, n: int, batch_frames: int) -> torch.Tensor:
        """A batch of one: the first n samples of `row`, zero-padded to
        the batch's frame grid."""
        one = torch.zeros(1, grid_len(n, batch_frames), device=dev)
        one[0, :n] = row[:n]
        return one

    def same_tokens(tok_a, len_a, tok_b, len_b) -> int:
        return sum(int(torch.equal(tok_a[r, :int(len_a[r])],
                                   tok_b[r, :int(len_b[r])]))
                   for r in range(tok_a.shape[0]))

    for fn in COUNTED:
        fn.launches = 0
    with torch.inference_mode():
        enc, elens, logits, tokens, tlens = serve(model, audio, audio_lens)
    torch.cuda.synchronize()
    counts = {"logmel": logmel.launches, "toeplitz": toeplitz_fwd.launches,
              "attention": attention_fwd.launches,
              "subsample": subsample.launches}
    check(all(fn.launches == 0 for fn in COUNTED[3:-1]),
          "a backward or flash kernel launched in the short forward")
    print(f"[4] main path launches: {counts}", flush=True)
    check(counts == {"logmel": 1, "toeplitz": 1,
                     "attention": mcfg.encoder_layers, "subsample": 1},
          f"main path launch counts {counts}")
    for key, n in counts.items():
        kernels[key]["launches"] = n
    check(tuple(enc.shape) == (B, T_enc, D) and enc.dtype == torch.bfloat16,
          f"encoder output {tuple(enc.shape)} {enc.dtype}")
    check(tuple(logits.shape) == (B, T_enc, mcfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "logits not finite")
    nf = (audio_lens - WIN) // HOP + 1
    check(torch.equal(elens, ((nf + 1) // 2 + 1) // 2),
          f"encoder lengths {elens.tolist()}")

    with torch.inference_mode():
        _, _, ref_logits, ref_tokens, ref_tlens = serve(
            ref_model, audio, audio_lens)
    compare("[4] kernels vs plain torch (bf16, 12 L, ragged batch)", logits,
            ref_logits, elens, need_sure=True)
    print(f"[4] token sequences equal on "
          f"{same_tokens(tokens, tlens, ref_tokens, ref_tlens)}/{B} rows",
          flush=True)
    # control: the plain model without its relative bias must fail the same
    # comparison, or the tolerance could not see a kernel's bias error
    with torch.no_grad():
        ref_model.encoder.rel.table.zero_()
    with torch.inference_mode():
        ctl_logits = serve(ref_model, audio, audio_lens)[2]
    valid = torch.arange(T_enc, device=dev)[None, :] < elens[:, None]
    ctl = (logits - ctl_logits).abs().amax(-1)[valid].max().item()
    print(f"[4] control, plain model with the relative bias zeroed: max "
          f"|dlogit| {ctl:.4f} (must exceed {TOL_LOGITS})", flush=True)
    check(ctl > TOL_LOGITS, "the logit tolerance cannot see the bias")
    with torch.no_grad():
        ref_model.encoder.rel.table.copy_(table)

    # requests alone (on the batch's frame grid) vs in the ragged batch
    n_same = 0
    for i in ALONE_ROWS:
        n = int(audio_lens[i])
        with torch.inference_mode():
            _, one_elens, one_logits, one_tokens, one_tlens = serve(
                model, alone(audio[i], n, n_frames), audio_lens[i:i + 1])
        L = int(one_elens[0])
        check(L == int(elens[i]), f"request {i} alone: {L} frames")
        compare(f"[4] request {i} ({n / SR:.2f} s) alone vs in the batch",
                one_logits[:, :L], logits[i:i + 1, :L], elens[i:i + 1])
        n_same += same_tokens(one_tokens, one_tlens, tokens[i:i + 1],
                              tlens[i:i + 1])
    print(f"[4] token sequences equal alone and in the batch for "
          f"{n_same}/{len(ALONE_ROWS)} requests", flush=True)

    # the log-mel of one second against the port's numpy oracle (f32), on
    # white noise as in the JAX package's tests: the oracle applies the
    # preemphasis to the samples, the kernel folds it into the basis, and on
    # audio with the test signal's 60 dB of level range the two roundings
    # differ by more than 1e-3 in the quietest bins
    one_sec = 0.1 * torch.randn(SR, device=dev, generator=gen)
    f32_front = fe.Frontend(
        FrontendConfig(cmvn="none", dft_dtype="float32", impl="cuda"), dev)
    got = f32_front(one_sec[None], torch.tensor([SR], device=dev))[0][0]
    want = fe.logmel_np(one_sec.cpu().numpy(), f32_front.cfg)
    err_np = float(np.abs(got.cpu().numpy() - want).max())
    print(f"[4] log-mel kernel (f32) vs numpy oracle, 1 s: max err "
          f"{err_np:.3e} (tol {TOL_LOGMEL})", flush=True)
    check(err_np <= TOL_LOGMEL, f"log-mel vs numpy oracle ({err_np})")

    # ---- [5] a few ragged requests, padded into one batch
    Tr = max(REQUEST_LENS)
    req = torch.zeros(len(REQUEST_LENS), Tr, device=dev)
    for j, n in enumerate(REQUEST_LENS):
        req[j, :n] = audio[j, :n]
    req_lens = torch.tensor(REQUEST_LENS, device=dev)
    with torch.inference_mode():
        _, rlens, rlogits, rtok, rtl = serve(model, req, req_lens)
        _, _, plogits, ptok, ptl = serve(ref_model, req, req_lens)
    nf = (req_lens - WIN) // HOP + 1
    check(torch.equal(rlens, ((nf + 1) // 2 + 1) // 2)
          and bool(torch.isfinite(rlogits).all()), "ragged requests")
    compare("[5] requests vs plain torch", rlogits, plogits, rlens)
    print(f"[5] token sequences equal to plain torch's on "
          f"{same_tokens(rtok, rtl, ptok, ptl)}/{len(REQUEST_LENS)} requests")
    for j, n in enumerate(REQUEST_LENS):
        with torch.inference_mode():
            _, _, jl, jt, jtl = serve(model, alone(req[j], n, n_frames_of(Tr)),
                                      req_lens[j:j + 1])
        L = int(rlens[j])
        compare(f"[5] request {j} alone vs in the batch", jl[:, :L],
                rlogits[j:j + 1, :L], rlens[j:j + 1])
        toks = rtok[j, :int(rtl[j])].tolist()
        print(f"[5] request {j}: {n / SR:.2f} s -> {L} frames, {len(toks)} "
              f"tokens {toks[:16]}{' ...' if len(toks) > 16 else ''}; alone: "
              f"{'same' if same_tokens(jt, jtl, rtok[j:j + 1], rtl[j:j + 1]) else 'other'}"
              f" tokens")
    del ref_model

    # ---- [6] throughput: encode + CTC + greedy at B=32 x 30 s
    rates = []
    with torch.inference_mode():
        for _ in range(2):
            serve(model, audio, full_lens)
        torch.cuda.synchronize()
        for _ in range(WINDOWS):
            t0 = time.perf_counter()
            for _ in range(ITERS):
                out = serve(model, audio, full_lens)
            torch.cuda.synchronize()
            rates.append(B * SECONDS * ITERS / (time.perf_counter() - t0))
    live_rate = statistics.median(rates)  # [19] prints it beside a bundle's
    print(f"[6] throughput: median {live_rate:.1f} audio-s/s "
          f"over {WINDOWS} windows of {ITERS} x (B={B} x {SECONDS:.0f} s) "
          f"(min {min(rates):.1f}, max {max(rates):.1f}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card}; "
          f"{time.perf_counter() - t_start:.0f} s since start", flush=True)

    # ---- [7] where the device time goes in one forward (torch.profiler)
    with torch.inference_mode():
        wall_ms, kernel_ms, n = profile_step(
            lambda: serve(model, audio, full_lens), ITERS)
    print_profile("[7] profile of one forward", wall_ms, kernel_ms, n, card)
    del model

    # ---- [8] the training path at full width: the hybrid step
    from pytorch_end2end_speech_recognition_tpu_torch.data.dataset import Batch
    from pytorch_end2end_speech_recognition_tpu_torch.ops.specaugment import (
        spec_augment_mask,
    )

    tok = 1 + torch.cumsum(torch.randint(1, V - 1, (B, U_TOKENS), device=dev,
                                         generator=gen), 1) % (V - 1)
    tok_lens = torch.minimum(
        torch.randint(U_TOKENS // 2, U_TOKENS + 1, (B,), device=dev,
                      generator=gen), enc_lens_r // 2)
    tok = tok * (torch.arange(U_TOKENS, device=dev)[None, :]
                 < tok_lens[:, None])
    host = lambda t: t.cpu().numpy()
    batch = Batch(host(audio), host(audio_lens).astype(np.int32),
                  host(tok).astype(np.int32), host(tok_lens).astype(np.int32))
    spec_mask = spec_augment_mask(front.frame_lens(audio_lens), n_frames,
                                  fcfg.n_mels, fcfg, gen)

    def train_cfg(impl: str, dropout: float):
        c = flagship_conformer()
        c.model.encoder_dropout = c.model.decoder_dropout = dropout
        if impl == "torch":
            c.frontend.impl = "torch"
            c.model.attn_impl = c.model.ctc_impl = "torch"
        return c

    def solver_with_table(impl: str, tbl, remat: bool = False) -> "Solver":
        c = train_cfg(impl, 0.0)
        c.model.remat = remat
        sv = make_solver(c, V, dev)
        with torch.no_grad():
            sv.model.encoder.rel.table.copy_(tbl)
        return sv

    ks = solver_with_table("cuda", table)
    check(ks.cfg.model.ctc_impl == "cuda" and ks.cfg.model.attn_impl == "cuda"
          and ks.model.decoder is not None, "the train step is not on the "
          "kernels or has no decoder")
    for fn in COUNTED:
        fn.launches = 0
    km, kg = ks.grads(batch, spec_mask=spec_mask)
    torch.cuda.synchronize()
    step_counts = {"logmel": logmel.launches,
                   "toeplitz": toeplitz_fwd.launches,
                   "attention": attention_fwd.launches,
                   "attention_bwd": attention_bwd.launches,
                   "toeplitz_reduce": toeplitz_reduce.launches,
                   "ctc_alpha": ctc_alpha.launches,
                   "ctc_beta": ctc_beta.launches,
                   "subsample": subsample.launches}
    print(f"[8] hybrid step launches: {step_counts}", flush=True)
    L = mcfg.encoder_layers
    check(step_counts == {"logmel": 1, "toeplitz": 1, "attention": L,
                          "attention_bwd": L, "toeplitz_reduce": 1,
                          "ctc_alpha": 1, "ctc_beta": 1, "subsample": 0},
          f"train step launch counts {step_counts}")
    for key in ("attention_bwd", "toeplitz_reduce", "ctc_alpha", "ctc_beta"):
        kernels[key]["launches"] = step_counts[key]
    kg = {n: g.detach() for n, g in zip(ks.names, kg)}
    check(all(bool(torch.isfinite(g).all()) for g in kg.values())
          and all(bool(torch.isfinite(v)) for v in km.values()),
          "kernel train step not finite")
    del ks
    ps = solver_with_table("torch", table)
    pm, pg = ps.grads(batch, spec_mask=spec_mask)
    pg = {n: g.detach() for n, g in zip(ps.names, pg)}
    torch.cuda.synchronize()
    d_loss = abs(float(km["loss"]) - float(pm["loss"])) / float(pm["loss"])
    cmin, rmax, cmed, n_cmp = grad_stats(kg, pg)
    print(f"[8] kernels vs plain torch, one hybrid step (B={B} x "
          f"{SECONDS:.0f} s ragged, U<={U_TOKENS}, bf16, 12 L): loss "
          f"{float(km['loss']):.5f} vs {float(pm['loss']):.5f} (ctc "
          f"{float(km['ctc_loss']):.4f} vs {float(pm['ctc_loss']):.4f}, att "
          f"{float(km['att_loss']):.4f} vs {float(pm['att_loss']):.4f}), "
          f"relative |d loss| {d_loss:.2e} (tol {TOL_TRAIN_LOSS}); gradients "
          f"of {n_cmp} parameters: cosine min {cmin:.5f} median {cmed:.5f} "
          f"(tol {TRAIN_MIN_COS}), relative error max {rmax:.4f} (tol "
          f"{TRAIN_MAX_REL})", flush=True)
    check(d_loss <= TOL_TRAIN_LOSS and cmin >= TRAIN_MIN_COS
          and rmax <= TRAIN_MAX_REL, "kernel train step disagrees with plain")
    # control: the plain model without its relative bias must fail
    with torch.no_grad():
        ps.model.encoder.rel.table.zero_()
    cm, cg = ps.grads(batch, spec_mask=spec_mask)
    cg = {n: g.detach() for n, g in zip(ps.names, cg)}
    c_loss = abs(float(cm["loss"]) - float(km["loss"])) / float(cm["loss"])
    cmin_c, rmax_c, cmed_c, _ = grad_stats(kg, cg)
    print(f"[8] control, plain model with the relative bias zeroed: relative "
          f"|d loss| {c_loss:.2e}, cosine min {cmin_c:.5f} median "
          f"{cmed_c:.5f}, relative error max {rmax_c:.4f} (must fail)",
          flush=True)
    check(c_loss > TOL_TRAIN_LOSS or cmin_c < TRAIN_MIN_COS
          or rmax_c > TRAIN_MAX_REL, "the train-step tolerance cannot see "
          "the bias")
    del ps, cg
    # ---- [8r] model.remat: the same step with every encoder block under
    # torch.utils.checkpoint; peak memory of the step above what was
    # allocated before it, remat off and on, and the remat step against
    # plain torch within [8]'s tolerances
    step_gib, runs = {}, {}
    for remat in (False, False, True):
        sv = solver_with_table("cuda", table, remat=remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        rm, rg = sv.grads(batch, spec_mask=spec_mask)
        torch.cuda.synchronize()
        step_gib[remat] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        rg = {n: g.detach() for n, g in zip(sv.names, rg)}
        runs.setdefault(remat, []).append(rg)
        del sv
    r_loss = abs(float(rm["loss"]) - float(pm["loss"])) / float(pm["loss"])
    rcmin, rrmax, rcmed, _ = grad_stats(rg, pg)
    names = tuple(rg)
    n_remat = bits_differ(tuple(rg[n] for n in names),
                          tuple(runs[False][0][n] for n in names))
    n_again = bits_differ(tuple(runs[False][1][n] for n in names),
                          tuple(runs[False][0][n] for n in names))
    print(f"[8r] remat: step peak memory {step_gib[False]:.3f} GiB without, "
          f"{step_gib[True]:.3f} GiB with (B={B} x {SECONDS:.0f} s); vs "
          f"plain torch: relative |d loss| {r_loss:.2e}, cosine min "
          f"{rcmin:.5f} median {rcmed:.5f}, relative error max {rrmax:.4f}; "
          f"gradient elements whose bits differ from a step without remat: "
          f"{n_remat}, between two steps without remat: {n_again} (of "
          f"{sum(g.numel() for g in rg.values())})", flush=True)
    check(step_gib[True] < step_gib[False] and r_loss <= TOL_TRAIN_LOSS
          and rcmin >= TRAIN_MIN_COS and rrmax <= TRAIN_MAX_REL,
          "remat step disagrees with plain or saves no memory")
    del pg, kg, rg, runs

    # five Solver steps on the kernels, dropout 0.1 and SpecAugment drawn
    # from the Solver's generator on the card
    solver = make_solver(flagship_conformer(), V, dev)
    check(solver.cfg.model.encoder_dropout > 0
          and solver.cfg.frontend.spec_augment, "training draws are off")
    solver.cfg.train.log_every = 1
    solver.fit(OneBatch(batch), steps=5)
    losses = [r["loss"] for r in solver.log]
    print(f"[8] 5 Solver steps (dropout 0.1, SpecAugment on): loss "
          f"{[round(x, 4) for x in losses]}, grad_norm "
          f"{[round(r['grad_norm'], 3) for r in solver.log]}", flush=True)
    check(len(losses) == 5 and all(math.isfinite(x) for x in losses)
          and all(bool(torch.isfinite(p).all())
                  for p in solver.model.parameters()),
          "Solver steps not finite")

    # train throughput: full 30 s rows, audio-seconds per second
    full_batch = Batch(batch.audio, np.full(B, Ts, np.int32), batch.tokens,
                       batch.token_lens)
    solver.train_step(full_batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rates = []
    for _ in range(TRAIN_WINDOWS):
        t0 = time.perf_counter()
        for _ in range(TRAIN_ITERS):
            solver.train_step(full_batch)
        torch.cuda.synchronize()
        rates.append(B * SECONDS * TRAIN_ITERS / (time.perf_counter() - t0))
    print(f"[8] train throughput: median {statistics.median(rates):.1f} "
          f"audio-s/s over {TRAIN_WINDOWS} windows of {TRAIN_ITERS} steps x "
          f"(B={B} x {SECONDS:.0f} s, U={U_TOKENS}, hybrid lambda "
          f"{mcfg.ctc_weight}) (min {min(rates):.1f}, max {max(rates):.1f}); "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB;"
          f" {card}; {time.perf_counter() - t_start:.0f} s since start",
          flush=True)
    wall_ms, kernel_ms, n = profile_step(
        lambda: solver.train_step(full_batch), TRAIN_ITERS)
    print_profile("[8] profile of one train step", wall_ms, kernel_ms, n,
                  card)

    # ---- [9] long-audio serving at full width: rows of 17-65 s padded to
    # 2^20 samples, T' 1,638 > FLASH_T, so the bias travels as float32
    # diagonals and attention takes the flash kernel
    Bl, Tsl = LONG_B, LONG_SAMPLES
    audio_l = speechlike(Bl, Tsl, gen, dev)
    lens_l = torch.randint(LONG_MIN_S * SR, Tsl + 1, (Bl,), device=dev,
                           generator=gen)
    lens_l[0] = Tsl
    audio_l = audio_l * (torch.arange(Tsl, device=dev)[None, :]
                         < lens_l[:, None])          # zero padding
    full_l = torch.full((Bl,), Tsl, dtype=torch.int64, device=dev)
    model = AsrModel(flagship_conformer(), device=dev, seed=0).eval()
    ref_model = plain_subsampling(AsrModel(cfg_ref, device=dev, seed=0).eval())
    with torch.no_grad():
        model.encoder.rel.table.copy_(table)
        ref_model.encoder.rel.table.copy_(table)
    for fn in COUNTED:
        fn.launches = 0
    with torch.inference_mode():
        enc, elens_l, logits, tokens, tlens = serve(model, audio_l, lens_l)
    torch.cuda.synchronize()
    long_counts = {f.__name__: f.launches for f in COUNTED}
    print(f"[9] long-audio forward launches: {long_counts}", flush=True)
    check(long_counts == {"logmel": 1, "toeplitz_fwd": 0, "attention_fwd": 0,
                          "attention_bwd": 0, "toeplitz_reduce": 0,
                          "ctc_alpha": 0, "ctc_beta": 0,
                          "flash_fwd": mcfg.encoder_layers, "flash_bwd": 0,
                          "lstm_fwd": 0, "lstm_bwd": 0,
                          "ffn_fwd": 0, "ffn_bwd": 0,
                          "ctc_prefix_score": 0, "ctc_prefix_select": 0,
                          "subsample": 1},
          f"long-audio forward launch counts {long_counts}")
    kernels["flash_attention"]["launches"] = long_counts["flash_fwd"]
    check(tuple(enc.shape) == (Bl, T_long, D) and bool(
        torch.isfinite(logits).all()), f"long encoder output {enc.shape}")
    nf_l = (lens_l - WIN) // HOP + 1
    check(torch.equal(elens_l, ((nf_l + 1) // 2 + 1) // 2),
          f"long encoder lengths {elens_l.tolist()}")
    with torch.inference_mode():
        _, _, ref_logits, ref_tokens, ref_tlens = serve(ref_model, audio_l,
                                                        lens_l)
    compare(f"[9] kernels vs plain torch (bf16, 12 L, ragged B={Bl} x "
            f"{LONG_MIN_S}-{Tsl / SR:.1f} s, T' {T_long})", logits,
            ref_logits, elens_l, need_sure=True)
    print(f"[9] token sequences equal on "
          f"{same_tokens(tokens, tlens, ref_tokens, ref_tlens)}/{Bl} rows",
          flush=True)
    with torch.no_grad():
        ref_model.encoder.rel.table.zero_()
    with torch.inference_mode():
        ctl_logits = serve(ref_model, audio_l, lens_l)[2]
    valid = torch.arange(T_long, device=dev)[None, :] < elens_l[:, None]
    ctl = (logits - ctl_logits).abs().amax(-1)[valid].max().item()
    print(f"[9] control, plain model with the relative bias zeroed: max "
          f"|dlogit| {ctl:.4f} (must exceed {TOL_LOGITS})", flush=True)
    check(ctl > TOL_LOGITS, "the long-audio logit tolerance cannot see the "
          "bias")
    with torch.no_grad():
        ref_model.encoder.rel.table.copy_(table)
    del ctl_logits, ref_logits
    # two requests as the JAX transcribe CLI pads them: each alone, zero-
    # padded to the next power of two of samples
    for j, secs in enumerate((20, 50)):
        n = secs * SR
        bucket = 1 << math.ceil(math.log2(n))
        one = torch.zeros(1, bucket, device=dev)
        one[0, :n] = audio_l[j, :n]
        n_t = torch.tensor([n], device=dev)
        with torch.inference_mode():
            _, one_lens, one_logits, one_tok, one_tl = serve(model, one, n_t)
            _, _, ref_one, _, _ = serve(ref_model, one, n_t)
        Tj = one_logits.shape[1]
        check(Tj > FLASH_T, f"request {j}: {Tj} frames, not past "
              "FLASH_T")
        compare(f"[9] request of {secs} s padded to 2^{bucket.bit_length() - 1}"
                f" samples (T' {Tj}) vs plain torch", one_logits, ref_one,
                one_lens)
        toks = one_tok[0, :int(one_tl[0])].tolist()
        print(f"[9] request of {secs} s: {int(one_lens[0])} frames of {Tj}, "
              f"{len(toks)} tokens {toks[:16]}"
              f"{' ...' if len(toks) > 16 else ''}", flush=True)
    del ref_model
    rates = []
    with torch.inference_mode():
        for _ in range(2):
            serve(model, audio_l, full_l)
        torch.cuda.synchronize()
        for _ in range(WINDOWS):
            t0 = time.perf_counter()
            for _ in range(ITERS):
                serve(model, audio_l, full_l)
            torch.cuda.synchronize()
            rates.append(Bl * Tsl / SR * ITERS / (time.perf_counter() - t0))
    print(f"[9] long-audio throughput: median {statistics.median(rates):.1f} "
          f"audio-s/s over {WINDOWS} windows of {ITERS} x (B={Bl} x "
          f"{Tsl / SR:.3f} s) (min {min(rates):.1f}, max {max(rates):.1f});"
          f" {card}; {time.perf_counter() - t_start:.0f} s since start",
          flush=True)
    with torch.inference_mode():
        wall_ms, kernel_ms, n = profile_step(
            lambda: serve(model, audio_l, full_l), ITERS)
    print_profile("[9] profile of one long-audio forward", wall_ms, kernel_ms,
                  n, card)
    del model, enc, logits

    # ---- [10] one long-audio hybrid train step at full width: B=16 x 2^20
    # samples, U=128 tokens, kernels vs plain torch on the card
    tok_l = 1 + torch.cumsum(torch.randint(1, V - 1, (Bl, U_LONG), device=dev,
                                           generator=gen), 1) % (V - 1)
    tok_lens_l = torch.minimum(
        torch.randint(U_LONG // 2, U_LONG + 1, (Bl,), device=dev,
                      generator=gen), elens_l // 2)
    tok_l = tok_l * (torch.arange(U_LONG, device=dev)[None, :]
                     < tok_lens_l[:, None])
    batch_l = Batch(host(audio_l), host(lens_l).astype(np.int32),
                    host(tok_l).astype(np.int32),
                    host(tok_lens_l).astype(np.int32))
    spec_mask_l = spec_augment_mask(front.frame_lens(lens_l),
                                    front.n_frames(Tsl), fcfg.n_mels, fcfg,
                                    gen)
    ks = solver_with_table("cuda", table)
    for fn in COUNTED:
        fn.launches = 0
    km, kg = ks.grads(batch_l, spec_mask=spec_mask_l)
    torch.cuda.synchronize()
    kg = {n: g.detach() for n, g in zip(ks.names, kg)}
    del ks
    check(all(bool(torch.isfinite(g).all()) for g in kg.values())
          and all(bool(torch.isfinite(v)) for v in km.values()),
          "long-audio kernel train step not finite")
    torch.cuda.reset_peak_memory_stats()
    ps = solver_with_table("torch", table)
    pm, pg = ps.grads(batch_l, spec_mask=spec_mask_l)
    pg = {n: g.detach() for n, g in zip(ps.names, pg)}
    torch.cuda.synchronize()
    plain_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    d_loss = abs(float(km["loss"]) - float(pm["loss"])) / float(pm["loss"])
    cmin, rmax, cmed, n_cmp = grad_stats(kg, pg)
    tbl_cos = float(torch.nn.functional.cosine_similarity(
        kg["encoder.rel.table"].flatten(), pg["encoder.rel.table"].flatten(),
        dim=0))
    print(f"[10] kernels vs plain torch, one long-audio hybrid step (B={Bl} "
          f"x {Tsl / SR:.3f} s ragged, T' {T_long}, U<={U_LONG}, bf16, 12 L;"
          f" plain at the same B, peak {plain_peak:.2f} GiB): loss "
          f"{float(km['loss']):.5f} vs {float(pm['loss']):.5f} (ctc "
          f"{float(km['ctc_loss']):.4f} vs {float(pm['ctc_loss']):.4f}, att "
          f"{float(km['att_loss']):.4f} vs {float(pm['att_loss']):.4f}), "
          f"relative |d loss| {d_loss:.2e} (tol {TOL_TRAIN_LOSS}); gradients "
          f"of {n_cmp} parameters: cosine min {cmin:.5f} median {cmed:.5f} "
          f"(tol {TRAIN_MIN_COS}), relative error max {rmax:.4f} (tol "
          f"{TRAIN_MAX_REL}); encoder.rel.table cosine {tbl_cos:.5f}",
          flush=True)
    check(d_loss <= TOL_TRAIN_LOSS and cmin >= TRAIN_MIN_COS
          and rmax <= TRAIN_MAX_REL, "long-audio kernel train step disagrees "
          "with plain")
    with torch.no_grad():
        ps.model.encoder.rel.table.zero_()
    cm, cg = ps.grads(batch_l, spec_mask=spec_mask_l)
    cg = {n: g.detach() for n, g in zip(ps.names, cg)}
    c_loss = abs(float(cm["loss"]) - float(km["loss"])) / float(cm["loss"])
    cmin_c, rmax_c, cmed_c, _ = grad_stats(kg, cg)
    print(f"[10] control, plain model with the relative bias zeroed: relative"
          f" |d loss| {c_loss:.2e}, cosine min {cmin_c:.5f} median "
          f"{cmed_c:.5f}, relative error max {rmax_c:.4f} (must fail)",
          flush=True)
    check(c_loss > TOL_TRAIN_LOSS or cmin_c < TRAIN_MIN_COS
          or rmax_c > TRAIN_MAX_REL, "the long-audio train-step tolerance "
          "cannot see the bias")
    del ps, pg, cg, kg
    # one Solver.train_step (dropout 0.1, SpecAugment drawn) with its
    # launch counts, then throughput on full rows
    full_batch_l = Batch(batch_l.audio, np.full(Bl, Tsl, np.int32),
                         batch_l.tokens, batch_l.token_lens)
    for fn in COUNTED:
        fn.launches = 0
    metrics = solver.train_step(batch_l)
    torch.cuda.synchronize()
    step_l = {f.__name__: f.launches for f in COUNTED}
    print(f"[10] long-audio Solver.train_step launches: {step_l}; loss "
          f"{float(metrics['loss']):.4f}", flush=True)
    check(step_l == {"logmel": 1, "toeplitz_fwd": 0, "attention_fwd": 0,
                     "attention_bwd": 0, "toeplitz_reduce": 0,
                     "ctc_alpha": 1, "ctc_beta": 1, "flash_fwd": L,
                     "flash_bwd": L, "lstm_fwd": 0, "lstm_bwd": 0,
                     "ffn_fwd": 0, "ffn_bwd": 0, "ctc_prefix_score": 0,
                     "ctc_prefix_select": 0, "subsample": 0},
          f"long train step launch counts {step_l}")
    check(math.isfinite(float(metrics["loss"])), "long train step not finite")
    kernels["flash_attention_bwd"]["launches"] = step_l["flash_bwd"]
    solver.train_step(full_batch_l)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rates = []
    for _ in range(TRAIN_WINDOWS):
        t0 = time.perf_counter()
        for _ in range(TRAIN_ITERS):
            solver.train_step(full_batch_l)
        torch.cuda.synchronize()
        rates.append(Bl * Tsl / SR * TRAIN_ITERS / (time.perf_counter() - t0))
    print(f"[10] long-audio train throughput: median "
          f"{statistics.median(rates):.1f} audio-s/s over {TRAIN_WINDOWS} "
          f"windows of {TRAIN_ITERS} steps x (B={Bl} x {Tsl / SR:.3f} s, "
          f"U={U_LONG}) (min {min(rates):.1f}, max {max(rates):.1f}); peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"{card}; {time.perf_counter() - t_start:.0f} s since start",
          flush=True)
    wall_ms, kernel_ms, n = profile_step(
        lambda: solver.train_step(full_batch_l), TRAIN_ITERS)
    print_profile("[10] profile of one long-audio train step", wall_ms,
                  kernel_ms, n, card)

    del solver
    # ---- [11] an4_ctc serving, [12] the wsj_las hybrid step (LSTM rungs)
    an4_serve_phase(dev, gen, card, kernels, COUNTED, t_start)
    las_train_phase(dev, gen, card, kernels, COUNTED, t_start)
    # ---- [13] the flagship with ffn_impl=cuda, [14] rung 3 (Transformer)
    flagship_ffn_phase(dev, card, kernels, COUNTED, t_start, audio,
                       audio_lens, full_lens, table, batch, spec_mask)
    rung3_phase(dev, gen, card, kernels, COUNTED, t_start, audio, audio_lens,
                full_lens, spec_mask, peaks)
    # ---- [15] beam decode (wsj_las here; rung 3 in [14], rung 4 in [16])
    beam_phase(dev, torch.Generator(device=dev).manual_seed(15), peaks, card,
               COUNTED, t_start)
    # ---- [16] rung 4 (libri960_conformer) at full width
    rung4_phase(dev, torch.Generator(device=dev).manual_seed(16), peaks, card,
                kernels, COUNTED, t_start, audio, audio_lens, full_lens,
                spec_mask)

    # ---- [17] the trainer from a manifest: cli.train and --resume
    trained, wer_inputs = trainer_phase(dev, card, COUNTED, t_start)
    # ---- [18] streaming: rung 4's encoder and chunk beam, an4_ctc, the CLIs
    stream_phase(dev, torch.Generator(device=dev).manual_seed(18), peaks,
                 card, COUNTED, t_start, trained)
    # ---- [19] serving bundles and the remaining CLIs
    bundle_phase(dev, torch.Generator(device=dev).manual_seed(19), card,
                 COUNTED, t_start, live_rate)
    # ---- [20] data and tensor parallelism: rung 5, two ranks, the CLIs
    rung5_phase(dev, card, COUNTED, t_start, audio, audio_lens)
    # ---- [21] cp_mode and pp_stages without a mesh, profiling, prep, native
    cp_pp_phase(dev, card, COUNTED, t_start, audio, audio_lens, table, batch,
                spec_mask, V, wer_inputs)

    order = ("logmel", "toeplitz", "attention", "attention_bwd",
             "toeplitz_reduce", "flash_attention", "flash_attention_bwd",
             "ctc_alpha", "ctc_beta", "lstm_fwd", "lstm_bwd", "ffn_fwd",
             "ffn_bwd", "ctc_prefix_score", "ctc_prefix_select", "subsample")
    print(f"[total] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": [kernels[k] for k in order]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--train-seeds"]:
        sys.exit(train_seed_sweep([int(s) for s in sys.argv[2].split(",")]))
    if sys.argv[1:2] == ["--bundle-child"]:
        sys.exit(bundle_child(sys.argv[2]))
    if sys.argv[1:2] == ["--profile-child"]:
        sys.exit(profile_child(sys.argv[2]))
    if sys.argv[1:2] == ["--dist-child"]:
        sys.exit(dist_child(sys.argv[2], int(sys.argv[3])))
    sys.exit(main())
