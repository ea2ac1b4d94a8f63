"""Bucketed batch loader (the port of the JAX package's `data/dataset.py`):
the host decodes and pads; features run on the device.

- Batches carry raw padded audio; the log-mel, SpecAugment and the model
  run in the train step on the device.
- (T, U) shapes are quantized to a small fixed set of bucket shapes; each
  bucket has a fixed batch size, and ragged final batches are padded with
  zero-length rows (masked out by `audio_lens == 0`).
- Per-host sharding by `shard_index/num_shards`; every shard yields the
  same number of batches an epoch.
- An epoch's order is a function of (data.seed, epoch), so (epoch, batch
  index) is an exact position to resume from.

For a given (data.seed, epoch) the port yields the JAX loader's batches in
its order, bit for bit. A batch's audio is decoded by the C++ batch decoder
(`native/`, multithreaded, straight into the padded buffer), as in the JAX
package; the rows it leaves (another container or sample rate) are read
through `data/audio.py`, row by row. `prefetch` runs a loader in a
background thread; on CUDA the Solver pins each batch there (`pin_batch`)
so that its copy to the card is asynchronous.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from pytorch_end2end_speech_recognition_tpu_torch.data.audio import load_audio
from pytorch_end2end_speech_recognition_tpu_torch.data.manifest import (
    Utterance,
)
from pytorch_end2end_speech_recognition_tpu_torch.data.tokenizer import (
    Tokenizer,
)
from pytorch_end2end_speech_recognition_tpu_torch.native import (
    load_batch_native,
)
from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
    DataConfig,
)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class Bucket:
    max_samples: int      # padded audio length (samples)
    max_label: int        # padded token length
    batch_size: int       # fixed utterances per batch
    utt_indices: list[int] = field(default_factory=list)


@dataclass
class Batch:
    """Host-side batch: numpy arrays, or page-locked CPU tensors after
    `pin_batch`."""

    audio: np.ndarray        # (B, Ts) float32
    audio_lens: np.ndarray   # (B,) int32 samples; 0 for pad rows
    tokens: np.ndarray       # (B, U) int32, blank(0)-padded
    token_lens: np.ndarray   # (B,) int32
    ids: list[str] = field(default_factory=list)
    texts: list[str] = field(default_factory=list)

    @property
    def shape_key(self):
        return (tuple(self.audio.shape), tuple(self.tokens.shape))


def pin_batch(batch: Batch) -> Batch:
    """A copy of `batch` whose four arrays are page-locked CPU tensors, so
    that `tensor.to('cuda', non_blocking=True)` is an asynchronous DMA."""
    return dataclasses.replace(batch, **{
        k: torch.from_numpy(getattr(batch, k)).pin_memory()
        for k in ("audio", "audio_lens", "tokens", "token_lens")})


class BucketedLoader:
    """Length-bucketed, shape-stable batch iterator over a manifest."""

    def __init__(
        self,
        utts: list[Utterance],
        tokenizer: Tokenizer,
        cfg: DataConfig,
        sample_rate: int = 16000,
        train: bool = True,
        shard_index: int = 0,
        num_shards: int = 1,
    ):
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.sr = sample_rate
        self.train = train
        self.shard_index = shard_index
        self.num_shards = num_shards

        kept = []
        for u in utts:
            if not (cfg.min_audio_s <= u.duration_s <= cfg.max_audio_s):
                continue
            toks = tokenizer.encode(u.text)
            if 0 < len(toks) <= cfg.max_label_len:
                kept.append((u, toks))
        if not kept:
            raise ValueError("no utterances survived filtering")
        self.utts = [u for u, _ in kept]
        self.token_ids = [t for _, t in kept]
        self.buckets = self._build_buckets()
        self._epoch = 0

    # ---- bucketing ----
    def _build_buckets(self) -> list[Bucket]:
        cfg = self.cfg
        lens = np.array([int(u.duration_s * self.sr) for u in self.utts])
        order = np.argsort(lens)
        n_buckets = min(cfg.n_length_buckets, len(self.utts))
        buckets = []
        for idxs in np.array_split(order, n_buckets):
            if len(idxs) == 0:
                continue
            max_s = _round_up(int(lens[idxs].max()), 1600)  # 100 ms grain
            max_u = _round_up(max(len(self.token_ids[i]) for i in idxs), 8)
            bs = max(1, min(cfg.batch_size, cfg.batch_frames // max(max_s, 1)))
            buckets.append(Bucket(max_samples=max_s, max_label=max_u,
                                  batch_size=bs, utt_indices=list(idxs)))
        # merge buckets with identical shapes
        merged: dict[tuple, Bucket] = {}
        for b in buckets:
            k = (b.max_samples, b.max_label, b.batch_size)
            if k in merged:
                merged[k].utt_indices.extend(b.utt_indices)
            else:
                merged[k] = b
        return list(merged.values())

    @property
    def shape_set(self) -> list[tuple[int, int, int]]:
        """All (batch, samples, label) padded shapes the model will see."""
        return [(b.batch_size, b.max_samples, b.max_label)
                for b in self.buckets]

    def __len__(self):
        n = 0
        for b in self.buckets:
            sharded = len(b.utt_indices[self.shard_index::self.num_shards])
            n += -(-sharded // b.batch_size)
        return n

    # ---- iteration ----
    def _make_batch(self, bucket: Bucket, idxs: list[int]) -> Batch:
        B, Ts, U = bucket.batch_size, bucket.max_samples, bucket.max_label
        audio = np.zeros((B, Ts), np.float32)
        alens = np.zeros((B,), np.int32)
        tokens = np.zeros((B, U), np.int32)
        tlens = np.zeros((B,), np.int32)
        ids, texts = [], []
        load_batch_native([self.utts[i].audio for i in idxs],
                          audio[:len(idxs)], alens[:len(idxs)],
                          expect_sr=self.sr)
        for row, i in enumerate(idxs):
            if alens[row] == 0:  # left by the native decoder
                x = load_audio(self.utts[i].audio, self.sr)[:Ts]
                audio[row, :len(x)] = x
                alens[row] = len(x)
            t = self.token_ids[i]
            tokens[row, :len(t)] = t
            tlens[row] = len(t)
            ids.append(self.utts[i].id)
            texts.append(self.utts[i].text)
        return Batch(audio, alens, tokens, tlens, ids, texts)

    def epoch(self, epoch: int | None = None, start_batch: int = 0):
        """One pass over this host's shard, in shuffled bucket order.
        `start_batch` skips the first N batches (the resume cursor): epochs
        are deterministic in (cfg.seed, epoch), so (epoch, batch index) is
        an exact position."""
        ep = self._epoch if epoch is None else epoch
        rng = np.random.default_rng((self.cfg.seed, ep))
        jobs: list[tuple[Bucket, list[int]]] = []
        for b in self.buckets:
            idxs = np.array(b.utt_indices)
            if self.train and self.cfg.shuffle:
                rng.shuffle(idxs)
            idxs = idxs[self.shard_index::self.num_shards]
            for s in range(0, len(idxs), b.batch_size):
                jobs.append((b, list(idxs[s:s + b.batch_size])))
        if self.num_shards > 1:
            # every shard yields the same number of batches: pad short
            # shards with empty batches (all rows masked by audio_lens == 0)
            max_jobs = max(
                sum(-(-len(b.utt_indices[s::self.num_shards]) // b.batch_size)
                    for b in self.buckets)
                for s in range(self.num_shards))
            while len(jobs) < max_jobs:
                jobs.append((self.buckets[0], []))
        if self.train and self.cfg.shuffle:
            rng.shuffle(jobs)  # type: ignore[arg-type]
        for b, idxs in jobs[start_batch:]:
            yield self._make_batch(b, idxs)
        self._epoch = ep + 1

    def __iter__(self):
        return self.epoch()

    def repeat(self, start_epoch: int = 0, start_batch: int = 0,
               with_cursor: bool = False):
        """Infinite step-based iteration (training), resumable from an
        (epoch, batch) cursor. With `with_cursor`, yields (epoch,
        batch_index, batch) so the trainer can save its exact position."""
        ep, skip = start_epoch, start_batch
        while True:
            for i, batch in enumerate(self.epoch(ep, start_batch=skip)):
                yield (ep, skip + i, batch) if with_cursor else batch
            skip = 0
            ep += 1


class _Raised:
    def __init__(self, exc: BaseException):
        self.exc = exc


def prefetch(it, depth: int = 2):
    """Iterate `it` in a background thread, at most `depth` items ahead, so
    that host preparation overlaps the device's work. An exception in the
    thread is raised here; closing the generator stops the thread."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    end = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def worker():
        try:
            for item in it:
                if not put(item):
                    return
        except BaseException as e:  # noqa: BLE001 - handed to the consumer
            put(_Raised(e))
            return
        put(end)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, _Raised):
                raise item.exc
            yield item
    finally:
        stop.set()
        t.join(timeout=10)
