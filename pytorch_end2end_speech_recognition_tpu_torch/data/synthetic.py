"""Synthetic corpora for tests and CPU-runnable recipes (the port's copy of
the JAX package's `data/synthetic.py`), generated with numpy, no download:
the spoken-digits corpus (each digit word a fixed short melody of tones,
with silences and noise), the phrases corpus (a grammar over the digits
and DASH) and the commands corpus (formant-synthesised words). A model
must learn the same alignment machinery (frames -> tokens, CTC blanks,
attention) as on real speech.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from pytorch_end2end_speech_recognition_tpu_torch.data.audio import write_wav
from pytorch_end2end_speech_recognition_tpu_torch.data.manifest import (
    Utterance,
    write_manifest,
)

DIGITS = [
    "ZERO", "ONE", "TWO", "THREE", "FOUR",
    "FIVE", "SIX", "SEVEN", "EIGHT", "NINE",
]
# Connective words for the grammar corpus (see make_phrases_corpus); word
# id 10 = DASH.
WORDS = DIGITS + ["DASH"]

# Each digit -> sequence of 3 tone frequencies (Hz). Distinct patterns.
_BASE = 300.0


def _digit_freqs(d: int) -> list[float]:
    return [
        _BASE * (1.3 ** ((d * 3 + k) % 10)) + 37.0 * ((d + k) % 4) for k in range(3)
    ]


def _word_freqs(w: int) -> list[float]:
    if w < 10:
        return _digit_freqs(w)
    return [265.0, 205.0, 265.0]  # DASH: a distinct low dip melody


def synth_digit_audio(
    digits: list[int],
    sr: int = 16000,
    tone_s: float = 0.09,
    gap_s: float = 0.06,
    noise: float = 0.01,
    rng: np.random.Generator | None = None,
    speaker_jitter: float = 0.0,
) -> np.ndarray:
    """With speaker_jitter > 0, a per-UTTERANCE 'speaker' is sampled: a
    global pitch scale, speaking rate, loudness, and noise floor (the
    digit's relative tone pattern stays intact). This is the train/dev
    distribution gap that makes dev WER a generalization measure instead
    of a memorization one."""
    rng = rng or np.random.default_rng(0)
    j = speaker_jitter
    pitch = 1.0 + j * 0.2 * (rng.random() - 0.5) * 2    # ±20% * j
    rate = 1.0 + j * 0.3 * (rng.random() - 0.5) * 2     # ±30% * j
    loud = 0.3 * (1.0 + j * 0.5 * (rng.random() - 0.5) * 2)
    noise = noise * (1.0 + j * (rng.random() - 0.5) * 2)
    pieces = [np.zeros(int(sr * gap_s), np.float32)]
    for d in digits:
        for f in _word_freqs(d):
            # jitter duration/freq slightly so the model must generalize
            dur = tone_s * rate * (1.0 + 0.15 * (rng.random() - 0.5))
            fj = f * pitch * (1.0 + 0.02 * (rng.random() - 0.5))
            t = np.arange(int(sr * dur)) / sr
            env = np.hanning(len(t)).astype(np.float32)
            pieces.append((loud * env * np.sin(2 * np.pi * fj * t)).astype(np.float32))
        pieces.append(np.zeros(int(sr * gap_s * rate * (1 + rng.random())),
                               np.float32))
    x = np.concatenate(pieces)
    x = x + noise * rng.standard_normal(len(x)).astype(np.float32)
    return x.astype(np.float32)


def make_digits_corpus(
    out_dir: str | Path,
    n_train: int = 200,
    n_dev: int = 20,
    n_test: int = 20,
    min_digits: int = 1,
    max_digits: int = 5,
    sr: int = 16000,
    seed: int = 0,
    speaker_jitter: float = 0.0,
) -> dict[str, Path]:
    """Generate WAVs + manifests. Returns {'train': path, 'dev': ..., 'test': ...}."""
    out_dir = Path(out_dir)
    (out_dir / "wav").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    manifests = {}
    counts = {"train": n_train, "dev": n_dev, "test": n_test}
    for split, n in counts.items():
        utts = []
        for i in range(n):
            k = int(rng.integers(min_digits, max_digits + 1))
            digits = rng.integers(0, 10, size=k).tolist()
            x = synth_digit_audio(digits, sr=sr, rng=rng,
                                  speaker_jitter=speaker_jitter)
            uid = f"{split}_{i:05d}"
            wav_path = out_dir / "wav" / f"{uid}.wav"
            write_wav(wav_path, x, sr)
            utts.append(
                Utterance(
                    id=uid,
                    audio=str(wav_path),
                    duration_s=len(x) / sr,
                    text=" ".join(DIGITS[d] for d in digits),
                )
            )
        mpath = out_dir / f"{split}.jsonl"
        write_manifest(mpath, utts)
        manifests[split] = mpath
    return manifests


# ---------------------------------------------------------------- grammar
# "Phone-number" phrase grammar for the LM shallow-fusion evidence run:
# transcripts carry real sequence structure —
# a small closed set of 3-digit area codes, a DASH connective, then a
# 4-digit line number from a skewed Markov chain — so a language model
# trained on them has genuine headroom over the acoustics, unlike uniform
# random digit strings whose per-token entropy an LM cannot reduce.

AREA_CODES = [(4, 1, 5), (2, 1, 2), (6, 5, 0), (9, 1, 7)]
_P_STEP = 0.55   # next = (d + 3) % 10
_P_REPEAT = 0.20  # next = d


def sample_phrase(rng: np.random.Generator) -> list[int]:
    """Word-id sequence: AREA(3) DASH LINE(4), line digits Markov-chained."""
    words = list(AREA_CODES[int(rng.integers(len(AREA_CODES)))]) + [10]
    d = int(rng.integers(10))
    for _ in range(4):
        words.append(d)
        r = rng.random()
        if r < _P_STEP:
            d = (d + 3) % 10
        elif r < _P_STEP + _P_REPEAT:
            pass
        else:
            d = int(rng.integers(10))
    return words


def _mix_noise(x, rng, snr_db, kind):
    """Add broadband noise at a given SNR (dB). Unlike the narrowband tone
    corpora's `noise` amplitude knob (difficulty cliff: dev WER jumps
    0.006 -> 0.75 between 0.03 and 0.07),
    broadband maskers degrade WER smoothly with SNR."""
    n = len(x)
    if kind == "white":
        w = rng.standard_normal(n).astype(np.float32)
    elif kind == "pink":
        # 1/f shaping in the frequency domain
        spec = np.fft.rfft(rng.standard_normal(n).astype(np.float32))
        f = np.maximum(np.arange(len(spec), dtype=np.float32), 1.0)
        w = np.fft.irfft(spec / np.sqrt(f), n).astype(np.float32)
    elif kind == "babble":
        # speech-shaped modulated noise: pink noise with a few independent
        # slow (2-8 Hz) amplitude modulators summed — crude multi-talker
        w = np.zeros(n, np.float32)
        t = np.arange(n, dtype=np.float32) / 16000.0
        for _ in range(5):
            spec = np.fft.rfft(rng.standard_normal(n).astype(np.float32))
            f = np.maximum(np.arange(len(spec), dtype=np.float32), 1.0)
            g = np.fft.irfft(spec / np.sqrt(f), n).astype(np.float32)
            rate = 2.0 + 6.0 * rng.random()
            mod = 0.5 + 0.5 * np.sin(
                2 * np.pi * rate * t + 2 * np.pi * rng.random())
            w += g * mod.astype(np.float32)
    else:
        raise ValueError(f"unknown noise kind {kind!r}")
    sig_p = float(np.mean(x ** 2)) + 1e-12
    noi_p = float(np.mean(w ** 2)) + 1e-12
    w *= np.sqrt(sig_p / noi_p / (10.0 ** (snr_db / 10.0)))
    return (x + w).astype(np.float32)


# ------------------------------------------------------- formant synthesis
# Pseudo-speech with speech-like spectral structure: each letter is a
# phoneme with formant targets (vowels/nasals/liquids: harmonic stacks
# shaped by formant resonances), a noise band (fricatives) or
# closure+burst (stops), so a word's acoustics are compositional over its
# spelling exactly as
# grapheme-level speech is. Per-speaker F0, formant scale, rate and
# loudness vary; per-phoneme duration/pitch jitter on top.

_VOWELS = {          # (F1, F2, F3) Hz — rough adult averages
    "A": (730, 1090, 2440),
    "E": (530, 1840, 2480),
    "I": (390, 1990, 2550),
    "O": (570, 840, 2410),
    "U": (440, 1020, 2240),
    "Y": (420, 1900, 2500),
}
_SONORANTS = {       # voiced consonants -> formant targets
    "M": (250, 1100, 2200),
    "N": (280, 1700, 2300),
    "L": (380, 1200, 2600),
    "R": (420, 1300, 1600),   # low F3 = rhotic cue
    "W": (320, 720, 2200),
}
_FRICATIVES = {      # letter -> (band center Hz, bandwidth Hz, voiced)
    "S": (5500, 2400, False),
    "Z": (5200, 2200, True),
    "F": (4200, 3200, False),
    "V": (3800, 2800, True),
    "H": (1500, 2600, False),
    "J": (2800, 1800, True),
    "X": (4800, 2600, False),
    "C": (4900, 2400, False),  # context-free: treat as /s/-ish
}
_STOPS = {           # letter -> (burst center Hz, voiced)
    "P": (900, False), "B": (900, True),
    "T": (3800, False), "D": (3400, True),
    "K": (2100, False), "G": (1900, True),
    "Q": (2100, False),
}


def _formant_gain(freqs: np.ndarray, formants, scale: float) -> np.ndarray:
    """Spectral envelope: Gaussian resonance bumps + a -6 dB/oct source
    rolloff floor."""
    g = np.full(freqs.shape, 1e-3, np.float32)
    for i, fc in enumerate(formants):
        bw = 80.0 + 60.0 * i
        g = g + (1.0 / (1.0 + i)) * np.exp(
            -0.5 * ((freqs - fc * scale) / bw) ** 2
        ).astype(np.float32)
    rolloff = 1.0 / (1.0 + (freqs / 600.0) ** 1.2)
    return (g * rolloff).astype(np.float32)


def _harmonic_segment(n, sr, f0, formants, scale, rng):
    """Voiced segment: harmonic stack at f0 shaped by the formant envelope,
    with a slow F0 declination so it reads as natural pitch."""
    t = np.arange(n, dtype=np.float32) / sr
    drift = 1.0 - 0.06 * t / max(t[-1], 1e-6) if n > 1 else np.ones(1, np.float32)
    h_max = max(2, int(7400.0 / f0))
    h = np.arange(1, min(h_max, 46) + 1, dtype=np.float32)
    amps = _formant_gain(h * f0, formants, scale)
    phases = 2 * np.pi * rng.random(len(h)).astype(np.float32)
    # phase integral of drifting f0: 2*pi*h*f0 * int(drift dt)
    tau = np.cumsum(drift).astype(np.float32) / sr
    x = (amps[:, None] * np.sin(
        2 * np.pi * f0 * h[:, None] * tau[None, :] + phases[:, None]
    )).sum(axis=0)
    return (x / (np.abs(x).max() + 1e-6)).astype(np.float32)


def _noise_band_segment(n, sr, center, bw, rng):
    spec = np.fft.rfft(rng.standard_normal(n).astype(np.float32))
    f = np.arange(len(spec), dtype=np.float32) * sr / n
    spec *= np.exp(-0.5 * ((f - center) / bw) ** 2)
    x = np.fft.irfft(spec, n).astype(np.float32)
    return (x / (np.abs(x).max() + 1e-6)).astype(np.float32)


def _phoneme_audio(ch, sr, f0, scale, rate, rng):
    """One letter -> audio segment. Durations jitter per instance."""
    def dur(base):
        return int(sr * base * rate * (1.0 + 0.25 * (rng.random() - 0.5)))

    if ch in _VOWELS:
        return _harmonic_segment(dur(0.11), sr, f0, _VOWELS[ch], scale, rng)
    if ch in _SONORANTS:
        n = dur(0.07)
        return 0.6 * _harmonic_segment(n, sr, f0, _SONORANTS[ch], scale, rng)
    if ch in _FRICATIVES:
        c, bw, voiced = _FRICATIVES[ch]
        n = dur(0.08)
        x = 0.35 * _noise_band_segment(n, sr, c * scale, bw, rng)
        if voiced:
            x = x + 0.4 * _harmonic_segment(n, sr, f0, (300, 1400, 2500),
                                            scale, rng)
        return x.astype(np.float32)
    if ch in _STOPS:
        c, voiced = _STOPS[ch]
        closure = np.zeros(dur(0.035), np.float32)
        if voiced:  # voice bar during closure
            closure = 0.12 * _harmonic_segment(
                len(closure), sr, f0, (180, 1200, 2400), scale, rng)
        burst = 0.5 * _noise_band_segment(
            max(dur(0.018), 8), sr, c * scale, 1500.0, rng)
        return np.concatenate([closure, burst])
    # unknown letter -> short schwa
    return 0.4 * _harmonic_segment(dur(0.05), sr, f0, (500, 1500, 2500),
                                   scale, rng)


def synth_speech_audio(
    words: list[str],
    sr: int = 16000,
    rng: np.random.Generator | None = None,
    snr_db: float = 20.0,
    noise_kind: str = "babble",
    speaker_var: float = 1.0,
) -> np.ndarray:
    """Formant-synthesized pseudo-speech for a word sequence.

    A per-utterance 'speaker' samples F0 (log-uniform 95-230 Hz), a vocal
    tract length (formant scale), a speaking rate and loudness; every
    phoneme then jitters duration and the pitch declines naturally. 10 ms
    crossfades join phonemes so there are no clicks, and word gaps carry
    low-level breath noise rather than digital silence."""
    rng = rng or np.random.default_rng(0)
    v = speaker_var
    f0 = 150.0 * np.exp(v * 0.45 * (rng.random() - 0.5) * 2)
    scale = 1.0 + v * 0.13 * (rng.random() - 0.5) * 2
    rate = 1.0 + v * 0.25 * (rng.random() - 0.5) * 2
    loud = 0.25 * (1.0 + v * 0.4 * (rng.random() - 0.5) * 2)
    xf = int(sr * 0.010)  # crossfade samples
    ramp = np.linspace(0.0, 1.0, xf, dtype=np.float32)

    pieces = [np.zeros(int(sr * 0.05), np.float32)]
    for w in words:
        segs = []
        prev = None
        for ch in w.upper():
            if ch == prev:      # collapse doubled letters (e.g. LL)
                continue
            prev = ch
            seg = _phoneme_audio(ch, sr, f0, scale, rate, rng)
            # taper segment edges for the crossfade
            if len(seg) > 2 * xf:
                seg = seg.copy()
                seg[:xf] *= ramp
                seg[-xf:] *= ramp[::-1]
            segs.append(seg)
        word_audio = segs[0]
        for seg in segs[1:]:
            if len(word_audio) > xf and len(seg) > xf:  # overlap-add joint
                head, tail = word_audio[:-xf], word_audio[-xf:]
                word_audio = np.concatenate(
                    [head, tail + seg[:xf], seg[xf:]])
            else:
                word_audio = np.concatenate([word_audio, seg])
        pieces.append(loud * word_audio)
        gap = int(sr * (0.04 + 0.05 * rng.random()) * rate)
        pieces.append(np.zeros(gap, np.float32))
    x = np.concatenate(pieces)
    return _mix_noise(x, rng, snr_db, noise_kind)


# ---------------------------------------------------------- command grammar
# >=100-word lexicon with template structure an LM can exploit: skewed
# template/slot choices (non-uniform priors), acoustically confusable word
# pairs (LIGHT/RIGHT, PLAY/DAY, NINE/WINE...) that context disambiguates.

_ACTIONS = ["TURN", "SWITCH", "SET", "PLAY", "STOP", "OPEN", "CLOSE",
            "START", "PAUSE", "RESUME", "DIM", "RAISE", "LOWER", "LOCK",
            "UNLOCK", "CHECK", "SHOW", "MUTE", "CALL", "FIND"]
_DEVICES = ["LIGHT", "LIGHTS", "DOOR", "WINDOW", "MUSIC", "ALARM", "TIMER",
            "HEATER", "FAN", "TELEVISION", "RADIO", "CAMERA", "SPEAKER",
            "BLINDS", "OVEN", "KETTLE", "SCREEN", "MONITOR", "PRINTER",
            "VACUUM"]
_ROOMS = ["KITCHEN", "BEDROOM", "BATHROOM", "GARDEN", "OFFICE", "HALLWAY",
          "GARAGE", "BASEMENT", "ATTIC", "STUDY", "LOUNGE", "PORCH"]
_NUMBERS = ["ZERO", "ONE", "TWO", "THREE", "FOUR", "FIVE", "SIX", "SEVEN",
            "EIGHT", "NINE", "TEN", "ELEVEN", "TWELVE", "THIRTEEN",
            "FOURTEEN", "FIFTEEN", "SIXTEEN", "SEVENTEEN", "EIGHTEEN",
            "NINETEEN", "TWENTY", "THIRTY", "FORTY", "FIFTY", "SIXTY",
            "SEVENTY", "EIGHTY", "NINETY", "HUNDRED"]
_UNITS = ["PERCENT", "DEGREES", "MINUTES", "SECONDS", "HOURS"]
_FILLER = ["THE", "IN", "TO", "FOR", "AT", "ON", "OFF", "UP", "DOWN",
           "PLEASE", "NOW", "ALL", "EVERY", "VOLUME", "BRIGHTNESS",
           "TEMPERATURE", "AND", "THEN", "AGAIN", "RIGHT", "DAY", "WINE",
           "NIGHT", "MORNING"]

COMMAND_WORDS = sorted(set(_ACTIONS + _DEVICES + _ROOMS + _NUMBERS
                           + _UNITS + _FILLER))


def _skewed(rng, items, alpha=1.6):
    """Zipf-ish skewed choice — gives an LM genuine headroom over a
    uniform prior."""
    w = 1.0 / np.arange(1, len(items) + 1) ** alpha
    return items[int(rng.choice(len(items), p=w / w.sum()))]


def sample_command(rng: np.random.Generator) -> list[str]:
    t = rng.random()
    num = lambda: _skewed(rng, _NUMBERS)          # noqa: E731
    if t < 0.30:
        words = [_skewed(rng, _ACTIONS),
                 "ON" if rng.random() < 0.65 else "OFF", "THE",
                 _skewed(rng, _ROOMS), _skewed(rng, _DEVICES)]
    elif t < 0.50:
        words = ["SET", _skewed(rng, ["TEMPERATURE", "VOLUME",
                                      "BRIGHTNESS"]),
                 "TO", num(), _skewed(rng, _UNITS)]
    elif t < 0.68:
        words = ["SET", "ALARM", "FOR", num(), num()]
    elif t < 0.84:
        words = [_skewed(rng, ["PLAY", "STOP", "PAUSE", "RESUME"]),
                 "MUSIC", "IN", "THE", _skewed(rng, _ROOMS)]
    else:
        words = ["DIM", "THE", _skewed(rng, _ROOMS), "LIGHTS", "TO",
                 num(), "PERCENT"]
    if rng.random() < 0.25:
        words.append("PLEASE")
    if rng.random() < 0.15:
        words = words + ["AND", "THEN", _skewed(rng, _ACTIONS), "THE",
                         _skewed(rng, _DEVICES)]
    return words


def make_commands_corpus(
    out_dir: str | Path,
    n_train: int = 4000,
    n_dev: int = 600,
    n_test: int = 600,
    sr: int = 16000,
    seed: int = 0,
    snr_db: float = 8.0,
    noise_kind: str = "babble",
    speaker_var: float = 1.0,
) -> dict[str, Path]:
    """Realistic-regime corpus: formant pseudo-speech over a >=100-word
    command grammar with broadband/babble noise. Dev/test are sized
    (default 600 utts, ~3-4k words each) so WER deltas of a fraction of a
    percent are resolvable, and the SNR
    knob moves WER smoothly instead of the tone corpus's cliff."""
    out_dir = Path(out_dir)
    (out_dir / "wav").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    manifests = {}
    for split, n in (("train", n_train), ("dev", n_dev), ("test", n_test)):
        utts = []
        for i in range(n):
            words = sample_command(rng)
            x = synth_speech_audio(words, sr=sr, rng=rng, snr_db=snr_db,
                                   noise_kind=noise_kind,
                                   speaker_var=speaker_var)
            uid = f"{split}_{i:05d}"
            wav_path = out_dir / "wav" / f"{uid}.wav"
            write_wav(wav_path, x, sr)
            utts.append(Utterance(
                id=uid,
                audio=str(wav_path),
                duration_s=len(x) / sr,
                text=" ".join(words),
            ))
        mpath = out_dir / f"{split}.jsonl"
        write_manifest(mpath, utts)
        manifests[split] = mpath
    return manifests


def make_phrases_corpus(
    out_dir: str | Path,
    n_train: int = 2000,
    n_dev: int = 100,
    n_test: int = 100,
    sr: int = 16000,
    seed: int = 0,
    speaker_jitter: float = 1.0,
    noise: float = 0.03,
) -> dict[str, Path]:
    """Grammar-structured corpus (area-code phrases). Defaults are
    noisier than make_digits_corpus so the acoustic model actually makes
    errors an LM can correct."""
    out_dir = Path(out_dir)
    (out_dir / "wav").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    manifests = {}
    for split, n in (("train", n_train), ("dev", n_dev), ("test", n_test)):
        utts = []
        for i in range(n):
            words = sample_phrase(rng)
            x = synth_digit_audio(words, sr=sr, rng=rng, noise=noise,
                                  speaker_jitter=speaker_jitter)
            uid = f"{split}_{i:05d}"
            wav_path = out_dir / "wav" / f"{uid}.wav"
            write_wav(wav_path, x, sr)
            utts.append(Utterance(
                id=uid,
                audio=str(wav_path),
                duration_s=len(x) / sr,
                text=" ".join(WORDS[w] for w in words),
            ))
        mpath = out_dir / f"{split}.jsonl"
        write_manifest(mpath, utts)
        manifests[split] = mpath
    return manifests
