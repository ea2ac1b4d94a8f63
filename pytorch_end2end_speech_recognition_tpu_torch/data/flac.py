"""Dependency-free FLAC codec (decoder + encoder), pure Python/numpy (the
port's copy of the JAX package's `data/flac.py`). The bitstream follows the
format spec (RFC 9639 layout):

- decoder: STREAMINFO + frame parsing; CONSTANT / VERBATIM / FIXED(0-4) /
  LPC(1-32) subframes; rice and rice2 residual partitions incl. escape
  codes; independent / left-side / right-side / mid-side channel modes;
  wasted bits; CRC-8 (header) and CRC-16 (frame) verification.
- encoder: mono fixed-blocksize streams with FIXED or quantized-LPC
  predictors and rice residuals, used to write fixtures and tests.
"""

from __future__ import annotations

import hashlib
import struct
from pathlib import Path

import numpy as np

FIXED_COEFFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}

# ---------------------------------------------------------------- CRC tables
def _crc8_table():
    tbl = []
    for b in range(256):
        c = b
        for _ in range(8):
            c = ((c << 1) ^ 0x07) & 0xFF if c & 0x80 else (c << 1) & 0xFF
        tbl.append(c)
    return tbl


def _crc16_table():
    tbl = []
    for b in range(256):
        c = b << 8
        for _ in range(8):
            c = ((c << 1) ^ 0x8005) & 0xFFFF if c & 0x8000 else (c << 1) & 0xFFFF
        tbl.append(c)
    return tbl


_CRC8 = _crc8_table()
_CRC16 = _crc16_table()


def crc8(data: bytes) -> int:
    c = 0
    for b in data:
        c = _CRC8[c ^ b]
    return c


def crc16(data: bytes) -> int:
    c = 0
    for b in data:
        c = _CRC16[((c >> 8) ^ b) & 0xFF] ^ ((c << 8) & 0xFFFF)
    return c


# ---------------------------------------------------------------- bit reader
class BitReader:
    """MSB-first bit reader over a bytes buffer."""

    def __init__(self, data: bytes, pos_bytes: int = 0):
        self.data = data
        self.pos = pos_bytes * 8  # absolute bit position

    @property
    def byte_pos(self) -> int:
        return self.pos >> 3

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def read(self, n: int) -> int:
        """Read n bits as an unsigned int."""
        if n == 0:
            return 0
        end = self.pos + n
        first = self.pos >> 3
        last = (end - 1) >> 3
        chunk = int.from_bytes(self.data[first : last + 1], "big")
        shift = (last + 1) * 8 - end
        self.pos = end
        return (chunk >> shift) & ((1 << n) - 1)

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        return v - (1 << n) if v & (1 << (n - 1)) else v

    def read_unary(self) -> int:
        """Count 0 bits until the terminating 1 bit (FLAC unary)."""
        data = self.data
        n = 0
        pos = self.pos
        # scan remainder of current byte, then whole bytes
        while True:
            byte = data[pos >> 3]
            rem = 8 - (pos & 7)
            window = byte & ((1 << rem) - 1)
            if window:
                lead = rem - window.bit_length()
                self.pos = pos + lead + 1
                return n + lead
            n += rem
            pos += rem

    def read_utf8_number(self) -> int:
        """FLAC's UTF-8-style coded number (extended to 36 bits)."""
        b0 = self.read(8)
        if b0 < 0x80:
            return b0
        n_extra = 0
        mask = 0x40
        while b0 & mask:
            n_extra += 1
            mask >>= 1
        if n_extra == 0:
            raise ValueError("invalid UTF-8 coded number")
        val = b0 & (mask - 1)
        for _ in range(n_extra):
            b = self.read(8)
            if (b & 0xC0) != 0x80:
                raise ValueError("invalid UTF-8 continuation")
            val = (val << 6) | (b & 0x3F)
        return val


# ---------------------------------------------------------------- bit writer
class BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nacc = 0

    def write(self, value: int, n: int) -> None:
        if n == 0:
            return
        self.acc = (self.acc << n) | (value & ((1 << n) - 1))
        self.nacc += n
        while self.nacc >= 8:
            self.nacc -= 8
            self.buf.append((self.acc >> self.nacc) & 0xFF)
        self.acc &= (1 << self.nacc) - 1

    def write_unary(self, q: int) -> None:
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)

    def write_utf8_number(self, v: int) -> None:
        if v < 0x80:
            self.write(v, 8)
            return
        n_extra = 1  # continuation bytes; lead byte carries 6-n_extra bits
        while v >= (1 << (6 * n_extra + (6 - n_extra))):
            n_extra += 1
        lead_bits = 6 - n_extra
        prefix = (0xFF << (lead_bits + 1)) & 0xFF
        self.write(prefix | (v >> (6 * n_extra)), 8)
        for i in range(n_extra - 1, -1, -1):
            self.write(0x80 | ((v >> (6 * i)) & 0x3F), 8)

    def align(self) -> None:
        if self.nacc:
            self.write(0, 8 - self.nacc)

    def getvalue(self) -> bytes:
        assert self.nacc == 0, "unaligned"
        return bytes(self.buf)


# ---------------------------------------------------------------- decoder
class FlacInfo:
    def __init__(self, sample_rate, channels, bits_per_sample, total_samples,
                 min_blocksize, max_blocksize, md5):
        self.sample_rate = sample_rate
        self.channels = channels
        self.bits_per_sample = bits_per_sample
        self.total_samples = total_samples
        self.min_blocksize = min_blocksize
        self.max_blocksize = max_blocksize
        self.md5 = md5

    @property
    def duration_s(self) -> float:
        return self.total_samples / self.sample_rate


def _parse_streaminfo(data: bytes):
    """Returns (FlacInfo, byte offset of first frame)."""
    if data[:4] != b"fLaC":
        raise ValueError("not a FLAC file (missing fLaC magic)")
    pos = 4
    info = None
    while True:
        hdr = data[pos : pos + 4]
        if len(hdr) < 4:
            raise ValueError("truncated metadata")
        last = hdr[0] >> 7
        btype = hdr[0] & 0x7F
        size = int.from_bytes(hdr[1:4], "big")
        body = data[pos + 4 : pos + 4 + size]
        if btype == 0:  # STREAMINFO
            if len(body) < 34:
                raise ValueError("short STREAMINFO")
            br = BitReader(body)
            min_bs = br.read(16)
            max_bs = br.read(16)
            br.read(24)  # min frame size
            br.read(24)  # max frame size
            sr = br.read(20)
            ch = br.read(3) + 1
            bps = br.read(5) + 1
            total = br.read(36)
            md5 = body[18:34]
            info = FlacInfo(sr, ch, bps, total, min_bs, max_bs, md5)
        pos += 4 + size
        if last:
            break
    if info is None:
        raise ValueError("no STREAMINFO block")
    return info, pos


def flac_info(path: str | Path) -> FlacInfo:
    """STREAMINFO only — exact duration without decoding (prep scripts)."""
    with open(str(path), "rb") as f:
        head = f.read(64 * 1024)
    return _parse_streaminfo(head)[0]


def _decode_residual(br: BitReader, blocksize: int, order: int) -> np.ndarray:
    method = br.read(2)
    if method > 1:
        raise ValueError(f"reserved residual coding method {method}")
    plen = 4 if method == 0 else 5
    escape = (1 << plen) - 1
    porder = br.read(4)
    n_parts = 1 << porder
    if blocksize % n_parts:
        raise ValueError("partition order does not divide blocksize")
    out = np.empty(blocksize - order, np.int64)
    w = 0
    for p in range(n_parts):
        n = (blocksize >> porder) - (order if p == 0 else 0)
        k = br.read(plen)
        if k == escape:
            raw = br.read(5)
            if raw:
                for i in range(n):
                    out[w + i] = br.read_signed(raw)
            else:
                out[w : w + n] = 0
        else:
            for i in range(n):
                q = br.read_unary()
                u = (q << k) | br.read(k)
                out[w + i] = (u >> 1) ^ -(u & 1)  # un-zigzag
        w += n
    return out


def _restore_fixed(res: np.ndarray, warm: np.ndarray, order: int) -> np.ndarray:
    """Invert r = D^order x by `order` cumulative integrations; boundary
    constants are successive differences of the warmup samples."""
    if order == 0:
        return res.copy()
    y = res.astype(np.int64)
    w = warm.astype(np.int64)
    for j in range(order, 0, -1):
        b = np.diff(w, n=j - 1)[-1]
        y = b + np.cumsum(y)
    return np.concatenate([w, y])


def _restore_lpc(res, warm, coefs, shift):
    n = len(warm) + len(res)
    x = np.empty(n, np.int64)
    order = len(warm)
    x[:order] = warm
    c = np.asarray(coefs, np.int64)[::-1]  # c[j] applies to x[i-order+j]
    for i in range(order, n):
        pred = int(np.dot(c, x[i - order : i])) >> shift
        x[i] = res[i - order] + pred
    return x


def _decode_subframe(br: BitReader, blocksize: int, bps: int) -> np.ndarray:
    if br.read(1):
        raise ValueError("subframe padding bit set")
    stype = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = br.read_unary() + 1
    ebps = bps - wasted
    if stype == 0:  # CONSTANT
        v = br.read_signed(ebps)
        out = np.full(blocksize, v, np.int64)
    elif stype == 1:  # VERBATIM
        out = np.fromiter((br.read_signed(ebps) for _ in range(blocksize)),
                          np.int64, blocksize)
    elif 8 <= stype <= 12:  # FIXED
        order = stype - 8
        warm = np.fromiter((br.read_signed(ebps) for _ in range(order)),
                           np.int64, order)
        res = _decode_residual(br, blocksize, order)
        out = _restore_fixed(res, warm, order)
    elif stype >= 32:  # LPC
        order = (stype & 31) + 1
        warm = np.fromiter((br.read_signed(ebps) for _ in range(order)),
                           np.int64, order)
        prec = br.read(4) + 1
        if prec == 16:
            raise ValueError("invalid LPC precision")
        shift = br.read_signed(5)
        if shift < 0:
            raise ValueError("negative LPC shift")
        coefs = [br.read_signed(prec) for _ in range(order)]
        res = _decode_residual(br, blocksize, order)
        out = _restore_lpc(res, warm, coefs, shift)
    else:
        raise ValueError(f"reserved subframe type {stype}")
    return out << wasted if wasted else out


_BLOCKSIZES = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
               8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
               13: 8192, 14: 16384, 15: 32768}
_RATES = {1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000, 6: 22050,
          7: 24000, 8: 32000, 9: 44100, 10: 48000, 11: 96000}
_SAMPLE_SIZES = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}


def _decode_frame(data: bytes, pos: int, info: FlacInfo, check_crc: bool):
    """Decode one frame at byte `pos`; returns (samples (ch, n), new pos)."""
    br = BitReader(data, pos)
    sync = br.read(14)
    if sync != 0x3FFE:
        raise ValueError(f"bad frame sync at byte {pos}")
    if br.read(1):
        raise ValueError("reserved bit set in frame header")
    br.read(1)  # blocking strategy
    bs_code = br.read(4)
    sr_code = br.read(4)
    ch_code = br.read(4)
    ss_code = br.read(3)
    if br.read(1):
        raise ValueError("reserved bit set in frame header")
    br.read_utf8_number()  # frame/sample number
    if bs_code == 0:
        raise ValueError("reserved blocksize code 0")
    elif bs_code == 6:
        blocksize = br.read(8) + 1
    elif bs_code == 7:
        blocksize = br.read(16) + 1
    else:
        blocksize = _BLOCKSIZES[bs_code]
    if sr_code == 0:
        pass
    elif sr_code in _RATES:
        pass
    elif sr_code == 12:
        br.read(8)
    elif sr_code in (13, 14):
        br.read(16)
    else:
        raise ValueError("invalid sample rate code")
    bps = info.bits_per_sample if ss_code == 0 else _SAMPLE_SIZES[ss_code]
    header_crc = br.read(8)
    if check_crc and crc8(data[pos : br.byte_pos - 1]) != header_crc:
        raise ValueError(f"frame header CRC-8 mismatch at byte {pos}")

    if ch_code <= 7:
        n_ch = ch_code + 1
        chans = [_decode_subframe(br, blocksize, bps) for _ in range(n_ch)]
        out = np.stack(chans)
    elif ch_code in (8, 9, 10):  # stereo decorrelation; side has +1 bit
        bits = {8: (bps, bps + 1), 9: (bps + 1, bps), 10: (bps, bps + 1)}
        b0, b1 = bits[ch_code]
        c0 = _decode_subframe(br, blocksize, b0)
        c1 = _decode_subframe(br, blocksize, b1)
        if ch_code == 8:      # left, side
            left, right = c0, c0 - c1
        elif ch_code == 9:    # side, right
            left, right = c1 + c0, c1
        else:                 # mid, side
            side = c1
            mid = (c0 << 1) | (side & 1)
            left = (mid + side) >> 1
            right = (mid - side) >> 1
        out = np.stack([left, right])
    else:
        raise ValueError(f"reserved channel assignment {ch_code}")
    br.align()
    frame_crc = br.read(16)
    if check_crc and crc16(data[pos : br.byte_pos - 2]) != frame_crc:
        raise ValueError(f"frame CRC-16 mismatch at byte {pos}")
    return out, br.byte_pos


def read_flac(path: str | Path, check_crc: bool = True,
              verify_md5: bool = False) -> tuple[np.ndarray, int]:
    """Decode a FLAC file -> (float32 mono samples in [-1, 1], sample_rate).

    Multi-channel is downmixed by mean (matches `read_wav`)."""
    data = Path(str(path)).read_bytes()
    info, pos = _parse_streaminfo(data)
    blocks = []
    total = 0
    while pos < len(data) and (info.total_samples == 0
                               or total < info.total_samples):
        if len(data) - pos < 2:
            break
        frame, pos = _decode_frame(data, pos, info, check_crc)
        blocks.append(frame)
        total += frame.shape[1]
    if not blocks:
        raise ValueError(f"{path}: no frames decoded")
    pcm = np.concatenate(blocks, axis=1)  # (ch, n)
    if info.total_samples:
        pcm = pcm[:, : info.total_samples]
    if verify_md5 and info.md5 != b"\0" * 16:
        nbytes = (info.bits_per_sample + 7) // 8
        inter = pcm.T.astype(np.int64)
        raw = bytearray()
        for frame_row in inter.reshape(-1):
            raw += int(frame_row & ((1 << (8 * nbytes)) - 1)).to_bytes(
                nbytes, "little")
        if hashlib.md5(bytes(raw)).digest() != info.md5:
            raise ValueError(f"{path}: MD5 mismatch (corrupt stream)")
    scale = float(1 << (info.bits_per_sample - 1))
    x = pcm.astype(np.float32) / scale
    if x.shape[0] > 1:
        x = x.mean(axis=0)
    else:
        x = x[0]
    return np.ascontiguousarray(x, dtype=np.float32), info.sample_rate


# ---------------------------------------------------------------- encoder
def _rice_cost(res: np.ndarray, k: int) -> int:
    u = (res << 1) ^ (res >> 63)
    return int(np.sum(u >> k)) + len(res) * (k + 1)


def _best_rice_k(res: np.ndarray) -> int:
    if len(res) == 0:
        return 0
    u = (res << 1) ^ (res >> 63)
    mean = max(1.0, float(u.mean()))
    k0 = min(14, max(0, int(np.log2(mean))))
    return min(range(max(0, k0 - 1), min(15, k0 + 3)),
               key=lambda k: _rice_cost(res, k))


def _write_residual(bw: BitWriter, res: np.ndarray) -> None:
    """Partition order 0, rice method 0 (4-bit params) with escape."""
    bw.write(0, 2)   # rice, 4-bit params
    bw.write(0, 4)   # partition order 0
    k = _best_rice_k(res)
    u = (res << 1) ^ (res >> 63)
    max_q = int((u >> k).max()) if len(u) else 0
    if max_q > 48:  # pathological: escape to raw
        raw = max(1, int(np.abs(res).max()).bit_length() + 1) if len(res) else 1
        raw = min(raw, 31)
        bw.write(15, 4)
        bw.write(raw, 5)
        for v in res:
            bw.write(int(v), raw)
        return
    bw.write(k, 4)
    for uv in u:
        bw.write_unary(int(uv) >> k)
        bw.write(int(uv), k)


def _fixed_residual(x: np.ndarray, order: int) -> np.ndarray:
    return np.diff(x, n=order) if order else x.copy()


def _lpc_coefs(x: np.ndarray, order: int, prec: int = 14):
    """Levinson-Durbin + quantization. Returns (coefs, shift) or None."""
    xf = x.astype(np.float64)
    n = len(xf)
    if n <= order + 1:
        return None
    ac = np.array([np.dot(xf[: n - i], xf[i:]) for i in range(order + 1)])
    if ac[0] == 0:
        return None
    a = _levinson(ac, order)
    if a is None:
        return None
    cmax = np.abs(a).max()
    if cmax == 0 or not np.isfinite(cmax):
        return None
    shift = min(14, max(1, prec - 1 - int(np.floor(np.log2(cmax))) - 1))
    q = np.clip(np.round(a * (1 << shift)), -(1 << (prec - 1)),
                (1 << (prec - 1)) - 1).astype(np.int64)
    if not q.any():
        return None
    return q, shift, prec


def _levinson(ac: np.ndarray, order: int):
    err = ac[0]
    a = np.zeros(0)
    for i in range(order):
        acc = ac[i + 1]
        if i:
            acc -= np.dot(a, ac[1 : i + 1][::-1])
        if err == 0:
            return None
        k = acc / err
        a = np.concatenate([a - k * a[::-1], [k]])
        err *= 1 - k * k
        if err <= 0 or not np.isfinite(err):
            return None
    return a


def _lpc_residual(x: np.ndarray, coefs: np.ndarray, shift: int) -> np.ndarray:
    order = len(coefs)
    xi = x.astype(np.int64)
    pred = np.zeros(len(x) - order, np.int64)
    for j, c in enumerate(coefs):  # pred[i] = sum c[j] * x[order-1-j+i]
        pred += c * xi[order - 1 - j : len(x) - 1 - j]
    return xi[order:] - (pred >> shift)


def _encode_subframe(bw: BitWriter, x: np.ndarray, bps: int,
                     predictor: str) -> None:
    if np.all(x == x[0]):
        bw.write(0, 1)
        bw.write(0, 6)   # CONSTANT
        bw.write(0, 1)
        bw.write(int(x[0]), bps)
        return
    cands = []
    max_order = min(4, len(x) - 1)
    for order in range(0, max_order + 1):
        res = _fixed_residual(x, order)
        cost = order * bps + _rice_cost(res, _best_rice_k(res))
        cands.append((cost, "fixed", order, res, None))
    if predictor == "lpc" and len(x) > 16:
        order = min(8, len(x) - 2)
        lp = _lpc_coefs(x, order)
        if lp is not None:
            q, shift, prec = lp
            res = _lpc_residual(x, q, shift)
            cost = (order * bps + 4 + 5 + order * prec
                    + _rice_cost(res, _best_rice_k(res)))
            cands.append((cost, "lpc", order, res, (q, shift, prec)))
    verb_cost = len(x) * bps
    cost, kind, order, res, lp = min(cands, key=lambda c: c[0])
    if verb_cost < cost:
        bw.write(0, 1)
        bw.write(1, 6)   # VERBATIM
        bw.write(0, 1)
        for v in x:
            bw.write(int(v), bps)
        return
    bw.write(0, 1)
    if kind == "fixed":
        bw.write(8 + order, 6)
        bw.write(0, 1)   # no wasted bits
    else:
        bw.write(32 + order - 1, 6)
        bw.write(0, 1)
    for v in x[:order]:
        bw.write(int(v), bps)
    if kind == "lpc":
        q, shift, prec = lp
        bw.write(prec - 1, 4)
        bw.write(shift, 5)
        for c in q:
            bw.write(int(c), prec)
    _write_residual(bw, res)


def write_flac(path: str | Path, x: np.ndarray, sr: int,
               blocksize: int = 4096, predictor: str = "fixed") -> None:
    """Write float32 [-1,1] (or int16) mono samples as a 16-bit FLAC."""
    x = np.asarray(x)
    if x.dtype.kind == "f":
        pcm = (np.clip(x, -1.0, 1.0) * 32767.0).astype(np.int64)
    else:
        pcm = x.astype(np.int64)
    n = len(pcm)
    bps = 16
    md5 = hashlib.md5(pcm.astype("<i2").tobytes()).digest()

    frames = bytearray()
    for fi, start in enumerate(range(0, n, blocksize)):
        blk = pcm[start : start + blocksize]
        bw = BitWriter()
        bw.write(0x3FFE, 14)  # sync
        bw.write(0, 1)        # reserved
        bw.write(0, 1)        # fixed blocksize stream
        bw.write(7, 4)        # blocksize: 16-bit value-1 follows
        sr_code = {88200: 1, 176400: 2, 192000: 3, 8000: 4, 16000: 5,
                   22050: 6, 24000: 7, 32000: 8, 44100: 9, 48000: 10,
                   96000: 11}.get(sr, 0)
        bw.write(sr_code, 4)
        bw.write(0, 4)        # mono
        bw.write(4, 3)        # 16 bps
        bw.write(0, 1)        # reserved
        bw.write_utf8_number(fi)
        bw.write(len(blk) - 1, 16)
        bw.align()
        hdr = bw.getvalue()
        bw2 = BitWriter()
        _encode_subframe(bw2, blk, bps, predictor)
        bw2.align()
        body = hdr + bytes([crc8(hdr)]) + bw2.getvalue()
        frames += body + struct.pack(">H", crc16(body))

    si = BitWriter()
    si.write(min(blocksize, n) if n else blocksize, 16)  # min blocksize
    si.write(blocksize, 16)
    si.write(0, 24)  # min frame size unknown
    si.write(0, 24)
    si.write(sr, 20)
    si.write(0, 3)    # channels - 1
    si.write(bps - 1, 5)
    si.write(n, 36)
    si.align()
    streaminfo = si.getvalue() + md5
    with open(str(path), "wb") as f:
        f.write(b"fLaC")
        f.write(bytes([0x80]) + len(streaminfo).to_bytes(3, "big"))
        f.write(streaminfo)
        f.write(bytes(frames))
