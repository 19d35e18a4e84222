"""Audio file I/O (port of ``pmfm_tpu/io/wav.py``, numpy only): WAV and AIFF
read, WAV write, and ``resample`` (bandlimited sample-rate conversion).

PCM 16/24/32-bit and IEEE float32 WAV, PCM 8/16/24/32 AIFF, mono or
multichannel (averaged to mono on read). Unsupported encodings raise with
the format code in the message. The reference's optional native codec
(``pmfm_tpu/native``) is not ported: this is its pure-numpy path, which it
documents as the behavioural spec.
"""
from __future__ import annotations

import os
import struct

import numpy as np

DEFAULT_SAMPLE_RATE = 44100
DEFAULT_BIT_DEPTH = 24


def read_wav(path: str | os.PathLike) -> tuple[np.ndarray, int]:
    """Read a WAV file -> (mono float32 in [-1, 1], sample_rate)."""
    path = os.fspath(path)
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    payload = None
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body, 0)
            fmt_body = body
        elif cid == b"data":
            payload = body
        pos += 8 + size + (size & 1)
    if fmt is None or payload is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, channels, sample_rate, _, _, bits = fmt
    if audio_format == 0xFFFE:  # WAVE_FORMAT_EXTENSIBLE
        # the real format is the first two bytes of the SubFormat GUID at
        # fmt-body offset 24 (after cbSize + validBits + channelMask)
        if len(fmt_body) >= 26:
            (audio_format,) = struct.unpack_from("<H", fmt_body, 24)
        else:
            audio_format = 1  # malformed extensible header: assume PCM
    if audio_format == 3:  # IEEE float
        x = np.frombuffer(payload, "<f4").astype(np.float32)
    elif audio_format == 1:
        if bits == 16:
            x = np.frombuffer(payload, "<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            raw = np.frombuffer(payload, np.uint8)
            raw = raw[: len(raw) - len(raw) % 3].reshape(-1, 3)
            vals = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16)
            )
            vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
            x = vals.astype(np.float32) / float(1 << 23)
        elif bits == 32:
            x = np.frombuffer(payload, "<i4").astype(np.float32) / float(1 << 31)
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    else:
        raise ValueError(f"{path}: unsupported WAV format code {audio_format}")
    if channels > 1:
        x = x[: len(x) - len(x) % channels].reshape(-1, channels).mean(axis=1)
    return np.ascontiguousarray(x, np.float32), int(sample_rate)


def _read_extended80(b: bytes) -> float:
    """IEEE 754 80-bit extended float (AIFF COMM sample rate), big-endian."""
    sign = b[0] >> 7
    exp = ((b[0] & 0x7F) << 8) | b[1]
    mant = int.from_bytes(b[2:10], "big")
    if exp == 0 and mant == 0:
        return 0.0
    val = mant * 2.0 ** (exp - 16383 - 63)
    return -val if sign else val


def read_aiff(path: str | os.PathLike) -> tuple[np.ndarray, int]:
    """Read an AIFF file -> (mono float32 in [-1, 1], sample_rate).

    Big-endian PCM 8/16/24/32; AIFF-C compressed forms raise a clear error.
    """
    path = os.fspath(path)
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"FORM" or data[8:12] not in (b"AIFF", b"AIFC"):
        raise ValueError(f"{path}: not a FORM/AIFF file")
    is_aifc = data[8:12] == b"AIFC"
    pos = 12
    comm = None
    payload = None
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        (size,) = struct.unpack_from(">I", data, pos + 4)
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"COMM":
            channels, _frames, bits = struct.unpack_from(">hIh", body, 0)
            rate = _read_extended80(body[8:18])
            if is_aifc and len(body) >= 22:
                ctype = body[18:22]
                if ctype not in (b"NONE", b"sowt", b"twos"):
                    raise ValueError(
                        f"{path}: unsupported AIFF-C compression "
                        f"{ctype!r} (only uncompressed PCM is supported)"
                    )
            comm = (channels, bits, int(round(rate)))
        elif cid == b"SSND":
            (offset, _blocksize) = struct.unpack_from(">II", body, 0)
            payload = body[8 + offset :]
        pos += 8 + size + (size & 1)
    if comm is None or payload is None:
        raise ValueError(f"{path}: missing COMM/SSND chunk")
    channels, bits, sample_rate = comm
    if bits == 8:
        x = np.frombuffer(payload, np.int8).astype(np.float32) / 128.0
    elif bits == 16:
        x = np.frombuffer(payload, ">i2").astype(np.float32) / 32768.0
    elif bits == 24:
        raw = np.frombuffer(payload, np.uint8)
        raw = raw[: len(raw) - len(raw) % 3].reshape(-1, 3)
        vals = (
            (raw[:, 0].astype(np.int32) << 16)
            | (raw[:, 1].astype(np.int32) << 8)
            | raw[:, 2].astype(np.int32)
        )
        vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
        x = vals.astype(np.float32) / float(1 << 23)
    elif bits == 32:
        x = np.frombuffer(payload, ">i4").astype(np.float32) / float(1 << 31)
    else:
        raise ValueError(f"{path}: unsupported AIFF bit depth {bits}")
    if channels > 1:
        x = x[: len(x) - len(x) % channels].reshape(-1, channels).mean(axis=1)
    return np.ascontiguousarray(x, np.float32), int(sample_rate)


def read_audio(path: str | os.PathLike) -> tuple[np.ndarray, int]:
    """Read WAV or AIFF by container magic (extension-agnostic)."""
    path = os.fspath(path)
    with open(path, "rb") as f:
        magic = f.read(12)
    if magic[:4] == b"RIFF" and magic[8:12] == b"WAVE":
        return read_wav(path)
    if magic[:4] == b"FORM" and magic[8:12] in (b"AIFF", b"AIFC"):
        return read_aiff(path)
    raise ValueError(
        f"{path}: unrecognised audio container "
        f"(magic {magic[:4]!r}/{magic[8:12]!r}; WAV and AIFF are supported)"
    )


def resample(
    audio: np.ndarray, sr_from: int, sr_to: int, taps: int = 64
) -> np.ndarray:
    """Bandlimited sample-rate conversion: Kaiser-windowed-sinc
    interpolation evaluated at the true output sample times (beta=8.6,
    ~90 dB stopband; anti-alias cutoff scaled when downsampling). Used when
    a target file's rate differs from the config's ``sampleRate`` so
    matching happens at the synthesis engine's rate instead of silently
    reinterpreting samples at the wrong rate (round-1 behaviour)."""
    if sr_from == sr_to:
        return np.asarray(audio, np.float32)
    x = np.asarray(audio, np.float64)
    n = len(x)
    # round, don't floor: a 2048-sample chunk must survive a 44.1k->48k->
    # 44.1k round trip as 2048 samples (floor loses one and a one-chunk
    # target would then be "shorter than one chunk")
    n_out = int(round(n * sr_to / float(sr_from)))
    c = min(1.0, sr_to / float(sr_from))  # anti-alias cutoff (in/out Nyquist)
    beta = 8.6
    i0b = np.i0(beta)
    offs = np.arange(-(taps // 2) + 1, taps // 2 + 1, dtype=np.float64)
    step = sr_from / float(sr_to)
    y = np.empty(n_out, np.float64)
    half = taps / 2.0
    for j0 in range(0, n_out, 1 << 16):  # block to bound the (B, taps) matrix
        j = np.arange(j0, min(j0 + (1 << 16), n_out), dtype=np.float64)
        t = j * step  # output sample positions, in input-sample units
        k0 = np.floor(t)
        idx = (k0[:, None] + offs[None, :]).astype(np.int64)
        d = t[:, None] - idx  # in (-taps/2, taps/2]
        w = np.sinc(c * d) * np.i0(beta * np.sqrt(np.maximum(0.0, 1.0 - (d / half) ** 2))) / i0b
        valid = (idx >= 0) & (idx < n)
        xi = np.where(valid, x[np.clip(idx, 0, n - 1)], 0.0)
        y[int(j0) : int(j0) + len(j)] = c * np.sum(xi * w, axis=1)
    return np.ascontiguousarray(y, np.float32)


def write_wav(
    path: str | os.PathLike,
    audio: np.ndarray,
    sample_rate: int = DEFAULT_SAMPLE_RATE,
    bit_depth: int = DEFAULT_BIT_DEPTH,
    normalize: bool = False,
) -> None:
    """Write mono audio to WAV (PCM 16/24/32 or float32 via bit_depth=0).

    The reference writes un-normalised candidate audio whose amplitude is in
    the thousands (output = osc * modFreq*modIdx); pass ``normalize=True`` to
    peak-normalise into [-1, 1] first (recommended for audition).
    """
    path = os.fspath(path)
    audio = np.asarray(audio, np.float32).reshape(-1)
    if normalize:
        peak = float(np.abs(audio).max()) or 1.0
        audio = audio / peak
    if bit_depth == 0:  # IEEE float32
        fmt_code, bits, payload = 3, 32, audio.astype("<f4").tobytes()
    elif bit_depth == 16:
        q = np.clip(np.rint(audio * 32767.0), -32768, 32767).astype("<i2")
        fmt_code, bits, payload = 1, 16, q.tobytes()
    elif bit_depth == 24:
        q = np.clip(np.rint(audio * float((1 << 23) - 1)), -(1 << 23), (1 << 23) - 1).astype(
            np.int32
        )
        b = np.empty((len(q), 3), np.uint8)
        b[:, 0] = q & 0xFF
        b[:, 1] = (q >> 8) & 0xFF
        b[:, 2] = (q >> 16) & 0xFF
        fmt_code, bits, payload = 1, 24, b.tobytes()
    elif bit_depth == 32:
        q = np.clip(np.rint(audio * float((1 << 31) - 1)), -(1 << 31), (1 << 31) - 1).astype(
            "<i4"
        )
        fmt_code, bits, payload = 1, 32, q.tobytes()
    else:
        raise ValueError(f"unsupported bit depth {bit_depth}")
    block_align = bits // 8
    hdr = b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE"
    hdr += b"fmt " + struct.pack(
        "<IHHIIHH", 16, fmt_code, 1, sample_rate, sample_rate * block_align, block_align, bits
    )
    hdr += b"data" + struct.pack("<I", len(payload))
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "wb") as f:
        f.write(hdr + payload)
