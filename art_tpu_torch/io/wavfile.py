"""RIFF/WAV container I/O.

Mirrors the reference CLI's WAV layer (reference art.c:432-471 header
structs, 473-715 parse loop, 1157-1215 writer):

  - reader: RIFF validation, fmt parsing including WAVE_FORMAT_EXTENSIBLE
    (channel mask, ValidBitsPerSample), PCM 4-24-bit and float 32/64 support
    checks, unknown chunks skipped, <= 32 channels,
  - writer: plain header, or extensible when > 2 channels or a nonstandard
    channel mask; the header is written twice (placeholder then rewind +
    rewrite with the true sample count) and odd-sized data gets a pad byte.

Sample data moves as raw bytes plus metadata; conversion to float planes is
the decimator's unpack/pack (ops/decimate_kernel.py / the native runtime).

A copy of ``art_tpu/io/wavfile.py``, unchanged, so that the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

WAVE_FORMAT_PCM = 0x1
WAVE_FORMAT_IEEE_FLOAT = 0x3
WAVE_FORMAT_EXTENSIBLE = 0xFFFE

_FMT_BASE = "<HHIIHH"                  # FormatTag..BitsPerSample
_EXT_GUID_TAIL = bytes([0x00, 0x00, 0x00, 0x00, 0x10, 0x00,
                        0x80, 0x00, 0x00, 0xAA, 0x00, 0x38, 0x9B, 0x71])


class WavFormatError(ValueError):
    """verbatim=True messages are complete reference one-liners (printed
    as-is); others are fragments the CLI wraps as '"<path>" is <msg>!'."""

    def __init__(self, msg: str, verbatim: bool = False):
        super().__init__(msg)
        self.verbatim = verbatim


@dataclass
class WavInfo:
    num_channels: int
    sample_rate: int
    bits_per_sample: int       # valid bits (4-24 int, 32/64 float)
    bytes_per_sample: int      # container bytes per sample
    is_float: bool
    num_frames: int
    channel_mask: int
    data_offset: int           # file offset of the first data byte


def read_wav_header(f) -> WavInfo:
    """Parse up to the data chunk; leaves the file positioned at the data."""
    riff = f.read(12)
    if len(riff) < 12 or riff[0:4] != b"RIFF" or riff[8:12] != b"WAVE":
        raise WavFormatError("not a valid .WAV file")

    fmt_seen = False
    num_channels = sample_rate = bits = block_align = 0
    channel_mask = 0
    is_float = False

    while True:
        hdr = f.read(8)
        if len(hdr) < 8:
            raise WavFormatError("not a valid .WAV file")
        ck_id, ck_size = hdr[0:4], struct.unpack("<I", hdr[4:8])[0]

        if ck_id == b"fmt ":
            if ck_size < 16 or ck_size > 40:
                raise WavFormatError("not a valid .WAV file")
            raw = f.read(ck_size)
            if len(raw) < ck_size:
                raise WavFormatError("not a valid .WAV file")
            (fmt_tag, num_channels, sample_rate, _bps, block_align,
             bits_stored) = struct.unpack(_FMT_BASE, raw[:16])
            bits = bits_stored
            sub_format = fmt_tag
            if fmt_tag == WAVE_FORMAT_EXTENSIBLE and ck_size == 40:
                valid_bits, channel_mask, sub_format = struct.unpack(
                    "<HIH", raw[18:26])
                if valid_bits:
                    bits = valid_bits
            elif num_channels <= 2:
                channel_mask = 0x5 - num_channels
            elif num_channels < 32:
                channel_mask = (1 << num_channels) - 1
            else:
                channel_mask = 0xFFFFFFFF

            if num_channels < 1 or num_channels > 32:
                raise WavFormatError("an unsupported .WAV format")
            if sub_format == WAVE_FORMAT_PCM:
                is_float = False
                if bits < 4 or bits > 24:
                    raise WavFormatError("an unsupported .WAV format")
                if block_align != num_channels * ((bits + 7) // 8):
                    raise WavFormatError("an unsupported .WAV format")
            elif sub_format == WAVE_FORMAT_IEEE_FLOAT:
                is_float = True
                if bits not in (32, 64):
                    raise WavFormatError("an unsupported .WAV format")
                if block_align != num_channels * (bits // 8):
                    raise WavFormatError("an unsupported .WAV format")
            else:
                raise WavFormatError("an unsupported .WAV format")
            fmt_seen = True

        elif ck_id == b"data":
            if not fmt_seen:
                raise WavFormatError("not a valid .WAV file")
            # reference order (art.c:607-627): zero-size data chunk is
            # "no audio samples" (a verbatim line without the filename);
            # a misaligned size is "not a valid .WAV file"
            if not ck_size:
                raise WavFormatError("this .WAV file has no audio samples, "
                                     "probably is corrupt!", verbatim=True)
            if ck_size % block_align:
                raise WavFormatError("not a valid .WAV file")
            num_frames = ck_size // block_align
            return WavInfo(
                num_channels=num_channels, sample_rate=sample_rate,
                bits_per_sample=bits,
                bytes_per_sample=block_align // num_channels,
                is_float=is_float, num_frames=num_frames,
                channel_mask=channel_mask, data_offset=f.tell())

        else:
            # skip unknown chunks (not copied, reference art.c:637-663)
            skip = (ck_size + 1) & ~1
            data = f.read(skip)
            if len(data) != skip:
                raise WavFormatError("not a valid .WAV file")


def write_wav_header(f, *, bits: int, num_channels: int, num_frames: int,
                     sample_rate: int, channel_mask: int) -> None:
    """Write the RIFF header (reference art.c:1157-1215); call once with a
    placeholder frame count, then again after rewind with the real count."""
    bytes_per_sample = (bits + 7) // 8
    fmt = WAVE_FORMAT_IEEE_FLOAT if bits >= 32 else WAVE_FORMAT_PCM
    data_bytes = num_frames * bytes_per_sample * num_channels
    extensible = num_channels > 2 or channel_mask != 0x5 - num_channels

    if extensible:
        fmt_chunk = struct.pack(
            _FMT_BASE + "HHIH", WAVE_FORMAT_EXTENSIBLE, num_channels,
            sample_rate, sample_rate * num_channels * bytes_per_sample,
            bytes_per_sample * num_channels, bits, 22, bits, channel_mask,
            fmt) + _EXT_GUID_TAIL
    else:
        fmt_chunk = struct.pack(
            _FMT_BASE, fmt, num_channels, sample_rate,
            sample_rate * num_channels * bytes_per_sample,
            bytes_per_sample * num_channels, bits)

    # ckSize counts from "WAVE" on: 4 + fmt chunk + data chunk (+ pad)
    riff_size = (4 + 8 + len(fmt_chunk) + 8 + data_bytes + 1) & ~1
    f.write(b"RIFF" + struct.pack("<I", riff_size) + b"WAVE")
    f.write(b"fmt " + struct.pack("<I", len(fmt_chunk)) + fmt_chunk)
    f.write(b"data" + struct.pack("<I", data_bytes))


def decode_frames(raw: bytes, info: WavInfo, gain: float,
                  dtype=np.float32) -> np.ndarray:
    """Raw data bytes -> interleaved float frames [n, channels]."""
    from ..ops.decimate_kernel import unpack_bytes
    dt = np.dtype(dtype)
    if info.is_float:
        src = np.frombuffer(
            raw, dtype="<f4" if info.bits_per_sample == 32 else "<f8")
        out = src.astype(dt)
        if gain != 1.0:
            # the reference computes fl32((double)sample * gain) — one
            # rounding with the gain at full double precision
            # (art.c:989-993, `inbuffer[i] *= gain` with double gain);
            # an f32-rounded gain operand is 1 ulp off on ~6% of samples
            out = (out.astype(np.float64) * gain).astype(dt)
    else:
        out = unpack_bytes(np.frombuffer(raw, dtype=np.uint8), gain,
                           info.bits_per_sample, info.bytes_per_sample, dt)
    return out.reshape(-1, info.num_channels)


def encode_float_frames(frames: np.ndarray, bits: int) -> bytes:
    """Interleaved float frames -> raw bytes for a float WAV (32/64-bit)."""
    if bits == 32:
        return frames.astype("<f4").tobytes()
    return frames.astype("<f8").tobytes()
