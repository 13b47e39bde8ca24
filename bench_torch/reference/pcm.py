"""Plain reference of the decimator (decimator.c): TPDF dither, quantization
with optional noise-shaped error feedback, clipping and little-endian
packing of float samples, in plain PyTorch.

Written from the C reference's semantics (decimator.c:40-52, 62-89,
152-194, 370-409), per channel c and frame i:

- the dither generator is the uint32 LCG g -> ((g << 4) - g) ^ 1, stepped
  5 times a frame; with g0 the state entering the frame and r2, r5 the
  states 2 and 5 steps on, first = ~g0 (highpass, type -1), g0 (lowpass,
  type 1) or ~r2 (flat, type 0), and the draw ((first >> 1) + (r5 >> 1)) /
  2^31 - 1 in double, stored in the data type;
- code = fl(fl(x * scaler) - fb), ov = floor(double(fl(code + d)) + 0.5);
- with shaping, fb is the output of the decoupled 4th-order filter H(z)
  (a[k] = b[k+1] - a[k+1] of the curve's N(z)) fed the error fl(T(ov) -
  code), summed oldest term first in the data type: s = err*a0, then s +=
  xh3*a4 - b4*yh3, xh2*a3 - b3*yh2, xh1*a2 - b2*yh1, xh0*a1 - b1*yh0;
- ov above 2^(bits-1) - 1 or below -2^(bits-1) is counted and clamped;
- v = (ov << (24 - bits) % 8) + (128 for 8 bits or fewer), its (bits + 7)
  / 8 low bytes after bytes - (bits + 7) / 8 zero bytes.

Each channel's generator starts from a byte-wise LCG stream off 0x31415926
filling the decimator's uint32 states (decimator.c:40-52): every file's
decimator starts from the same stream.  Its state after any number of
steps has a closed form (``jump``): two steps take an even state g to 225 g
+ 14 and an odd one to 225 g - 14, keeping its parity.

The quantizer runs vectorised over lanes (channels, and calls stacked side
by side) with a loop over frames; its dither is computed a block of frames
at a time in closed form from the block's first states.
"""

from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF

# N(z) of the ATH noise-shaping curves, rate -> (a1..a4, b1..b4), a0 = 1
# (decimator.c:70-78, Gesemann / Lame)
ATH_CURVES = {
    32000: (-0.780459, +0.569358, -0.348221, +0.466316,
            +0.950797, +0.282052, +0.004337, +1.76209e-5),
    44100: (-1.1474, 0.5383, -0.3530, 0.3475,
            1.0587, 0.0676, -0.6054, -0.2738),
    48000: (-1.3344, 0.7455, -0.4602, 0.4363,
            0.9030, 0.0116, -0.5853, -0.2571),
    88200: (-2.150679, +2.1402057, -1.042712, +0.206838,
            +0.67433, +1.017047, +0.4028633, +0.098656),
    96000: (-2.16994, +2.01986, -0.894857, +0.1557738,
            +0.517789, +1.1062189, +0.4825786, +0.244994),
}
# the 1st-order shaper, which a rate without an ATH curve falls back to
FIRST_ORDER = (-1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)

# decimator.h's dither flags and the type each selects, highpass first
DITHER_TYPES = (("DITHER_HIGHPASS", -1), ("DITHER_LOWPASS", 1),
                ("DITHER_FLAT", 0))


def seed_generators(channels: int) -> np.ndarray:
    """The initial generator states of a decimator of ``channels``
    channels, uint32 [channels]."""
    random = 0x31415926
    seed = bytearray()
    for _ in range(4 * channels):
        seed.append((random >> 24) & 0xFF)
        for _ in range(3):
            random = (((random << 4) - random) ^ 1) & MASK
    return np.frombuffer(bytes(seed), dtype="<u4").astype(np.uint32)


def track_seeds(tracks: int, channels: int) -> np.ndarray:
    """uint32 [tracks * channels]: each file's decimator's states, file t
    at channels [t * channels, (t + 1) * channels)."""
    return np.tile(seed_generators(channels), tracks)


def jump(states, steps: int) -> np.ndarray:
    """uint32 states after ``steps`` steps of the LCG, in closed form."""
    g = np.asarray(states, np.uint64)
    pairs = steps // 2
    a, b = 1, 0                         # 2*pairs steps: g -> a g +- b
    pa, pb = 225, 14                    # the map of 2^k pairs
    while pairs:
        if pairs & 1:
            a, b = (a * pa) & MASK, (b * pa + pb) & MASK
        pa, pb = (pa * pa) & MASK, (pb * pa + pb) & MASK
        pairs >>= 1
    odd = (g & 1).astype(bool)
    g = (np.uint64(a) * g + np.where(odd, np.uint64(MASK + 1 - b),
                                     np.uint64(b))) & np.uint64(MASK)
    if steps % 2:
        g = (np.uint64(15) * g + np.where(g & 1, np.uint64(MASK),
                                          np.uint64(1))) & np.uint64(MASK)
    return g.astype(np.uint32)


def _mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b mod 2^32 of int64 tensors of uint32 values, exact."""
    lo = (a & 0xFFFF) * b
    hi = ((a >> 16) * b) & 0xFFFF
    return (lo + (hi << 16)) & MASK


def _tables(steps: int, device):
    """(A, V) int64: after k = 1..steps steps a state g of parity p is A[k-1]
    g + V[p, k-1] mod 2^32 (each step multiplies by 15 and adds +1 from an
    even state, -1 from an odd one; the parity flips every step)."""
    A = np.empty(steps, np.int64)
    V = np.empty((2, steps), np.int64)
    a, v = 1, [0, 0]
    for k in range(steps):
        a = (a * 15) & MASK
        for p in (0, 1):
            c = 1 if (p + k) % 2 == 0 else MASK
            v[p] = (v[p] * 15 + c) & MASK
        A[k] = a
        V[:, k] = v
    return (torch.from_numpy(A).to(device), torch.from_numpy(V).to(device))


def dither_block(states: torch.Tensor, dither_type: int, frames: int,
                 tables):
    """(draws float64 [frames, lanes], states after 5 * frames steps) from
    int64 ``states`` [lanes] of uint32 values; ``tables`` of at least 5 *
    frames steps."""
    A, V = tables
    n = 5 * frames
    seq = (_mul32(A[None, :n], states[:, None])
           + V[(states & 1)][:, :n]) & MASK
    g0 = torch.cat([states[:, None], seq[:, 4:n - 1:5]], dim=1)
    r2, r5 = seq[:, 1::5], seq[:, 4::5]
    if dither_type == -1:
        first = g0 ^ MASK
    elif dither_type == 1:
        first = g0
    else:
        first = r2 ^ MASK
    d = ((first >> 1) + (r5 >> 1)).to(torch.float64) / 2147483648.0 - 1.0
    return d.T, seq[:, n - 1]


class Decimator:
    """The reference decimator's arithmetic for ``lanes`` independent
    channels at once, float32 or float64 data: ``dither_type`` -1, 1, 0
    or None (no dither), ``ath`` the ATH noise shaping of
    ``sample_rate`` (or no shaping)."""

    def __init__(self, *, output_bits: int, output_bytes: int,
                 output_gain: float, sample_rate: int, dither_type=None,
                 ath: bool = False, dtype=torch.float32, block: int = 512):
        self.bits, self.nbytes = output_bits, output_bytes
        self.dt = dtype
        self.scaler = float(torch.tensor((1 << output_bits) / 2.0
                                         * output_gain, dtype=dtype))
        self.hi = (1 << (output_bits - 1)) - 1
        self.lo = -(1 << (output_bits - 1))
        self.dither_type = dither_type
        self.block = block
        self.coef = None
        if ath:
            a1, a2, a3, a4, b1, b2, b3, b4 = ATH_CURVES.get(sample_rate,
                                                            FIRST_ORDER)
            self.coef = ([b1 - a1, b2 - a2, b3 - a3, b4 - a4, 0.0],
                         [0.0, b1, b2, b3, b4])

    def run(self, x: torch.Tensor, gens, fb, xh, yh):
        """Quantize ``x`` [frames, lanes] from the state (``gens`` int64
        [lanes] of uint32 values, or None without dither; ``fb`` [lanes];
        ``xh``, ``yh`` [4, lanes], newest first).  Returns (ov int64 [frames,
        lanes] clamped, clip flags bool [frames, lanes], the state after:
        (gens, fb, xh, yh))."""
        dev, dt = x.device, self.dt
        frames, lanes = x.shape
        xs = x.to(dt) * torch.tensor(self.scaler, dtype=dt, device=dev)
        fb = fb.to(dt)
        xhs, yhs = list(xh.to(dt)), list(yh.to(dt))
        if self.coef is not None:
            a, b = ([torch.tensor(v, dtype=torch.float64).to(dt).to(dev)
                     for v in row] for row in self.coef)
        tables = _tables(5 * min(self.block, frames), dev) \
            if self.dither_type is not None else None
        zero = torch.zeros((), dtype=dt, device=dev)
        ovs = []
        for f0 in range(0, frames, self.block):
            nf = min(self.block, frames - f0)
            if self.dither_type is None:
                d = zero.expand(nf, lanes)
            else:
                d64, gens = dither_block(gens, self.dither_type, nf, tables)
                d = d64.to(dt)
            for i in range(nf):
                code = xs[f0 + i] - fb
                ov = torch.floor((code + d[i]).to(torch.float64) + 0.5)
                ovs.append(ov)
                if self.coef is None:
                    continue
                err = ov.to(dt) - code
                s = err * a[0]
                for k in (3, 2, 1, 0):
                    s = s + (xhs[k] * a[k + 1] - b[k + 1] * yhs[k])
                xhs = [err, *xhs[:3]]
                yhs = [s, *yhs[:3]]
                fb = s
        ov = torch.stack(ovs) if ovs else torch.zeros(
            (0, lanes), dtype=torch.float64, device=dev)
        clipped = (ov > self.hi) | (ov < self.lo)
        ov = ov.clamp(self.lo, self.hi).to(torch.int64)
        return ov, clipped, (gens, fb, torch.stack(xhs), torch.stack(yhs))

    def pack(self, ov: torch.Tensor) -> torch.Tensor:
        """Little-endian bytes uint8 [frames, lanes * bytes] of the codes
        ``ov`` [frames, lanes]."""
        frames, lanes = ov.shape
        used = (self.bits + 7) // 8
        shift = (24 - self.bits) % 8
        offset = 128 if self.bits <= 8 else 0
        v = (ov * (1 << shift) + offset) & MASK
        planes = [torch.zeros_like(v)] * (self.nbytes - used)
        planes += [(v >> (8 * j)) & 0xFF for j in range(used)]
        return torch.stack(planes, dim=2).to(torch.uint8) \
            .reshape(frames, lanes * self.nbytes)

    def unpack(self, packed: torch.Tensor) -> torch.Tensor:
        """The codes int64 [..., lanes] of little-endian bytes uint8 [...,
        lanes * bytes] (the inverse of ``pack``)."""
        used = (self.bits + 7) // 8
        b = packed.to(torch.int64).reshape(*packed.shape[:-1], -1,
                                           self.nbytes)
        v = sum(b[..., self.nbytes - used + j] << (8 * j)
                for j in range(used))
        if self.bits <= 8:
            v = v - 128
        else:
            v = torch.where(v >= 1 << (8 * used - 1), v - (1 << (8 * used)),
                            v)
        return v >> ((24 - self.bits) % 8)
