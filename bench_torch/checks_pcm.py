"""The comparisons that decide ``correct`` for the cells that deliver
integer PCM (``entries/pcm_batch.py``, ``entries/flat_packed.py``).

Each is computed on the run's device once the program's state is freed,
from the configuration, the seed's inputs and the plain references
(``reference/fixed_ratio.py``, ``reference/bank.py``, ``reference/pcm.py``):

- ``count_mismatch``: calls whose outputs differ in number from the
  reference's, over every call from the stream's start (as
  ``checks.fixed_ratio`` counts them); exact.
- ``sample_err`` (the batch cell): over the kept calls, the largest gap
  between the program's float block and the float64 resample reference,
  over the reference's RMS, as ``checks.fixed_ratio`` computes it, with
  the reference's own lowpass for downsampling.
- ``code_mismatch`` (the batch cell): bytes of the kept calls where the
  program's packed output differs from the reference decimator run on the
  program's own float block from the state that entered the call; exact.
- ``code_mismatch`` (the packed cell): codes of the kept calls that
  differ from those of the float64 resample reference under the same
  rounding (round half up, clamp), where the reference's scaled value lies
  more than ``TIE_LSB`` from a rounding boundary; within it, the codes
  either side of the boundary both count as right; exact otherwise.
- ``clip_mismatch``: the batch cell: over the kept calls, the gap between
  the program's clip count and the reference decimator's; exact.  The
  packed cell: how far the program's clip count lies outside the range the
  float64 resample reference allows, from its samples past a clip bound by
  more than ``TIE_LSB`` to those past it or within ``TIE_LSB`` of it, as
  ``count_mismatch`` takes either count at a tie; exact otherwise.
- ``state_mismatch`` (the batch cell): the dither states after the window
  that differ from each file's seeds jumped 5 x (the frames quantized
  since the start) steps in closed form, the states that entered each kept
  call that differ from that jump, and the state elements (dither,
  feedback, shaper histories) that entered a kept call and differ from
  what the reference left after the call before it, where both are kept;
  exact.

With ``control`` the reference computed as a TF32 tensor core would takes
the program's place in ``sample_err`` and the packed cell's
``code_mismatch``, so the run has to come out not correct.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .checks import _Gap, _program
from .reference import fixed_ratio as fixed_ref
from .reference import pcm
from .reference.bank import phase_bank

# distance from a rounding boundary, in LSB, within which a sound float32
# K1 may round either way: it lies ~0.03 LSB from float64 at the packed
# cell's level (PERF.md section 2)
TIE_LSB = 0.1


def _geometry(cfg) -> dict:
    g = math.gcd(int(cfg["source_rate"]), int(cfg["destin_rate"]))
    return dict(L=int(cfg["destin_rate"]) // g,
                M=int(cfg["source_rate"]) // g, taps=cfg["num_taps"])


def lowpass_ratio(cfg) -> float:
    """The sinc's cutoff over the source's Nyquist rate: for downsampling
    with INCLUDE_LOWPASS and no lowpass frequency given, the reference's
    own (1 - 7.5 / taps / ratio, no lower than 0.8 nor than the ratio)
    folded by the ratio (resampler.c's fixed-ratio init); else 1."""
    ratio = cfg["destin_rate"] / cfg["source_rate"]
    if cfg["lowpass_freq"] or "INCLUDE_LOWPASS" not in cfg["flags"] or \
            ratio >= 1:
        return 1.0
    lp = 1.0 - 7.5 / cfg["num_taps"] / ratio
    return max(lp, 0.8, ratio) * ratio


def count_mismatch(counts, log, *, L: int, M: int, taps: int) -> int:
    mismatch, cum = 0, 0
    for c, K in enumerate(counts):
        cum += K
        ref, tie = fixed_ref.emitted(log.starts[c] + log.calls[c][2], L=L,
                                     M=M, taps=taps)
        mismatch += not (cum == ref or (tie and cum == ref + 1))
    return mismatch


def _resampled(entry, log, call: int, k0: int, bank, geom, control=False):
    """The float64 reference's outputs [C, K] of call ``call`` (TF32 with
    ``control``)."""
    K = entry.counts[call]
    a, b = fixed_ref.window_span(k0, k0 + K, **geom)
    seg = log.segment(a, b, entry.dev)
    return fixed_ref.outputs(seg, a, k0, k0 + K, L=geom["L"], M=geom["M"],
                             bank=bank, control=control)


def _decimator(cfg, dev) -> pcm.Decimator:
    dither = next((t for name, t in pcm.DITHER_TYPES
                   if name in cfg["decimator_flags"]), None)
    return pcm.Decimator(output_bits=cfg["output_bits"],
                         output_bytes=cfg["output_bytes"],
                         output_gain=cfg["output_gain"],
                         sample_rate=cfg["destin_rate"], dither_type=dither,
                         ath="SHAPING_ATH_CURVE" in cfg["decimator_flags"],
                         dtype=getattr(torch, cfg["dtype"]))


def _values(bits: torch.Tensor) -> torch.Tensor:
    """int32 state bits -> int64 uint32 values."""
    return bits.to(torch.int64) & pcm.MASK


def _seeds_after(seeds: np.ndarray, frames: int, dev) -> torch.Tensor:
    return torch.from_numpy(pcm.jump(seeds, 5 * frames).astype(np.int64)) \
        .to(dev)


def pcm_batch(entry, records, log, control: bool) -> dict:
    """Tracks of a fixed-ratio stream, each through its own decimator;
    ``records`` are (call, first output index, float block [ch, >= K],
    packed [K, ch * bytes], clips int32 0-d, (gens, fb, xh, yh) that
    entered the call)."""
    cfg, dev = entry.cfg, entry.dev
    geom = _geometry(cfg)
    bank = phase_bank(geom["taps"], geom["L"], lowpass=lowpass_ratio(cfg),
                      device=dev)
    gap = _Gap()
    for call, k0, out, *_ in records:
        K = entry.counts[call]
        ref = _resampled(entry, log, call, k0, bank, geom)
        got = _resampled(entry, log, call, k0, bank, geom, control=True) \
            if control else _program(out[:, :K], dev)
        gap.add(got, ref, ref.numel())
        del got, ref
    numbers = gap.numbers(count_mismatch(entry.counts, log, **geom))

    dec = _decimator(cfg, dev)
    seeds = pcm.track_seeds(cfg["tracks"], cfg["channels"])
    before = np.concatenate([[0], np.cumsum(entry.counts)])
    codes = clips = states = 0
    # the calls side by side as lanes, each from its own entering state
    # (the group form's periodic plan gives every window call one K)
    K = entry.counts[records[0][0]]
    ch = records[0][2].shape[0]
    x = torch.cat([r[2][:, :K].to(dev) for r in records]).T.contiguous()
    entered = [torch.cat([_values(r[5][0]).to(dev) for r in records])]
    entered += [torch.cat([r[5][k].to(dev) for r in records], dim=-1)
                for k in (1, 2, 3)]
    ov, clipped, left = dec.run(x, *entered)
    packed = dec.pack(ov)
    del x, ov
    after = {}
    for j, (call, _k0, _out, got, n_clip, _state) in enumerate(records):
        lanes = slice(j * ch, (j + 1) * ch)
        cols = slice(j * ch * dec.nbytes, (j + 1) * ch * dec.nbytes)
        codes += int((got[:K].to(dev) != packed[:, cols]).sum())
        clips += abs(int(n_clip) - int(clipped[:, lanes].sum()))
        after[call] = [t[..., lanes] for t in left]
    del packed, clipped
    for call, *_, (gens, fb, xh, yh) in records:
        gens = _values(gens)
        states += int((gens != _seeds_after(seeds, int(before[call]),
                                            dev)).sum())
        if call - 1 in after:
            for got, ref in zip((gens, fb, xh, yh), after[call - 1]):
                states += int((got != ref).sum())
    final = _values(entry.final_gens)
    states += int((final != _seeds_after(seeds, int(before[-1]),
                                         dev)).sum())
    numbers.update(code_mismatch=codes, clip_mismatch=clips,
                   state_mismatch=states)
    return numbers


def flat_packed(entry, records, log, control: bool) -> dict:
    """A fixed-ratio stream through the ditherless, unshaped quantizer;
    ``records`` are (call, first output index, packed container [C, >= K],
    clips int32 0-d)."""
    cfg, dev, tp = entry.cfg, entry.dev, entry.tp
    geom = _geometry(cfg)
    bank = phase_bank(geom["taps"], geom["L"], lowpass=lowpass_ratio(cfg),
                      device=dev)
    dec = pcm.Decimator(output_bits=tp["output_bits"],
                        output_bytes=tp["output_bytes"], output_gain=1.0,
                        sample_rate=cfg["destin_rate"])
    codes = clips = 0
    for call, k0, packed, n_clip in records:
        K = entry.counts[call]
        v = _resampled(entry, log, call, k0, bank, geom) * dec.scaler
        if control:
            tf = _resampled(entry, log, call, k0, bank, geom, control=True)
            got = torch.floor(tf * dec.scaler + 0.5).clamp(dec.lo, dec.hi)
            del tf
        else:
            got = dec.unpack(packed[:, :K].to(dev).contiguous()
                             .view(torch.uint8))
        # the unclamped codes of v moved TIE_LSB down and up: equal but
        # within TIE_LSB of a rounding boundary
        down = torch.floor(v + (0.5 - TIE_LSB))
        up = torch.floor(v + (0.5 + TIE_LSB))
        del v
        codes += int(((got != down.clamp(dec.lo, dec.hi))
                      & (got != up.clamp(dec.lo, dec.hi))).sum())
        least = int(((down > dec.hi) | (up < dec.lo)).sum())
        most = int(((up > dec.hi) | (down < dec.lo)).sum())
        clips += max(0, least - int(n_clip), int(n_clip) - most)
        del down, up, got
    return {"count_mismatch": count_mismatch(entry.counts, log, **geom),
            "code_mismatch": codes, "clip_mismatch": clips}
