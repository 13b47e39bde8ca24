"""The comparison that decides ``correct`` for the float64 chain cell
(``entries/chain_f64.py``: art's ``-p`` pre-filter, then the fixed-ratio
downsampler).

Computed on the run's device once the program's state is freed, from the
configuration, the seed's inputs and the plain references: the cascade
(``reference/biquad.py``, its impulse response applied as a causal FIR
from the stream's start), then ``reference/fixed_ratio.py`` with the
reference's own lowpass for downsampling (``checks_pcm.lowpass_ratio``):

- ``count_mismatch``: calls whose outputs differ in number from the
  reference's, over every call from the stream's start (as
  ``checks.fixed_ratio`` counts them); exact.
- ``sample_err``: over the kept calls (the window's last two and a
  seed-drawn pair, so the filter and resampler state carried between
  calls is compared too), the largest gap between an output of the
  program and the float64 reference chain's, over the reference outputs'
  RMS.

With ``control`` the same reference chain computed in float32 (impulse
response, FIR, phase bank and dots; TF32 off), the precision below the
configuration's float64, takes the program's place in ``sample_err``, at
the program's positions and counts, so the run has to come out not
correct.
"""

from __future__ import annotations

import torch

from .checks import _Gap, _program
from .checks_pcm import _geometry, count_mismatch, lowpass_ratio
from .reference import biquad as biquad_ref
from .reference import fixed_ratio as fixed_ref
from .reference.bank import phase_bank


def sections(cfg) -> list:
    """The pre-filter's sections as ``reference/biquad.py`` takes them."""
    pf = cfg["prefilter"]
    return [biquad_ref.lowpass(pf["frequency"], pf["gain"])] * \
        pf["sections"]


def _outputs(log, k0: int, K: int, h, bank, geom, dev) -> torch.Tensor:
    """[C, K] of the reference chain in h's type: outputs k0..k0+K-1."""
    a, b = fixed_ref.window_span(k0, k0 + K, **geom)
    raw = log.segment(a - h.shape[0], b, dev, dtype=h.dtype)
    seg = biquad_ref.apply(raw, h)
    del raw
    return fixed_ref.outputs(seg, a, k0, k0 + K, L=geom["L"], M=geom["M"],
                             bank=bank)


def chain(entry, records, log, control: bool) -> dict:
    """``records`` are (call, first output index, outputs [C, >= K]) and
    ``entry.counts`` each call's outputs."""
    cfg, dev = entry.cfg, entry.dev
    geom = _geometry(cfg)
    h = biquad_ref.impulse(sections(cfg), dtype=torch.float64, device=dev)
    bank = phase_bank(geom["taps"], geom["L"], lowpass=lowpass_ratio(cfg),
                      device=dev)
    if control:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        h_c = biquad_ref.impulse(sections(cfg), dtype=torch.float32,
                                 device=dev)
        bank_c = bank.float()
    gap = _Gap()
    for call, k0, out in records:
        K = entry.counts[call]
        ref = _outputs(log, k0, K, h, bank, geom, dev)
        got = _outputs(log, k0, K, h_c, bank_c, geom, dev).double() \
            if control else _program(out[:, :K], dev)
        gap.add(got, ref, ref.numel())
        del got, ref
    return gap.numbers(count_mismatch(entry.counts, log, **geom))
