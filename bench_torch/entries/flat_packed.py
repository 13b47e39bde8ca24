"""``DeviceStreamResampler``'s packed group form on the device, as a file
converter delivering integer PCM runs it: the groups of ``flat_group``
(the first chunk through ``process()``, then ``group`` chunks a call from
a pool of ``pool`` device buffers), each through ``process_flat_packed``:
K1, then the ditherless, unshaped quantizer into little-endian
``output_bits``-bit codes in ``output_bytes``-byte containers (D1's
packed epilogue), full scale 2^(bits - 1), clipped at its bounds.  The
packed codes and each call's clip count stay on the device.

Traffic keys: those of ``flat_group``, ``output_bits``, ``output_bytes``."""

from __future__ import annotations

import torch

from .. import checks_pcm
from . import flat_group


def k1_shape(eng, inputs: int, Ks, K: int) -> dict:
    """K1's launch shape (``roofline/k1.py``) of a ``process_flat_out``
    group of ``inputs`` frames a channel that emitted ``Ks`` a chunk, K in
    all, as ``flat_group`` records it."""
    return dict(channels=eng.num_channels, hist=eng.num_samples,
                inputs=inputs, p_rows=eng.qn * eng.M, L=eng.L,
                blocks=len(Ks) * (int(Ks[0]) // eng.L), outputs=K,
                taps=eng.num_taps)


class Entry(flat_group.Entry):
    def setup(self):
        super().setup()
        bits = self.tp["output_bits"]
        self.quant = dict(scaler=float(1 << bits) / 2.0,
                          highclip=(1 << (bits - 1)) - 1,
                          lowclip=-(1 << (bits - 1)), output_bits=bits,
                          output_bytes=self.tp["output_bytes"])
        self.no_clips = torch.zeros((), dtype=torch.int32, device=self.dev)

    def _group(self):
        i = len(self.counts)
        index = i % len(self.pool)
        packed, Ks, clips = self.eng.process_flat_packed(
            self.pool[index], self.n, self.no_clips, **self.quant)
        K = int(Ks.sum())
        record = (i, self.k_total, packed, clips)
        self.log.add(index, 0, self.G * self.n)
        self.counts.append(K)
        self.k_total += K
        if "k1" not in self.roofline:
            self.roofline["k1"] = k1_shape(self.eng, self.G * self.n, Ks, K)
            self.roofline["d1"] = dict(samples=self.eng.num_channels * K,
                                       out_bytes=self.tp["output_bytes"])
        return record

    def check(self, control: bool) -> dict:
        return checks_pcm.flat_packed(self, self.keeper.records(), self.log,
                                      control)
