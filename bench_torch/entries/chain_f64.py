"""art's ``-p`` pre-filter into the fixed-ratio downsampler on the device,
in float64, as a post house's converter of multichannel programmes runs
it with the audio kept on the card: one ``DeviceBiquadCascade`` of the
configuration's sections, from a zero state, filters each call's group
buffer in one call (one launch a section); ``DeviceStreamResampler``
(float64) then takes the filtered buffer, the first chunk through
``process()``, then every call one ``process_flat_out`` group of
``group`` chunks of whole input periods (``chunk_target`` rounded to a
multiple of M).  The inputs are a pool of ``pool`` group buffers made on
the device (float32 noise widened to float64 once, in set-up), taken in
turn; the outputs stay on the device.

Traffic keys: ``chunk_target``, ``group``, ``pool``, ``std``,
``warmup_calls`` (groups after the first chunk)."""

from __future__ import annotations

import numpy as np

from .. import checks_chain, harness, traffic
from .flat_packed import k1_shape


class Entry(harness.Entry):
    def setup(self):
        from art_tpu_torch import DeviceStreamResampler
        from art_tpu_torch.core import flags
        from art_tpu_torch.engines import biquad
        from art_tpu_torch.ops.biquad_kernel import DeviceBiquadCascade
        c, p = self.cfg, self.tp
        pf = c["prefilter"]
        coeffs = getattr(biquad, pf["design"])(pf["frequency"])
        sections = [biquad.Biquad.init(coeffs, pf["gain"],
                                       channels=c["channels"],
                                       dtype=np.float64)
                    for _ in range(pf["sections"])]
        self.casc = DeviceBiquadCascade(*sections, combined=pf["combined"],
                                        device=self.dev)
        self.casc.push_from(*sections)
        self.eng = DeviceStreamResampler(
            c["channels"], c["num_taps"], c["max_filters"],
            c["source_rate"], c["destin_rate"], c["lowpass_freq"],
            sum(getattr(flags, name) for name in c["flags"]),
            dtype=np.float64, device=self.dev)
        self.eng.advance_position(c["advance"])
        self.n = traffic.m_multiple(p["chunk_target"], self.eng.M)
        self.G = p["group"]
        pool = traffic.noise_pool(self.seed, p["pool"],
                                  (c["channels"], self.G * self.n),
                                  p["std"], self.dev)
        self.pool = [b.double() for b in pool]
        del pool
        self.log = traffic.StreamLog(self.pool)
        self.k_total = 0

    def warmup(self):
        y = self.casc.process(self.pool[0][:, :self.n], self.n)
        _, K = self.eng.process(y, self.n)
        self.log.add(0, 0, self.n)
        self.counts.append(K)
        self.k_total += K
        for _ in range(self.tp["warmup_calls"]):
            self._group()

    def _group(self):
        i = len(self.counts)
        index = i % len(self.pool)
        x = self.pool[index]
        y = self.casc.process(x, x.shape[1])
        out, Ks = self.eng.process_flat_out(y, self.n)
        K = int(Ks.sum())
        record = (i, self.k_total, out)
        self.log.add(index, 0, x.shape[1])
        self.counts.append(K)
        self.k_total += K
        if "k1_f64" not in self.roofline:
            self.roofline["k1_f64"] = k1_shape(self.eng, x.shape[1], Ks, K)
            self.roofline["b1"] = dict(frames=x.shape[1],
                                       streams=x.shape[0])
        return record

    def call(self):
        record = self._group()
        self.keeper.push(record)
        return self.counts[-1]

    def release(self):
        del self.eng, self.casc

    def check(self, control: bool) -> dict:
        return checks_chain.chain(self, self.keeper.records(), self.log,
                                  control)
