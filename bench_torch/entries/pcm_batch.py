"""Batch delivery of integer PCM on the device: ``tracks`` files of
``channels`` channels as the channels of one ``DeviceStreamResampler``,
each call one ``process_flat_out`` group of ``group`` chunks of whole
input periods (``chunk_target`` rounded to a multiple of M), its output
read in place as [frames, channels] by one ``DeviceDecimator`` seeded as a
decimator a file (``tracks=``).  The first chunk goes through
``process()`` and the decimator too.  The inputs are a pool of ``pool``
group buffers made on the device, taken in turn; the packed bytes and the
clip count stay on the device.

A call's frames are its outputs a channel times ``tracks`` (a file's
frame counts once).  Each call's record keeps the float block, the packed
bytes, the clip count and the decimator state tensors that entered the
call (the decimator replaces them each call, so references suffice).

Traffic keys: ``chunk_target``, ``group``, ``pool``, ``std``,
``warmup_calls`` (groups after the first chunk)."""

from __future__ import annotations

from .. import checks_pcm, harness, traffic
from .flat_packed import k1_shape


class Entry(harness.Entry):
    def setup(self):
        from art_tpu_torch import DeviceStreamResampler
        from art_tpu_torch.core import flags
        from art_tpu_torch.engines.decimator import DeviceDecimator
        c, p = self.cfg, self.tp
        self.tracks = c["tracks"]
        ch = c["tracks"] * c["channels"]
        self.eng = DeviceStreamResampler(
            ch, c["num_taps"], c["max_filters"], c["source_rate"],
            c["destin_rate"], c["lowpass_freq"],
            sum(getattr(flags, name) for name in c["flags"]),
            device=self.dev)
        self.eng.advance_position(c["advance"])
        self.dec = DeviceDecimator(
            ch, c["output_bits"], c["output_bytes"], c["output_gain"],
            c["destin_rate"],
            sum(getattr(flags, name) for name in c["decimator_flags"]),
            tracks=self.tracks, device=self.dev)
        self.n = traffic.m_multiple(p["chunk_target"], self.eng.M)
        self.G = p["group"]
        self.pool = traffic.noise_pool(self.seed, p["pool"],
                                       (ch, self.G * self.n), p["std"],
                                       self.dev)
        self.log = traffic.StreamLog(self.pool)
        self.k_total = 0

    def _decimate(self, out, K: int):
        """(packed, clips, the state that entered) of out [ch, >= K]."""
        d = self.dec
        entered = (d.gens, d.fb, d.xh, d.yh)
        packed, clips = d.process_chunk_async(out.T, K)
        return packed, clips, entered

    def warmup(self):
        out, K = self.eng.process(self.pool[0][:, :self.n], self.n)
        self._decimate(out, K)
        self.log.add(0, 0, self.n)
        self.counts.append(K)
        self.k_total += K
        for _ in range(self.tp["warmup_calls"]):
            self._call()

    def _call(self):
        i = len(self.counts)
        index = i % len(self.pool)
        out, Ks = self.eng.process_flat_out(self.pool[index], self.n)
        K = int(Ks.sum())
        record = (i, self.k_total, out, *self._decimate(out, K))
        self.log.add(index, 0, self.G * self.n)
        self.counts.append(K)
        self.k_total += K
        if "k1" not in self.roofline:
            self.roofline["k1"] = k1_shape(self.eng, self.G * self.n, Ks, K)
            self.roofline["d2"] = dict(frames=out.shape[1],
                                       channels=self.eng.num_channels,
                                       quantized=K)
        return record

    def call(self):
        self.keeper.push(self._call())
        return self.counts[-1] * self.tracks

    def release(self):
        self.final_gens = self.dec.gens
        del self.eng, self.dec

    def check(self, control: bool) -> dict:
        return checks_pcm.pcm_batch(self, self.keeper.records(), self.log,
                                    control)
