"""``DeviceStreamResampler``'s delivering group form on the device, as a
file or batch converter runs it: the first chunk through ``process()``,
then every call one ``process_flat_out`` group of ``group`` chunks of
whole input periods (``chunk_target`` rounded to a multiple of M).  The
inputs are a pool of ``pool`` group buffers made on the device, taken in
turn; the outputs stay on the device.

Traffic keys: ``chunk_target``, ``group``, ``pool``, ``std``,
``warmup_calls`` (groups after the first chunk)."""

from __future__ import annotations

from .. import checks, harness, traffic


class Entry(harness.Entry):
    def setup(self):
        from art_tpu_torch import DeviceStreamResampler
        from art_tpu_torch.core import flags
        c, p = self.cfg, self.tp
        self.eng = DeviceStreamResampler(
            c["channels"], c["num_taps"], c["max_filters"],
            c["source_rate"], c["destin_rate"], c["lowpass_freq"],
            sum(getattr(flags, name) for name in c["flags"]),
            device=self.dev)
        self.eng.advance_position(c["advance"])
        self.n = traffic.m_multiple(p["chunk_target"], self.eng.M)
        self.G = p["group"]
        self.pool = traffic.noise_pool(self.seed, p["pool"],
                                       (c["channels"], self.G * self.n),
                                       p["std"], self.dev)
        self.log = traffic.StreamLog(self.pool)
        self.k_total = 0

    def warmup(self):
        _, K = self.eng.process(self.pool[0][:, :self.n], self.n)
        self.log.add(0, 0, self.n)
        self.counts.append(K)
        self.k_total += K
        for _ in range(self.tp["warmup_calls"]):
            self._group()

    def _group(self):
        i = len(self.counts)
        index = i % len(self.pool)
        out, Ks = self.eng.process_flat_out(self.pool[index], self.n)
        K = int(Ks.sum())
        record = (i, self.k_total, out)
        self.log.add(index, 0, self.G * self.n)
        self.counts.append(K)
        self.k_total += K
        if "k1" not in self.roofline:
            e = self.eng
            nb = int(Ks[0]) // e.L
            self.roofline["k1"] = dict(
                channels=e.num_channels, hist=e.num_samples,
                inputs=self.G * self.n, p_rows=e.qn * e.M, L=e.L,
                blocks=self.G * nb, outputs=K, taps=e.num_taps)
        return record

    def call(self):
        record = self._group()
        self.keeper.push(record)
        return self.counts[-1]

    def release(self):
        del self.eng

    def check(self, control: bool) -> dict:
        return checks.fixed_ratio(self, self.keeper.records(), self.log,
                                  control)
