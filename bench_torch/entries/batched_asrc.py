"""``BatchedASRC`` (``parallel/asrc.py``): ``streams`` drifting-ratio
streams, each call ``call_frames`` frames a stream at the configuration's
per-call drift.  With ``host_io`` the inputs go up from host buffers and
the outputs and counts come back to the host every call, one caller
waiting for each (a live server's period); without it the inputs and
outputs stay on the device.  The inputs are a pool of ``pool`` buffers
made from the seed, taken in turn.

Traffic keys: ``call_frames``, ``pool``, ``std``, ``host_io``,
``warmup_calls``."""

from __future__ import annotations

import numpy as np

from .. import checks, harness, traffic

# the output capacity's bucket, as the repo's config-5 benchmarks have run
# the engine (bench.py:355, chip_smoke.py:1266-1267): each call's output
# width is a multiple of it
HANKEL_KB = 256


class Entry(harness.Entry):
    def setup(self):
        from art_tpu_torch import BatchedASRC
        c, p = self.cfg, self.tp
        self.eng = BatchedASRC(
            c["streams"], c["num_taps"], c["num_filters"], dtype=np.float32,
            blackman_harris=c["blackman_harris"], hankel_kb=HANKEL_KB,
            lowpass_ratio=c["lowpass_ratio"],
            device=self.dev)
        self.eng.advance_position(c["advance"])
        self.n = p["call_frames"]
        pool = traffic.noise_pool(self.seed, p["pool"],
                                  (c["streams"], self.n), p["std"], self.dev)
        self.inputs = [x.cpu().numpy() for x in pool] if p["host_io"] \
            else pool
        self.log = traffic.StreamLog(pool)
        self.t0 = traffic.drift_origin(self.seed)
        e = self.eng
        # K2's shape; each window call adds its (capacity, valid outputs)
        self.roofline["asrc_step"] = dict(
            streams=e.S, hist=e.num_samples, inputs=self.n,
            bank_rows=e.bank.shape[0], taps=e.num_taps, calls=[])

    def ratios_at(self, call: int) -> np.ndarray:
        return traffic.drift(self.cfg["streams"], self.t0 + call,
                             **self.cfg["drift"])

    def warmup(self):
        for _ in range(self.tp["warmup_calls"]):
            self._call()

    def _call(self):
        i = len(self.counts)
        index = i % len(self.inputs)
        out, Ks = self.eng.process(self.inputs[index], self.ratios_at(i))
        if self.tp["host_io"]:
            out = out.cpu()
        self.log.add(index, 0, self.n)
        self.counts.append(Ks.copy())
        return i, out

    def call(self):
        record = self._call()
        self.keeper.push(record)
        K = int(self.counts[-1].sum())
        self.roofline["asrc_step"]["calls"].append((record[1].shape[1], K))
        return K

    def release(self):
        del self.eng

    def check(self, control: bool) -> dict:
        return checks.asrc(self, self.keeper.records(), self.log, self.n,
                           self.ratios_at, control)
