"""``BatchedASRC`` (``parallel/asrc.py``) on art64's float64 path:
``batched_asrc``'s traffic with the engine built in float64, so each call
is one launch of the step kernel's float64 instance (K4).  The seed's
float32 noise pool is widened to float64 once, in set-up, and that pool is
what the engine takes and the log records, so no call casts its input.

Traffic keys: ``batched_asrc``'s."""

from __future__ import annotations

import numpy as np

from .. import checks_asrc_f64, traffic
from . import batched_asrc


class Entry(batched_asrc.Entry):
    def setup(self):
        from art_tpu_torch import BatchedASRC
        c, p = self.cfg, self.tp
        self.eng = BatchedASRC(
            c["streams"], c["num_taps"], c["num_filters"], dtype=np.float64,
            blackman_harris=c["blackman_harris"],
            hankel_kb=batched_asrc.HANKEL_KB,
            lowpass_ratio=c["lowpass_ratio"], kernel="auto",
            device=self.dev)
        self.eng.advance_position(c["advance"])
        self.n = p["call_frames"]
        pool = traffic.noise_pool(self.seed, p["pool"],
                                  (c["streams"], self.n), p["std"], self.dev)
        pool = [b.double() for b in pool]
        self.inputs = [x.cpu().numpy() for x in pool] if p["host_io"] \
            else pool
        self.log = traffic.StreamLog(pool)
        self.t0 = traffic.drift_origin(self.seed)
        e = self.eng
        # K4's shape; each window call adds its (capacity, valid outputs)
        self.roofline["asrc_step_f64"] = dict(
            streams=e.S, hist=e.num_samples, inputs=self.n,
            bank_rows=e.bank.shape[0], taps=e.num_taps, calls=[])

    def call(self):
        record = self._call()
        self.keeper.push(record)
        K = int(self.counts[-1].sum())
        self.roofline["asrc_step_f64"]["calls"].append(
            (record[1].shape[1], K))
        return K

    def check(self, control: bool) -> dict:
        return checks_asrc_f64.asrc_f64(self, self.keeper.records(),
                                        self.log, self.n, self.ratios_at,
                                        control)
