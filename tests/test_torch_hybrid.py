"""The port's ``HybridStreamResampler`` against JAX's, on the CPU.

The same seeded blocks go through both engines: a first block (the
extrapolation prefill with ``EXTRAPOLATE_ENDPOINTS``, else the first steady
block), steady blocks through every entry point (interleaved, planar,
device-resident output), a dry-run query while the steady state sits on the
device engine, an undersized caller buffer, a mid-stream advance, an odd tail
block and the flush.  Counts, ``get_position`` and on-device residency match
exactly; samples stay within the float32 class (1e-5), one float32 ulp for
``precise=True``, 1e-12 for float64 data (the host edges run the same copied
host engine, so they agree bitwise).  A second test pins the state handoff:
``_pull`` undoes ``_push`` bitwise, and the device ring holds the host's
left-aligned history at its right end."""

import numpy as np
import pytest
import torch

from art_tpu.parallel.streams import HybridStreamResampler as JHybrid
from art_tpu_torch.core.flags import (BLACKMAN_HARRIS, EXTRAPOLATE_ENDPOINTS,
                                      INCLUDE_LOWPASS, SUBSAMPLE_INTERPOLATE)
from art_tpu_torch.parallel.streams import HybridStreamResampler as THybrid

IBL = SUBSAMPLE_INTERPOLATE | BLACKMAN_HARRIS | INCLUDE_LOWPASS
IB = SUBSAMPLE_INTERPOLATE | BLACKMAN_HARRIS

CASES = {
    # 44.1k->48k at 48 taps, reduced (380 filters carry the 160 phases)
    "reduced": ((2, 48, 380, 44100, 48000, 0, IBL), {}),
    # preset -1: 48 filters cannot carry 160 phases -> interpolated
    "interpolated": ((1, 48, 48, 44100, 48000, 0, IB), {}),
    # -x: the prefill and the extrapolated flush run on the host
    "extrapolated": ((2, 48, 380, 44100, 48000, 0,
                      IBL | EXTRAPOLATE_ENDPOINTS), {}),
    "precise": ((2, 48, 380, 44100, 48000, 0, IBL), {"precise": True}),
    "float64": ((2, 48, 380, 44100, 48000, 0, IBL),
                {"dtype": np.float64}),
}


def _check_samples(a, b, case):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    if not a.size:
        return
    if case == "precise":
        ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float32))
        assert (np.abs(a - b) <= ulp).all()
    else:
        tol = 1e-12 if a.dtype == np.float64 else 1e-5
        np.testing.assert_allclose(a, b, rtol=0, atol=tol)


@pytest.mark.parametrize("case", list(CASES))
def test_hybrid_matches_jax(case):
    ctor, opts = CASES[case]
    ch, taps = ctor[0], ctor[1]
    dtype = opts.get("dtype", np.float32)
    j = JHybrid(*ctor, **opts)
    t = THybrid(*ctor, **opts, device="cpu")
    rng = np.random.default_rng(20261017)

    def block(n):
        return (rng.standard_normal((n, ch)) * 0.5).astype(dtype)

    def same_state():
        assert t.get_position() == j.get_position()
        assert t._on_device == j._on_device

    def both(method, data, n, cap):
        rj = getattr(j, method)(data, n, cap)
        rt = getattr(t, method)(data, n, cap)
        assert (rt[1].input_used, rt[1].output_generated) == (
            rj[1].input_used, rj[1].output_generated)
        same_state()
        return rj, rt

    for eng in (j, t):
        eng.advance_position(taps // 2)
    same_state()
    (oj, _), (ot, _) = both("process_interleaved", block(1000), 1000, 4000)
    _check_samples(oj, ot, case)
    for _ in range(2):
        (oj, _), (ot, _) = both("process_interleaved", block(1000), 1000,
                                4000)
        _check_samples(oj, ot, case)
    assert t._on_device

    # planar entry point, then the device-resident one
    x = np.ascontiguousarray(block(1000).T)
    (oj, _), (ot, _) = both("process", x, 1000, 4000)
    _check_samples(oj, ot, case)
    rj, rt = both("process_interleaved_device", block(1000), 1000, 4000)
    assert rt[0] is None and isinstance(rt[2], torch.Tensor)
    assert rt[2].shape[0] == ch and rt[2].shape[1] >= rt[1].output_generated
    K = rt[1].output_generated
    _check_samples(np.asarray(rj[2])[:, :K], rt[2][:, :K].numpy(), case)

    # the dry run answers from the scalar state without leaving the device
    assert t.get_expected_output(1000) == j.get_expected_output(1000)
    assert t._on_device

    # an undersized caller buffer runs on the host before any state moves
    (oj, rj1), (ot, rt1) = both("process_interleaved", block(1000), 1000, 50)
    assert rt1.output_generated == 50 and rt1.input_used < 1000
    assert not t._on_device
    _check_samples(oj, ot, case)
    (oj, _), (ot, _) = both("process_interleaved", block(1000), 1000, 4000)
    _check_samples(oj, ot, case)
    assert t._on_device

    # a mid-stream advance reaches the live state
    for eng in (j, t):
        eng.advance_position(3)
    same_state()
    (oj, _), (ot, _) = both("process_interleaved", block(1000), 1000, 4000)
    _check_samples(oj, ot, case)

    # the odd tail block and the flush run on the host
    (oj, _), (ot, _) = both("process_and_flush_interleaved", block(777), 777,
                            4000)
    _check_samples(oj, ot, case)
    assert not t._on_device
    (oj, _), (ot, _) = both("process_interleaved", None, -1, 4000)
    assert ot.shape[0] == 0


def _states_equal(a, b):
    assert a.keys() == b.keys()
    assert a["history"].dtype == b["history"].dtype
    assert np.array_equal(a["history"].view(np.uint8),
                          b["history"].view(np.uint8))
    for k in ("output_offset", "input_index", "flags"):
        assert a[k] == b[k], k


def test_hybrid_handoff_round_trip():
    """_pull undoes _push bitwise, on a host state whose history past
    input_index holds old samples (a ring slide shrank it), and the device
    ring is the host history right-aligned, with the latch clear; after
    device steps, _pull then _push keep the ring's live columns (the last
    input_index, all a device step reads)."""
    h = THybrid(2, 48, 380, 44100, 48000, 0, IBL | EXTRAPOLATE_ENDPOINTS,
                device="cpu")
    h.advance_position(24)
    rng = np.random.default_rng(3)
    for n in (1000, 999, 37, 500, 100, 1000, 3):
        x = rng.standard_normal((n, 2)).astype(np.float32)
        h.process_interleaved(x, n, 4000)
    assert not h._on_device
    st0 = h.host.state_dict()
    ii, ns = st0["input_index"], h.dev.num_samples
    assert np.abs(st0["history"][:, ii:]).max() > 0
    h._push()
    ds = h.dev.state_dict()
    assert np.array_equal(ds["history"][:, ns - ii:], st0["history"][:, :ii])
    assert not ds["history"][:, :ns - ii].any()
    assert (ds["output_offset"], ds["input_index"], ds["flushed"]) == (
        st0["output_offset"], ii, False)
    assert h.get_position() == h.host.get_position()
    h._pull()
    _states_equal(h.host.state_dict(), st0)

    # and the device state survives _pull then _push after device steps
    for _ in range(3):
        x = rng.standard_normal((1000, 2)).astype(np.float32)
        h.process_interleaved_device(x, 1000, 4000)
    assert h._on_device
    d0 = h.dev.state_dict()
    h._pull()
    h._push()
    d1 = h.dev.state_dict()
    ii = d0["input_index"]
    assert np.array_equal(d0["history"][:, ns - ii:],
                          d1["history"][:, ns - ii:])
    assert (d0["output_offset"], d0["input_index"], d0["flushed"]) == (
        d1["output_offset"], d1["input_index"], d1["flushed"])
