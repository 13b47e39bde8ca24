"""The port's ``art`` and ``artest`` against JAX's, on the CPU.

- ``--backend=numpy``: the port's copies of the host layer give JAX's
  output bytes (``art``) and stats blocks (``artest``) exactly.
- ``--backend=cuda`` with ``device="cpu"`` (the kernels' plain versions)
  against JAX's ``--backend=device`` on CPU JAX: file lengths, clip
  warnings and every stats-line count exact; float32 samples within 1e-5;
  decimate-only bytes identical (the decimator's input is bit-identical);
  resample-then-decimate codes within the shaped-noise floor JAX's own
  device test uses (max <= 12 LSB, mean < 2); configurations the device
  engine cannot model (``--pitch``, an irrational ``-r``) byte-identical to
  the numpy backend; the ``-w5`` round-trip RMS within 0.5 dB of JAX's or
  below -125 dB.
- ``--backend=torch`` with ``device="cpu"`` (the host ``Resampler``'s
  kernels on their plain versions) against JAX's ``--backend=jax``: file
  lengths, clip warnings and every stats-line count exact; float32
  samples within 1e-5, float64 within 1e-12; resample-then-decimate codes
  within the shaped-noise floor; ``-w5`` as above.
- No silent fallback: without a card, or when the device engine or its
  kernel fails, ``--backend=cuda`` raises (the command exits non-zero) and
  writes no converted file; ``--backend=jax`` exits naming
  ``--backend=torch``, and ``--mesh`` its ROADMAP item.
"""

import io
import os
import re
import subprocess
import sys
from contextlib import redirect_stderr
from pathlib import Path

import numpy as np
import pytest
import torch

from art_tpu.cli import art as jart
from art_tpu.cli import artest as jartest
from art_tpu_torch.cli import art as tart
from art_tpu_torch.cli import artest as tartest
from art_tpu_torch.io import wavfile
from art_tpu_torch.ops import fixed_step as k1
from art_tpu_torch.parallel import streams

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def wav_in(tmp_path_factory):
    """1 s of 44.1k stereo float32 noise (std 0.4: some samples clip at 16
    bits, so clip counts are exercised)."""
    rng = np.random.default_rng(5)
    n = 44100
    x = (rng.standard_normal((n, 2)) * 0.4).astype("<f4")
    p = tmp_path_factory.mktemp("cli") / "in.wav"
    with open(p, "wb") as f:
        wavfile.write_wav_header(f, bits=32, num_channels=2, num_frames=n,
                                 sample_rate=44100, channel_mask=0x3)
        f.write(x.tobytes())
    return p


def _convert(main, backend, args, src, dst, **kw):
    buf = io.StringIO()
    with redirect_stderr(buf):
        rc = main(["-q", "-y", f"--backend={backend}", *args, str(src),
                   str(dst)], **kw)
    assert not rc, buf.getvalue()
    return dst.read_bytes(), buf.getvalue()


def _jax(backend, args, src, tmp_path):
    return _convert(jart.main, backend, args, src, tmp_path / "jax.wav")


def _port(backend, args, src, tmp_path):
    kw = {"device": "cpu"} if backend in ("cuda", "torch") else {}
    return _convert(tart.main, backend, args, src, tmp_path / "port.wav",
                    **kw)


def _data(wav: bytes) -> bytes:
    i = wav.index(b"data")
    return wav[i + 8:i + 8 + int.from_bytes(wav[i + 4:i + 8], "little")]


@pytest.mark.parametrize("args", [
    ["-r48k", "-o16"], ["-o16", "-n0"], ["-r48k", "-p"], ["-r22050", "-p"],
    ["--pitch=50"], ["-r48k", "-x"], ["-r48k", "-m"], ["-r48k", "--f64"],
    ["-r48k", "-o24", "-d1", "-n2"]], ids=" ".join)
def test_art_numpy_bytes_equal_jax(args, wav_in, tmp_path):
    a, ea = _jax("numpy", args, wav_in, tmp_path)
    b, eb = _port("numpy", args, wav_in, tmp_path)
    assert a == b and ea == eb


@pytest.mark.parametrize("args", [["-r48k"], ["-s10"], ["-r48k", "-x"],
                                  ["-r22050", "-p"]], ids=" ".join)
def test_art_cuda_float_samples_match_jax_device(args, wav_in, tmp_path):
    """Float output: samples within the float32 class of JAX's device
    path.  (-s10 is not a fallback: both device engines run its 1:1
    interpolated period.)"""
    a, ea = _jax("device", args, wav_in, tmp_path)
    b, eb = _port("cuda", args, wav_in, tmp_path)
    assert len(a) == len(b) and ea == eb and a[:44] == b[:44]
    da = np.frombuffer(_data(a), "<f4")
    db = np.frombuffer(_data(b), "<f4")
    assert np.abs(da - db).max() <= 1e-5


@pytest.mark.parametrize("args", [
    ["-r48k", "-o16"], ["-r48k", "-o16", "-n0", "-m"],
    ["-r48k", "-o16", "-n0", "-p"], ["-r22050", "-o16", "-n0", "-p"]],
    ids=" ".join)
def test_art_cuda_resample_decimate_within_noise_floor(args, wav_in,
                                                       tmp_path,
                                                       monkeypatch):
    """Resample then decimate: lengths and clip warnings exact, 16-bit
    codes within the shaped-noise floor of JAX's own device test.  The
    upsampling -p post filter runs on the device route in both
    (DeviceBiquadCascade between the resample and the decimate stage):
    here on its plain version, one cascade of two sections per steady
    block; the downsampling -p pre filter stays on the host."""
    from art_tpu_torch.ops import biquad_kernel as bk
    calls = []
    orig = bk.DeviceBiquadCascade.process

    def spy(self, dev_out, K):
        calls.append(K)
        return orig(self, dev_out, K)

    monkeypatch.setattr(bk.DeviceBiquadCascade, "process", spy)
    a, ea = _jax("device", args, wav_in, tmp_path)
    before = dict(bk.plain_calls)
    b, eb = _port("cuda", args, wav_in, tmp_path)
    assert len(a) == len(b) and ea == eb
    diff = np.abs(np.frombuffer(_data(a), "<i2").astype(np.int32)
                  - np.frombuffer(_data(b), "<i2").astype(np.int32))
    assert diff.max() <= 12 and diff.mean() < 2.0
    # 44,100 frames in 16,384-frame blocks: the prefill and the tail on
    # the host, one steady block on the device route
    steady = 44100 // tart.BUFFER_SAMPLES - 1
    post = args[0] == "-r48k" and "-p" in args
    assert len(calls) == (steady if post else 0)
    assert bk.plain_calls["biquad"] - before["biquad"] == 2 * len(calls)


@pytest.mark.parametrize("args", [
    ["-o16"], ["-o16", "-n0"], ["--pitch=50"], ["-r47999"],
    ["-r48k", "--f64", "-o16"]], ids=" ".join)
def test_art_cuda_bytes_equal_jax_device(args, wav_in, tmp_path):
    """Decimate only (no resampler), the configurations the device engine
    cannot model (host engine), and the float64 path: byte-identical to
    JAX's device backend; the fallback ones also to the port's numpy
    backend."""
    a, ea = _jax("device", args, wav_in, tmp_path)
    b, eb = _port("cuda", args, wav_in, tmp_path)
    assert a == b and ea == eb
    if args[0] in ("--pitch=50", "-r47999"):
        assert b == _port("numpy", args, wav_in, tmp_path)[0]


def _codes(wav: bytes):
    return np.frombuffer(_data(wav), "<i2").astype(np.int32)


@pytest.mark.parametrize("args", [
    ["-o16", "-n0"], ["-o16", "-n0", "-d1"], ["-o8", "-n0", "-d2"],
    ["-o24", "-n0", "-d0", "-g3"], ["-o16", "-n0", "-m"]], ids=" ".join)
def test_art_cuda_device_decimator_bytes_equal_numpy(args, wav_in,
                                                     tmp_path):
    """Decimate only, unshaped: the device decimator's input is the
    numpy backend's, so the bytes are identical (JAX's test_io_cli.py
    decimate-only check, on the port)."""
    a, ea = _port("numpy", args, wav_in, tmp_path)
    b, eb = _port("cuda", args, wav_in, tmp_path)
    assert a == b and ea == eb


def test_art_cuda_device_decimator_after_resample(wav_in, tmp_path):
    """-r48k -o16 -n0 -m: the device decimator on K1's steady blocks, its
    fetches drained by the write pool: lengths and clip warnings equal to
    the numpy backend's, codes within the floor of JAX's own test."""
    args = ["-r48k", "-o16", "-n0", "-m"]
    a, ea = _port("numpy", args, wav_in, tmp_path)
    b, eb = _port("cuda", args, wav_in, tmp_path)
    assert len(a) == len(b) and ea == eb and "clipped" in ea
    diff = np.abs(_codes(a) - _codes(b))
    assert diff.max() <= 12 and diff.mean() < 2.0


def _spy_device_decimator(monkeypatch):
    from art_tpu_torch.engines.decimator import DeviceDecimator
    rows = []
    orig = DeviceDecimator.process_chunk_async

    def spy(self, src, generated):
        rows.append((int(src.shape[0]), isinstance(src, torch.Tensor)))
        return orig(self, src, generated)

    monkeypatch.setattr(DeviceDecimator, "process_chunk_async", spy)
    return rows


def test_art_cuda_oversize_engine_chunk_is_sliced(monkeypatch, tmp_path):
    """JAX's test_cli_device_oversize_engine_chunk_single_shape on the
    port: an engine block longer than the CLI's decimator bucket
    (ceil(outcap/256)*256) holds invalid padding past it, which is sliced
    off.  JAX's -t16 -f1024 -r48k pads its block to 18432 rows; the port's
    K1 block is exactly nb = ceil(K/L) blocks (17920 rows there, inside the
    bucket), so the port's oversize case is -r32k: 12160 rows against a
    bucket of 12032.  Output at the floor of the numpy backend."""
    rng = np.random.default_rng(11)
    n = 44100
    x = (rng.standard_normal((n, 2)) * 0.4).astype("<f4")
    src = tmp_path / "in.wav"
    with open(src, "wb") as f:
        wavfile.write_wav_header(f, bits=32, num_channels=2, num_frames=n,
                                 sample_rate=44100, channel_mask=0x3)
        f.write(x.tobytes())
    rows = _spy_device_decimator(monkeypatch)
    args = ["-t16", "-f1024", "-r32k", "-o16", "-n0"]
    b, eb = _port("cuda", args, src, tmp_path)
    outcap = int((tart.BUFFER_SAMPLES + 8) * 32000 / 44100 + 100.0)
    bucket = -(-outcap // 256) * 256
    steady = [r for r, on_device in rows if on_device]
    assert bucket == 12032 and steady and set(steady) == {bucket}
    assert all(r <= bucket for r, _ in rows)
    a, ea = _port("numpy", args, src, tmp_path)
    assert len(a) == len(b) and ea == eb
    diff = np.abs(_codes(a) - _codes(b))
    assert diff.max() <= 12 and diff.mean() < 2.0


@pytest.mark.parametrize("args,runs", [
    (["-r48k", "-o16", "-n0"], True), (["-r48k", "-o16"], False),
    (["-r48k", "-o16", "-n0", "--f64"], False)],
    ids=["unshaped", "ATH shaping", "f64"])
def test_art_cuda_device_decimator_gate(args, runs, monkeypatch, wav_in,
                                        tmp_path):
    """JAX's gate: the device decimator runs for an unshaped float32
    integer output, not for the default ATH shaping or the float64 path."""
    rows = _spy_device_decimator(monkeypatch)
    _port("cuda", args, wav_in, tmp_path)
    assert bool(rows) == runs


_LINE = re.compile(r"(\w+) \(-w(\d)\): count =\s*(\d+), checksum = (\w+), "
                   r"range = ([-\d.]+) to ([-\d.]+), RMS = ([-\d.]+) dB")
_DEC = re.compile(r"decimate \(-w3\): count =\s*(\d+), checksum = (\w+), "
                  r"clipped samples = (\d+)")


def _artest(main, args, **kw):
    buf = io.StringIO()
    with redirect_stderr(buf):
        rc = main(args, **kw)
    assert rc == 0, buf.getvalue()
    text = buf.getvalue()
    out = {m.group(2): dict(count=int(m.group(3)), rms=float(m.group(7)),
                            raw=m.group(0))
           for m in _LINE.finditer(text)}
    m = _DEC.search(text)
    if m:
        out["3"] = dict(count=int(m.group(1)), clipped=int(m.group(3)))
    return out, text


@pytest.mark.parametrize("args", [
    ["-3", "-s44.1k", "-d48k", "-c2", "-n1", "-e", "-i", "-o16"],
    ["-2", "-s96k", "-d44.1k", "-c2", "-n1", "-e", "-i", "-o16", "-v", "-x"],
    ["-1", "-s44.1k", "-d48k", "-c1", "-n1", "-i", "-h3000"]], ids=" ".join)
def test_artest_numpy_equals_jax(args):
    """The whole stats block, checksums included, equals JAX's."""
    a = _artest(jartest.main, [*args, "--backend=numpy"])[1]
    b = _artest(tartest.main, [*args, "--backend=numpy"])[1]
    assert a == b


ARTEST_DEVICE = [
    # JAX's DEVICE_CONFIGS (tests/test_artest_matrix.py)
    ["-3", "-s44.1k", "-d48k", "-c2", "-n2", "-e", "-i"],
    ["-1", "-s44.1k", "-d48k", "-c1", "-n2", "-e", "-i"],
    ["-2", "-s96k", "-d44.1k", "-c2", "-n2", "-e", "-i", "-o16", "-v", "-x"],
    ["-1", "-s44.1k", "-d48k", "-c2", "-n2", "-i"],
    ["-1", "-s44.1k", "-d48k", "-c1", "-n2", "-i", "-o16", "-v"],
    # the precision tier and the float64 data path
    ["-3", "-s44.1k", "-d48k", "-c2", "-n2", "-e", "-i", "--precise"],
    ["-3", "-s44.1k", "-d48k", "-c2", "-n2", "-e", "-i", "--f64"],
]


@pytest.mark.parametrize("args", ARTEST_DEVICE, ids=" ".join)
def test_artest_cuda_matches_jax_device(args):
    ref, _ = _artest(jartest.main, [*args, "--backend=device"])
    got, _ = _artest(tartest.main, [*args, "--backend=cuda"], device="cpu")
    assert set(ref) == set(got)
    assert got["1"]["raw"] == ref["1"]["raw"]          # input bit-identical
    for key in ref:
        assert got[key]["count"] == ref[key]["count"], key
        if "clipped" in ref[key]:
            assert got[key]["clipped"] == ref[key]["clipped"]
    assert got["5"]["rms"] < -125.0 or abs(got["5"]["rms"]
                                           - ref["5"]["rms"]) <= 0.5


def test_artest_profile_writes_a_torch_trace(tmp_path):
    args = ["-3", "-s44.1k", "-d48k", "-c1", "-n1", "-e", "--backend=cuda",
            f"--profile={tmp_path / 'trace'}"]
    _, text = _artest(tartest.main, args, device="cpu")
    assert f"profiler trace written to {tmp_path / 'trace'}" in text
    assert list((tmp_path / "trace").glob("*.json"))


# ----------------------------------------------------- no silent fallback
def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _fail_build(monkeypatch):
    def prewarm(self):
        raise RuntimeError("kernel build failed")
    monkeypatch.setattr(streams.DeviceStreamResampler, "prewarm", prewarm)


def _fail_launch(monkeypatch):
    def fixed_step(*args, **kwargs):
        raise RuntimeError("kernel launch failed")
    monkeypatch.setattr(k1, "fixed_step", fixed_step)


@pytest.mark.parametrize("fault", [_no_card, _fail_build, _fail_launch],
                         ids=["no card", "prewarm fails", "launch fails"])
def test_art_cuda_failure_propagates(fault, monkeypatch, wav_in, tmp_path):
    fault(monkeypatch)
    dst = tmp_path / "out.wav"
    kw = {} if fault is _no_card else {"device": "cpu"}
    with pytest.raises(RuntimeError):
        tart.main(["-q", "--backend=cuda", "-r48k", "-o16", str(wav_in),
                   str(dst)], **kw)
    # the engine is built before the output file is opened; a failed
    # launch leaves at most the header and the blocks before it, never a
    # converted file: the command exits non-zero
    if fault is not _fail_launch:
        assert not dst.exists()


@pytest.mark.parametrize("multi", [False, True], ids=["", "-m"])
def test_art_cuda_decimate_failure_propagates(multi, monkeypatch, wav_in,
                                              tmp_path):
    """A failed decimate kernel build or launch ends the command with its
    error, also when the fetches run on the write pool."""
    from art_tpu_torch.ops import decimate_device as dd

    def decimate_flat(*args, **kwargs):
        raise RuntimeError("decimate kernel launch failed")
    monkeypatch.setattr(dd, "decimate_flat", decimate_flat)
    with pytest.raises(RuntimeError, match="decimate kernel"):
        tart.main(["-q", "-y", "--backend=cuda", "-r48k", "-o16", "-n0",
                   *(["-m"] if multi else []), str(wav_in),
                   str(tmp_path / "out.wav")], device="cpu")


def test_artest_cuda_failure_propagates(monkeypatch):
    _no_card(monkeypatch)
    for args in (["-3", "-e"], ["-1"]):
        with pytest.raises(RuntimeError):
            tartest.main([*args, "-s44.1k", "-d48k", "-n1",
                          "--backend=cuda"])


def test_art_command_exits_nonzero_without_a_card(wav_in, tmp_path):
    dst = tmp_path / "out.wav"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "art_tpu_torch.cli.art", "-q",
                        "--backend=cuda", "-r48k", str(wav_in), str(dst)],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0 and "RuntimeError" in r.stderr
    assert not dst.exists()


@pytest.mark.parametrize("main,args,named", [
    (tart.main, ["--backend=jax", "a.wav", "b.wav"], "--backend=torch"),
    (tart.main, ["--mesh=4", "a.wav", "b.wav"], "item 11"),
    (tartest.main, ["--backend=jax", "-s44.1k", "-d48k"], "--backend=torch")],
    ids=["art jax", "art mesh", "artest jax"])
def test_refused_backends_name_their_roadmap_item(main, args, named):
    """--mesh names the ROADMAP item that ports it; --backend=jax, whose
    place --backend=torch takes, names that."""
    with pytest.raises(SystemExit) as exc:
        main(args)
    assert named in str(exc.value)


@pytest.mark.parametrize("args", [
    ["-r48k"], ["-r47999"], ["-r48k", "--f64"],
    ["-r22050", "-p"], ["-r48k", "-o16"]], ids=" ".join)
def test_art_torch_matches_jax_jax(args, wav_in, tmp_path, monkeypatch):
    """--backend=torch against JAX's --backend=jax: -r48k reduces (the
    polyphase path, K1), -r47999 interpolates and -r22050
    -p runs the allpass-free downsampler with its pre filter (the apply,
    K5); lengths, headers and clip warnings exact, samples within the
    float32 class (float64 within 1e-12), 16-bit codes within the
    shaped-noise floor.  Each resampler call goes to the branch JAX's
    goes to."""
    from art_tpu.engines.resampler import Resampler as JResampler
    from art_tpu_torch.engines.resampler import Resampler as TResampler
    branches = {}

    def spy(cls, key):
        orig = cls._compute

        def compute(self, L, plan, ratio):
            poly = self._polyphase() if not self.interpolation_used() \
                else None
            hit = bool(plan.output_generated and poly is not None
                       and poly.eligible(plan.first_position,
                                         plan.output_generated))
            branches.setdefault(key, []).append(hit)
            return orig(self, L, plan, ratio)
        monkeypatch.setattr(cls, "_compute", compute)

    spy(JResampler, "jax")
    spy(TResampler, "torch")
    a, ea = _jax("jax", args, wav_in, tmp_path)
    b, eb = _port("torch", args, wav_in, tmp_path)
    assert len(a) == len(b) and ea == eb and a[:44] == b[:44]
    assert branches["jax"] == branches["torch"]
    assert any(branches["torch"]) == (args[0] == "-r48k")
    if "-o16" in args:
        diff = np.abs(_codes(a) - _codes(b))
        assert diff.max() <= 12 and diff.mean() < 2.0
    else:
        da = np.frombuffer(_data(a), "<f4").astype(np.float64)
        db = np.frombuffer(_data(b), "<f4").astype(np.float64)
        assert np.abs(da - db).max() <= 1e-5


ARTEST_TORCH = [
    ["-3", "-s44.1k", "-d48k", "-c2", "-n1", "-e", "-i"],
    ["-1", "-s44.1k", "-d48k", "-c2", "-n1", "-i", "-o16"],
    ["-3", "-s44.1k", "-d48k", "-c2", "-n1", "-e", "-i", "--f64"],
]


@pytest.mark.parametrize("args", ARTEST_TORCH, ids=" ".join)
def test_artest_torch_matches_jax_jax(args):
    """artest --backend=torch against JAX's --backend=jax: every stats-line
    count and the clip total exact, the input stream bit-identical, -w5
    within 0.5 dB of JAX's or below -125 dB."""
    ref, _ = _artest(jartest.main, [*args, "--backend=jax"])
    got, _ = _artest(tartest.main, [*args, "--backend=torch"], device="cpu")
    assert set(ref) == set(got)
    assert got["1"]["raw"] == ref["1"]["raw"]
    for key in ref:
        assert got[key]["count"] == ref[key]["count"], key
        if "clipped" in ref[key]:
            assert got[key]["clipped"] == ref[key]["clipped"]
    assert got["5"]["rms"] < -125.0 or abs(got["5"]["rms"]
                                           - ref["5"]["rms"]) <= 0.5
