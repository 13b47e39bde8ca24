"""ART — Audio Resampling Tool (CLI).

Command-line-compatible port of the reference `art` tool (reference
art.c): same options (presets -1..-4, -r/-g/-s/-l/-f/-t/-o/-d/-n/-a/-b/-h/
-m/-e/-p/-q/-v/-x/-y, --pitch/--tempo/--duration), same pipeline
(stretch -> pre-biquad -> resample -> post-biquad -> decimate), same WAV
behaviors.  The numeric width switch is `-o64`-style output plus `--f64`
for the full 64-bit data path (the reference's ART64 build).

The compute backend defaults to host numpy (bit-careful parity path); pass
`--backend=torch` to run the per-call resampling kernels on an NVIDIA card,
or `--backend=cuda` to stream fixed-ratio conversions through the
device-resident chunk engine (parallel/streams.py, kernel K1) with host
edges.

A copy of ``art_tpu/cli/art.py`` for the PyTorch port, run as ``python -m
art_tpu_torch.cli.art``.  It differs in its backends: ``--backend=cuda``
takes the place of ``--backend=device``: the resample stage's steady
blocks run on the card and, for an integer output without noise shaping,
the decimate stage too (``DeviceDecimator``, JAX's gate), with an
upsampling ``-p`` post filter between them (``DeviceBiquadCascade``).
``--backend=torch`` takes the place of ``--backend=jax``: the host
``Resampler(backend="torch")`` (its polyphase calls on K1, the others on
the ASRC apply kernel), with the decimator native and the filters and the
stretcher on the host, as JAX's does.  ``--backend=jax`` exits naming
``--backend=torch``, and ``--mesh`` naming the ROADMAP item that ports it
(11).  ``main(argv, device=...)`` names the torch device of the cuda and
torch backends: the command line always runs on the card, and tests pass
``device="cpu"``.  Only a configuration the device engine cannot
model (its ``ValueError``) runs on the host engine instead; a missing card
or a kernel that fails to build or launch ends the command with an error.
"""

from __future__ import annotations

import math
import os
import sys

import numpy as np

from .._roadmap import _not_ported
from ..core.flags import (BLACKMAN_HARRIS, DECIMATE_MULTITHREADED,
                          DITHER_FLAT, DITHER_HIGHPASS, DITHER_LOWPASS,
                          EXTRAPOLATE_ENDPOINTS, INCLUDE_LOWPASS,
                          NO_FILTER_REDUCTION, PRESETS,
                          RESAMPLE_MULTITHREADED, SHAPING_1ST_ORDER,
                          SHAPING_2ND_ORDER, SHAPING_3RD_ORDER,
                          SHAPING_ATH_CURVE, SHAPING_ENABLED,
                          STRETCH_DUAL_FLAG, SUBSAMPLE_INTERPOLATE)
from ..engines.biquad import Biquad, apply_cascade, biquad_lowpass
from ..engines.decimator import Decimator, DeviceDecimator
from ..engines.resampler import Resampler
from ..engines.stretch import Stretcher
from ..io import wavfile
from ._common import num_suffix, strtod, strtol


VERSION = 0.7
BUFFER_SAMPLES = 16384

USAGE = """
 Usage:     ART [-options] infile.wav outfile.wav

 Options:  -1|2|3|4    = quality presets, default = 3
           -r<Hz>      = resample to specified rate in Hz ('k' for kHz)
           -g<dB>      = apply gain (default = 0 dB)
           -s<degrees> = add specified phase shift (+/-360 degrees)
           -l<Hz>      = specify alternate lowpass frequency in Hz
           -f<num>     = number of sinc filters (1-1024)
           -t<num>     = number of sinc taps (4-1024, multiples of 4)
           -o<bits>    = output bitdepth (4-24, 32, or 64 with --f64)
           -d<sel>     = dither override: 0=none 1=flat 2=LP (default HP)
           -n<sel>     = noise-shaping override: 0-3 (default ATH)
           -a          = allpass sinc (no lowpass, even downsampling)
           -b          = Blackman-Harris windowing (best stopband)
           -h          = Hann windowing (fastest transition)
           -m          = accepted for compatibility (XLA schedules channels)
           -e          = accepted for compatibility (convolution already
                         accumulates at double precision here)
           -p          = pre/post filtering (cascaded biquads)
           -q          = quiet mode   -v = verbose
           -x          = do NOT extrapolate audio samples at endpoints
           -y          = overwrite outfile if it exists
           --pitch=<cents>   --tempo=<ratio>
           --duration=<[+|-][[hh:]mm:]ss.ss>
           --f64       = 64-bit float data path (the reference's ART64)
           --backend=<numpy|torch|cuda>  (torch = the resampler's
                       per-call kernels on the NVIDIA card; cuda =
                       fixed-ratio steady state of the resample stage on
                       the card, host edges; unshaped integer output
                       quantized and the upsampling -p post filter run on
                       the card too; falls back to numpy when the config
                       cannot reduce)
"""


class Options:
    def __init__(self):
        self.num_taps = 380
        self.num_filters = 380
        self.outbits = 0
        self.verbosity = 0
        self.pre_post_filter = False
        self.allpass = False
        self.dither = DITHER_HIGHPASS
        self.noise_shaping = SHAPING_ATH_CURVE
        self.extrapolation = True
        self.extended_math = False
        self.multithreaded = False
        self.pitch_ratio = 1.0
        self.tempo_ratio = 1.0
        self.resample_rate = 0
        self.lowpass_freq = 0
        self.phase_shift = 0.0
        self.gain = 1.0
        self.bh4_window = False
        self.hann_window = False
        self.overwrite = False
        self.duration = None           # (is_relative, seconds)
        self.dtype = np.float32
        self.backend = "numpy"
        self.infile = None
        self.outfile = None


def parse_time_spec(src: str):
    """[+|-][[hh:]mm:]ss.ss (reference art.c:400-430)."""
    rel = 0
    if src[:1] in "+-":
        rel = 1 if src[0] == "+" else -1
        src = src[1:]
    parts = src.split(":")
    if len(parts) > 3 or not src:
        return None
    value = 0.0
    try:
        for i, p in enumerate(parts):
            v = float(p) if p else 0.0
            if v < 0.0 or (i > 0 and v >= 60.0):
                return None
            if i < len(parts) - 1 and v != math.floor(v):
                return None
            value = value * 60.0 + v
    except ValueError:
        return None
    return rel, value


def parse_args(argv, opt: Options):
    i = 0
    while i < len(argv):
        arg = argv[i]
        i += 1
        if arg.startswith("--"):
            name, _, val = arg[2:].partition("=")
            if name == "pitch":
                cents = strtod(val)
                if not -2400 <= cents <= 2400:
                    raise SystemExit("invalid pitch shift, must be +/- 2400 "
                                     "cents (2 octaves)!")
                opt.pitch_ratio = 2.0 ** (cents / 1200.0)
            elif name == "tempo":
                opt.tempo_ratio = strtod(val)
                if not 0.25 <= opt.tempo_ratio <= 4.0:
                    raise SystemExit("invalid tempo, must be 0.25 to 4.0!")
            elif name == "duration":
                opt.duration = parse_time_spec(val)
                if opt.duration is None:
                    raise SystemExit("invalid --duration parameter!")
            elif name == "f64":
                opt.dtype = np.float64
            elif name == "backend":
                if val == "jax":
                    raise SystemExit("--backend=jax is the JAX package's; "
                                     "this port runs it as --backend=torch!")
                if val not in ("numpy", "torch", "cuda"):
                    raise SystemExit("--backend must be numpy, torch or "
                                     "cuda!")
                opt.backend = val
            elif name == "mesh":
                raise SystemExit(str(_not_ported("--mesh", 11)))
            else:
                raise SystemExit(f"unknown option: {name} !")
        elif arg.startswith("-") and len(arg) > 1:
            j = 1
            while j < len(arg):
                c = arg[j]
                rest = arg[j + 1:]

                def take_num():
                    nonlocal j
                    k = 0
                    while k < len(rest) and (rest[k].isdigit()
                                             or rest[k] in ".+-kK"):
                        k += 1
                    j += k
                    return rest[:k]

                cl = c.lower()
                if c in "1234":
                    opt.num_filters, opt.num_taps = PRESETS[int(c)]
                elif cl == "a":
                    opt.allpass = True
                elif cl == "m":
                    opt.multithreaded = True
                elif cl == "p":
                    opt.pre_post_filter = True
                elif cl == "q":
                    opt.verbosity = -1
                elif cl == "v":
                    opt.verbosity = 1
                elif cl == "e":
                    opt.extended_math = True
                elif cl == "x":
                    opt.extrapolation = False
                elif cl == "y":
                    opt.overwrite = True
                elif cl == "r":
                    opt.resample_rate = int(num_suffix(take_num()))
                elif cl == "d":
                    sel = strtol(take_num())
                    opt.dither = {0: 0, 1: DITHER_FLAT,
                                  2: DITHER_LOWPASS}.get(sel)
                    if opt.dither is None:
                        raise SystemExit("dither override must be 0, 1, "
                                         "or 2!")
                elif cl == "n":
                    sel = strtol(take_num())
                    opt.noise_shaping = {
                        0: 0, 1: SHAPING_1ST_ORDER, 2: SHAPING_2ND_ORDER,
                        3: SHAPING_3RD_ORDER}.get(sel)
                    if opt.noise_shaping is None:
                        raise SystemExit("noise-shaping override must be "
                                         "0, 1, 2, or 3!")
                elif cl == "s":
                    opt.phase_shift = strtod(take_num()) / 360.0
                    if not -1.0 < opt.phase_shift < 1.0:
                        raise SystemExit("phase shift must be less than "
                                         "+/- 1 sample!")
                elif cl == "g":
                    opt.gain = 10.0 ** (strtod(take_num()) / 20.0)
                elif cl == "l":
                    opt.lowpass_freq = int(num_suffix(take_num()))
                elif cl == "f":
                    opt.num_filters = strtol(take_num())
                    if not 1 <= opt.num_filters <= 1024:
                        raise SystemExit("num of filters must be 1 - 1024!")
                elif cl == "o":
                    opt.outbits = strtol(take_num())
                    if opt.outbits == 64:
                        opt.dtype = np.float64  # -o64 implies the f64 path
                    elif opt.outbits != 32 and not 4 <= opt.outbits <= 24:
                        raise SystemExit("outbits must be 4 - 24 (integer) "
                                         "or 32/64 (float)!")
                elif cl == "t":
                    opt.num_taps = strtol(take_num())
                    if (opt.num_taps & 3) or not 4 <= opt.num_taps <= 1024:
                        raise SystemExit("num of taps must be 4 - 1024 and "
                                         "a multiple of 4!")
                elif cl == "b":
                    opt.bh4_window = True
                elif cl == "h":
                    opt.hann_window = True
                else:
                    raise SystemExit(f"illegal option: {c} !")
                j += 1
        elif opt.infile is None:
            opt.infile = arg
        elif opt.outfile is None:
            opt.outfile = arg
        else:
            raise SystemExit(f"extra unknown argument: {arg} !")

    if opt.lowpass_freq and opt.allpass:
        raise SystemExit("error: can't specify BOTH the allpass option and "
                         "a lowpass frequency!")
    if opt.duration is not None and opt.tempo_ratio != 1.0:
        raise SystemExit("error: can't specify BOTH a tempo change and a "
                         "target duration!")
    return opt


def process_file(opt: Options, device="cuda") -> int:
    """The wav_process + process_audio pipeline (reference art.c:473-1155);
    ``device``: where ``--backend=cuda`` runs its steady blocks and
    ``--backend=torch`` its resampler's kernels."""
    dt = np.dtype(opt.dtype)
    with open(opt.infile, "rb") as f:
        info = wavfile.read_wav_header(f)
        sample_rate = info.sample_rate
        num_channels = info.num_channels
        num_samples = info.num_frames
        inbits = info.bits_per_sample
        if inbits == 64 and dt != np.float64:
            # a 64-bit float input implies the f64 data path (same rule as
            # -o64): the reference's 32-bit build rejects these files as
            # unsupported (art.c:552-574), and silently downcasting f64
            # audio through the f32 pipeline would be worse than either
            dt = np.dtype(np.float64)
            opt.dtype = np.float64

        resample_rate = opt.resample_rate or sample_rate
        outbits = opt.outbits or inbits

        if opt.verbosity >= 0:
            print(f"resampling {num_channels}-channel file "
                  f"\"{opt.infile}\" ({inbits}b/"
                  f"{(sample_rate + 500) // 1000}k) to \"{opt.outfile}\" "
                  f"({outbits}b/{(resample_rate + 500) // 1000}k)...",
                  file=sys.stderr)

        sample_ratio = resample_rate / sample_rate
        stretch_ratio = 1.0
        tempo_ratio = opt.tempo_ratio

        if opt.duration is not None:
            rel, value = opt.duration
            source_seconds = num_samples / sample_rate
            target = {1: source_seconds + value,
                      -1: source_seconds - value}.get(rel, value)
            if target <= 0.0:
                raise SystemExit("error: invalid relative duration "
                                 "specified!")
            tempo_ratio = source_seconds / target

        stretcher = None
        if opt.pitch_ratio != 1.0 or tempo_ratio != 1.0:
            stretch_ratio = opt.pitch_ratio / tempo_ratio
            sample_ratio /= opt.pitch_ratio
            if stretch_ratio != 1.0:
                if num_channels > 2:
                    raise SystemExit("error: audio stretch only works with "
                                     "mono or stereo, "
                                     f"not {num_channels}-channel")
                if not 0.25 <= stretch_ratio <= 4.0:
                    raise SystemExit("error: audio stretch requires "
                                     f"excessive ratio {stretch_ratio:g}")
                flags = (STRETCH_DUAL_FLAG
                         if stretch_ratio < 0.5 or stretch_ratio > 2.0
                         else 0)
                try:
                    stretcher = Stretcher(sample_rate // 350,
                                          sample_rate // 50,
                                          num_channels, flags, dtype=dt)
                except ValueError:
                    # out-of-range periods (rate < ~8400 undershoots
                    # MIN_PERIOD): the reference prints this line from
                    # stretchInit (stretch.c:52-56) and then crashes on
                    # the NULL context (art.c:786) — we print the same
                    # line and exit cleanly
                    print("stretchInit(): invalid periods!",
                          file=sys.stderr)
                    return -1
                if opt.verbosity > 0:
                    print(f"audio stretch initialized with ratio "
                          f"{stretch_ratio:g}", file=sys.stderr)

        target_output = int(math.floor(
            num_samples * stretch_ratio * sample_ratio + 0.5))

        resampler = None
        if opt.num_filters and (sample_ratio != 1.0 or opt.lowpass_freq
                                or opt.phase_shift != 0.0):
            flags = SUBSAMPLE_INTERPOLATE | INCLUDE_LOWPASS
            if opt.multithreaded:
                flags |= RESAMPLE_MULTITHREADED
            if opt.bh4_window or not opt.hann_window:
                flags |= BLACKMAN_HARRIS
            if opt.phase_shift != 0.0:
                flags |= NO_FILTER_REDUCTION
            if opt.allpass:
                flags &= ~INCLUDE_LOWPASS
            if opt.extrapolation:
                flags |= EXTRAPOLATE_ENDPOINTS
            if opt.backend == "cuda":
                # device steady state + host edges; falls back to the host
                # engine when the config cannot reduce to a fixed ratio (a
                # ValueError; a missing card or a failed build propagates)
                from ..parallel.streams import HybridStreamResampler
                try:
                    resampler = HybridStreamResampler(
                        num_channels, opt.num_taps, opt.num_filters,
                        sample_rate * opt.pitch_ratio, resample_rate,
                        opt.lowpass_freq, flags, dtype=dt, device=device)
                except ValueError:
                    resampler = None
            if resampler is None:
                try:
                    resampler = Resampler.fixed_ratio(
                        num_channels, opt.num_taps, opt.num_filters,
                        sample_rate * opt.pitch_ratio, resample_rate,
                        opt.lowpass_freq, flags, dtype=dt,
                        backend="torch" if opt.backend == "torch"
                        else "numpy", device=device)
                except ValueError as e:
                    # the reference lib prints its reason to stderr and
                    # returns NULL; art adds its own line and exits
                    # (reference resampler.c:317-318, art.c:829-831)
                    print(e, file=sys.stderr)
                    print("error: resampler initialization failed!",
                          file=sys.stderr)
                    return -1
            if opt.verbosity > 0:
                lr = resampler.get_lowpass_ratio()
                nf = resampler.get_num_filters()
                interp = "with" if resampler.interpolation_used() else "no"
                if lr == 1.0:
                    print(f"{nf} {opt.num_taps}-tap fixed-ratio sinc "
                          f"resampler{'s' if nf > 1 else ''}, no lowpass, "
                          f"{interp} interpolation", file=sys.stderr)
                else:
                    lp = int(lr * (sample_rate * opt.pitch_ratio / 2.0))
                    print(f"{nf} {opt.num_taps}-tap fixed-rate sinc "
                          f"resampler{'s' if nf > 1 else ''} with lowpass "
                          f"at {lp} Hz, {interp} interpolation",
                          file=sys.stderr)

        if opt.extended_math and opt.verbosity > 0:
            # reference -e selects apply_filter_precise (double-accumulating
            # dot, resampler.c:84-88, 1159-1181); every path here already
            # accumulates at >= float64 (host) or full-f32 MXU precision
            # with a float64-vs-device floor test (device), so the flag is
            # satisfied rather than ignored
            print("extended convolution math: always active "
                  "(double-precision accumulation)", file=sys.stderr)

        pre_filter = post_filter = False
        lowpass1 = lowpass2 = None
        if opt.pre_post_filter:
            if resample_rate <= sample_rate:
                cutoff = resample_rate * 0.45 / sample_rate
                pre_filter = True
                if opt.verbosity > 0:
                    print(f"cutoff = {cutoff:g}, cascaded biquad "
                          f"pre-filter at {sample_rate * cutoff:g} Hz",
                          file=sys.stderr)
            else:
                cutoff = sample_rate * 0.45 / resample_rate
                post_filter = True
                if opt.verbosity > 0:
                    print(f"cascaded biquad post-filter at "
                          f"{resample_rate * cutoff:g} Hz", file=sys.stderr)
            coeffs = biquad_lowpass(cutoff)
            lowpass1 = Biquad.init(coeffs, 1.0, num_channels, dt)
            lowpass2 = Biquad.init(coeffs, 1.0, num_channels, dt)

        decimator = None
        if outbits < 32:
            dec_flags = opt.dither | opt.noise_shaping
            if opt.multithreaded:
                dec_flags |= DECIMATE_MULTITHREADED
            # always the native backend: it is the fastest bit-exact host
            # path, and --backend only selects the resampling compute path
            decimator = Decimator(num_channels, outbits, (outbits + 7) // 8,
                                  1.0, resample_rate, dec_flags, dtype=dt,
                                  backend="native")

        # --backend=cuda with an integer output: the decimate stage also
        # runs on the card, so steady blocks never fetch float32 samples --
        # only packed bytes (and the clip count) cross to the host
        # (reference chains the stages per chunk on host, art.c:933-1130).
        # Shaped modes stay on the host, as in JAX: the error-feedback
        # recurrence is a serial loop (PERF.md times it on the card).
        dev_decimator = None
        if (decimator is not None and opt.backend == "cuda"
                and dt == np.float32 and stretcher is None
                and not (dec_flags & SHAPING_ENABLED)):
            dev_decimator = DeviceDecimator(
                num_channels, outbits, (outbits + 7) // 8, 1.0,
                resample_rate, dec_flags, dtype=dt, device=device)

        # -p upsampling with --backend=cuda: the post filter runs on the
        # card as the masked block-IIR cascade between the device resample
        # and decimate stages, with exact filter-state handoff to the host
        # Biquads at chunk edges (reference chains these on host,
        # art.c:1052-1058; here the chain stays on the card)
        dev_post = None
        dev_post_active = False
        if (post_filter and opt.backend == "cuda"
                and dev_decimator is not None
                and hasattr(resampler, "process_interleaved_device")):
            # gate mirrors the device-output consumer: without a device
            # decimator no chunk ever takes the device output path, so a
            # cascade built here could never run
            from ..ops.biquad_kernel import DeviceBiquadCascade
            dev_post = DeviceBiquadCascade(lowpass1, lowpass2, device=device)

        if resampler is not None:
            resampler.advance_position(opt.num_taps / 2.0 + opt.phase_shift)

        outcap = int((BUFFER_SAMPLES + opt.num_taps // 2) * sample_ratio
                     + 100.0)
        if stretcher is not None:
            stretch_cap = stretcher.get_output_capacity(BUFFER_SAMPLES,
                                                        stretch_ratio)
            outcap = int((stretch_cap + opt.num_taps // 2) * sample_ratio
                         + 100.0)

        with open(opt.outfile, "wb") as out:
            wavfile.write_wav_header(
                out, bits=outbits, num_channels=num_channels,
                num_frames=num_samples, sample_rate=resample_rate,
                channel_mask=info.channel_mask)

            remaining = num_samples
            output_samples = 0
            clipped = 0
            frame_bytes = num_channels * info.bytes_per_sample
            progress_divider = ((num_samples + 50) // 100
                                if opt.verbosity >= 0 and num_samples > 1000
                                else 0)
            percent = -1
            if progress_divider:
                # the reference ticker starts at 0% before the loop
                # (art.c:926-929)
                percent = 0
                print("\rprogress: 0% ", end="", file=sys.stderr,
                      flush=True)

            # -m: worker pools overlap host IO with engine compute (the
            # reference's pool parallelizes within a chunk across channels,
            # resampler.c:441-484; with vectorized channel engines the
            # remaining host-side concurrency is IO overlap).  Two
            # single-worker pools: one prefetch-decodes the next chunk,
            # one drains packed-byte fetches + file writes.  Each pool is
            # FIFO (write ordering preserved); separating them keeps a
            # pending fetch from blocking the next read enqueue.
            pool = wpool = None
            if opt.multithreaded:
                from ..parallel import workers as _w
                pool = _w.workers_init(1)
                if dev_decimator is not None:
                    # the write pool only ever receives jobs from the
                    # device-decimator fetch path; host-path writes stay
                    # on the main thread
                    wpool = _w.workers_init(1)

            clip_cell = [0]
            io_error = []

            def _read_decode(_ctx, slot):
                try:
                    to_read = min(slot[0], BUFFER_SAMPLES)
                    raw = f.read(to_read * frame_bytes)
                    frames_read = len(raw) // frame_bytes
                    slot[1] = frames_read
                    slot[2] = wavfile.decode_frames(
                        raw[:frames_read * frame_bytes], info, opt.gain,
                        dt) if frames_read \
                        else np.zeros((0, num_channels), dt)
                except BaseException as e:   # surfaced on the main thread
                    slot[1] = 0
                    slot[2] = np.zeros((0, num_channels), dt)
                    io_error.append(e)
                return 0

            def _fetch_write(_ctx, job):
                try:
                    packed_dev, clip_dev, k = job
                    out.write(packed_dev[:k].cpu().numpy().tobytes())
                    clip_cell[0] += int(clip_dev)
                except BaseException as e:   # surfaced on the main thread
                    io_error.append(e)
                return 0

            pending = [remaining, 0, None]
            read_job = pool.enqueue(_read_decode, None, pending) \
                if pool is not None else 0

            # drain both pools before the with-block closes the output
            # file, on success AND on exception paths (a queued
            # _fetch_write must never race the file close)
            try:
                while output_samples < target_output:
                    if pool is not None:
                        pool.wait_on_job(read_job)
                        if io_error:
                            raise io_error[0]
                        frames_read, frames = pending[1], pending[2]
                        remaining -= frames_read
                        pending = [remaining, 0, None]
                        read_job = pool.enqueue(_read_decode, None, pending)
                    else:
                        pending[0] = remaining
                        _read_decode(None, pending)
                        if io_error:
                            raise io_error[0]
                        frames_read, frames = pending[1], pending[2]
                        remaining -= frames_read

                    if stretcher is not None:
                        if frames_read:
                            flat = stretcher.process(frames.reshape(-1),
                                                     frames_read, stretch_ratio)
                        else:
                            flat = stretcher.flush()
                        frames = flat.reshape(-1, num_channels)

                    # the reference filters the *raw read buffer*, which the
                    # resampler never sees when a stretcher is active
                    # (art.c:1011-1017 vs resample_buffer at art.c:1023) — so
                    # with a stretcher, -p has no effect on output
                    if pre_filter and stretcher is None and frames.shape[0]:
                        frames = apply_cascade([lowpass1, lowpass2], frames)

                    dev_out = None
                    if resampler is not None:
                        if (dev_decimator is not None
                                and (not post_filter or dev_post is not None)
                                and hasattr(resampler,
                                            "process_interleaved_device")):
                            outbuf, res, dev_out = \
                                resampler.process_interleaved_device(
                                    frames if frames.shape[0] else None,
                                    frames.shape[0] if frames.shape[0] else -1,
                                    outcap, sample_ratio)
                        else:
                            outbuf, res = resampler.process_interleaved(
                                frames if frames.shape[0] else None,
                                frames.shape[0] if frames.shape[0] else -1,
                                outcap, sample_ratio)
                        generated = res.output_generated
                        if generated == outcap:
                            raise SystemExit("fatal error: outputbuffer too "
                                             "small!")
                    else:
                        outbuf = frames
                        generated = frames.shape[0]

                    if (not frames.shape[0] and not generated
                            and output_samples < target_output):
                        generated = min(target_output - output_samples, outcap)
                        outbuf = np.zeros((generated, num_channels), dt)

                    if post_filter and generated:
                        if dev_out is not None:
                            # device chunk: filter on the card, adopting the
                            # host filters' streaming state on first use
                            if not dev_post_active:
                                dev_post.push_from(lowpass1, lowpass2)
                                dev_post_active = True
                            dev_out = dev_post.process(dev_out, generated)
                        else:
                            if dev_post_active:
                                dev_post.pull_to(lowpass1, lowpass2)
                                dev_post_active = False
                            outbuf = apply_cascade([lowpass1, lowpass2],
                                                   outbuf[:generated])

                    if output_samples + generated > target_output:
                        generated = target_output - output_samples
                    if outbuf is not None:
                        outbuf = outbuf[:generated]

                    if outbits < 32:
                        if dev_decimator is not None:
                            if dev_out is not None:
                                # K1's [ch, capacity] output, read in place
                                # as [capacity, ch]; rows past generated are
                                # inert, and an oversize engine chunk (nb*L
                                # past the outcap bucket) is sliced as JAX
                                # does
                                dec_rows = -(-outcap // 256) * 256
                                src = dev_out.T[:dec_rows]
                            else:
                                src = outbuf
                            step = dev_decimator.process_chunk_async(
                                src, generated)
                            if step is not None:
                                job = (step[0], step[1], generated)
                                if wpool is not None:
                                    wpool.enqueue(_fetch_write, None, job)
                                else:
                                    _fetch_write(None, job)
                                # fail fast on a failed write (disk full):
                                # read and dispatch no further blocks
                                if io_error:
                                    raise io_error[0]
                        else:
                            packed, c = decimator.process_interleaved(outbuf)
                            clipped += c
                            out.write(packed.tobytes())
                    else:
                        out.write(wavfile.encode_float_frames(outbuf, outbits))

                    output_samples += generated
                    if progress_divider:
                        new_pct = 100 - remaining // progress_divider
                        if new_pct != percent:
                            percent = new_pct
                            print(f"\rprogress: {percent}% ", end="",
                                  file=sys.stderr, flush=True)
            finally:
                if pool is not None:
                    pool.wait_all()
                    pool.deinit()
                if wpool is not None:
                    wpool.wait_all()
                    wpool.deinit()
            if io_error:
                raise io_error[0]
            clipped += clip_cell[0]

            data_bytes = output_samples * num_channels * ((outbits + 7) // 8)
            if data_bytes & 1:
                out.write(b"\x00")
            out.seek(0)
            wavfile.write_wav_header(
                out, bits=outbits, num_channels=num_channels,
                num_frames=output_samples, sample_rate=resample_rate,
                channel_mask=info.channel_mask)

    if opt.verbosity >= 0:
        print("\r...completed successfully", file=sys.stderr)
    if opt.verbosity > 0:
        print(f"info: {output_samples} samples were generated",
              file=sys.stderr)
    if clipped:
        print(f"warning: {clipped} samples were clipped, suggest reducing "
              "gain!", file=sys.stderr)
    if remaining:
        print("warning: file terminated early!", file=sys.stderr)
    return 0


def main(argv=None, *, device="cuda") -> int:
    """The command line; ``device``: the torch device of ``--backend=cuda``
    and ``--backend=torch`` (the command always runs on the card)."""
    opt = parse_args(argv if argv is not None else sys.argv[1:], Options())
    if opt.verbosity >= 0:
        bits = np.dtype(opt.dtype).itemsize * 8
        print(f"\n ART-TPU  Audio Resampling Tool  {bits}-bit Version "
              f"{VERSION}\n", file=sys.stderr)
    if not opt.outfile:
        print(USAGE)
        return 0
    if opt.infile == opt.outfile:
        print("can't overwrite input file (specify different/new output "
              "file name)", file=sys.stderr)
        return -1
    if not opt.overwrite and os.path.exists(opt.outfile):
        print(f"output file \"{opt.outfile}\" exists (use -y to overwrite)",
              file=sys.stderr)
        return -1
    try:
        return process_file(opt, device)
    except wavfile.WavFormatError as e:
        # reference-style one-liner instead of a traceback (art.c:521-571);
        # verbatim messages are complete reference lines (art.c:608)
        if getattr(e, "verbatim", False):
            print(e, file=sys.stderr)
        else:
            print(f"\"{opt.infile}\" is {e}!", file=sys.stderr)
        return -1
    except OSError as e:
        # distinguish the reference's three cases (art.c:487, 492, 684):
        # open-for-reading and open-for-writing failures carry the path;
        # a mid-run write failure (disk full) carries none
        fn = getattr(e, "filename", None)
        if fn == opt.outfile:
            print(f"can't open file \"{opt.outfile}\" for writing!",
                  file=sys.stderr)
        elif fn is not None:
            print(f"can't open file \"{fn}\" for reading!", file=sys.stderr)
        else:
            print(f"can't write to file \"{opt.outfile}\"!", file=sys.stderr)
        return -1


if __name__ == "__main__":
    raise SystemExit(main())
