"""ARTEST — Audio Resampling Tester (CLI).

Command-line-compatible port of the reference `artest` harness (reference
artest.c): benchmark and fidelity testing with synthetic LCG noise or tones,
round-trip inverse resampling with time-aligned subtraction (-i), decimation
checksums (-o), planar-vs-interleaved equivalence (-v), raw stream taps
(-w1..5), and the same stats block (count / multiplicative checksum / range /
RMS dB).  The noise source, fades, and checksums are bit-identical to the
reference, so input-stream stats lines match the C binary exactly.

A copy of ``art_tpu/cli/artest.py`` for the PyTorch port, run as ``python
-m art_tpu_torch.cli.artest``.  ``--backend=cuda`` takes the place of
``--backend=device``: the fixed-ratio ``HybridStreamResampler`` with
``-e`` (``--precise`` on it), the runtime-ratio ``ASRCStreamResampler``
without; ``--backend=torch`` takes the place of ``--backend=jax`` (the
host ``Resampler(backend="torch")`` in both modes, the decimator native),
``--backend=jax`` exits naming ``--backend=torch``, and ``--profile=DIR``
writes a ``torch.profiler`` trace.  ``main(argv, device=...)`` names the
torch device of the cuda and torch backends: the command line always runs
on the card, and tests pass ``device="cpu"``.
"""

from __future__ import annotations

import sys

import numpy as np

from ..core.flags import (BLACKMAN_HARRIS, DITHER_HIGHPASS,
                          EXTRAPOLATE_ENDPOINTS, INCLUDE_LOWPASS, PRESETS,
                          SHAPING_ATH_CURVE, SUBSAMPLE_INTERPOLATE)
from ..engines.decimator import Decimator
from ..engines.resampler import Resampler
from ._common import num_suffix, strtol
from ..utils.testsig import (NoiseLCG, Stats, ToneGenerator, checksum_bytes,
                             fade_in, fade_out)

USAGE = """
 Usage:    ARTEST [-options] [< infile.raw] [> outfile.raw]

 Options:  -1|2|3|4    = quality presets, default = 3
           -b<num>     = inbuffer samples (default 4096)
           -c<num>     = number of channels (1-256, default 2)
           -n<num>     = number of seconds (1-36000, default 60)
           -h[<Hz>]    = use tone instead of white noise
           -s<Hz>      = source sample rate   -d<Hz> = destination rate
           -l<Hz>      = lowpass frequency in Hz
           -f<num>     = sinc filters   -t<num> = sinc taps
           -o<bits>    = decimate to bitdepth (4-24)
           -z          = Hann windowing instead of Blackman-Harris
           -e          = calc exact filters / no interpolation
           -r          = read input from stdin
           -w<num>     = write raw stream 1..5 to stdout
           -m          = accepted for compatibility
           -i          = inverse-resample and compare to source
           -a          = do not fade audio endpoints
           -x          = extrapolate audio endpoints
           -p          = precise (doubles) convolution
           -v          = test non-interleaved (planar) API path
           --f64       = 64-bit data path
           --backend=<numpy|torch|cuda> (torch = the resampler's
                         per-call kernels on the NVIDIA card; cuda = the
                         card's engines: the fixed-ratio streaming engine
                         with -e, the runtime-ratio BatchedASRC without)
           --precise   = cuda backend: f64-accumulated contraction
                         dots (the within-0.1-dB-of-C operating point)
           --timing    = per-stage wall-clock summary
           --profile=<dir> = write a torch.profiler trace of the run
"""


def main(argv=None, *, device="cuda") -> int:
    """The command line; ``device``: the torch device of ``--backend=cuda``
    and ``--backend=torch`` (the command always runs on the card)."""
    argv = argv if argv is not None else sys.argv[1:]
    inbuffer_samples = 4096
    chans, taps, filters, seconds = 2, 380, 380, 60
    outbits, outbytes = 32, 4
    source_rate = destin_rate = lowpass_freq = 0
    flags = BLACKMAN_HARRIS | SUBSAMPLE_INTERPOLATE
    dither = DITHER_HIGHPASS
    noise_shaping = SHAPING_ATH_CURVE
    exact = inv_resample = non_interleaved = False
    fades = True
    read_stdin = False
    write_stdout = 0
    tone_freq = 0.0
    dtype = np.float32
    backend = "numpy"
    precise = False
    timing = False
    profile_dir = None

    if not argv:
        sys.stderr.write(USAGE)
        return 0

    i = 0
    while i < len(argv):
        arg = argv[i]
        i += 1
        if arg.startswith("--"):
            name, _, val = arg[2:].partition("=")
            if name == "f64":
                dtype = np.float64
            elif name == "backend":
                if val == "jax":
                    raise SystemExit("--backend=jax is the JAX package's; "
                                     "this port runs it as --backend=torch!")
                if val not in ("numpy", "torch", "cuda"):
                    raise SystemExit("--backend must be numpy, torch or "
                                     "cuda!")
                backend = val
            elif name == "precise":
                precise = True
            elif name == "timing":
                timing = True
            elif name == "profile":
                if not val:
                    raise SystemExit("--profile needs a directory, e.g. --profile=/tmp/trace")
                profile_dir = val
            else:
                raise SystemExit(f"unknown option: {name}")
            continue
        if not arg.startswith("-") or len(arg) < 2:
            raise SystemExit(f"extra unknown argument: {arg} !")
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

            if c in "1234":
                filters, taps = PRESETS[int(c)]
            elif c == "a":
                fades = False
            elif c == "e":
                exact = True
            elif c == "r":
                read_stdin = True
            elif c == "w":
                write_stdout = strtol(take_num())
                if not 0 <= write_stdout <= 5:
                    raise SystemExit("written stream must be 0 - 5!")
            elif c == "z":
                flags &= ~BLACKMAN_HARRIS
            elif c == "i":
                inv_resample = True
            elif c == "v":
                non_interleaved = True
            elif c == "x":
                flags |= EXTRAPOLATE_ENDPOINTS
            elif c == "p":
                # reference -p selects apply_filter_precise (double
                # accumulation, resampler.c:1159-1181); satisfied always —
                # float64 accumulation is the default convolution here (the
                # stats lines it would alter are already at the f64 floor)
                pass
            elif c == "m":
                pass
            elif c in "Hh":
                num = take_num()
                tone_freq = num_suffix(num) if num else 1000.0
                if tone_freq == 0.0:
                    tone_freq = 1000.0
            elif c in "Ss":
                source_rate = int(num_suffix(take_num()))
            elif c in "Dd":
                destin_rate = int(num_suffix(take_num()))
            elif c in "Ll":
                lowpass_freq = int(num_suffix(take_num()))
                flags |= INCLUDE_LOWPASS
            elif c in "Bb":
                inbuffer_samples = strtol(take_num())
                if not 256 <= inbuffer_samples <= 65536:
                    raise SystemExit("inbuffer samples must be 256 - 65536!")
            elif c in "Cc":
                chans = strtol(take_num())
                if not 1 <= chans <= 256:
                    raise SystemExit("num of chans must be 1 - 256!")
            elif c in "Ff":
                filters = strtol(take_num())
                if not 1 <= filters <= 1024:
                    raise SystemExit("num of filters must be 1 - 1024!")
            elif c in "Nn":
                seconds = strtol(take_num())
                if not 1 <= seconds <= 36000:
                    raise SystemExit("number of seconds must be 1 - 36000!")
            elif c in "Oo":
                outbits = strtol(take_num())
                if outbits != 32 and not 4 <= outbits <= 24:
                    raise SystemExit("outbits must be 4 - 24 (for integer) "
                                     "or 32 (for float)!")
                outbytes = (outbits + 7) // 8
            elif c in "Tt":
                taps = strtol(take_num())
                if (taps & 3) or not 4 <= taps <= 1024:
                    raise SystemExit("num of taps must be 4 - 1024 and a "
                                     "multiple of 4!")
            else:
                raise SystemExit(f"illegal option: {c} !")
            j += 1

    if not (destin_rate and source_rate) or not filters or not taps \
            or not chans:
        raise SystemExit("something is missing!")
    if (flags & INCLUDE_LOWPASS) and not lowpass_freq and not exact:
        raise SystemExit("specify lowpass frequency, auto lowpass can only "
                         "be used with exact resampling (-e)!")

    ratio = destin_rate / source_rate
    outbuffer_samples = int((inbuffer_samples + taps // 2) * ratio + 10)
    buffers = int(np.ceil(seconds * source_rate / inbuffer_samples))
    inv_ratio = source_rate / destin_rate if inv_resample else 0.0

    def describe(r, src, dst, w):
        nf = r.get_num_filters()
        interp = "with" if r.interpolation_used() else "no"
        lr = r.get_lowpass_ratio()
        if lr == 1.0:
            print(f"{w}: {nf} {taps}-tap fixed-ratio sinc resampler"
                  f"{'s' if nf > 1 else ''}, no lowpass, {interp} "
                  "interpolation", file=sys.stderr)
        else:
            print(f"{w}: {nf} {taps}-tap fixed-rate sinc resampler"
                  f"{'s' if nf > 1 else ''} with lowpass at "
                  f"{int(lr * src / 2.0)} Hz, {interp} interpolation",
                  file=sys.stderr)

    if precise and backend != "cuda":
        raise SystemExit("--precise applies to --backend=cuda!")
    if precise and not exact:
        raise SystemExit("--precise applies to the exact (-e) device "
                         "path; the runtime-ratio ASRC engine has no "
                         "precise mode!")
    if precise and dtype == np.float64:
        # the f64 data path already accumulates natively in f64; the
        # engine would silently drop the flag (streams.py _precise gate)
        raise SystemExit("--precise is the f32 data path's f64-accumulate "
                         "mode; the --f64 path is already f64!")
    if backend == "cuda" and not exact \
            and (flags & EXTRAPOLATE_ENDPOINTS):
        raise SystemExit("-x is not modeled by the runtime-ratio device "
                         "engine; drop -x or use -e!")

    def make_resampler(src, dst):
        if backend == "cuda":
            from ..parallel.streams import HybridStreamResampler
            return HybridStreamResampler(chans, taps, filters, src, dst,
                                         lowpass_freq, flags, dtype=dtype,
                                         precise=precise, device=device)
        return Resampler.fixed_ratio(chans, taps, filters, src, dst,
                                     lowpass_freq, flags, dtype=dtype,
                                     backend=backend, device=device)

    resampler = inv_resampler = None
    try:
        if ratio != 1.0 or lowpass_freq:
            if exact:
                resampler = make_resampler(source_rate, destin_rate)
                describe(resampler, source_rate, destin_rate, "w1 --> w2")
                if inv_resample:
                    inv_resampler = make_resampler(destin_rate, source_rate)
                    describe(inv_resampler, destin_rate, source_rate,
                             "w2 --> w4")
                inv_ratio = ratio = 0.0
            else:
                def make_interp(lp_ratio):
                    if backend == "cuda":
                        # the runtime-ratio interpolated path on device:
                        # channels ride as BatchedASRC streams (the
                        # reference resampleProcess-with-ratio contract,
                        # resampler.c:433-541 / artest.c:380-437)
                        from ..parallel.asrc import ASRCStreamResampler
                        return ASRCStreamResampler(chans, taps, filters,
                                                   lp_ratio, flags,
                                                   dtype=dtype, device=device)
                    return Resampler(chans, taps, filters, lp_ratio,
                                     flags, dtype=dtype, backend=backend,
                                     device=device)

                resampler = make_interp(lowpass_freq * 2.0 / source_rate)
                describe(resampler, source_rate, destin_rate, "w1 --> w2")
                if inv_resample:
                    inv_resampler = make_interp(
                        lowpass_freq * 2.0 / destin_rate)
                    describe(inv_resampler, destin_rate, source_rate,
                             "w2 --> w4")
            resampler.advance_position(taps / 2.0)
            if inv_resampler is not None:
                inv_resampler.advance_position(taps / 2.0)
    except ValueError as e:
        # the reference prints the engine's validation line (e.g.
        # 'lowpass frequency must be lower than destination Nyquist!',
        # resampler.c:317) and then SEGFAULTS on the NULL context
        # (artest.c:380-437 uses the return unchecked) — we exit cleanly
        print(e, file=sys.stderr)
        return -1

    decimator = None
    if outbits != 32:
        decimator = Decimator(chans, outbits, outbytes, 1.0, destin_rate,
                              dither | noise_shaping, dtype=dtype,
                              backend="native")

    in_stats, out_stats = Stats(chans, dtype), Stats(chans, dtype)
    inv_stats, diff_stats = Stats(chans, dtype), Stats(chans, dtype)
    dec_checksum = 0
    out_bytes = 0
    clipped = 0
    rembuffer = np.zeros((0, chans), dtype=dtype)
    noise = NoiseLCG()
    tone = ToneGenerator()
    stdout = sys.stdout.buffer

    def run_resampler(r, data, n_in, outcap, rr, last):
        """Chunk through the engine, planar (-v) or interleaved."""
        if non_interleaved:
            planar = None if data is None else \
                np.ascontiguousarray(data.T)
            if last:
                out, res = r.process_and_flush(planar, n_in, outcap, rr)
            else:
                out, res = r.process(planar, n_in, outcap, rr)
            return np.ascontiguousarray(out.T), res
        if last:
            return r.process_and_flush_interleaved(data, n_in, outcap, rr)
        return r.process_interleaved(data, n_in, outcap, rr)

    # per-stage timing + optional device trace (the observability analog of
    # the reference's wall-clock benchmarking, SURVEY §5)
    import time as _time
    stage_t = {"generate": 0.0, "resample": 0.0, "inverse": 0.0,
               "decimate": 0.0}

    class _Stage:
        def __init__(self, key):
            self.key = key

        def __enter__(self):
            self.t0 = _time.perf_counter()

        def __exit__(self, *exc):
            stage_t[self.key] += _time.perf_counter() - self.t0

    profiler_cm = None
    if profile_dir:
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        profiler_cm = torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                profile_dir))
        profiler_cm.__enter__()

    try:
        bi = 0
        n = inbuffer_samples
        while (bi < buffers or read_stdin) and n:
            if read_stdin:
                raw = sys.stdin.buffer.read(
                    inbuffer_samples * chans * np.dtype(dtype).itemsize)
                n = len(raw) // (chans * np.dtype(dtype).itemsize)
                inbuf = np.frombuffer(raw[:n * chans * np.dtype(dtype).itemsize],
                                      dtype=dtype).reshape(n, chans).copy()
            else:
                n = inbuffer_samples
                with _Stage("generate"):
                    if tone_freq:
                        inbuf = tone.fill(n, chans, tone_freq / source_rate,
                                          dtype)
                    else:
                        inbuf = noise.fill(n * chans, dtype).reshape(n, chans)
                    if fades:
                        if bi == 0:
                            fade_in(inbuf)
                        elif bi == buffers - 1:
                            fade_out(inbuf)
            if not n:
                break

            in_stats.update(inbuf)
            if write_stdout == 1:
                stdout.write(inbuf.tobytes())

            # the reference flushes once bi reaches the final buffer even when
            # reading stdin (reference artest.c:477-484)
            last = bi >= buffers - 1
            if resampler is None:
                outbuf = inbuf
                used, generated = n, n
            else:
                with _Stage("resample"):
                    outbuf, res = run_resampler(resampler, inbuf, n,
                                                outbuffer_samples, ratio, last)
                used, generated = res.input_used, res.output_generated
                if used != n or generated == outbuffer_samples:
                    raise SystemExit("fatal error in resample results!")
                outbuf = outbuf[:generated]

            out_stats.update(outbuf)
            if write_stdout == 2:
                stdout.write(outbuf.tobytes())

            if inv_resample:
                # worst-case inverse output sizing (reference artest.c:375)
                invcap = int((outbuffer_samples + taps // 2)
                             * (source_rate / destin_rate) + 10)
                if inv_resampler is None:
                    invbuf = outbuf
                    inv_used = inv_gen = generated
                else:
                    with _Stage("inverse"):
                        invbuf, ires = run_resampler(inv_resampler, outbuf,
                                                     generated, invcap,
                                                     inv_ratio, last)
                    inv_used, inv_gen = ires.input_used, ires.output_generated
                    invbuf = invbuf[:inv_gen]

                # reference order (artest.c:511-523): clamp the rounding
                # overshoot FIRST (any buffer), print "fewer" only at exactly
                # the nominal final buffer, THEN run the fatal check against
                # the clamped count
                pending = rembuffer.shape[0] + n
                if inv_gen > pending:
                    print(f"info: we generated {inv_gen - pending} extra "
                          "sample(s) on round-trip resample", file=sys.stderr)
                    inv_gen = pending
                    invbuf = invbuf[:inv_gen]
                elif bi == buffers - 1 and inv_gen < pending:
                    print(f"info: we generated {pending - inv_gen} fewer "
                          "sample(s) on round-trip resample", file=sys.stderr)
                if inv_resampler is not None and (
                        inv_used != generated or inv_gen == invcap):
                    raise SystemExit("fatal error in inverse resample results!")

                inv_stats.update(invbuf)
                if write_stdout == 4:
                    stdout.write(invbuf.tobytes())

                # subtract the time-aligned source (rembuffer bookkeeping,
                # reference artest.c:529-565)
                avail = np.concatenate([rembuffer, inbuf], axis=0)
                diff = invbuf - avail[:inv_gen]
                rembuffer = avail[inv_gen:]
                diff_stats.update(diff)
                if write_stdout == 5:
                    stdout.write(diff.tobytes())

            if decimator is not None:
                with _Stage("decimate"):
                    if non_interleaved:
                        # A/B the planar decimator API (reference artest.c:620-653)
                        packed, c = decimator.process(
                            np.ascontiguousarray(outbuf.T))
                    else:
                        packed, c = decimator.process_interleaved(outbuf)
                clipped += c
                out_bytes += packed.size
                if write_stdout == 3:
                    stdout.write(packed.tobytes())
                dec_checksum = checksum_bytes(packed.reshape(-1), dec_checksum)

            bi += 1

    except BrokenPipeError:
        # a -w tap piped into a consumer that exited (head, ffmpeg):
        # the reference dies silently on SIGPIPE; finish quietly without
        # stats, pointing stdout at devnull so interpreter shutdown does
        # not print a spurious second BrokenPipeError
        import os as _os
        _os.dup2(_os.open(_os.devnull, _os.O_WRONLY), sys.stdout.fileno())
        return 0
    finally:
        # SystemExit from a fatal-results check must still terminate the
        # profiler trace — an unterminated trace directory is unusable
        # for exactly the runs one wants to inspect
        if profiler_cm is not None:
            profiler_cm.__exit__(None, None, None)
            print(f"profiler trace written to {profile_dir}",
                  file=sys.stderr)
    if timing:
        total = sum(stage_t.values())
        parts = ", ".join(f"{k} {v:.3f}s" for k, v in stage_t.items())
        print(f"timing: {parts} (total {total:.3f}s)", file=sys.stderr)

    print(file=sys.stderr)
    print(f"   input (-w1): {in_stats.display()}", file=sys.stderr)
    print(f"  output (-w2): {out_stats.display()}", file=sys.stderr)
    if inv_resample:
        print(f" inverse (-w4): {inv_stats.display()}", file=sys.stderr)
        print(f"    diff (-w5): {diff_stats.display()}", file=sys.stderr)
    if out_bytes:
        print(f"decimate (-w3): count = {out_bytes:9d}, checksum = "
              f"{dec_checksum:016x}, clipped samples = {clipped}",
              file=sys.stderr)
    print(file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
