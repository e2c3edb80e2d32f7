"""pulse_device_pct.sweep: the pulses' share of the device time of the
correction sweep kernel and the spectrum kernel on a sweep's first
objective call (every cell's initial simplex), %.  Each kernel is replayed
alone on the port's own arguments of that call, once as the call runs it
and once with its pulse work off: the correction kernel's instance without
pulses on the same input with the pulse rates zeroed, the spectrum kernel
with no pulse site.  The share is the two differences over the two kernels'
times as the call runs them; each kernel's two times are beside it.
Nothing to read where the port has no such kernels, or no
``FusedSweep.spectrum_input`` to hand over the spectrum's arguments.
Layer: the kernels (kernels/correction_fused.py, kernels/spectrum.py,
csrc/correction_sweep.cu, csrc/spectrum.cu)."""

import dataclasses

from benchmark.harness.profiling import kernel_ms


def read(ctx):
    try:
        from misti_tpu_torch.kernels.correction_fused import correction_sweep
        from misti_tpu_torch.kernels.spectrum import spectrum_kernel
    except ImportError:
        return None
    call = ctx["driver"].first_call(ctx["request"])
    fs = call["fs"]
    if getattr(fs, "spectrum_input", None) is None or getattr(fs, "kernel_input", None) is None:
        return None
    opts = fs.kernel_opts
    if not opts.get("has_pulse"):
        return None
    inp = fs.kernel_input(call["st"], call["params"])
    flat = inp.clone()
    flat[5:7] = 0.0  # the pulse rates: a pulse of rate 0 is the identity
    flat_opts = dict(opts, has_pulse=False)
    basis, args = fs.spectrum_input(call["st"], call["params"])
    no_sites = dataclasses.replace(args, pulse_site=None)

    times = {}
    for key, fn in (("correction_ms", lambda: correction_sweep(inp, **opts)),
                    ("correction_no_pulse_ms", lambda: correction_sweep(flat, **flat_opts)),
                    ("spectrum_ms", lambda: spectrum_kernel(basis, args)),
                    ("spectrum_no_pulse_ms", lambda: spectrum_kernel(basis, no_sites))):
        times[key], times[key[:-3] + "_timed_by"] = kernel_ms(fn, reps=10, launches=1)
    both = times["correction_ms"] + times["spectrum_ms"]
    pulse = (times["correction_ms"] - times["correction_no_pulse_ms"]
             + times["spectrum_ms"] - times["spectrum_no_pulse_ms"])
    return {"value": 100 * pulse / both, **times, "lanes": args.B,
            "pulse_sites": int(args.pulse_site.sum()) if args.pulse_site is not None else 0}
