"""correction_roofline.sweep: the correction sweep kernel's share of its
roofline on a sweep's first objective call (every cell's initial simplex),
%.  The bound is the work the function needs on the benchmark's rebuild of
that call (benchmark/roofline/first_call.py) over the H100's FP64 and HBM
peaks; the time is the kernel's own, replayed alone on the port's input of
the same call.  Nothing to read where the port has no such kernel.
Layer: the kernels (kernels/correction_fused.py, csrc/correction_sweep.cu)."""

from benchmark.harness.profiling import kernel_ms
from benchmark.roofline.first_call import correction_bound_s


def read(ctx):
    try:
        from misti_tpu_torch.kernels.correction_fused import correction_sweep
    except ImportError:
        return None
    call = ctx["driver"].first_call(ctx["request"])
    if getattr(call["fs"], "kernel_input", None) is None:
        return None
    inp = call["fs"].kernel_input(call["st"], call["params"])
    opts = call["fs"].kernel_opts
    ms, how = kernel_ms(lambda: correction_sweep(inp, **opts), reps=10, launches=1)
    bound, by, ops, nbytes = correction_bound_s(ctx["config"], call["rows"])
    return {"value": 100 * bound / (ms / 1e3), "device_ms": ms, "timed_by": how,
            "bound_ms": bound * 1e3, "bound_by": by, "ops": ops, "bytes": nbytes}
