"""expm_action_roofline.sweep: the 44-state ``expm_action`` kernel's share
of its roofline over the pre-split spectrum intervals of a sweep's first
objective call (one launch per interval), %.  The bound is the work each
interval needs on the benchmark's rebuild of that call
(benchmark/roofline/first_call.py) over the H100's FP64 and HBM peaks,
summed over the intervals; the time is the kernel's own over the same
launches, replayed alone on the arguments the port passed it in that call.
Nothing to read where the port has no such kernel.
Layer: the kernels (kernels/expm_action.py, csrc/expm_action.cu)."""

from benchmark.harness.profiling import kernel_ms
from benchmark.roofline.first_call import expm_action_k2_bound_s


def read(ctx):
    try:
        from misti_tpu_torch.engine import likelihood as lk
    except ImportError:
        return None
    orig = getattr(lk, "expm_action_pair", None)
    if orig is None:
        return None
    call = ctx["driver"].first_call(ctx["request"])
    seen = []

    def capture(*a, **kw):
        if a[4].shape[-1] == 44:
            seen.append((a, kw))
        return orig(*a, **kw)

    lk.expm_action_pair = capture
    try:
        call["call"]()
    finally:
        lk.expm_action_pair = orig
    if not seen:
        return None
    ms, how = kernel_ms(lambda: [orig(*a, **kw) for a, kw in seen], reps=5,
                        launches=len(seen))
    bound, ops, nbytes = expm_action_k2_bound_s(ctx["config"], call["rows"])
    return {"value": 100 * bound / (ms / 1e3), "device_ms": ms, "timed_by": how,
            "launches": len(seen), "bound_ms": bound * 1e3, "ops": ops, "bytes": nbytes}
