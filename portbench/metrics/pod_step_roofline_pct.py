"""Share of the fused pod step's roofline: the reference's least work of
the traced ingests (items decided, each priced once at the summary size
it met; appends) at the FP32 and HBM peaks, against the device time of
``pod_step_kernel`` in the trace."""


def read(ctx):
    tr, work = ctx["trace"], ctx["work"]
    if not tr or "pod_flops" not in work:
        return None
    s = sum(v for k, v in tr["kernel_s"].items() if "pod_step_kernel" in k)
    if s <= 0:
        return None
    return 100.0 * ctx["peaks"].bound_s(work["pod_flops"],
                                        work["pod_bytes"]) / s
