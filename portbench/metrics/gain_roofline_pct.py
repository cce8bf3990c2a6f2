"""Share of the gain pass's roofline: the reference's least work of the
traced ingests (each item priced once against each live rung at its
size) at the FP32 and HBM peaks, against the device time of both
kernels a ``gain_traced`` call launches (norms, then gains)."""


def read(ctx):
    tr, work = ctx["trace"], ctx["work"]
    if not tr or "gain_flops" not in work:
        return None
    s = sum(v for k, v in tr["kernel_s"].items()
            if "gain_traced_kernel" in k or "gain_norms_kernel" in k)
    if s <= 0:
        return None
    return 100.0 * ctx["peaks"].bound_s(work["gain_flops"],
                                        work["gain_bytes"]) / s
