"""Time in ``ingest_routed`` an ingest outside the gain kernels: the host
clock around the call (it returns after its last round's sync) less the
gain kernels' device time, over the traced ingests."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr["ingests"]:
        return None
    gain = sum(v for k, v in tr["kernel_s"].items()
               if "gain_traced_kernel" in k or "gain_norms_kernel" in k)
    if gain <= 0:
        return None
    host = sum(ctx["ingest_routed_s"][:tr["ingests"]])
    return 1e3 * (host - gain) / tr["ingests"]
