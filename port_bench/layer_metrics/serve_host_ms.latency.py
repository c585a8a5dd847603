"""The host's share of a lone request in the traced window: the mean
request latency there less the device's busy time per request (kernels,
copies and sets), in ms."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device or not ctx.traced.requests:
        return None
    mean_ms = sum(ctx.traced.latencies_ms) / len(ctx.traced.latencies_ms)
    return mean_ms - 1e3 * ctx.trace.busy_s / ctx.traced.requests
