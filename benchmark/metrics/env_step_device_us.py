"""Device microseconds per batched env step: every kernel the host
launched inside the ``bench.env_step`` spans (``BatchedEnv.step``) of the
profiled sub-window, over the number of those spans."""

SPAN = "bench.env_step"


def read(record: dict):
    w = record.get("window")
    if w is None or not w.span_count.get(SPAN) or not w.span_launches.get(SPAN):
        return None
    return w.span_device_s[SPAN] / w.span_count[SPAN] * 1e6
