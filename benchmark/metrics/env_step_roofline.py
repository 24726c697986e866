"""The least time of one batched env step's work over its device time, in
percent.  The least time is the larger of the bytes over the HBM rate and
the f32 operations over the f32 rate (``harness/peaks.py``), counted from
the configuration file's frozen sizes and operation counts, with a reset's
operations for each env that the profiled steps' done flags reset."""

from benchmark.harness import peaks

SPAN = "bench.env_step"


def read(record: dict):
    w = record.get("window")
    if w is None or not w.span_count.get(SPAN) or not w.span_launches.get(SPAN):
        return None
    steps = w.span_count[SPAN]
    resets = record["profiled_resets"] / record["profiled_steps"]
    least = peaks.env_step_least_s(record["config"], record["n_envs"], resets)
    return 100.0 * least / (w.span_device_s[SPAN] / steps)
