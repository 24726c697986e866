"""The device's idle share of the rollout, in percent: 1 minus the union
of the device operations' intervals over the span from the first one's
start to the last one's end, both read from one sub-window profiled with
CUDA activity alone (``trace.device_busy``), in which the host runs as it
does untraced."""


def read(record: dict):
    if record.get("device_busy") is None:
        return None
    busy_s, window_s = record["device_busy"]
    return 100.0 * (1.0 - busy_s / window_s)
