"""Seconds of the run's set-up that the program spent in its own set-up
phases: the sum of the ``seconds`` of every ``rsoccer.setup.*`` phase in
the program's counter table (``rsoccer_tpu_torch.utils.tracing``'s
``snapshot()``: keys ``("phase", name, field)``), read in the run's
process once the window has closed: the kernel library's load (with nvcc
where the library is missing), ``make_vec`` and ``BatchedEnv.reset``.
Nothing where the program keeps no such table or no such phase."""

PREFIX = "rsoccer.setup."


def total(table: dict):
    """The phases' seconds in ``table``, or None where it holds none."""
    secs = [v for k, v in table.items() if isinstance(k, tuple) and len(k) == 3 and k[0] == "phase"
            and str(k[1]).startswith(PREFIX) and k[2] == "seconds"]
    return sum(secs) if secs else None


def read(record: dict):
    try:
        from rsoccer_tpu_torch.utils import tracing
    except ImportError:
        return None
    return total(tracing.snapshot())
