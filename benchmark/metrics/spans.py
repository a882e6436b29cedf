"""What the span metrics share: the port's span store (``core/trace.py``), read after the traced call.

The port records its spans only while a profiler records, and of a traced run
only the profiled call runs under one (set-up's warm-up, the timed prep and the
sync-counted call run without), so the store holds that call alone. A span's
time is host time, on the profiler's clock. A program without the store gives
None, as does a store without the spans a metric reads.
"""


def records():
    try:
        from elasticreconstruction_tpu_torch.core import trace
    except ImportError:
        return None
    return trace.records()


def ms_per(span: str, unit_span: str, counter: str):
    """Milliseconds of the spans named ``span`` over the sum of ``counter`` in the spans named ``unit_span``."""
    recs = records()
    if not recs:
        return None
    ns = [s.end_ns - s.start_ns for s in recs if s.name == span]
    units = sum(s.counters.get(counter, 0) for s in recs if s.name == unit_span)
    if not ns or units <= 0:
        return None
    return 1e-6 * sum(ns) / units


def counter_per_span(counter: str, span: str):
    """The sum of ``counter`` over every span, over the number of spans named ``span``."""
    recs = records()
    if not recs:
        return None
    n = sum(s.name == span for s in recs)
    if n == 0:
        return None
    return sum(s.counters.get(counter, 0) for s in recs) / n
