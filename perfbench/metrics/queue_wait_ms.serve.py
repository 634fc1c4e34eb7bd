"""Mean ms a request waited in the queue, from ``submit`` to its admission
into a slot, over the window's admissions: the port's
``serve.queue_wait_seconds`` (host clock, recorded whenever metrics are
on). None where the program has no such histogram."""


def read(m):
    n = m.counters.get("serve.queue_wait_seconds.count", 0)
    if not n:
        return None
    return m.counters["serve.queue_wait_seconds.sum"] / n * 1e3
