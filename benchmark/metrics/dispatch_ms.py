"""Host ms a record inside the step calls, from the harness's span around
each call (model step layer)."""


def read(t):
    if not t.records:
        return None
    return sum(t.step_host_s) / t.records * 1e3
