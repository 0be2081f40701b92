"""K6 sweeps inside K7's launches a record stepped (kernels layer), from
the program's counters (vic_tpu_torch.trace.counters: k7_sweeps, which
K7 adds on the device, over records, the step calls) over the whole
process: every block replays the same forcing from the same state, so the
process's ratio is the window's. None where the program has no such
counters or ran no K7."""


def read(t):
    try:
        from vic_tpu_torch import trace
    except ImportError:
        return None
    counts = trace.counters()
    if not counts.get("records") or not counts.get(
            "launches.fd_surface_brent"):
        return None
    return counts["k7_sweeps"] / counts["records"]
