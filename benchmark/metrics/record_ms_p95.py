"""The 95th percentile, over every record of the spanned window, of the
device interval between CUDA events recorded after consecutive step calls
(model step layer)."""
from benchmark.timeline import percentile


def read(t):
    if not t.record_ms:
        return None
    return percentile(t.record_ms, 95.0)
