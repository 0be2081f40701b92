"""Device ms a record of the operations that are not the program's own
kernels: PyTorch's kernels, copies and fills (physics glue layer)."""
from benchmark.timeline import is_port_kernel


def read(t):
    if not t.profiled_records or not t.ops:
        return None
    ns = sum(o.end_ns - o.start_ns for o in t.ops
             if not is_port_kernel(o.name, t.port_kernels))
    return ns / 1e6 / t.profiled_records
