"""Device ms a record of the program's own kernels, by the names of its
kernel functions (kernels layer)."""
from benchmark.timeline import is_port_kernel


def read(t):
    if not t.profiled_records or not t.ops:
        return None
    ns = sum(o.end_ns - o.start_ns for o in t.ops
             if is_port_kernel(o.name, t.port_kernels))
    if not ns:
        return None
    return ns / 1e6 / t.profiled_records
