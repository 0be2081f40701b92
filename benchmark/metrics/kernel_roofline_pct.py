"""The program's countable kernel calls' share of their roofline, in %
(kernels layer): the bound seconds of the profiled part's calls
(benchmark/roofline.py: bytes once, the least operations of the inputs)
over the device seconds, in the profiled part's trace, of the program's
kernels those calls launch."""


def read(t):
    if t.roofline is None:
        return None
    bound_s, names = t.roofline
    device_ns = sum(o.end_ns - o.start_ns for o in t.ops if o.name in names)
    if device_ns <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / (device_ns / 1e9)
