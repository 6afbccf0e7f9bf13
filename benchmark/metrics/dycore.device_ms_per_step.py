"""Device ms a CRM step of the dycore (``spam/``): the program's
``pam:dycore`` span and the B1 kernel, which ctypes launches outside any
span, in a profiled eager step of every chunk (the kernels that the
compiled step captures, launched one by one)."""

from mmfbench import kernels, trace


def read(r):
    eager = r.get("eager")
    if not eager or "pam:dycore" not in eager["spans"]:
        return None
    _, b1_s = trace.kernel_time(eager["ops"], kernels.B1_KERNEL)
    return 1e3 * (eager["spans"]["pam:dycore"] + b1_s) / eager["steps"]
