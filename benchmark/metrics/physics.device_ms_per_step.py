"""Device ms a CRM step of the physics (``physics/p3``,
``physics/sgs/shoc``, ``physics/kessler.py``): the program's ``pam:sgs``
and ``pam:micro`` spans and the B4 kernel, which ctypes launches outside
any span, in a profiled eager step of every chunk."""

from mmfbench import kernels, trace


def read(r):
    eager = r.get("eager")
    if not eager or "pam:micro" not in eager["spans"]:
        return None
    _, b4_s = trace.kernel_time(eager["ops"], kernels.B4_KERNEL)
    spans = eager["spans"]
    return 1e3 * (spans["pam:micro"] + spans.get("pam:sgs", 0.0)
                  + b4_s) / eager["steps"]
