"""The benchmark's own code: the cell's description, the GCM loop that the
window drives, the metric arithmetic, the kernels' work and the peaks,
the reading of traces, and the comparison that decides ``correct``.

Nothing here imports ``jax``, ``jaxlib`` or ``pam_tpu``; the program under
test, ``pam_tpu_torch``, is imported only by :mod:`mmfbench.program`."""
