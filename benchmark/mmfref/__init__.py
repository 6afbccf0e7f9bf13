"""The plain reference of the benchmark: a frozen copy of the MMF CRM
step's mathematics as ``pam_tpu_torch`` computed it when the benchmark was
defined (the SPAM+SI dycore, the GCM forcing, the sponge, SHOC, P3 with its
lookup table, Kessler, and the supercell set-up; the AWFL dycore and its
directional flux, B3's plain version, were copied later), in plain PyTorch and
numpy on any device and dtype: every loop on the host (``ops/graph.py``),
one process (``parallel/``), Thomas solves, the plain WENO and P3 part 2,
no CUDA kernel. It imports nothing of the program, so a later change to the
program cannot change the yardstick. ``tests/test_bench_reference.py``
holds it equal to the program's step bit for bit on the CPU today; the
program's own tests held that step against ``pam_tpu`` (JAX), the port's
source, when the copy was made.

Only what the two configurations' step reaches was kept: the functions
that a CPU run of both configurations (float64, float32 and the bfloat16
control) never called went, with the 3-D, pressure-system, diffusion,
diagnostic and PCR branches; of AWFL the 2-D slab's route alone
(``dycore/awfl.py`` lists its departures)."""
