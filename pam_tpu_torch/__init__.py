"""pam_tpu_torch: the PyTorch/CUDA port of pam_tpu.

The same MMF cloud-resolving-model step as ``pam_tpu`` (coupler state,
SPAM+SI dycore, GCM forcing, sponge, Kessler microphysics), written as
plain PyTorch on tensors of an explicit device and dtype. Kernels that
``pam_tpu`` wrote in Pallas for the TPU are hand-written CUDA kernels
here (``csrc/``), built at first use; each has a plain PyTorch version
beside it that the CPU path runs.

The package imports neither ``jax`` nor ``pam_tpu``; module paths mirror
``pam_tpu`` so every function's reference is at the same relative path.
"""

__version__ = "0.1.0"
