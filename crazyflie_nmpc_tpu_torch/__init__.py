"""PyTorch/CUDA port of crazyflie_nmpc_tpu for NVIDIA Hopper (H100).

The JAX package `crazyflie_nmpc_tpu` stays the reference; this package
keeps its module layout so each module's counterpart is easy to find.
It imports `torch` only, never JAX nor anything of the JAX package.

Ported so far: the batched RTI step (`solver.rti_batched.rti_step_batched`)
with block-2 condensing and the fused prep+condense launch, whose four
Pallas kernels are hand-written CUDA C++ for sm_90a under `csrc/`
(built at first use by `ops.cuda._build`).

Entry points run on the card unless the caller asks for the CPU: every
constructor takes `device=None`, which means `cuda`, and raises when no
GPU is present.  On CPU tensors the kernel wrappers run their plain
PyTorch versions (that is how the CPU tests hold the port against JAX).
"""

from crazyflie_nmpc_tpu_torch.device import resolve_device  # noqa: F401
