"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each wrapper counts its kernel launches in a plain integer attribute
(`wrapper.launches`), incremented only where it launches the kernel; a CPU
tensor takes the plain version and counts nothing.  The split sweeps
`kkt_sweep_c2_win` / `corrector_sweep_c2_win` are two launches each, of
`bwd_c2` / `bwd_vec_c2` and then `fwd_c2`, counted on those kernels.
`expand2` counts both of its forms (stride 1 and 2), `prep_condense2` and
`prep_sweep` both VDE orders, `kkt_sweep_c2` and `corrector_sweep_c2` their
compressed-stream forms too.  `KERNELS` holds the solver's kernels; the
speed-of-light probes of `roofline.ipm_iter_sol` (`fma_chain`,
`stage_replay`), on no solver path, count the same way in `PROBES`: pass
it to `launch_counts` / `reset_launch_counts`.
"""

from __future__ import annotations

from crazyflie_nmpc_tpu_torch.ops.cuda.condensed_kernels import (
    bwd_c2,
    bwd_vec_c2,
    condense2,
    corrector_sweep_c2,
    expand2,
    fwd_c2,
    iter_sweep_c2,
    kkt_sweep_c2,
)
from crazyflie_nmpc_tpu_torch.ops.cuda.prep_kernel import (prep_condense2,
                                                           prep_sweep)
from crazyflie_nmpc_tpu_torch.ops.cuda.riccati_kernels import (
    backward_sweep,
    backward_vector_sweep,
    corrector_sweep,
    forward_sweep,
    kkt_sweep,
)
from crazyflie_nmpc_tpu_torch.ops.cuda.sol_kernels import PROBES  # noqa: F401

KERNELS = {
    "prep_condense2": prep_condense2,
    "kkt_sweep_c2": kkt_sweep_c2,
    "corrector_sweep_c2": corrector_sweep_c2,
    "expand2": expand2,
    "bwd_c2": bwd_c2,
    "fwd_c2": fwd_c2,
    "bwd_vec_c2": bwd_vec_c2,
    "iter_sweep_c2": iter_sweep_c2,
    "prep_sweep": prep_sweep,
    "condense2": condense2,
    "kkt_sweep": kkt_sweep,
    "corrector_sweep": corrector_sweep,
    "backward_sweep": backward_sweep,
    "forward_sweep": forward_sweep,
    "backward_vector_sweep": backward_vector_sweep,
}


def launch_counts(kernels=KERNELS) -> dict:
    return {name: fn.launches for name, fn in kernels.items()}


def reset_launch_counts(kernels=KERNELS) -> None:
    for fn in kernels.values():
        fn.launches = 0
