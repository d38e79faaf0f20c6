from crazyflie_nmpc_tpu_torch.solver.ocp import (  # noqa: F401
    CostSpec,
    OCPSpec,
    default_cost,
    default_ocp,
    diagonal_lls_cost,
    hover_yref,
)
from crazyflie_nmpc_tpu_torch.solver.rti import (  # noqa: F401
    RTIOutput,
    RTIState,
    init_rti,
)
