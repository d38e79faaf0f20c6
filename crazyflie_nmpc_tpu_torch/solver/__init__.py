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
    as_rti_prepare,
    as_rti_step,
    init_rti,
    rti_step,
    sqp_solve,
)
from crazyflie_nmpc_tpu_torch.solver.outputs import (  # noqa: F401
    BodyTwist,
    krpm2pwm,
    pwm2krpm,
    to_cmd_vel,
)
from crazyflie_nmpc_tpu_torch.solver import policies  # noqa: F401
