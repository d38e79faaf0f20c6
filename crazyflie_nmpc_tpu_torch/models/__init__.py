from crazyflie_nmpc_tpu_torch.models.quadrotor import (  # noqa: F401
    NU,
    NX,
    NY,
    NYN,
    W_MAX_KRPM,
    W_MIN_KRPM,
    QuadrotorParams,
    dynamics,
    dynamics_jacobians,
    hover_control,
    hover_state,
)
from crazyflie_nmpc_tpu_torch.models import rotations  # noqa: F401
from crazyflie_nmpc_tpu_torch.models.firmware import (  # noqa: F401
    AttitudeGains,
    attitude_plant_step,
    init_motor_state,
    mix_cmd_vel,
)
from crazyflie_nmpc_tpu_torch.models.cartpole import (  # noqa: F401
    CP_NU,
    CP_NX,
    CP_NY,
    CartpoleParams,
    cartpole_dynamics,
    cartpole_ocp,
    downward_state,
    upright_state,
)
