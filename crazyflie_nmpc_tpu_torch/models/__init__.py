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
