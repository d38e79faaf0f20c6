from crazyflie_nmpc_tpu_torch.ops.integrators import (  # noqa: F401
    integrate,
    linearize_trajectory,
    rk4_step,
    rollout,
    step_with_sensitivities,
)
