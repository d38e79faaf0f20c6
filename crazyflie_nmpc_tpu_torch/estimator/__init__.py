from crazyflie_nmpc_tpu_torch.estimator.lpf import (  # noqa: F401
    VelocityLPFState,
    init_lpf,
    lpf_step,
)
from crazyflie_nmpc_tpu_torch.estimator.pipeline import (  # noqa: F401
    EstimatorState,
    estimate,
    fuse,
    init_estimator,
    notify_command,
    predict,
)
