from crazyflie_nmpc_tpu_torch.parallel.mesh import (  # noqa: F401
    BATCH_AXIS,
    STAGE_AXIS,
    Mesh,
    make_mesh,
)
from crazyflie_nmpc_tpu_torch.parallel.sharded import (  # noqa: F401
    batch_sharded_rti,
    stage_sharded_rti_step,
)
from crazyflie_nmpc_tpu_torch.parallel.pod import (  # noqa: F401
    fleet_metrics,
    init_distributed,
    pod_rti_step,
)
