"""The batched IPM's barrier algebra in segments (`ops.ipm_fast`): the
stacked fraction-to-boundary step against the four separate ones it
replaces, `LoopGraphs` on CPU tensors (it issues the segments eagerly,
as without it), and on the card (`cuda` marker; skips here) the steps
replayed from CUDA graphs against the op-by-op steps, bit for bit, with
the same kernel launches."""

import numpy as np
import pytest
import torch

from crazyflie_nmpc_tpu_torch.models.quadrotor import NX, NY
from crazyflie_nmpc_tpu_torch.ops import cuda as kc
from crazyflie_nmpc_tpu_torch.ops import ipm_fast
from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig, certified_config
from crazyflie_nmpc_tpu_torch.solver import default_ocp, init_rti
from crazyflie_nmpc_tpu_torch.solver.rti_batched import (rti_step_batched,
                                                         to_batch_last)
from _torch_shared import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("tau", [1.0, 0.995])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_stacked_step_equals_the_minimum_of_four(tau, dtype):
    """One `_max_step_lane` over the four stacked (slack, dual) pairs is
    the minimum of the four separate steps exactly, blocking and
    non-blocking lanes both (a lane no entry of which decreases takes
    the full step)."""
    rng = np.random.default_rng(3)
    shape = (4, 10, 4, 6)
    v = torch.as_tensor(rng.uniform(0.01, 2.0, shape), dtype=dtype)
    dv = torch.as_tensor(rng.standard_normal(shape), dtype=dtype)
    dv[..., 0] = dv[..., 0].abs()                # lane 0 never blocks
    dv[..., 1] *= 1e-3                           # lane 1 full step too
    one = [ipm_fast._max_step_lane(v[i], dv[i], tau) for i in range(4)]
    want = torch.minimum(torch.minimum(one[0], one[1]),
                         torch.minimum(one[2], one[3]))
    got = ipm_fast._max_step_lane(v, dv, tau)
    assert torch.equal(got, want)
    assert got[0] == 1.0 and got[1] == 1.0 and (got[2:] < 1.0).all()


def _problem(n, B, device, dtype=torch.float32):
    spec = default_ocp(N=n, tf=0.015 * n, dtype=dtype, device=device)
    rng = np.random.default_rng(11)
    x0 = np.zeros((B, NX))
    x0[:, :3] = 0.2 * rng.standard_normal((B, 3)) + [0.0, 0.0, 0.5]
    x0[:, 3] = 1.0
    x0[:, 7:10] = 0.5 * rng.standard_normal((B, 3))
    y = np.zeros((B, NY))
    y[:, 2] = 0.5
    y[:, 3] = 1.0
    y[:, NX:] = spec.params.hover_speed()
    x = torch.as_tensor(x0, dtype=dtype).to(device)
    y = torch.as_tensor(y, dtype=dtype).to(device)
    return spec, x, y[:, None].expand(B, n, NY), y[:, :NX]


def _steps(spec, x, yref, yref_e, cfg, graphs, steps=3):
    st = to_batch_last(init_rti(spec, x, device=x.device))
    outs = []
    for _ in range(steps):
        st, out = rti_step_batched(spec, st, x, yref, yref_e, cfg,
                                   layout="batch_last", graphs=graphs)
        outs += [out.u_plan, out.x_plan, out.qp_mu, out.kkt_res]
    return outs


@pytest.mark.parametrize("cfg", [
    IPMConfig(iters=4), IPMConfig(iters=4, gondzio_correctors=1)],
    ids=["plain", "gondzio"])
def test_loop_graphs_on_cpu_tensors_run_eagerly(cfg):
    """On CPU tensors `LoopGraphs` captures nothing: the steps equal the
    steps without it bit for bit, and no arena is made."""
    torch.set_num_threads(1)
    spec, x, yref, yref_e = _problem(10, 3, torch.device("cpu"))
    graphs = ipm_fast.LoopGraphs()
    got = _steps(spec, x, yref, yref_e, cfg, graphs)
    want = _steps(spec, x, yref, yref_e, cfg, None)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not graphs._arenas


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["realtime", "certified"])
def test_loop_graphs_match_the_op_by_op_steps_on_the_card(case):
    """On the card the graphed steps equal the op-by-op steps bit for
    bit and launch the same kernels the same number of times."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc)")
    dev = torch.device("cuda")
    n, B, cfg = ((20, 2, IPMConfig(iters=4)) if case == "realtime"
                 else (50, 64, certified_config(16)))
    spec, x, yref, yref_e = _problem(n, B, dev)
    runs, counts = [], []
    for graphs in (ipm_fast.LoopGraphs(), None):
        kc.reset_launch_counts()
        runs.append(_steps(spec, x, yref, yref_e, cfg, graphs))
        counts.append(kc.launch_counts())
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert counts[0] == counts[1] and counts[0]["kkt_sweep_c2"] >= 3 * 4
