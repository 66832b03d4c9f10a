"""The port's MoE dispatch at the decode sizes, where its one-launch route
runs on the card, against the JAX package's; and the route the wrapper
picks from the shapes.

Same numpy inputs on both sides, on the CPU: the JAX fused kernel runs in
interpret mode, the port's wrapper through its plain version (both routes
are held to it on the card, ``tests/test_torch_gpu.py``).
"""
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.kernels import moe_dispatch as jmd
from paddle_tpu_torch.kernels import moe_dispatch as tmd
from test_torch_moe import _assert_dispatch, _inputs

# the decode buckets below 8 at ERNIE-MoE's 8 experts, C = S:
# (S, E, C, k, gate kind)
CASES = [(1, 8, 1, 2, "gshard"),
         (2, 8, 2, 2, "gshard"),
         (4, 8, 4, 2, "gshard")]


@pytest.mark.parametrize("S,E,C,K,kind", CASES)
def test_decode_dispatch_matches_jax(S, E, C, K, kind):
    """The port's dispatch (its plain version on the CPU) against the JAX
    reference and the JAX fused kernel in interpret mode."""
    x, gw, gb = _inputs(S, E)
    kw = dict(num_expert=E, capacity=C, top_k=K, gate_kind=kind)
    got = tmd.fused_moe_dispatch(*map(torch.from_numpy, (x, gw, gb)), **kw)
    assert got[1].dtype == torch.int32 and got[2].dtype == torch.float32
    jx = [jnp.asarray(a) for a in (x, gw, gb)]
    _assert_dispatch(got, jmd.reference_moe_dispatch(*jx, **kw), "reference")
    _assert_dispatch(got, jmd.fused_moe_dispatch(*jx, **kw), "kernel")


def test_dispatch_route_from_shapes():
    """The dispatch kernel's route, from the shapes alone: one launch up to
    the switch point while a lane per expert and 48 KB of shared memory
    hold, else three passes; the private switch forces either."""
    S1 = tmd._ONE_LAUNCH_MAX_S
    for S in (1, 2, 4, 8, S1):
        assert tmd.dispatch_route(S, 8, 2) == "one_launch"
    assert tmd.dispatch_route(S1 + 1, 8, 2) == "three_pass"
    assert tmd.dispatch_route(8, 32, 2) == "one_launch"
    assert tmd.dispatch_route(8, 33, 2) == "three_pass"
    assert tmd._one_launch_fits(512, 8, 2)          # the forced sweep's top
    assert not tmd._one_launch_fits(4096, 8, 2)
    with tmd._dispatch_route("three_pass"):
        assert tmd.dispatch_route(1, 8, 2) == "three_pass"
        with tmd._dispatch_route("one_launch"):
            assert tmd.dispatch_route(4096, 8, 2) == "one_launch"
        assert tmd.dispatch_route(1, 8, 2) == "three_pass"
    assert tmd.dispatch_route(1, 8, 2) == "one_launch"
    with pytest.raises(ValueError, match="route"):
        with tmd._dispatch_route("cluster"):
            pass
