"""The port's linalg, logic and search ops against the JAX package's, case by
case: the table, its tolerances and what each case checks are in
``test_torch_ops_cases.py``."""
import pytest

import paddle_tpu_torch as tp
from paddle_tpu_torch.framework import place as tplace
from test_torch_ops_cases import check_case, names_of


@pytest.fixture(autouse=True)
def _cpu_place():
    prev = tplace._current_place
    tp.set_device("cpu")
    yield
    tplace._current_place = prev


@pytest.mark.parametrize("name", names_of("linalg", "logic", "search"))
def test_op_against_jax(name):
    check_case(name)
