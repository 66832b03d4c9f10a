"""The port stands alone: no module of ``paddle_tpu_torch`` (nor
``chip_smoke``) imports JAX or the JAX package, and no entry point quietly
falls back to the CPU. Checked in a fresh interpreter, since the test
process itself has both packages loaded."""
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from paddle_tpu_torch.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = textwrap.dedent("""
    import importlib, pkgutil, sys
    import paddle_tpu_torch
    names = ["paddle_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                                              "paddle_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    # the training slices' modules are among them
    assert {"paddle_tpu_torch.amp.auto_cast",
            "paddle_tpu_torch.amp.grad_scaler",
            "paddle_tpu_torch.optimizer.optimizer",
            "paddle_tpu_torch.nn.clip",
            "paddle_tpu_torch.nn.functional.attention",
            "paddle_tpu_torch.incubate.distributed.models.moe.grad_clip",
            "paddle_tpu_torch.distributed",
            "paddle_tpu_torch.distributed.fleet",
            "paddle_tpu_torch.distributed.fleet.train_step",
            "paddle_tpu_torch.nn.initializer",
            "paddle_tpu_torch.nn._torch_layers",
            "paddle_tpu_torch.nn.layer",
            "paddle_tpu_torch.nn.layer.layers",
            "paddle_tpu_torch.nn.layer.container",
            "paddle_tpu_torch.nn.layer.common",
            "paddle_tpu_torch.nn.layer.activation",
            "paddle_tpu_torch.nn.layer.norm",
            "paddle_tpu_torch.nn.layer.loss",
            "paddle_tpu_torch.nn.layer.transformer",
            "paddle_tpu_torch.nn.functional.activation",
            "paddle_tpu_torch.nn.functional.common",
            "paddle_tpu_torch.nn.functional.norm",
            "paddle_tpu_torch.nn.functional.loss",
            "paddle_tpu_torch.models.bert",
            "paddle_tpu_torch.models._encoder",
            "paddle_tpu_torch.static",
            "paddle_tpu_torch.static.program",
            "paddle_tpu_torch.static.executor",
            "paddle_tpu_torch.static.io",
            "paddle_tpu_torch.static.parity",
            "paddle_tpu_torch.static.serde",
            "paddle_tpu_torch.static.nn",
            "paddle_tpu_torch.static.nn.common",
            "paddle_tpu_torch.jit",
            "paddle_tpu_torch.jit.save_load",
            "paddle_tpu_torch.nn.functional.conv",
            "paddle_tpu_torch.nn.functional.pooling",
            "paddle_tpu_torch.nn.layer.conv",
            "paddle_tpu_torch.nn.layer.pooling",
            "paddle_tpu_torch.vision",
            "paddle_tpu_torch.vision.models",
            "paddle_tpu_torch.vision.models.resnet",
            "paddle_tpu_torch.vision.models.lenet",
            "paddle_tpu_torch.vision.models.alexnet",
            "paddle_tpu_torch.vision.models.vgg",
            "paddle_tpu_torch.vision.models.mobilenetv1",
            "paddle_tpu_torch.vision.models.mobilenet",
            "paddle_tpu_torch.vision.models.mobilenetv3",
            "paddle_tpu_torch.vision.models.squeezenet",
            "paddle_tpu_torch.vision.models.shufflenetv2",
            "paddle_tpu_torch.vision.models.densenet",
            "paddle_tpu_torch.vision.models.googlenet",
            "paddle_tpu_torch.vision.models.inceptionv3",
            } <= set(names), names
    import chip_smoke
    bad = sorted(m for m in sys.modules
                 if m == "jax" or m.startswith(("jax.", "jaxlib",
                                                "paddle_tpu.")) \\
                 or m == "paddle_tpu")
    assert not bad, bad
    from paddle_tpu_torch.kernels import _build
    assert _build._lib is None, "a kernel was built at import"
    import torch
    if not torch.cuda.is_available():
        from paddle_tpu_torch.models.gpt import (GPTForPretraining,
                                                 GPTModel, gpt_tiny_config)
        from paddle_tpu_torch.serving import PagePool, ServingEngine
        from paddle_tpu_torch.models.ernie import (ErnieMoeModel,
                                                   ernie_moe_tiny_config)
        model = GPTForPretraining(GPTModel(gpt_tiny_config(), device="cpu"))
        from paddle_tpu_torch import static

        def static_run():
            prog = static.Program()
            with static.program_guard(prog):
                x = static.data("x", [2], "float32")
            static.Executor().run(prog, feed={"x": [1.0, 2.0]},
                                  fetch_list=[x])
        for make in (static_run, lambda: ServingEngine(model),
                     lambda: GPTModel(gpt_tiny_config()),
                     lambda: ErnieMoeModel(ernie_moe_tiny_config()),
                     lambda: PagePool(4, 4, 1, 1, 4),
                     lambda: paddle_tpu_torch.vision.models.resnet18()):
            try:
                make()
            except RuntimeError as e:
                assert "CUDA" in str(e), e
            else:
                raise AssertionError("ran on the CPU without device='cpu'")
    print("MODULES", len(names))
""")


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    if torch.cuda.is_available():
        assert resolve_device("gpu").type == "cuda"
        assert resolve_device(None) == resolve_device("cuda")
    else:
        for name in (None, "gpu", "cuda", "cuda:0", "gpu:0"):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                resolve_device(name)


def test_port_imports_no_jax_and_never_falls_back_to_cpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    n = int(out.stdout.split("MODULES")[1])
    assert n >= 46
