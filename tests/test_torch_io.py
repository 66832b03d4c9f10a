"""The port's ``paddle.save``/``paddle.load`` and the engines'
``from_checkpoint`` against the JAX package's.

Round trips (f32, bf16, int64, nested, an LR scheduler's state, a
Parameter), the integrity checks (truncation, a changed byte, a file
pickle cannot read: each ``CheckpointCorruptError``; no temporary file
left), files written by ``paddle_tpu.save`` read by the port (bf16 too,
and without ``ml_dtypes`` a clear error), and ``from_checkpoint`` of tiny
GPT (both key forms, f32 and int8) and tiny ERNIE-MoE: greedy tokens
exactly equal to an engine built from the model and to the JAX engine's
``from_checkpoint`` on the same file (``autofuse=False``, as the other
serving oracles run it). Round-tripped values are bit-equal.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.models import ernie as jernie
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.serving import MoEServingEngine as JMoEEngine
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu_torch.framework import place as tplace
from paddle_tpu_torch.framework.io import CheckpointCorruptError
from paddle_tpu_torch.models import ernie as ternie
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models.convert import (ernie_moe_state_dict_from_numpy,
                                             gpt_state_dict_from_numpy)
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.serving import MoEServingEngine, ServingEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cpu_place():
    prev = tplace._current_place
    tp.set_device("cpu")
    yield
    tplace._current_place = prev


def _leftovers(d):
    return sorted(f for f in os.listdir(d) if ".tmp." in f)


# ---------------------------------------------------------------- round trips

def test_round_trips(tmp_path):
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((3, 4)).astype(np.float32)
    i64 = rng.integers(-5, 5, (6,)).astype(np.int64)
    bf = tp.to_tensor(f32, dtype="bfloat16")
    param = tp.Parameter(f32, name="w0")
    sched = tlr.StepDecay(0.1, step_size=3, gamma=0.5)
    for _ in range(4):
        sched.step()
    state = {"f32": tp.to_tensor(f32), "i64": tp.to_tensor(i64), "bf": bf,
             "raw": torch.tensor(f32), "param": param,
             "nested": {"list": [tp.to_tensor(i64), 3, "s"],
                        "tuple": (tp.to_tensor(f32), None)},
             "sched": sched}
    path = str(tmp_path / "ck" / "state.pdparams")
    tp.save(state, path)
    assert os.path.exists(path + ".sha256")
    assert _leftovers(tmp_path / "ck") == []
    got = tp.load(path)
    assert got["f32"].dtype == tp.float32
    np.testing.assert_array_equal(got["f32"].numpy(), f32)
    assert got["i64"].dtype == tp.int64
    np.testing.assert_array_equal(got["i64"].numpy(), i64)
    assert got["bf"].dtype == tp.bfloat16
    assert torch.equal(got["bf"]._value, bf._value)
    np.testing.assert_array_equal(got["raw"].numpy(), f32)
    assert isinstance(got["param"], tp.Parameter)
    assert got["param"].name == "w0" and not got["param"].stop_gradient
    np.testing.assert_array_equal(got["nested"]["list"][0].numpy(), i64)
    assert got["nested"]["list"][1:] == [3, "s"]
    assert isinstance(got["nested"]["tuple"], tuple)
    assert got["nested"]["tuple"][1] is None
    assert got["sched"]["__lr_scheduler__"] == "StepDecay"
    restored = tlr.StepDecay(0.1, step_size=3, gamma=0.5)
    restored.set_state_dict(got["sched"]["state"])
    assert restored() == sched() and restored.last_epoch == 4
    assert got["f32"].place == tp.CPUPlace()
    arrays = tp.load(path, return_numpy=True)
    assert isinstance(arrays["f32"], np.ndarray)
    np.testing.assert_array_equal(arrays["i64"], i64)
    assert arrays["bf"].dtype.name == "bfloat16"      # ml_dtypes is here
    np.testing.assert_array_equal(arrays["bf"].astype(np.float32),
                                  bf.astype("float32").numpy())


def test_corrupt_files_raise(tmp_path):
    t = tp.to_tensor(np.arange(1000, dtype=np.float32))
    path = str(tmp_path / "a.pdparams")
    tp.save({"t": t}, path)
    raw = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(raw[:-10])                      # truncated
    with pytest.raises(CheckpointCorruptError, match="truncated") as e:
        tp.load(path)
    assert e.value.expected_bytes == len(raw)
    with open(path, "wb") as f:                 # one byte changed
        f.write(raw[:100] + bytes([raw[100] ^ 1]) + raw[101:])
    with pytest.raises(CheckpointCorruptError, match="sha256"):
        tp.load(path)
    # without the sidecar, a truncated pickle is still caught
    os.unlink(path + ".sha256")
    with open(path, "wb") as f:
        f.write(raw[:len(raw) // 2])
    with pytest.raises(CheckpointCorruptError, match="unpicklable"):
        tp.load(path)
    with pytest.raises(FileNotFoundError):
        tp.load(str(tmp_path / "missing.pdparams"))
    # checksum off: no sidecar, and a stale one is removed
    tp.save({"t": t}, path)
    tp.save({"t": t}, path, checksum=False)
    assert not os.path.exists(path + ".sha256")
    np.testing.assert_array_equal(tp.load(path)["t"].numpy(), t.numpy())
    assert _leftovers(tmp_path) == []


def test_failed_save_leaves_no_temporary_file(tmp_path):
    class Unpicklable:
        def __reduce__(self):
            raise RuntimeError("no")
    path = str(tmp_path / "b.pdparams")
    tp.save({"a": tp.to_tensor([1.0])}, path)
    before = open(path, "rb").read()
    with pytest.raises(RuntimeError, match="no"):
        tp.save({"a": Unpicklable()}, path)
    assert _leftovers(tmp_path) == []
    assert open(path, "rb").read() == before     # the old file stands


# ------------------------------------------------------- the JAX package's files

def test_reads_files_the_jax_package_wrote(tmp_path):
    rng = np.random.default_rng(1)
    f32 = rng.standard_normal((2, 3)).astype(np.float32)
    i64 = np.arange(4, dtype=np.int64)
    from paddle_tpu.optimizer import lr as jlr
    sched = jlr.StepDecay(0.1, step_size=3, gamma=0.5)
    for _ in range(4):
        sched.step()
    path = str(tmp_path / "jax.pdparams")
    jbf = jp.to_tensor(f32, dtype="bfloat16")
    jp.save({"f32": jp.to_tensor(f32), "i64": jp.to_tensor(i64),
             "bf": jbf, "param": jp.framework.Parameter(f32, name="w"),
             "nested": [jp.to_tensor(i64), (1, 2)], "sched": sched}, path)
    got = tp.load(path)
    np.testing.assert_array_equal(got["f32"].numpy(), f32)
    assert got["i64"].dtype == tp.int64
    np.testing.assert_array_equal(got["nested"][0].numpy(), i64)
    assert got["nested"][1] == (1, 2)
    assert isinstance(got["param"], tp.Parameter)
    assert got["bf"].dtype == tp.bfloat16
    np.testing.assert_array_equal(got["bf"].astype("float32").numpy(),
                                  np.asarray(jbf.astype("float32")._value))
    assert got["sched"]["state"] == sched.state_dict()
    arrays = tp.load(path, return_numpy=True)
    np.testing.assert_array_equal(arrays["f32"], f32)
    # any other name of the JAX package is refused
    bad = str(tmp_path / "dtype.pdparams")
    jp.save({"d": jp.float32}, bad)
    with pytest.raises(CheckpointCorruptError, match="refusing paddle_tpu"):
        tp.load(bad)


_NO_ML_DTYPES = textwrap.dedent("""
    import sys
    sys.modules["ml_dtypes"] = None          # as on a machine without it
    import numpy as np
    import paddle_tpu_torch as tp
    from paddle_tpu_torch.framework.io import CheckpointCorruptError
    tp.set_device("cpu")
    path = sys.argv[1]
    try:
        tp.load(path)
    except CheckpointCorruptError as e:
        assert "ml_dtypes" in str(e), e
        print("REFUSED")
    own = path + ".port"
    tp.save({"bf": tp.to_tensor([1.5, -2.0], dtype="bfloat16")}, own)
    back = tp.load(own)["bf"]
    assert back.dtype == tp.bfloat16
    assert back.astype("float32").numpy().tolist() == [1.5, -2.0]
    try:
        back.numpy()
    except TypeError as e:
        assert "ml_dtypes" in str(e)
        print("NO_NUMPY")
""")


def test_jax_bf16_file_without_ml_dtypes_is_refused(tmp_path):
    path = str(tmp_path / "bf.pdparams")
    jp.save({"bf": jp.to_tensor([1.0, 2.0], dtype="bfloat16")}, path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _NO_ML_DTYPES, path],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "REFUSED" in out.stdout and "NO_NUMPY" in out.stdout


def test_no_card_no_cpu_place_raises():
    tplace._current_place = None          # the default: the card
    if torch.cuda.is_available():
        assert tp.to_tensor([1.0]).place == tp.CUDAPlace(0)
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.to_tensor([1.0])
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.zeros([2])
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.set_device("gpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine.from_checkpoint(__file__, tgpt.gpt_tiny_config())


# ------------------------------------------------------------ from_checkpoint

def _gpt_models(seed=5):
    jp.seed(seed)
    cfg = jgpt.gpt_tiny_config()
    jmodel = jgpt.GPTForPretraining(jgpt.GPTModel(cfg))
    state = {k: np.asarray(v._value) for k, v in jmodel.state_dict().items()}
    tmodel = tgpt.GPTForPretraining(tgpt.GPTModel(tgpt.gpt_tiny_config(),
                                                  device="cpu"))
    tmodel.load_state_dict(gpt_state_dict_from_numpy(state), strict=True)
    return jmodel, tmodel


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (s,)).astype(np.int32) for s in lens]


def _greedy(eng, prompts, n=5):
    """Each prompt alone: prefill, then ``n - 1`` bucket-1 decodes."""
    out = []
    for sid, p in enumerate(prompts):
        toks = [int(eng.prefill(sid, p))]
        for _ in range(n - 1):
            eng.pool.extend(sid, 1)
            toks.append(int(np.asarray(eng.decode([sid], bucket=1))[0]))
        eng.pool.free(sid)
        out.append(toks)
    return out


_GPT_KW = dict(page_size=8, decode_buckets=(1,), prefill_buckets=(16, 64),
               max_seq_len=64)


@pytest.mark.parametrize("keys,quantize", [("full", None), ("bare", None),
                                           ("full", "int8")])
def test_gpt_from_checkpoint_matches_model_and_jax(tmp_path, keys, quantize):
    jmodel, tmodel = _gpt_models()
    target = jmodel if keys == "full" else jmodel.gpt
    path = str(tmp_path / "gpt.pdparams")
    jp.save(target.state_dict(), path)
    prompts = _prompts(tmodel.gpt.config.vocab_size, (5, 11), seed=2)
    kw = dict(_GPT_KW, quantize=quantize)
    from_file = ServingEngine.from_checkpoint(path, tmodel.gpt.config,
                                              device="cpu", **kw)
    built = ServingEngine(tmodel, device="cpu", **kw)
    jeng = JEngine.from_checkpoint(path, jmodel.gpt.config, autofuse=False,
                                   aot=False, **kw)
    got = _greedy(from_file, prompts)
    assert got == _greedy(built, prompts)
    assert got == _greedy(jeng, prompts)
    assert from_file.quantize == quantize


def test_gpt_from_a_port_written_checkpoint(tmp_path):
    _, tmodel = _gpt_models(seed=6)
    path = str(tmp_path / "port.pdparams")
    tp.save(tmodel.state_dict(), path)
    prompts = _prompts(tmodel.gpt.config.vocab_size, (7,), seed=1)
    eng = ServingEngine.from_checkpoint(path, tmodel.gpt.config,
                                        device="cpu", **_GPT_KW)
    assert _greedy(eng, prompts) == _greedy(
        ServingEngine(tmodel, device="cpu", **_GPT_KW), prompts)


def _moe_cfg(mod):
    return mod.ernie_moe_tiny_config(
        num_hidden_layers=2, hidden_size=32, num_attention_heads=2,
        intermediate_size=64, num_experts=4, capacity_factor=100.0,
        max_position_embeddings=64)


_MOE_KW = dict(page_size=8, decode_buckets=(1,), prefill_buckets=(16, 64))


def test_moe_from_checkpoint_matches_model_and_jax(tmp_path):
    jp.seed(0)
    jmodel = jernie.ErnieMoeForPretraining(
        jernie.ErnieMoeModel(_moe_cfg(jernie)))
    jmodel.eval()
    state = {k: np.asarray(v._value) for k, v in jmodel.state_dict().items()}
    tmodel = ternie.ErnieMoeForPretraining(
        ternie.ErnieMoeModel(_moe_cfg(ternie), device="cpu"))
    tmodel.load_state_dict(ernie_moe_state_dict_from_numpy(state),
                           strict=True)
    tmodel.eval()
    path = str(tmp_path / "moe.pdparams")
    jp.save(jmodel.state_dict(), path)
    prompts = _prompts(1024, (6, 13), seed=4)
    cfg = _moe_cfg(ternie)
    from_file = MoEServingEngine.from_checkpoint(path, cfg, device="cpu",
                                                 **_MOE_KW)
    got = _greedy(from_file, prompts)
    assert got == _greedy(MoEServingEngine(tmodel, device="cpu", **_MOE_KW),
                          prompts)
    jeng = JMoEEngine.from_checkpoint(path, _moe_cfg(jernie), autofuse=False,
                                      aot=False, **_MOE_KW)
    assert got == _greedy(jeng, prompts)
    # the port's own state dict (the tied embedding under both names)
    own = str(tmp_path / "moe_port.pdparams")
    tp.save(tmodel.state_dict(), own)
    assert _greedy(MoEServingEngine.from_checkpoint(
        own, cfg, device="cpu", **_MOE_KW), prompts) == got
    # bare ErnieMoeModel keys: the head keeps a fresh seed-0 model's
    bare = str(tmp_path / "moe_bare.pdparams")
    tp.save(tmodel.ernie.state_dict(), bare)
    fresh = ternie.ErnieMoeForPretraining(
        ternie.ErnieMoeModel(cfg, device="cpu"))
    fresh.ernie.load_state_dict(tmodel.ernie.state_dict())
    fresh.eval()
    assert _greedy(MoEServingEngine.from_checkpoint(
        bare, cfg, device="cpu", **_MOE_KW), prompts) == _greedy(
        MoEServingEngine(fresh, device="cpu", **_MOE_KW), prompts)


def test_from_checkpoint_rejects_a_foreign_state(tmp_path):
    path = str(tmp_path / "x.pdparams")
    tp.save({"w": tp.to_tensor([1.0])}, path)
    with pytest.raises(ValueError):
        ServingEngine.from_checkpoint(path, tgpt.gpt_tiny_config(),
                                      device="cpu")
    with pytest.raises(ValueError):
        MoEServingEngine.from_checkpoint(path, _moe_cfg(ternie),
                                         device="cpu")
    with open(path, "wb") as f:
        pickle.dump({"w": 1}, f)
    os.unlink(path + ".sha256")
    with pytest.raises(ValueError):
        ServingEngine.from_checkpoint(path, tgpt.gpt_tiny_config(),
                                      device="cpu")
