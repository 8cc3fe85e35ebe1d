"""The port's benchmark and probe drivers on the CPU at a tiny size.

Each of ``sylph_tpu_torch/tools/{bench_stage_breakdown, bench_train,
bench_pretrain_accum, bf16_fidelity_probe, bench_backbone_exp,
bench_int8_probe}.py`` runs at depth 18 on small canvases and returns its
JAX original's JSON keys (the port's additions beside them). The int8
``pack`` gives the JAX probe's int8 values and scales exactly on converted
weights (OIHW here, HWIO there), and ``unpack`` its bf16 kernels. ``bench_backbone_exp --variant lhs`` (an XLA
flag) raises, ``bench_train --steps-per-call 2`` runs, and every new entry
point refuses a card it does not have.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sylph_tpu.models.meta_arch import MetaOneStageDetector as JaxDetector
from sylph_tpu_torch import entry
from sylph_tpu_torch.tools import (bench, bench_backbone_exp,
                                   bench_int8_probe, bench_pretrain_accum,
                                   bench_stage_breakdown, bench_train,
                                   bf16_fidelity_probe)
from sylph_tpu_torch.tools.bench_common import store_params
from sylph_tpu_torch.utils.convert_weights import state_dict_from_jax

from torch_port_util import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(depth=18, canvas=(128, 256))

# tool -> (its run at a tiny size, the JAX original's JSON keys)
TOOLS = {
    # tools/bench_stage_breakdown.py:94-103
    "stage_breakdown": (
        lambda: bench_stage_breakdown.run("cpu", batch=2, iters=1, **SMALL),
        {"residency", "batch", "canvas", "backbone_fpn_ms",
         "towers_cond_head_ms", "decode_nms_ms", "total_ms", "img_per_sec"}),
    "stage_breakdown_f32": (
        lambda: bench_stage_breakdown.run("cpu", batch=2, iters=1, f32=True,
                                          **SMALL),
        {"residency", "batch", "canvas", "backbone_fpn_ms",
         "towers_cond_head_ms", "decode_nms_ms", "total_ms", "img_per_sec"}),
    # tools/bench_train.py:113-124
    "train": (
        lambda: bench_train.run("cpu", episodes=2, shot=2, canvas=128,
                                iters=1, depth=18),
        {"metric", "value", "unit", "extra"}),
    # tools/bf16_fidelity_probe.py:82-89
    "bf16_fidelity": (
        lambda: bf16_fidelity_probe.run("cpu", batch=2, **SMALL),
        {"logit_delta", "prob_delta", "reg_delta_px", "decoded_score_delta",
         "logit_range"}),
    # tools/bench_backbone_exp.py:100-106 (``xla_flags`` is None: no XLA)
    "backbone_baseline": (
        lambda: bench_backbone_exp.run("cpu", "baseline", batch=2, iters=1,
                                       **SMALL),
        {"variant", "batch", "img_per_sec", "ms_per_batch", "xla_flags"}),
    "backbone_bf16_params": (
        lambda: bench_backbone_exp.run("cpu", "bf16_params", batch=2,
                                       iters=1, **SMALL),
        {"variant", "batch", "img_per_sec", "ms_per_batch", "xla_flags"}),
    # tools/bench_int8_probe.py:114-123
    "int8": (
        lambda: bench_int8_probe.run("cpu", batch=2, iters=1, **SMALL),
        {"batch", "bf16_ms", "bf16_ms_repeat", "int8_ms", "bf16_img_s",
         "int8_img_s", "max_logit_delta", "logit_range"}),
}
TRAIN_EXTRA = {"sec_per_step", "images_per_step", "images_per_sec",
               "canvas", "shot", "steps_per_call", "devices"}
# tools/bench_pretrain_accum.py:100-119 (XLA's ``memory`` report and
# ``compile_plus_first_s`` become ``peak_allocated_gb`` on a card and
# ``first_step_s``)
ACCUM_ROW = {"grad_accum", "micro_batch", "remat", "first_step_s",
             "sec_per_iter", "sec_per_iter_median", "img_per_sec",
             "loss_cls"}


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_tool_line_has_the_originals_keys(tool):
    run, keys = TOOLS[tool]
    line = run()
    assert keys <= set(line), keys - set(line)
    assert line.get("device", line.get("extra", {}).get("device")) == "cpu"
    if tool == "train":
        assert TRAIN_EXTRA <= set(line["extra"])
        assert line["metric"] == "episodic_train_episodes_per_sec"
        assert all(np.isfinite(v) for v in line["extra"]["losses"].values())
    if tool.startswith("stage_breakdown"):
        assert line["residency"] == ("f32" if tool.endswith("f32")
                                     else "bf16")
    if tool == "int8":
        assert line["int8_kernels"] > 0 and line["max_logit_delta"] > 0


def test_bf16_weights_cost_nothing_in_bf16_activations():
    """The port's bf16 path already rounds every weight to bf16 where it
    uses it, so rounding the stored weights changes no output."""
    line = bf16_fidelity_probe.run("cpu", batch=2, **SMALL)
    for key in ("logit_delta", "reg_delta_px", "decoded_score_delta"):
        assert line[key]["max"] == 0.0, (key, line[key])


def test_bf16_held_parameters_generate_codes():
    """bench.py's code paths run after the parameters are held in bf16 (on
    a card); the code generator's float32 GroupNorm then meets bf16
    parameters, and gives the codes of the float32-held model."""
    model, _, _ = bench.build_query_path("cpu", depth=18, canvas=(128, 256),
                                         batch=1, n_classes=2, bank_size=64)
    sup, boxes, valid = bench.code_inputs(2, (64, 64), "cpu", classes=2)
    with torch.inference_mode():
        want = model.forward_class_code(sup, boxes, valid, 2, False)
        store_params(model)
        got = model.forward_class_code(sup, boxes, valid, 2, False)
    for key in ("cls_conv", "cls_bias"):
        assert got[key].shape == want[key].shape == (2, *want[key].shape[1:])
        torch.testing.assert_close(got[key].float(), want[key].float(),
                                   rtol=0.05, atol=0.05)


@pytest.mark.parametrize("remat", [False, True])
def test_pretrain_accum_rows(remat, capsys):
    rows = bench_pretrain_accum.sweep("cpu", batch=4, canvas=(96, 96),
                                      accum=(2, 3, 4), remat=remat, iters=1,
                                      depth=18)
    assert [r["grad_accum"] for r in rows] == [2, 4]   # 3 does not divide
    for row in rows:
        assert ACCUM_ROW <= set(row) and row["remat"] == remat
        assert row["micro_batch"] == 4 // row["grad_accum"]
        assert np.isfinite(row["loss_cls"])
    assert len(capsys.readouterr().out.strip().splitlines()) == 2


def _jax_pack(x):
    """tools/bench_int8_probe.py:57-64, on an HWIO kernel."""
    x = jnp.asarray(x)
    if x.ndim == 4 and x.shape[-1] >= 8:
        s = jnp.max(jnp.abs(x), axis=(0, 1, 2), keepdims=True)
        s = jnp.maximum(s, 1e-8) / 127.0
        q = jnp.clip(jnp.round(x / s), -127, 127).astype(jnp.int8)
        return {"_q": q, "_s": s.astype(jnp.float32)}
    return x.astype(jnp.bfloat16)


def _jax_unpack(x):
    """tools/bench_int8_probe.py:66-70."""
    return x["_q"].astype(jnp.bfloat16) * x["_s"].astype(jnp.bfloat16)


def test_int8_pack_equals_jax_on_converted_weights():
    jmodel = JaxDetector(depth=18, num_classes=60)
    params = jax.jit(lambda r: jmodel.init(
        r, jnp.zeros((1, 128, 128, 3)),
        method=JaxDetector.forward_base))(jax.random.PRNGKey(0))["params"]
    params = jax.tree.map(np.asarray, params)
    sd = state_dict_from_jax(params)
    packed = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        if path[-1].key != "kernel" or leaf.ndim != 4:
            continue
        name = ".".join(str(p.key) for p in path[:-1]) + ".weight"
        want = _jax_pack(leaf)
        got = bench_int8_probe.pack(sd[name])
        if not isinstance(want, dict):
            assert not isinstance(got, tuple), name
            continue
        q, s = got
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.permute(2, 3, 1, 0).numpy(),
                                      np.asarray(want["_q"]), err_msg=name)
        np.testing.assert_array_equal(s.reshape(-1).numpy(),
                                      np.asarray(want["_s"]).reshape(-1),
                                      err_msg=name)
        np.testing.assert_array_equal(
            bench_int8_probe.unpack(got).permute(2, 3, 1, 0).float().numpy(),
            np.asarray(_jax_unpack(want), np.float32), err_msg=name)
        packed += 1
    assert packed >= 20


@pytest.mark.parametrize("call,match", [
    pytest.param(lambda: bench_backbone_exp.run("cpu", "lhs"), "no port",
                 id="<lambda>-no port0"),
    pytest.param(lambda: bench_train.run("cpu", episodes=2, shot=2,
                                         canvas=128, iters=1, depth=18,
                                         steps_per_call=2),
                 None, id="<lambda>-no port1"),
])
def test_tpu_workaround_options_raise(call, match):
    """``--variant lhs`` names an XLA scheduler flag and still raises;
    ``--steps-per-call 2`` runs two optimizer steps a call and reports
    it, as the JAX driver does."""
    if match is None:
        line = call()
        assert line["extra"]["steps_per_call"] == 2
        assert all(np.isfinite(v) for v in line["extra"]["losses"].values())
        return
    with pytest.raises(NotImplementedError, match=match):
        call()


ENTRY_POINTS = {
    "bench": lambda: bench.run(),
    "entry": lambda: entry.entry(),
    "stage_breakdown": lambda: bench_stage_breakdown.run(),
    "train": lambda: bench_train.run(),
    "pretrain_accum": lambda: bench_pretrain_accum.sweep(),
    "bf16_fidelity": lambda: bf16_fidelity_probe.run(),
    "backbone_exp": lambda: bench_backbone_exp.run(),
    "int8": lambda: bench_int8_probe.run(),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_refuse_a_missing_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is real")
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        ENTRY_POINTS[name]()


def test_drivers_run_as_modules_on_the_cpu_only_when_asked():
    """``python3 -m`` of a driver without ``--device cpu`` raises on a
    machine without a card; the CLI names the flag."""
    import subprocess
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "sylph_tpu_torch.tools.bench_backbone_exp"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "device='cpu'" in proc.stderr
