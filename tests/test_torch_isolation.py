"""The port imports nothing of JAX, flax, optax, orbax or the JAX package.

A fresh interpreter imports every module of ``sylph_tpu_torch`` and
``chip_smoke`` (without running its ``main``) and then inspects
``sys.modules``.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, json, pkgutil, sys
import sylph_tpu_torch
names = ["sylph_tpu_torch", "chip_smoke"] + [
    m.name for m in pkgutil.walk_packages(sylph_tpu_torch.__path__,
                                          "sylph_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                    "sylph_tpu"))
print(json.dumps({"imported": names, "bad": bad}))
"""


def test_port_imports_no_jax_and_no_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["bad"] == []
    expected = {"sylph_tpu_torch.predictor", "sylph_tpu_torch.runner",
                "sylph_tpu_torch.ops.nms_kernel",
                "sylph_tpu_torch.models.meta_arch",
                "sylph_tpu_torch.utils.convert_weights",
                "sylph_tpu_torch.evaluation.meta_eval",
                "sylph_tpu_torch.data.loader",
                "sylph_tpu_torch.ops.image_ops", "chip_smoke",
                "sylph_tpu_torch.ops.losses", "sylph_tpu_torch.ops.assigner",
                "sylph_tpu_torch.ops.fcos_losses",
                "sylph_tpu_torch.ops.image_aug",
                "sylph_tpu_torch.train.optimizer",
                "sylph_tpu_torch.train.train_state",
                "sylph_tpu_torch.train.steps",
                "sylph_tpu_torch.train.checkpoint",
                "sylph_tpu_torch.utils.events",
                "sylph_tpu_torch.data.samplers",
                "sylph_tpu_torch.tools.train_net",
                "sylph_tpu_torch.models.roi_encoder",
                "sylph_tpu_torch.ops.deform_conv",
                "sylph_tpu_torch.utils.convert_d2",
                "sylph_tpu_torch.evaluation.visualization",
                "sylph_tpu_torch.tools.demo_inference",
                "sylph_tpu_torch.parallel", "sylph_tpu_torch.parallel.mesh",
                "sylph_tpu_torch.tools.bench_registration",
                "sylph_tpu_torch.tools.quality_loop",
                "sylph_tpu_torch.tools.nms_audit",
                "sylph_tpu_torch.tools.quality_seeds",
                "sylph_tpu_torch.entry", "sylph_tpu_torch.tools.bench",
                "sylph_tpu_torch.tools.bench_common",
                "sylph_tpu_torch.tools.bench_stage_breakdown",
                "sylph_tpu_torch.tools.bench_train",
                "sylph_tpu_torch.tools.bench_pretrain_accum",
                "sylph_tpu_torch.tools.bf16_fidelity_probe",
                "sylph_tpu_torch.tools.bench_backbone_exp",
                "sylph_tpu_torch.tools.bench_int8_probe",
                "sylph_tpu_torch.tools.convert_checkpoint",
                "sylph_tpu_torch.tools.visualize_class_codes",
                "sylph_tpu_torch.tools.visualize_result"}
    assert expected <= set(report["imported"])
