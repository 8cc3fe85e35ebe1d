"""The ``tfa_rcnn`` quality recipe at several SEEDs in both packages, on one
machine: the evidence that tells a seed sample from a fault when the port's
novel-class AP misses the band drawn around JAX's one recorded run.

``tools/quality_loop_variants.py`` has no seed flag, so the JAX recipe gets
its SEED by wrapping ``build_tfa_rcnn_pretrain_cfg`` and
``build_tfa_rcnn_finetune_cfg``: each stage's config is built as the driver
builds it, then ``SEED`` is set before the driver freezes it. The port's
driver takes ``args.seed`` (``sylph_tpu_torch/tools/quality_seeds.py``).

The full recipe (128², 400 + 400 iterations, fp32) runs on the CPU, one
package at a time, as a script:

    python tests/test_torch_f3_seed_spread.py --package jax --seed 1 \
        --data-root /tmp/f3/data --output-dir /tmp/f3/jax1
    python tests/test_torch_f3_seed_spread.py --package port --seed 1 \
        --data-root /tmp/f3/data --output-dir /tmp/f3/port1

(``--mask-frozen-bn`` holds JAX's bottleneck FrozenBN constant, as the port
keeps it.) Each run prints one JSON line: the seed, the package, nAP, AP,
bAP, the base stage's AP and the wall time. JAX runs on one CPU device, as
the record ran on one chip. The ``slow`` test runs both packages at a seed
through the script; the quick one checks that the wrapper sets SEED in both
stages' dumped ``config.yaml``.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
STAGES = ("pretrain", "finetune")


def seeded(build, seed):
    """``build`` with ``cfg.SEED = seed`` set on the config it returns."""
    def build_seeded(*args, **kwargs):
        cfg = build(*args, **kwargs)
        cfg.SEED = seed
        return cfg
    return build_seeded


def patch_jax_recipe(mp, seed, mask_frozen_bn=False):
    """The JAX driver's two ``tfa_rcnn`` config builders wrapped to set
    ``seed``; with ``mask_frozen_bn``, JAX's optimizer masked so the
    bottleneck FrozenBN stays constant (tests/torch_port_util.py::jax_tx).
    -> the driver module."""
    if TOOLS not in sys.path:
        sys.path.insert(0, TOOLS)
    import quality_loop_variants as ql
    for name in ("build_tfa_rcnn_pretrain_cfg",
                 "build_tfa_rcnn_finetune_cfg"):
        mp.setattr(ql, name, seeded(getattr(ql, name), seed))
    if mask_frozen_bn:
        from sylph_tpu.runner import meta_fcos_runner
        from torch_port_util import jax_tx

        def build_optimizer(params, **kw):
            from sylph_tpu.train import optimizer as jopt
            _, schedule = jopt.build_optimizer(params, **kw)
            return jax_tx(params, kw), schedule

        mp.setattr(meta_fcos_runner, "build_optimizer", build_optimizer)
    return ql


def jax_args(data_root, output_dir, iters):
    """The namespace ``quality_loop_variants.main`` parses for
    ``--family tfa_rcnn --cpu``."""
    return SimpleNamespace(
        family="tfa_rcnn", hard=False, repeat_test=0, ref_depth=False,
        grad_accum=0, ref_world=0, data_root=data_root,
        output_dir=output_dir, iters=iters, lr=0.01, cpu=True)


def summary(seed, package, results, wall_s):
    bbox = results["coco_pretrain_val_all"]["bbox"]
    return {"seed": seed, "package": package, "nAP": bbox["nAP"],
            "AP": bbox["AP"], "bAP": bbox["bAP"],
            "base_AP": results["base_pretrain"]["bbox"]["AP"],
            "wall_s": wall_s}


def run_jax(seed, data_root, output_dir, iters=400, mask_frozen_bn=False):
    """JAX's ``run_tfa_rcnn`` at ``seed``, as ``main`` runs it (the
    learnable set written when missing, the catalog registered,
    ``eval_results.json`` written). -> ``summary``."""
    from sylph_tpu.data.catalog import register_all_coco
    from sylph_tpu.data.synthetic import make_learnable_coco

    t0 = time.perf_counter()
    with pytest.MonkeyPatch.context() as mp:
        ql = patch_jax_recipe(mp, seed, mask_frozen_bn)
        if not os.path.exists(os.path.join(data_root, "annotations")):
            make_learnable_coco(data_root, n_train=80, n_val=16,
                                img_hw=(128, 128), n_empty_val=2)
        register_all_coco(data_root)
        os.makedirs(output_dir, exist_ok=True)
        results = ql.run_tfa_rcnn(jax_args(data_root, output_dir, iters))
    with open(os.path.join(output_dir, "eval_results.json"), "w") as f:
        json.dump(results, f, indent=2, default=float)
    return summary(seed, "jax", results, time.perf_counter() - t0)


def run_port(seed, data_root, output_dir, iters=400):
    """The port's ``tfa_rcnn`` at ``seed`` on the CPU. -> ``summary``."""
    from sylph_tpu_torch.tools import quality_loop

    args = quality_loop.parse_args(
        ["--family", "tfa_rcnn", "--iters", str(iters), "--device", "cpu",
         "--data-root", data_root, "--output-dir", output_dir])
    args.seed = seed
    t0 = time.perf_counter()
    results = quality_loop.run(args)
    return summary(seed, "port", results, time.perf_counter() - t0)


# ------------------------------------------------------------------ tests
class _Results(dict):
    def __missing__(self, key):
        return {"bbox": {"AP": 0.0, "nAP": 0.0, "bAP": 0.0}}


def _stub_jax_runners(mp):
    from sylph_tpu.runner import meta_faster_rcnn_runner as jrcnn

    for cls in (jrcnn.MetaFasterRCNNRunner, jrcnn.TFAFasterRCNNRunner):
        mp.setattr(cls, "build_model", lambda self, cfg: (None, {}))
        mp.setattr(cls, "do_train",
                   lambda self, cfg, model, params: (None, None))
        mp.setattr(cls, "do_test",
                   lambda self, cfg, model, params, **kw: _Results())
        mp.setattr(cls, "eval_params", lambda self, cfg, state: {})


def test_seed_reaches_both_stages_config(tmp_path):
    """SEED 3 lands in the dumped ``config.yaml`` of the JAX recipe's
    pretrain and finetune stage (the runners stubbed out: no model is
    built). The port's driver sets ``args.seed`` the same way
    (tests/test_torch_quality_loop.py::test_stage_time_parts_and_seed)."""
    out = str(tmp_path / "out")
    os.makedirs(out)
    with pytest.MonkeyPatch.context() as mp:
        _stub_jax_runners(mp)
        ql = patch_jax_recipe(mp, 3)
        ql.run_tfa_rcnn(jax_args(str(tmp_path / "data"), out, 400))
    for stage in STAGES:
        with open(os.path.join(out, stage, "config.yaml")) as f:
            dumped = yaml.safe_load(f)
        assert dumped["SEED"] == 3, stage
        assert dumped["SOLVER"]["MAX_ITER"] == 400, stage


@pytest.mark.slow
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tfa_rcnn_at_a_seed_in_both_packages(tmp_path, seed):
    """The full recipe at ``seed`` in JAX, then in the port, each in a
    fresh interpreter (JAX on one CPU device); both detect novel classes
    (nAP above 0). SYLPH_TEST_MODE is left out: it would cut the val set."""
    data = str(tmp_path / "data")
    env = {k: v for k, v in os.environ.items() if k != "SYLPH_TEST_MODE"}
    lines = []
    # The port's CPU steps take seconds each: 9229 s a seed on an 8-core
    # CPU against JAX's ~1300 s.
    for package, limit_s in (("jax", 3600), ("port", 4 * 3600)):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--package",
             package, "--seed", str(seed), "--data-root", data,
             "--output-dir", str(tmp_path / package)],
            capture_output=True, text=True, cwd=REPO, env=env,
            timeout=limit_s)
        assert proc.returncode == 0, proc.stderr[-4000:]
        lines.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    print(json.dumps(lines))
    for line in lines:
        assert line["nAP"] > 0, line


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--package", choices=["jax", "port"], required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--data-root", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--iters", type=int, default=400)
    p.add_argument("--mask-frozen-bn", action="store_true",
                   help="jax only: keep the bottleneck FrozenBN constant")
    ns = p.parse_args(argv)
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    if ns.package == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        line = run_jax(ns.seed, ns.data_root, ns.output_dir, ns.iters,
                       ns.mask_frozen_bn)
    else:
        line = run_port(ns.seed, ns.data_root, ns.output_dir, ns.iters)
    line["mask_frozen_bn"] = ns.mask_frozen_bn
    print(json.dumps(line, default=float), flush=True)


if __name__ == "__main__":
    main()
