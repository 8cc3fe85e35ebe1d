"""CLI: train, then meta-test, a model with the port on one card or on N
(port of the JAX package's tools/train_net.py).

    python3 -m sylph_tpu_torch.tools.train_net [--runner MetaFCOSRunner] \
        --config-file sylph://COCO-Detection/Meta-FCOS/Meta-FCOS-finetune.yaml \
        [--eval-only] [--output-dir DIR] [--datasets-root datasets/coco] \
        [--lvis-root datasets/lvis] [--device cuda] [KEY VALUE ...]

On N cards, one process per card, through torchrun (it ships with torch):

    python3 -m torch.distributed.run --standalone --nproc_per_node N \
        -m sylph_tpu_torch.tools.train_net --distributed [--dist-url URL] ...

``--distributed`` builds the data-parallel group from torchrun's
environment (``parallel.mesh.create_mesh``: NCCL on the cards, gloo with
``--device cpu``); ``--dist-url`` replaces torchrun's rendezvous with
another, e.g. a ``file://`` store, where RANK and WORLD_SIZE are set by
hand.

``--runner`` takes MetaFCOSRunner, MetaFasterRCNNRunner (with the
LVISv1-Detection/Meta-RCNN configs) or TFAFasterRCNNRunner.
``auto_scale_world_size`` emulates the config's REFERENCE_WORLD_SIZE ranks
on the group's ranks with TPU.GRAD_ACCUM micro-groups on each (batch, LR
and schedule unchanged) where the batch divides, as the JAX package does on
its device count. ``config.yaml``, ``config_diff.yaml`` (against the
runner's defaults) and ``env.txt`` go into OUTPUT_DIR first; rank 0 writes
them, the synthetic trees, checkpoints, metrics and
``eval_results.json``. SYLPH_TEST_MODE=1 shrinks the run
(``apply_test_mode``) and writes a synthetic COCO tree at
``--datasets-root``, and for a config on LVIS datasets a synthetic LVIS tree
at ``--lvis-root``, where none is there. After training, ``do_test`` runs
and ``{OUTPUT_DIR}/eval_results.json`` is written.
"""

from __future__ import annotations

import argparse
import json
import os

from ..data.catalog import register_all_coco, register_all_lvis
from ..parallel.mesh import DataGroup, create_mesh
from ..runner import create_runner
from ..utils.setup import setup_after_launch


def apply_test_mode(cfg):
    """SYLPH_TEST_MODE shrink (reference tools/setup.py:170-186)."""
    cfg.SOLVER.IMS_PER_BATCH = 2
    cfg.SOLVER.MAX_ITER = 10
    cfg.SOLVER.WARMUP_ITERS = 0
    cfg.MODEL.META_LEARN.SHOT = 2
    cfg.MODEL.META_LEARN.EVAL_SHOT = 2
    cfg.MODEL.META_LEARN.CLASS = 2
    cfg.TEST.REPEAT_TEST = 1
    cfg.TPU.TEST_MODE = True
    return cfg


def auto_scale_world_size(cfg, world: int = 1):
    """Rescale a config written for SOLVER.REFERENCE_WORLD_SIZE ranks to
    ``world`` devices (reference tools/setup.py:273), preferring exact
    emulation: when the batch divides, keep batch, LR and schedule and run
    ``ref / world`` micro-groups per step (TPU.GRAD_ACCUM), each one
    reference rank, which keeps the episodic way. Non-episodic configs
    size the micro-groups by TPU.PRETRAIN_MICRO_BATCH instead (any split is
    exact there). Otherwise fall back to linear scaling of the batch, LR and
    every iteration quantity."""
    ref = cfg.SOLVER.REFERENCE_WORLD_SIZE
    if not ref or world == ref:
        return cfg
    if (world < ref and ref % world == 0
            and cfg.SOLVER.IMS_PER_BATCH % ref == 0):
        m = ref // world
        cap = cfg.TPU.get("PRETRAIN_MICRO_BATCH", 0)
        if not cfg.MODEL.META_LEARN.EPISODIC_LEARNING and cap > 0:
            per_dev = cfg.SOLVER.IMS_PER_BATCH // world
            m = max(1, -(-per_dev // cap))  # ceil(per_dev / cap)
            while per_dev % m:
                m += 1
        if cfg.TPU.GRAD_ACCUM <= 1:
            cfg.TPU.GRAD_ACCUM = m
        cfg.SOLVER.REFERENCE_WORLD_SIZE = world
        print(f"[setup] emulating {ref} ranks on {world} device(s) via "
              f"TPU.GRAD_ACCUM={cfg.TPU.GRAD_ACCUM} (batch "
              f"{cfg.SOLVER.IMS_PER_BATCH}, lr {cfg.SOLVER.BASE_LR:.2e}, "
              "schedule unchanged)")
        return cfg
    old_batch = cfg.SOLVER.IMS_PER_BATCH
    cfg.SOLVER.IMS_PER_BATCH = max(int(round(old_batch * world / ref)),
                                   world)
    # linear scaling against the realized batch ratio
    scale = cfg.SOLVER.IMS_PER_BATCH / old_batch
    inv = 1.0 / max(scale, 1e-9)
    cfg.SOLVER.BASE_LR *= scale
    cfg.SOLVER.MAX_ITER = int(round(cfg.SOLVER.MAX_ITER * inv))
    cfg.SOLVER.STEPS = [int(round(s * inv)) for s in cfg.SOLVER.STEPS]
    cfg.SOLVER.WARMUP_ITERS = int(round(cfg.SOLVER.WARMUP_ITERS * inv))
    cfg.SOLVER.CHECKPOINT_PERIOD = int(
        round(cfg.SOLVER.CHECKPOINT_PERIOD * inv))
    if cfg.TEST.EVAL_PERIOD:
        cfg.TEST.EVAL_PERIOD = int(round(cfg.TEST.EVAL_PERIOD * inv))
    cfg.SOLVER.REFERENCE_WORLD_SIZE = world
    print(f"[setup] auto-scaled world size {ref} -> {world} "
          f"(lr {cfg.SOLVER.BASE_LR:.2e}, batch {cfg.SOLVER.IMS_PER_BATCH}, "
          f"warmup {cfg.SOLVER.WARMUP_ITERS})")
    if (cfg.MODEL.META_LEARN.EPISODIC_LEARNING
            and cfg.SOLVER.IMS_PER_BATCH < old_batch):
        print(f"[setup] WARNING: episodic batch shrank {old_batch} -> "
              f"{cfg.SOLVER.IMS_PER_BATCH}, which shrinks the episodic way; "
              "prefer a batch divisible by REFERENCE_WORLD_SIZE")
    return cfg


def _ensure_test_mode_dataset(root: str) -> None:
    needed = [os.path.join(root, "annotations", "instances_train2017.json"),
              os.path.join(root, "annotations", "instances_val2017.json"),
              os.path.join(root, "train2017"),
              os.path.join(root, "val2017")]
    if all(os.path.exists(p) for p in needed):
        return
    from ..data.synthetic import make_synthetic_coco
    print(f"[test-mode] no COCO tree at {root}; writing the synthetic one")
    make_synthetic_coco(root, n_empty_val=2)


def _ensure_test_mode_lvis(lvis_root: str, coco_root: str) -> None:
    """The LVIS counterpart: the jsons at ``lvis_root``, the images under
    ``coco_root``."""
    needed = [os.path.join(lvis_root, "lvis_v1_train.json"),
              os.path.join(lvis_root, "lvis_v1_val.json")]
    if all(os.path.exists(p) for p in needed):
        return
    from ..data.synthetic import make_synthetic_lvis
    print(f"[test-mode] no LVIS jsons at {lvis_root}; writing the synthetic "
          "LVIS tree")
    make_synthetic_lvis(lvis_root, coco_root)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--runner", default="MetaFCOSRunner")
    p.add_argument("--config-file", required=True)
    p.add_argument("--eval-only", action="store_true")
    p.add_argument("--output-dir", default=None)
    p.add_argument("--datasets-root", default="datasets/coco")
    p.add_argument("--lvis-root", default="datasets/lvis")
    p.add_argument("--device", default="cuda")
    p.add_argument("--distributed", action="store_true",
                   help="one rank of a data-parallel group: read torchrun's "
                        "environment (RANK, WORLD_SIZE, LOCAL_RANK, "
                        "MASTER_ADDR, MASTER_PORT)")
    p.add_argument("--dist-url", default=None,
                   help="with --distributed: the rendezvous (default "
                        "env://), e.g. file:///tmp/rendezvous")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    args = p.parse_args(argv)

    group = (create_mesh(args.device, init_method=args.dist_url)
             if args.distributed else DataGroup.single(args.device))
    try:
        return _run(args, group)
    finally:
        group.close()


def _run(args, group: DataGroup):
    runner = create_runner(args.runner, group=group)
    cfg = runner.get_default_cfg()
    cfg.merge_from_file(args.config_file)
    opts = args.opts
    if opts and opts[0] == "opts":   # argparse REMAINDER keeps the token
        opts = opts[1:]
    if opts:
        cfg.merge_from_list(opts)
    if args.output_dir:
        cfg.OUTPUT_DIR = args.output_dir
    test_mode = bool(os.environ.get("SYLPH_TEST_MODE"))
    if test_mode:
        apply_test_mode(cfg)
        if not args.output_dir:
            cfg.OUTPUT_DIR = os.path.join(cfg.OUTPUT_DIR, "testmode_smoke")
    auto_scale_world_size(cfg, world=group.world)
    cfg.freeze()
    uses_lvis = any(n.startswith("lvis") for n in
                    list(cfg.DATASETS.TRAIN) + list(cfg.DATASETS.TEST))
    if group.is_main:
        setup_after_launch(cfg, cfg.OUTPUT_DIR,
                           default_cfg=runner.get_default_cfg())
        if test_mode:
            _ensure_test_mode_dataset(args.datasets_root)
            if uses_lvis:
                _ensure_test_mode_lvis(args.lvis_root, args.datasets_root)
    group.barrier()  # the trees are written before any rank reads them
    register_all_coco(args.datasets_root)
    if uses_lvis:
        register_all_lvis(args.lvis_root, args.datasets_root)

    model = runner.build_model(cfg, init="train")
    step = 0
    if not args.eval_only:
        model, state = runner.do_train(cfg, model)
        step = state.step
        # the EMA weights when MODEL_EMA is on (reference :692-699)
        model.load_state_dict(runner.eval_params(cfg, state), strict=False)
    results = runner.do_test(cfg, model, step=step)
    if group.is_main:
        with open(os.path.join(cfg.OUTPUT_DIR, "eval_results.json"),
                  "w") as f:
            json.dump(results, f, indent=2, default=float)
    print(json.dumps({k: v.get("bbox", v) for k, v in results.items()},
                     indent=2, default=float))
    return results


if __name__ == "__main__":
    main()
