"""Helpers shared by the tests that hold sylph_tpu_torch against sylph_tpu.

Weights are made once, as flax param trees of numpy arrays, and carried to
the port with ``sylph_tpu_torch.utils.convert_weights.state_dict_from_jax``;
inputs are made from a seed with numpy and handed to both packages.
"""

import jax
import numpy as np


def to_numpy(tree):
    """A flax param tree as nested dicts of numpy arrays."""
    return jax.tree.map(np.asarray, tree)


def merge_trees(a, b):
    """Deep union of two nested dicts (``b`` wins on shared leaves)."""
    out = dict(a)
    for k, v in b.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge_trees(out[k], v)
        else:
            out[k] = v
    return out


def randomize(params, rng):
    """Replace every leaf by detectron2-scaled random values: fan-in scaled
    conv kernels, scales near 1, biases near 0."""

    def leaf(path, x):
        name = path[-1].key
        shape = np.shape(x)
        if name == "kernel":
            fan_in = int(np.prod(shape[:3]))
            return (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "meta_bias_value":
            return np.asarray(-4.6 + 0.1 * rng.randn(), np.float32)
        if name == "scale":
            return np.asarray(1.0 + 0.1 * rng.randn(*shape), np.float32)
        return np.asarray(0.1 * rng.randn(*shape), np.float32)

    return jax.tree_util.tree_map_with_path(leaf, to_numpy(params))


def shrink_meta_cfg(cfg, episodic: bool = True):
    """The finetune (or, with ``episodic=False``, the pretrain) config at
    test size: R-18, one-conv towers, 2 shots, 64x64 support and 128x160
    eval canvases, fp32, the thresholds opened so that random weights give
    detections, and no output directory."""
    cfg.merge_from_file("sylph://COCO-Detection/Meta-FCOS/Meta-FCOS-"
                        + ("finetune" if episodic else "pretrain") + ".yaml")
    cfg.MODEL.RESNETS.DEPTH = 18
    cfg.MODEL.FCOS.NUM_CLS_CONVS = 1
    cfg.MODEL.FCOS.NUM_BOX_CONVS = 1
    cfg.MODEL.FCOS.NUM_CLASSES = 6
    cfg.MODEL.FCOS.INFERENCE_TH_TEST = 0.015
    cfg.MODEL.META_LEARN.SHOT = 2
    cfg.MODEL.META_LEARN.EVAL_SHOT = 2
    cfg.MODEL.META_LEARN.CODE_GENERATOR.TOWER_LAYERS = [["GN", "ReLU"]]
    cfg.TPU.TRAIN_CANVAS = [128, 128]
    cfg.TPU.EVAL_CANVAS = [128, 160]
    cfg.TPU.SUPPORT_CANVAS = [64, 64]
    cfg.TPU.MAX_GT_BOXES = 10
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.EVAL_BATCH = 4
    cfg.INPUT.MIN_SIZE_TRAIN = [96]
    cfg.INPUT.MIN_SIZE_TEST = 96
    cfg.INPUT.MAX_SIZE_TEST = 160
    cfg.TEST.REPEAT_TEST = 1
    cfg.OUTPUT_DIR = ""
    return cfg


def tiny_model_pair(episodic: bool = True, seed: int = 0):
    """The same random weights in a JAX model and a port model (CPU) on
    ``shrink_meta_cfg`` configs: (jax cfg, jax model, params, port cfg,
    port model). Params are the union of the base, the code-generation and
    the normalization init, randomized detectron2-style."""
    import jax.numpy as jnp

    from sylph_tpu.config import get_default_cfg as jax_default_cfg
    from sylph_tpu.models.meta_arch import MetaOneStageDetector
    from sylph_tpu.runner.meta_fcos_runner import build_model_from_cfg
    from sylph_tpu_torch import build_model_from_cfg as torch_build
    from sylph_tpu_torch import get_default_cfg
    from sylph_tpu_torch.utils.convert_weights import load_jax_params

    jcfg = shrink_meta_cfg(jax_default_cfg(), episodic)
    tcfg = shrink_meta_cfg(get_default_cfg(), episodic)
    jmodel = build_model_from_cfg(jcfg)
    key = jax.random.PRNGKey(seed)
    query = jnp.zeros((1, *jcfg.TPU.EVAL_CANVAS, 3))
    params = to_numpy(jax.jit(lambda r: jmodel.init(r, query))(key)["params"])
    if episodic:
        shot = jcfg.MODEL.META_LEARN.SHOT
        sup = jnp.zeros((shot, *jcfg.TPU.SUPPORT_CANVAS, 3))
        code = jax.jit(lambda r: jmodel.init(
            r, sup, jnp.zeros((shot, 4)), jnp.ones((shot,), bool), shot,
            method=MetaOneStageDetector.forward_class_code))(key)
        norm = jax.jit(lambda r: jmodel.init(
            r, {"cls_conv": jnp.zeros((1, 256)), "cls_bias": jnp.zeros((1,))},
            method=MetaOneStageDetector.normalize_code))(key)
        params = merge_trees(merge_trees(params, to_numpy(code["params"])),
                             to_numpy(norm["params"]))
    params = randomize(params, np.random.RandomState(seed))
    tmodel = load_jax_params(torch_build(tcfg, device="cpu"), params)
    return jcfg, jmodel, params, tcfg, tmodel


def register_both(root: str) -> None:
    """Register one synthetic COCO root in both packages' catalogs."""
    from sylph_tpu.data import catalog as jax_catalog
    from sylph_tpu_torch.data import catalog

    for cat in (jax_catalog, catalog):
        cat.DatasetCatalog.clear()
        cat.MetadataCatalog.clear()
        cat.register_all_coco(root)


def make_meta_env(root: str):
    """The meta-test fixture: a synthetic COCO tree at ``root`` registered
    in both catalogs, ``tiny_model_pair(seed=2)`` and both mappers."""
    from sylph_tpu.runner.meta_fcos_runner import _mapper as jax_mapper
    from sylph_tpu_torch.data.synthetic import make_synthetic_coco
    from sylph_tpu_torch.runner import _mapper

    make_synthetic_coco(root, n_train=24, n_val=8, img_hw=(96, 128),
                        n_empty_val=2)
    register_both(root)
    jcfg, jmodel, params, tcfg, tmodel = tiny_model_pair(seed=2)
    return dict(jcfg=jcfg, jmodel=jmodel, params=params, tcfg=tcfg,
                tmodel=tmodel, jmapper=jax_mapper(jcfg),
                mapper=_mapper(tcfg))


def datasets_both(name: str):
    """One registered dataset from each package's catalog; the global
    numpy RNG (the split "all" samples novel support from it) is seeded
    alike before each load."""
    from sylph_tpu.data import catalog as jax_catalog
    from sylph_tpu_torch.data import catalog

    np.random.seed(5)
    jd = jax_catalog.DatasetCatalog.get(name)
    np.random.seed(5)
    return jd, catalog.DatasetCatalog.get(name)


def assert_results_close(got, want, atol=1e-4):
    """Two ``eval_results`` dicts: the same keys, every value within
    ``atol`` (NaN where the other is NaN)."""
    import math

    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if math.isnan(w):
            assert math.isnan(got[k]), k
        else:
            assert abs(got[k] - w) <= atol, (k, got[k], w)
