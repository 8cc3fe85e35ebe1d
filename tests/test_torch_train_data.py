"""The port's train loaders and samplers against the JAX package's.

On one synthetic COCO tree registered in both catalogs, the episodic and
the pretrain train loader must yield byte-identical batches for seeds 0 and
1 (images, boxes, labels, valid flags, episode class ids and the drawn
device RandAugment ops), with host RandAugment too; with ``device="cpu"``
the batches arrive as tensors holding the same bytes. The samplers give the
JAX sequences.
"""

import itertools

import numpy as np
import pytest
import torch

from sylph_tpu.config import get_default_cfg as jax_default_cfg
from sylph_tpu.data import catalog as jax_catalog
from sylph_tpu.data import samplers as jax_samplers
from sylph_tpu.data.loader import \
    build_episodic_train_loader as jax_episodic_loader
from sylph_tpu.data.loader import build_pretrain_loader as jax_pretrain_loader
from sylph_tpu.data.meta_dataset import MetaDataset as JaxMetaDataset
from sylph_tpu.runner.meta_fcos_runner import _mapper as jax_mapper
from sylph_tpu_torch import get_default_cfg
from sylph_tpu_torch.data import catalog, samplers
from sylph_tpu_torch.data.loader import (build_episodic_train_loader,
                                         build_pretrain_loader)
from sylph_tpu_torch.data.meta_dataset import MetaDataset
from sylph_tpu_torch.data.synthetic import make_synthetic_coco
from sylph_tpu_torch.runner import _mapper

from torch_port_util import (few_torch_threads,  # noqa: F401
                             register_both, shrink_meta_cfg)

N_BATCHES = 2


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco"))
    make_synthetic_coco(root, n_train=24, n_val=4, img_hw=(96, 128))
    register_both(root)
    return root


def _mappers(device_aug: bool):
    out = []
    for cfg in (shrink_meta_cfg(jax_default_cfg()),
                shrink_meta_cfg(get_default_cfg())):
        cfg.TPU.DEVICE_RANDAUG = device_aug
        out.append(cfg)
    return jax_mapper(out[0]), _mapper(out[1])


def _take(loader, n=N_BATCHES):
    """n batches with their arrays copied (the loaders reuse buffers)."""
    out = [{k: (v.clone() if isinstance(v, torch.Tensor) else np.array(v))
            for k, v in b.items()} for b in itertools.islice(loader, n)]
    loader.close()
    return out


def _assert_equal(got, want):
    assert len(got) == len(want) == N_BATCHES
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            gv = g[k].numpy() if isinstance(g[k], torch.Tensor) else g[k]
            assert gv.dtype == w[k].dtype, k
            np.testing.assert_array_equal(gv, w[k], err_msg=k)


def _episodic(pkg_loader, pkg_dataset, catalog_, mapper, seed, **kw):
    ds = pkg_dataset(catalog_.DatasetCatalog.get("coco_meta_train_base"),
                     "episodic_train_both", num_shot=2, num_query_shot=1)
    return _take(pkg_loader(ds, mapper, episodes_per_batch=3, seed=seed,
                            **kw))


@pytest.mark.parametrize("device_aug", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_episodic_train_loader_matches_jax(coco, seed, device_aug):
    jm, tm = _mappers(device_aug)
    want = _episodic(jax_episodic_loader, JaxMetaDataset, jax_catalog, jm,
                     seed)
    got = _episodic(build_episodic_train_loader, MetaDataset, catalog, tm,
                    seed)
    _assert_equal(got, want)
    assert ("query_aug_ops" in got[0]) == device_aug
    on_cpu = _episodic(build_episodic_train_loader, MetaDataset, catalog,
                       tm, seed, device="cpu")
    assert isinstance(on_cpu[0]["query_images"], torch.Tensor)
    _assert_equal(on_cpu, want)


def _pretrain_records(catalog_):
    data = catalog_.DatasetCatalog.get("coco_pretrain_train_base")
    return data["records"] if isinstance(data, dict) else data


@pytest.mark.parametrize("sampler", ["TrainingSampler",
                                     "RepeatFactorTrainingSampler"])
@pytest.mark.parametrize("seed", [0, 1])
def test_pretrain_loader_matches_jax(coco, seed, sampler):
    jm, tm = _mappers(True)
    kw = dict(batch_size=3, seed=seed, sampler=sampler, repeat_thresh=0.3)
    want = _take(jax_pretrain_loader(_pretrain_records(jax_catalog), jm,
                                     **kw))
    got = _take(build_pretrain_loader(_pretrain_records(catalog), tm, **kw))
    _assert_equal(got, want)
    on_cpu = _take(build_pretrain_loader(_pretrain_records(catalog), tm,
                                         device="cpu", **kw))
    _assert_equal(on_cpu, want)
    assert isinstance(on_cpu[0]["gt_boxes"], torch.Tensor)
    assert isinstance(on_cpu[0]["aug_ops"], np.ndarray)  # stays on the host


@pytest.mark.parametrize("seed", [0, 3])
def test_samplers_match_jax(coco, seed):
    n = 50
    pairs = [
        (samplers.TrainingClassSampler(7, seed),
         jax_samplers.TrainingClassSampler(7, seed)),
        (samplers.EpochShuffleSampler(5, seed),
         jax_samplers.EpochShuffleSampler(5, seed)),
        (samplers.RepeatFactorClassSampler({0: 1, 1: 30, 4: 3}, 0.2, seed),
         jax_samplers.RepeatFactorClassSampler({0: 1, 1: 30, 4: 3}, 0.2,
                                               seed)),
        (samplers.RepeatFactorImageSampler(
            _pretrain_records(catalog), 0.3, seed),
         jax_samplers.RepeatFactorImageSampler(
             _pretrain_records(jax_catalog), 0.3, seed)),
    ]
    for got, want in pairs:
        assert (list(itertools.islice(iter(got), n))
                == list(itertools.islice(iter(want), n)))
