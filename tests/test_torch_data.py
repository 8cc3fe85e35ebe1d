"""The port's data layer against the JAX package's on one synthetic tree.

``make_synthetic_coco`` writes a COCO tree (JPEGs + jsons); both packages
register it in their own catalogs. For the novel, base and all splits and
meta-test seeds 0 and 1, the support batches (``build_support_set_loader``),
the base-class chunk batches (``build_support_set_base_loader``) and the
query batches (``build_query_loader``, padded tail included) must be
byte-identical: images, boxes, valid flags, class ids and names, weights,
sizes, image ids and ``batch_valid``. The split "all" draws its novel
support from the global numpy RNG, which is seeded alike before each load.
The LVIS family registers and loads to the same dicts too.
"""

import numpy as np
import pytest
import torch

from sylph_tpu.data import catalog as jax_catalog
from sylph_tpu.data.loader import build_query_loader as jax_query_loader
from sylph_tpu.data.loader import \
    build_support_set_base_loader as jax_base_loader
from sylph_tpu.data.loader import build_support_set_loader as jax_sup_loader
from sylph_tpu.data.meta_dataset import MetaDataset as JaxMetaDataset
from sylph_tpu.data.synthetic import make_synthetic_coco as jax_make_coco
from sylph_tpu.data.synthetic import make_synthetic_lvis as jax_make_lvis
from sylph_tpu.data.transforms import pad_to_canvas as jax_pad
from sylph_tpu.runner.meta_fcos_runner import _mapper as jax_mapper
from sylph_tpu_torch.data import catalog
from sylph_tpu_torch.data.loader import (build_query_loader,
                                         build_support_set_base_loader,
                                         build_support_set_loader)
from sylph_tpu_torch.data.meta_dataset import MetaDataset
from sylph_tpu_torch.data.synthetic import (make_synthetic_coco,
                                            make_synthetic_lvis)
from sylph_tpu_torch.data.transforms import pad_to_canvas
from sylph_tpu_torch.evaluation.meta_eval import _device_prefetch
from sylph_tpu_torch.runner import _mapper

from torch_port_util import register_both, shrink_meta_cfg

SPLITS = ("novel", "base", "all")


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    """40 train images (novel classes exceed the 10-shot support cap, so
    the split "all" downsamples), 9 + 2 empty val images."""
    root = str(tmp_path_factory.mktemp("coco"))
    make_synthetic_coco(root, n_train=40, n_val=9, img_hw=(96, 128),
                        n_empty_val=2)
    register_both(root)
    from sylph_tpu.config import get_default_cfg as jax_default_cfg
    from sylph_tpu_torch import get_default_cfg
    return dict(root=root,
                jmapper=jax_mapper(shrink_meta_cfg(jax_default_cfg())),
                mapper=_mapper(shrink_meta_cfg(get_default_cfg())))


def load_both(split):
    name = f"coco_meta_val_{split}"
    np.random.seed(11)
    jd = jax_catalog.DatasetCatalog.get(name)
    np.random.seed(11)
    td = catalog.DatasetCatalog.get(name)
    return jd, td


def host_copies(loader):
    """Each batch with its arrays copied (the query loader reuses its
    buffers)."""
    return [{k: np.array(v) if isinstance(v, np.ndarray) else v
             for k, v in b.items()} for b in loader]


def assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g[k] == w[k], k


def test_synthetic_copy_writes_the_same_tree(tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    jax_make_coco(a, n_train=5, n_val=2, n_empty_val=1, seed=3)
    make_synthetic_coco(b, n_train=5, n_val=2, n_empty_val=1, seed=3)
    for rel in ("annotations/instances_train2017.json",
                "annotations/instances_val2017.json",
                "train2017/000000010004.jpg", "val2017/000000020002.jpg"):
        with open(f"{a}/{rel}", "rb") as fa, open(f"{b}/{rel}", "rb") as fb:
            assert fa.read() == fb.read(), rel


@pytest.mark.parametrize("name", ["lvis_meta_val_novelr",
                                  "lvis_meta_train_all",
                                  "lvis_pretrain_val_basefc", "lvis_v1_val"])
def test_lvis_catalog_equals_jax(coco, tmp_path, name):
    """The LVIS family: the synthetic tree is the same in both copies and
    each registered dataset loads to the same dict."""
    roots = {}
    for side, make in (("jax", jax_make_lvis), ("port", make_synthetic_lvis)):
        roots[side] = (str(tmp_path / side / "lvis"),
                       str(tmp_path / side / "coco"))
        make(*roots[side])
    for rel in ("lvis_v1_train.json", "lvis_v1_val.json"):
        with open(f"{roots['jax'][0]}/{rel}", "rb") as fa, \
                open(f"{roots['port'][0]}/{rel}", "rb") as fb:
            assert fa.read() == fb.read(), rel
    jcat, tcat = jax_catalog.DatasetCatalog, catalog.DatasetCatalog
    try:
        jcat.clear()
        tcat.clear()
        jax_catalog.register_all_lvis(*roots["port"])
        catalog.register_all_lvis(*roots["port"])
        assert tcat.list() == jcat.list()
        want, got = jcat.get(name), tcat.get(name)
        assert got == want and got["metadata"]
    finally:
        register_both(coco["root"])


def test_catalogs_are_separate(coco):
    catalog.DatasetCatalog.register("port_only", lambda: {})
    assert "port_only" in catalog.DatasetCatalog
    assert "port_only" not in jax_catalog.DatasetCatalog
    assert catalog.DatasetCatalog is not jax_catalog.DatasetCatalog


@pytest.mark.parametrize("split", SPLITS)
def test_dataset_dicts_equal(coco, split):
    jd, td = load_both(split)
    assert jd == td


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("split", SPLITS)
def test_support_batches_equal(coco, split, seed):
    jd, td = load_both(split)
    jds = JaxMetaDataset(jd, "episodic_test_supportset", num_shot=2,
                         meta_test_seed=seed)
    tds = MetaDataset(td, "episodic_test_supportset", num_shot=2,
                      meta_test_seed=seed)
    assert [tds[i] for i in range(len(tds))] == \
        [jds[i] for i in range(len(jds))]
    assert_batches_equal(
        host_copies(build_support_set_loader(tds, coco["mapper"])),
        host_copies(jax_sup_loader(jds, coco["jmapper"])))


@pytest.mark.parametrize("split", SPLITS)
def test_base_chunk_batches_equal(coco, split):
    jd, td = load_both(split)
    jds = JaxMetaDataset(jd, "episodic_test_supportset", num_shot=2)
    tds = MetaDataset(td, "episodic_test_supportset", num_shot=2)
    kw = dict(chunk_size=4, max_records=10)
    assert_batches_equal(
        host_copies(build_support_set_base_loader(tds, coco["mapper"],
                                                  **kw)),
        host_copies(jax_base_loader(jds, coco["jmapper"], **kw)))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("split", SPLITS)
def test_query_batches_equal(coco, split, seed):
    jd, td = load_both(split)
    jds = JaxMetaDataset(jd, "episodic_test_queryset", num_shot=2,
                         meta_test_seed=seed)
    tds = MetaDataset(td, "episodic_test_queryset", num_shot=2,
                      meta_test_seed=seed)
    got = host_copies(build_query_loader(tds, coco["mapper"], batch_size=4))
    assert_batches_equal(got, host_copies(
        jax_query_loader(jds, coco["jmapper"], batch_size=4)))
    n = len(tds.query)  # the tail batch is padded
    assert n % 4 and got[-1]["batch_valid"].tolist() == \
        [j < n % 4 for j in range(4)]


def test_device_copies_outlive_the_buffer_ring(coco):
    """The query loader rewrites its host buffers once the ring wraps; the
    tensors the meta-test hands the model are copies that do not change."""
    _, td = load_both("novel")
    ds = MetaDataset(td, "episodic_test_queryset", num_shot=2)
    loader = build_query_loader(ds, coco["mapper"], batch_size=1)
    held = [b["images"] for b in _device_prefetch(loader, ("images",),
                                                  torch.device("cpu"))]
    assert len(held) == len(ds.query) > 8  # more than the ring holds
    for rec, t in zip(ds.query, held):
        want = coco["mapper"].map_query_eval(rec)["image"]
        np.testing.assert_array_equal(t[0].numpy(), want)


def test_pad_to_canvas_out_matches_jax():
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (20, 30, 3), np.uint8)[:, ::-1]
    out, jout = (np.full((32, 40, 3), 7, np.uint8) for _ in range(2))
    got = pad_to_canvas(img, (32, 40), out)
    assert got is out
    np.testing.assert_array_equal(got, jax_pad(img, (32, 40), jout))


def test_map_query_train_is_not_ported(coco):
    with pytest.raises(NotImplementedError):
        coco["mapper"].map_query_train({}, np.random.RandomState(0))
