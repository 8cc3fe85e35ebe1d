"""``sylph_tpu_torch.parallel.mesh`` against the JAX package's mesh helpers.

  * ``shard_batch``: each rank's slice equals the shard a 2-device JAX mesh
    puts on that device (``NamedSharding(mesh, P("data"))``);
  * ``gather_class_codes`` over 2 gloo ranks equals JAX's tiled all-gather
    under ``shard_map`` on 2 devices, the same on both ranks;
  * ``cross_rank_mean`` and ``all_reduce_mean_`` average over the ranks and
    are the identity in a world of one;
  * ``loss_normalizers`` over 2 ranks equal JAX's ``_accum_normalizers`` on
    a 2-device mesh, clamped after the mean: on a batch whose positives sit
    on one rank, clamping first would give another value;
  * the refusals: no card without ``device="cpu"``, NCCL only on a card,
    gloo on a card only where it is named.

Ranks are processes (``torch_port_util.spawn_ranks``); this file imports
nothing of JAX at module level, because every rank imports it.
"""

import numpy as np
import pytest
import torch

from sylph_tpu_torch.ops.assigner import FCOSTargets
from sylph_tpu_torch.ops.fcos_losses import loss_normalizers
from sylph_tpu_torch.parallel import mesh as pmesh
from sylph_tpu_torch.parallel import (DataGroup, all_reduce_mean_,
                                      create_mesh, cross_rank_mean,
                                      gather_class_codes, shard_batch)

CODES = np.random.RandomState(3).randn(6, 16).astype(np.float32)
BIAS = np.random.RandomState(4).randn(6).astype(np.float32)


def _targets(rank_or_none):
    """Pretraining-style targets of 4 images x 6 locations: every positive
    sits in the first two images (rank 0's half), so rank 1 has none."""
    labels = np.full((4, 6), -1, np.int32)
    labels[0, :3] = 2
    labels[1, 0] = 1
    reg = np.random.RandomState(7).uniform(0.5, 3.0, (4, 6, 4)).astype(
        np.float32)
    inds = np.where(labels >= 0, 0, -1).astype(np.int32)
    if rank_or_none is None:
        return labels, reg, inds
    sl = slice(2 * rank_or_none, 2 * rank_or_none + 2)
    return labels[sl], reg[sl], inds[sl]


def rank_collectives(group, out):
    """What each rank sees of the collectives."""
    r = group.rank
    codes = {"cls_conv": torch.from_numpy(CODES[3 * r:3 * r + 3]),
             "cls_bias": torch.from_numpy(BIAS[3 * r:3 * r + 3])}
    x = torch.tensor([float(r + 1), 4.0 * r])
    xs = [torch.full((3,), float(r)), torch.full((2, 2), 2.0 * r,
                                                 dtype=torch.float64)]
    all_reduce_mean_(xs, group)
    tg = FCOSTargets(*(torch.from_numpy(a) for a in _targets(r)))
    npa, ld = loss_normalizers(tg, 1, group)
    return {"gathered": {k: v.numpy() for k, v in
                         gather_class_codes(codes, group).items()},
            "mean": cross_rank_mean(x, group).numpy(),
            "reduced": [t.numpy() for t in xs],
            "normalizers": (float(npa), float(ld)),
            "backend": group.backend, "world": group.world,
            "objects": group.gather_objects((r, f"rank{r}"))}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from torch_port_util import spawn_ranks
    return spawn_ranks(__file__, "rank_collectives",
                       tmp_path_factory.mktemp("ranks"))


def test_shard_batch_matches_jax_named_sharding():
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from sylph_tpu.parallel.mesh import create_mesh as jax_mesh
    rng = np.random.RandomState(0)
    batch = {"images": rng.randint(0, 255, (8, 4, 4, 3)).astype(np.uint8),
             "boxes": rng.randn(8, 3, 4).astype(np.float32),
             "ids": np.arange(8, dtype=np.int32)}
    mesh = jax_mesh(2)
    sharding = NamedSharding(mesh, P("data"))
    for key, arr in batch.items():
        shards = sorted(jax.device_put(arr, sharding).addressable_shards,
                        key=lambda s: s.index[0].start)
        for r, shard in enumerate(shards):
            got = shard_batch({key: torch.from_numpy(arr)},
                              DataGroup(r, 2, "gloo", torch.device("cpu")))
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(shard.data))
            np.testing.assert_array_equal(
                shard_batch(arr, DataGroup(r, 2, None, torch.device("cpu"))),
                np.asarray(shard.data))
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(np.zeros((5, 2)), DataGroup(0, 2, None,
                                                torch.device("cpu")))


def test_gather_class_codes_matches_jax_shard_map(ranks):
    import jax
    from jax.sharding import PartitionSpec as P

    from sylph_tpu.parallel.mesh import create_mesh as jax_mesh
    from sylph_tpu.parallel.mesh import gather_class_codes as jax_gather
    fn = jax.jit(jax.shard_map(
        jax_gather, mesh=jax_mesh(2), in_specs=(P("data"),), out_specs=P(),
        check_vma=False))
    want = fn({"cls_conv": CODES, "cls_bias": BIAS})
    for res in ranks:
        for k in ("cls_conv", "cls_bias"):
            np.testing.assert_array_equal(res["gathered"][k],
                                          np.asarray(want[k]))
    assert ranks[0]["backend"] == "gloo" and ranks[0]["world"] == 2
    assert ranks[0]["objects"] == ranks[1]["objects"] == [(0, "rank0"),
                                                          (1, "rank1")]


def test_cross_rank_mean_and_all_reduce_mean(ranks):
    for res in ranks:
        np.testing.assert_array_equal(res["mean"], [1.5, 2.0])
        np.testing.assert_array_equal(res["reduced"][0], np.full(3, 0.5))
        assert res["reduced"][1].dtype == np.float64
        np.testing.assert_array_equal(res["reduced"][1], np.ones((2, 2)))
    one = DataGroup.single("cpu")
    x = torch.tensor([1.0, 2.0])
    assert cross_rank_mean(x, one) is x and cross_rank_mean(x, None) is x
    all_reduce_mean_([x], one)
    assert x.tolist() == [1.0, 2.0]
    codes = {"cls_conv": torch.ones(2, 3)}
    assert gather_class_codes(codes, one)["cls_conv"] is codes["cls_conv"]


def test_normalizers_clamp_after_the_mean_as_jax(ranks):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from sylph_tpu.ops.assigner import FCOSTargets as JaxTargets
    from sylph_tpu.parallel.mesh import create_mesh as jax_mesh
    from sylph_tpu.train.steps import _accum_normalizers

    fn = jax.jit(jax.shard_map(
        lambda t: _accum_normalizers(t, "data", 1), mesh=jax_mesh(2),
        in_specs=(P("data"),), out_specs=P(), check_vma=False))
    want = [float(v) for v in fn(JaxTargets(*(jnp.asarray(a)
                                              for a in _targets(None))))]
    for res in ranks:
        np.testing.assert_allclose(res["normalizers"], want, rtol=1e-6)
    # 4 positives on rank 0, none on rank 1: the mean is 2; clamping each
    # rank to 1 first would give (4 + 1) / 2
    assert res["normalizers"][0] == 2.0
    one = [float(v) for v in loss_normalizers(
        FCOSTargets(*(torch.from_numpy(a) for a in _targets(None))), 2)]
    np.testing.assert_allclose(one, want, rtol=1e-6)


def test_refusals_and_the_world_of_one(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    g = create_mesh("cpu")
    assert (g.rank, g.world, g.backend, g.group) == (0, 1, None, None)
    assert g.device == torch.device("cpu") and g.is_main
    g.barrier()
    assert g.gather_objects("x") == ["x"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            create_mesh()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DataGroup.single("cuda")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        create_mesh("cpu", backend="nccl")
    with pytest.raises(ValueError, match="one of"):
        create_mesh("cpu", backend="mpi")
    with pytest.raises(ValueError, match="needs an init_method"):
        create_mesh("cpu", world_size=2)
    card = torch.device("cuda", 0)
    assert pmesh._backend_for(card, None) == "nccl"
    assert pmesh._backend_for(card, "gloo") == "gloo"
    assert pmesh._backend_for(torch.device("cpu"), None) == "gloo"
