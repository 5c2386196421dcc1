"""The transforms and the loader of the torch port against the JAX package,
batch field by field from the same key: ``NeighborSamplerTransform`` on
karate (``Data`` with an edge attribute) and on fakeheterodataset
(``HeteroData``), ``HGTSamplerTransform`` uniform and temporal,
``NegativeSamplerTransform`` on both, ``SeedLoader`` and ``loader.to_csc``
/ ``to_csr``."""
import dataclasses
import inspect

import jax
import numpy as np
import pytest

from tch_geometric_tpu import loader as jloader
from tch_geometric_tpu import transforms as jtr
from tch_geometric_tpu.data.dataset import Data as JData
from tch_geometric_tpu.data.dataset import HeteroData as JHeteroData
from tch_geometric_tpu_torch import loader, transforms
from tch_geometric_tpu_torch.data import Data, HeteroData
from tch_geometric_tpu_torch.data.io import _fixture_path
from tch_geometric_tpu_torch.sampling import rng


def _karate():
    d = np.load(_fixture_path("karate.npz"))
    kw = dict(x=d["x"].astype(np.float32), y=d["y"].astype(np.int64),
              edge_index=d["edge_index"].astype(np.int64))
    w = np.random.default_rng(0).random(kw["edge_index"].shape[1])
    return (Data(**kw, edge_attrs={"w": w}),
            JData(**kw, edge_attrs={"w": w}))


def _hetero(timestamps=False):
    h = HeteroData.from_npz(_fixture_path("fakeheterodataset.npz"))
    attrs = {}
    if timestamps:
        r = np.random.default_rng(1)
        attrs = {e: {"timestamps": r.integers(-1, 12, ei.shape[1])}
                 for e, ei in h.edge_index.items()}
    kw = dict(x=h.x, y=h.y, edge_index=h.edge_index, edge_attrs=attrs)
    return HeteroData(**kw), JHeteroData(**kw)


def _same(ours, theirs):
    assert type(ours).__name__ == type(theirs).__name__
    for f in dataclasses.fields(ours):
        a, b = getattr(ours, f.name), getattr(theirs, f.name)
        if isinstance(a, dict):
            assert list(a) == list(b), f.name
            for k in a:
                if isinstance(a[k], list):
                    assert a[k] == b[k], (f.name, k)
                else:
                    np.testing.assert_array_equal(a[k], b[k],
                                                  err_msg=f"{f.name}[{k}]")
        elif a is None or isinstance(a, list):
            assert a == b, f.name
        else:
            np.testing.assert_array_equal(a, b, err_msg=f.name)


def test_neighbor_transform_data():
    data, jdata = _karate()
    seeds = np.array([0, 1, 2, 3, 33])
    ours = transforms.NeighborSamplerTransform(data, [4, 3], device="cpu")(
        seeds, key=rng.key(0))
    theirs = jtr.NeighborSamplerTransform(jdata, [4, 3])(
        seeds, key=jax.random.key(0))
    _same(ours, theirs)
    np.testing.assert_array_equal(ours.edge_attrs["w"],
                                  data.edge_attrs["w"][ours.e_id])


def test_neighbor_transform_hetero():
    data, jdata = _hetero()
    seeds = {t: np.array([0, 1, 4]) for t in data.node_types}
    ours = transforms.NeighborSamplerTransform(data, [3, 2], device="cpu")(
        seeds, key=rng.key(1))
    theirs = jtr.NeighborSamplerTransform(jdata, [3, 2])(
        seeds, key=jax.random.key(1))
    _same(ours, theirs)


@pytest.mark.parametrize("temporal", [False, True])
def test_hgt_transform(temporal):
    data, jdata = _hetero(timestamps=temporal)
    seeds = {t: np.array([0, 1, 4, 5]) for t in data.node_types}
    kw = {}
    if temporal:
        kw = dict(input_timestamps={t: np.array([3, 4, -1, 6])
                                    for t in data.node_types},
                  timerange=(0, 9))
    ours = transforms.HGTSamplerTransform(data, [12, 8], temporal=temporal,
                                          device="cpu")(
        seeds, key=rng.key(2), **kw)
    theirs = jtr.HGTSamplerTransform(jdata, [12, 8], temporal=temporal)(
        seeds, key=jax.random.key(2), **kw)
    _same(ours, theirs)


def test_negative_transform():
    data, jdata = _karate()
    seeds = np.array([0, 1, 2, 2, 33])
    _same(transforms.NegativeSamplerTransform(data, 4, 3, device="cpu")(
              seeds, key=rng.key(3)),
          jtr.NegativeSamplerTransform(jdata, 4, 3)(
              seeds, key=jax.random.key(3)))
    hdata, jhdata = _hetero()
    hseeds = {t: np.array([0, 1, 4]) for t in hdata.node_types}
    for inbound in (False, True):
        _same(transforms.NegativeSamplerTransform(
                  hdata, 3, 2, inbound, device="cpu")(hseeds,
                                                      key=rng.key(4)),
              jtr.NegativeSamplerTransform(jhdata, 3, 2, inbound)(
                  hseeds, key=jax.random.key(4)))


@pytest.mark.parametrize("kw", [{}, {"drop_last": False},
                                {"drop_last": False, "pad_last": True},
                                {"shuffle": False, "drop_last": False}])
def test_seed_loader(kw):
    seeds = np.arange(100, 203)
    ours = loader.SeedLoader(seeds, 16, seed=5, **kw)
    theirs = jloader.SeedLoader(seeds, 16, seed=5, **kw)
    assert len(ours) == len(theirs)
    for _epoch in range(2):
        a, b = list(ours), list(theirs)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_loader_csx_and_device_defaults():
    data, jdata = _karate()
    for ours, theirs in ((loader.to_csc, jloader.to_csc),
                         (loader.to_csr, jloader.to_csr)):
        for a, b in zip(ours(data), theirs(jdata)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(ours(data.edge_index, (34, 40)),
                        theirs(data.edge_index, (34, 40))):
            np.testing.assert_array_equal(a, b)
    for cls in (transforms.NeighborSamplerTransform,
                transforms.HGTSamplerTransform,
                transforms.NegativeSamplerTransform):
        assert inspect.signature(cls).parameters["device"].default == "cuda"
