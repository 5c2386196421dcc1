"""The torch port stands alone: no module under tch_geometric_tpu_torch/
imports jax, flax, optax or the JAX package (checked on the source with
ast), and importing it loads none of them."""
import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "tch_geometric_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "tch_geometric_tpu"}
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = set(_imported_roots(path)) & FORBIDDEN
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


MODULES = ["tch_geometric_tpu_torch.data.dataset",
           "tch_geometric_tpu_torch.data.graph",
           "tch_geometric_tpu_torch.data.ogb",
           "tch_geometric_tpu_torch.data.storage",
           "tch_geometric_tpu_torch.loader",
           "tch_geometric_tpu_torch.native",
           "tch_geometric_tpu_torch.models.dropout",
           "tch_geometric_tpu_torch.models.gnn",
           "tch_geometric_tpu_torch.models.hgt",
           "tch_geometric_tpu_torch.models.node2vec",
           "tch_geometric_tpu_torch.ops._build",
           "tch_geometric_tpu_torch.ops.attention_blocked",
           "tch_geometric_tpu_torch.ops.segment",
           "tch_geometric_tpu_torch.ops.spmm",
           "tch_geometric_tpu_torch.ops.spmm_kernels",
           "tch_geometric_tpu_torch.parallel.dist_budget",
           "tch_geometric_tpu_torch.parallel.dist_hetero",
           "tch_geometric_tpu_torch.parallel.dist_hgt",
           "tch_geometric_tpu_torch.parallel.dist_negative",
           "tch_geometric_tpu_torch.parallel.dist_sampling",
           "tch_geometric_tpu_torch.parallel.dist_walks",
           "tch_geometric_tpu_torch.parallel.hgt_train",
           "tch_geometric_tpu_torch.parallel.link_train",
           "tch_geometric_tpu_torch.parallel.mesh",
           "tch_geometric_tpu_torch.parallel.multihost",
           "tch_geometric_tpu_torch.parallel.partition",
           "tch_geometric_tpu_torch.parallel.resilience",
           "tch_geometric_tpu_torch.parallel.sharded_features",
           "tch_geometric_tpu_torch.parallel.train",
           "tch_geometric_tpu_torch.sampling.budget",
           "tch_geometric_tpu_torch.sampling.hetero_neighbor",
           "tch_geometric_tpu_torch.sampling.hgt",
           "tch_geometric_tpu_torch.sampling.negative",
           "tch_geometric_tpu_torch.sampling.neighbor",
           "tch_geometric_tpu_torch.sampling.primitives",
           "tch_geometric_tpu_torch.sampling.walks",
           "tch_geometric_tpu_torch.transforms",
           "tch_geometric_tpu_torch.utils.adam",
           "tch_geometric_tpu_torch.utils.checkpoint",
           "tch_geometric_tpu_torch.utils.kernel_gates",
           "tch_geometric_tpu_torch.utils.metrics",
           "tch_geometric_tpu_torch.utils.params"]


def test_import_loads_no_jax():
    # compare before/after: an interpreter start-up hook may load jax itself
    code = ("import sys\n"
            f"bad = lambda: {{m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN)!r}}}\n"
            "before = bad()\n"
            "import tch_geometric_tpu_torch\n"
            "print(sorted(bad() - before))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize("module", MODULES)
def test_module_import_loads_no_jax(module):
    """Each module of the GAT/GCN/GIN, attention, training and sampling
    slices, of the data layer, walks, HGT, budget and negative samplers,
    transforms and loader, of the HGT and node2vec models and their
    trainers, and of the mesh, the partitioned graph, its exchanges,
    trainers, walks, negative, budget and typed samplers and the
    partitioned heterogeneous layouts, imported alone in a fresh interpreter, loads no JAX and
    nothing of the JAX package."""
    code = ("import sys, importlib\n"
            f"bad = lambda: {{m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN)!r}}}\n"
            "before = bad()\n"
            f"importlib.import_module({module!r})\n"
            "print(sorted(bad() - before))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


EXPORTS = {
    "tch_geometric_tpu_torch.ops": [
        "edge_softmax_blocked_multihead",
        "edge_softmax_blocked_multihead_cuda",
        "spmm_blocked_multiweighted", "spmm_blocked_multiweighted_cuda",
        "gat_attend_blocked", "gat_attend_blocked_cuda",
        "gat_attend_blocked_flash", "gat_attend_blocked_flash_cuda",
        "quantize_rows", "spmm_blocked_q8", "spmm_blocked_q8_cuda",
        "csc_sort_edges", "csc_edge_cumsum"],
    "tch_geometric_tpu_torch.utils.kernel_gates": [
        "run_gat_route_gates", "run_q8_gates"],
    "tch_geometric_tpu_torch.parallel": [
        "make_gnn_trainer", "make_sage_trainer",
        "make_multibatch_sage_trainer", "HGTTrainState", "make_hgt_trainer",
        "make_link_trainer", "make_mesh", "data_sharding", "replicated",
        "param_sharding_rule", "shard_params", "barrier", "shard_checksums",
        "inject_shard_fault", "build_interleaved_features", "halo_gather",
        "make_sharded_feature_trainer", "PartitionedGraph",
        "build_partitioned_graph", "dist_sample_neighbors",
        "make_partitioned_trainer", "make_partitioned_multibatch_trainer",
        "dist_random_walk", "dist_tempo_random_walk",
        "dist_biased_tempo_random_walk", "effective_edge_ts",
        "dist_negative_sample", "dist_negative_sample_hetero",
        "make_partitioned_link_trainer", "dist_budget_sample",
        "dist_budget_sample_hetero", "dist_hetero_neighbor_sample",
        "merge_rank_blocks", "build_partitioned_hetero", "StackedRels",
        "stack_partitioned_rels", "put_stacked_rels", "dist_hgt_sample",
        "make_partitioned_hgt_trainer"],
    "tch_geometric_tpu_torch.parallel.multihost": [
        "initialize", "make_mesh", "global_from_local", "replicated",
        "local_seed_shard", "put_partitioned"],
    "tch_geometric_tpu_torch.parallel.mesh": [
        "ThreadComm", "ProcessGroupComm", "spmd", "psum_grad"],
    "tch_geometric_tpu_torch.parallel.partition": [
        "RingShards", "build_ring_shards", "pad_features", "ring_spmm",
        "alltoall_gather"],
    "tch_geometric_tpu_torch.parallel.dist_sampling": [
        "exchange_rounds", "resolve_num_rounds"],
    "tch_geometric_tpu_torch.utils": [
        "save_checkpoint", "restore_checkpoint", "latest_step",
        "MetricsLogger", "trace_span", "profile", "adam_state_from_optax",
        "train_state_from_flax", "hgt_params_from_flax",
        "node2vec_params_from_flax", "load_flax_params"],
    "tch_geometric_tpu_torch.data": [
        "csc_graph_from_coo", "csr_graph_from_coo", "HeteroData",
        "coo_to_csc_device", "ind2ptr", "ind2ptr_np", "load_ogbn_dir",
        "planted_hetero"],
    "tch_geometric_tpu_torch.sampling": [
        "split_sample_batches", "sample_edges_uniform",
        "sample_hetero_neighbors", "compact_hetero_sample",
        "neighbor_sampling_heterogenous", "random_walk", "tempo_random_walk",
        "biased_tempo_random_walk", "hgt_sampling", "sample_hgt",
        "compact_hgt_sample", "budget_sampling", "sample_budget",
        "compact_budget_sample", "negative_sample_neighbors_homogenous",
        "negative_sample_neighbors_heterogenous"],
    "tch_geometric_tpu_torch.transforms": [
        "NeighborSamplerTransform", "HGTSamplerTransform",
        "NegativeSamplerTransform", "Batch", "HeteroBatch"],
    "tch_geometric_tpu_torch.loader": ["SeedLoader", "to_csc", "to_csr"],
    "tch_geometric_tpu_torch.native": ["available", "coo_to_csx", "ind2ptr"],
    "tch_geometric_tpu_torch.sampling.primitives": [
        "window_topk_sample", "window_choice_sample", "masked_gumbel_topk"],
    "tch_geometric_tpu_torch": [
        "neighbor_sampling_heterogenous", "sample_hetero_neighbors",
        "validate_mixeddata", "random_walk", "tempo_random_walk",
        "biased_tempo_random_walk", "hgt_sampling", "sample_hgt",
        "budget_sampling", "sample_budget",
        "negative_sample_neighbors_homogenous",
        "negative_sample_neighbors_heterogenous"],
    "tch_geometric_tpu_torch.models": ["keyed_dropout", "HGT", "HGTConv",
                                       "Node2Vec", "make_node2vec_trainer"],
}


@pytest.mark.parametrize("module,name", [(m, n) for m, names in
                                         EXPORTS.items() for n in names])
def test_ported_names_exported(module, name):
    """The multi-head GAT routes (B7, B8, B9), the int8 SpMM (B11), the
    training slice's entry points, the sampling slices' samplers, data and
    ops, the transforms and the loader, the HGT and node2vec models, the
    HGT and link trainers, and the mesh, multihost, partitioned graph,
    exchange, partitioned-trainer, distributed walk and negative sampler
    names are public names of the port; each
    ``_cuda`` wrapper carries a launch count."""
    import importlib
    obj = getattr(importlib.import_module(module), name)
    assert callable(obj)
    if name.endswith("_cuda") and name != "gat_attend_blocked_cuda":
        assert isinstance(obj.launches, int)


JAX_PACKAGES = {"tch_geometric_tpu": "tch_geometric_tpu_torch",
                "tch_geometric_tpu.data": "tch_geometric_tpu_torch.data",
                "tch_geometric_tpu.models": "tch_geometric_tpu_torch.models",
                "tch_geometric_tpu.sampling":
                    "tch_geometric_tpu_torch.sampling"}


@pytest.mark.parametrize("jax_module", sorted(JAX_PACKAGES))
def test_every_jax_name_exported(jax_module):
    """Every public name of the JAX top level and of its ``data``,
    ``models`` and ``sampling`` packages exists in the port's counterpart,
    save
    ``data.load_ogbn`` (it needs the ``ogb`` package and a download; the
    port reads the same data with ``load_ogbn_dir``)."""
    import importlib
    jmod = importlib.import_module(jax_module)
    ours = importlib.import_module(JAX_PACKAGES[jax_module])
    names = getattr(jmod, "__all__", None) or [
        n for n in dir(jmod) if not n.startswith("_")]
    missing = sorted(n for n in names if not hasattr(ours, n)
                     and (jax_module, n) != ("tch_geometric_tpu.data",
                                             "load_ogbn"))
    assert not missing, missing
    if jax_module == "tch_geometric_tpu":
        assert {"transforms", "loader"} <= set(ours.__all__)


def test_layer_and_model_devices_default_to_the_card():
    """Every public layer and model constructor of the port defaults to
    ``device="cuda"`` (read from the signature: no card needed)."""
    import inspect

    from tch_geometric_tpu_torch import models
    classes = [models.SAGEConv, models.GraphSAGE, models.GCNConv,
               models.GATConv, models.GINConv, models.GCN, models.GAT,
               models.GIN, models.HGTConv, models.HGT, models.Node2Vec]
    for cls in classes:
        dev = inspect.signature(cls).parameters["device"]
        assert dev.default == "cuda", cls.__name__
    for cls in (models.HGTConv, models.HGT):
        assert inspect.signature(cls).parameters["psum_axis"].default is None


# the distributed names still to port: the last slice took the last two
# (dist_hgt_sample, make_partitioned_hgt_trainer) off this list
DISTRIBUTED = set()


def test_every_jax_parallel_name_exported_but_the_distributed():
    """Every public name of the JAX ``parallel`` package, its submodules
    included (each package's submodules are imported first, so the names
    do not depend on what else the process imported), exists in the
    port's, save the named distributed ones, of which none is left; and
    none of those is in the port yet (a slice that ports one takes it off
    the list)."""
    import importlib
    import pkgutil
    jmod = importlib.import_module("tch_geometric_tpu.parallel")
    for m in pkgutil.iter_modules(jmod.__path__):
        importlib.import_module(f"tch_geometric_tpu.parallel.{m.name}")
    ours = importlib.import_module("tch_geometric_tpu_torch.parallel")
    for m in pkgutil.iter_modules(ours.__path__):
        importlib.import_module(f"tch_geometric_tpu_torch.parallel.{m.name}")
    names = {n for n in dir(jmod) if not n.startswith("_")}
    assert DISTRIBUTED <= names, sorted(DISTRIBUTED - names)
    missing = sorted(n for n in names - DISTRIBUTED if not hasattr(ours, n))
    assert not missing, missing
    ported = sorted(n for n in DISTRIBUTED if hasattr(ours, n))
    assert not ported, ported


def test_every_entry_point_defaults_num_rounds_to_auto():
    """The port's counterpart of ``tests/test_num_rounds_defaults.py::
    test_every_entry_point_defaults_to_auto``: every distributed entry
    point of the port with a ``num_rounds`` parameter defaults it to None
    (``resolve_num_rounds``: one round at P = 1, two at P > 1), so none
    drops overflowing requests by default."""
    import inspect

    from tch_geometric_tpu_torch.parallel import (dist_budget, dist_hetero,
                                                  dist_hgt, dist_negative,
                                                  dist_sampling, dist_walks,
                                                  hgt_train, link_train,
                                                  sharded_features)
    entry_points = [
        dist_sampling.dist_sample_neighbors,
        dist_sampling.make_partitioned_trainer,
        dist_sampling.make_partitioned_multibatch_trainer,
        dist_budget.dist_budget_sample,
        dist_budget.dist_budget_sample_hetero,
        dist_hetero.dist_hetero_neighbor_sample,
        dist_negative.dist_negative_sample,
        dist_negative.dist_negative_sample_hetero,
        dist_walks.dist_random_walk,
        dist_walks.dist_tempo_random_walk,
        dist_walks.dist_biased_tempo_random_walk,
        link_train.make_partitioned_link_trainer,
        sharded_features.make_sharded_feature_trainer,
        dist_hgt.dist_hgt_sample,
        hgt_train.make_partitioned_hgt_trainer,
    ]
    for f in entry_points:
        params = inspect.signature(f).parameters
        assert "num_rounds" in params, f.__qualname__
        assert params["num_rounds"].default is None, f.__qualname__
