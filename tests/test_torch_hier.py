"""The 2-axis mesh of the torch port against the JAX package, on the CPU.

* collectives over one axis of a multi-axis mesh: ``axis_index``,
  ``all_to_all``, ``psum``, ``pmean``, ``all_gather`` and ``ppermute``
  over each axis of a (2, 2) and a (2, 4) thread mesh and over
  ``("slice", "chip")``, exactly ``jax.lax``'s inside ``shard_map`` on the
  virtual CPU mesh (integral values, so every sum and mean is exact);
* ``spmd``'s placements by spec, ``Mesh.axis_index`` and
  ``Mesh.group_ranks`` on a (2, 4) mesh, and the sub-axis forms of
  ``barrier``, ``shard_checksums``, ``inject_shard_fault``, ``ring_spmm``
  and ``dist_sample_neighbors`` (a P = 2 axis of a (2, 2) mesh gives the
  P = 2 mesh's answers);
* ``_hier_feature_gather`` at (S, C) = (2, 4) equals JAX's bit for bit and
  the port's flat ``halo_gather`` over 8 ranks;
* ``make_partitioned_trainer`` and ``make_partitioned_multibatch_trainer``
  with ``hier=("slice", "chip")`` at (2, 2) and (2, 4), float32 and with
  bfloat16 rows in the exchange, against JAX's ``hier`` trainers at
  (2, 2) (flax parameters carried in, dropout 0; one JAX compile per
  trainer and dtype, which both shapes read, the curve not depending on
  (S, C)): three steps' losses within 1e-5 relative, overflow 0; the
  (2, 2) curve equals the flat P = 1 one;
* two gloo processes (``multihost.initialize`` over a ``file://`` store)
  with meshes of shape (2, 1) and (1, 2): the sub-axis collectives, a
  ``hier`` step and a DP+TP step equal the thread mesh's, which makes the
  ``dist.new_group`` groups and ``put_partitioned``'s specs run.
"""
import functools
import inspect
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from tch_geometric_tpu.data.io import load_karate_graph as jload_karate
from tch_geometric_tpu.data.storage import to_csc as jto_csc
from tch_geometric_tpu.models import GraphSAGE as JSAGE
from tch_geometric_tpu.parallel import dist_sampling as jds
from tch_geometric_tpu.parallel import sharded_features as jsf
from tch_geometric_tpu.parallel.train import TrainState as JTrainState
from tch_geometric_tpu_torch.models import GraphSAGE
from tch_geometric_tpu_torch.parallel import (
    barrier, build_interleaved_features, build_partitioned_graph,
    dist_sample_neighbors, inject_shard_fault, make_mesh,
    make_partitioned_multibatch_trainer, make_partitioned_trainer,
    shard_checksums)
from tch_geometric_tpu_torch.parallel import mesh as tmesh
from tch_geometric_tpu_torch.parallel.dist_sampling import (
    _hier_feature_gather)
from tch_geometric_tpu_torch.parallel.partition import (build_ring_shards,
                                                        pad_features,
                                                        ring_spmm)
from tch_geometric_tpu_torch.parallel.sharded_features import halo_gather
from tch_geometric_tpu_torch.sampling import rng
from tch_geometric_tpu_torch.utils.params import sage_params_from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("slice", "chip")
BOTH = ("slice", "chip")
F, HIDDEN, OUT, LR, STEPS = 8, 16, 4, 1e-2, 3
FANOUTS = [3, 2]


def _jmesh(S, C):
    return JMesh(np.array(jax.devices()[:S * C]).reshape(S, C), NAMES)


def _tmesh(S, C):
    return make_mesh((S, C), NAMES, device="cpu")


# ---------------------------------------------------------------------------
# Sub-axis collectives against jax.lax
# ---------------------------------------------------------------------------

def _collectives(xb, axis, n, lax):
    """The six collectives over ``axis`` (size ``n``) of a rank's block
    ``xb (n, 3)``, by ``lax`` (``jax.lax`` or the port's mesh module)."""
    ring = [(i, (i + 1) % n) for i in range(n)]
    return (lax.all_to_all(xb, axis, 0, 0) if lax is jax.lax
            else lax.all_to_all(xb, axis),
            lax.psum(xb, axis), lax.pmean(xb.astype(jnp.float32)
                                          if lax is jax.lax
                                          else xb.float(), axis),
            lax.all_gather(xb, axis), lax.ppermute(xb, axis, ring),
            lax.ppermute(xb, axis, [(0, n - 1)]))


@pytest.mark.parametrize("shape", [(2, 2), (2, 4)])
@pytest.mark.parametrize("axis", ["slice", "chip", BOTH])
def test_sub_axis_collectives_match_lax(shape, axis):
    S, C = shape
    P = S * C
    n = {"slice": S, "chip": C}.get(axis, P)
    x = (np.arange(P * n * 3).reshape(P, n, 3) * 7 % 23 - 5).astype(np.int32)
    jm = _jmesh(S, C)
    spec = JP(BOTH)

    @jax.jit
    @functools.partial(shard_map, mesh=jm, in_specs=spec, out_specs=spec)
    def jbody(xb):
        outs = _collectives(xb[0], axis, n, jax.lax)
        return tuple(o[None] for o in outs) + (
            jnp.asarray(jax.lax.axis_index(axis))[None],)

    with jm:
        want = [np.asarray(o) for o in jbody(jnp.asarray(x))]

    def tbody(xb):
        return _collectives(xb[0], axis, n, tmesh) + (
            torch.tensor(tmesh.axis_index(axis)),)

    got = tmesh.spmd(_tmesh(S, C), tbody, torch.from_numpy(x))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.reshape(g.shape))


def test_mesh_groups_and_placements():
    m = _tmesh(2, 4)
    assert m.axis_size("chip") == 4 and m.axis_size(BOTH) == 8
    assert m.axis_index("chip", 6) == 2 and m.axis_index(BOTH, 6) == 6
    assert m.group_ranks("slice", 6) == (2, 6)
    assert m.group_ranks("chip", 6) == (4, 5, 6, 7)
    assert m.group_ranks(BOTH, 6) == tuple(range(8))
    with pytest.raises(ValueError, match="mesh's order"):
        m.axes(("chip", "slice"))
    with pytest.raises(ValueError, match="no axis"):
        m.axis_size("data")
    x = torch.arange(24).reshape(8, 3)

    def body(by_chip, by_both, stripes, whole):
        return by_chip, by_both, stripes, whole

    c, b, s, w = tmesh.spmd(
        m, body, tmesh.Split(x[:4], ("chip",)), tmesh.Split(x, (BOTH,)),
        tmesh.Split(x.T, (None, BOTH)), tmesh.Split(x, ()))
    for r in range(8):
        torch.testing.assert_close(c[r], x[r % 4: r % 4 + 1])
        torch.testing.assert_close(b[r], x[r: r + 1])
        torch.testing.assert_close(s[r], x.T[:, r: r + 1])
        torch.testing.assert_close(w[r], x)
    assert tmesh.Placement(m, (None, "chip")).local(x.T, 6).shape == (3, 2)


def test_resilience_partition_and_sampler_over_a_sub_axis():
    """A P = 2 axis of a (2, 2) mesh answers as a P = 2 mesh does."""
    sub, flat = make_mesh((2, 2), device="cpu"), make_mesh((2, 1),
                                                            device="cpu")
    assert barrier(sub, axis="data", timeout_s=60.0)
    x = torch.arange(32.0).reshape(8, 4) - 9.0
    for fn in (lambda m: shard_checksums(x, m),
               lambda m: inject_shard_fault(x, 1, m, mode="flip")):
        torch.testing.assert_close(fn(sub), fn(flat), rtol=0, atol=0)
    _x, _y, ei = jload_karate()
    ei = np.asarray(ei)
    feats = pad_features(np.random.default_rng(1).normal(
        size=(34, 5)).astype(np.float32), 2)
    shards = build_ring_shards(ei, 34, 2, device="cpu")
    torch.testing.assert_close(
        ring_spmm(shards, torch.from_numpy(feats), sub, axis="model"),
        ring_spmm(shards, torch.from_numpy(feats), flat), rtol=0, atol=0)
    cp, ri, _ = jto_csc(ei, 34)
    g = build_partitioned_graph(np.asarray(cp), np.asarray(ri), 2,
                                device="cpu")
    a, ao = dist_sample_neighbors(rng.key(3), g, np.arange(8), FANOUTS, sub,
                                  axis="model", capacity_factor=2.0)
    b, bo = dist_sample_neighbors(rng.key(3), g, np.arange(8), FANOUTS, flat,
                                  capacity_factor=2.0)
    for f in ("nodes", "node_valid", "eptr", "edge_valid"):
        torch.testing.assert_close(getattr(a, f), getattr(b, f), rtol=0,
                                   atol=0)
    torch.testing.assert_close(ao, bo)


# ---------------------------------------------------------------------------
# The hierarchical feature fetch
# ---------------------------------------------------------------------------

def test_hier_feature_gather_matches_jax_and_flat():
    S, C = 2, 4
    P = S * C
    r = np.random.default_rng(0)
    N, Fx, L = 203, 16, 64
    x = r.standard_normal((N, Fx)).astype(np.float32)
    xi = build_interleaved_features(x, P)
    ids = r.integers(0, N, (P, L)).astype(np.int32)
    valid = r.random((P, L)) < 0.9
    cap = 24                      # a few owners overflow one round
    jm = _jmesh(S, C)
    spec = JP(BOTH)

    @jax.jit
    @functools.partial(shard_map, mesh=jm, in_specs=(spec, spec, spec),
                       out_specs=(spec, spec))
    def jhier(x_shard, ids_l, valid_l):
        rows, ovf = jds._hier_feature_gather(
            x_shard, ids_l[0], ax_slice="slice", ax_chip="chip",
            num_slices=S, chips_per_slice=C, capacity=cap, valid=valid_l[0],
            num_rounds=2)
        return rows[None], ovf[None][None]

    with jm:
        jrows, jovf = (np.asarray(a) for a in jhier(
            jnp.asarray(xi), jnp.asarray(ids), jnp.asarray(valid)))

    def hier(x_shard, ids_l, valid_l):
        return _hier_feature_gather(
            x_shard, ids_l[0].long(), ax_slice="slice", ax_chip="chip",
            num_slices=S, chips_per_slice=C, capacity=cap, valid=valid_l[0],
            num_rounds=2)

    def flat(x_shard, ids_l, valid_l):
        return halo_gather(x_shard, ids_l[0].long(), axis="data",
                           num_parts=P, capacity=L, valid=valid_l[0])

    args = [torch.from_numpy(a) for a in (xi, ids, valid)]
    trows, tovf = tmesh.spmd(_tmesh(S, C), hier, *args)
    frows, fovf = tmesh.spmd(make_mesh((P, 1), device="cpu"), flat, *args)
    np.testing.assert_array_equal(trows.numpy(), jrows.reshape(trows.shape))
    np.testing.assert_array_equal(tovf.numpy(), jovf.reshape(-1))
    assert int(fovf.sum()) == 0
    ok = ~(tovf.reshape(P, 1) > 0).expand(P, L).numpy() | ~valid
    np.testing.assert_array_equal(np.where(ok[..., None], trows.numpy(), 0),
                                  np.where(ok[..., None], frows.numpy(), 0))
    np.testing.assert_array_equal(frows.numpy()[valid], x[ids[valid]])


# ---------------------------------------------------------------------------
# The hier trainers against JAX's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def karate_setup():
    _x, y, ei = jload_karate()
    cp, ri, _ = jto_csc(np.asarray(ei), 34)
    x = np.random.default_rng(0).normal(size=(34, F)).astype(np.float32)
    return dict(cp=np.asarray(cp), ri=np.asarray(ri), x=x, y=np.asarray(y))


def _flax_params(seed=0):
    r = np.random.default_rng(seed)
    dims = [F, HIDDEN, OUT]
    p = {}
    for i in range(2):
        p[f"conv{i}"] = {
            "lin_self": {
                "kernel": r.normal(size=dims[i:i + 2]).astype(np.float32)
                * 0.4,
                "bias": r.normal(size=dims[i + 1]).astype(np.float32) * 0.1},
            "lin_neigh": {
                "kernel": r.normal(size=dims[i:i + 2]).astype(np.float32)
                * 0.4}}
    return jax.tree_util.tree_map(jnp.asarray, {"params": p})


def _batches(ks, multi):
    seeds = np.arange(16, dtype=np.int32) * 5 % 34
    if multi:
        seeds = seeds.reshape(2, 8)
    return seeds, ks["y"][seeds]


def _jax_hier_curve(ks, S, C, params, multi, exchange_dtype):
    jm = _jmesh(S, C)
    make = (jds.make_partitioned_multibatch_trainer if multi
            else jds.make_partitioned_trainer)
    jstep = make(JSAGE(hidden=HIDDEN, out=OUT, num_layers=2), FANOUTS, jm,
                 learning_rate=LR, capacity_factor=3.0, hier=BOTH,
                 exchange_dtype=exchange_dtype)[1]
    jg = jds.build_partitioned_graph(ks["cp"], ks["ri"], C)
    seeds, labels = _batches(ks, multi)
    data = JP(None, BOTH) if multi else JP(BOTH)
    out = []
    with jm:
        g = jax.device_put(jg, NamedSharding(jm, JP("chip")))
        xi = jax.device_put(jnp.asarray(jsf.build_interleaved_features(
            ks["x"], S * C)), NamedSharding(jm, JP(BOTH)))
        s, lab = (jax.device_put(jnp.asarray(a), NamedSharding(jm, data))
                  for a in (seeds, labels))
        state = JTrainState(params, optax.adam(LR).init(params),
                            jnp.zeros((), jnp.int32))
        for i in range(STEPS):
            state, loss, _, ovf = jstep(
                state, jax.random.fold_in(jax.random.key(6), i), g, xi, s,
                lab)
            assert int(ovf) == 0
            out.append(np.asarray(loss))
    return np.stack(out)


def _port_hier_curve(ks, S, C, params, multi, exchange_dtype, hier=BOTH):
    m = GraphSAGE(F, HIDDEN, OUT, 2, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    m.load_state_dict(sage_params_from_flax(params))
    make = (make_partitioned_multibatch_trainer if multi
            else make_partitioned_trainer)
    mesh = _tmesh(S, C) if hier else make_mesh((S * C, 1), device="cpu")
    tr = make(m, FANOUTS, mesh, learning_rate=LR, capacity_factor=3.0,
              hier=hier, exchange_dtype=exchange_dtype)
    g = build_partitioned_graph(ks["cp"], ks["ri"], C if hier else S * C,
                                device="cpu")
    xi = torch.from_numpy(build_interleaved_features(ks["x"], S * C))
    seeds, labels = _batches(ks, multi)
    st, out = tr.init_fn(), []
    for i in range(STEPS):
        st, loss, _, ovf = tr.train_step(st, rng.fold_in(rng.key(6), i), g,
                                         xi, seeds, labels)
        assert int(ovf) == 0
        out.append(loss.numpy())
    assert st.step == STEPS
    return np.stack(out)


@pytest.fixture(scope="module")
def jax_hier_curves(karate_setup):
    """JAX's ``hier`` curve at (2, 2) and its flax parameters, by
    ``(multi, dtype)``, each compiled once for the module: the curve does
    not depend on (S, C) (the (2, 2) case equals the flat P = 1 one), so
    both shapes' cases read the same one."""
    memo = {}

    def curve(multi, dtype):
        if (multi, dtype) not in memo:
            params = _flax_params(int(multi) + 2 * (dtype is not None))
            memo[multi, dtype] = params, _jax_hier_curve(
                karate_setup, 2, 2, params, multi,
                jnp.bfloat16 if dtype else None)
        return memo[multi, dtype]

    return curve


@pytest.mark.parametrize("multi,shape,dtype", [
    (False, (2, 2), None), (False, (2, 4), None), (True, (2, 2), None),
    (True, (2, 4), None), (False, (2, 2), "bf16"), (True, (2, 2), "bf16")])
def test_hier_trainers_match_jax(karate_setup, jax_hier_curves, multi,
                                 shape, dtype):
    ks = karate_setup
    params, want = jax_hier_curves(multi, dtype)
    S, C = shape
    got = _port_hier_curve(ks, S, C, params, multi,
                           torch.bfloat16 if dtype else None)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    if shape == (2, 2) and dtype is None:
        flat = _port_hier_curve(ks, 1, 1, params, multi, None, hier=None)
        np.testing.assert_allclose(got, flat, rtol=1e-5)


# ---------------------------------------------------------------------------
# Two gloo processes against the thread mesh
# ---------------------------------------------------------------------------

_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    from tch_geometric_tpu_torch.parallel import multihost
    store, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    multihost.initialize("file://" + store, 2, rank, device="cpu",
                         timeout_s=120)
    res = {}
    for shape in ((2, 1), (1, 2)):
        # a host holds (1, C) processes, the first axis strides over hosts
        res.update(_gloo_run(shape, lambda names: multihost.make_mesh(
            names, ici_shape=(1, shape[1]), dcn_axis=names[0],
            device="cpu")))
    np.savez(out, **res)
    multihost.shutdown()
""")


def _gloo_run(shape, mesh_of):
    """Every value the two-process test compares, at mesh shape ``shape``
    (a thread mesh or one gloo process's view: blocks ``(1, ...)``).  It
    imports what it needs itself: the workers run its source without this
    module's JAX imports."""
    import numpy as np
    import torch
    from tch_geometric_tpu_torch.data import load_karate_graph
    from tch_geometric_tpu_torch.data.graph import make_graph
    from tch_geometric_tpu_torch.data.storage import to_csc
    from tch_geometric_tpu_torch.models import GraphSAGE
    from tch_geometric_tpu_torch.parallel import (
        build_interleaved_features, build_partitioned_graph,
        make_gnn_trainer, make_partitioned_trainer)
    from tch_geometric_tpu_torch.parallel import mesh as mm
    from tch_geometric_tpu_torch.sampling import rng
    NAMES = BOTH = ("slice", "chip")
    FANOUTS = [3, 2]
    tag = f"{shape[0]}x{shape[1]}"
    res = {}
    m = mesh_of(NAMES)
    assert m.shape == dict(zip(NAMES, shape))
    x = torch.arange(2 * 2 * 3).reshape(2, 2, 3) * 3 - 4

    def body(xb):
        out = []
        for axis in ("slice", "chip", BOTH):
            n = mm.current_mesh().axis_size(axis)
            xa = xb[0][:n]
            out += [mm.all_to_all(xa, axis), mm.psum(xa, axis),
                    mm.pmean(xa.double(), axis), mm.all_gather(xa, axis),
                    mm.ppermute(xa, axis, [(i, (i + 1) % n)
                                           for i in range(n)]),
                    torch.tensor(mm.axis_index(axis))]
        return out

    for i, v in enumerate(mm.spmd(m, body, x)):
        res[f"{tag}_c{i}"] = v.numpy()
    xk, yk, ei = load_karate_graph()
    cp, ri, perm = to_csc(ei, 34)
    xk = xk.astype(np.float32)
    S, C = shape
    g = build_partitioned_graph(cp, ri, C, device="cpu")
    model = GraphSAGE(34, 16, 4, 2, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    tr = make_partitioned_trainer(model, FANOUTS, m, capacity_factor=2.0,
                                  hier=BOTH)
    st = tr.init_fn()
    xi = build_interleaved_features(xk, 2)
    losses = []
    for _ in range(2):
        st, loss, _, ovf = tr.train_step(st, rng.key(3), g, xi,
                                         np.arange(8), yk[:8])
        assert int(ovf) == 0
        losses.append(float(loss))
    res[f"{tag}_hier"] = np.array(losses)
    dm = mesh_of(("data", "model"))
    assert dm.shape == {"data": S, "model": C}
    cg = make_graph(cp, ri, perm, num_src=34, num_dst=34, device="cpu")
    model = GraphSAGE(34, 16, 4, 2, dropout=0.5, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    tr = make_gnn_trainer(model, FANOUTS, mesh=dm)
    st, losses = tr.init_fn(), []
    for _ in range(2):
        st, loss, _ = tr.train_step(st, rng.key(4), cg, torch.from_numpy(xk),
                                    np.arange(8), yk[:8])
        losses.append(float(loss))
    res[f"{tag}_dptp"] = np.array(losses)
    return res


def test_two_gloo_processes_sub_axes_match_the_thread_mesh(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(inspect.getsource(_gloo_run) + _WORKER)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    store = str(tmp_path / "store")
    procs = [subprocess.Popen(
        [sys.executable, str(script), store, str(r),
         str(tmp_path / f"out{r}.npz")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=150)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
                p.wait(timeout=10)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    outs = [np.load(tmp_path / f"out{r}.npz") for r in range(2)]
    for shape in ((2, 1), (1, 2)):
        want = _gloo_run(shape, lambda names: make_mesh(shape, names,
                                                        device="cpu"))
        for k, v in want.items():
            for r in range(2):
                got = outs[r][k]
                if k.endswith(("_hier", "_dptp")):
                    np.testing.assert_allclose(got, v, rtol=1e-6)
                else:
                    np.testing.assert_array_equal(got[0], v[r])
