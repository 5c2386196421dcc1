"""The port's mesh layer against the JAX package, on the CPU.

* the thread mesh's collectives (``all_to_all``, ``all_reduce``,
  ``all_gather``, ``ppermute``) against their definitions, and the runner's
  failure paths: a rank that raises, and a rank that never reaches a
  collective, fail the call within the barrier's timeout, which counts
  from the last arrival (ranks working in turn past it in all complete);
* ``halo_gather`` (exact, one round and retry rounds), ``ring_spmm``
  (1e-6) and ``alltoall_gather`` (exact) against the JAX functions on
  ``Mesh(jax.devices()[:P])``; ``build_interleaved_features``;
* the routing plan: ``_route_to_owners``'s ranks, round masks and packed
  slots exactly JAX's, and ``exchange_rounds`` under a frontier skewed onto
  one owner, one and two rounds, with its overflow;
* ``barrier``, ``shard_checksums`` and ``inject_shard_fault`` against
  JAX's; ``make_mesh``, the placements, ``shard_params`` and the
  multihost helpers;
* two gloo processes (``multihost.initialize`` over a ``file://`` store)
  give the thread mesh's P = 2 sample blocks bit-exactly, and the same
  train-step loss; their group refuses a CUDA mesh (NCCL or nothing).
"""
import functools
import os
import subprocess
import sys
import textwrap
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from tch_geometric_tpu.parallel import dist_sampling as jds
from tch_geometric_tpu.parallel import partition as jpart
from tch_geometric_tpu.parallel import resilience as jres
from tch_geometric_tpu.parallel import sharded_features as jsf
from tch_geometric_tpu_torch.parallel import dist_sampling as tds
from tch_geometric_tpu_torch.parallel import mesh as tmesh
from tch_geometric_tpu_torch.parallel import multihost
from tch_geometric_tpu_torch.parallel import (barrier,
                                              build_interleaved_features,
                                              data_sharding,
                                              inject_shard_fault, make_mesh,
                                              param_sharding_rule, replicated,
                                              shard_checksums, shard_params)
from tch_geometric_tpu_torch.parallel.partition import (alltoall_gather,
                                                        build_ring_shards,
                                                        pad_features,
                                                        ring_spmm)
from tch_geometric_tpu_torch.parallel.sharded_features import halo_gather

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jmesh(n):
    return JMesh(np.array(jax.devices()[:n]), ("data",))


def _tmesh(n, **kw):
    return make_mesh((n, 1), device="cpu", **kw)


# ---------------------------------------------------------------------------
# The thread mesh's collectives and runner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("P", [1, 2, 4])
def test_thread_collectives(P):
    mesh = _tmesh(P)
    x = torch.arange(P * P * 3, dtype=torch.float32).reshape(P, P, 3)

    def body(xb):
        me = tmesh.axis_index("data")
        ring = [(i, (i + 1) % P) for i in range(P)]
        return (tmesh.all_to_all(xb[0], "data"), tmesh.psum(xb[0], "data"),
                tmesh.pmean(xb[0], "data"), tmesh.all_gather(xb[0], "data"),
                tmesh.ppermute(xb[0], "data", ring),
                tmesh.ppermute(xb[0], "data", [(0, P - 1)]),
                torch.tensor(me))

    a2a, s, m, g, perm, one, me = tmesh.spmd(mesh, body, x)
    assert me.tolist() == list(range(P))
    for d in range(P):
        torch.testing.assert_close(a2a[d], x[:, d], rtol=0, atol=0)
        torch.testing.assert_close(s[d], x.sum(0), rtol=0, atol=0)
        torch.testing.assert_close(m[d], x.sum(0) / P, rtol=0, atol=0)
        torch.testing.assert_close(g[d], x, rtol=0, atol=0)
        torch.testing.assert_close(perm[d], x[(d - 1) % P], rtol=0, atol=0)
        want = x[0] if d == P - 1 else torch.zeros_like(x[0])
        torch.testing.assert_close(one[d], want, rtol=0, atol=0)


def test_failing_rank_fails_the_call():
    """A rank that raises aborts the barrier: the others leave their waits
    at once and the runner re-raises the rank's own error."""
    mesh = _tmesh(4, timeout_s=30.0)

    def body(xb):
        if tmesh.axis_index("data") == 2:
            raise ValueError("rank 2 failed")
        return tmesh.psum(xb, "data")

    t0 = time.perf_counter()
    with pytest.raises(ValueError, match="rank 2 failed"):
        tmesh.spmd(mesh, body, torch.ones(4))
    assert time.perf_counter() - t0 < 10.0
    # the mesh runs again afterwards
    out = tmesh.spmd(mesh, lambda xb: tmesh.psum(xb, "data"), torch.ones(4))
    assert out.tolist() == [[4.0]] * 4


def test_hung_rank_times_out():
    """A rank that never reaches the collective the others wait in: the
    waits time out and the call raises instead of hanging."""
    mesh = _tmesh(2, timeout_s=1.0)

    def body(xb):
        if tmesh.axis_index("data") == 0:
            return xb
        return tmesh.psum(xb, "data")

    t0 = time.perf_counter()
    with pytest.raises(threading.BrokenBarrierError):
        tmesh.spmd(mesh, body, torch.ones(2))
    assert time.perf_counter() - t0 < 10.0


def test_timeout_bounds_one_rank_segment_not_the_turns():
    """The ranks work in turn, so rank 0 waits through the others' work:
    three 1.2 s segments before one collective outlast a 2 s timeout in
    all, but each fits, and the call completes."""
    mesh = _tmesh(3, timeout_s=2.0)

    def body(xb):
        time.sleep(1.2)
        return tmesh.psum(xb, "data")

    out = tmesh.spmd(mesh, body, torch.ones(3))
    assert out.tolist() == [[3.0]] * 3


def test_mesh_shapes_placements_and_multihost_single_process():
    m = make_mesh(device="cpu")
    assert m.shape == {"data": 1, "model": 1} and m.size == 1
    m8 = make_mesh((2, 4), device="cpu")
    assert m8.shape == {"data": 2, "model": 4}
    assert m8.coords(5) == {"data": 1, "model": 1}
    assert m8.axis_size("data") == 2 and m8.axis_size("model") == 4
    assert m8.axis_size(("data", "model")) == 8
    assert data_sharding(m8).spec == ("data",)
    assert replicated(m8).spec == ()
    w = torch.arange(24.0).reshape(3, 8)
    b = torch.arange(3.0)
    assert param_sharding_rule("w", w, m8).spec == (None, "model")
    assert param_sharding_rule("b", b, m8).spec == ()
    local = shard_params({"w": w, "b": b}, m8, rank=6)       # model index 2
    torch.testing.assert_close(local["w"], w[:, 4:6])
    torch.testing.assert_close(local["b"], b)
    assert data_sharding(m8).local(torch.arange(8.0), rank=5).tolist() == \
        [4.0, 5.0, 6.0, 7.0]

    mm = multihost.make_mesh(("data", "model"), ici_shape=(2, 4),
                             device="cpu")
    assert mm.shape == {"data": 2, "model": 4}
    assert multihost.make_mesh(device="cpu").shape == {"data": 1}
    assert multihost.local_seed_shard(100) == (0, 100)
    t = multihost.put_partitioned({"a": np.arange(4), "b": None}, m8)
    assert torch.is_tensor(t["a"]) and t["b"] is None
    assert multihost.global_from_local(np.arange(3), m8).tolist() == [0, 1, 2]
    assert multihost.replicated([1, 2], m8).tolist() == [1, 2]


# ---------------------------------------------------------------------------
# Feature exchange and ring aggregation against JAX
# ---------------------------------------------------------------------------

def test_interleaved_layout_matches_jax():
    x = np.random.default_rng(0).normal(size=(10, 3)).astype(np.float32)
    for P in (1, 3, 4):
        want = np.asarray(jsf.build_interleaved_features(x, P))
        np.testing.assert_array_equal(build_interleaved_features(x, P), want)
        np.testing.assert_array_equal(
            build_interleaved_features(torch.from_numpy(x), P).numpy(), want)


@pytest.mark.parametrize("P,cf,rounds,skew",
                         [(4, 2.0, 1, False), (4, 1.2, 1, False),
                          (4, 0.5, 1, True), (4, 0.5, 6, True),
                          (1, 1.3, 1, False)])
def test_halo_gather_matches_jax(P, cf, rounds, skew):
    rng_np = np.random.default_rng(0)
    n, f, L = 41, 5, 12
    x = rng_np.normal(size=(n, f)).astype(np.float32)
    xi = build_interleaved_features(x, P)
    if skew:           # every request aimed at owner 0
        ids = (P * rng_np.integers(0, n // P, size=(P, L))).astype(np.int32)
    else:
        ids = rng_np.integers(0, n, size=(P, L)).astype(np.int32)
    valid = rng_np.random((P, L)) > 0.2
    capacity = int(np.ceil(cf * L / P))
    jm = _jmesh(P)

    @jax.jit
    @functools.partial(jax.shard_map, mesh=jm,
                       in_specs=(JP("data"), JP("data"), JP("data")),
                       out_specs=(JP("data"), JP("data")))
    def jrun(xs, il, vl):
        rows, ovf = jsf.halo_gather(xs, il[0], axis="data", num_parts=P,
                                    capacity=capacity, valid=vl[0],
                                    num_rounds=rounds)
        return rows[None], ovf[None]

    jrows, jovf = jrun(jnp.asarray(xi), jnp.asarray(ids), jnp.asarray(valid))

    def body(xs, il, vl):
        return halo_gather(xs, il[0].long(), axis="data", num_parts=P,
                           capacity=capacity, valid=vl[0], num_rounds=rounds)

    rows, ovf = tmesh.spmd(_tmesh(P), body, torch.from_numpy(xi),
                           torch.from_numpy(ids), torch.from_numpy(valid))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    np.testing.assert_array_equal(ovf.numpy(), np.asarray(jovf))
    if skew:
        assert (int(ovf.sum()) > 0) == (rounds == 1)


@pytest.mark.parametrize("P", [1, 2, 4])
def test_ring_spmm_and_alltoall_gather_match_jax(karate, P):
    _x, _y, edge_index = karate
    N = 34
    x = np.random.default_rng(0).normal(size=(N, 8)).astype(np.float32)
    xp = pad_features(x, P)
    jm = _jmesh(P)
    sh = NamedSharding(jm, JP("data"))
    want = np.asarray(jpart.ring_spmm(
        jpart.build_ring_shards(np.asarray(edge_index), N, P),
        jax.device_put(jnp.asarray(xp), sh), jm))
    got = ring_spmm(build_ring_shards(edge_index, N, P, device="cpu"),
                    torch.from_numpy(xp), _tmesh(P))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)

    Rp, R = xp.shape[0] // P, 3
    req = np.random.default_rng(1).integers(0, Rp, (P, P, R)).astype(np.int32)
    want = np.asarray(jpart.alltoall_gather(
        jax.device_put(jnp.asarray(xp), sh),
        jax.device_put(jnp.asarray(req), sh), jm))
    got = alltoall_gather(torch.from_numpy(xp), torch.from_numpy(req),
                          _tmesh(P))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("P,capacity", [(4, 3), (3, 2), (1, 40), (1, 50)])
def test_route_to_owners_matches_jax(P, capacity):
    r = np.random.default_rng(P)
    L = 40
    owner = r.integers(0, P, L).astype(np.int32)
    valid = r.random(L) > 0.25
    payload = r.integers(-50, 50, (L, 3)).astype(np.int32)
    jr = jds._route_to_owners(jnp.asarray(owner), jnp.asarray(valid), P,
                              capacity)
    tr = tds._route_to_owners(torch.from_numpy(owner).long(),
                              torch.from_numpy(valid), P, capacity)
    np.testing.assert_array_equal(tr.rank.numpy(), np.asarray(jr.rank))
    np.testing.assert_array_equal(tr.ok.numpy(), np.asarray(jr.ok))
    assert tr.max_rounds == jr.max_rounds
    for rnd in range(3):
        np.testing.assert_array_equal(tr.in_round(rnd).numpy(),
                                      np.asarray(jr.in_round(rnd)))
        packed = tr.scatter(torch.from_numpy(payload), rnd)
        np.testing.assert_array_equal(
            packed.numpy(), np.asarray(jr.scatter(jnp.asarray(payload), rnd)))
        back = torch.arange(packed.numel()).reshape(packed.shape)
        ir = tr.in_round(rnd).numpy()
        np.testing.assert_array_equal(
            tr.pickup(back, rnd).numpy()[ir],
            np.asarray(jr.pickup(jnp.asarray(back.numpy()), rnd))[ir])


@pytest.mark.parametrize("rounds", [1, 2])
def test_exchange_rounds_skewed_frontier_matches_jax(rounds):
    """Every request aimed at owner 0: capacity 3 of 8 a round, so one
    round drops some and two carry more; results and overflow exact."""
    P, L, C = 4, 8, 3
    r = np.random.default_rng(0)
    owner = np.zeros((P, L), np.int32)
    valid = r.random((P, L)) > 0.1
    payload = r.integers(0, 1000, (P, L, 2)).astype(np.int32)

    def jowner(recv):
        me = jax.lax.axis_index("data")
        return recv * 3 + me

    @jax.jit
    @functools.partial(jax.shard_map, mesh=_jmesh(P),
                       in_specs=(JP("data"),) * 3,
                       out_specs=(JP("data"),) * 3)
    def jrun(pl, ow, va):
        out, got, ovf = jds.exchange_rounds(
            pl[0], ow[0], va[0], jowner, axis="data", num_parts=P,
            capacity=C, num_rounds=rounds, ret_cols=2)
        return out[None], got[None], ovf[None]

    def body(pl, ow, va):
        me = tmesh.axis_index("data")
        return tds.exchange_rounds(
            pl[0], ow[0].long(), va[0], lambda recv: recv * 3 + me,
            axis="data", num_parts=P, capacity=C, num_rounds=rounds,
            ret_cols=2)

    jo, jg, jovf = jrun(jnp.asarray(payload), jnp.asarray(owner),
                        jnp.asarray(valid))
    to, tg, tovf = tmesh.spmd(_tmesh(P), body, torch.from_numpy(payload),
                              torch.from_numpy(owner),
                              torch.from_numpy(valid))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(tovf.numpy(), np.asarray(jovf))
    assert int(tovf.sum()) == int(valid.sum()) - P * min(L, rounds * C) \
        or rounds * C >= L


def test_barrier_checksums_and_fault_injection_match_jax():
    P = 4
    jm, tm = _jmesh(P), _tmesh(P)
    assert jres.barrier(jm, timeout_s=120.0)
    assert barrier(tm, timeout_s=120.0)
    x = np.arange(64, dtype=np.float32).reshape(8, 8) - 20.0
    xs = jax.device_put(jnp.asarray(x), NamedSharding(jm, JP("data")))
    xt = torch.from_numpy(x)
    base = shard_checksums(xt, tm)
    np.testing.assert_array_equal(base.numpy(),
                                  np.asarray(jres.shard_checksums(xs, jm)))
    for dev, mode in ((3, "zero"), (1, "flip")):
        bad = inject_shard_fault(xt, dev, tm, mode=mode)
        np.testing.assert_array_equal(
            bad.numpy(), np.asarray(jres.inject_shard_fault(xs, dev, jm,
                                                            mode=mode)))
        after = shard_checksums(bad, tm)
        diff = torch.nonzero(base != after).reshape(-1).tolist()
        assert diff == ([dev] if mode == "zero" else [])
    with pytest.raises(ValueError):
        inject_shard_fault(xt, 0, tm, mode="melt")


def test_barrier_reports_a_hung_mesh():
    """``barrier`` returns False when the collective does not finish in
    time (a mesh whose ranks wait longer than the host's timeout)."""
    class Stuck(tmesh.ThreadComm):
        def all_reduce(self, x, op="sum"):
            time.sleep(3.0)
            return super().all_reduce(x, op)

    mesh = make_mesh((2, 1), device="cpu", comm=Stuck(2))
    assert not barrier(mesh, timeout_s=0.5)


# ---------------------------------------------------------------------------
# Two gloo processes against the thread mesh
# ---------------------------------------------------------------------------

_WORKER = textwrap.dedent("""
    import sys
    import numpy as np, torch
    from tch_geometric_tpu_torch.data import load_karate_graph
    from tch_geometric_tpu_torch.data.storage import to_csc
    from tch_geometric_tpu_torch.models import GraphSAGE
    from tch_geometric_tpu_torch.parallel import (
        build_interleaved_features, build_partitioned_graph,
        dist_sample_neighbors, make_partitioned_trainer, multihost)
    from tch_geometric_tpu_torch.sampling import rng
    store, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    multihost.initialize("file://" + store, 2, rank, device="cpu",
                         timeout_s=120)
    mesh = multihost.make_mesh(("data",), device="cpu")
    assert mesh.shape == {"data": 2} and mesh.comm.rank() == rank
    from tch_geometric_tpu_torch.parallel.mesh import ProcessGroupComm
    try:                 # a CUDA mesh never runs over a gloo group
        ProcessGroupComm("cuda")
        raise SystemExit("a gloo group served a CUDA mesh")
    except RuntimeError as e:
        assert "nccl" in str(e), e
    x, y, ei = load_karate_graph()
    cp, ri, _ = to_csc(ei, 34)
    g = build_partitioned_graph(cp, ri, 2, device="cpu")
    s, ovf = dist_sample_neighbors(rng.key(7), g, np.arange(8), (4, 3), mesh,
                                   capacity_factor=1.5)
    m = GraphSAGE(34, 16, 4, 2, device="cpu",
                  generator=torch.Generator().manual_seed(rank))
    tr = make_partitioned_trainer(m, [4, 3], mesh, capacity_factor=2.0)
    st = tr.init_fn()
    xi = build_interleaved_features(x.astype(np.float32), 2)
    losses = []
    for _ in range(2):
        st, loss, acc, o = tr.train_step(st, rng.key(3), g, xi,
                                         np.arange(16), y[:16])
        losses.append(float(loss))
    np.savez(out, nodes=s.nodes.numpy(), valid=s.node_valid.numpy(),
             eptr=s.eptr.numpy(), ovf=ovf.numpy(), losses=np.array(losses))
    multihost.shutdown()
""")


def test_two_gloo_processes_match_the_thread_mesh(tmp_path):
    from tch_geometric_tpu_torch.data import load_karate_graph
    from tch_geometric_tpu_torch.data.storage import to_csc
    from tch_geometric_tpu_torch.models import GraphSAGE
    from tch_geometric_tpu_torch.parallel import (build_partitioned_graph,
                                                  dist_sample_neighbors,
                                                  make_partitioned_trainer)
    from tch_geometric_tpu_torch.sampling import rng

    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    store = str(tmp_path / "store")
    procs = [subprocess.Popen(
        [sys.executable, str(script), store, str(r),
         str(tmp_path / f"out{r}.npz")], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
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

    x, y, ei = load_karate_graph()
    cp, ri, _ = to_csc(ei, 34)
    g = build_partitioned_graph(cp, ri, 2, device="cpu")
    mesh = _tmesh(2)
    s, ovf = dist_sample_neighbors(rng.key(7), g, np.arange(8), (4, 3),
                                   mesh, capacity_factor=1.5)
    for r in range(2):
        assert outs[r]["nodes"].shape[0] == 1
        np.testing.assert_array_equal(outs[r]["nodes"][0], s.nodes[r])
        np.testing.assert_array_equal(outs[r]["valid"][0], s.node_valid[r])
        np.testing.assert_array_equal(outs[r]["eptr"][0], s.eptr[r])
        np.testing.assert_array_equal(outs[r]["ovf"][0], ovf[r])
    # rank 1 built its model from another seed: init_fn made it rank 0's
    m = GraphSAGE(34, 16, 4, 2, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    tr = make_partitioned_trainer(m, [4, 3], mesh, capacity_factor=2.0)
    st = tr.init_fn()
    xi = build_interleaved_features(x.astype(np.float32), 2)
    losses = []
    for _ in range(2):
        st, loss, _, _ = tr.train_step(st, rng.key(3), g, xi, np.arange(16),
                                       y[:16])
        losses.append(float(loss))
    for r in range(2):
        np.testing.assert_allclose(outs[r]["losses"], losses, rtol=1e-6)
