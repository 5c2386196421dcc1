"""The torch port's HGT layer and model against the JAX package's, on the
CPU, with flax parameters carried in by ``hgt_params_from_flax``:

* ``HGTConv`` forward in both layouts (per relation and relation-batched),
  float32, rtol 1e-5, atol 1e-6, on inputs as wide as the layer (the skip
  gate mixes them in) and of another width (no residual), with a relation
  that has no edges;
* ``HGT`` forward on padded edges with invalid slots, both layouts, in
  float32 (rtol 1e-5, atol 1e-6) and bfloat16 (2e-2 of the largest value),
  and its gradients in float32 (rtol 1e-4, atol 1e-7: the softmax's max
  is a scatter-amax whose ties split the gradient, which cancels in exact
  arithmetic);
* the relation without edges keeps the port's init and takes no gradient;
* ``_lecun_normal_``'s std against flax's ``lecun_normal`` on (H, D),
  (H, d, d) and (R, H, d, d) draws (2%).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from tch_geometric_tpu.models.hgt import HGT as JHGT
from tch_geometric_tpu.models.hgt import HGTConv as JHGTConv
from tch_geometric_tpu_torch.models import HGT, HGTConv
from tch_geometric_tpu_torch.models.gnn import _lecun_normal_
from tch_geometric_tpu_torch.utils.params import (hgt_params_from_flax,
                                                  load_flax_params)

TYPES = ("a", "b", "c")
COUNTS = {"a": 9, "b": 6, "c": 4}
SPECS = (("a__to__b", "a", "b"), ("b__to__a", "b", "a"),
         ("a__self__a", "a", "a"), ("b__to__c", "b", "c"),
         ("c__to__b", "c", "b"))
EMPTY = "b__to__c"          # a relation with no edges
HIDDEN, HEADS = 8, 2
F32 = dict(rtol=1e-5, atol=1e-6)
LAYOUTS = [False, True]


def _edges(seed, empty=EMPTY, E=20):
    """Per relation (rows, cols, valid): some invalid slots, and rows and
    cols past the type's size where not valid (the model clamps them)."""
    r = np.random.default_rng(seed)
    out = {}
    for rk, s, t in SPECS:
        n = 0 if rk == empty else E
        valid = r.random(n) < 0.75
        rows = np.where(valid, r.integers(0, COUNTS[s], n), COUNTS[s] + 3)
        cols = np.where(valid, r.integers(0, COUNTS[t], n), COUNTS[t] + 1)
        out[rk] = (rows, cols, valid)
    return out


def _x(seed, width):
    r = np.random.default_rng(seed)
    return {t: r.normal(size=(COUNTS[t], width)).astype(np.float32)
            for t in TYPES}


def _jax(tree):
    return {k: tuple(jnp.asarray(v) for v in val) if isinstance(val, tuple)
            else jnp.asarray(val) for k, val in tree.items()}


def _torch(tree):
    return {k: tuple(torch.from_numpy(np.asarray(v)) for v in val)
            if isinstance(val, tuple) else torch.from_numpy(val)
            for k, val in tree.items()}


def _with_edges():
    return [rk for rk, _s, _t in SPECS if rk != EMPTY]


@pytest.mark.parametrize("stacked", LAYOUTS, ids=["per_rel", "stacked"])
@pytest.mark.parametrize("width", [HIDDEN, 5], ids=["residual", "narrow"])
def test_hgt_conv_forward_matches_flax(stacked, width):
    x, e = _x(0, width), _edges(1)
    jm = JHGTConv(HIDDEN, TYPES, SPECS, heads=HEADS, stacked_rels=stacked)
    params = jm.init(jax.random.key(0), _jax(x), _jax(e))
    want = jm.apply(params, _jax(x), _jax(e))
    m = HGTConv(width, HIDDEN, TYPES, SPECS, heads=HEADS,
                stacked_rels=stacked, device="cpu")
    load_flax_params(m, hgt_params_from_flax(params, SPECS, stacked,
                                             _with_edges()))
    got = m(_torch(x), _torch(e))
    assert list(got) == list(TYPES)
    for t in TYPES:
        np.testing.assert_allclose(got[t].detach().numpy(),
                                   np.asarray(want[t]), err_msg=t, **F32)


def _model_pair(stacked, dtype=None, seed=0):
    x, e = _x(seed, 7), _edges(seed + 1)
    jm = JHGT(hidden=HIDDEN, out=3, num_layers=2, node_types=TYPES,
              rel_specs=SPECS, out_type="b", heads=HEADS, dtype=dtype,
              stacked_rels=stacked)
    params = jm.init(jax.random.key(seed), _jax(x), _jax(e))
    m = HGT(7, HIDDEN, 3, 2, TYPES, SPECS, "b", heads=HEADS,
            dtype=None if dtype is None else torch.bfloat16,
            stacked_rels=stacked, device="cpu",
            generator=torch.Generator().manual_seed(seed))
    return jm, params, m, x, e


@pytest.mark.parametrize("stacked", LAYOUTS, ids=["per_rel", "stacked"])
def test_hgt_forward_f32_and_carrier(stacked):
    jm, params, m, x, e = _model_pair(stacked)
    init = {k: v.clone() for k, v in m.state_dict().items()}
    carried = hgt_params_from_flax(params, SPECS, stacked, _with_edges())
    load_flax_params(m, carried)
    # the relation without edges is not in flax's tree: the port keeps its
    # init there, and carries every other entry
    missing = set(m.state_dict()) - set(carried)
    assert missing == {f"convs.{i}.{k}.{EMPTY}" for i in range(2)
                       for k in ("w_att", "w_msg", "mu")}
    for k in missing:
        assert torch.equal(m.state_dict()[k], init[k]), k
    want = np.asarray(jm.apply(params, _jax(x), _jax(e)))
    got = m(_torch(x), _torch(e))
    assert got.shape == (COUNTS["b"], 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, **F32)


@pytest.mark.parametrize("stacked", LAYOUTS, ids=["per_rel", "stacked"])
def test_hgt_forward_bf16(stacked):
    jm, params, m, x, e = _model_pair(stacked, jnp.bfloat16, seed=2)
    load_flax_params(m, hgt_params_from_flax(params, SPECS, stacked,
                                             _with_edges()))
    want = np.asarray(jm.apply(params, _jax(x), _jax(e)), np.float32)
    got = m(_torch(x), _torch(e))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().detach().numpy(), want, rtol=0,
                               atol=2e-2 * np.abs(want).max())


@pytest.mark.parametrize("stacked", LAYOUTS, ids=["per_rel", "stacked"])
def test_hgt_gradients_match_flax(stacked):
    jm, params, m, x, e = _model_pair(stacked, seed=4)
    load_flax_params(m, hgt_params_from_flax(params, SPECS, stacked,
                                             _with_edges()))
    labels = np.random.default_rng(5).integers(0, 3, COUNTS["b"])

    def jloss(p):
        logits = jm.apply(p, _jax(x), _jax(e))
        logp = jax.nn.log_softmax(logits)
        return -jnp.take_along_axis(logp, jnp.asarray(labels)[:, None],
                                    1).mean()

    jgrads = hgt_params_from_flax(unfreeze(jax.grad(jloss)(params)), SPECS,
                                  stacked, _with_edges())
    loss = torch.nn.functional.cross_entropy(m(_torch(x), _torch(e)),
                                             torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss(params)),
                               rtol=1e-5)
    for k, p in m.named_parameters():
        if k in jgrads:
            # None where the loss does not reach (the last layer's other
            # types): JAX's gradient is zero there
            g = torch.zeros_like(p) if p.grad is None else p.grad
            np.testing.assert_allclose(g.numpy(), jgrads[k].numpy(),
                                       rtol=1e-4, atol=1e-7, err_msg=k)
        else:
            assert EMPTY in k and p.grad is None, k


@pytest.mark.parametrize("shape", [(64, 512), (16, 32, 32), (7, 4, 16, 16)],
                         ids=["H_D", "H_d_d", "R_H_d_d"])
def test_lecun_normal_fan_in_matches_flax(shape):
    import flax.linen as nn
    want = float(np.asarray(nn.initializers.lecun_normal()(
        jax.random.key(0), shape)).std())
    w = torch.empty(shape)
    _lecun_normal_(w, torch.Generator().manual_seed(0))
    fan_in = int(np.prod(shape[:-1]))
    np.testing.assert_allclose(float(w.std()), want, rtol=2e-2)
    np.testing.assert_allclose(float(w.std()), fan_in ** -0.5, rtol=2e-2)
