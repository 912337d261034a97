"""The port's sharding rules (`analytics_zoo_tpu_torch/parallel/sharding.py`)
held against the JAX package's `parallel/sharding.py` case for case: the
spec of every parameter of the rule catalog (`scripts/
check_sharding_rules.build_catalog`, the tables of `test_parallel.py:31-61`)
on several meshes, the fingerprints, the divisibility errors, and the
specs of a port BERT's state dict against the JAX tree's; then the fit's
FSDP layout (`ShardLayout`: blocks, gathers, the gradient reduction) on 4
gloo CPU ranks at data=2, fsdp=2 (one group, spawned once)."""

import os
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from analytics_zoo_tpu.parallel import sharding as js
from analytics_zoo_tpu_torch.parallel import sharding as ts
from analytics_zoo_tpu_torch.parallel.sharding import P

from torch_dist_workers import layout_params, run_group

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
from scripts.check_sharding_rules import build_catalog  # noqa: E402


class _Sizes:
    """A mesh by its axis sizes: all `spec_for` reads of either mesh."""

    def __init__(self, **axes):
        self.axis_sizes = {a: axes.get(a, 1) for a in
                           ("pipeline", "data", "fsdp", "sequence",
                            "expert", "tensor")}

    def size(self, axis):
        return self.axis_sizes[axis]


MESHES = [_Sizes(data=2, fsdp=2, tensor=2), _Sizes(data=2, fsdp=4),
          _Sizes(fsdp=8), _Sizes(data=8), _Sizes(data=2, fsdp=3)]


def _jspec(spec):
    return tuple(spec)


@pytest.fixture(scope="module")
def catalog():
    return build_catalog()


@pytest.mark.parametrize("mesh", MESHES,
                         ids=lambda m: "x".join(
                             f"{k}{v}" for k, v in m.axis_sizes.items()
                             if v > 1))
def test_spec_for_every_catalog_parameter(catalog, mesh):
    for path, shape in catalog + [("blk/attn/qkv_kernel", (64, 192)),
                                  ("x_qkv_kernel", (6, 3)),
                                  ("some_weight", (3, 8)),
                                  ("tower/kernel", (129, 67))]:
        t = ts.TRANSFORMER_RULES.spec_for(path, shape, mesh)
        j = js.TRANSFORMER_RULES.spec_for(path, shape, mesh)
        assert tuple(t) == _jspec(j), (path, shape)
        assert repr(t) == str(j)


def test_partition_spec_text_and_fingerprints():
    for axes in [(), ("fsdp",), (None, "tensor"), (("data", "fsdp"),),
                 ("fsdp", "tensor")]:
        assert repr(P(*axes)) == str(JP(*axes))
        assert P(*axes) == tuple(JP(*axes))
    assert ts.TRANSFORMER_RULES.fingerprint() == \
        js.TRANSFORMER_RULES.fingerprint()
    for rules, fallback in [([(r"w$", ("fsdp",))], True),
                            ([(r"w$", ("fsdp",)), (r"b$", ())], False),
                            ([], True)]:
        t = ts.ShardingRules([(p, P(*s)) for p, s in rules], fallback)
        j = js.ShardingRules([(p, JP(*s)) for p, s in rules], fallback)
        assert t.fingerprint() == j.fingerprint()
    assert ts.ShardingRules([]).fingerprint() != \
        ts.ShardingRules([], fsdp_fallback=False).fingerprint()


def test_param_specs_of_a_port_bert_match_the_jax_tree():
    from analytics_zoo_tpu_torch import convert
    from analytics_zoo_tpu_torch.models.bert import BERTClassifier
    tm = BERTClassifier(2, device="cpu", vocab=64, hidden_size=32,
                        n_block=2, n_head=2, seq_len=16,
                        intermediate_size=64)
    flat = {k: v for k, v in tm.state_dict().items()}
    tree = convert.params_to_jax(flat)
    for mesh in MESHES:
        tspecs = ts.param_specs(flat, mesh)
        jspecs = js.param_specs(tree, mesh)
        for name, spec in tspecs.items():
            node = jspecs
            for part in ts.param_path(name).split("/"):
                node = node[part]
            assert tuple(spec) == _jspec(node), name


def _error(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("params", [
    {"tower": {"kernel": np.zeros((129, 67), np.float32)}},
    {"k": np.zeros((128, 64)), "bias": np.zeros((67,))},
    {"a": np.zeros((129, 67)), "b": np.zeros((67, 129)),
     "c": np.zeros((4, 4))},
])
def test_check_fsdp_divisibility_case_for_case(params):
    for mesh in MESHES:
        for rules in ([], None):
            t = ts.ShardingRules([]) if rules == [] else ts.TRANSFORMER_RULES
            j = js.ShardingRules([]) if rules == [] else js.TRANSFORMER_RULES
            assert _error(lambda: ts.check_fsdp_divisibility(
                params, mesh, t)) == _error(
                lambda: js.check_fsdp_divisibility(params, mesh, j))


def test_descriptor_separates_layouts():
    a = ts.sharding_descriptor(type("M", (), {
        "axis_sizes": {"data": 2, "fsdp": 2}, "n_devices": 4})())
    b = ts.sharding_descriptor(type("M", (), {
        "axis_sizes": {"data": 4, "fsdp": 1}, "n_devices": 4})())
    c = ts.sharding_descriptor(type("M", (), {
        "axis_sizes": {"data": 2, "fsdp": 2}, "n_devices": 4})(),
        ts.ShardingRules([]))
    assert len({a, b, c}) == 3 and "ranks=4" in a


def test_tensor_axis_refused_naming_item_7b():
    mesh = _Sizes(fsdp=2, tensor=2)
    with pytest.raises(NotImplementedError, match="item 7b"):
        ts.ShardLayout({"blk.attn.qkv_kernel": torch.zeros(4, 6)}, mesh,
                       ts.TRANSFORMER_RULES)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    return run_group("sharding_worker", 4,
                     str(tmp_path_factory.mktemp("sharding")))


def test_layout_blocks_gathers_and_reduction(group):
    params = layout_params()
    mesh = _Sizes(data=2, fsdp=2)
    for r, res in enumerate(group):
        f = r % 2                                   # fsdp coordinate
        for name, t in params.items():
            jspec = js.TRANSFORMER_RULES.spec_for(
                ts.param_path(name), tuple(t.shape), mesh)
            assert res["specs"][name] == _jspec(jspec), name
            d = res["dims"][name]
            shape = list(t.shape)
            if d is not None:
                assert jspec[d] == "fsdp"
                shape[d] //= 2
                n = t.shape[d] // 2
                want = t.narrow(d, f * n, n)
                assert "Shard(dim=%d)" % d in res["placements"][name]
            else:
                want = t * 2.5
                assert "Shard" not in res["placements"][name]
            assert res["block_shapes"][name] == tuple(shape)
            assert torch.equal(res["gathered"][name], t)
            assert torch.equal(res["state_gathered"]["mu"][name], t * 2)
            if d is not None:
                torch.testing.assert_close(res["reduced"][name], want * 2.5,
                                           rtol=0, atol=1e-6)
            else:
                torch.testing.assert_close(res["reduced"][name], want,
                                           rtol=0, atol=1e-6)
        assert res["state_gathered"]["count"] == 3
        assert res["mean_loss"] == pytest.approx(1.5)
        np.testing.assert_array_equal(
            res["batch"]["ids"], np.arange(48).reshape(8, 6)[2 * r:2 * r + 2])
        k = "bert.blocks.0.attn.qkv_kernel"
        np.testing.assert_array_equal(res["gather_leaf"], params[k].numpy())
        assert res["gather_leaf_rep"].shape == (16,)
        assert res["local_bytes"] < res["full_bytes"] * 0.6
