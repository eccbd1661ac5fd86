"""The small names of the JAX package the port lacked, against the live
reference: ``spaces.expr_to_config``, ``graphviz.dot_hyperparameters``
(and its ``graphviz_mod`` alias, both exported by the package),
``base.SONify``, ``base.miscs_update_idxs_vals`` and
``rand.suggest_batch``."""

import datetime

import numpy as np
import pytest
import torch

import hyperopt_tpu as ref
from hyperopt_tpu import base as ref_base, graphviz as ref_graphviz, hp as rhp
from hyperopt_tpu import spaces as ref_spaces, zoo as ref_zoo
import hyperopt_tpu_torch as port
from hyperopt_tpu_torch import base, graphviz, graphviz_mod, hp, spaces, zoo
from hyperopt_tpu_torch.base import Domain


def _space(h):
    return {
        "u": h.uniform("u", -2, 3),
        "q": h.quniform("q", 0, 10, 2.5),
        "i": h.uniformint("i", 1, 4),
        "c": h.choice("c", [{"a": h.loguniform("a", -2, 1)},
                            {"b": h.normal("b", 0, 2), "k": "kind"}]),
    }


@pytest.mark.parametrize("name", ["many_dists", "hr_conditional", "ml_model_select_cv", None])
def test_expr_to_config_matches_reference(name):
    rs, ps = (_space(rhp), _space(hp)) if name is None else (
        ref_zoo.ZOO[name].space, zoo.ZOO[name].space)
    want, got = ref_spaces.expr_to_config(rs), spaces.expr_to_config(ps)
    assert list(got) == list(want)
    for label in want:
        w, g = want[label], got[label]
        assert g["dist"].family == w["dist"].family, label
        assert tuple(g["dist"].params) == tuple(w["dist"].params), label
        assert g["cast"] == w["cast"] and g["conditions"] == w["conditions"], label


@pytest.mark.parametrize("name", ["branin", "hr_conditional", "ml_model_select_cv", None])
def test_dot_hyperparameters_is_the_reference_text(name):
    rs, ps = (_space(rhp), _space(hp)) if name is None else (
        ref_zoo.ZOO[name].space, zoo.ZOO[name].space)
    want = ref_graphviz.dot_hyperparameters(rs)
    assert graphviz.dot_hyperparameters(ps) == want
    assert graphviz_mod.dot_hyperparameters is graphviz.dot_hyperparameters
    assert port.graphviz is graphviz and "graphviz" in port.__all__


def test_sonify_matches_reference():
    now = datetime.datetime(2026, 1, 2, 3, 4, 5)
    doc = {"a": np.float32(1.5), "b": [np.int64(3), (np.bool_(True), None)],
           "c": np.arange(6, dtype=np.int32).reshape(2, 3), "d": "s", "e": b"x", "f": now,
           np.int64(7): {"g": np.float64(0.25)}}
    want = ref_base.SONify(doc)
    assert base.SONify(doc) == want
    # a tensor is SONified as the array it holds
    tdoc = {**doc, "c": torch.arange(6, dtype=torch.int32).reshape(2, 3)}
    assert base.SONify(tdoc) == want
    for bad in (object(), {1, 2}):
        with pytest.raises(TypeError):
            base.SONify(bad)


def test_miscs_update_idxs_vals_matches_reference():
    def miscs():
        return [{"tid": t, "cmd": None, "idxs": {}, "vals": {}} for t in (4, 5, 6)]

    idxs = {"x": [4, 6], "y": [5], "z": []}
    vals = {"x": [0.5, 1.5], "y": [2], "z": []}
    want = ref_base.miscs_update_idxs_vals(miscs(), idxs, vals)
    assert base.miscs_update_idxs_vals(miscs(), idxs, vals) == want
    want = ref_base.miscs_update_idxs_vals(miscs(), {"x": [0]}, {"x": [9.0]},
                                           idxs_map={0: 5})
    assert base.miscs_update_idxs_vals(miscs(), {"x": [0]}, {"x": [9.0]},
                                       idxs_map={0: 5}) == want
    with pytest.raises(port.InvalidTrial):
        base.miscs_update_idxs_vals(miscs(), {"x": [99]}, {"x": [1.0]})
    assert base.miscs_update_idxs_vals(miscs(), {"x": [99]}, {"x": [1.0]},
                                       assert_all_vals_used=False) == \
        ref_base.miscs_update_idxs_vals(miscs(), {"x": [99]}, {"x": [1.0]},
                                        assert_all_vals_used=False)


def test_rand_suggest_batch_matches_reference():
    rt, pt = ref.Trials(), port.Trials(device="cpu")
    rd, pd = ref_base.Domain(None, _space(rhp)), Domain(None, _space(hp))
    ids = list(range(12))
    want = ref.rand.suggest_batch(ids, rd, rt, 5)
    got = port.rand.suggest_batch(ids, pd, pt, 5)
    serial = port.rand.suggest(ids, pd, pt, 5)
    assert [d["tid"] for d in got] == ids
    for w, g, s in zip(want, got, serial):
        assert g["misc"]["vals"] == s["misc"]["vals"]
        assert g["misc"]["vals"].keys() == w["misc"]["vals"].keys()
        for k, v in w["misc"]["vals"].items():
            np.testing.assert_allclose(g["misc"]["vals"][k], v, rtol=1e-5, atol=1e-6)
