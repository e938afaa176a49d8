"""The port's own copies of the reference's numpy-only modules (config,
instances, chordal decomposition, the batched dense block, the pair layout)
agree with ``sdpcutsel_tpu``'s: the same config fields and defaults, and
equal instance arrays, cliques, candidate tables and layouts.  ``reference_config`` serves the other port tests, which build their
configs from the port and hand the reference the same values."""

import dataclasses

import numpy as np
import pytest

import sdpcutsel_tpu.config as jconfig
import sdpcutsel_tpu_torch.config as tconfig
from sdpcutsel_tpu.instances import boxqp as jboxqp
from sdpcutsel_tpu.instances import qcqp as jqcqp
from sdpcutsel_tpu.qcqp import chordal as jchordal
from sdpcutsel_tpu_torch.instances import boxqp as tboxqp
from sdpcutsel_tpu_torch.instances import qcqp as tqcqp
from sdpcutsel_tpu_torch.qcqp import chordal as tchordal

CONFIGS = ["LPConfig", "CutConfig", "ScorerConfig", "LoopConfig", "MeshConfig", "RunConfig"]


def reference_config(cfg: tconfig.RunConfig) -> jconfig.RunConfig:
    """The reference's RunConfig holding the values of the port's ``cfg``."""
    kw = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            v = getattr(jconfig, type(v).__name__)(**dataclasses.asdict(v))
        kw[f.name] = v
    return jconfig.RunConfig(**kw)


@pytest.mark.parametrize("name", CONFIGS)
def test_config_fields_and_defaults_match(name):
    want, got = getattr(jconfig, name), getattr(tconfig, name)
    assert [(f.name, f.type) for f in dataclasses.fields(got)] == \
           [(f.name, f.type) for f in dataclasses.fields(want)]
    assert got() == got() and dataclasses.asdict(got()) == dataclasses.asdict(want())
    assert got.__dataclass_params__.frozen


def test_reference_config_carries_every_value():
    cfg = tconfig.RunConfig(lp=tconfig.LPConfig(max_iters=77, tol=3e-5),
                            cuts=tconfig.CutConfig(k=5, sel_gate="none"),
                            loop=tconfig.LoopConfig(polish_iters=9), seed=4)
    ref = reference_config(cfg)
    assert isinstance(ref, jconfig.RunConfig)
    assert dataclasses.asdict(ref) == dataclasses.asdict(cfg)
    assert tconfig.override(cfg, seed=1).seed == 1 and cfg.seed == 4


@pytest.mark.parametrize("args", [(20, 100, 1), (13, 75, 2), (70, 100, 1)])
def test_generate_spar_matches(args):
    want, got = jboxqp.generate_spar(*args), tboxqp.generate_spar(*args)
    assert got.name == want.name and got.n == want.n
    np.testing.assert_array_equal(got.Q, want.Q)
    np.testing.assert_array_equal(got.c, want.c)


@pytest.mark.parametrize("name", ["spar020-100-1", "spar125-100-1"])
def test_parse_boxqp_matches(name):
    path = f"data/boxqp/{name}.in"
    want = jboxqp.parse_boxqp(path, use_native=False)
    got = tboxqp.parse_boxqp(path)
    assert got.name == want.name == name
    np.testing.assert_array_equal(got.Q, want.Q)
    np.testing.assert_array_equal(got.c, want.c)


def test_load_or_generate_reads_then_generates():
    read = tboxqp.load_or_generate("spar020-100-1", data_dir="data/boxqp")
    np.testing.assert_array_equal(read.Q, jboxqp.parse_boxqp(
        "data/boxqp/spar020-100-1.in", use_native=False).Q)
    made = tboxqp.load_or_generate("spar011-50-2")
    np.testing.assert_array_equal(made.Q, jboxqp.generate_spar(11, 50, 2).Q)
    with pytest.raises(ValueError):
        tboxqp.load_or_generate("nonsense")


@pytest.mark.parametrize("name", ["qcqp015-30-3-1", "qcqpband100-5-25-1"])
def test_load_or_generate_qcqp_matches(name):
    want, got = jqcqp.load_or_generate_qcqp(name), tqcqp.load_or_generate_qcqp(name)
    assert (got.name, got.n, got.m) == (want.name, want.n, want.m)
    for a, b in [(got.Q0, want.Q0), (got.c0, want.c0), (got.bs, want.bs),
                 *zip(got.Qs, want.Qs), *zip(got.cs, want.cs)]:
        np.testing.assert_array_equal(a, b)
    assert got.sparsity_graph() == want.sparsity_graph()


@pytest.mark.parametrize("name,k", [("qcqp015-30-3-1", 5), ("qcqp025-25-4-2", 4),
                                    ("qcqpband100-5-25-1", 5)])
def test_chordal_decomposition_and_candidates_match(name, k):
    inst = tqcqp.load_or_generate_qcqp(name)
    edges = inst.sparsity_graph()
    want = jchordal.chordal_decomposition(inst.n, edges, use_native=False)
    got = tchordal.chordal_decomposition(inst.n, edges)
    assert got == want
    np.testing.assert_array_equal(tchordal.clique_candidates(got[0], k),
                                  jchordal.clique_candidates(want[0], k))
    assert tchordal.clique_candidates([], k).shape == (0, k)


@pytest.mark.parametrize("args", [(30, 30, 2, 1, 8), (12, 40, 3, 2, 3)])
def test_generate_qcqp_family_matches(args):
    want, got = jqcqp.generate_qcqp_family(*args), tqcqp.generate_qcqp_family(*args)
    assert [g.name for g in got] == [w.name for w in want]
    for g, w in zip(got, want):
        for a, b in [(g.Q0, w.Q0), (g.c0, w.c0), (g.bs, w.bs), *zip(g.Qs, w.Qs),
                     *zip(g.cs, w.cs)]:
            np.testing.assert_array_equal(a, b)
        assert g.sparsity_graph() == got[0].sparsity_graph()


def test_batched_dense_from_qcqp_matches():
    from sdpcutsel_tpu.relax.denserows import batched_dense_from_qcqp as jbatched
    from sdpcutsel_tpu_torch.relax.denserows import batched_dense_from_qcqp as tbatched

    insts = tqcqp.generate_qcqp_family(30, 30, 2, 1, 4)
    got, want = tbatched(insts, "cpu"), jbatched(insts)
    for f in ("G", "g", "h"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))


@pytest.mark.parametrize("n", [12, 70, 125])
def test_build_pair_layout_matches(n):
    from sdpcutsel_tpu.ops.pair_score import build_pair_layout as jlayout
    from sdpcutsel_tpu_torch.ops.pair_score import build_pair_layout as tlayout

    _, _, table, valid = jlayout(n)
    got_table, got_valid = tlayout(n)
    np.testing.assert_array_equal(got_table, table)
    np.testing.assert_array_equal(got_valid, valid)
