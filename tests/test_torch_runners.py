"""The port's runners (sdpcutsel_tpu_torch.run_suite_incremental,
run_qcqp_suite, rerun_cell, run_parity, run_qcqp_parity) on the CPU at
tests/test_scripts.py's sizes (spar012-100-3, a tiny registry): the suite
runners resume (a second invocation skips the cell and does not duplicate
it), rerun_cell appends, the parity runners pair the port's cell with a
replica row that the test records by running the JAX package's replica on
the same cell, and scripts/summarize_suite.py, summarize_qcqp.py and
summarize_parity.py read the port's records."""

import importlib.util
import json
import os
import shutil
import time

import numpy as np
import pytest
import torch

from sdpcutsel_tpu.baseline import cpu_cut_select
from sdpcutsel_tpu.baseline.cpu_reference_qcqp import cpu_cut_select_qcqp
from sdpcutsel_tpu.instances import load_or_generate as j_load_or_generate
from sdpcutsel_tpu.instances.qcqp import load_or_generate_qcqp as j_load_qcqp
from sdpcutsel_tpu.loop.sdp_bound import gap_closed as j_gap_closed
from sdpcutsel_tpu_torch import (rerun_cell, run_parity, run_qcqp_parity, run_qcqp_suite,
                                 run_suite_incremental)
from sdpcutsel_tpu_torch.config import LPConfig
from sdpcutsel_tpu_torch.instances import load_or_generate
from sdpcutsel_tpu_torch.loop.sdp_bound import sdp_relaxation_bound

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME, QNAME = "spar012-100-3", "qcqp015-30-3-1"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _summarizer(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def _rows(path):
    return [r for r in (json.loads(line) for line in open(path)) if "instance" in r]


@pytest.fixture(scope="module")
def tiny_registry(tmp_path_factory):
    """A data dir with spar012-100-3's bounds, certified by the port on the
    CPU (tests/test_scripts.py's settings)."""
    d = tmp_path_factory.mktemp("boxqp_data")
    sdp, mc, _ = sdp_relaxation_bound(load_or_generate(NAME), LPConfig(max_iters=4000, tol=1e-5),
                                      max_rounds=8, device="cpu")
    (d / "bounds.json").write_text(json.dumps({NAME: {"mccormick": float(mc), "sdp": float(sdp)}}))
    return str(d)


def test_suite_incremental_resumable(tiny_registry, tmp_path, capsys):
    out = tmp_path / "suite_torch.jsonl"
    argv = ["--sizes", "12", "--densities", "100", "--seeds", "3", "--strategies",
            "feasibility", "--rounds", "2", "--sel-size", "6", "--data-dir", tiny_registry,
            "--out", str(out), "--lp-max-iters", "4000", "--polish-iters", "0",
            "--sdp-max-rounds", "8", "--cpu"]
    assert run_suite_incremental.main(argv) == 0
    rows = _rows(out)
    assert len(rows) == 1 and rows[0]["platform"] == "cpu"
    assert rows[0]["round_times_s"] and 0.0 <= rows[0]["final_gap_closed"] <= 1.0
    assert run_suite_incremental.main(argv) == 0
    assert len(_rows(out)) == 1                   # skipped, not duplicated
    capsys.readouterr()
    _summarizer("summarize_suite")(str(out))
    assert NAME in capsys.readouterr().out


def test_rerun_cell_appends(tiny_registry, tmp_path):
    out = tmp_path / "suite_torch.jsonl"
    argv = [NAME, "feasibility", "--rounds", "2", "--sel-size", "6", "--lp-max-iters", "4000",
            "--polish-iters", "0", "--data-dir", tiny_registry, "--out", str(out), "--cpu"]
    for want in (1, 2):
        assert rerun_cell.main(argv) == 0
        rows = _rows(out)
        assert len(rows) == want
    assert [r["platform"] for r in rows] == ["cpu", "cpu"]
    assert rows[1]["bounds"] == rows[0]["bounds"]     # one configuration, one result


def test_qcqp_suite_resumable(tmp_path, capsys):
    data = tmp_path / "qcqp"
    data.mkdir()
    shutil.copy(os.path.join(REPO, "data", "qcqp", "bounds.json"), data / "bounds.json")
    out = tmp_path / "qcqp_torch.jsonl"
    argv = ["--specs", "015-30-3-1", "--ks", "4", "--strategies", "feasibility", "--rounds",
            "2", "--data-dir", str(data), "--out", str(out), "--lp-max-iters", "2000",
            "--polish-iters", "0", "--cpu"]
    assert run_qcqp_suite.main(argv) == 0
    rows = _rows(out)
    assert len(rows) == 1 and rows[0]["instance"] == QNAME and rows[0]["platform"] == "cpu"
    assert 0.0 <= rows[0]["final_gap_closed"] <= 1.0 and len(rows[0]["bounds"]) == 2
    assert run_qcqp_suite.main(argv) == 0
    assert len(_rows(out)) == 1
    capsys.readouterr()
    _summarizer("summarize_qcqp")(str(out), str(tmp_path / "none.jsonl"), str(data / "bounds.json"))
    assert "| 15 | 4 |" in capsys.readouterr().out


def test_parity_pairs_the_replicas_row(tiny_registry, tmp_path, capsys):
    """The replica's row comes from the JAX package's cpu_cut_select on the
    same cell, in scripts/run_parity.py's rerun form."""
    reg = json.load(open(os.path.join(tiny_registry, "bounds.json")))[NAME]
    t0 = time.perf_counter()
    hist, _ = cpu_cut_select(j_load_or_generate(NAME, data_dir=tiny_registry), k=3, sel_size=6,
                             rounds=2, strategy="feasibility")
    cpu_gaps = j_gap_closed(reg["mccormick"], reg["sdp"], [h.bound for h in hist]).tolist()
    replica = tmp_path / "parity.jsonl"
    replica.write_text(json.dumps({
        "instance": NAME, "strategy": "feasibility", "k": 3, "rounds": 2, "sel_size": 6,
        "cpu_final_gap_closed": cpu_gaps[-1], "cpu_gap_closed": cpu_gaps,
        "cpu_wall_time_s": time.perf_counter() - t0, "cpu_diversity_alpha": 0.0,
        "tpu_rerun": True, "tpu_purge": False, "tpu_diversity_alpha": 0.0}) + "\n")
    out = tmp_path / "parity_torch.jsonl"
    argv = ["--instances", NAME, "--strategy", "feasibility", "--rounds", "2", "--sel-size",
            "6", "--data-dir", tiny_registry, "--replica", str(replica), "--out", str(out),
            "--no-purge", "--polish-iters", "2000", "--cpu"]
    assert run_parity.main(argv) == 0
    (rec,) = _rows(out)
    assert rec["platform"] == rec["tpu_backend"] == "cpu" and rec["tpu_rerun"]
    assert rec["cpu_final_gap_closed"] == cpu_gaps[-1]
    assert 0.2 <= rec["ratio_tpu_over_cpu"] <= 5.0
    assert run_parity.main(argv) == 0
    assert "already done" in capsys.readouterr().out
    assert len(_rows(out)) == 1
    _summarizer("summarize_parity")(str(out))
    assert f"| {NAME} | feasibility | 3 | rerun no-purge |" in capsys.readouterr().out


def test_qcqp_parity_pairs_the_replicas_row(tmp_path, capsys):
    t0 = time.perf_counter()
    hist, _ = cpu_cut_select_qcqp(j_load_qcqp(QNAME), k=4, sel_size=16, rounds=2,
                                  strategy="feasibility")
    replica = tmp_path / "qcqp_parity.jsonl"
    replica.write_text(json.dumps({
        "instance": QNAME, "strategy": "feasibility", "k": 4, "sel_size": 16, "rounds": 2,
        "replica_bounds": [h.bound for h in hist], "replica_wall_s": time.perf_counter() - t0,
        "tpu_diversity_alpha": 0.0}) + "\n")
    out = tmp_path / "qcqp_parity_torch.jsonl"
    argv = ["--names", QNAME, "--strategies", "feasibility", "--rounds", "2",
            "--lp-max-iters", "2000", "--polish-iters", "0", "--replica", str(replica),
            "--suite", os.path.join(REPO, "results", "qcqp.jsonl"), "--out", str(out), "--cpu"]
    assert run_qcqp_parity.main(argv) == 0
    (rec,) = _rows(out)
    assert rec["platform"] == "cpu" and rec["replica_bounds"] == [h.bound for h in hist]
    assert len(rec["tpu_bounds"]) == 2 and np.isfinite(rec["ratio"]) and rec["ratio"] > 0
    capsys.readouterr()
    _summarizer("summarize_qcqp")(str(tmp_path / "none.jsonl"), str(out))
    assert "| feasibility | 4 | 1 |" in capsys.readouterr().out
