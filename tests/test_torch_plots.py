"""The port's figures (sdpcutsel_tpu_torch/bench/plots.py, cli plot) against
the JAX package's render_all on one results file: the same figure files and
count, from a port record (platform "cuda"), a JAX package record (platform
"tpu"), a foreign row, a summary line and a replica timing file beside them
(tests/test_utils.py::test_plots_render_all's shapes).  The port's CLI
imports no matplotlib until plot runs."""

import json
import os
import subprocess
import sys

from sdpcutsel_tpu.bench.plots import render_all as j_render_all
from sdpcutsel_tpu_torch import cli
from sdpcutsel_tpu_torch.bench.plots import render_all

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _results(tmp_path):
    port = {"instance": "spar010-100-1", "strategy": "neural", "k": 3,
            "gap_closed": [0.0, 0.4, 0.6], "final_gap_closed": 0.6,
            "round_times_s": [0.5, 0.3, 0.3], "mccormick": 10.0, "sdp": 5.0,
            "bounds": [10.0, 8.0, 7.0], "platform": "cuda"}
    ref = {**port, "instance": "spar012-100-3", "strategy": "feasibility",
           "gap_closed": [0.0, 0.2], "final_gap_closed": 0.2, "round_times_s": [1.0, 0.8],
           "platform": "tpu"}
    foreign = {"instance": "spar010-100-1", "note": "parity row"}
    summary = {"summary": {"neural": {"mean_gap_closed": 0.6}}}
    path = tmp_path / "suite_torch.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in (port, ref, foreign, summary)) + "\n")
    timing = {"instance": "spar010-100-1", "strategy": "neural", "bounds": [10.0, 7.5],
              "score_time_s": [0.1, 0.2], "lp_time_s": [0.3, 0.5]}
    (tmp_path / "replica_timing.jsonl").write_text(json.dumps(timing) + "\n")
    return str(path)


def test_render_all_matches_reference(tmp_path):
    path = _results(tmp_path)
    n = render_all(path, str(tmp_path / "port"))
    want = j_render_all(path, str(tmp_path / "ref"))
    assert n == want == 6    # 2 x (rounds, time), the summary, the replica overlay
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "ref"))
    overlay = (tmp_path / "port" / "tpu_vs_replica_time_spar010-100-1.svg").read_text()
    assert "CUDA (neural)" in overlay


def test_cli_plot(tmp_path, capsys):
    path = _results(tmp_path)
    out = tmp_path / "figs"
    assert cli.main(["plot", path, "--out", str(out)]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {
        "figures": 6, "out": str(out)}
    assert (out / "gap_vs_rounds_spar010-100-1.svg").exists()
    assert (out / "suite_summary.svg").exists()


def test_cli_imports_no_matplotlib():
    code = ("import sys\nimport sdpcutsel_tpu_torch.cli\n"
            "assert 'matplotlib' not in sys.modules\nprint('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
