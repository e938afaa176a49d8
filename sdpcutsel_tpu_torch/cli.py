"""Command-line interface — the experiment runner's entry point (port of
``sdpcutsel_tpu/cli.py``).

    python -m sdpcutsel_tpu_torch.cli solve spar020-100-1 --strategy neural --rounds 20
    python -m sdpcutsel_tpu_torch.cli suite --sizes 20,30 --strategies neural,feasibility
    python -m sdpcutsel_tpu_torch.cli sdpbound spar020-100-1
    python -m sdpcutsel_tpu_torch.cli train --k 3 --samples 200000 --out mlp_k3.npz
    python -m sdpcutsel_tpu_torch.cli plot results/suite_torch.jsonl --out results/figures

The flags and defaults are the reference's.  Runs go to the card unless
``--cpu`` is given.  ``solve --trace LOGDIR`` writes a ``torch.profiler``
trace of the run to ``LOGDIR/trace.json`` (open with ui.perfetto.dev).
``train`` writes the scorer's ``.npz`` to ``--out`` (default: the shipped
``models/artifacts/mlp_k{k}.npz``), which a solve serves with
``--set scorer.weights_path=PATH``.  ``plot`` renders the figures of a
results JSONL (``bench/plots.py``) on the host: it alone imports
matplotlib, which the card's host need not have.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import torch


def _common(ap):
    ap.add_argument("--data-dir", default="data/boxqp")
    ap.add_argument("--k", type=int, default=3)
    ap.add_argument("--sel-size", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--strategy", default="neural",
                    choices=["feasibility", "optimality", "neural", "random",
                             "combined", "triangle"])
    ap.add_argument("--capacity", type=int, default=4096)
    ap.add_argument("--lp-tol", type=float, default=1e-6)
    ap.add_argument("--lp-max-iters", type=int, default=20000)
    ap.add_argument("--viol-tol", type=float, default=1e-4)
    ap.add_argument("--log", default=None, help="JSONL output path")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    metavar="SECTION.FIELD=VALUE",
                    help="generic config override, repeatable (e.g. "
                         "--set lp.check_every=50 --set cuts.purge=false)")
    ap.add_argument("--debug", action="store_true",
                    help="per-round state checks (utils/debug.py)")
    ap.add_argument("--trace", default=None, metavar="LOGDIR",
                    help="write a torch.profiler trace of the run to LOGDIR")


def _config(args):
    from .config import (
        CutConfig, LPConfig, LoopConfig, RunConfig, ScorerConfig,
        apply_overrides,
    )

    cfg = RunConfig(
        lp=LPConfig(tol=args.lp_tol, max_iters=args.lp_max_iters),
        cuts=CutConfig(k=args.k, sel_size=args.sel_size,
                       capacity=args.capacity, viol_tol=args.viol_tol),
        scorer=ScorerConfig(strategy=args.strategy),
        loop=LoopConfig(rounds=args.rounds),
        debug=getattr(args, "debug", False),
    )
    return apply_overrides(cfg, getattr(args, "overrides", None))


@contextlib.contextmanager
def trace(logdir: str | None, device: torch.device):
    """A ``torch.profiler`` trace of the enclosed block (CPU, and CUDA on
    the card), written to ``logdir/trace.json``; nothing when logdir is
    None."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="sdpcutsel_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("solve", help="run the cutting-plane loop on one instance")
    ps.add_argument("instance")
    _common(ps)

    pu = sub.add_parser("suite", help="run the experiment suite")
    _common(pu)
    pu.add_argument("--sizes", default="20,30,40,50")
    pu.add_argument("--densities", default="25,50,75,100")
    pu.add_argument("--seeds", default="1,2,3")
    pu.add_argument("--strategies", default=None,
                    help="comma list; default = --strategy")

    pb = sub.add_parser("sdpbound", help="compute/cache SDP bound for instance")
    pb.add_argument("instance")
    _common(pb)

    pp = sub.add_parser("plot", help="render figures from suite JSONL results")
    pp.add_argument("path", nargs="?", default="results/suite.jsonl")
    pp.add_argument("--out", default="results/figures")

    pt = sub.add_parser("train", help="train the NN cut scorer")
    pt.add_argument("--k", type=int, default=3)
    pt.add_argument("--samples", type=int, default=200_000)
    pt.add_argument("--steps", type=int, default=4000)
    pt.add_argument("--seed", type=int, default=0)
    pt.add_argument("--out", default=None)
    pt.add_argument("--cpu", action="store_true", help="train on the CPU")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.cmd == "plot":
        from .bench import plots

        n = plots.render_all(args.path, args.out)
        print(json.dumps({"figures": n, "out": args.out}))
        return 0

    device = torch.device("cpu" if args.cpu else "cuda")

    if args.cmd == "train":
        from .models.train import train_scorer

        _, metrics = train_scorer(k=args.k, samples=args.samples, steps=args.steps,
                                  seed=args.seed, out_path=args.out, device=device)
        print(json.dumps(metrics))
        return 0

    if args.cmd == "solve":
        from .bench.suite import instance_gap_closed
        from .utils.logging import JSONLLogger

        logger = JSONLLogger(args.log) if args.log else None
        with trace(args.trace, device):
            rec = instance_gap_closed(args.instance, _config(args),
                                      args.data_dir, rounds=args.rounds,
                                      logger=logger, device=device)
        if logger:
            logger.close()
        print(json.dumps(rec, default=float))
        return 0

    if args.cmd == "sdpbound":
        from .bench.suite import ensure_bounds

        mc, sdp = ensure_bounds(args.instance, args.data_dir, device=device)
        print(json.dumps({"instance": args.instance,
                          "mccormick": mc, "sdp": sdp}))
        return 0

    if args.cmd == "suite":
        from .bench.suite import run_suite

        sizes = [int(s) for s in args.sizes.split(",")]
        densities = [int(s) for s in args.densities.split(",")]
        seeds = [int(s) for s in args.seeds.split(",")]
        names = [f"spar{n:03d}-{d}-{s}"
                 for n in sizes for d in densities for s in seeds]
        strategies = (args.strategies or args.strategy).split(",")
        _, summary = run_suite(names, strategies, _config(args),
                               args.data_dir, out_path=args.log,
                               rounds=args.rounds, device=device)
        print(json.dumps(summary))
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
