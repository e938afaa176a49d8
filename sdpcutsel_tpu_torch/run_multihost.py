"""Multi-process sharded solve (port of ``scripts/run_multihost.py``).

Every rank runs this module with the same arguments; the ranks join one
process group (``parallel/distributed.py``), form a ('data' x 'cand') mesh
laid out data-major (``parallel/mesh.py``), and run the batched round step
(``parallel/round.py``) for ``--rounds`` rounds over an instance batch whose
'data' shards live on different ranks, each rank scoring its 'cand' shard
of the table and gathering the winners over its 'cand' group.  Rank 0
prints one JSON line with the f64 certificates of the whole batch (the
reference's keys, plus ``backend`` and ``device``); every rank prints its
kernel launch counts on a line of its own (``[launches rank R] {...}``).

The scoring goes through the kernels (K1 at k = 3, K4 otherwise) on the
card, where the reference passes ``use_fused=False`` (its Pallas kernel
needs shards of 1024 rows; the port's take any).

On the CPU, four ranks on one host (a 2 x 2 mesh over gloo):

    for r in 0 1 2 3; do python3 -m sdpcutsel_tpu_torch.run_multihost --cpu \\
        --data 2 --cand 2 --coordinator file:///tmp/mh_store --num-processes 4 \\
        --process-id $r & done; wait

On the cards of one host (nccl when each rank has a card, else gloo):

    torchrun --nproc-per-node 4 -m sdpcutsel_tpu_torch.run_multihost --data 2 --cand 2

``--save PATH`` (rank 0) writes the fetched batch's pool, bounds and
certificates to an ``.npz``, for bit-for-bit comparisons.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .cuts.enumerate import combinations_table
from .instances import generate_spar, load_or_generate
from .ops.launches import launch_counts
from .parallel import distributed as dist
from .parallel.mesh import make_mesh
from .parallel.round import (certify_batched_f64, certify_scan_f64, init_batched_state,
                             make_sharded_round_step, make_sharded_scan_step,
                             shard_batched_state)
from .parallel.sharding import shard_candidates


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="sdpcutsel_tpu_torch.run_multihost")
    ap.add_argument("--coordinator", default=None,
                    help="tcp://host:port, host:port or file://path (default: MASTER_ADDR)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="default: nccl when each rank has a card of its own, else gloo")
    ap.add_argument("--cpu", action="store_true", help="ranks on the CPU (gloo)")
    ap.add_argument("--n", type=int, default=12)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--data", type=int, default=2)
    ap.add_argument("--cand", type=int, default=4)
    ap.add_argument("--lp-iters", type=int, default=400)
    ap.add_argument("--sel-size", type=int, default=4)
    ap.add_argument("--strategy", default="neural")
    ap.add_argument("--instances", default=None,
                    help="comma list of BoxQP names (the repository's data/boxqp) in place "
                         "of --n/--batch's generate_spar(n, 100, s + 1)")
    ap.add_argument("--capacity", type=int, default=128)
    ap.add_argument("--use-scan", action="store_true",
                    help="all rounds in one call (make_sharded_scan_step)")
    ap.add_argument("--save", default=None, help="rank 0: an .npz of the fetched results")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = dist.initialize(args.coordinator, args.num_processes, args.process_id, args.backend,
                          dist.rank_device(args.cpu))
    rank, world = torch.distributed.get_rank(), torch.distributed.get_world_size()
    backend = torch.distributed.get_backend()
    print(f"[rank {rank}] world {world} backend {backend} device {dev}", flush=True)

    mesh = make_mesh(args.data, args.cand)
    # the same batch on every rank; each keeps its 'data' shard
    if args.instances:
        insts = [load_or_generate(name, os.path.join(dist.REPO, "data", "boxqp"))
                 for name in args.instances.split(",")]
    else:
        insts = [generate_spar(args.n, 100, s + 1) for s in range(args.batch)]
    n = insts[0].n
    state = shard_batched_state(init_batched_state(
        np.stack([i.Q for i in insts]), np.stack([i.c for i in insts]), args.capacity, 3,
        device=dev), mesh)
    table_np = combinations_table(n, 3)
    table, valid = shard_candidates(table_np, mesh, device=dev)
    print(f"[rank {rank}] mesh {args.data}x{args.cand}: {state.c.shape[0]} of {len(insts)} "
          f"instances, {table.shape[0]} of {table_np.shape[0]} candidate rows", flush=True)
    knobs = dict(lp_iters=args.lp_iters, sel_size=args.sel_size, strategy=args.strategy)
    t0 = time.perf_counter()
    if args.use_scan:
        state, outs = make_sharded_scan_step(mesh, rounds=args.rounds, **knobs)(
            state, table, valid)
        lp_iters = outs["lp_iters"][-1]
    else:
        step = make_sharded_round_step(mesh, **knobs)
        for _ in range(args.rounds):
            state, info = step(state, table, valid)
        lp_iters = info["lp_iters"]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(f"[rank {rank}] {args.rounds} rounds in {time.perf_counter() - t0:.4f} s "
          f"(the first includes the kernels' load)", flush=True)
    launches = launch_counts()

    # every rank joins every collective below; only the prints are rank 0's
    full = dist.fetch_tree(state, mesh)
    iters = dist.fetch_tree(torch.as_tensor(lp_iters), mesh)
    if args.use_scan:
        per_round = certify_scan_f64(full.Q, full.c, dist.fetch_tree(outs, mesh, axis=1))
        cert = per_round[-1]
    else:
        cert = certify_batched_f64(full)
    dist.sync("rounds-done")
    print(f"[launches rank {rank}] {json.dumps(launches)}", flush=True)
    if rank == 0:
        print(json.dumps({
            "mesh": f"{args.data}x{args.cand}",
            "processes": world,
            "strategy": args.strategy,
            "rounds": args.rounds,
            "bounds_f32": np.asarray(full.bound).round(4).tolist(),
            "bounds_certified_f64": np.round(cert, 4).tolist(),
            "cuts": np.asarray(full.pool.count).tolist(),
            "lp_iters": np.asarray(iters).tolist(),
            "backend": backend,
            "device": str(dev),
        }), flush=True)
        if args.save:
            np.savez(args.save, idx=full.pool.idx, count=full.pool.count, cert=cert,
                     bound=full.bound, best_bound=full.best_bound, lp_iters=iters,
                     **({"per_round": per_round} if args.use_scan else {}))
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
