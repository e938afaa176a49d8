"""Multi-rank dry run of the batched round (port of
``__graft_entry__.py::dryrun_multichip``).

    python3 -m sdpcutsel_tpu_torch.multichip_dryrun --ranks 2 [--data 1] [--cpu]

With no process group, ``dryrun_multichip`` spawns its ranks itself
(``parallel/distributed.spawn``); under ``torchrun`` each rank runs its part.
Every rank runs, at n = 12 and two instances a 'data' shard, on the mesh
(data x cand) = (2 x ranks/2) for an even rank count, else (1 x ranks) (or
``--data``'s), the reference's production steps: two neural round steps
(K1, K2), a 2-round BoxQP scan and a 2-round QCQP scan
(``generate_qcqp_family(12, 30, 2, 1, B)``, the clique table at k = 4, 2
dense rows: K4, K2).  The checks, as in the reference: the running bound
does not rise, cuts in the pool, finite f64 certificates of the fetched
batch, the scan's certificates monotone, and both scans within 1e-5 of the
one-process ``Mesh(1, 1)`` run of the whole batch.  One more check: every
pool (idx and count) and every certificate equals, bit for bit, one process
running each 'data' shard's instances as a batch of their own at the
logical ``Mesh(1, cand)`` (a whole batch and its shards differ in their last
bits: torch reduces a (B, ...) tensor in another order).  Rank 0 computes
the one-process runs after the ranks' part and prints the result line;
every rank prints its launch counts of the ranks' part.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as tdist

from .cuts.enumerate import combinations_table
from .instances import generate_qcqp_family, generate_spar
from .ops.launches import launch_counts
from .parallel import distributed
from .parallel.mesh import Mesh, make_mesh
from .parallel.round import (certify_batched_f64, certify_scan_f64, init_batched_state,
                             instances_of, make_sharded_round_step, make_sharded_scan_step,
                             shard_batched_state)
from .parallel.sharding import shard_candidates
from .qcqp.chordal import chordal_decomposition, clique_candidates
from .relax.denserows import batched_dense_from_qcqp

N, K, PER_SHARD, CAPACITY, LP_ITERS, SEL = 12, 3, 2, 64, 300, 4
M_DENSE = 2
MODULE = "sdpcutsel_tpu_torch.multichip_dryrun"


def _require(ok: bool, what: str):
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


class _Problem:
    """The dry run's batch of B = data x 2 instances, on every rank."""

    def __init__(self, data: int, dev):
        self.dev = dev
        self.B = data * PER_SHARD
        insts = [generate_spar(N, 100, s + 1) for s in range(self.B)]
        self.Qb = np.stack([i.Q for i in insts])
        self.cb = np.stack([i.c for i in insts])
        fam = generate_qcqp_family(N, 30, M_DENSE, 1, self.B)
        cliques, _ = chordal_decomposition(N, fam[0].sparsity_graph())
        self.qtable = clique_candidates(cliques, 4)
        self.Qq = np.stack([i.Q0 for i in fam])
        self.cq = np.stack([i.c0 for i in fam])
        self.dense = batched_dense_from_qcqp(fam, dev)

    def state(self, mesh, lo=None, hi=None, qcqp=False):
        """The start state over ``mesh``, or instances lo..hi-1 of it."""
        Q, c = (self.Qq, self.cq) if qcqp else (self.Qb, self.cb)
        st = init_batched_state(Q, c, CAPACITY, 4 if qcqp else K,
                                m_dense=M_DENSE if qcqp else 0, device=self.dev)
        return shard_batched_state(st, mesh) if lo is None else instances_of(st, lo, hi)

    def dense_of(self, mesh, lo=None, hi=None):
        if lo is not None:
            return type(self.dense)(*(t[lo:hi].contiguous() for t in
                                      (self.dense.G, self.dense.g, self.dense.h)))
        return distributed.put_global_tree(self.dense, mesh, "data", self.dev)

    def steps(self, mesh, lo=None, hi=None):
        """Two neural round steps: (best bound after round 1, state)."""
        st = self.state(mesh, lo, hi)
        table, valid = shard_candidates(combinations_table(N, K), mesh, device=self.dev)
        step = make_sharded_round_step(mesh, lp_iters=LP_ITERS, sel_size=SEL, strategy="neural")
        st, _ = step(st, table, valid)
        b1 = st.best_bound.clone()
        st, _ = step(st, table, valid)
        return b1, st

    def scan(self, mesh, lo=None, hi=None, qcqp=False):
        """A 2-round scan: (final state, outs)."""
        st = self.state(mesh, lo, hi, qcqp)
        dense = self.dense_of(mesh, lo, hi) if qcqp else None
        table_np = self.qtable if qcqp else combinations_table(N, K)
        table, valid = shard_candidates(table_np, mesh, device=self.dev)
        sc = make_sharded_scan_step(mesh, rounds=2, lp_iters=LP_ITERS, sel_size=SEL,
                                    strategy="neural", kmax=4 if qcqp else K,
                                    m_dense=M_DENSE if qcqp else 0)
        return sc(st, table, valid, dense)


def _scan_result(final, outs, mesh, dense=None):
    """(certificates (2, B), final pool idx, count) of the fetched batch
    as numpy; ``dense``: the batch's dense rows (all of its instances')."""
    f = distributed.fetch_tree(final, mesh)
    o = distributed.fetch_tree(outs, mesh, axis=1)
    return certify_scan_f64(f.Q, f.c, o, dense=dense), f.pool.idx, f.pool.count


def _rank_part(data: int, cand: int, dev) -> dict:
    mesh = make_mesh(data, cand)
    prob = _Problem(data, dev)
    b1, st = prob.steps(mesh)
    full = distributed.fetch_tree(st, mesh)
    b1 = distributed.fetch_tree(b1, mesh)
    out = {"mesh": mesh, "prob": prob, "b1": b1, "full": full,
           "cert": certify_batched_f64(full),
           "boxqp": _scan_result(*prob.scan(mesh), mesh),
           "qcqp": _scan_result(*prob.scan(mesh, qcqp=True), mesh, prob.dense)}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    out["launches"] = launch_counts()
    return out


def _references(part: dict) -> tuple:
    """The one-process runs, on this rank: (max |scan - Mesh(1, 1)| of the
    BoxQP and the QCQP scans, bit-equality of every 'data' shard at
    Mesh(1, cand))."""
    mesh, prob = part["mesh"], part["prob"]
    one = Mesh(1, 1)
    box_ref = _scan_result(*prob.scan(one), one)[0]
    q_ref = _scan_result(*prob.scan(one, qcqp=True), one, prob.dense)[0]
    box_delta = float(np.abs(part["boxqp"][0] - box_ref).max())
    q_delta = float(np.abs(part["qcqp"][0] - q_ref).max())
    logical = Mesh(1, mesh.cand)
    same = True
    for d in range(mesh.data):
        lo, hi = d * PER_SHARD, (d + 1) * PER_SHARD
        _, st = prob.steps(logical, lo, hi)
        full = part["full"]
        same &= (np.array_equal(st.pool.idx.cpu().numpy(), full.pool.idx[lo:hi])
                 and np.array_equal(st.pool.count.cpu().numpy(), full.pool.count[lo:hi])
                 and np.array_equal(certify_batched_f64(st), part["cert"][lo:hi]))
        for key, qcqp in (("boxqp", False), ("qcqp", True)):
            cert, idx, count = _scan_result(*prob.scan(logical, lo, hi, qcqp), logical,
                                            prob.dense_of(logical, lo, hi) if qcqp else None)
            want = part[key]
            same &= (np.array_equal(cert, want[0][:, lo:hi])
                     and np.array_equal(idx, want[1][lo:hi])
                     and np.array_equal(count, want[2][lo:hi]))
    return box_delta, q_delta, same


def _run_rank(data: int, cand: int, dev, save: Optional[str] = None) -> Optional[str]:
    part = _rank_part(data, cand, dev)
    rank = tdist.get_rank()
    b1, full, cert = part["b1"], part["full"], part["cert"]
    box_cert, q_cert = part["boxqp"][0], part["qcqp"][0]
    B = part["prob"].B
    _require(full.best_bound.shape == (B,), f"bounds of {B} instances")
    _require(bool((full.pool.count > 0).any()), "cuts in the pool")
    _require(bool((full.best_bound <= b1 + 1e-6).all()), "the running bound does not rise")
    _require(bool(np.isfinite(cert).all()), "finite f64 certificates")
    for name, c in (("BoxQP", box_cert), ("QCQP", q_cert)):
        _require(c.shape == (2, B) and bool(np.isfinite(c).all()), f"{name} scan finite")
    _require(bool((np.diff(box_cert, axis=0) <= 1e-9).all()), "the BoxQP scan monotone")
    distributed.sync("ranks-done")
    print(f"[launches rank {rank}] {json.dumps(part['launches'])}", flush=True)
    if rank:
        return None
    box_delta, q_delta, same = _references(part)
    _require(box_delta <= 1e-5, f"BoxQP scan diverges from Mesh(1, 1) by {box_delta:.2e}")
    _require(q_delta <= 1e-5, f"QCQP scan diverges from Mesh(1, 1) by {q_delta:.2e}")
    _require(same, f"the ranks differ from the per-shard batches at Mesh(1, {cand})")
    line = (f"dryrun_multichip ok: mesh=({data}x{cand}) ranks={data * cand} "
            f"backend={tdist.get_backend()} device={dev} neural "
            f"bounds_f32={np.round(full.best_bound, 2).tolist()} "
            f"certified_f64={np.round(cert, 2).tolist()} cuts={full.pool.count.tolist()} "
            f"scan_certified_f64={np.round(box_cert[-1], 2).tolist()} "
            f"boxqp_vs_one_process_max_delta={box_delta:.2e} "
            f"qcqp_scan_certified_f64={np.round(q_cert[-1], 2).tolist()} "
            f"qcqp_vs_one_process_max_delta={q_delta:.2e} "
            f"bit_equal_to_per_shard_batches={same}")
    print(line, flush=True)
    if save:
        np.savez(save, idx=full.pool.idx, count=full.pool.count, cert=cert,
                 **{f"{key}_{what}": v for key in ("boxqp", "qcqp")
                    for what, v in zip(("cert", "idx", "count"), part[key])})
    return line


def mesh_shape(n_ranks: int, data: Optional[int] = None) -> tuple:
    """(data, cand): the reference's 2 x n/2 for an even count, else 1 x n."""
    data = data or (2 if n_ranks % 2 == 0 and n_ranks >= 2 else 1)
    if n_ranks % data:
        raise ValueError(f"data={data} does not divide {n_ranks} ranks")
    return data, n_ranks // data


def dryrun_multichip(n_ranks: int, data: Optional[int] = None, device=None,
                     timeout: float = 600.0, save: Optional[str] = None):
    """The dry run over ``n_ranks`` ranks on the card (``device="cpu"``: the
    CPU, gloo).  Without a process group, spawn the ranks (each with
    ``timeout`` seconds) and return every rank's output; inside one, run
    this rank's part and return its result line (None but on rank 0).
    ``save``: rank 0 writes the fetched batch's pool and certificates after
    the two round steps, and each scan's certificates (rounds, B) and final
    pool, to this ``.npz`` (keys ``idx``, ``count``, ``cert``,
    ``boxqp_cert``, ``boxqp_idx``, ``boxqp_count`` and the same for
    ``qcqp``)."""
    data, cand = mesh_shape(n_ranks, data)
    cpu = device is not None and torch.device(device).type == "cpu"
    if tdist.is_initialized():
        return _run_rank(data, cand, distributed.device(), save)
    return distributed.spawn(["-m", MODULE, "--ranks", str(n_ranks), "--data", str(data),
                              *(["--cpu"] if cpu else []), *(["--save", save] if save else [])],
                             n_ranks, timeout)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=MODULE)
    ap.add_argument("--ranks", type=int, default=None,
                    help="default: the process group's size (WORLD_SIZE under torchrun)")
    ap.add_argument("--data", type=int, default=None)
    ap.add_argument("--cpu", action="store_true", help="ranks on the CPU (gloo)")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--save", default=None, help="rank 0: an .npz of the fetched results")
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    args = ap.parse_args(argv)
    as_rank = args.process_id is not None or args.coordinator is not None
    if as_rank or "RANK" in os.environ:
        distributed.initialize(args.coordinator, args.num_processes, args.process_id,
                               device=distributed.rank_device(args.cpu))
        n_ranks = args.ranks or tdist.get_world_size()
        dryrun_multichip(n_ranks, args.data, save=args.save)
        tdist.destroy_process_group()
        return 0
    outs = dryrun_multichip(args.ranks or 2, args.data, "cpu" if args.cpu else None,
                            args.timeout, args.save)
    print("".join(outs), end="")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
