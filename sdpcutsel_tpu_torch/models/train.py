"""Offline NN pipeline: subproblem sampling, exact labelling, MLP training
(port of ``sdpcutsel_tpu/models/train.py``).

The label oracle is the batched ADMM of ``labels.py``, so sampling,
labelling and training all run on one device (the card unless the caller
asks for the CPU); the harvests run the port's solvers, whose scoring and
LP blocks are the hand-written kernels on the card.

Sampling distribution (as the reference's):
  Qhat  - symmetric, entries U[-1, 1], a random density mask (each
          off-diagonal kept with p ~ U[0.3, 1], the diagonal always),
          rescaled to max-abs 1;
  x*    - U[0, 1]^k;
  X*    - half McCormick vertices (each entry at its upper bound where a
          Bernoulli(1/2) draw and its transpose agree, else at its lower
          bound), half uniform interior points of the McCormick box at x*.

Label = max(0, 1/2 <Qhat, X*> - s(Qhat; x*)), the exact optimality score.

Training is the reference's: Adam (b1 0.9, b2 0.999, eps 1e-8 outside the
square root, bias-corrected) on the MSE, the step size
lr * (1 + cos(pi * min(t, steps) / steps)) / 2 at step t = 0, 1, ...
(``optax.cosine_decay_schedule``), batches drawn with ``torch.randint``
from an explicit generator.  The forward and backward passes are plain
torch, as the reference's are plain XLA: no kernel has a backward.

Run:  python -m sdpcutsel_tpu_torch.models.train --k 3 --samples 200000 [--cpu]
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from .features import tri_indices
from .labels import _mccormick_box, exact_improvement
from .scorer import MLPScorer, artifact_path, init_params, params_of, save_params


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def sample_subproblems(generator: torch.Generator, k: int, num: int, dup_frac: float = 0.0):
    """Returns (Qhat (N, k, k), x (N, k), X (N, k, k)) on the generator's
    device, in the distribution of the module docstring.

    dup_frac: fraction of samples whose LAST coordinate duplicates their
    first (row/col copies in Q, x, X), as the padded clique-subset tables of
    the QCQP path repeat an index.  Every draw (the density mask, the vertex
    pick, the vertex/interior choice, the duplication) is independent; the
    reference reuses one key for the vertex pick and the vertex/interior
    choice, and one for the mask and the duplication."""
    dev = generator.device

    def uniform(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=generator, device=dev)

    Q = uniform(num, k, k, lo=-1.0)
    Q = 0.5 * (Q + Q.transpose(1, 2))
    p = uniform(num, 1, 1, lo=0.3)
    mask = uniform(num, k, k) < p
    mask = mask | mask.transpose(1, 2) | torch.eye(k, dtype=torch.bool, device=dev)
    Q = Q * mask
    Q = Q / Q.abs().amax(dim=(1, 2), keepdim=True).clamp(min=1e-6)

    x = uniform(num, k)
    lo, hi = _mccormick_box(x)
    t = uniform(num, k, k)
    t = 0.5 * (t + t.transpose(1, 2))
    interior = lo + t * (hi - lo)
    vert_pick = uniform(num, k, k) < 0.5
    vert_pick = vert_pick & vert_pick.transpose(1, 2)
    vertex = torch.where(vert_pick, hi, lo)
    use_vertex = uniform(num, 1, 1) < 0.5
    X = torch.where(use_vertex, vertex, interior)

    if dup_frac > 0.0:
        dup = uniform(num) < dup_frac
        last = torch.arange(k, device=dev) == k - 1
        x = torch.where(dup[:, None] & last[None, :], x[:, :1], x)

        def dup_mat(M):
            M = torch.where(dup[:, None, None] & last[None, :, None], M[:, :1, :], M)
            return torch.where(dup[:, None, None] & last[None, None, :], M[:, :, :1], M)

        Q, X = dup_mat(Q), dup_mat(X)
    return Q, x, X


def make_features(Qhat, x, X):
    i0, i1 = tri_indices(x.shape[-1], x.device)
    return torch.cat([Qhat[:, i0, i1], x, X[:, i0, i1]], dim=1)


def gen_dataset(generator: torch.Generator, k: int, num: int, admm_iters: int = 400,
                chunk: int = 65536, dup_frac: float = 0.0):
    """Exact-labelled synthetic dataset (features (num, d), labels (num,)) on
    the generator's device, sampled and labelled ``chunk`` blocks at a time."""
    feats_all, labels_all = [], []
    done = 0
    while done < num:
        m = min(chunk, num - done)
        Q, x, X = sample_subproblems(generator, k, m, dup_frac=dup_frac)
        labels_all.append(exact_improvement(Q, x, X, iters=admm_iters))
        feats_all.append(make_features(Q, x, X))
        done += m
    return torch.cat(feats_all), torch.cat(labels_all)


def _harvest(solver, table: np.ndarray, Q: np.ndarray, rounds: int, per_round: int,
             admm_iters: int, rng, feats_all: list, labels_all: list):
    """Run ``rounds`` rounds of ``solver``; after each, label a random subset
    of ``table``'s rows (numpy ``rng``) at the round's LP point."""
    dev = solver.device
    Qfull = torch.as_tensor(Q, dtype=torch.float32, device=dev)
    for _ in range(rounds):
        solver.do_round()
        x, X = solver.state.x, solver.state.X
        sel = rng.choice(table.shape[0], size=min(per_round, table.shape[0]), replace=False)
        idx = torch.as_tensor(table[sel], dtype=torch.long, device=dev)
        Qr = Qfull[idx[:, :, None], idx[:, None, :]]
        scale = Qr.abs().amax(dim=(1, 2)).clamp(min=1e-12)
        Qhat = Qr / scale[:, None, None]
        xr = x[idx]
        Xr = X[idx[:, :, None], idx[:, None, :]]
        labels_all.append(exact_improvement(Qhat, xr, Xr, iters=admm_iters))
        feats_all.append(make_features(Qhat, xr, Xr))


def harvest_dataset(k: int, instances=None, rounds: int = 4, per_round: int = 4096,
                    admm_iters: int = 400, seed: int = 0, lp_max_iters: int = 10_000,
                    device="cuda"):
    """Exact-labelled dataset harvested from real BoxQP cutting-plane runs:
    the feasibility-strategy loop on generated instances, labelling a random
    subsample of candidate blocks at each round's LP point.  The picks come
    from ``np.random.default_rng(seed)``, so they are the reference's."""
    from ..config import CutConfig, LPConfig, RunConfig, ScorerConfig
    from ..cuts.enumerate import combinations_table
    from ..instances.boxqp import generate_spar
    from ..loop.solver import CutSolver

    if instances is None:
        instances = [generate_spar(n, d, s) for n in (20, 30) for d in (50, 100) for s in (1, 2)]
    rng = np.random.default_rng(seed)
    feats_all, labels_all = [], []
    cfg = RunConfig(
        lp=LPConfig(max_iters=lp_max_iters, tol=2e-6),
        cuts=CutConfig(k=k, sel_size=max(4, 20), capacity=1024),
        scorer=ScorerConfig(strategy="feasibility"),
    )
    for inst in instances:
        solver = CutSolver(inst, cfg, device=device)
        _harvest(solver, combinations_table(inst.n, k), inst.Q, rounds, per_round,
                 admm_iters, rng, feats_all, labels_all)
    return torch.cat(feats_all), torch.cat(labels_all)


def harvest_dataset_qcqp(k: int, specs=None, rounds: int = 4, per_round: int = 2048,
                         admm_iters: int = 400, seed: int = 0, lp_max_iters: int = 10_000,
                         device="cuda"):
    """Exact-labelled dataset harvested from real sparse-QCQP runs (the
    feasibility-strategy loop of ``CutSolverQCQP``), labelling a random
    subsample of the clique-candidate table at each round's LP point."""
    from ..config import CutConfig, LPConfig, RunConfig, ScorerConfig
    from ..instances.qcqp import generate_qcqp
    from ..qcqp.solver import CutSolverQCQP

    if specs is None:
        specs = [(15, 30, 3, 1), (15, 30, 3, 2), (20, 25, 4, 1), (20, 25, 4, 2), (25, 20, 4, 1)]
    rng = np.random.default_rng(seed)
    feats_all, labels_all = [], []
    cfg = RunConfig(
        lp=LPConfig(max_iters=lp_max_iters, tol=2e-6),
        cuts=CutConfig(k=k, sel_size=16, capacity=1024),
        scorer=ScorerConfig(strategy="feasibility"),
    )
    for spec in specs:
        inst = generate_qcqp(*spec)
        solver = CutSolverQCQP(inst, cfg, device=device)
        _harvest(solver, solver.table.cpu().numpy(), inst.Q0, rounds, per_round,
                 admm_iters, rng, feats_all, labels_all)
    return torch.cat(feats_all), torch.cat(labels_all)


def cosine_lr(lr: float, steps: int, t: int) -> float:
    """``optax.cosine_decay_schedule(lr, steps)`` at step count t (0 first)."""
    return lr * 0.5 * (1.0 + math.cos(math.pi * min(t, steps) / steps))


def adam(model: MLPScorer) -> torch.optim.Adam:
    """``optax.adam``'s update (b1 0.9, b2 0.999, eps 1e-8 outside the square
    root, bias-corrected); ``train_step`` sets the step size."""
    return torch.optim.Adam(model.parameters(), lr=0.0, betas=(0.9, 0.999), eps=1e-8)


def train_step(model: MLPScorer, optimizer, lr_t: float, ftr, ltr, idx):
    """One Adam step of step size ``lr_t`` on the MSE over rows ``idx`` of
    (ftr, ltr).  Returns the batch loss before the step (a 0-d tensor)."""
    for group in optimizer.param_groups:
        group["lr"] = lr_t
    fb, lb = ftr[idx], ltr[idx]
    loss = ((model(fb) - lb) ** 2).mean()
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    return loss.detach()


def train_scorer(
    k: int = 3,
    samples: int = 200_000,
    steps: int = 4000,
    batch: int = 4096,
    lr: float = 1e-3,
    hidden=(64, 64),
    seed: int = 0,
    out_path: str | None = None,
    verbose: bool = True,
    harvest: bool = True,
    harvest_rounds: int = 4,
    device="cuda",
):
    """Label a dataset, train the k scorer on it and write its ``.npz``
    (default: the shipped ``artifact_path(k)``).  Returns (params, metrics):
    the weights in the ``.npz`` layout and the reference's holdout metrics.
    ``seed`` sets all the randomness: a generator on ``device`` seeded with
    it draws the samples and the batches, the weights start from
    ``init_params(k, hidden, seed)``, and the harvest picks and the
    permutations come from numpy generators seeded from it."""
    device = torch.device(device)
    generator = torch.Generator(device).manual_seed(seed)
    t0 = time.perf_counter()
    # k>=4 scorers serve the QCQP padded tables: include duplicated-index
    # samples so those inputs are in-distribution
    feats, labels = gen_dataset(generator, k, samples, dup_frac=0.25 if k >= 4 else 0.0)
    _sync(device)
    t1 = time.perf_counter()
    if verbose:
        print(f"[train] synthetic: {samples} rows labelled in {t1 - t0:.4f}s")
    if harvest:
        hf, hl = harvest_dataset(k, rounds=harvest_rounds, seed=seed, device=device)
        _sync(device)
        if verbose:
            print(f"[train] harvest: {len(hf)} rows, {harvest_rounds} rounds an instance, "
                  f"in {time.perf_counter() - t1:.4f}s")
        feats = torch.cat([feats, hf])
        labels = torch.cat([labels, hl])
        perm = torch.as_tensor(np.random.default_rng(seed).permutation(len(feats)), device=device)
        feats, labels = feats[perm], labels[perm]
    if verbose:
        print(f"[train] dataset: {tuple(feats.shape)} labeled in {time.perf_counter() - t0:.1f}s "
              f"(mean label {float(labels.mean()):.4f}, "
              f"frac>1e-3 {float((labels > 1e-3).float().mean()):.3f})")

    n_train = int(0.95 * len(feats))
    ftr, ltr = feats[:n_train], labels[:n_train]
    fte, lte = feats[n_train:], labels[n_train:]
    if harvest and k >= 4:
        # k>=4 serves the QCQP path: harvest from real QCQP runs too.  Split
        # BEFORE upweighting so repeated train rows never leak into the
        # holdout; upweight by repetition because the QCQP tables are small.
        t2 = time.perf_counter()
        qf, ql = harvest_dataset_qcqp(k, rounds=harvest_rounds, seed=seed, device=device)
        qperm = torch.as_tensor(np.random.default_rng(seed + 1).permutation(len(qf)),
                                device=device)
        qf, ql = qf[qperm], ql[qperm]
        q_tr = int(0.95 * len(qf))
        reps = max(1, int(0.25 * n_train / max(q_tr, 1)))
        ftr = torch.cat([ftr] + [qf[:q_tr]] * reps)
        ltr = torch.cat([ltr] + [ql[:q_tr]] * reps)
        tperm = torch.as_tensor(np.random.default_rng(seed + 2).permutation(len(ftr)),
                                device=device)
        ftr, ltr = ftr[tperm], ltr[tperm]
        fte = torch.cat([fte, qf[q_tr:]])
        lte = torch.cat([lte, ql[q_tr:]])
        _sync(device)
        if verbose:
            print(f"[train] +qcqp harvest: {len(qf)} rows x{reps} into train, "
                  f"{len(qf) - q_tr} into holdout, {harvest_rounds} rounds an instance, "
                  f"in {time.perf_counter() - t2:.4f}s")
    n_train = len(ftr)

    model = MLPScorer(init_params(k, hidden, seed), device, trainable=True)
    optimizer = adam(model)

    def holdout():
        with torch.no_grad():
            return model(fte)

    t0 = time.perf_counter()
    for i in range(steps):
        idx = torch.randint(0, n_train, (batch,), generator=generator, device=device)
        loss = train_step(model, optimizer, cosine_lr(lr, steps, i), ftr, ltr, idx)
        if verbose and (i % 500 == 0 or i == steps - 1):
            pred = holdout()
            mse = float(((pred - lte) ** 2).mean())
            var = float(lte.var(correction=0))
            # rank quality matters for selection: Spearman on holdout
            rs = _spearman(pred.cpu().numpy(), lte.cpu().numpy())
            print(f"[train] step {i}: loss={float(loss):.5f} "
                  f"holdout R2={1 - mse / max(var, 1e-12):.3f} spearman={rs:.3f}")
    _sync(device)
    if verbose:
        loop_s = time.perf_counter() - t0
        print(f"[train] {steps} steps of batch {batch} in {loop_s:.4f}s = "
              f"{steps / loop_s:.2f} steps/s")

    params = params_of(model)
    out_path = out_path or artifact_path(k)
    save_params(params, out_path)
    pred = holdout().cpu().numpy()
    lte_np = lte.cpu().numpy()
    mse = float(np.mean((pred - lte_np) ** 2))
    # ranking quality where it matters: among genuinely improving candidates,
    # and precision of the predicted top decile at catching the true top decile
    pos = lte_np > 1e-3
    q = np.quantile(lte_np, 0.9)
    top_true = lte_np >= q
    top_pred = pred >= np.quantile(pred, 0.9)
    metrics = {
        "holdout_mse": mse,
        "holdout_r2": 1 - mse / max(float(np.var(lte_np)), 1e-12),
        "holdout_spearman": _spearman(pred, lte_np),
        "spearman_positive": (
            _spearman(pred[pos], lte_np[pos]) if pos.sum() > 10 else None
        ),
        "precision_at_top10pct": float((top_true & top_pred).sum() / max(top_true.sum(), 1)),
        "train_time_s": time.perf_counter() - t0,
        "samples": int(len(feats)),
    }
    if verbose:
        print(f"[train] saved {out_path}: {metrics}")
    return params, metrics


def _spearman(a: np.ndarray, b: np.ndarray) -> float:
    ra = np.argsort(np.argsort(a)).astype(np.float64)
    rb = np.argsort(np.argsort(b)).astype(np.float64)
    ra -= ra.mean()
    rb -= rb.mean()
    denom = np.sqrt((ra**2).sum() * (rb**2).sum())
    return float((ra * rb).sum() / max(denom, 1e-12))


def main(argv=None):
    """``cli train`` under this module's name: the flags are ``cli.py``'s."""
    from ..cli import main as cli_main

    return cli_main(["train", *(sys.argv[1:] if argv is None else argv)])


if __name__ == "__main__":
    sys.exit(main())
