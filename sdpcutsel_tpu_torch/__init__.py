"""PyTorch + CUDA port of the BoxQP and sparse-QCQP cutting-plane rounds of
``sdpcutsel_tpu``.

The JAX package ``sdpcutsel_tpu`` is the reference; this package mirrors its
layout so the counterpart of a module is easy to find:

- ``relax``  — cut pool, McCormick operators and QCQP dense rows on tensors.
- ``lp``     — restarted averaged PDHG, the f64 dual certificate, and the
               wrapper of the PDHG iteration-block kernel (``csrc/pdhg_block.cu``).
- ``cuts``   — candidate table, Z(rho) assembly, small eigh, cut rows, and
               the triangle (RLT-3) family.
- ``ops``    — top-k selection, struct-of-arrays Jacobi, and the wrappers of
               the scoring kernels (``csrc/pair_score.cu`` for dense k = 3,
               ``csrc/fused_score.cu`` for any (T, k) table, k = 2..5).
- ``models`` — feature layout, the MLP scorer (weights in ``.npz``) and the
               exact optimality oracle (batched ADMM).
- ``loop``   — the BoxQP round controller ``CutSolver`` and the round loop
               and checkpoints it shares with the QCQP solver: every
               strategy, per-round and scan mode, steering, polish.
- ``qcqp``   — the sparse-QCQP round controller ``CutSolverQCQP``.
- ``utils``  — debug mode and the round snapshots (``.npz`` + JSON).
- ``_build`` — compiles ``csrc/*.cu`` with nvcc at first use (ctypes binding).

- ``config``, ``instances``, ``qcqp/chordal.py`` — the port's own copies of
               the reference's configuration tree, instance generators and
               readers, and chordal decomposition (numpy).

It imports ``torch`` and numpy only: nothing of ``sdpcutsel_tpu`` and no jax.
Every kernel wrapper takes its plain PyTorch twin for CPU tensors only; a
CUDA tensor launches the kernel.  The solvers run on ``"cuda"`` unless the
caller passes another device.
"""

__version__ = "0.1.0"
