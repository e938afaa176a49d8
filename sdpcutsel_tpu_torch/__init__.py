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
- ``models`` — feature layout, the MLP scorer (weights in ``.npz``), the
               exact optimality oracle (batched ADMM), and training
               (``train``: ADMM-labelled samples and harvests from real
               runs, Adam on the device).
- ``loop``   — the BoxQP round controller ``CutSolver`` and the round loop
               and checkpoints it shares with the QCQP solver: every
               strategy, per-round and scan mode, steering, polish; and the
               SDP certifiers (``sdp_bound``: the in-out eigencut loop over a
               dense cut buffer on the device; ``sdp_primal``, ``sdp_dual``:
               the Burer-Monteiro and Lagrangian-dual bounds, host f64).
- ``qcqp``   — the sparse-QCQP round controller ``CutSolverQCQP``.
- ``parallel`` — instance batching on one card (the batched round and scan).
- ``utils``  — debug mode, the round snapshots (``.npz`` + JSON), the
               certified-bounds registries and ``JSONLLogger``.
- ``bench``, ``cli`` — the experiment runner (``python3 -m
               sdpcutsel_tpu_torch.cli solve|suite|sdpbound|train``);
               ``validate_sdp_bounds``, ``validate_qcqp_bounds`` — the
               registry validators.
- ``_build`` — compiles ``csrc/*.cu`` with nvcc at first use (ctypes binding).

- ``config``, ``instances``, ``qcqp/chordal.py`` — the port's own copies of
               the reference's configuration tree, instance generators and
               readers, and chordal decomposition (numpy).

It imports ``torch``, numpy and scipy only: nothing of ``sdpcutsel_tpu`` and no
jax.
Every kernel wrapper takes its plain PyTorch twin for CPU tensors only; a
CUDA tensor launches the kernel.  The solvers run on ``"cuda"`` unless the
caller passes another device.
"""

__version__ = "0.1.0"
