"""PyTorch + CUDA port of the BoxQP and sparse-QCQP cutting-plane rounds of
``sdpcutsel_tpu``.

The JAX package ``sdpcutsel_tpu`` is the reference; this package mirrors its
layout so the counterpart of a module is easy to find:

- ``relax``  — cut pool, McCormick operators and QCQP dense rows on tensors.
- ``lp``     — restarted averaged PDHG, the f64 dual certificate, and the
               wrapper of the PDHG iteration-block kernel (``csrc/pdhg_block.cu``).
- ``cuts``   — candidate table, Z(rho) assembly, small eigh, cut rows.
- ``ops``    — top-k selection, struct-of-arrays Jacobi, and the wrappers of
               the scoring kernels (``csrc/pair_score.cu`` for dense k = 3,
               ``csrc/fused_score.cu`` for any (T, k) table, k = 2..5).
- ``models`` — feature layout and the MLP scorer (weights in ``.npz``).
- ``loop``   — the BoxQP round controller ``CutSolver`` (per-round mode,
               neural).
- ``qcqp``   — the sparse-QCQP round controller ``CutSolverQCQP``.
- ``_build`` — compiles ``csrc/*.cu`` with nvcc at first use (ctypes binding).

It imports ``torch`` and numpy, plus the numpy-only ``sdpcutsel_tpu.config``,
``sdpcutsel_tpu.instances`` and ``sdpcutsel_tpu.qcqp.chordal``; never jax.  Every kernel wrapper takes its
plain PyTorch twin for CPU tensors only; a CUDA tensor launches the kernel.
"""

__version__ = "0.1.0"
