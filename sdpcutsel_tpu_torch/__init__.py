"""PyTorch + CUDA port of the BoxQP cutting-plane round of ``sdpcutsel_tpu``.

The JAX package ``sdpcutsel_tpu`` is the reference; this package mirrors its
layout so the counterpart of a module is easy to find:

- ``relax``  — cut pool and McCormick operators on tensors.
- ``lp``     — restarted averaged PDHG, the f64 dual certificate, and the
               wrapper of the PDHG iteration-block kernel (``csrc/pdhg_block.cu``).
- ``cuts``   — candidate table, Z(rho) assembly, small eigh, cut rows.
- ``ops``    — top-k selection, struct-of-arrays Jacobi, and the wrapper of
               the candidate scoring kernel (``csrc/pair_score.cu``).
- ``models`` — feature layout and the MLP scorer (weights in ``.npz``).
- ``loop``   — the round controller ``CutSolver`` (per-round mode, neural).
- ``_build`` — compiles ``csrc/*.cu`` with nvcc at first use (ctypes binding).

It imports ``torch`` and numpy, plus the numpy-only ``sdpcutsel_tpu.config``
and ``sdpcutsel_tpu.instances``; never jax.  Every kernel wrapper takes its
plain PyTorch twin for CPU tensors only; a CUDA tensor launches the kernel.
"""

__version__ = "0.1.0"
