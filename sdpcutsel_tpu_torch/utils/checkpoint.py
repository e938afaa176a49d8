"""Round-granular checkpoint and resume (port of
``sdpcutsel_tpu/utils/checkpoint.py``, in the port's own format).

A solver's whole state between rounds is its cut pool, its PDHG warm start,
its random generator and its history; the QCQP solver adds its re-selection
gate.  A snapshot at ``path`` is two files:
  * ``path``: an ``.npz`` of the ``CutPool`` fields (``pool.<field>``), the
    ``PDHGState`` fields (``state.<field>``), the CPU generator's
    ``get_state()`` (``generator``, uint8) and any extra arrays
    (``extra.<name>``), all as host numpy arrays with their own dtypes, so a
    restore gives back the same bits;
  * ``path + ".json"``: the history (one dict a round) and the meta dict.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_checkpoint(path: str, pool, state, generator_state: torch.Tensor,
                    history: list, meta: dict, extra: dict | None = None):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arrays = {f"pool.{f.name}": _host(getattr(pool, f.name))
              for f in dataclasses.fields(pool)}
    arrays.update({f"state.{f.name}": _host(getattr(state, f.name))
                   for f in dataclasses.fields(state)})
    arrays["generator"] = _host(generator_state)
    arrays.update({f"extra.{k}": _host(v) for k, v in (extra or {}).items()})
    with open(path, "wb") as f:         # a file object: np.savez adds no suffix
        np.savez(f, **arrays)
    with open(path + ".json", "w") as f:
        json.dump({"history": history, "meta": meta}, f)


def load_checkpoint(path: str):
    """Returns (pool fields, state fields, generator state: a uint8 tensor,
    history, meta, extra arrays), the fields and extras as dicts of numpy
    arrays."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    with open(path + ".json") as f:
        side = json.load(f)

    def group(prefix):
        return {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)}

    return (group("pool."), group("state."), torch.from_numpy(arrays["generator"]),
            side["history"], side["meta"], group("extra."))
