"""Checkpoint files (counterpart of lidarnerf_tpu/utils/checkpoint_io.py:31-125, pickle only).

A checkpoint is one pickle file holding the trainer's state dict, written
atomically (to `<path>.tmp`, then `os.replace`), so a kill mid-write leaves
the previous file whole. Its leaves are numpy arrays and Python values, so
each package reads the other's files. The JAX package's second format,
`orbax` (a directory per checkpoint), needs the orbax library, a JAX
library: it raises here (ROADMAP.md, queue A item 6, beside the sharded
table).

`load_state` reads a checkpoint through `utils.params.load_state`, which
refuses objects of the JAX libraries and reads a JAX optimizer state
(optax's) as plain tuples.
Unpickle only files this system wrote: unpickling can run code.
"""

import os
import pickle

from lidarnerf_tpu_torch.utils import params

_ORBAX = ("checkpoint format 'orbax' needs the orbax library, a JAX library "
          "(ROADMAP.md, queue A item 6); use 'pickle'")


def check_format(fmt):
    if fmt == "orbax":
        raise NotImplementedError(_ORBAX)
    if fmt != "pickle":
        raise ValueError(f"unknown checkpoint format {fmt!r}")


def dump_state(state, path, fmt="pickle"):
    """Atomically persist `state` (a Trainer state dict) at `path`."""
    check_format(fmt)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(state, f)
    os.replace(tmp, path)


def load_state(path):
    """Load a checkpoint written by `dump_state` or by the JAX trainer (pickle;
    an orbax directory raises)."""
    return params.load_state(path)


def probe(path):
    """True iff `path` holds a complete, readable checkpoint."""
    try:
        load_state(path)
        return True
    except (OSError, EOFError, pickle.UnpicklingError, ValueError, NotImplementedError):
        return False


def remove(path):
    if os.path.exists(path):
        os.remove(path)
