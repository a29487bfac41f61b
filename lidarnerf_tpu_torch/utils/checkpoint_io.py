"""Checkpoint backends (counterpart of lidarnerf_tpu/utils/checkpoint_io.py): pickle and orbax.

- `pickle` (the default): one file holding the trainer's state dict,
  written atomically (to `<path>.tmp`, then `os.replace`). Its leaves are
  numpy arrays and Python values, so each package reads the other's files:
  it is the format both packages read. A row-sharded table is gathered
  whole before it is written (`parallel.sharding.full_state_dict`).
- `orbax`: the JAX package's sharded array store, a directory `<name>.ckpt/`
  holding `meta.pkl` (the non-array state and a plain description of the
  array tree: containers, each leaf's number, kind, dtype and shape) and
  `arrays/`, which torch.distributed.checkpoint writes: a leaf given as a
  DTensor (the table row-sharded over `model`) is written by each rank for
  its own rows, a collective of every rank; any other leaf is written once.
  The directory is built under `<name>.ckpt.tmp` and swapped in with the
  JAX package's `.old` renames, so a crash leaves a readable checkpoint.
  Orbax itself is a JAX library, absent where the port runs, so a
  directory the JAX package wrote cannot be read here: `load_state` raises
  and names `--ckpt_format pickle`.

`load_state`, `probe` and `remove` dispatch on file versus directory, so the
trainer's `glob('*.ckpt')` finds both. `load_state` returns whole arrays (a
sharded leaf assembled from every rank's rows) with numpy leaves, and reads
a pickle through `utils.params.load_state`, which refuses objects of the JAX
libraries. Unpickle only files this system wrote: unpickling can run code.
"""

import os
import pickle
import shutil

import numpy as np
import torch

from lidarnerf_tpu_torch.utils import params

FORMATS = ("pickle", "orbax")
_ARRAY_KEYS = ("model", "ema", "optimizer", "rng")  # the JAX package's
_MARK = "lidarnerf_tpu_torch/dcp/1"
_JAX_ORBAX = ("{path} is not a checkpoint of the port's orbax format (it holds no {what}): an "
              "orbax directory written by the JAX package needs orbax, a JAX library; save "
              "the run with --ckpt_format pickle, the format both packages read")


def check_format(fmt):
    if fmt not in FORMATS:
        raise ValueError(f"unknown checkpoint format {fmt!r}")


def dump_state(state, path, fmt="pickle"):
    """Persist `state` (a Trainer state dict) at `path`, atomically.

    The orbax format is a collective of every rank when a leaf is a DTensor;
    else the calling rank writes it alone.
    """
    check_format(fmt)
    if fmt == "pickle":
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(state, f)
        os.replace(tmp, path)
    else:
        _dump_dcp(state, path)


def _is_dtensor(x):
    return type(x).__name__ == "DTensor"


def _describe(tree, leaves):
    """`tree` with each array leaf replaced by its description, appended to `leaves`."""
    if isinstance(tree, dict):
        return {k: _describe(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, [_describe(v, leaves) for v in tree])
    if isinstance(tree, (np.ndarray, np.generic)) or torch.is_tensor(tree):
        kind = "torch" if torch.is_tensor(tree) else "numpy"
        t = tree if torch.is_tensor(tree) else torch.from_numpy(np.array(tree))
        leaves.append(t if _is_dtensor(t) else t.detach().cpu().contiguous())
        return {"__leaf__": len(leaves) - 1, "kind": kind, "dtype": str(t.dtype),
                "shape": tuple(t.shape)}
    return {"__value__": tree}


def _rebuild(desc, arrays):
    if isinstance(desc, tuple):
        kind, items = desc
        items = [_rebuild(v, arrays) for v in items]
        return tuple(items) if kind == "tuple" else items
    if "__leaf__" in desc:
        t = arrays[str(desc["__leaf__"])]
        return t if desc["kind"] == "torch" else t.numpy()
    if "__value__" in desc:
        return desc["__value__"]
    return {k: _rebuild(v, arrays) for k, v in desc.items()}


def _swap_in(tmp, path):
    """Replace `path` by the finished directory `tmp`; a crash between the two
    renames leaves `path.old` whole (the JAX package's rule)."""
    old = path + ".old"
    remove(old)
    had_old = os.path.exists(path)
    if had_old:
        os.replace(path, old)
    os.replace(tmp, path)
    if had_old:
        remove(old)


def _dump_dcp(state, path):
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    leaves = []
    tree = _describe({k: state[k] for k in _ARRAY_KEYS if k in state}, leaves)
    meta = {k: v for k, v in state.items() if k not in _ARRAY_KEYS}
    collective = any(_is_dtensor(t) for t in leaves)
    if collective and not (dist.is_initialized() and dist.get_world_size() > 1):
        collective = False
    writer = not collective or dist.get_rank() == 0
    tmp = path + ".tmp"
    if writer:
        remove(tmp)
        os.makedirs(tmp)
    if collective:
        dist.barrier()
    dcp.save({str(i): t for i, t in enumerate(leaves)}, checkpoint_id=os.path.join(tmp, "arrays"),
             no_dist=not collective)
    if writer:
        with open(os.path.join(tmp, "meta.pkl"), "wb") as f:
            pickle.dump({"format": _MARK, "meta": meta, "tree": tree, "n_leaves": len(leaves)}, f)
        _swap_in(tmp, path)
    if collective:
        dist.barrier()


def _load_dcp(path):
    import torch.distributed.checkpoint as dcp

    try:
        with open(os.path.join(path, "meta.pkl"), "rb") as f:
            blob = params._NumpyOnlyUnpickler(f).load()
    except (OSError, ValueError, EOFError, pickle.UnpicklingError) as e:
        raise NotImplementedError(_JAX_ORBAX.format(path=path, what=f"readable meta.pkl: {e}"))
    if not isinstance(blob, dict) or blob.get("format") != _MARK:
        raise NotImplementedError(_JAX_ORBAX.format(path=path, what="port format mark"))
    arrays = {}

    def alloc(desc):
        if isinstance(desc, tuple):
            for v in desc[1]:
                alloc(v)
        elif "__leaf__" in desc:
            dtype = getattr(torch, desc["dtype"].removeprefix("torch."))
            arrays[str(desc["__leaf__"])] = torch.empty(desc["shape"], dtype=dtype)
        elif "__value__" not in desc:
            for v in desc.values():
                alloc(v)

    alloc(blob["tree"])
    dcp.load(arrays, checkpoint_id=os.path.join(path, "arrays"), no_dist=True)
    state = dict(blob["meta"])
    state.update(_rebuild(blob["tree"], arrays))
    return state


def load_state(path):
    """A checkpoint written by `dump_state` (either format) or by the JAX
    trainer (pickle; its orbax directories raise, naming the pickle format)."""
    if not os.path.exists(path) and os.path.exists(path + ".old"):
        path = path + ".old"  # a crash between the two renames of an overwrite
    if os.path.isdir(path):
        return _load_dcp(path)
    return params.load_state(path)


def probe(path):
    """True iff `path` holds a complete, readable checkpoint."""
    try:
        if os.path.isdir(path):
            # a finished directory has its meta and a committed store; a crash
            # mid-save leaves only the ".tmp" directory, never `path`
            with open(os.path.join(path, "meta.pkl"), "rb") as f:
                blob = params._NumpyOnlyUnpickler(f).load()
            return blob.get("format") == _MARK and os.path.exists(
                os.path.join(path, "arrays", ".metadata"))
        load_state(path)
        return True
    except (OSError, EOFError, pickle.UnpicklingError, ValueError, AttributeError,
            NotImplementedError):
        return False


def remove(path):
    """Delete a checkpoint of either format (a file or a directory)."""
    if os.path.isdir(path):
        shutil.rmtree(path, ignore_errors=True)
    elif os.path.exists(path):
        os.remove(path)


def size_bytes(path):
    """Bytes on disk of a checkpoint of either format."""
    if os.path.isdir(path):
        return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)
    return os.path.getsize(path)
