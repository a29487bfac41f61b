"""Weight bridge between the JAX package's flax parameters and the port's state_dict.

The flax tree is the `state["model"]` a JAX checkpoint holds
(lidarnerf_tpu/nerf/trainer.py:837), beside `state["occ_grid"]` under
`--fast` (:840-844): nested dicts of numpy arrays,
`{"params": {"hash_table": ..., "<net>": {"Dense_i": {"kernel": [in, out]}}}}`.
The tables are kept as they are: `hash_table` is [L*B, 128] under
blockhash, [table_rows, level_dim] under hashgrid and tiledgrid, [R^3 L, C]
under periodic_volume, and absent under frequency and None; `bg_table`
[table_rows, level_dim] and `bg_net` exist with the background sphere
(bg_radius > 0). Each `Dense_i/kernel` is stored transposed as
`<net>.layers.i.weight` [out, in], the torch `nn.Linear` layout.
The optimizer state travels in optax's layout (`optimizer_to_jax`,
`optimizer_from_jax`). `load_state` reads either package's pickle
checkpoints without JAX.

The classical baselines' nets (lidarnvs/) cross the same way: the ray-drop
MLP's `Dense_i` {kernel [in, out], bias} is `layers.i` {weight [out, in],
bias} (`raydrop_params_*`), and the UNet's flax tree (`params` and
`batch_stats`) is the port UNet's state_dict (`unet_params_*`).
"""

import os
import pickle

import numpy as np
import torch

_TABLES = ("hash_table", "bg_table")
_NETS = ("sigma_net", "color_net", "lidar_color_net", "bg_net")
_FOREIGN = ("jax", "jaxlib", "flax", "optax", "orbax", "lidarnerf_tpu")


def params_from_jax(tree) -> dict:
    """Flax parameter tree (numpy leaves) -> NeRFNetwork state_dict (float32 CPU tensors)."""
    p = tree.get("params", tree)
    unknown = set(p) - {*_TABLES, *_NETS}
    if unknown:
        raise ValueError(f"parameters with no home in the port: {sorted(unknown)}")
    sd = {t: torch.from_numpy(np.array(p[t], dtype=np.float32)) for t in _TABLES if t in p}
    for net in _NETS:
        for name, layer in p.get(net, {}).items():
            i = int(name.removeprefix("Dense_"))
            kernel = np.array(layer["kernel"], dtype=np.float32)
            sd[f"{net}.layers.{i}.weight"] = torch.from_numpy(kernel.T.copy())
    return sd


def params_to_jax(state_dict) -> dict:
    """NeRFNetwork state_dict -> flax parameter tree with numpy leaves."""
    p = {t: state_dict[t].detach().cpu().numpy() for t in _TABLES if t in state_dict}
    for key, value in state_dict.items():
        net, _, rest = key.partition(".layers.")
        if net in _NETS:
            i = int(rest.removesuffix(".weight"))
            p.setdefault(net, {})[f"Dense_{i}"] = {"kernel": value.detach().cpu().numpy().T.copy()}
    return {"params": p}


def optimizer_to_jax(state) -> tuple:
    """DeviceAdam.state_dict() -> the JAX trainer's `optimizer` entry, numpy leaves.

    optax.adam with a schedule keeps (ScaleByAdamState(count, mu, nu),
    ScaleByScheduleState(count)), mu and nu in the flax parameter layout;
    written as plain tuples, they flatten to the same leaves in the same
    order, [count, mu..., nu..., count] with flax's sorted keys, which the
    JAX trainer unflattens into its own state (lidarnerf_tpu/nerf/trainer.py:929-935).
    """
    return ((np.asarray(state["count"], np.int32), params_to_jax(state["mu"]),
             params_to_jax(state["nu"])), (np.asarray(state["schedule_count"], np.int32),))


def optimizer_from_jax(entry) -> dict:
    """The `optimizer` entry of either package's checkpoint -> DeviceAdam.state_dict()'s
    layout (moments as state_dict names, kernels transposed)."""
    (count, mu, nu), (schedule_count,) = entry
    return {"count": int(np.asarray(count)), "schedule_count": int(np.asarray(schedule_count)),
            "mu": params_from_jax(mu), "nu": params_from_jax(nu)}


def optimizer_from_torch_adam(entry, names) -> dict:
    """The `optimizer_torch` entry of the port's older checkpoints (torch.optim.Adam's
    state_dict over the parameters `names` in order, and LambdaLR's) -> DeviceAdam's
    layout: exp_avg and exp_avg_sq are Adam's moments, its step the count."""
    state = entry["adam"]["state"]
    steps = {int(np.asarray(s["step"])) for s in state.values()}
    if len(steps) > 1:
        raise ValueError(f"the parameters' Adam steps differ: {sorted(steps)}")
    return {"count": steps.pop() if steps else 0,
            "schedule_count": int(entry["schedule"]["last_epoch"]),
            "mu": {names[i]: torch.from_numpy(np.asarray(s["exp_avg"])) for i, s in state.items()},
            "nu": {names[i]: torch.from_numpy(np.asarray(s["exp_avg_sq"]))
                   for i, s in state.items()}}


class _OptaxState(tuple):
    """Inert stand-in for an optax state class (a NamedTuple) in a JAX checkpoint.

    A JAX checkpoint's `optimizer` entry holds optax states; they unpickle
    as these, and `load_state` turns them into plain tuples of their fields.
    Anywhere else one is refused.
    """

    qualname = "optax"

    def __new__(cls, *fields):
        return super().__new__(cls, fields)

    def __setstate__(self, state):
        pass


class _NumpyOnlyUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        root = module.split(".")[0]
        if root == "optax":
            return type(name, (_OptaxState,), {"qualname": f"{module}.{name}"})
        if root in _FOREIGN:
            raise ValueError(
                f"the checkpoint holds a {module}.{name} object, which needs the "
                "JAX package to unpickle; save its trees with jax.device_get "
                "(numpy leaves) to load them here"
            )
        return super().find_class(module, name)


def _find_optax(tree):
    """The qualified name of the first optax stand-in in `tree`, or None."""
    if isinstance(tree, _OptaxState):
        return tree.qualname
    children = tree.values() if isinstance(tree, dict) else (
        tree if isinstance(tree, (list, tuple)) else ())
    for x in children:
        found = _find_optax(x)
        if found:
            return found
    return None


def _plain(tree):
    """`tree` with every optax stand-in turned into a plain tuple of its fields."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return (list if isinstance(tree, list) else tuple)(_plain(x) for x in tree)
    return tree


def load_state(path) -> dict:
    """The state dict of a pickle checkpoint, without JAX.

    Objects of jax, jaxlib, flax, orbax or lidarnerf_tpu raise. optax
    states are allowed in the `optimizer` entry of a JAX checkpoint, and
    come back as plain tuples of their fields (`optimizer_from_jax` reads
    them); an optax object anywhere else raises.
    """
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a directory, an orbax checkpoint: only pickle checkpoints load here; "
            "save the run with --ckpt_format pickle, the format both packages read")
    with open(path, "rb") as f:
        state = _NumpyOnlyUnpickler(f).load()
    if isinstance(state, dict):
        found = _find_optax({k: v for k, v in state.items() if k != "optimizer"})
        if "optimizer" in state:
            state["optimizer"] = _plain(state["optimizer"])
    else:
        found = _find_optax(state)
    if found:
        raise ValueError(f"the checkpoint holds a {found} object outside its 'optimizer' entry")
    return state


def load_jax_checkpoint(path) -> dict:
    """Model parameters (flax tree, numpy leaves) of a JAX pickle checkpoint.

    Reads the `.ckpt` pickle the JAX trainer writes without importing JAX,
    under the rules of `load_state`. Unpickle only files this system wrote:
    unpickling can run code.
    """
    state = load_state(path)
    return state.get("model", state)


def load_jax_occ_grid(path):
    """The occupancy grid of a JAX pickle checkpoint, [G, G, G] float32 numpy,
    or None if the run did not sample by occupancy (no `--fast`).

    The JAX trainer stores it as `state["occ_grid"]` and reads it back on
    resume (lidarnerf_tpu/nerf/trainer.py:840-844, 914-915); the same
    unpickling rules as `load_jax_checkpoint` apply.
    """
    grid = load_state(path).get("occ_grid")
    return None if grid is None else np.asarray(grid, dtype=np.float32)


def raydrop_params_from_jax(tree) -> dict:
    """The ray-drop MLP's flax tree ({"params": {"Dense_i": {kernel, bias}}}) -> RayDrop
    state_dict."""
    p = tree.get("params", tree)
    sd = {}
    for name, layer in p.items():
        i = int(name.removeprefix("Dense_"))
        sd[f"layers.{i}.weight"] = torch.from_numpy(np.array(layer["kernel"], np.float32).T.copy())
        sd[f"layers.{i}.bias"] = torch.from_numpy(np.array(layer["bias"], np.float32))
    return sd


def raydrop_params_to_jax(state_dict) -> dict:
    """RayDrop state_dict -> the JAX trainer's `params` tree, numpy leaves."""
    p = {}
    for key, value in state_dict.items():
        i, kind = key.removeprefix("layers.").split(".")
        leaf = value.detach().cpu().numpy()
        p.setdefault(f"Dense_{i}", {})["kernel" if kind == "weight" else "bias"] = (
            leaf.T.copy() if kind == "weight" else leaf.copy())
    return {"params": p}


# flax module names -> the port UNet's (lidarnvs/unet.py)
_UNET_MODULES = {"DoubleConv_0": "inc", "Conv_0": "outc",
                 **{f"Down_{i}": f"down{i + 1}" for i in range(4)},
                 **{f"Up_{i}": f"up{i + 1}" for i in range(4)}}
_UNET_INNER = {"Conv_0": "conv1", "BatchNorm_0": "bn1", "Conv_1": "conv2", "BatchNorm_1": "bn2",
               "DoubleConv_0": "conv", "ConvTranspose_0": "up"}
_UNET_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def _unet_leaf_from_jax(path, leaf):
    """One flax leaf -> (port name, tensor). Conv kernels HWIO -> OIHW; a
    ConvTranspose kernel [kh, kw, in, out] -> ConvTranspose2d's [in, out, kh,
    kw] flipped in space (flax's transposed conv is a dilated conv with the
    kernel unflipped, transpose_kernel=False)."""
    *mods, name = path
    names = [_UNET_MODULES[mods[0]], *(_UNET_INNER[m] for m in mods[1:])]
    leaf = np.array(leaf, np.float32)
    if name == "kernel":
        if mods[-1].startswith("ConvTranspose"):
            leaf = leaf[::-1, ::-1].transpose(2, 3, 0, 1)
        else:
            leaf = leaf.transpose(3, 2, 0, 1)
        name = "weight"
    else:
        name = _UNET_LEAVES[name]
    return ".".join([*names, name]), torch.from_numpy(np.ascontiguousarray(leaf))


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, (*prefix, k))
        else:
            yield (*prefix, k), v


def unet_params_from_jax(params, batch_stats) -> dict:
    """The UNet trainer's flax `params` and `batch_stats` trees -> UNet state_dict."""
    return dict(_unet_leaf_from_jax(path, leaf)
                for tree in (params, batch_stats) for path, leaf in _flat(tree))


def unet_params_to_jax(state_dict) -> tuple:
    """UNet state_dict -> (params, batch_stats) flax trees with numpy leaves."""
    modules = {v: k for k, v in _UNET_MODULES.items()}
    inner = {v: k for k, v in _UNET_INNER.items()}
    leaves = {v: k for k, v in _UNET_LEAVES.items()}
    params, batch_stats = {}, {}
    for key, value in state_dict.items():
        *mods, name = key.split(".")
        if name == "num_batches_tracked":
            continue
        path = [modules[mods[0]], *(inner[m] for m in mods[1:])]
        leaf = value.detach().cpu().numpy()
        if name == "weight" and leaf.ndim == 4:
            leaf = leaf[:, :, ::-1, ::-1].transpose(2, 3, 0, 1) if path[-1].startswith(
                "ConvTranspose") else leaf.transpose(2, 3, 1, 0)
            name = "kernel"
        else:
            name = leaves[name]
        tree = batch_stats if name in ("mean", "var") else params
        for m in path:
            tree = tree.setdefault(m, {})
        tree[name] = np.ascontiguousarray(leaf)
    return params, batch_stats
