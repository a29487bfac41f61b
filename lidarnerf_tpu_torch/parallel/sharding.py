"""Data parallelism over the ray batch, and the row-sharded hash table, with
torch.distributed (counterpart of lidarnerf_tpu/parallel/sharding.py).

A mesh is the JAX package's: ranks laid out as (data, model), rank =
d * n_model + m. Each rank runs one process on one device (`cuda:LOCAL_RANK`
under NCCL, the CPU under gloo); `torchrun` starts the processes and sets
RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT, which
`init_from_env` reads. Nothing here starts a process.

The step is `nerf/train_step.py`'s one body, given the mesh (the JAX
package's two copies of it, `make_train_step` and `make_sharded_train_step`,
become one): every rank draws the whole global batch from the same seeded
generator (pixels, the render's jitter, the seam samples), keeps its
N / n_data rays, and scales its loss by 1 / n_data; the gradients and the
loss are then summed over `data` in one all-reduce before the non-finite
guard, so the guard and the Adam update act alike on every rank and the
parameters stay bit-identical. A world of W ranks samples exactly what one
device samples.

With `shard_table`, the [L*B, 128] table and its Adam moments are stored
row-sharded over `model`: rank m holds rows [m R / M, (m + 1) R / M). Before
each encode the shards are all-gathered into the whole table (B1 reads any
row); the table gradient keeps the rank's own rows, which the step's
all-reduce sums over `data`. The ranks of one `model` group take the same
rays, so their whole-table gradients agree and no reduction over `model`
is needed. XLA's partition of the JAX step (its compiled HLO on the 8-device
CPU mesh) sums the encoded features of masked shard lookups over `model`
instead, and the table-gradient shards and other gradients over `data`; the
port gathers the rows, because B1 takes the whole table and the rows (64 MiB
at 2^19) weigh less than a step's features (Q x 2L float32, 403 MB at
Q = 3,145,728).
"""

import datetime
import os
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(minutes=10)


def init_from_env(device_type=None):
    """Join the process group that `torchrun` describes in the environment
    (NCCL on CUDA, gloo on the CPU), if it is not joined yet; returns the
    rank's device. `device_type` "cpu" or "cuda"; None takes CUDA when there
    is a GPU."""
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    local = int(os.environ.get("LOCAL_RANK", "0"))
    device = torch.device("cuda", local) if device_type == "cuda" else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        backend = "nccl" if device.type == "cuda" else "gloo"
        kw = {"device_id": device} if device.type == "cuda" else {}
        dist.init_process_group(backend, init_method="env://", timeout=TIMEOUT, **kw)
    return device


def env_world_size():
    """WORLD_SIZE as `torchrun` sets it, 1 without it."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def rank_device():
    """The device of this rank in the joined group: `cuda:LOCAL_RANK` under
    NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", dist.get_rank() %
                                                       max(torch.cuda.device_count(), 1))))
    return torch.device("cpu")


@dataclass
class Mesh:
    """The (data, model) layout of the joined process group and this rank's
    place in it: `data_group` holds the ranks that share this rank's model
    coordinate (its gradients sum there), `model_group` those that share its
    data coordinate (its table rows gather there). A group of one is a group
    too: a world of one still sums its gradients through the backend."""

    n_data: int
    n_model: int
    rank: int
    data_rank: int
    model_rank: int
    device: torch.device
    data_group: object = None
    model_group: object = None
    _device_mesh: object = field(default=None, repr=False)

    def device_mesh(self):
        """The torch DeviceMesh of the layout (DTensor's), made at first use."""
        if self._device_mesh is None:
            from torch.distributed.device_mesh import init_device_mesh

            self._device_mesh = init_device_mesh(self.device.type, (self.n_data, self.n_model),
                                                 mesh_dim_names=("data", "model"))
        return self._device_mesh


def _new_groups(rank_sets):
    """new_group for every set (every rank takes part in each call, in one
    order); returns this rank's group."""
    mine = None
    for ranks in rank_sets:
        g = dist.new_group(ranks)
        if dist.get_rank() in ranks:
            mine = g
    return mine


def make_mesh_2d(n_data, n_model):
    """(data, model) mesh over the joined group (`make_mesh_2d` :37): rays
    shard over `data`, the hash table's rows over `model`."""
    if not dist.is_initialized():
        init_from_env()
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data * n_model != world:
        raise ValueError(f"a ({n_data}, {n_model}) mesh needs {n_data * n_model} ranks; the "
                         f"group has {world}")
    d, m = divmod(rank, n_model)
    data_group = _new_groups([[i * n_model + j for i in range(n_data)] for j in range(n_model)])
    model_group = _new_groups([[i * n_model + j for j in range(n_model)] for i in range(n_data)])
    return Mesh(n_data, n_model, rank, d, m, rank_device(), data_group, model_group)


def make_mesh(n_devices=None):
    """1-D `data` mesh over every rank of the joined group (`make_mesh` :30);
    `n_devices`, if given, must be the world size (a torch world cannot
    shrink)."""
    if not dist.is_initialized():
        init_from_env()
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh({n_devices}): the process group has {world} ranks")
    return make_mesh_2d(world, 1)


def local_rays(mesh, n):
    """The slice of a global batch of n rays this rank keeps."""
    if mesh is None or mesh.n_data == 1:
        return slice(0, n)
    if n % mesh.n_data:
        raise ValueError(f"num_rays_lidar={n} must divide evenly over {mesh.n_data} data ranks")
    k = n // mesh.n_data
    return slice(mesh.data_rank * k, (mesh.data_rank + 1) * k)


def all_reduce_sum(t, group):
    """Sum `t` in place over `group`."""
    dist.all_reduce(t, group=group)
    return t


def _all_gather_rows(shard, group, n):
    """[n * k, C] rows of the n shards [k, C] of `group`, in rank order."""
    if shard.device.type == "cuda":
        out = shard.new_empty((n * shard.shape[0], *shard.shape[1:]))
        dist.all_gather_into_tensor(out, shard.contiguous(), group=group)
        return out
    parts = [torch.empty_like(shard) for _ in range(n)]
    dist.all_gather(parts, shard.contiguous(), group=group)
    return torch.cat(parts)


class GatherRowShards(torch.autograd.Function):
    """This rank's row shard of a table -> the whole table (all-gather over
    `model`); the backward keeps the shard's rows of the whole-table gradient."""

    @staticmethod
    def forward(ctx, shard, mesh):
        ctx.rows = (mesh.model_rank * shard.shape[0], (mesh.model_rank + 1) * shard.shape[0])
        return _all_gather_rows(shard, mesh.model_group, mesh.n_model)

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.rows
        return g[lo:hi], None


def row_shard(table, mesh):
    """This rank's rows of a whole [R, C] table (R a multiple of n_model)."""
    R = table.shape[0]
    if R % mesh.n_model:
        raise ValueError(f"{R} table rows do not split over {mesh.n_model} model ranks")
    k = R // mesh.n_model
    return table[mesh.model_rank * k:(mesh.model_rank + 1) * k]


def shard_params(model, mesh):
    """Store the model's hash table row-sharded over `model` (`shard_params`
    :68), in place: `model.hash_table` becomes this rank's [R / M, 128] rows,
    and each encode gathers the whole table. Build the optimizer after this
    call, so that its moments are the shard's. Returns the model."""
    if getattr(model, "table_mesh", None) is not None:
        return model
    if getattr(model, "encoding", None) != "blockhash":
        raise ValueError("shard_table needs the blockhash encoding")
    if mesh.n_model > 1:
        shard = row_shard(model.hash_table.detach(), mesh).clone()
        model.hash_table = torch.nn.Parameter(shard)
    model.table_mesh = mesh
    return model


def gather_table(table, mesh):
    """The whole table of a model stored with `shard_params` (differentiable)."""
    if mesh is None or mesh.n_model == 1:
        return table
    return GatherRowShards.apply(table, mesh)


def full_state_dict(model):
    """The model's state_dict with a row-sharded table gathered whole (a
    collective over `model`)."""
    sd = model.state_dict()
    mesh = getattr(model, "table_mesh", None)
    if mesh is not None and mesh.n_model > 1:
        sd["hash_table"] = _all_gather_rows(sd["hash_table"], mesh.model_group, mesh.n_model)
    return sd


def broadcast_state(tensors, src=0):
    """Copy rank `src`'s tensors to every rank, in place (the replicated start)."""
    for t in tensors:
        dist.broadcast(t.data, src=src)


def replicate(tensors, mesh):
    """The tensors (one, or a sequence) made equal on every rank of the mesh
    (`replicate` :73): rank 0's values, broadcast in place; returns them.
    torch has no global array: where JAX places one array on every device,
    each rank here holds its own copy. In a world of one (or with no mesh)
    the input is returned as it is."""
    if mesh is not None and dist.is_initialized() and dist.get_world_size() > 1:
        broadcast_state([tensors] if isinstance(tensors, torch.Tensor) else tensors)
    return tensors


def shard_rays(array, mesh):
    """This rank's block of the leading (ray) axis over `data` (`shard_rays`
    :79): the rows `local_rays` keeps. torch has no global array: where JAX
    places one array across the devices, each rank holds its own block. An
    axis that does not divide over the data ranks raises the trainer's
    ValueError."""
    if mesh is None or mesh.n_data == 1:
        return array
    return array[local_rays(mesh, array.shape[0])]


def make_sharded_train_step(model, cfg, render_cfg, mesh, patch_size=1, masked_sampling=False,
                            sample_without_replacement=False, shard_table=False, optimizer=None):
    """The data-parallel train step (`make_sharded_train_step` :89): the one
    step body of `nerf/train_step.make_train_step`, given the mesh. With
    `shard_table`, the model's table is row-sharded first (`shard_params`)."""
    from lidarnerf_tpu_torch.nerf.train_step import make_train_step

    local_rays(mesh, cfg.num_rays_lidar)  # raises unless the rays split over `data`
    if shard_table:
        shard_params(model, mesh)
    return make_train_step(model, cfg, render_cfg, patch_size, masked_sampling,
                           sample_without_replacement, optimizer, mesh.device, mesh=mesh)


def make_sharded_epoch_step(model, cfg, render_cfg, mesh, patch_size=1, masked_sampling=False,
                            sample_without_replacement=False, shard_table=False, optimizer=None,
                            capture=True, graph_pool=None):
    """The data-parallel fused epoch (`make_sharded_epoch_step` :221): the
    one epoch of `nerf/train_step.make_epoch_step`, given the mesh (on CUDA
    a CUDA graph of the step, its all-reduce inside)."""
    from lidarnerf_tpu_torch.nerf.train_step import make_epoch_step

    local_rays(mesh, cfg.num_rays_lidar)
    if shard_table:
        shard_params(model, mesh)
    return make_epoch_step(model, cfg, render_cfg, patch_size, masked_sampling,
                           sample_without_replacement, optimizer, mesh.device, capture,
                           graph_pool, mesh=mesh)
