"""Device meshes over torch.distributed ranks, the collectives the
sharded encoder uses, and the sharded encoder search step.

Port of vvc/shard/mesh.py.  vvc runs one controller over a
`jax.sharding.Mesh`; the port runs one process per rank
(`vvc_torch.shard.launch`), every rank calling the same function on the
same inputs and working on its own chunk, over a
`torch.distributed.device_mesh.DeviceMesh` whose dims are named as vvc's:

  * 'tile'  — spatial shard: block batches split across ranks;
  * 'frame' — temporal shard: pictures of a GOP or segment.

The backend follows the device (`backend_for`): NCCL when every rank has a
card of its own, gloo when the ranks are on the CPU or share cards.  Gloo
moves host tensors only for all_gather and send/recv, so on a gloo group a
CUDA rank copies what it sends through host memory: that rule lives here
(`_to_wire`, `_from_wire`) and nowhere else.  An NCCL failure is never
retried on gloo.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from vvc_torch import ops


def backend_for(world_size: int, device) -> str:
    """NCCL when each of ``world_size`` ranks can have a card of its own,
    else gloo (CPU ranks, or more ranks than cards)."""
    dev = ops.resolve_device(device)
    if dev.type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_mesh(shape, names) -> DeviceMesh:
    """A mesh over ranks 0 .. prod(shape) - 1 in row-major order.  Every
    rank of the process group calls it; ranks outside the mesh get a mesh
    whose coordinate is None."""
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size()
    if n > world:
        raise ValueError(f"mesh {dict(zip(names, shape))} needs {n} ranks, "
                         f"the process group has {world}")
    dev_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(dev_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def make_mesh(n_tiles: int, n_frames: int = 1) -> DeviceMesh:
    """The ("tile", "frame") mesh of vvc's make_mesh, over the first
    n_tiles · n_frames ranks."""
    return rank_mesh((n_tiles, n_frames), ("tile", "frame"))


def in_mesh(mesh: DeviceMesh) -> bool:
    return mesh.get_coordinate() is not None


def mesh_index(mesh: DeviceMesh, dims) -> tuple[int, int]:
    """(this rank's index, count) over the mesh dims ``dims`` flattened in
    row-major order — the shard a `P(dims)` spec gives this rank."""
    idx, count = 0, 1
    for d in dims:
        idx = idx * mesh.size(mesh.mesh_dim_names.index(d)) \
            + mesh.get_local_rank(d)
        count *= mesh.size(mesh.mesh_dim_names.index(d))
    return idx, count


def flat_group(mesh: DeviceMesh, dims):
    """The process group over mesh dims ``dims`` that holds this rank."""
    if len(dims) == 1:
        return mesh.get_group(dims[0])
    if len(dims) != mesh.ndim:
        raise ValueError("flat_group: flatten one dim or all of them")
    if mesh.mesh.numel() == dist.get_world_size():
        return dist.group.WORLD
    # a mesh over the first ranks only: its members make the group alone
    return dist.new_group(mesh.mesh.flatten().tolist(),
                          use_local_synchronization=True)


def _host_wire(group) -> bool:
    return dist.get_backend(group) == "gloo"


def _to_wire(t: torch.Tensor, group) -> torch.Tensor:
    """The tensor a collective of ``group`` can move: on gloo a host copy."""
    t = t.contiguous()
    return t.cpu() if (t.is_cuda and _host_wire(group)) else t


def _from_wire(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return t.to(like.device, non_blocking=False)


def all_gather_cat(t: torch.Tensor, group) -> torch.Tensor:
    """Concatenate every rank's ``t`` (equal shapes) along dim 0, in the
    group's rank order."""
    w = _to_wire(t, group)
    parts = [torch.empty_like(w) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, w, group=group)
    return _from_wire(torch.cat(parts), t)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    w = _to_wire(t, group).clone()
    dist.all_reduce(w, op=dist.ReduceOp.SUM, group=group)
    return _from_wire(w, t)


def send_recv(sends, group):
    """Point-to-point exchange in one batch: ``sends`` is a list of
    (tensor, peer, recv_buffer) — this rank sends ``tensor`` to group rank
    ``peer`` and receives a tensor of recv_buffer's shape from it.
    Returns the received tensors on recv_buffer's device."""
    ops_ = []
    bufs = []
    for t, peer, like in sends:
        w = _to_wire(t, group)
        r = torch.empty_like(_to_wire(like, group))
        gpeer = dist.get_global_rank(group, peer)
        ops_.append(dist.P2POp(dist.isend, w, gpeer, group))
        ops_.append(dist.P2POp(dist.irecv, r, gpeer, group))
        bufs.append((r, like))
    if ops_:
        for work in dist.batch_isend_irecv(ops_):
            work.wait()
    return [_from_wire(r, like) for r, like in bufs]


def pad_rows(t: torch.Tensor, mult: int) -> torch.Tensor:
    """Pad dim 0 with zeros to a multiple of ``mult``."""
    pad = (-t.shape[0]) % mult
    if not pad:
        return t
    return torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])


def shard_blocks(mesh: DeviceMesh, arr: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous chunk of a [N, ...] block batch split over
    the 'tile' axis (N padded with zero blocks to a multiple of it)."""
    idx, n = mesh_index(mesh, ("tile",))
    arr = pad_rows(arr, n)
    k = arr.shape[0] // n
    return arr[idx * k:(idx + 1) * k]


def sharded_rdo_step(mesh: DeviceMesh, orig: torch.Tensor,
                     refs: torch.Tensor, size: int, qp: int,
                     bit_depth: int = 8):
    """One sharded encoder search step: per-block best cost and mode plus
    the total cost.  Every rank passes the whole batch (orig [N, S, S],
    refs [N, 4S+3] int32); each runs eval_blocks on its chunk of the
    'tile' axis (with the sum orders of vvc's jitted step: `sharded`), the costs and modes are all_gathered, and the total is an
    all_reduce of the ranks' float32 partial sums (its order differs from
    a single sum: compare it with rtol, as vvc's own test does).  Returns
    (costs [N] f32, modes [N] i32, total f32 scalar) on every rank."""
    from vvc_torch.enc.rdo import eval_blocks

    n = orig.shape[0]
    group = mesh.get_group("tile")
    idx, count = mesh_index(mesh, ("tile",))
    k = -(-n // count)
    cost, mode, _mts, _lfnst = eval_blocks(shard_blocks(mesh, orig),
                                           shard_blocks(mesh, refs), size,
                                           qp, bit_depth, sharded=True)
    real = max(0, min(k, n - idx * k))          # pad blocks add nothing
    total = all_reduce_sum(cost[:real].sum(dtype=torch.float32), group)
    return (all_gather_cat(cost, group)[:n], all_gather_cat(mode, group)[:n],
            total)
