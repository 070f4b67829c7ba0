"""Rank functions for the port's multi-rank tests.

Spawned ranks (vvc_torch.shard.launch.run_ranks) import this module to
unpickle the function they run, so it imports torch and vvc_torch only —
never JAX or the JAX package `vvc` — and the test modules that import
both stay out of the ranks."""
import sys
import time

import torch
import torch.distributed as dist


def halo_and_deblock(stripes, cases, device):
    """On a 'tile' mesh of every rank: exchange_tile_halos of ``stripes``
    (halo 8 and 4), and deblock_tile_edges for each (qp, bit_depth, planes)
    of ``cases``.  Returns numpy arrays."""
    from vvc_torch.shard.filter import deblock_tile_edges
    from vvc_torch.shard.halo import exchange_tile_halos
    from vvc_torch.shard.mesh import make_mesh
    mesh = make_mesh(dist.get_world_size(), 1)
    t = torch.from_numpy(stripes).to(device)
    out = {"halo": [tuple(x.cpu().numpy() for x in
                          exchange_tile_halos(mesh, t, halo))
                    for halo in (8, 4)]}
    out["deblock"] = [
        deblock_tile_edges(mesh, torch.from_numpy(p).to(device), qp,
                           bd).cpu().numpy()
        for qp, bd, p in cases]
    return out


def rdo_step(orig, refs, size, qp, device):
    """sharded_rdo_step on a 'tile' mesh of every rank."""
    from vvc_torch.shard.mesh import make_mesh, sharded_rdo_step
    mesh = make_mesh(dist.get_world_size(), 1)
    c, m, tot = sharded_rdo_step(mesh, torch.from_numpy(orig).to(device),
                                 torch.from_numpy(refs).to(device), size, qp)
    return c.cpu().numpy(), m.cpu().numpy(), float(tot)


def encode_and_modules(frames, device, **kw):
    """encode_sequence_sharded, and the JAX or vvc modules loaded in this
    rank afterwards (none may be)."""
    from vvc_torch.shard.encode import encode_sequence_sharded
    out = encode_sequence_sharded(frames, device=device, **kw)
    mods = sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "vvc"))
    return out, mods


def fail_on_rank_1(device):
    """Rank 1 raises; the others wait in a collective it never joins."""
    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()


def sleep_forever(device):
    while True:
        time.sleep(1)


def rank_of(device):
    return dist.get_rank(), dist.get_world_size(), str(device), \
        dist.get_backend(), torch.get_num_threads()
