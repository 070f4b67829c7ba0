"""Sweep: the port's chroma decision against vvc's whole search program on
10-bit content whose chroma sums pass 2^24, where the decision rests on
the float32 order of each sum (vvc_torch.enc.rdo.eval_chroma_modes).

    JAX_PLATFORMS=cpu python -m tests.sweep_torch_chroma_orders W H F SEEDS \
        {binary,tied}

F = 1 runs vvc's eval_all_sizes on a W×H frame; F > 1 runs its vmapped
eval_all_sizes_frames on F tiles of W×H (the tile-column path).  Prints the
chroma-mode decisions that differ, per block size, and their total.  Not
collected by pytest: it compiles one 10-bit program per geometry (about
0.4 GiB and 20 s on a CPU)."""
import sys

import jax.numpy as jnp
import numpy as np
import torch

from vvc.enc import rdo as ref
from vvc_torch.enc import rdo as port

BIT_DEPTH = 10
SHAPES = ref._candidate_shapes(64, 8, False)


def planes(w, h, rng, content):
    mx = (1 << BIT_DEPTH) - 1
    y = rng.integers(0, mx + 1, (h, w)).astype(np.int32)

    def chroma():
        if content == "binary":
            return (rng.integers(0, 2, (h // 2, w // 2)) * mx).astype(np.int32)
        # 0 on rows and columns 3 mod 4, the top quarter of the range
        # elsewhere: all four predictions 0, their integer SSEs equal
        p = rng.integers(mx - 255, mx + 1, (h // 2, w // 2)).astype(np.int32)
        p[3::4, :] = 0
        p[:, 3::4] = 0
        return p
    return y, chroma(), chroma()


def main(w, h, f, seeds, content):
    torch.set_num_threads(2)
    differ, blocks, by_size = 0, 0, {}
    for seed in range(seeds):
        rng = np.random.default_rng(seed)
        tiles = [planes(w, h, rng, content) for _ in range(f)]
        if f == 1:
            vec = ref.pack_planes(*tiles[0])
            want = [np.asarray(ref.eval_all_sizes(
                jnp.asarray(vec), SHAPES, jnp.int32(32), BIT_DEPTH, w, h,
                False, True, True, False))]
            got = [port.eval_all_sizes(
                torch.from_numpy(vec), SHAPES, 32, BIT_DEPTH, w, h, False,
                True, True, False).numpy()]
        else:
            vec = ref.pack_planes(*(np.stack(p) for p in zip(*tiles)))
            want = list(np.asarray(ref.eval_all_sizes_frames(
                jnp.asarray(vec), SHAPES, jnp.int32(32), BIT_DEPTH, w, h, f,
                False, True, True, False)))
            got = list(port.eval_all_sizes_frames(
                torch.from_numpy(vec), SHAPES, 32, BIT_DEPTH, w, h, f, False,
                True, True, False).numpy())
        for g, wv in zip(got, want):
            rg = port.unpack_results(g, SHAPES, w, h)
            rw = port.unpack_results(wv[:len(g)], SHAPES, w, h)
            for k in rg:
                n = int((rg[k][4] != rw[k][4]).sum())
                by_size[k] = by_size.get(k, 0) + n
                differ += n
                blocks += rg[k][4].size
    print(f"{w}x{h} F={f} {content} seeds 0..{seeds - 1}: {differ} of "
          f"{blocks} chroma decisions differ; by size {by_size}")
    return differ


if __name__ == "__main__":
    a = sys.argv[1:]
    main(int(a[0]), int(a[1]), int(a[2]), int(a[3]), a[4])
