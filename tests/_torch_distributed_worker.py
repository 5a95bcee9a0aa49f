"""One process of the port's two-process gloo run
(``tests/test_torch_distributed.py``).  Launched with ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK`` set, as
``torchrun`` sets them.  Each process owns one CPU shard of a 16x16 Cornell
render and of a sharded gradient step on MINI_SCENE; rank 0 holds both
against the single-device results (the accumulator and the ray count
equal, the loss within 1e-5 relative, every leaf within rtol = 2e-3,
atol = 1e-5) and every rank prints ``DIST_OK <rank>``.  Imports nothing of
JAX."""

import dataclasses
import os
import sys

import torch

torch.set_num_threads(1)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pathtracer_tpu_torch.config import RenderConfig  # noqa: E402
from pathtracer_tpu_torch.ops.rng import prng_key  # noqa: E402
from pathtracer_tpu_torch.parallel.mesh import initialize_distributed, make_mesh  # noqa: E402
from pathtracer_tpu_torch.parallel.sharded import gather_image, render_sharded  # noqa: E402
from pathtracer_tpu_torch.render import diff  # noqa: E402
from pathtracer_tpu_torch.render.integrator import render  # noqa: E402
from pathtracer_tpu_torch.scene.parser import load_scene, parse_scene_text  # noqa: E402

MINI_SCENE = os.environ["PT_MINI_SCENE"]


def main():
    assert initialize_distributed("cpu") is True
    try:
        rank = torch.distributed.get_rank()
        mesh = make_mesh([torch.device("cpu")])
        assert (mesh.rank, mesh.world, mesh.size, mesh.shard_ids) == (rank, 2, 2, (rank,))
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        desc = dataclasses.replace(load_scene(os.path.join(root, "scenes", "cornell.txt")),
                                   resolution=(16, 16))
        scene = desc.scene_for_frame(0, device="cpu")
        cfg = RenderConfig(wavefront=True, max_depth=4, iters_per_launch=2)
        img, acc, st = render_sharded(scene, 4, cfg, mesh=mesh)
        flat = gather_image(acc, mesh)  # every rank gathers

        mdesc = dataclasses.replace(parse_scene_text(MINI_SCENE, name="mini"), resolution=(8, 8))
        params, static = diff.params_from_description(mdesc, 0, device="cpu")
        target = torch.full((64, 3), 0.25)
        gcfg = RenderConfig(max_depth=3)
        loss, grads = diff.loss_and_grad_sharded(params, static, diff.scatter_target(target, mesh),
                                                 2, prng_key(1), gcfg, mesh)
        if rank == 0:
            _, acc1, st1 = render(scene, 4, cfg, device="cpu")
            assert torch.equal(flat, acc1), "sharded accumulator differs"
            assert st["rays_traced"] == st1["rays_traced"], (st, st1)
            l1, g1 = diff.loss_and_grad(params, static, target, 2, prng_key(1), gcfg,
                                        device="cpu")
            assert abs(float(loss) - float(l1)) <= 1e-5 * abs(float(l1)), (loss, l1)
            for k, v in g1.leaves().items():
                torch.testing.assert_close(grads.leaves()[k], v, rtol=2e-3, atol=1e-5, msg=k)
        torch.distributed.barrier()
        print(f"DIST_OK {rank} rays={st['rays_traced']} loss={float(loss):.6g}", flush=True)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
