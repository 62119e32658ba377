"""One rank of a gloo world on the CPU for `tests/test_torch_parallel.py`.

    python tests/torch_parallel_worker.py RANK WORLD PORT OUT_DIR

Every rank builds the same seeded problems, runs the jobs of its world
size through `mvsmplfitting_tpu_torch.parallel` and saves what it got to
``OUT_DIR/rank<RANK>.pt``; the test compares the ranks with each other,
with the port's one-card fits and with JAX.  No JAX here.
"""

import os
import sys

import numpy as np
import torch

B = 4                  # distinct frames of the fit problem
SEQ = 4                # frames of the one-person sequence
ONE_STAGE = dict(pose_weights=(57.4,), shape_weights=(10.0,),
                 coll_weights=(0.0,))
TWO_STAGES = dict(pose_weights=(404.0, 57.4), shape_weights=(50.0, 10.0),
                  coll_weights=(0.0, 0.0))


def block_x(seed: int = 0) -> np.ndarray:
    """A seeded packed vector (B, 49) for the normal-equation check."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.1, (B, 49)).astype(np.float32)
    x[:, 48] = 1.0 + 0.1 * rng.uniform(-1, 1, B)
    return x


def _errors(P, problem):
    """The messages of the layout errors a 2-rank world must raise."""
    from mvsmplfitting_tpu_torch.fitting.stages import FitConfig
    assets, vw, cam, obs = problem
    out = {}
    for name, fn in (
            ("layout", lambda: P.make_mesh(P.MeshLayout(frames=2,
                                                        cameras=2))),
            ("cameras_axis", lambda: P.global_mesh(cameras_axis=3)),
            ("views", lambda: P.camera_sharded_fit(
                FitConfig(), assets, _views(cam, 5), _obs_views(obs, 5),
                P.make_mesh(P.MeshLayout(1, 2)), vposer_w=vw,
                device="cpu")),
            ("frames", lambda: P.camera_sharded_fit(
                FitConfig(), assets, cam, _obs_frames(obs, 3),
                P.make_mesh(P.MeshLayout(2, 1)), vposer_w=vw,
                device="cpu"))):
        try:
            fn()
        except ValueError as e:
            out[name] = str(e)
    return out


def _views(cam, v):
    from mvsmplfitting_tpu_torch.models.camera import Camera
    return Camera(cam.rotation[:v], cam.translation[:v], cam.focal[:v],
                  cam.center[:v])


def _obs_views(obs, v):
    from mvsmplfitting_tpu_torch.fitting.energy import Observations
    return Observations(obs.gt2d[:, :v], obs.conf[:, :v],
                        obs.view_mask[:, :v], obs.joint_weights)


def _obs_frames(obs, b):
    from mvsmplfitting_tpu_torch.fitting.energy import Observations
    return Observations(obs.gt2d[:b], obs.conf[:b], obs.view_mask[:b],
                        obs.joint_weights[:b])


def main(rank: int, world: int, port: int, out_dir: str) -> None:
    torch.set_num_threads(1)
    from mvsmplfitting_tpu_torch import parallel as P
    from mvsmplfitting_tpu_torch import synthetic
    from mvsmplfitting_tpu_torch.fitting import energy as E
    from mvsmplfitting_tpu_torch.fitting.initialize import init_guess
    from mvsmplfitting_tpu_torch.fitting.lm import LMOptions
    from mvsmplfitting_tpu_torch.fitting.stages import FitConfig
    from mvsmplfitting_tpu_torch.parallel import camera_shard as CS

    P.init_distributed(f"localhost:{port}", world, rank, device="cpu")
    assets, vw, cam, obs = problem = synthetic.make_problem(
        6, B, seed=0, device="cpu")
    classic = dict(linsolve="chol", speculative=False)
    got = {"slice": P.process_local_batch_slice(10)}

    def fit(layout, cfg, **kw):
        x, loss = P.camera_sharded_fit(cfg, assets, cam, obs,
                                       P.make_mesh(P.MeshLayout(*layout)),
                                       vposer_w=vw, device="cpu", **kw)
        return torch.cat([x, loss[:, None]], dim=1)

    if world == 2:
        mesh = P.make_mesh(P.MeshLayout(1, 2))
        views = P.mesh.axis_block(mesh, P.mesh.CAMERAS_AXIS, 6)
        cam_l, obs_l = CS._view_block(cam, views), CS._obs_block(
            obs, slice(None), views)
        got["triangulate"] = P.sharded_triangulate(
            cam_l, obs_l.gt2d, obs_l.conf, obs_l.view_mask,
            mesh.get_group("cameras"))
        weights = E.StageWeights.make(data=torch.full((B,), 500 / 1080.0),
                                      pose=57.4, shape=10.0)
        # The normal equations as one LM iteration assembles them.
        _, r_and_J = CS._shard_rows(FitConfig(), assets, vw, None, cam_l,
                                    obs_l, weights)
        got["blocks"] = CS._assemble(
            r_and_J, E.free_mask(E.EnergySpec()), torch.from_numpy(
                block_x()), mesh.get_group("cameras"), torch.ones(B))[:2]
        got["fit_1x2"] = fit((1, 2), FitConfig(
            lm=LMOptions(max_iters=5, **classic), **ONE_STAGE))

        cfg = FitConfig(lm=LMOptions(max_iters=5), **ONE_STAGE)
        res = P.batched_fit_frames(
            cfg, assets, cam, P.BatchedFitInputs(obs, torch.full(
                (B,), 1080.0)), vposer_w=vw,
            mesh=P.make_mesh(P.MeshLayout(2, 1)), device="cpu")
        got["batched"] = (res.loss, res.lm_iters, res.params.transl)

        sa, sw, sc, so, _ = synthetic.make_person_sequence(SEQ, seed=0,
                                                           device="cpu")
        g = init_guess(sa, sc, so.gt2d, so.conf, so.view_mask)
        out = P.schur_sequence_fit(
            FitConfig(lm=LMOptions(max_iters=6), **ONE_STAGE), sa, sc, so,
            g.params, g.z, vposer_w=sw,
            mesh=P.make_mesh(P.MeshLayout(2, 1)), device="cpu")
        got["schur"] = (out[2], out[3], out[4])
        got["errors"] = _errors(P, problem)
    else:
        mesh = P.make_mesh(P.MeshLayout(2, 2))
        frames = P.frames_slice(mesh, B)
        views = P.mesh.axis_block(mesh, P.mesh.CAMERAS_AXIS, 6)
        cam_l, obs_l = CS._view_block(cam, views), CS._obs_block(
            obs, frames, views)
        got["frames"] = (frames.start, frames.stop)
        got["triangulate"] = P.sharded_triangulate(
            cam_l, obs_l.gt2d, obs_l.conf, obs_l.view_mask,
            mesh.get_group("cameras"))
        got["fit_2x2"] = fit((2, 2), FitConfig(
            lm=LMOptions(max_iters=5, **classic), **ONE_STAGE))
        for jac in ("ad", "analytic"):
            got[f"jac_{jac}"] = fit((2, 2), FitConfig(
                lm=LMOptions(max_iters=8, jac=jac), **ONE_STAGE))
        cfg = FitConfig(lm=LMOptions(max_iters=5), **TWO_STAGES)
        got["unrolled"] = fit((2, 2), cfg)
        got["scan"] = fit((2, 2), cfg, max_iters_cap=5, scan_stages=True)
        got["capped"] = fit((2, 2), cfg, max_iters_cap=1, scan_stages=True)
    torch.save(got, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
