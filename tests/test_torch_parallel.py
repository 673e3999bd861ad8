"""The port's multi-device paths (nefes_tpu_torch/parallel/) on the CPU:
one spawn of 2 gloo ranks (tests/torch_dist_worker.py; a 60 s collective
timeout and one join deadline for both ranks, JOIN_S, so that a hang
fails within it) runs the
sharded train step under two layouts, mode 3, mode 2 and the render, and
the parent holds what they return:

* the 2-rank train step, 2 steps in f32 through the raw-input kernels'
  plain versions (K5 / K6 +dW), images over "data" (2 x 1) and rays over
  "rays" (1 x 2, with the TV and sparsity terms), against the one-rank
  train_step_rays on the whole batch: loss rtol 2e-5, every parameter
  atol 1e-5 (the JAX package's gate, tests/test_sharding.py), the last
  step's averaged gradient to 1e-4 of its largest entry (Adam and the
  clip would hide a sum in place of the mean); rank 1's state equals
  rank 0's exactly;
* refine_poses_sharded, refine_apr_sharded and render_rays_sharded
  against the JAX package's on a 2-device mesh, from the JAX weights
  carried across, at the tolerances of the port's mode-3, mode-2 and
  render parity tests (tests/test_torch_refine.py, test_torch_mode2.py).

Also the mesh's layout and its refusal of a frame count that does not
divide the ranks, in this process (a one-rank gloo group; without a
group and a card make_mesh refuses, as it does not fall back to the
CPU).
"""

import multiprocessing
import socket
import time
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nefes_tpu.features.dfnet import DFNet as JDFNet
from nefes_tpu.geometry.transforms import WorldSetup as JWorld
from nefes_tpu.refine.apr_opt import refine_apr_single as jrefine_apr_single
from nefes_tpu.parallel import make_mesh as jmake_mesh
from nefes_tpu.parallel.train_dp import (
    refine_apr_sharded as jrefine_apr_sharded,
    refine_poses_sharded as jrefine_poses_sharded,
    render_rays_sharded as jrender_rays_sharded,
)
from nefes_tpu.refine.pose_opt import RefineConfig as JRefine
from nefes_tpu_torch.data.synthetic import look_at_pose, make_synthetic_scene
from nefes_tpu_torch.features import DFNet, extract_target_features
from nefes_tpu_torch.geometry import learn_pose
from nefes_tpu_torch.geometry.rays import get_rays
from nefes_tpu_torch.geometry.transforms import WorldSetup
from nefes_tpu_torch.parallel import (
    Mesh, batch_ray_sharding, init_distributed, make_mesh,
    refine_poses_sharded, shard_batch,
)
from nefes_tpu_torch.refine import RefineConfig
from nefes_tpu_torch.train.trainer import (
    AuxConfig, create_train_state, make_optimizer, train_step_rays,
)
from nefes_tpu_torch.weights import dfnet_from_jax_variables
from tests.torch_parity import close, configs, models, n, t

NEAR, FAR = 0.5, 4.0
WS = (1.0, 1.0, 0.0, 0.0, 0.0)
TRAIN_PATH = dict(fused=True, fused_pre=False, fused_need_dw=True)
TEST_PATH = dict(fused=True, fused_pre=False, fused_need_dw=False,
                 fused_render=True)
LAYOUTS = {
    "data2": dict(data=2, rays=1, aux=AuxConfig()),
    "rays2": dict(data=1, rays=2, aux=AuxConfig(tvloss=True,
                                                sigma_sparsity=True,
                                                bound=FAR)),
}
IMG_HW = (32, 48)          # >= 32 px (DFNet's pose head), > the 10-px crop
JOIN_S = 90                # both ranks together; about 17 s on an idle CPU


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world():
    """Both packages' models with the same weights, and every input."""
    jcfg, tcfg = configs()
    jmodel, variables, tmodel = models(jcfg, tcfg)
    rng = np.random.default_rng(0)
    scene = make_synthetic_scene(n_views=4, H=16, W=16, device="cpu")
    train = dict(
        batch={"rgb": t(scene.images), "poses": t(scene.poses),
               "hists": t(scene.hists)},
        hwf=(16, 16, float(scene.focal)), near=scene.near, far=scene.far,
        n_rand=32, stage=0, steps=2, lr=1e-3, grad_clip=1.0, seed=5,
        rcfg=tcfg.render_config(n_samples=8, n_importance=8, **TRAIN_PATH))
    tkw = dict(n_samples=16, n_importance=16, output_transient=False,
               test_time=True, perturb=False, remat=False)
    jrc, trc = jcfg.render_config(**tkw), replace(
        tcfg.render_config(**tkw), **TEST_PATH)

    gt = look_at_pose(np.array([0.0, 0.3, 2.4], np.float32))
    moves = (([0.02, -0.03, 0.01], [0.05, -0.04, 0.03]),
             ([-0.01, 0.02, 0.0], [0.0, 0.03, -0.02]))
    poses = np.stack([learn_pose(t(dr), t(dt), t(gt))[:3, :4].numpy()
                      for dr, dt in moves])
    mode3 = dict(poses=t(poses),
                 feats=t(rng.normal(size=(2, 8, 8, 8)) * 0.5),
                 hists=torch.zeros(2, 10), ws=WorldSetup(NEAR, FAR, *WS[:2],
                                                         WS[2:]),
                 hwf=(8, 8, 6.0), cfg=trc,
                 rcfg=RefineConfig(opt_iter=3, lr_r=0.0087, lr_t=0.01))

    # DFNet with random BN statistics, fc_pose aimed at the scene
    images = rng.uniform(0, 1, (2,) + IMG_HW + (3,)).astype(np.float32)
    jd = JDFNet(output_dim=8)
    v = jax.tree.map(np.asarray, jd.init(jax.random.key(0), images[:1]))
    v = {"params": v["params"], "batch_stats": v["batch_stats"]}
    for blk in v["batch_stats"].values():
        blk["bn"]["mean"] = rng.normal(0, 0.1, blk["bn"]["mean"].shape)
        blk["bn"]["var"] = rng.uniform(0.5, 1.5, blk["bn"]["var"].shape)
    v["params"]["fc_pose"]["kernel"] = v["params"]["fc_pose"]["kernel"] * 0.05
    v["params"]["fc_pose"]["bias"] = poses[0].reshape(12)
    v = jax.tree.map(lambda x: np.asarray(x, np.float32), v)
    dfnet = DFNet(output_dim=8, device="cpu")
    dfnet.load_state_dict(dfnet_from_jax_variables(v))
    with torch.no_grad():
        targets = extract_target_features(dfnet, t(images), *IMG_HW)
    mode2 = dict(dfnet=dfnet.state_dict(), images=t(images),
                 targets=targets, hists=torch.zeros(2, 10), ws_vec=t(WS),
                 hwf_render=(6, 8, 6.0), hwf_full=IMG_HW + (24.0,),
                 near=NEAR, far=FAR, cfg=trc,
                 rcfg=RefineConfig(opt_iter=3, learning_rate=1e-5))

    ro, rd = get_rays(8, 8, 6.0, t(gt))
    render = dict(rays_o=ro.reshape(-1, 3), rays_d=rd.reshape(-1, 3),
                  near=NEAR, far=FAR, cfg=trc)
    job = dict(world=2, cfg=tcfg, state=tmodel.state_dict(), train=train,
               layouts=LAYOUTS, mode3=mode3, mode2=mode2, render=render)
    return dict(job=job, jmodel=jmodel, variables=variables, jrc=jrc,
                jdfnet=(jd, jax.tree.map(jnp.asarray, v)), tcfg=tcfg)


@pytest.fixture(scope="module")
def ranks(world, tmp_path_factory):
    """What each of the 2 gloo ranks returned."""
    out = str(tmp_path_factory.mktemp("ranks") / "rank")
    job = dict(world["job"], out=out,
               address=f"tcp://localhost:{_free_port()}")
    from tests.torch_dist_worker import run
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=run, args=(r, job)) for r in range(2)]
    deadline = time.monotonic() + JOIN_S
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
    assert not hung, "a rank did not finish"
    assert [p.exitcode for p in procs] == [0, 0]
    return [torch.load(f"{out}.{r}") for r in range(2)]


# --- the train step: 2 ranks against one ---

@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_train_step_matches_one_rank(world, ranks, layout):
    job = world["job"]
    tr = job["train"]
    from tests.torch_dist_worker import model_of
    state = create_train_state(model_of(job))
    state.tx = make_optimizer(state.model.parameters(),
                              grad_clip=tr["grad_clip"])
    gen = torch.Generator().manual_seed(tr["seed"])
    losses, psnrs = [], []
    for _ in range(tr["steps"]):
        state, loss, metrics = train_step_rays(
            state, tr["rcfg"], tr["batch"], gen, tr["lr"], tr["hwf"],
            tr["near"], tr["far"], n_rand=tr["n_rand"], stage=tr["stage"],
            aux=LAYOUTS[layout]["aux"])
        losses.append(float(loss))
        psnrs.append(float(metrics["psnr"]))
    got = ranks[0]["train"][layout]
    np.testing.assert_allclose(n(got["losses"]), losses, rtol=2e-5)
    np.testing.assert_allclose(n(got["psnr"]), psnrs, rtol=2e-5)
    moved = 0.0
    for name, p in state.model.named_parameters():
        close(got["params"][name], p, 0, 1e-5, name)
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        scale = max(float(g.abs().max()), 1e-12)
        close(got["grads"][name] / scale, g / scale, 0, 1e-4, name)
        moved = max(moved, float((p.detach() - job["state"][name]).abs()
                                 .max()))
    assert moved > 1e-4, moved                   # the steps moved weights
    other = ranks[1]["train"][layout]
    assert torch.equal(other["losses"], got["losses"])
    for name, p in got["params"].items():
        assert torch.equal(other["params"][name], p), name


# --- refinement and render: 2 ranks against JAX's 2-device mesh ---

@pytest.fixture(scope="module")
def jmesh():
    assert jax.device_count() >= 2, "conftest provides the virtual devices"
    return jmake_mesh(devices=jax.devices()[:2])


def test_mode3_matches_jax_sharded(world, ranks, jmesh):
    m3 = world["job"]["mode3"]
    ws = JWorld(NEAR, FAR, *WS[:2], WS[2:])
    refined, losses = jrefine_poses_sharded(
        world["jmodel"], world["variables"], jnp.asarray(n(m3["poses"])),
        jnp.asarray(n(m3["feats"])), jnp.asarray(n(m3["hists"])), ws,
        m3["hwf"], world["jrc"], JRefine(opt_iter=3, lr_r=0.0087,
                                         lr_t=0.01), jmesh)
    got_pose, got_losses = ranks[0]["mode3"]
    assert got_pose.shape == (2, 3, 4) and got_losses.shape == (2, 3)
    close(got_losses, losses, 2e-4, 2e-4, "losses")
    close(got_pose, refined, 2e-4, 2e-4, "refined poses")
    assert torch.equal(ranks[1]["mode3"][0], got_pose)


def test_mode2_matches_jax(world, ranks, jmesh):
    """Against JAX's refine_apr_single on each frame at the mode-2 test's
    tolerances, and against JAX's refine_apr_sharded at its own test's
    (tests/test_sharding.py: the forward quantities, and the final loss
    to 5e-2: JAX's mesh layout batches the frames, and its trajectory
    leaves its own single-frame run's beyond the tolerances above after
    one step on the second frame here)."""
    m2 = world["job"]["mode2"]
    jd, jv = world["jdfnet"]
    args = (world["jmodel"], world["variables"], jd, jv)
    tail = (jnp.asarray(WS, jnp.float32), m2["hwf_render"], m2["hwf_full"],
            NEAR, FAR, world["jrc"], JRefine(opt_iter=3, learning_rate=1e-5))
    images, targets = n(m2["images"]), n(m2["targets"])
    got = ranks[0]["mode2"]
    for i in range(2):
        want = jax.tree.map(np.asarray, jrefine_apr_single(
            *args, jnp.asarray(images[i]), jnp.asarray(targets[i]),
            jnp.zeros(10), *tail))
        close(got["losses"][i], want["losses"], 1e-5, 1e-6, "losses")
        for k in ("init_psnr", "end_psnr", "init_ssim", "end_ssim"):
            close(got[k][i], want[k], 1e-5, 1e-6, k)
        close(got["initial_pose"][i], want["initial_pose"], 1e-6, 1e-6,
              "initial")
        moved = np.abs(want["refined_pose"] - want["initial_pose"]).max()
        assert moved > 1e-3, moved
        close(got["refined_pose"][i], want["refined_pose"], 0, 5e-6,
              "refined")
    mesh = jax.tree.map(np.asarray, jrefine_apr_sharded(
        *args, jnp.asarray(images), jnp.asarray(targets),
        jnp.asarray(n(m2["hists"])), *tail[:-1],
        JRefine(opt_iter=3, learning_rate=1e-5), jmesh))
    close(got["initial_pose"], mesh["initial_pose"], 0, 1e-5, "initial")
    close(got["losses"][:, 0], mesh["losses"][:, 0], 1e-4, 0, "first loss")
    close(got["losses"][:, -1], mesh["losses"][:, -1], 5e-2, 0, "last loss")
    for k, v in got.items():
        assert torch.equal(ranks[1]["mode2"][k], v), k


def test_render_matches_jax_sharded(world, ranks, jmesh):
    rd = world["job"]["render"]
    want = jrender_rays_sharded(
        world["jmodel"], world["variables"]["params"],
        jnp.asarray(n(rd["rays_o"])), jnp.asarray(n(rd["rays_d"])), NEAR,
        FAR, world["jrc"], jmesh)
    close(ranks[0]["render"], want, 1e-4, 1e-5, "rgb")
    assert torch.equal(ranks[1]["render"], ranks[0]["render"])


# --- the layout, in this process ---

def test_mesh_layout_and_refusals(world):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
    init_distributed(0, 1, f"tcp://localhost:{_free_port()}", device="cpu")
    try:
        one = make_mesh()
        assert (one.data, one.rays, one.rank, one.size) == (1, 1, 0, 1)
        assert one.device == torch.device("cpu")
        with pytest.raises(ValueError):
            make_mesh(data=2)
    finally:
        torch.distributed.destroy_process_group()
    x = torch.arange(4 * 6).reshape(4, 6)
    m = Mesh(data=2, rays=3, rank=4, device=torch.device("cpu"))
    assert (m.data_index, m.rays_index) == (1, 1)
    assert torch.equal(batch_ray_sharding(m, x), x[2:4, 2:4])
    assert torch.equal(shard_batch(m, {"x": x})["x"], x[2:4])
    m3 = world["job"]["mode3"]
    two = Mesh(data=2, rays=1, rank=0, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="do not split"):
        refine_poses_sharded(None, m3["poses"][:1], m3["feats"][:1],
                             m3["hists"][:1], m3["ws"], m3["hwf"],
                             m3["cfg"], m3["rcfg"], two)
