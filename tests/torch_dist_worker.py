"""One rank of tests/test_torch_parallel.py's process group: the port's
sharded paths (nefes_tpu_torch/parallel/) on the CPU with gloo. It
imports no JAX, so that a spawned rank starts quickly.

run(rank, job) joins the group at job["address"], runs the sharded train
step under each of job["layouts"], then the sharded mode 3, mode 2 and
render, and saves what it got to job["out"] + f".{rank}"."""

import copy

import torch

from nefes_tpu_torch.features import DFNet
from nefes_tpu_torch.parallel import (
    init_distributed, make_mesh, make_sharded_train_step,
    refine_apr_sharded, refine_poses_sharded, render_rays_sharded,
    shard_batch,
)
from nefes_tpu_torch.train.model import NeFeSModel
from nefes_tpu_torch.train.trainer import create_train_state, make_optimizer


def model_of(job) -> NeFeSModel:
    model = NeFeSModel(job["cfg"], device="cpu")
    model.load_state_dict(job["state"])
    return model


def train_steps(job, mesh, layout: dict) -> dict:
    """job["steps"] sharded steps from the job's weights; the losses, and
    the parameters after them and the last step's (averaged) gradients."""
    tr = job["train"]
    state = create_train_state(model_of(job))
    state.tx = make_optimizer(state.model.parameters(),
                              grad_clip=tr["grad_clip"])
    step = make_sharded_train_step(tr["rcfg"], mesh, tr["hwf"], tr["near"],
                                   tr["far"], n_rand=tr["n_rand"],
                                   stage=tr["stage"], aux=layout["aux"])
    gen = torch.Generator().manual_seed(tr["seed"])
    batch = shard_batch(mesh, tr["batch"])
    losses, psnrs = [], []
    for _ in range(tr["steps"]):
        state, loss, metrics = step(state, batch, gen, tr["lr"])
        losses.append(loss)
        psnrs.append(metrics["psnr"])
    return {"losses": torch.stack(losses), "psnr": torch.stack(psnrs),
            "params": {k: v.detach().clone()
                       for k, v in state.model.named_parameters()},
            "grads": {k: v.grad.clone()
                      for k, v in state.model.named_parameters()}}


def run(rank: int, job: dict) -> None:
    torch.set_num_threads(1)
    init_distributed(rank, job["world"], job["address"], device="cpu",
                     timeout_s=60.0)
    out = {"train": {}}
    for name, layout in job["layouts"].items():
        mesh = make_mesh(data=layout["data"], rays=layout["rays"])
        out["train"][name] = train_steps(job, mesh, layout)
    mesh = make_mesh()

    m3 = job["mode3"]
    model = model_of(job).requires_grad_(False)
    out["mode3"] = refine_poses_sharded(
        model, m3["poses"], m3["feats"], m3["hists"], m3["ws"], m3["hwf"],
        m3["cfg"], m3["rcfg"], mesh)

    m2 = job["mode2"]
    dfnet = DFNet(output_dim=job["cfg"].feature_dim, device="cpu")
    dfnet.load_state_dict(m2["dfnet"])
    out["mode2"] = refine_apr_sharded(
        model, dfnet.requires_grad_(False), m2["images"], m2["targets"],
        m2["hists"], m2["ws_vec"], m2["hwf_render"], m2["hwf_full"],
        m2["near"], m2["far"], m2["cfg"], m2["rcfg"], mesh)

    rd = job["render"]
    out["render"] = render_rays_sharded(model, rd["rays_o"], rd["rays_d"],
                                        rd["near"], rd["far"], rd["cfg"],
                                        mesh)
    torch.save(copy.deepcopy(out), job["out"] + f".{rank}")
    torch.distributed.destroy_process_group()
