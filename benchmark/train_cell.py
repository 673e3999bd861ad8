"""Training traffic: stage-1 random-ray steps of the feature field back to
back (train.train_step_rays through the training CLI's kernel path: K5,
K6 +dW in chunks, the dW kernel, Adam), each on the traffic's images x
N_rand rays, the pixels, the samples' jitter and the importance samples
drawn from the seed.

Set-up builds one training state and drives it through its first steps
with the window's own call and batch; the reference follows the first
`checked_steps` from the same weights, batch and random draws."""

from __future__ import annotations

import gc
import statistics
import time
from dataclasses import replace

import torch
from torch.profiler import record_function

from benchmark import models, tracing, workcount
from benchmark.harness import Checks
from benchmark.refine_cell import (
    _geometry, _settings, exact_f32, program_field,
)

B1 = 0.9          # Adam's first-moment decay (optax's default)


def make_batch(config: dict, traffic: dict, seed: int, device) -> dict:
    """rgb targets (smooth colour fields), feature targets N(0, 1), camera
    poses and the targets' histograms, at the render's size."""
    from benchmark.reference.nefes import luminance_histograms
    h, w, _ = _geometry(config)["render"]
    n = traffic["images"]
    rgb = models.images(seed, n, h, w, device)
    gen = models.generator(seed, models.BATCH, device)
    feat = torch.randn((n, h, w, config["field"]["feature_dim"]),
                       generator=gen, device=device)
    poses = models.look_pose(gen, n, device)
    return {"rgb": rgb, "feat": feat, "poses": poses,
            "hists": luminance_histograms(rgb, config["field"]["hist_bin"])}


def _leaves(named) -> dict:
    return {k: v for k, v in sorted(named)}


def run(cell, seed, seconds, trace, device, t0, overrides) -> dict:
    from nefes_tpu_torch.cli.train import KERNEL_PATHS
    from nefes_tpu_torch.train import create_train_state, train_step_rays
    config, traffic = _settings(cell, overrides)
    on_card = device.type == "cuda"
    parts = {"imports": time.perf_counter() - t0}
    if on_card:
        from nefes_tpu_torch.kernels import build
        build.build_all(names=("fused_field", "fused_render"))
    parts["libraries"] = time.perf_counter() - t0
    geo = _geometry(config)
    tc, r = config["train"], config["render"]
    model = program_field(config, seed, device)
    state = create_train_state(model)
    cfg = replace(model.cfg.render_config(
        n_samples=r["n_samples"], n_importance=r["n_importance"],
        perturb=tc["perturb"], output_transient=tc["transient"],
        remat=False), **KERNEL_PATHS["train"])
    batch = make_batch(config, traffic, seed, device)
    gen = models.generator(seed, models.STEPS, device)
    rays = traffic["images"] * tc["n_rand"]
    tracing.sync(device)
    parts["weights"] = time.perf_counter() - t0

    def step():
        with record_function("bench.step"):
            return train_step_rays(state, cfg, batch, gen, tc["lrate"],
                geo["render"], geo["near"], geo["far"], n_rand=tc["n_rand"],
                stage=tc["stage"])[1:]

    params = _leaves(model.named_parameters())
    p0 = {k: v.detach().clone() for k, v in params.items()}
    losses, feats, grad_norms, change_norms = [], [], {}, {}
    for s in range(max(traffic["warmup_steps"], traffic["checked_steps"])):
        loss, metrics = step()
        if s < traffic["checked_steps"]:
            losses.append(loss)
            feats.append(metrics["loss_feat"])
        if s == 0:
            # the first gradient as the optimizer holds it: m = (1 - b1) g
            mu = dict(zip([id(p) for p in state.tx.params], state.tx.mu))
            grad_norms = {k: torch.linalg.norm(mu[id(p)] / (1 - B1))
                          for k, p in params.items()}
        if s == traffic["checked_steps"] - 1:
            change_norms = {k: torch.linalg.norm(p.detach() - p0[k])
                            for k, p in params.items()}
    tracing.sync(device)
    setup_s = time.perf_counter() - t0
    parts["warm-up"] = setup_s
    del p0

    steps = 0
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        step()
        steps += 1
    tracing.sync(device)
    window_s = time.perf_counter() - start

    run_rec = {"kind": "train", "setup_s": setup_s, "setup_parts": parts,
               "window_s": window_s,
               "steps": steps, "rays_per_step": rays}
    if trace:
        n = traffic["trace_steps"]

        def steps_fn():
            for _ in range(n):
                step()
        # no Python stacks: the step is bound by the host, whose every op
        # the stacks would slow; the program's kernels are named nefes::
        prof, wall = tracing.profiled(steps_fn, device, with_stack=False)
        ops, phases = tracing.load(prof)
        out = tracing.summarize(ops, wall)
        dims = workcount.FieldDims.from_config(config["field"])
        n_c, n_f = r["n_samples"], r["n_samples"] + r["n_importance"]
        kernel_ops = [o for o in ops if "nefes::" in o.name]
        fl = workcount.tower_flops(dims)
        fwd = rays * (n_c * fl["full"] + n_f * fl["fwd_t"])
        out.update({"steps": n, "phases_ms": phases,
                    "kernel_ms": sum(o.ms for o in kernel_ops),
                    "kernel_bound_ms": n * workcount.train_step_kernel_bound(
                        dims, rays, n_c, n_f),
                    # forward, and a backward of twice its products
                    "model_flops_per_step": 3.0 * fwd})
        run_rec["trace"] = out
    run_rec["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                    if on_card else 0)
    program = {"losses": [float(x) for x in losses],
               "feat": [float(x) for x in feats],
               "grad": {k: float(v) for k, v in grad_norms.items()},
               "change": {k: float(v) for k, v in change_norms.items()}}
    del state, model, params, batch
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks = Checks(cell.limits)
    compare(checks, program, config, traffic, seed, device)
    run_rec.update(checks=checks, attempted=steps, failed=0)
    return run_rec


def reference_steps(config: dict, traffic: dict, seed: int, device,
                    low: bool = False, keep_rows: float = 1.0) -> dict:
    """The reference's first traffic["checked_steps"] steps from the
    seed's weights, batch and draws: each step's loss, the first step's
    gradient norm and the parameters' change norm after the last, by
    leaf. low: the control (the field in fp8). keep_rows < 1: the loss
    over that share of each image's rays (a planted fault)."""
    from benchmark.reference import nefes
    f, tc, r = config["field"], config["train"], config["render"]
    h, w, focal = _geometry(config)["render"]
    geo = _geometry(config)
    field = nefes.NeFeS(f["depth"], f["width"], f["feature_dim"],
                        tuple(f["skips"]), f["n_freqs_xyz"], f["n_freqs_dir"],
                        f["hist_bin"]).to(device)
    models.fill_uniform_(field, seed, models.FIELD)
    field.set_low(low)
    batch = make_batch(config, traffic, seed, device)
    gen = models.generator(seed, models.STEPS, device)
    params = _leaves(field.named_parameters())
    p0 = {k: v.detach().clone() for k, v in params.items()}
    opt = torch.optim.Adam(list(params.values()), lr=tc["lrate"],
                           betas=(0.9, 0.999), eps=1e-8)
    B, n_rand = traffic["images"], tc["n_rand"]
    losses, feats, grad = [], [], {}
    for s in range(traffic["checked_steps"]):
        keys = torch.rand((B, h * w), generator=gen, device=gen.device)
        idx = keys.to(device).topk(n_rand, dim=1).indices
        px, py = (idx % w).float(), torch.div(idx, w,
                                             rounding_mode="floor").float()
        tgt_rgb = torch.gather(batch["rgb"].reshape(B, -1, 3), 1,
                               idx[..., None].expand(-1, -1, 3))
        tgt_feat = torch.gather(
            batch["feat"].reshape(B, h * w, -1), 1,
            idx[..., None].expand(-1, -1, batch["feat"].shape[-1]))
        ro, rd = nefes.rays_at(px, py, focal, h, w, batch["poses"])
        out = nefes.render_rays(field, ro.reshape(-1, 3), rd.reshape(-1, 3),
                                geo["near"], geo["far"], r["n_samples"],
                                r["n_importance"], gen=gen, train=True)
        out = {k: v.reshape(B, n_rand, *v.shape[1:]) for k, v in out.items()}
        out["rgb"] = nefes.affine_color_transform(
            field.exposure(batch["hists"]), out["rgb"])
        keep = max(1, int(round(n_rand * keep_rows)))
        out = {k: v[:, :keep] for k, v in out.items()}
        loss, loss_feat = nefes.training_loss(
            out, tgt_rgb[:, :keep], tgt_feat[:, :keep], tc["lambda_u"],
            tc["feat_weight"])
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if s == 0:
            grad = {k: (float(torch.linalg.norm(p.grad))
                        if p.grad is not None else 0.0)
                    for k, p in params.items()}
        opt.step()
        losses.append(float(loss.detach()))
        feats.append(float(loss_feat.detach()))
    change = {k: float(torch.linalg.norm(p.detach() - p0[k]))
              for k, p in params.items()}
    return {"losses": losses, "feat": feats, "grad": grad, "change": change}


def judge(checks: Checks, program: dict, ref: dict) -> None:
    """Each step's loss and its feature term (the L1 against the target
    features, which the batch's rays set and no constant dilutes); the
    first gradient's and the three steps' change's
    norms by worst leaf, against the larger of the leaf's and the median
    leaf's reference norm; leaves whose reference gradient is under a
    thousandth of the median leaf's are left out (they move by round-off
    alone)."""
    for i, (lp, lr) in enumerate(zip(program["losses"], ref["losses"])):
        checks.add(f"loss_step{i + 1}", abs(lp - lr) / abs(lr))
    for i, (fp, fr) in enumerate(zip(program["feat"], ref["feat"])):
        checks.add(f"feat_step{i + 1}", abs(fp - fr) / abs(fr))
    g = ref["grad"]
    med_g = statistics.median([v for v in g.values() if v > 0])
    live = [k for k, v in g.items() if v >= 1e-3 * med_g]
    med_c = statistics.median([ref["change"][k] for k in live])
    gaps = {"grad": {}, "change": {}}
    for k in live:
        gaps["grad"][k] = abs(program["grad"][k] - g[k]) / max(g[k], med_g)
        gaps["change"][k] = (abs(program["change"][k] - ref["change"][k])
                             / max(ref["change"][k], med_c))
    for name, by_leaf in gaps.items():
        for k, v in by_leaf.items():
            checks.add(name, v, k)
        # the median leaf's gap: steady where a few small leaves are not
        checks.add(f"{name}_median", statistics.median(by_leaf.values()))


def compare(checks: Checks, program: dict, config, traffic, seed, device):
    with exact_f32():
        judge(checks, program, reference_steps(config, traffic, seed,
                                               device))
