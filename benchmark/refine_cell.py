"""Refinement traffic: query frames back to back from one client (a closed
loop), each what a user localising one image pays, from image in to pose
out:

1. the query's DFNet target features (features.extract_target_features);
2. in mode 3, the APR's initial pose (refine.apr_poses_batched);
3. the serving step the refinement CLI runs at --refine_batch 1:
   refine.refine_apr_verified (mode 2, the verification fail-safe
   included) or refine.refine_pose_indexed (mode 3), which run the
   captured loop on the card and the eager one on the CPU;
4. the pose read back to the host.

The serving step returns only the pose; what its refinement loop
returned besides (the losses, the PSNR and SSIM of the fail-safe, the
refined and initial poses) is kept for the check by a recorder around
that loop, which holds references and reads nothing back.

The traffic file sets the mode, the pool of distinct query images the
frames cycle through, the warm-up frames, the traced frames and how many
frames the reference checks."""

from __future__ import annotations

import contextlib
import gc
import time
from dataclasses import replace

import torch
from torch.profiler import record_function

from benchmark import models, tracing, workcount
from benchmark.harness import Checks


def _geometry(config: dict) -> dict:
    sc, r = config["scene"], config["render"]
    H, W = sc["H"] // sc["df"], sc["W"] // sc["df"]
    focal = sc["focal"] / sc["df"]
    ts = r["tinyscale"]
    return {"full": (H, W, focal),
            "render": (int(H // ts), int(W // ts), focal / ts),
            "near": float(sc["near"]), "far": float(sc["far"]),
            "ws_vec": [sc["pose_scale"], sc["pose_scale2"],
                       *sc["move_all_cam_vec"]]}


def _settings(cell, overrides: dict) -> tuple:
    config = dict(cell.config)
    for key in ("field", "render", "scene", "refine", "apr", "train"):
        if key in overrides and key in config:
            config[key] = {**config.get(key, {}), **overrides[key]}
    traffic = {**cell.traffic, **overrides.get("traffic", {})}
    return config, traffic


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def program_field(config: dict, seed: int, device):
    """The program's field in its configured dtype with the seed's
    weights."""
    from nefes_tpu_torch.fields.embedder import EmbedConfig
    from nefes_tpu_torch.train.model import ModelConfig, NeFeSModel
    f = config["field"]
    mcfg = ModelConfig(depth=f["depth"], width=f["width"],
                       feature_dim=f["feature_dim"], skips=tuple(f["skips"]),
                       hist_bin=f["hist_bin"],
                       xyz_embed=EmbedConfig(num_freqs=f["n_freqs_xyz"]),
                       dir_embed=EmbedConfig(num_freqs=f["n_freqs_dir"]),
                       dtype=DTYPES[f["dtype"]])
    with torch.device(device):
        model = NeFeSModel(mcfg, device=device)
    models.fill_uniform_(model, seed, models.FIELD)
    return model


def program_models(config: dict, seed: int, device):
    """The program's frozen field, feature extractor and APR, with the
    seed's weights; the APR aimed at the seed's pose."""
    from nefes_tpu_torch.features import DFNet
    model = program_field(config, seed, device).requires_grad_(False)
    a = config["apr"]
    with torch.device(device):
        featnet = DFNet(output_dim=config["field"]["feature_dim"],
                        dtype=DTYPES[a["dtype"]], device=device)
    models.fill_dfnet_(featnet, seed)
    featnet.requires_grad_(False)
    base = models.look_pose(models.generator(seed, models.POSES, device), 1,
                            device)[0]
    if a["kind"] == "DFNet":
        models.aim_dfnet_(featnet, base)
        return model, featnet, featnet
    if a["kind"] != "MsTransformer":
        raise ValueError(f"APR kind {a['kind']!r}")
    from nefes_tpu_torch.features import MSTransPoseNet
    with torch.device(device):
        apr = MSTransPoseNet(device=device)
    models.fill_mstransformer_(apr, seed)
    models.aim_mstransformer_(apr, base)
    return model, featnet, apr.requires_grad_(False)


def reference_models(config: dict, seed: int, device, low: bool = False):
    """The plain reference's field, feature extractor, APR and the APR's
    pose function from the same seed (the control, low=True: the field in
    fp8, the APR and the feature extractor in bf16)."""
    from benchmark.reference.dfnet import DFNet
    from benchmark.reference.nefes import NeFeS
    f = config["field"]
    field = NeFeS(f["depth"], f["width"], f["feature_dim"], tuple(f["skips"]),
                  f["n_freqs_xyz"], f["n_freqs_dir"], f["hist_bin"]).to(device)
    models.fill_uniform_(field, seed, models.FIELD)
    field.requires_grad_(False).set_low(low)
    dt = torch.bfloat16 if low else torch.float32
    featnet = DFNet(f["feature_dim"], dtype=dt).to(device)
    models.fill_dfnet_(featnet, seed)
    featnet.requires_grad_(False)
    base = models.look_pose(models.generator(seed, models.POSES, device), 1,
                            device)[0]
    from benchmark.reference.refine import dfnet_pose
    a = config["apr"]
    if a["kind"] == "DFNet":
        models.aim_dfnet_(featnet, base)
        return field, featnet, featnet, dfnet_pose
    from benchmark.reference.mstransformer import MSTransPoseNet, pose_7scenes
    apr = MSTransPoseNet(dtype=dt).to(device)
    models.fill_mstransformer_(apr, seed)
    models.aim_mstransformer_(apr, base)
    return field, featnet, apr.requires_grad_(False), pose_7scenes


@contextlib.contextmanager
def exact_f32():
    """TF32 off for cuBLAS and cuDNN (the reference's float32), the
    program's settings restored after."""
    cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    old = cuda.allow_tf32, cudnn.allow_tf32
    cuda.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cuda.allow_tf32, cudnn.allow_tf32 = old


def program_precision(config: dict) -> None:
    """The APR's and DFNet's math as the configuration states it:
    convolutions on TF32 or float32 (conv_math), matrix products likewise
    (matmul_math); PyTorch's defaults, which the refinement CLI keeps,
    are TF32 and float32."""
    a = config["apr"]
    torch.backends.cudnn.allow_tf32 = a.get("conv_math", "tf32") == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = (
        a.get("matmul_math", "float32") == "tf32")


class Recorder:
    """Wraps the functions `names` of `module` so that the last value they
    returned is kept in `last`; close() puts them back."""

    def __init__(self, module, names):
        self.last = None
        self._saved = [(name, getattr(module, name)) for name in names]
        self._module = module
        for name, fn in self._saved:
            setattr(module, name, self._wrap(fn))

    def _wrap(self, fn):
        def recorded(*a, **k):
            self.last = fn(*a, **k)
            return self.last
        return recorded

    def take(self, entry: str):
        if self.last is None:
            names = ", ".join(n for n, _ in self._saved)
            raise RuntimeError(f"{entry} ran none of {names}: the check "
                               "has no losses to compare")
        out, self.last = self.last, None
        return out

    def close(self) -> None:
        for name, fn in self._saved:
            setattr(self._module, name, fn)


def frame_inputs(config: dict, seed: int, device):
    from benchmark.reference.nefes import luminance_histograms
    H, W, _ = _geometry(config)["full"]
    pool = models.images(seed, config["test_frames"], H, W, device)
    return pool, luminance_histograms(pool, config["field"]["hist_bin"])


def run(cell, seed, seconds, trace, device, t0, overrides) -> dict:
    from nefes_tpu_torch.cli.refine import KERNEL_PATHS
    from nefes_tpu_torch.features import extract_target_features
    from nefes_tpu_torch.refine import (
        RefineConfig, apr_opt, apr_poses_batched, graph, pose_opt,
        refine_apr_verified, refine_pose_indexed,
    )
    config, traffic = _settings(cell, overrides)
    program_precision(config)
    mode = traffic["mode"]
    on_card = device.type == "cuda"
    parts = {"imports": time.perf_counter() - t0}
    if on_card:
        from nefes_tpu_torch.kernels import build
        build.build_all(names=("fused_field", "fused_render"))
    parts["libraries"] = time.perf_counter() - t0
    geo = _geometry(config)
    (H, W, _), (h, w, _) = geo["full"], geo["render"]
    near, far = geo["near"], geo["far"]
    model, featnet, apr = program_models(config, seed, device)
    pool, hists = frame_inputs(config, seed, device)
    ws_vec = torch.tensor(geo["ws_vec"], dtype=torch.float32, device=device)
    r, rf = config["render"], config["refine"]
    rcfg_render = replace(model.cfg.render_config(
        n_samples=r["n_samples"], n_importance=r["n_importance"],
        perturb=False, test_time=True, output_transient=False, remat=False),
        **KERNEL_PATHS[mode])
    rcfg = RefineConfig(opt_iter=rf["opt_iter"], lr_r=rf["lr_r"],
                        lr_t=rf["lr_t"], tinyscale=r["tinyscale"],
                        learning_rate=rf["learning_rate"],
                        fusion=rf["fusion"])
    kind = config["apr"]["kind"]
    svd_reg = rf["svd_reg"]
    P = config["test_frames"]
    if on_card:
        tracing.sync(device)
    parts["weights"] = time.perf_counter() - t0

    def targets(img, th, tw):
        with torch.no_grad(), record_function("bench.targets"):
            return extract_target_features(featnet, img[None], th, tw)[0]

    def initial_pose(img):
        with torch.no_grad(), record_function("bench.initial_pose"):
            return apr_poses_batched(kind, apr, img[None], svd_reg)[0]

    def refine(i, img, tgt, init):
        with record_function("bench.refine"):
            return refine_once(i, img, tgt, init)

    def refine_once(i, img, tgt, init):
        if mode == 2:
            pose = refine_apr_verified(
                model, apr, img[None], tgt[None], hists, 0, i % P, ws_vec,
                geo["render"], geo["full"], near, far, rcfg_render, rcfg,
                svd_reg=svd_reg, freeze_bn=True, apr_kind=kind,
                dataset_type="7Scenes",
                verification_metric=rf["verification_metric"])
            out = dict(inner.take("refine_apr_verified"))
        else:
            pose = refine_pose_indexed(
                model, init[None], tgt[None], hists[i % P][None], 0, ws_vec,
                geo["render"], near, far, rcfg_render, rcfg)
            _, losses = inner.take("refine_pose_indexed")
            out = {"refined_pose": pose, "initial_pose": init,
                   "losses": losses}
        out["verified_pose"] = pose
        return out

    def frame(i):
        img = pool[i % P]
        if mode == 2:
            out = refine(i, img, targets(img, H, W), None)
        else:
            out = refine(i, img, targets(img, h, w), initial_pose(img))
        out["host_pose"] = out["verified_pose"].cpu()
        return out

    inner = (Recorder(apr_opt, ("refine_apr_captured", "refine_apr_single"))
             if mode == 2 else
             Recorder(pose_opt, ("refine_pose_captured",
                                 "refine_pose_single")))
    try:
        for i in range(traffic["warmup_frames"]):
            frame(i)
        tracing.sync(device)
        setup_s = time.perf_counter() - t0
        parts["warm-up"] = setup_s

        outs, lat = [], []
        start = time.perf_counter()
        while True:
            f0 = time.perf_counter()
            outs.append(frame(len(outs)))
            lat.append(time.perf_counter() - f0)
            if f0 + lat[-1] - start >= seconds:
                break
        window_s = time.perf_counter() - start

        run_rec = {"kind": "refine", "setup_s": setup_s,
                   "setup_parts": parts, "window_s": window_s,
                   "frame_latencies": lat, "iters": rf["opt_iter"]}
        if trace:
            run_rec["trace"] = _trace(frame, len(outs), traffic, config, geo,
                                      device, graph, on_card, kind, mode)
    finally:
        inner.close()
    run_rec["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                    if on_card else 0)
    kept = {i: outs[i] for i in models.sample(seed, len(outs),
                                              traffic["checked_frames"])}
    kept = {i: {k: (v.detach().cpu() if torch.is_tensor(v) else v)
                for k, v in o.items()} for i, o in kept.items()}
    del outs, model, featnet, apr
    graph.clear()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks = Checks(cell.limits)
    compare(checks, kept, config, traffic, seed, device, pool, hists, ws_vec,
            geo, mode)
    run_rec.update(checks=checks, attempted=len(lat), failed=0)
    return run_rec


def _trace(frame, first, traffic, config, geo, device, graph, on_card, kind,
           mode) -> dict:
    """Trace traffic["trace_frames"] frames; the replayed kernels of the
    captured iteration are named by one eager run of its step."""
    reference = None
    loops = graph.loops() if on_card else []
    if len(loops) == 1 and loops[0].graph is not None:
        loop = loops[0]
        loop._release_grads()
        loop._reset()
        prof, _ = tracing.profiled(loop._step, device)
        reference, _ = tracing.load(prof)
        loop._release_grads()
    n = traffic["trace_frames"]

    def frames():
        for i in range(n):
            frame(first + i)
    prof, wall = tracing.profiled(frames, device)
    ops, phases = tracing.load(prof, reference)
    out = tracing.summarize(ops, wall)
    dims = workcount.FieldDims.from_config(config["field"])
    h, w, _ = geo["render"]
    r = config["render"]
    n_c, n_f = r["n_samples"], r["n_samples"] + r["n_importance"]
    bounds = workcount.refinement_kernel_bounds(dims, h * w, n_c, n_f)
    kernel_ops = [o for o in ops if o.wrapper in bounds]
    replays = {o.replay for o in ops if o.replay is not None}
    out.update({
        "frames": n, "phases_ms": phases,
        "kernel_ms": sum(o.ms for o in kernel_ops),
        "kernel_bound_ms": sum(bounds[o.wrapper] for o in kernel_ops),
        "apr_ms": sum(o.ms for o in ops if o.phase == "apr_tower"
                      and o.span in ("bench.refine", "bench.initial_pose")),
        "glue_ms": sum(o.ms for o in ops if o.span == "bench.refine"
                       and o.phase != "apr_tower"
                       and o.wrapper not in bounds),
        "replayed_kernels": sum(1 for o in ops if o.replay is not None
                                and not o.name.startswith(("Memcpy",
                                                           "Memset"))),
        "replays": len(replays),
        "model_flops_per_frame": frame_flops(config, geo, mode, kind),
    })
    return out


def frame_flops(config: dict, geo: dict, mode: int, kind: str) -> float:
    """A frame's model FLOPs, counted from shapes whatever implements
    them: the field's coarse density pass, fine forward and its backward
    to the inputs (as many products as the forward) from the tower's
    sizes; the feature extraction, the APR (forward and backward in mode
    2, its forward once in mode 3) and FusionNet (forward and backward)
    by torch.utils.flop_counter over the reference's modules on the meta
    device."""
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference.dfnet import DFNet
    from benchmark.reference.nefes import FusionNet
    dims = workcount.FieldDims.from_config(config["field"])
    (H, W, _), (h, w, _) = geo["full"], geo["render"]
    r, it = config["render"], config["refine"]["opt_iter"]
    rays = h * w
    fl = workcount.tower_flops(dims)
    field = rays * (r["n_samples"] * fl["K1"]
                    + (r["n_samples"] + r["n_importance"]) * 2 * fl["full"])
    meta = torch.device("meta")
    F = config["field"]["feature_dim"]
    with torch.device(meta):
        net = DFNet(F)
        fusion = FusionNet(F)
    counter = FlopCounterMode(display=False)
    with counter:
        img = torch.zeros((1, H, W, 3), device=meta)
        th, tw = (H, W) if mode == 2 else (h, w)
        net.features(img, th, tw)
    extract = counter.get_total_flops()
    with FlopCounterMode(display=False) as c2:
        x = torch.zeros((1, h, w, 3 + F), device=meta, requires_grad=True)
        fusion(x).sum().backward()
    fusion_fb = c2.get_total_flops()
    with FlopCounterMode(display=False) as c3:
        if mode == 2:
            img = torch.zeros((1, H, W, 3), device=meta)
            net.pose(img).sum().backward()
        else:
            with torch.no_grad():
                net.pose(torch.zeros((1, H, W, 3), device=meta))
    apr = c3.get_total_flops()
    per_iter = field + fusion_fb + (apr if mode == 2 else 0)
    return float(extract + (0 if mode == 2 else apr) + it * per_iter)


def compare(checks: Checks, kept: dict, config, traffic, seed, device, pool,
            hists, ws_vec, geo, mode, low: bool = False) -> None:
    """Run the reference over each kept frame's query and judge the frame
    (judge_frame)."""
    with exact_f32():
        field, featnet, apr, apr_pose = reference_models(config, seed,
                                                         device, low)
        for i, out in kept.items():
            res, loss_at = reference_frame(config, mode, geo, field, featnet,
                                           apr, apr_pose, pool, hists,
                                           ws_vec, i)
            judge_frame(checks, out, res, mode, f"frame {i}", loss_at)


def reference_frame(config, mode, geo, field, featnet, apr, apr_pose, pool,
                    hists, ws_vec, i):
    """The reference's refinement of frame i's query, and the loss it gives
    any pose of that query."""
    from benchmark.reference import refine as ref
    r, rf = config["render"], config["refine"]
    P = config["test_frames"]
    img, hist = pool[i % P], hists[i % P]
    common = (field, apr, apr_pose, featnet, img, hist, ws_vec, geo["render"])
    if mode == 2:
        res = ref.mode2(*common, geo["full"], geo["near"], geo["far"],
                        r["n_samples"], r["n_importance"],
                        rf["learning_rate"], rf["opt_iter"])
    else:
        res = ref.mode3(*common, geo["near"], geo["far"], r["n_samples"],
                        r["n_importance"], rf["lr_r"], rf["lr_t"],
                        rf["opt_iter"])

    def loss_at(pose):
        return ref.pose_loss(mode, field, featnet, img, hist,
                             pose.to(img.device).float(), ws_vec,
                             geo["render"], geo["full"], geo["near"],
                             geo["far"], r["n_samples"], r["n_importance"])
    return res, loss_at


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """Frobenius distance of two (3, 4) poses (without svd_reg the APR's
    rotation block is not orthonormal, so no angle is defined)."""
    return float(torch.linalg.norm(a.float().cpu() - b.float().cpu()))


def judge_frame(checks: Checks, out: dict, res: dict, mode: int,
                where: str = "", loss_at=None) -> None:
    """One frame's numbers, each loss gap relative to the reference's first
    loss: the first loss (the forward through the APR, the render, the
    exposure, FusionNet, the resize and the loss), the widest loss gap
    over the first k steps (the gradient and the optimizer), the last
    loss; the initial pose; the refined pose's distance from the
    reference's, relative to the reference's move, and whether it did not
    move at all where the reference's did (exact); the gap between the
    losses the reference gives the program's refined pose and its own
    (both judged by the reference, so the answer is held to the
    reference's answer by how well it fits the query); in mode 2
    the PSNR and SSIM of the fail-safe and its choice, wrong only where
    the reference's margins are clear of twice the program's gaps. The
    reference's own drop over the frame is a reading."""
    lp = [float(x) for x in out["losses"]]
    lr = res["losses"]
    L0 = abs(lr[0])
    gaps = [abs(a - b) / L0 for a, b in zip(lp, lr)]
    checks.add("loss0", gaps[0], where)
    for k in (1, 5, 10):
        checks.add(f"traj{k}", max(gaps[:k + 1]), where)
    checks.add("last_loss", gaps[-1], where)
    checks.add("traj_all", max(gaps), where)
    # the gap in the loss's drop since the first step: the forward's
    # offset (the field's rounding) taken out, the gradient and the
    # optimizer's steps left
    drops = [abs((a - lp[0]) - (b - lr[0])) / L0 for a, b in zip(lp, lr)]
    for k in (1, 2, 3, 5, 10):
        checks.add(f"drop{k}", max(drops[:k + 1]), where)
    checks.add("ref_drop", (lr[0] - lr[-1]) / L0, where)
    checks.add("initial_pose", _gap(out["initial_pose"], res["initial"]),
               where)
    move = _gap(res["refined"], res["initial"])
    checks.add("ref_move", move, where)
    checks.add("refined_rel", _gap(out["refined_pose"], res["refined"])
               / max(move, 1e-12), where)
    # exact: the program's pose did not move where the reference's did
    checks.add("unmoved", float(move > 0 and _gap(out["refined_pose"],
                                                  out["initial_pose"]) == 0),
               where)
    if loss_at is not None:
        checks.add("answer_loss", abs(loss_at(out["refined_pose"])
                                      - loss_at(res["refined"])) / L0, where)
    if mode != 2:
        return
    dp = [abs(float(out[k]) - res[k2]) for k, k2 in (
        ("init_psnr", "psnrs0"), ("end_psnr", "psnrs-1"))]
    ds = [abs(float(out[k]) - res[k2]) for k, k2 in (
        ("init_ssim", "ssims0"), ("end_ssim", "ssims-1"))]
    checks.add("psnr_gap", max(dp), where)
    checks.add("ssim_gap", max(ds), where)
    m_p = res["psnrs-1"] - res["psnrs0"]
    m_s = res["ssims-1"] - res["ssims0"]
    checks.add("ref_dssim", abs(m_s), where)
    clear = abs(m_p) > 2 * sum(dp) and abs(m_s) > 2 * sum(ds)
    retreat_ref = m_p < 0 or m_s < 0
    retreat = bool(torch.equal(out["verified_pose"].cpu(),
                               out["initial_pose"].cpu()))
    refined = bool(torch.equal(out["verified_pose"].cpu(),
                               out["refined_pose"].cpu()))
    wrong = not (retreat or refined) or (clear and retreat != retreat_ref)
    checks.add("verify_wrong", float(wrong), where)
