"""The serving loops' captured iteration: one refinement iteration
(forward, backward, Adam step) captured once as a CUDA graph and replayed
opt_iter times a frame. The port's counterpart of the JAX package's
jitted lax.scan (refine_pose_indexed, nefes_tpu/refine/pose_opt.py:191;
refine_apr_verified, nefes_tpu/refine/apr_opt.py:238): the host launches
one graph an iteration instead of each of its kernels.

A loop (refine/pose_opt.py's PoseLoop, refine/apr_opt.py's AprLoop) owns
static device buffers: the frame's inputs, the optimisation state, and
buffers of opt_iter entries that each replay writes its loss (and PSNR,
SSIM) into at a step index the graph advances, so nothing is read back
to the host inside the loop. A frame copies its inputs into the buffers,
resets the state in place and replays.

Capture (torch.cuda.graphs' recipe): WARMUP iterations run first on a
side stream, on the first frame's inputs, so that every lazy set-up
happens outside the graph: the kernels' libraries are loaded and their
occupancy queries cached, cuDNN picks its algorithms, the resize
matrices and frequency bands are copied to the card. Every allocation
inside the capture comes from the graph's private pool, so each replay
finds its tensors (the gradients among them) at the same addresses. The
optimiser is GraphAdam, the eager loops' Adam step in capturable form.
What cannot be captured raises: a copy from the host, a read back to it
(torch.linalg.svd's error flag, cumprod's backward on the unfused
compositor), so only the kernel paths serve on the card. A failed
capture or replay raises; nothing falls back.

Graphs are cached per (loop kind, model, APR, render config, refine
config, shapes): one capture serves every frame of a scene. The cache is
the module's only state; clear() drops it.
"""

from __future__ import annotations

import torch

WARMUP = 2

_CACHE: dict = {}


def launch_counts() -> dict[str, int]:
    """The launch counts of the refinement's kernel wrappers (K1-K8), by
    wrapper name."""
    from nefes_tpu_torch.kernels import fused_field as kf
    from nefes_tpu_torch.kernels import fused_render as kr
    wrappers = (kf.field_fwd_pre, kf.field_bwd_pre, kf.field_fwd,
                kf.field_bwd, kr.render_fwd_pre, kr.render_bwd_pre,
                kr.render_fwd, kr.render_bwd)
    return {f.__name__: f.launches for f in wrappers}


class CapturedIteration:
    """step() captured as a CUDA graph after WARMUP uncaptured runs, each
    from a reset state.

    `launches` holds the kernel launches the capture recorded (by wrapper
    name): a replay launches them again without calling the wrappers, so
    their counters do not move; `replays` counts the replays."""

    def __init__(self, step, reset, release_grads):
        """reset() puts the loop's state back to a frame's start;
        release_grads() sets the gradients to None, so that the captured
        backward allocates them from the graph's pool."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                reset()
                step()
        torch.cuda.current_stream().wait_stream(side)
        reset()
        release_grads()
        before = launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            step()
        after = launch_counts()
        self.launches = {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}
        self.replays = 0

    def replay(self, n: int) -> None:
        for _ in range(n):
            self.graph.replay()
        self.replays += n


def cached(key: tuple, owners: tuple, build):
    """The loop cached under key, built with build() on a miss. owners
    are the objects whose identities the key holds; the entry keeps them,
    so that an id is never reused while its entry lives."""
    entry = _CACHE.get(key)
    if entry is None:
        entry = _CACHE[key] = (owners, build())
    return entry[1]


def loops() -> list:
    """The cached loops (each has .name and .graph, a CapturedIteration
    once its first frame ran)."""
    return [loop for _, loop in _CACHE.values()]


def clear() -> None:
    _CACHE.clear()


class GraphAdam:
    """torch.optim.Adam's step as the eager loops run it (foreach, not
    capturable: the bias corrections of step k as Python doubles), in
    operations a CUDA graph can hold. The step's two scalars for steps 1
    to n_steps sit in device tables that the graph indexes with its step
    tensor; every other operation is the eager one on the same operands,
    and the update param + step_size · (m / denom), one fused
    multiply-add in the eager foreach addcdiv, is addcmul's fused
    multiply-add here. So a replay moves the weights bit for bit as the
    eager optimizer does. torch's capturable Adam computes the bias
    corrections in float32 on the device, and those last bits are enough:
    Adam's normalised steps turn a flipped sign in a near-zero gradient
    component into a whole step along the pose loss's flat directions
    (PERF.md, PR 13). Parameters without a gradient are skipped, as the
    eager Adam skips them."""

    # the eager loops' Adam (optax.adam's defaults)
    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, groups, n_steps: int):
        """groups: [(params, lr)]."""
        self.groups = []
        for params, lr in groups:
            dev = params[0].device
            ks = range(1, n_steps + 1)
            neg_step = torch.tensor([(lr / (1 - self.b1 ** k)) * -1
                                     for k in ks], device=dev)
            bc2_sqrt = torch.tensor([(1 - self.b2 ** k) ** 0.5 for k in ks],
                                    device=dev)
            self.groups.append((list(params), neg_step, bc2_sqrt))
        self.moments = {p: (torch.zeros_like(p), torch.zeros_like(p))
                        for params, _, _ in self.groups for p in params}

    @torch.no_grad()
    def zero_(self) -> None:
        for m, v in self.moments.values():
            m.zero_()
            v.zero_()

    @torch.no_grad()
    def step(self, it: torch.Tensor) -> None:
        """One Adam step, step index it ((1,) int64, 0-based)."""
        for params, neg_step, bc2_sqrt in self.groups:
            live = [p for p in params if p.grad is not None]
            if not live:
                continue
            grads = [p.grad for p in live]
            m = [self.moments[p][0] for p in live]
            v = [self.moments[p][1] for p in live]
            torch._foreach_lerp_(m, grads, 1 - self.b1)
            torch._foreach_mul_(v, self.b2)
            torch._foreach_addcmul_(v, grads, grads, 1 - self.b2)
            denom = torch._foreach_sqrt(v)
            torch._foreach_div_(denom, [bc2_sqrt.index_select(0, it)]
                                * len(denom))
            torch._foreach_add_(denom, self.eps)
            step = neg_step.index_select(0, it)
            for p, q in zip(live, torch._foreach_div(m, denom)):
                p.addcmul_(q, step)


def record_(buf: torch.Tensor, it: torch.Tensor, value: torch.Tensor) -> None:
    """buf[it] = value on the device (it: the (1,) int64 step index)."""
    buf.index_copy_(0, it, value.detach().reshape(1).to(buf.dtype))
