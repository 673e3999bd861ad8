"""The port's trace attribution (nefes_tpu_torch/runtime/xprof.py) against
the JAX package's (runtime/xprof.py):

1. categorize on each port file gives the phase the JAX categorize gives
   for its counterpart, every branch of it (the nerfh_nff.py class spans
   among them, found by the classes' lines in each file), with two
   names of the port's own: cuda_kernel for pallas_kernel and
   torch_internal for jax_internal.
2. load_ops + attribute on a synthetic trace shaped as torch.profiler's
   event tree on the card (a kernel under its runtime call, under the
   torch op or Python frame that launched it; backward ops on the
   autograd thread; kernels under cudaGraphLaunch): the phases sum to the
   busy time (1e-9), two overlapping kernels count once, a ctypes launch
   takes its wrapper's bytes and a torch op's launch the op's inputs and
   allocations, a backward kernel takes its forward op's phase, and the
   replayed kernels take the eager reference's phases by order (the
   longest runs both launch in the same order; outside them, by name).
3. A real CPU trace of a port function with a backward: the forward ops
   attributed by their stack, the backward ones by their forward op's.
"""

import re
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from nefes_tpu_torch.runtime import xprof
from runtime import xprof as jxprof

ROOT = Path(__file__).resolve().parents[1]
RENAMED = {"pallas_kernel": "cuda_kernel", "jax_internal": "torch_internal"}


def _line_of(path: str, pattern: str) -> int:
    lines = (ROOT / path).read_text().splitlines()
    return next(i + 1 for i, ln in enumerate(lines) if re.match(pattern, ln))


def _span_pairs():
    """(JAX file, line), (port file, line): a line inside each top-level
    definition that the nerfh_nff.py rule names, and one it does not."""
    jf = "nefes_tpu/fields/nerfh_nff.py"
    pf = "nefes_tpu_torch/fields/nerfh_nff.py"
    out = []
    for pat in (r"class FusionNet", r"class ExposureMLP",
                r"def affine_color_transform", r"class NeRFHNFF"):
        out.append(((str(ROOT / jf), _line_of(jf, pat) + 2),
                    (pf, _line_of(pf, pat) + 2)))
    return out


# (JAX file, the port's counterpart): the port's as the profiler names it
# (relative to the repo root on sys.path) or an installed library's path
PAIRS = [
    ("nefes_tpu/ops/sorting.py", "nefes_tpu_torch/render/sampling.py"),
    ("nefes_tpu/render/sampling.py", "nefes_tpu_torch/render/sampling.py"),
    ("nefes_tpu/render/compositor.py", "nefes_tpu_torch/render/compositor.py"),
    ("nefes_tpu/fields/embedder.py", "nefes_tpu_torch/fields/embedder.py"),
    ("nefes_tpu/features/dfnet.py", "nefes_tpu_torch/features/dfnet.py"),
    ("nefes_tpu/features/posenet.py", "nefes_tpu_torch/features/posenet.py"),
    ("nefes_tpu/features/mstransformer.py",
     "nefes_tpu_torch/features/mstransformer.py"),
    ("nefes_tpu/features/backbones.py",
     "nefes_tpu_torch/features/backbones.py"),
    ("nefes_tpu/utils/image.py", "nefes_tpu_torch/utils/image.py"),
    ("nefes_tpu/render/renderer.py", "nefes_tpu_torch/render/renderer.py"),
    ("nefes_tpu/render/validation.py",
     "nefes_tpu_torch/render/validation.py"),
    ("nefes_tpu/train/model.py", "nefes_tpu_torch/train/model.py"),
    ("/v/lib/python3.12/site-packages/jax/_src/numpy/lax_numpy.py",
     "torch/nn/functional.py"),
    ("/v/lib/python3.12/site-packages/flax/linen/linear.py",
     "/v/lib/python3.12/site-packages/torch/nn/modules/linear.py"),
    ("nefes_tpu/refine/losses.py", "nefes_tpu_torch/refine/losses.py"),
    ("nefes_tpu/utils/ssim.py", "nefes_tpu_torch/utils/ssim.py"),
    ("nefes_tpu/train/losses.py", "nefes_tpu_torch/train/losses.py"),
    ("/v/lib/python3.12/site-packages/optax/_src/transform.py",
     "torch/optim/adam.py"),
    ("/v/lib/python3.12/site-packages/optax/_src/alias.py",
     "nefes_tpu_torch/refine/graph.py"),
    ("nefes_tpu/geometry/rays.py", "nefes_tpu_torch/geometry/rays.py"),
    ("nefes_tpu/geometry/se3.py", "nefes_tpu_torch/geometry/se3.py"),
    ("nefes_tpu/geometry/transforms.py",
     "nefes_tpu_torch/geometry/transforms.py"),
    ("nefes_tpu/refine/pose_opt.py", "nefes_tpu_torch/refine/pose_opt.py"),
    ("nefes_tpu/refine/apr_opt.py", "nefes_tpu_torch/refine/apr_opt.py"),
    ("nefes_tpu/kernels/fused_field.py",
     "nefes_tpu_torch/kernels/fused_field.py"),
    ("nefes_tpu/kernels/fused_render.py",
     "nefes_tpu_torch/kernels/fused_render.py"),
    ("nefes_tpu/cli/refine.py", "nefes_tpu_torch/cli/refine.py"),
]


@pytest.mark.parametrize("jax_file,port_file", PAIRS)
def test_categorize_matches_jax(jax_file, port_file):
    want = jxprof.categorize((jax_file, 1))
    assert xprof.categorize((port_file, 1, "f")) == RENAMED.get(want, want)


@pytest.mark.parametrize("case", range(4))
def test_categorize_class_spans(case):
    (jf, jl), (pf, pl) = _span_pairs()[case]
    want = jxprof.categorize((jf, jl))
    assert want == ("fusion_net", "exposure", "exposure", "field_mlp")[case]
    assert xprof.categorize((pf, pl, "forward")) == want
    assert xprof.categorize(None) == jxprof.categorize(None) == \
        "uncategorized"


# --- a synthetic event tree, as torch.profiler builds it on the card ---

E = xprof._tags()


class N:
    """A node of the event tree: the attributes xprof reads."""

    def __init__(self, tag, name, t0, t1, children=(), tid=1, **extra):
        self.tag, self.name = tag, name
        self.start_time_ns, self.end_time_ns, self.start_tid = t0, t1, tid
        self.children = list(children)
        self.parent = None
        for c in self.children:
            c.parent = self
        self.extra_fields = SimpleNamespace(**extra)


def py(file, line, fn, t0, t1, children=(), caller=("x.py", 1, "x"),
       tid=1):
    frame = SimpleNamespace(file_name=file, line_number=line,
                            function_name=fn)
    up = SimpleNamespace(file_name=caller[0], line_number=caller[1],
                         function_name=caller[2])
    return N(E.PyCall, f"{file}({line}): {fn}", t0, t1, children, tid,
             callsite=frame, caller=up)


def op(name, t0, t1, children=(), seq=-1, inputs=(), tid=1):
    return N(E.TorchOp, name, t0, t1, children, tid, sequence_number=seq,
             inputs=list(inputs))


def launch(kernel, t_launch, k0, k1, api="cudaLaunchKernel", tid=1):
    return N(E.Kineto, api, t_launch, t_launch + 5,
             [N(E.Kineto, kernel, k0, k1, tid=tid)], tid)


def tensor(*sizes):
    return SimpleNamespace(sizes=list(sizes), dtype=torch.float32)


def trace(*roots):
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=(
        SimpleNamespace(experimental_event_tree=lambda: list(roots)))))


FUSION = "nefes_tpu_torch/fields/nerfh_nff.py"
FUSION_LINE = _line_of(FUSION, r"class FusionNet") + 2
# the reference iteration: (kernel, phase, ns on the card, how)
EAGER = [("render_fwd_kernel", "cuda_kernel", 100, "stack"),
         ("gemm", "fusion_net", 50, "stack"),
         ("sin_kernel", "embed", 30, "stack"),
         ("gemm_bwd", "fusion_net", 100, "backward"),
         ("adam_kernel", "optimizer", 30, "stack"),
         ("Memcpy DtoD (Device -> Device)", "data_movement", 10, "none")]


def eager_trace():
    """One iteration: a ctypes launch in a kernel wrapper; a matmul in
    FusionNet (inputs 10x20 and 20x30 f32, 1200 B allocated) whose kernel
    the embedding's sin overlaps by 10 ns; the matmul's backward on the
    autograd thread; an Adam update; a copy no frame encloses."""
    step = py("nefes_tpu_torch/refine/pose_opt.py", 191, "_step", 0, 1000, [
        py("nefes_tpu_torch/kernels/fused_render.py", 148, "render_fwd_pre",
           10, 100, [launch("render_fwd_kernel", 20, 40, 140)]),
        py(FUSION, FUSION_LINE, "forward", 150, 300, [
            op("aten::mm", 160, 290, [
                N(E.Allocation, "[memory]", 165, 165, alloc_size=1200),
                launch("gemm", 170, 200, 260)],
               seq=5, inputs=[tensor(10, 20), tensor(20, 30), 1.0])]),
        py("nefes_tpu_torch/fields/embedder.py", 51, "embed", 310, 400, [
            op("aten::sin", 320, 390, [launch("sin_kernel", 330, 250, 280)],
               seq=6, inputs=[tensor(8)])]),
        py("torch/_tensor.py", 576, "backward", 400, 900, [
            op("autograd::engine::evaluate_function: MmBackward0", 500, 800,
               [op("aten::mm", 510, 790,
                   [launch("gemm_bwd", 520, 600, 700, tid=2)], tid=2)],
               seq=5, tid=2)]),
        py("torch/optim/adam.py", 300, "_single_tensor_adam", 900, 990, [
            op("aten::add_", 910, 960, [launch("adam_kernel", 915, 920, 950)],
               inputs=[tensor(3), tensor(3)])]),
    ])
    copy = launch("Memcpy DtoD (Device -> Device)", 970, 980, 990,
                  api="cudaMemcpyAsync")
    return trace(step, copy)


KBYTES = {"render_fwd_pre": 1000.0}


def test_eager_attribution():
    ops, busy, span = xprof.load_ops(eager_trace(), KBYTES)
    assert [o.name for o in sorted(ops, key=lambda o: o.start_ns)] == \
        ["render_fwd_kernel", "gemm", "sin_kernel", "gemm_bwd",
         "adam_kernel", "Memcpy DtoD (Device -> Device)"]
    # the union of the spans: [40, 140] + [200, 280] + [600, 700] +
    # [920, 950] + [980, 990]; the overlap [250, 260] counted once
    assert busy == pytest.approx(320e-6, abs=1e-15)
    assert span == pytest.approx(950e-6, abs=1e-15)
    phases, per_op, pbytes = xprof.attribute(ops, want_bytes=True)
    assert abs(sum(phases.values()) - busy) <= 1e-9
    by_name = {o.name: o for o in ops}
    for name, phase, ns, how in EAGER:
        o = by_name[name]
        assert (o.phase, o.how) == (phase, how), name
        assert o.ms == pytest.approx(ns * 1e-6, abs=1e-15), name
    assert list(phases)[:2] == ["fusion_net", "cuda_kernel"]
    assert phases == pytest.approx({
        "fusion_net": 150e-6, "cuda_kernel": 100e-6, "embed": 30e-6,
        "optimizer": 30e-6, "data_movement": 10e-6}, abs=1e-15)
    # bytes: the wrapper's; the matmul's inputs (800 + 2400) and its
    # allocation; the sin's input; the backward matmul has no inputs
    # recorded (0 B); the copy is not reckoned
    assert by_name["render_fwd_kernel"].nbytes == 1000.0
    assert by_name["gemm"].nbytes == 4400.0
    assert by_name["sin_kernel"].nbytes == 32.0
    assert by_name["Memcpy DtoD (Device -> Device)"].nbytes is None
    assert pbytes["fusion_net"] == {"bytes": 4400.0,
                                    "ms": pytest.approx(150e-6)}
    assert "data_movement" not in pbytes
    assert by_name["render_fwd_kernel"].opcode == "render_fwd_pre"
    assert by_name["gemm"].opcode == "aten::mm"
    assert by_name["gemm"].src == (FUSION, FUSION_LINE, "forward")
    assert per_op[0][1:] == (
        "render_fwd_kernel", "render_fwd_pre @ "
        "nefes_tpu_torch/kernels/fused_render.py:148 render_fwd_pre",
        "cuda_kernel", 1)


def replay_trace(orders):
    """One captured frame: an eager copy into the loop's buffers, then one
    graph launch a list of orders, each launching the eager iteration's
    kernels (EAGER) in that order, 100 ns apart, beside a "Command Buffer
    Full" record over them (not device work)."""
    frame = py("nefes_tpu_torch/refine/pose_opt.py", 214, "run", 0, 100, [
        op("aten::copy_", 10, 90, [launch("copy_kernel", 20, 30, 40)])])
    roots, t = [frame], 1000
    for order in orders:
        kernels = []
        for i in order:
            kernels.append(N(E.Kineto, EAGER[i][0], t, t + EAGER[i][2]))
            t += 100
        # CUPTI's record of a full launch queue: no device work
        kernels.append(N(E.Kineto, "Command Buffer Full", t - 600, t))
        graph_launch = N(E.Kineto, "cudaGraphLaunch", t - 700, t - 690,
                         kernels)
        roots.append(py("torch/cuda/graphs.py", 137, "replay", t - 800,
                        t - 600, [graph_launch]))
    return trace(*roots)


def test_replayed_kernels_by_reference():
    reference, _, _ = xprof.load_ops(eager_trace(), KBYTES)
    in_order, swapped = list(range(6)), [1, 0, 2, 3, 5, 4]
    ops, busy, _ = xprof.load_ops(replay_trace([in_order, in_order,
                                                swapped]), KBYTES)
    phases, _, pbytes = xprof.attribute(ops, reference, want_bytes=True)
    assert abs(sum(phases.values()) - busy) <= 1e-9
    assert "Command Buffer Full" not in {o.name for o in ops}
    hows = {}
    for o in ops:
        hows.setdefault(o.replay, set()).add(o.how)
    # the swapped replay: the longest common run by order, the rest by name
    assert hows == {None: {"stack"}, 0: {"order"}, 1: {"order"},
                    2: {"order", "name"}}
    want = {}
    for _, phase, ns, _ in EAGER:
        want[phase] = want.get(phase, 0.0) + 3 * ns * 1e-6
    want["pose_geom"] = 10e-6
    assert set(phases) == set(want)
    for k in want:
        assert phases[k] == pytest.approx(want[k], abs=1e-15), k
    assert pbytes["cuda_kernel"]["bytes"] == 3 * 1000.0
    gemm = [o for o in ops if o.name == "gemm"]
    assert len(gemm) == 3 and all(
        o.phase == "fusion_net" and o.opcode == "graph replay of aten::mm"
        for o in gemm)
    # a reference that missed the iteration's first kernel (the tracer
    # started late): the others still line up by order
    ops, _, _ = xprof.load_ops(replay_trace([in_order]), KBYTES)
    late = [r for r in reference if r.name != "render_fwd_kernel"]
    xprof.attribute(ops, late)
    assert {o.name: o.how for o in ops if o.replay == 0} == {
        n: ("none" if n == "render_fwd_kernel" else "order")
        for n, *_ in EAGER}
    # the same op on a kernel variant of another name (operands aligned
    # otherwise): lined up by its position between two runs
    renamed = list(reference)
    k = next(i for i, r in enumerate(reference) if r.name == "sin_kernel")
    renamed[k] = xprof.Op("sin_kernel_unaligned", reference[k].start_ns,
                          reference[k].end_ns, src=reference[k].src)
    ops, _, _ = xprof.load_ops(replay_trace([in_order]), KBYTES)
    xprof.attribute(ops, renamed)
    assert {o.how for o in ops if o.replay == 0} == {"order"}
    assert [o.phase for o in ops if o.name == "sin_kernel"] == ["embed"]
    # a kernel the reference never launched stays uncategorized
    extra = N(E.Kineto, "unknown_kernel", 9000, 9010)
    roots = replay_trace([in_order]).profiler.kineto_results \
        .experimental_event_tree()
    roots.append(py("torch/cuda/graphs.py", 137, "replay", 8900, 9100, [
        N(E.Kineto, "cudaGraphLaunch", 8950, 8960, [extra])]))
    ops, _, _ = xprof.load_ops(trace(*roots), KBYTES)
    phases, _ = xprof.attribute(ops, reference)
    assert extra.name in {o.name for o in ops if o.phase == "uncategorized"}


def test_cpu_trace_of_a_port_function():
    """The torch ops of embed and their backward, profiled on the CPU."""
    from torch.profiler import ProfilerActivity, profile

    from nefes_tpu_torch.fields.embedder import EmbedConfig, embed
    x = torch.randn(64, 3, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    cfg = EmbedConfig(num_freqs=4)
    with profile(activities=[ProfilerActivity.CPU], with_stack=True,
                 record_shapes=True, profile_memory=True) as prof:
        embed(x, cfg).square().sum().backward()
    ops, busy, span = xprof.load_ops(prof)
    phases, per_op = xprof.attribute(ops)
    assert 0 < busy <= span and abs(sum(phases.values()) - busy) <= 1e-9
    embed_ops = [o for o in ops if o.phase == "embed"]
    assert {o.how for o in embed_ops} == {"stack", "backward"}
    assert any(o.name in ("aten::sin", "aten::cos") for o in embed_ops
               if o.how == "stack")
    assert all(o.src[0].endswith("nefes_tpu_torch/fields/embedder.py")
               for o in embed_ops)
