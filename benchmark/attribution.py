"""torch.profiler trace reading for the benchmark's per-layer metrics:
device time per kernel and its attribution to the program's layers.

A frozen copy of the program's runtime/xprof.py method, so that a later
change to the program cannot change the yardstick. Run the profiler
with the CPU and CUDA activities and ``with_stack=True``. Its event tree
nests each device activity under the runtime call that launched it, and
that call under the torch op or Python frame running on its thread. The
program's kernels are launched through ctypes, so the runtime call is
tied to the innermost Python frame around it; a kernel's source is the
innermost frame, walking out, in a file of the program or of
torch.optim. A backward op takes the source of the forward op with its
sequence number. Kernels replayed from a CUDA graph carry no stack: they
are lined up, in order, with the kernels of an eager run of the same
iteration (``attribute``'s ``reference``).

Each op also records the program's kernel wrapper that launched it
(``wrapper``: a name of ``WRAPPERS``), which the roofline metrics read,
and the benchmark's span around its launch (``span``: the innermost
``record_function("bench.*")`` on its thread at the launch's time).
"""

from __future__ import annotations

import difflib
import os
from collections import defaultdict
from dataclasses import dataclass
from pathlib import Path

PROJECT = "nefes_tpu_torch"
_ROOT = Path(__file__).resolve().parents[1]   # the directory holding PROJECT
_BACKWARD = "autograd::engine::evaluate_function"
# the program's kernel wrappers (kernels/fused_field.py, fused_render.py)
WRAPPERS = ("field_fwd_pre", "field_bwd_pre", "render_fwd_pre",
            "render_bwd_pre", "field_fwd", "field_bwd", "render_fwd",
            "render_bwd", "field_dw")


@dataclass
class Op:
    """One device activity (a kernel, copy or memset) or, on the CPU, one
    torch op's self time."""
    name: str
    start_ns: int
    end_ns: int
    ms: float = 0.0            # its share of the busy union
    opcode: str = ""           # the torch op, the project function or
                               # "graph replay" that launched it
    src: tuple | None = None   # (file, line, function) it is attributed to
    how: str = "none"          # "stack", "backward", "order", "name", "none"
    nbytes: float | None = None    # traffic upper bound; None: not reckoned
    replay: int | None = None  # index of the graph launch that replayed it
    phase: str = ""
    wrapper: str = ""          # the kernel wrapper that launched it
    span: str = ""             # the benchmark's span around its launch


def _tags():
    from torch._C._profiler import _EventType
    return _EventType


def _project(f: str) -> bool:
    return PROJECT in f


def _decisive(f: str) -> bool:
    """A frame that names what an op is: a project file, or torch.optim."""
    return _project(f) or "torch/optim" in f


def _is_backward(node, E) -> bool:
    return node.tag == E.TorchOp and node.name.startswith(_BACKWARD)


def _frames(node, E):
    """(file, line, function) of each PyCall on node's parent chain,
    innermost first, up to the first backward node (the autograd engine's
    frames above it are those of whoever called backward); the line is
    where the frame called the next one in when that is known, else the
    function's first line."""
    out, inner = [], None
    while node is not None and not _is_backward(node, E):
        if node.tag == E.PyCall:
            cs = node.extra_fields.callsite
            line = cs.line_number
            if inner is not None and inner.file_name == cs.file_name:
                line = inner.line_number
            out.append((cs.file_name, line, cs.function_name))
            inner = node.extra_fields.caller
        node = node.parent
    return out


def _spans(tr) -> dict:
    """{thread: [(start, end, name)]} of the benchmark's record_function
    spans ("bench.*"): nodes of the tree with no children, known by their
    time on their thread."""
    out = defaultdict(list)
    for n in tr.nodes():
        if n.tag == tr.E.TorchOp and n.name.startswith("bench."):
            out[n.start_tid].append((n.start_time_ns, n.end_time_ns, n.name))
    return out


def _span_at(spans: dict, t: int, tid: int) -> str:
    """The innermost benchmark span on thread tid around time t, or ""."""
    around = [s for s in spans.get(tid, ()) if s[0] <= t <= s[1]]
    return max(around)[2] if around else ""


def _deepest(parent, t: int, tid: int, skip, E):
    """The innermost torch op or Python frame on thread tid around time t,
    from parent down."""
    node = parent
    while node is not None:
        nxt = None
        for c in node.children:
            if (c is not skip and c.tag in (E.PyCall, E.TorchOp)
                    and c.start_tid == tid
                    and c.start_time_ns <= t <= c.end_time_ns):
                nxt = c
                break
        if nxt is None:
            return node
        node = nxt
    return None


def _tensor_bytes(x) -> int:
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(y) for y in x)
    sizes = getattr(x, "sizes", None)
    if sizes is None or getattr(x, "dtype", None) is None:
        return 0
    n = 1
    for s in sizes:
        n *= s
    return n * x.dtype.itemsize


def _subtree(node):
    stack = [node]
    while stack:
        n = stack.pop()
        yield n
        stack.extend(n.children)


def _op_bytes(op, E) -> int:
    """Traffic upper bound of one torch op, as xprof._op_bytes reckons an
    HLO op: its tensor inputs read once (record_shapes) and what it
    allocates, its outputs and any workspace, written once
    (profile_memory)."""
    total = sum(_tensor_bytes(x) for x in op.extra_fields.inputs)
    for n in _subtree(op):
        if n.tag == E.Allocation and n.extra_fields.alloc_size > 0:
            total += n.extra_fields.alloc_size
    return total


class _Trace:
    def __init__(self, prof):
        self.E = _tags()
        self.roots = prof.profiler.kineto_results.experimental_event_tree()
        self.forward = {}           # sequence number -> forward torch op
        self._index()

    def _index(self):
        E = self.E
        stack = [(r, False) for r in self.roots]
        while stack:
            n, in_bwd = stack.pop()
            if n.tag == E.TorchOp:
                if n.name.startswith(_BACKWARD):
                    in_bwd = True
                elif (not in_bwd and n.extra_fields.sequence_number >= 0
                      and n.extra_fields.sequence_number not in self.forward):
                    self.forward[n.extra_fields.sequence_number] = n
            stack.extend((c, in_bwd) for c in n.children)

    def nodes(self):
        for r in self.roots:
            yield from _subtree(r)

    def source(self, node):
        """(src, how) for an op or frame: the innermost decisive frame
        around it ("stack"); for a backward op with none inside its
        backward node, its forward op's ("backward"); else the innermost
        frame of any file, or None ("none")."""
        E = self.E
        frames = _frames(node, E)
        for fr in frames:
            if _decisive(fr[0]):
                return fr, "stack"
        n = node
        while n is not None and not _is_backward(n, E):
            n = n.parent
        if n is not None:
            fwd = self.forward.get(n.extra_fields.sequence_number)
            if fwd is not None:
                for fr in _frames(fwd, E):
                    if _decisive(fr[0]):
                        return fr, "backward"
        return (frames[0], "stack") if frames else (None, "none")


# CUPTI records these under a launch beside the device's work; they are
# not work (a full launch queue, the tracer's own activity, a wait)
_OVERHEAD = ("Command Buffer Full", "Buffer Flush", "Activity Buffer Request",
             "Instrumentation", "Resource", "Unknown")


def _device_work(name: str) -> bool:
    """A device activity (a kernel, copy or memset), as opposed to a CUDA
    API call (cudaLaunchKernel, cuLaunchKernel), CUPTI's overhead
    records, or a synchronisation (Stream Sync, Event Sync)."""
    for prefix in ("cuda", "cu"):
        if name.startswith(prefix) and name[len(prefix):][:1].isupper():
            return False
    return name not in _OVERHEAD and not name.endswith(" Sync")


def load_ops(prof, kernel_bytes: dict | None = None):
    """Ops of a profiled run: (ops, busy ms, span ms).

    With device activity in the trace, one Op per kernel, copy or memset;
    without, one Op per torch op. Nested or overlapping ops are counted
    once (_split_union): an op's ms is the time in which it is the
    latest-started of those running (a torch op's self time), so the
    ops' ms sum to the union of their spans, busy. The span runs from the
    first start to the last end. kernel_bytes maps a project function
    that launches a kernel itself (a ctypes wrapper) to the bytes of one
    launch; a launch inside a torch op takes that op's bytes, shared
    among the kernels it launched; a CPU op with no op nested in it, its
    own; any other op stays unreckoned (nbytes None)."""
    tr = _Trace(prof)
    E = tr.E
    device = [n for n in tr.nodes()
              if n.tag == E.Kineto and n.parent is not None
              and n.parent.tag == E.Kineto and _device_work(n.name)]
    ops = _device_ops(tr, device, kernel_bytes or {}) if device else \
        _cpu_ops(tr)
    if not ops:
        return [], 0.0, 0.0
    _split_union(ops)
    busy = sum(op.ms for op in ops)
    span = (max(o.end_ns for o in ops) - min(o.start_ns for o in ops)) / 1e6
    return ops, busy, span


def _split_union(ops: list[Op]) -> None:
    """Set each op's ms to the time in which it is the latest-started of
    the ops running: nested ops leave their parent its self time, and
    overlapping ones count once, so the ms sum to the union of the
    spans."""
    bounds = sorted({t for o in ops for t in (o.start_ns, o.end_ns)})
    order = sorted(range(len(ops)), key=lambda i: ops[i].start_ns)
    credit = [0] * len(ops)
    active, nxt = [], 0
    for a, b in zip(bounds, bounds[1:]):
        while nxt < len(order) and ops[order[nxt]].start_ns <= a:
            active.append(order[nxt])
            nxt += 1
        active = [i for i in active if ops[i].end_ns > a]
        if active:
            credit[max(active, key=lambda i: ops[i].start_ns)] += b - a
    for op, c in zip(ops, credit):
        op.ms = c / 1e6


def _device_ops(tr, device, kernel_bytes) -> list[Op]:
    E = tr.E
    spans = _spans(tr)
    ops, op_bytes, launched = [], {}, defaultdict(int)
    graph_launches = sorted({id(n.parent): n.parent for n in device
                             if "GraphLaunch" in n.parent.name}.values(),
                            key=lambda r: r.start_time_ns)
    replay_of = {id(r): i for i, r in enumerate(graph_launches)}
    pending = []
    for n in device:
        rt = n.parent
        op = Op(n.name, n.start_time_ns, n.end_time_ns)
        op.span = _span_at(spans, rt.start_time_ns, rt.start_tid)
        if id(rt) in replay_of:
            op.opcode, op.replay = "graph replay", replay_of[id(rt)]
            ops.append(op)
            continue
        inner = _deepest(rt.parent, rt.start_time_ns, rt.start_tid, rt, E)
        op.src, op.how = tr.source(inner) if inner is not None else (None,
                                                                      "none")
        # the innermost torch op, unless a project frame lies inside it
        node, torch_op = inner, None
        while node is not None:
            if node.tag == E.TorchOp:
                torch_op = node
                break
            if node.tag == E.PyCall and _project(
                    node.extra_fields.callsite.file_name):
                break
            node = node.parent
        if torch_op is not None:
            op.opcode = torch_op.name
            if id(torch_op) not in op_bytes:
                op_bytes[id(torch_op)] = _op_bytes(torch_op, E)
            launched[id(torch_op)] += 1
            pending.append((op, id(torch_op)))
        else:
            frames = [f for f in _frames(inner, E) if _project(f[0])] \
                if inner is not None else []
            op.opcode = frames[0][2] if frames else "runtime"
            op.wrapper = next((f[2] for f in frames if f[2] in WRAPPERS),
                              "")
            for f in frames:
                if f[2] in kernel_bytes:
                    op.nbytes = float(kernel_bytes[f[2]])
                    break
        ops.append(op)
    for op, key in pending:
        op.nbytes = op_bytes[key] / launched[key]
    return ops


def _cpu_ops(tr) -> list[Op]:
    spans = _spans(tr)
    E = tr.E
    ops = []
    for n in tr.nodes():
        if (n.tag != E.TorchOp or n.end_time_ns <= n.start_time_ns
                or n.name.startswith("bench.")):
            continue
        op = Op(n.name, n.start_time_ns, n.end_time_ns, opcode=n.name)
        op.src, op.how = tr.source(n)
        op.span = _span_at(spans, n.start_time_ns, n.start_tid)
        leaf = not any(c.tag == E.TorchOp for c in _subtree(n) if c is not n)
        op.nbytes = float(_op_bytes(n, E)) if leaf else None
        ops.append(op)
    return ops


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

_CLASS_SPANS: dict[str, list[tuple[int, int, str]]] = {}


def _resolve(path: str) -> str:
    """A trace's file name (often relative to an entry of sys.path) as a
    path that opens."""
    if os.path.isabs(path) or os.path.exists(path):
        return path
    return str(_ROOT / path)


def _class_spans(path: str) -> list[tuple[int, int, str]]:
    """(start, end, name) line spans of top-level defs and classes."""
    if path in _CLASS_SPANS:
        return _CLASS_SPANS[path]
    spans = []
    try:
        with open(_resolve(path)) as f:
            lines = f.readlines()
        starts = [(i + 1, line.split()[1].split("(")[0].rstrip(":"))
                  for i, line in enumerate(lines)
                  if line.startswith(("class ", "def "))]
        for j, (ln, name) in enumerate(starts):
            end = starts[j + 1][0] - 1 if j + 1 < len(starts) else len(lines)
            spans.append((ln, end, name))
    except OSError:
        pass
    _CLASS_SPANS[path] = spans
    return spans


def _span_name(path: str, line: int) -> str | None:
    for s, e, name in _class_spans(path):
        if s <= line <= e:
            return name
    return None


def categorize(src: tuple | None) -> str:
    """Map a (file, line[, function]) to a framework phase: the phase
    names and the file -> phase map of runtime/xprof.py's categorize, over
    the port's files. Two names are the port's: "cuda_kernel" for the
    hand-written kernels' wrappers (JAX: "pallas_kernel") and
    "torch_internal" for torch's own frames (JAX: "jax_internal");
    torch.optim takes optax's "optimizer", and so does refine/graph.py
    (GraphAdam, the captured loops' Adam step)."""
    if src is None:
        return "uncategorized"
    f, line = src[0], src[1]
    base = os.path.basename(f)
    if base in ("sorting.py", "sampling.py"):
        return "sampling+sort"
    if base == "compositor.py":
        return "composite"
    if base == "embedder.py":
        return "embed"
    if base == "nerfh_nff.py":
        name = _span_name(f, line)
        if name == "FusionNet":
            return "fusion_net"
        if name in ("ExposureMLP", "affine_color_transform"):
            return "exposure"
        return "field_mlp"
    if base in ("dfnet.py", "posenet.py", "mstransformer.py",
                "backbones.py"):
        return "apr_tower"
    if base == "image.py":
        return "resize"
    if base in ("renderer.py", "validation.py"):
        return "render_driver"      # pts/viewdirs construction, reshapes
    if base == "model.py":
        return "model_glue"
    if "torch/optim" in f or (base == "graph.py" and _project(f)):
        return "optimizer"
    if f.startswith("torch/") or "/torch/" in f:
        return "torch_internal"
    if base == "losses.py" and "refine" in f:
        return "dfm_loss"
    if base == "ssim.py" or base == "losses.py":
        return "verify_metrics"
    if base in ("rays.py", "se3.py", "transforms.py", "pose_opt.py",
                "apr_opt.py"):
        return "pose_geom"
    if base in ("fused_field.py", "fused_render.py"):
        return "cuda_kernel"
    return "other"


def _alignment(names: tuple, ref_names: tuple) -> dict:
    """{position in names: position in ref_names}: the runs of kernels
    the two sequences launch in the same order (difflib), and between
    two such runs, position by position, as many kernels on each side
    (the same ops, whose kernel variants differ: an elementwise or cat
    kernel is picked by its operands' alignment, and a graph's pool
    places them elsewhere than the eager allocator)."""
    sm = difflib.SequenceMatcher(None, names, ref_names, autojunk=False)
    at = {}
    for tag, i1, i2, j1, j2 in sm.get_opcodes():
        if tag == "equal" or (tag == "replace" and i2 - i1 == j2 - j1):
            at.update(zip(range(i1, i2), range(j1, j2)))
    return at


def _match_replays(ops: list[Op], reference: list[Op]) -> None:
    """Give each replayed op the source, bytes and launcher of the
    reference op it lines up with in launch order (_alignment: "order");
    a kernel that lines up with none, the reference's k-th of its name
    ("name"), or none."""
    ref = sorted(reference, key=lambda o: o.start_ns)
    ref_names = tuple(r.name for r in ref)
    by_name = defaultdict(list)
    for r in ref:
        by_name[r.name].append(r)
    groups = defaultdict(list)
    for op in ops:
        if op.replay is not None:
            groups[op.replay].append(op)
    aligned: dict[tuple, dict] = {}     # replays mostly repeat one order
    for group in groups.values():
        group.sort(key=lambda o: o.start_ns)
        names = tuple(o.name for o in group)
        if names not in aligned:
            aligned[names] = _alignment(names, ref_names)
        at = aligned[names]
        seen = defaultdict(int)
        for i, op in enumerate(group):
            k = seen[op.name]
            seen[op.name] += 1
            if i in at:
                r, how = ref[at[i]], "order"
            else:
                cands = by_name.get(op.name, [])
                r, how = (cands[k], "name") if k < len(cands) else (None,
                                                                    "none")
            if r is not None:
                op.src, op.nbytes, op.how = r.src, r.nbytes, how
                op.wrapper = r.wrapper
                op.opcode = f"graph replay of {r.opcode}"


def attribute(ops: list[Op], reference: list[Op] | None = None,
              want_bytes: bool = False):
    """ops (from load_ops) -> per-phase ms table.

    Each op's ms goes to the phase of its source (categorize); an op with
    no source is "data_movement" if it is a copy or memset, else
    "uncategorized". Replayed ops (op.replay set) take their sources from
    `reference`, the ops of an eager run of the replayed iteration
    (load_ops of a trace of it), by position (see _match_replays); each
    op's `how` says which way it was attributed.

    Returns (phases_ms sorted by time, per_op) and with want_bytes also
    phase_bytes: {phase: {"bytes": the reckoned ops' bytes, "ms": their
    ms}}; per_op rows are (ms, kernel, opcode, phase, count), one per
    (kernel, launcher, source), longest first."""
    if reference is not None:
        _match_replays(ops, reference)
    phases: dict[str, float] = defaultdict(float)
    phase_bytes: dict[str, dict] = {}
    rows: dict[tuple, list] = {}
    for op in ops:
        if op.src is None:
            op.phase = ("data_movement" if op.name.startswith(
                ("Memcpy", "Memset")) else "uncategorized")
        else:
            op.phase = categorize(op.src)
        phases[op.phase] += op.ms
        if op.nbytes is not None:
            pb = phase_bytes.setdefault(op.phase, {"bytes": 0.0, "ms": 0.0})
            pb["bytes"] += op.nbytes
            pb["ms"] += op.ms
        src = (f"{op.src[0]}:{op.src[1]} {op.src[2]}" if op.src and
               len(op.src) > 2 else "")
        where = f"{op.opcode} @ {src}" if src else op.opcode
        row = rows.setdefault((op.name, where, op.phase),
                              [0.0, op.name, where, op.phase, 0])
        row[0] += op.ms
        row[4] += 1
    per_op = sorted((tuple(r) for r in rows.values()), reverse=True)
    phases_sorted = dict(sorted(phases.items(), key=lambda kv: -kv[1]))
    if want_bytes:
        return phases_sorted, per_op, phase_bytes
    return phases_sorted, per_op
