"""The work a kernel or a step needs, counted from shapes, and the least
time an H100 could take for it. A frozen copy of the program's
runtime/probe.py `bound`, `tower_flops`, `embed_ops` and
`refinement_kernel_bytes` (the rules its kernel table was built with),
taking the field's sizes instead of the program's packed weights."""

from __future__ import annotations

from dataclasses import dataclass

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


@dataclass(frozen=True)
class FieldDims:
    """The NeFeS field's sizes: embedded point and direction widths, trunk
    width and depth, skips, the rgb + feature head's width."""
    depth: int = 8
    width: int = 128
    feature_dim: int = 128
    skips: tuple = (4,)
    n_freqs_xyz: int = 10
    n_freqs_dir: int = 4

    @property
    def emb_xyz(self) -> int:
        return 3 + 6 * self.n_freqs_xyz

    @property
    def emb_dir(self) -> int:
        return 3 + 6 * self.n_freqs_dir

    @property
    def half(self) -> int:
        return self.width // 2

    @property
    def rgbfeat(self) -> int:
        return 3 + self.feature_dim

    @classmethod
    def from_config(cls, field: dict) -> "FieldDims":
        return cls(depth=field["depth"], width=field["width"],
                   feature_dim=field["feature_dim"],
                   skips=tuple(field["skips"]),
                   n_freqs_xyz=field["n_freqs_xyz"],
                   n_freqs_dir=field["n_freqs_dir"])


def bound(flops: float, ew_ops: float, nbytes: float) -> tuple:
    """(ms, "operations" or "bytes"): the larger of the bf16 products at
    the tensor cores' peak plus the f32 elementwise work at the f32 peak,
    and the bytes (each input read once, each output written once) at the
    memory rate."""
    t_ops = (flops / PEAK_BF16_FLOPS + ew_ops / PEAK_F32_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def tower_flops(d: FieldDims, samples: int = 1) -> dict:
    """Matrix-product operations per sample (2 per multiply-add) of each
    field kernel's function. K1: trunk and sigma head. "full": the whole
    forward with the dir layer and the rgb/feature head. K3: the forward
    to the dir layer per sample and the rgb/feature head once per ray of
    `samples` samples. K2 and K4 recompute the forward (K4 with the 3 rgb
    columns) and backprop to the inputs, as many products as the whole
    forward. "fwd_t": the forward with the transient branch; "bwd_dw_t":
    its recompute without the rgb head, the products back to the inputs
    and one product per weight for dW."""
    E, Ed, Wd, Hd, C = d.emb_xyz, d.emb_dir, d.width, d.half, d.rgbfeat
    trunk = E * Wd + (d.depth - 1) * Wd * Wd + Wd
    trunk += sum(E * Wd for i in d.skips if 0 < i < d.depth)
    body = trunk + Wd * Wd + (Wd + Ed) * Hd
    full = body + Hd * C
    trans = (Wd + Ed) * Hd + 2 * Hd * Hd + Hd * 5
    return {"K1": 2 * trunk, "K2": 2 * (body + full), "full": 2 * full,
            "K3": 2 * (body + Hd * C / samples),
            "K4": 2 * (body + Hd * 3 + full),
            "fwd_t": 2 * (full + trans),
            "bwd_dw_t": 2 * ((body + trans) + 2 * (full + trans))}


def embed_ops(d: FieldDims) -> dict:
    """f32 elementwise operations per sample of the sin/cos embedding:
    forward 3 phases and 6 sin/cos per band and coordinate (the point
    only: "xyz_fwd"; point and direction: "fwd"); back to the inputs 2
    sin/cos, 3 products and 2 sums per band and coordinate ("bwd")."""
    nx, nd = d.n_freqs_xyz, d.n_freqs_dir
    return {"xyz_fwd": 3 * 3 * nx, "fwd": 3 * 3 * (nx + nd),
            "bwd": 3 * 7 * (nx + nd)}


def weight_bytes(d: FieldDims, transient: bool = False,
                 elem: int = 2) -> int:
    """The tower's matrices in the compute dtype and its biases in f32."""
    E, Ed, Wd, Hd, C = d.emb_xyz, d.emb_dir, d.width, d.half, d.rgbfeat
    mats = [E * Wd] + [Wd * Wd] * (d.depth - 1) + [
        E * Wd for i in d.skips if 0 < i < d.depth]
    mats += [Wd, Wd * Wd, (Wd + Ed) * Hd, Hd * C]
    biases = [Wd] * d.depth + [1, Wd, Hd, C]
    if transient:
        mats += [(Wd + Ed) * Hd, Hd * Hd, Hd * Hd, Hd * 5]
        biases += [Hd, Hd, Hd, 5]
    return sum(mats) * elem + sum(biases) * 4


def refinement_kernel_bytes(d: FieldDims, rays: int, n_c: int = 64,
                            n_f: int = 128, elem: int = 2) -> dict:
    """Bytes of one launch of each refinement kernel, by the wrapper that
    launches it, at `rays` rays: each input read once, each output
    written once, and the tower's weights."""
    b4 = 4
    Nc, Nf = rays * n_c, rays * n_f
    ray_out = rays * (d.rgbfeat + 2) * b4
    pre = d.emb_xyz + d.emb_dir
    w = weight_bytes(d, elem=elem)
    return {
        "field_fwd_pre": Nc * (d.emb_xyz + 1) * elem + w,
        "field_bwd_pre": Nf * (2 * pre + d.rgbfeat + 1) * elem + w,
        "render_fwd_pre": Nf * pre * elem + Nf * b4 + ray_out + w,
        "render_bwd_pre": 2 * Nf * pre * elem + 2 * Nf * b4 + ray_out + w,
        "field_fwd": Nc * (3 + 1) * b4 + w,
        "field_bwd": Nf * (4 * 3 + d.rgbfeat + 1) * b4 + w,
        "render_fwd": Nf * (2 * 3 + 1) * b4 + ray_out + w,
        "render_bwd": 2 * Nf * (2 * 3 + 1) * b4 + ray_out + w,
    }


def refinement_kernel_bounds(d: FieldDims, rays: int, n_c: int = 64,
                             n_f: int = 128) -> dict:
    """{wrapper: least ms of one launch} of the refinement kernels K1-K8
    at `rays` rays, n_c coarse and n_f fine samples a ray (the products
    of K1, K2, K3 and K4, plus the raw-input kernels' embedding)."""
    fl = tower_flops(d, samples=n_f)
    el = embed_ops(d)
    kb = refinement_kernel_bytes(d, rays, n_c, n_f)
    Nc, Nf = rays * n_c, rays * n_f
    work = {
        "field_fwd_pre": (Nc * fl["K1"], 0),
        "field_bwd_pre": (Nf * fl["K2"], 0),
        "render_fwd_pre": (Nf * fl["K3"], 0),
        "render_bwd_pre": (Nf * fl["K4"], 0),
        "field_fwd": (Nc * fl["K1"], Nc * el["xyz_fwd"]),
        "field_bwd": (Nf * fl["K2"], Nf * (el["fwd"] + el["bwd"])),
        "render_fwd": (Nf * fl["K3"], Nf * el["fwd"]),
        "render_bwd": (Nf * fl["K4"], Nf * (el["fwd"] + el["bwd"])),
    }
    return {k: bound(f, e, kb[k])[0] for k, (f, e) in work.items()}


def train_step_kernel_bound(d: FieldDims, rays: int, n_c: int = 64,
                            n_f: int = 128) -> float:
    """Least ms of one training step's field kernels through the raw-input
    path: the coarse pass (rays x n_c) forward in full mode and its
    backward with dW; the fine pass (rays x n_f) forward with the
    transient branch and its backward with dW (the dW products of the
    separate dW kernel included)."""
    fl = tower_flops(d)
    el = embed_ops(d)
    Nc, Nf = rays * n_c, rays * n_f
    heads_t = 1 + 3 + d.feature_dim + 5
    heads = 1 + d.rgbfeat
    wb = weight_bytes(d)
    wbt = weight_bytes(d, transient=True)
    dw = weight_bytes(d, elem=4) + weight_bytes(d, True, 4)
    parts = [
        (Nc * fl["full"], Nc * el["fwd"], Nc * (6 * 4 + heads * 2) + wb),
        (Nc * (fl["K2"] + fl["full"]), Nc * (el["fwd"] + el["bwd"]),
         Nc * (6 * 4 * 2 + heads * 2) + wb),
        (Nf * fl["fwd_t"], Nf * el["fwd"], Nf * (6 * 4 + heads_t * 2) + wbt),
        (Nf * fl["bwd_dw_t"], Nf * (el["fwd"] + el["bwd"]),
         Nf * (6 * 4 * 2 + heads_t * 2) + wbt + dw),
    ]
    return sum(bound(f, e, b)[0] for f, e, b in parts)
